"""Granite-3.0-1B-A400M sparse MoE: 32 experts, top-8
[hf:ibm-granite/granite-3.0-1b-a400m-base]."""
from repro_torch.models.config import ArchConfig
from repro_torch.sharding.plan import MeshPlan

CONFIG = ArchConfig(
    name="granite-moe-1b-a400m",
    arch_type="moe",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    d_head=64,
    num_experts=32,
    top_k=8,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
)

PLAN = MeshPlan(train_factors=(8, 4, 1, 8), microbatch=4)
