"""Qwen3-14B dense decoder [hf:Qwen/Qwen3 family]: per-head qk-RMSNorm + GQA."""
from repro_torch.models.config import ArchConfig
from repro_torch.sharding.plan import MeshPlan

CONFIG = ArchConfig(
    name="qwen3-14b",
    arch_type="dense",
    num_layers=40,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=17408,
    vocab_size=151936,
    d_head=128,
    rope_base=1e6,
    qk_norm=True,
    source="hf:Qwen/Qwen3-8B card family (assignment)",
)

PLAN = MeshPlan(train_factors=(4, 2, 4, 8), microbatch=2)
