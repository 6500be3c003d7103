"""GLM-4-9B dense decoder [hf:THUDM/glm-4-9b]: RoPE + aggressive GQA (kv=2)."""
from repro_torch.models.config import ArchConfig
from repro_torch.sharding.plan import MeshPlan

CONFIG = ArchConfig(
    name="glm4-9b",
    arch_type="dense",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=2,
    d_ff=13696,
    vocab_size=151552,
    d_head=128,
    rope_base=1e6,
    qkv_bias=True,
    source="hf:THUDM/glm-4-9b",
)

PLAN = MeshPlan(train_factors=(4, 2, 4, 8), microbatch=2)
