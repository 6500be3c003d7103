"""Qwen2.5-32B dense decoder [hf:Qwen/Qwen2.5-* family]: GQA kv=8 + QKV bias."""
from repro_torch.models.config import ArchConfig
from repro_torch.sharding.plan import MeshPlan

CONFIG = ArchConfig(
    name="qwen2.5-32b",
    arch_type="dense",
    num_layers=64,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=27648,
    vocab_size=152064,
    d_head=128,
    rope_base=1e6,
    qkv_bias=True,
    source="hf:Qwen/Qwen2.5 model card family (0.5B cited in assignment)",
)

PLAN = MeshPlan(train_factors=(2, 2, 8, 8), microbatch=1)
