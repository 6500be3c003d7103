"""RWKV-6 "Finch" 1.6B: attention-free, data-dependent decay
[arXiv:2404.05892]. 32 heads of 64 (time-mix state per head is 64x64)."""
from repro_torch.models.config import ArchConfig
from repro_torch.sharding.plan import MeshPlan

CONFIG = ArchConfig(
    name="rwkv6-1.6b",
    arch_type="ssm",
    num_layers=24,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,   # unused (attention-free); kept for config uniformity
    d_ff=7168,
    vocab_size=65536,
    d_head=64,
    rwkv_chunk=64,
    source="RWKV-6 Finch [arXiv:2404.05892]",
)

PLAN = MeshPlan(train_factors=(8, 4, 1, 8), microbatch=2)
