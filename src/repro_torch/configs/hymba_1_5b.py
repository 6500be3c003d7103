"""Hymba-1.5B hybrid-head decoder [arXiv:2411.13676].

Every block runs attention heads and Mamba(SSM) heads *in parallel* on the
same input and fuses (mean) their outputs. Attention heads use sliding
windows (the paper keeps only 3 global-attention layers and argues the SSM
path carries global context; we make all attention layers SWA-1024 so the
arch is sub-quadratic end-to-end). 25 heads / kv=5.
"""
from repro_torch.models.config import ArchConfig
from repro_torch.sharding.plan import MeshPlan

CONFIG = ArchConfig(
    name="hymba-1.5b",
    arch_type="hybrid",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    d_ff=5504,
    vocab_size=32001,
    d_head=64,
    sliding_window=1024,
    ssm_state=16,
    ssm_d_inner=3200,
    source="Hymba [arXiv:2411.13676]",
)

PLAN = MeshPlan(train_factors=(8, 4, 1, 8), microbatch=2)
