"""Mixtral 8x22B: sparse MoE decoder, 8 experts top-2 [arXiv:2401.04088].

Per the assignment card the attention is sliding-window (Mistral-family
SWA, 4096); GQA kv=8.
"""
from repro_torch.models.config import ArchConfig
from repro_torch.sharding.plan import MeshPlan

CONFIG = ArchConfig(
    name="mixtral-8x22b",
    arch_type="moe",
    num_layers=56,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=16384,
    vocab_size=32768,
    d_head=128,
    rope_base=1e6,
    sliding_window=4096,
    num_experts=8,
    top_k=2,
    source="Mixtral of Experts [arXiv:2401.04088]",
)

PLAN = MeshPlan(train_factors=(2, 2, 4, 16), microbatch=1)
