"""InternVL2-26B language backbone (InternLM2-20B-chat side) [arXiv:2404.16821].

The InternViT-6B vision tower is a stub: the model takes 256 pre-computed
patch embeddings (pixel-shuffled tile tokens) of width 3200 a sample; the
MLP projector and the decoder are implemented.
"""
from repro_torch.models.config import ArchConfig
from repro_torch.sharding.plan import MeshPlan

CONFIG = ArchConfig(
    name="internvl2-26b",
    arch_type="vlm",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=16384,
    vocab_size=92553,
    d_head=128,
    rope_base=1e6,
    vision_tokens=256,
    vision_dim=3200,
    source="InternVL2 [arXiv:2404.16821]; InternLM2-20B backbone",
)

PLAN = MeshPlan(train_factors=(2, 2, 4, 16), microbatch=2)
