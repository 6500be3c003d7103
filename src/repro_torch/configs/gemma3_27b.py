"""Gemma-3-27B dense decoder [hf:google/gemma-3 family]:
5 local (SWA-1024) layers per 1 global layer, 128k context, huge vocab."""
from repro_torch.models.config import ArchConfig
from repro_torch.sharding.plan import MeshPlan

CONFIG = ArchConfig(
    name="gemma3-27b",
    arch_type="dense",
    num_layers=62,
    d_model=5376,
    num_heads=32,
    num_kv_heads=16,
    d_ff=21504,
    vocab_size=262144,
    d_head=128,
    rope_base=1e6,
    sliding_window=1024,
    local_global_ratio=5,
    tie_embeddings=True,
    source="hf:google/gemma-3-1b-pt card family (assignment)",
)

PLAN = MeshPlan(train_factors=(2, 2, 4, 16), microbatch=1)
