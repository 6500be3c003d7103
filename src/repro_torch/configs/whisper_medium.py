"""Whisper-medium encoder-decoder backbone [arXiv:2212.04356].

The mel-spectrogram + conv2 frontend is a stub: the model takes the 1500
post-conv frame embeddings; the 24-layer bidirectional encoder runs over
those frames and the 24-layer causal decoder cross-attends to its output.
MHA (kv == heads = 16).
"""
from repro_torch.models.config import ArchConfig
from repro_torch.sharding.plan import MeshPlan

CONFIG = ArchConfig(
    name="whisper-medium",
    arch_type="audio",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4096,
    vocab_size=51865,
    d_head=64,
    encoder_layers=24,
    encoder_frames=1500,
    source="Whisper [arXiv:2212.04356], medium.en card",
)

PLAN = MeshPlan(train_factors=(8, 4, 1, 8), microbatch=2)
