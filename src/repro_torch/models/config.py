"""Architecture configuration of the LM stack (copy of
``src/repro/models/config.py``, field for field, so one set of keyword
arguments describes a model in both packages)."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    arch_type: str                 # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 128
    source: str = ""               # citation for the config

    # attention features
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_base: float = 10000.0
    sliding_window: int = 0        # 0 = global everywhere
    local_global_ratio: int = 0    # gemma3: N local layers per global layer
    tie_embeddings: bool = False

    # MoE
    num_experts: int = 0
    top_k: int = 0

    # SSM / hybrid
    ssm_state: int = 0
    ssm_d_inner: int = 0

    # enc-dec (audio) / vlm stubs
    encoder_layers: int = 0
    encoder_frames: int = 0        # whisper: 1500 post-conv frames
    vision_tokens: int = 0         # internvl2: patch embeddings per image
    vision_dim: int = 0

    # numerics
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"

    # execution knobs
    attn_block: int = 512          # blocked-attention KV block
    rwkv_chunk: int = 64
    remat: bool = True

    @property
    def vocab_padded(self) -> int:
        """Vocab rounded up to a multiple of 512 (tokens stay < vocab_size)."""
        return -(-self.vocab_size // 512) * 512

    @property
    def supports_decode(self) -> bool:
        return True  # all assigned archs have a decoder

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch serve 524k contexts without quadratic prefill /
        unbounded per-layer global attention?"""
        if self.arch_type in ("ssm", "hybrid"):
            return True
        if self.sliding_window > 0:
            return True            # mixtral SWA
        if self.local_global_ratio > 0:
            return True            # gemma3 local:global (decode is linear)
        return False

    def reduced(self, **over) -> "ArchConfig":
        """2-layer, narrow variant of the same family for CPU smoke tests."""
        small = dict(
            num_layers=2,
            d_model=128,
            num_heads=4,
            num_kv_heads=max(1, min(self.num_kv_heads, 2)),
            d_head=32,
            d_ff=256,
            vocab_size=256,
            num_experts=min(self.num_experts, 4) if self.num_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            ssm_state=self.ssm_state,
            ssm_d_inner=128 if self.ssm_d_inner else 0,
            encoder_layers=2 if self.encoder_layers else 0,
            encoder_frames=16 if self.encoder_frames else 0,
            vision_tokens=8 if self.vision_tokens else 0,
            vision_dim=32 if self.vision_dim else 0,
            sliding_window=min(self.sliding_window, 16) if self.sliding_window else 0,
            param_dtype="float32",
            compute_dtype="float32",
            attn_block=16,
            rwkv_chunk=4,
            remat=False,
        )
        small.update(over)
        return dataclasses.replace(self, **small)
