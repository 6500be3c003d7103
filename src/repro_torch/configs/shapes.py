"""Assigned input shapes -> tensors on the ``meta`` device (no allocation;
port of ``src/repro/configs/shapes.py``, where ``jax.ShapeDtypeStruct``
stands).

SHAPES (assignment):
    train_4k     seq  4,096   global_batch 256   (training, one MTGC round)
    prefill_32k  seq 32,768   global_batch  32   (inference prefill)
    decode_32k   seq 32,768   global_batch 128   (one-token decode, 32k cache)
    long_500k    seq 524,288  global_batch   1   (long-context decode)

``train_specs`` shapes one *global round* of batches
``[E, H, A, G, K, chunk, T]``: E group rounds x H local steps x A
grad-accumulation chunks; ``chunk = microbatch * F`` samples live at once
per client (sharded over the client's fsdp submesh). ``serve_specs`` shapes
the request batch + KV/recurrent cache for the serve step.

``long_500k`` is only generated for sub-quadratic archs
(``cfg.sub_quadratic``); asking for it on a full-attention arch raises
``SkipShape``, an assignment-sanctioned skip.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.core.device import MetaFactories
from repro_torch.models.config import ArchConfig
from repro_torch.sharding.plan import MeshPlan

SHAPES = {
    "train_4k": dict(seq_len=4096, global_batch=256, kind="train"),
    "prefill_32k": dict(seq_len=32768, global_batch=32, kind="prefill"),
    "decode_32k": dict(seq_len=32768, global_batch=128, kind="decode"),
    "long_500k": dict(seq_len=524288, global_batch=1, kind="decode"),
}


class SkipShape(Exception):
    """(arch, shape) pair excluded by the assignment's skip rules."""


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(int(s) for s in shape), dtype=dtype, device="meta")


def _frontend_train(cfg: ArchConfig, lead, seq):
    """Stub-modality extras + the effective text length for VLM/audio."""
    extras = {}
    t_text = seq
    if cfg.arch_type == "vlm":
        t_text = seq - cfg.vision_tokens
        extras["patches"] = _sds(lead + (cfg.vision_tokens, cfg.vision_dim), torch.bfloat16)
    if cfg.arch_type == "audio":
        extras["frames"] = _sds(lead + (cfg.encoder_frames, cfg.d_model), torch.bfloat16)
    return extras, t_text


def train_specs(cfg: ArchConfig, plan: MeshPlan, *, multi_pod: bool = False) -> dict:
    """Batch meta tensors for one MTGC global round of ``train_4k``."""
    s = SHAPES["train_4k"]
    G, K, F, M = plan.train_factors
    if multi_pod:
        G *= 2  # pods multiply the group axis; global batch stays pinned
    B_c = s["global_batch"] // (G * K)          # per-client batch per step
    chunk = min(plan.microbatch * F, B_c)       # live samples per client
    A = max(B_c // chunk, 1)                    # grad-accumulation steps
    E, H = plan.dryrun_E, plan.dryrun_H
    lead = (E, H, A, G, K, chunk)
    extras, t_text = _frontend_train(cfg, lead, s["seq_len"])
    return {
        "tokens": _sds(lead + (t_text,), torch.int32),
        "targets": _sds(lead + (t_text,), torch.int32),
        **extras,
    }


def serve_specs(cfg: ArchConfig, shape_id: str) -> dict[str, Any]:
    """Request batch + cache meta tensors for prefill/decode shapes."""
    s = SHAPES[shape_id]
    kind, B, S = s["kind"], s["global_batch"], s["seq_len"]
    if shape_id == "long_500k" and not cfg.sub_quadratic:
        raise SkipShape(
            f"{cfg.name}: pure full-attention arch; long_500k skipped per "
            "assignment (no sub-quadratic variant)"
        )
    dt = getattr(torch, cfg.param_dtype)
    Lh = cfg.num_layers

    cache: dict[str, Any] = {}
    if cfg.arch_type != "ssm":
        kvshape = (Lh, B, S, cfg.num_kv_heads, cfg.d_head)
        cache["k"] = _sds(kvshape, dt)
        cache["v"] = _sds(kvshape, dt)
    if cfg.arch_type == "ssm":
        dh = cfg.d_model // cfg.num_heads
        cache["state"] = _sds((Lh, B, cfg.num_heads, dh, dh), torch.float32)
        cache["x_prev"] = _sds((Lh, B, cfg.d_model), dt)
        cache["ffn_prev"] = _sds((Lh, B, cfg.d_model), dt)
    if cfg.arch_type == "hybrid":
        di = cfg.ssm_d_inner or cfg.d_model
        cache["sstate"] = _sds((Lh, B, di, cfg.ssm_state), torch.float32)

    if kind == "prefill":
        t_text = S
        batch: dict[str, Any] = {}
        if cfg.arch_type == "vlm":
            t_text = S - cfg.vision_tokens
            batch["patches"] = _sds((B, cfg.vision_tokens, cfg.vision_dim), torch.bfloat16)
        if cfg.arch_type == "audio":
            # serving: the (stubbed) encoder runs once at admission; the
            # prefill consumes its memory directly.
            batch["memory"] = _sds((B, cfg.encoder_frames, cfg.d_model), dt)
        batch["tokens"] = _sds((B, t_text), torch.int32)
        return {"batch": batch, "cache": cache}

    batch = {"token": _sds((B, 1), torch.int32), "index": _sds((), torch.int32)}
    if cfg.arch_type == "audio":
        batch["memory"] = _sds((B, cfg.encoder_frames, cfg.d_model), dt)
    return {"batch": batch, "cache": cache}


def param_specs(cfg: ArchConfig, bundle) -> Any:
    """The model's full-size parameter tree as ``meta`` tensors (no
    allocation, nothing drawn): ``bundle.init`` run with every factory
    call sent to the meta device."""
    with MetaFactories():
        return bundle.init(0, device="cpu")
