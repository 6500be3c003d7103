"""Upload compression round trips over ``[R, N]`` rows (one row = one upload).

Port of ``src/repro/kernels/quantize.py`` (the two Pallas kernels) and of
their oracles in ``src/repro/kernels/ref.py``. The kernels are hand-written
CUDA for Hopper (``csrc/quantize.cu``; the note at its top says what bounds
them and what the design does about it); the plain PyTorch versions live
beside them in this module.

* :func:`int8_roundtrip` -- stochastic int8 quantize + dequantize:
  ``clip(floor(u / scale + noise), -127, 127) * scale``, cast to
  ``u.dtype``. ``noise ~ U[0, 1)`` is an operand drawn by the caller, so the
  kernel, the plain version and the JAX package see the same numbers.
* :func:`topk_mask` -- ``where(|u| >= thresh[r], u, 0)``; every tie at the
  threshold is kept. The threshold (the row's k-th magnitude) is computed
  by the caller.

Dispatch is by the device of the tensors and nothing else, as in
``kernels/mtgc_update.py``: a CPU tensor takes the plain version, a CUDA
tensor launches the kernel (building it on first use) or raises. Each
wrapper carries an integer ``launches`` counter that goes up by one exactly
where its kernel is launched.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import load
from repro_torch.kernels.mtgc_update import _DTYPES, _check, _raise_on, _stream


def int8_roundtrip_ref(u, scale, noise):
    """Stochastic int8 quantize + dequantize. u/noise: [R, N]; scale: [R].

    The reference's operation order, each op rounded on its own in float32:
    ``u / s``, ``+ noise``, ``floor``, ``clamp(-127, 127)`` (NaN stays NaN),
    ``* s``, then the cast to ``u.dtype``.
    """
    s = scale.to(torch.float32)[:, None]
    q = torch.floor(u.to(torch.float32) / s + noise.to(torch.float32))
    q = torch.clamp(q, -127.0, 127.0)
    return (q * s).to(u.dtype)


def topk_mask_ref(u, thresh):
    """Keep entries with |u| >= per-row thresh (cast to u.dtype), zero the
    rest. u: [R, N]; thresh: [R]."""
    return torch.where(torch.abs(u) >= thresh.to(u.dtype)[:, None], u, torch.zeros_like(u))


def _check_rows(u: torch.Tensor) -> tuple[int, int]:
    if u.dim() != 2:
        raise ValueError(f"u must be [R, N], got shape {tuple(u.shape)}")
    _check("u", u, u.device, _DTYPES)
    return u.shape[0], u.shape[1]


def int8_roundtrip(u, scale, noise):
    """Stochastic int8 round trip of upload rows (replaces the Pallas
    ``int8_roundtrip``, src/repro/kernels/quantize.py:66). u: [R, N]
    float32 or bfloat16; noise: [R, N] float32; scale: [R] float32.
    Returns a new [R, N] tensor of u's dtype."""
    if u.device.type == "cpu":
        return int8_roundtrip_ref(u, scale, noise)
    if u.device.type != "cuda":
        raise ValueError(f"int8_roundtrip runs on cpu or cuda, got {u.device}")
    R, N = _check_rows(u)
    _check("noise", noise, u.device, (torch.float32,), (R, N))
    _check("scale", scale, u.device, (torch.float32,), (R,))
    out = torch.empty_like(u)
    if out.numel() == 0:
        return out
    err = load("quantize").int8_roundtrip_launch(
        u.data_ptr(), noise.data_ptr(), scale.data_ptr(), out.data_ptr(), R, N,
        int(u.dtype == torch.bfloat16), _stream(u.device))
    _raise_on(err, "int8_roundtrip")
    int8_roundtrip.launches += 1
    return out


def topk_mask(u, thresh):
    """Per-row magnitude sparsification of upload rows (replaces the Pallas
    ``topk_mask``, src/repro/kernels/quantize.py:96). u: [R, N] float32 or
    bfloat16; thresh: [R], cast to u's dtype as the reference casts it.
    Returns a new [R, N] tensor of u's dtype."""
    if u.device.type == "cpu":
        return topk_mask_ref(u, thresh)
    if u.device.type != "cuda":
        raise ValueError(f"topk_mask runs on cpu or cuda, got {u.device}")
    R, N = _check_rows(u)
    thresh = thresh.to(u.dtype).contiguous()  # a [R] column of topk's values
    _check("thresh", thresh, u.device, _DTYPES, (R,))
    out = torch.empty_like(u)
    if out.numel() == 0:
        return out
    err = load("quantize").topk_mask_launch(
        u.data_ptr(), thresh.data_ptr(), out.data_ptr(), R, N,
        int(u.dtype == torch.bfloat16), _stream(u.device))
    _raise_on(err, "topk_mask")
    topk_mask.launches += 1
    return out


int8_roundtrip.launches = 0
topk_mask.launches = 0


def reset_launch_counts() -> None:
    """Set both wrappers' ``launches`` counters to 0."""
    int8_roundtrip.launches = 0
    topk_mask.launches = 0
