"""RWKV-6 "Finch" time mixing (attention-free, data-dependent decay).

Port of ``src/repro/models/rwkv6.py``. Recurrence per head (state S in
R^{Dk x Dv}, float32)::

    o_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
    S_t = diag(w_t) S_{t-1} + k_t v_t^T        with  w_t = exp(-exp(x_w(t)))

* :func:`rwkv6_chunked` -- training and prefill: the chunked parallel
  form, through ``kernels/rwkv6_scan.py::rwkv6_scan_bthd`` (the CUDA kernel
  on a CUDA tensor, its plain version on a CPU tensor), which reads the
  projections in their [B, T, H, Dh] layout and pads a ragged T itself.
  With grad enabled on a CUDA tensor it goes through ``RWKV6Scan``, whose
  backward is the scan's backward kernel; on a CPU tensor autograd
  differentiates the plain version (the reference's ``chunk_fn``
  arithmetic, which ``jax.vjp`` differentiates the same way).
* :func:`rwkv6_step` -- decode: the O(1) one-token update, plain PyTorch
  (the reference has no kernel for it).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.rwkv6_scan import RWKV6Scan, rwkv6_scan_bthd
from repro_torch.models.layers import init_linear, init_rms, linear, rms_norm


def init_rwkv6(gen, d_model, n_heads, dtype, device):
    d_head = d_model // n_heads
    p = {
        "wr": init_linear(gen, d_model, d_model, dtype, device),
        "wk": init_linear(gen, d_model, d_model, dtype, device),
        "wv": init_linear(gen, d_model, d_model, dtype, device),
        "wg": init_linear(gen, d_model, d_model, dtype, device),
        "wd": init_linear(gen, d_model, d_model, dtype, device),  # decay projection
        "wo": init_linear(gen, d_model, d_model, dtype, device),
        "u": 0.1 * torch.randn((n_heads, d_head), generator=gen, dtype=torch.float32,
                               device=device),
        "decay_base": torch.full((d_model,), -1.0, dtype=torch.float32, device=device),
        "mix": torch.full((4, d_model), 0.5, dtype=dtype, device=device),  # r/k/v/d shift mix
        "ln_out": init_rms(d_model, dtype, device),
    }
    return p


def _proj(p, x, x_prev, n_heads):
    """Token-shifted projections -> r, k, v ([B, T, H, Dh], param dtype),
    log-decay ([B, T, H, Dh] float32) and the gate g ([B, T, D])."""
    B, T, D = x.shape
    xs = torch.cat([x_prev[:, None], x[:, :-1]], dim=1)  # shifted input

    def mix(i):
        m = p["mix"][i]
        return x * m + xs * (1 - m)

    r = linear(p["wr"], mix(0))
    k = linear(p["wk"], mix(1))
    v = linear(p["wv"], mix(2))
    d = linear(p["wd"], mix(3)).to(torch.float32)
    g = F.silu(linear(p["wg"], x))
    # log w_t = -exp(base + tanh(d)) in (-inf, 0): per-token per-channel decay
    logw = -torch.exp(p["decay_base"] + torch.tanh(d))          # [B, T, D] f32
    shp = (B, T, n_heads, D // n_heads)
    return r.reshape(shp), k.reshape(shp), v.reshape(shp), logw.reshape(shp), g


def rwkv6_chunked(p, x, x_prev, state, *, n_heads, chunk=64):
    """x: [B, T, D]; x_prev: [B, D]; state: [B, H, Dk, Dv] float32.
    Returns (out [B, T, D], last x [B, D], new state)."""
    B, T, D = x.shape
    r, k, v, logw, g = _proj(p, x, x_prev, n_heads)
    args = (r, k, v, logw, p["u"].to(torch.float32), state.to(torch.float32).contiguous())
    if torch.is_grad_enabled() and x.device.type == "cuda":
        o, state = RWKV6Scan.apply(*args, chunk)
    else:
        o, state = rwkv6_scan_bthd(*args, chunk=chunk)
    o = rms_norm(o.reshape(B, T, D).to(x.dtype), p["ln_out"])
    return linear(p["wo"], o * g), x[:, -1], state


def rwkv6_step(p, x_t, x_prev, state, *, n_heads):
    """Single-token decode. x_t: [B, D]; state: [B, H, Dk, Dv] float32."""
    B, D = x_t.shape
    r, k, v, logw, g = _proj(p, x_t[:, None], x_prev, n_heads)
    r, k, v, logw = (a[:, 0].to(torch.float32) for a in (r, k, v, logw))
    g = g[:, 0]
    u = p["u"].to(torch.float32)
    kv = torch.einsum("bhd,bhe->bhde", k, v)
    o = torch.einsum("bhd,bhde->bhe", r, state + u[None, :, :, None] * kv)
    state = torch.exp(logw)[..., None] * state + kv
    o = rms_norm(o.reshape(B, D).to(x_t.dtype), p["ln_out"])
    return linear(p["wo"], o * g), x_t, state
