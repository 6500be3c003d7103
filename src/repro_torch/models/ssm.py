"""Selective (Mamba-style) diagonal SSM of the Hymba hybrid heads.

Port of ``src/repro/models/ssm.py``. Diagonal selective state space::

    h_t = exp(dt_t * A) * h_{t-1} + (dt_t * B_t) u_t      A = -exp(log_a)
    y_t = C_t . h_t + D * u_t

with input-dependent dt_t, B_t, C_t (the "selective" part).

* :func:`ssm_parallel` -- prefill and the forward pass: the gates in
  PyTorch (the products stay ``torch.matmul``), then the recurrence
  through ``kernels/ssm_scan.py::selective_scan`` (the CUDA kernel on a
  CUDA tensor, its plain sequential loop on a CPU tensor), which forms
  ``decay`` and ``drive`` token by token: the ``[B, T, Di, S]`` arrays the
  reference's ``associative_scan`` materialises never exist here. When a
  gradient is wanted it goes through ``SelectiveScan`` instead, whose
  backward is the CUDA backward kernel on the card and the plain reverse
  loop on the CPU (the reference differentiates its scan with JAX's
  autodiff).
* :func:`ssm_step` -- decode: the O(1) one-token update, plain PyTorch (the
  reference has no kernel for it).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssm_scan import SelectiveScan, selective_scan
from repro_torch.models.layers import init_linear, linear


def init_ssm(gen, d_model, d_inner, d_state, dtype, device):
    """The reference's leaves, shapes and dtypes: the projections in the
    param dtype, ``log_a`` [Di, S] and ``d_skip`` [Di] in float32 whatever
    the param dtype."""
    log_a = torch.log(torch.linspace(1.0, float(d_state), d_state, dtype=torch.float32,
                                     device=device))
    return {
        "win": init_linear(gen, d_model, d_inner, dtype, device),
        "wdt": init_linear(gen, d_model, d_inner, dtype, device, bias=True),
        "wb": init_linear(gen, d_model, d_state, dtype, device),
        "wc": init_linear(gen, d_model, d_state, dtype, device),
        "wout": init_linear(gen, d_inner, d_model, dtype, device),
        "log_a": log_a[None, :] + torch.zeros((d_inner, d_state), dtype=torch.float32,
                                              device=device),
        "d_skip": torch.ones((d_inner,), dtype=torch.float32, device=device),
    }


def _gates(p, x):
    """u [B, T, Di] (x's dtype), dt [B, T, Di], Bm and Cm [B, T, S] (float32),
    in the reference's order of operations."""
    u = F.silu(linear(p["win"], x))
    dt = F.softplus(linear(p["wdt"], x).to(torch.float32))
    Bm = linear(p["wb"], x).to(torch.float32)
    Cm = linear(p["wc"], x).to(torch.float32)
    return u, dt, Bm, Cm


def ssm_parallel(p, x, state, chunk: int = 2048):
    """x: [B, T, D]; state: [B, Di, S] float32 -> (out [B, T, D], new state).

    ``chunk`` is the reference's: it bounds the live ``[B, C, Di, S]``
    arrays of its associative scan. The scan here materialises none, so
    one call covers all T (the padded chunks give the same recurrence)."""
    u, dt, Bm, Cm = _gates(p, x)
    args = (u, dt, Bm, Cm, p["log_a"], p["d_skip"], state.to(torch.float32))
    if torch.is_grad_enabled() and any(a.requires_grad for a in args):
        y, state = SelectiveScan.apply(*args)
    else:
        y, state = selective_scan(*args)
    return linear(p["wout"], y.to(x.dtype)), state


def ssm_step(p, x_t, state):
    """x_t: [B, D]; state: [B, Di, S] float32 -> (out [B, D], new state)."""
    u, dt, Bm, Cm = (a[:, 0] for a in _gates(p, x_t[:, None]))
    A = -torch.exp(p["log_a"])
    decay = torch.exp(dt[:, :, None] * A[None])
    drive = (dt * u.to(torch.float32))[:, :, None] * Bm[:, None, :]
    state = decay * state + drive
    y = torch.einsum("bds,bs->bd", state, Cm) + p["d_skip"] * u.to(torch.float32)
    return linear(p["wout"], y.to(x_t.dtype)), state
