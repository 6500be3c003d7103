"""Selective (Mamba-style) diagonal state-space scan of the hybrid family.

Per (b, di) and state s, with ``A = -exp(log_a)``::

    h_t[s] = exp(dt_t * A[di, s]) * h_{t-1}[s] + (dt_t * u_t) * B_t[s]
    y_t    = sum_s C_t[s] * h_t[s] + d_skip[di] * u_t

from ``h_{-1} = state0``. This is the recurrence that ``ssm_parallel``
evaluates with ``jax.lax.associative_scan`` in the reference
(``src/repro/models/ssm.py:80``; jnp, no Pallas call). The reference
materialises ``decay`` and ``drive`` as ``[B, T, Di, S]`` float32 arrays;
the kernel, hand-written CUDA for Hopper (``csrc/ssm_scan.cu``; the note
at its top says what bounds it and what its design does about that), forms
them token by token in registers and never writes them out.

:func:`selective_scan_ref` is the plain version: a sequential float32 loop
over T with the same formula. The reference's chunks of 2048 tokens,
padded with decay 1 and drive 0, give the same recurrence, so both loop
over all of T, whatever its length.

Dispatch is by device: a CPU tensor takes the plain version, a CUDA tensor
launches the kernel (building it on first use) or raises.
``selective_scan.launches`` counts the kernel's launches, one a call.
There is no backward kernel yet: serving comes first.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import load
from repro_torch.kernels.mtgc_update import _check, _raise_on, _stream

MAX_STATE = 16                 # csrc/ssm_scan.cu kMaxS
_U_DTYPES = (torch.float32, torch.bfloat16)
_F32 = (torch.float32,)


def selective_scan_ref(u, dt, Bm, Cm, log_a, d_skip, state0):
    """Plain version: u [B, T, Di] (any float dtype), dt [B, T, Di], Bm and
    Cm [B, T, S], log_a [Di, S], d_skip [Di], state0 [B, Di, S]. Returns
    (y [B, T, Di] float32, final state [B, Di, S] float32)."""
    u32 = u.to(torch.float32)
    A = -torch.exp(log_a.to(torch.float32))                      # [Di, S]
    h = state0.to(torch.float32)
    ys = []
    for t in range(u.shape[1]):
        d = dt[:, t].to(torch.float32)                            # [B, Di]
        decay = torch.exp(d[:, :, None] * A[None])                # [B, Di, S]
        drive = (d * u32[:, t])[:, :, None] * Bm[:, t, None, :].to(torch.float32)
        h = decay * h + drive
        ys.append(torch.einsum("bds,bs->bd", h, Cm[:, t].to(torch.float32))
                  + d_skip.to(torch.float32) * u32[:, t])
    if not ys:
        return torch.zeros(u.shape, dtype=torch.float32, device=u.device), h.clone()
    return torch.stack(ys, dim=1), h


def _check_operands(u, dt, Bm, Cm, log_a, d_skip, state0):
    """The kernel's operand rules; returns (B, T, Di, S)."""
    if u.dim() != 3 or Bm.dim() != 3:
        raise ValueError(f"u and Bm must be [B, T, Di] and [B, T, S], got {tuple(u.shape)} "
                         f"and {tuple(Bm.shape)}")
    B, T, Di = u.shape
    S = Bm.shape[-1]
    dev = u.device
    _check("u", u, dev, _U_DTYPES)
    _check("dt", dt, dev, _F32, (B, T, Di))
    _check("Bm", Bm, dev, _F32, (B, T, S))
    _check("Cm", Cm, dev, _F32, (B, T, S))
    _check("log_a", log_a, dev, _F32, (Di, S))
    _check("d_skip", d_skip, dev, _F32, (Di,))
    _check("state0", state0, dev, _F32, (B, Di, S))
    if not 1 <= S <= MAX_STATE:
        raise ValueError(f"state size {S} is not one the kernel takes (1 to {MAX_STATE})")
    return B, T, Di, S


def selective_scan(u, dt, Bm, Cm, log_a, d_skip, state0):
    """The scan (see the module docstring). u [B, T, Di] float32 or
    bfloat16; dt [B, T, Di], Bm and Cm [B, T, S], log_a [Di, S], d_skip
    [Di] and state0 [B, Di, S] float32; on a CUDA tensor all contiguous on
    one card, S at most 16. Returns (y [B, T, Di] float32, final state
    [B, Di, S] float32, a new tensor)."""
    if u.device.type == "cpu":
        return selective_scan_ref(u, dt, Bm, Cm, log_a, d_skip, state0)
    if u.device.type != "cuda":
        raise ValueError(f"selective_scan runs on cpu or cuda, got {u.device}")
    B, T, Di, S = _check_operands(u, dt, Bm, Cm, log_a, d_skip, state0)
    y = torch.empty((B, T, Di), dtype=torch.float32, device=u.device)
    if y.numel() == 0:
        return y, state0.clone()
    s_out = torch.empty_like(state0)
    err = load("ssm_scan").selective_scan_launch(
        u.data_ptr(), dt.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), log_a.data_ptr(),
        d_skip.data_ptr(), state0.data_ptr(), y.data_ptr(), s_out.data_ptr(), B, T, Di, S,
        int(u.dtype == torch.bfloat16), _stream(u.device))
    _raise_on(err, "selective_scan")
    selective_scan.launches += 1
    return y, s_out


selective_scan.launches = 0


def reset_launch_counts() -> None:
    """Set the wrapper's ``launches`` counter to 0."""
    selective_scan.launches = 0
