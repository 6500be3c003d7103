"""Selective (Mamba-style) diagonal state-space scan of the hybrid family.

Per (b, di) and state s, with ``A = -exp(log_a)``::

    h_t[s] = exp(dt_t * A[di, s]) * h_{t-1}[s] + (dt_t * u_t) * B_t[s]
    y_t    = sum_s C_t[s] * h_t[s] + d_skip[di] * u_t

from ``h_{-1} = state0``. This is the recurrence that ``ssm_parallel``
evaluates with ``jax.lax.associative_scan`` in the reference
(``src/repro/models/ssm.py:80``; jnp, no Pallas call), and trains through
JAX's autodiff of it. The reference materialises ``decay`` and ``drive`` as
``[B, T, Di, S]`` float32 arrays; the kernels, hand-written CUDA for Hopper
(``csrc/ssm_scan.cu`` forward, ``csrc/ssm_scan_bwd.cu`` backward; the note
at the top of each says what bounds it and what its design does about
that), form them token by token and never write them out.

* :func:`selective_scan_ref` -- the forward's plain version: a sequential
  float32 loop over T with the same formula. The reference's chunks of 2048
  tokens, padded with decay 1 and drive 0, give the same recurrence, so both
  loop over all of T, whatever its length.
* :func:`selective_scan_bwd_ref` -- the backward's plain version: h
  recomputed forward, then a sequential float32 reverse loop (the gradients
  in ``csrc/ssm_scan_bwd.cu``'s note).
* :func:`selective_scan` / :func:`selective_scan_bwd` -- dispatch by device:
  a CPU tensor takes the plain version, a CUDA tensor launches the kernel
  (building it on first use) or raises. ``selective_scan.launches`` counts
  one a forward call; ``selective_scan_bwd.launches`` :data:`BWD_LAUNCHES`
  a backward call.
* :class:`SelectiveScan` -- the differentiable scan that training runs: on
  the card its forward keeps h at the start of every chunk of
  :data:`CHUNK` tokens, from which the backward kernel recomputes h.

The backward on an H100 80GB HBM3 at a 700 W limit. At hymba's training
shape (u [1, 2048, 3200] bf16, S = 16) the gradients need 106.2 MB moved
(their operands with state0 read once, their results written once: 0.0317
ms at 3.35 TB/s) and 209.7 M decays formed on the special-function unit
(0.050 ms). With B = 1 the work splits only over channels and T. The first design
(commit 5b5dfe8) swept each channel's whole T in one block (100 blocks of
16 warps, a thread a state) and took 0.494 ms. ``csrc/ssm_scan_bwd.cu``
splits the reverse sweep into chunks of 64 tokens: a carry pass and a fold
in chunk order give each chunk the gradient carry that enters it, then
3,200 blocks of (chunk, 32 channels), four threads a channel and four
states a thread, recompute h from the forward's states (kept every
:data:`CHUNK` = 16 tokens) and sweep back; a fourth launch takes the sums
over channels and chunks in a fixed order. It takes 0.242 ms, bound by
the chunk pass's instruction issue (PERF.md).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import load
from repro_torch.kernels.mtgc_update import _check, _raise_on, _stream

MAX_STATE = 16                 # csrc/ssm_scan.cu kMaxS
CHUNK = 16                     # csrc/ssm_scan.cu kChunk: tokens between saved states
BWD_LAUNCHES = 4               # carry pass, fold, chunk pass, reduction
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


def selective_scan_bwd_ref(u, dt, Bm, Cm, log_a, d_skip, state0, dy, d_final=None):
    """The backward's plain version: the forward's operands, ``dy`` [B, T,
    Di] and the final state's gradient ``d_final`` [B, Di, S] (None: zero).
    Returns (du in u's dtype, rounded once from float32; ddt [B, T, Di]; dB,
    dC [B, T, S]; dlog_a [Di, S]; dd_skip [Di]; dstate0 [B, Di, S]), all but
    du float32."""
    f32 = torch.float32
    u32, dt32, B32, C32, dy32 = (a.to(f32) for a in (u, dt, Bm, Cm, dy))
    A = -torch.exp(log_a.to(f32))
    T = u.shape[1]
    hs = [state0.to(f32)]
    for t in range(T):
        decay = torch.exp(dt32[:, t, :, None] * A)
        hs.append(decay * hs[-1] + (dt32[:, t] * u32[:, t])[:, :, None] * B32[:, t, None, :])
    carry = torch.zeros_like(hs[0]) if d_final is None else d_final.to(f32).clone()
    du, ddt = torch.empty_like(u32), torch.empty_like(u32)
    dB, dC = torch.empty_like(B32), torch.empty_like(C32)
    dla = torch.zeros_like(A)
    for t in range(T - 1, -1, -1):
        decay = torch.exp(dt32[:, t, :, None] * A)
        g = C32[:, t, None, :] * dy32[:, t, :, None] + carry          # [B, Di, S]
        hd = decay * hs[t]
        dC[:, t] = torch.einsum("bd,bds->bs", dy32[:, t], hs[t + 1])
        dB[:, t] = torch.einsum("bds,bd->bs", g, dt32[:, t] * u32[:, t])
        du[:, t] = (g * B32[:, t, None, :]).sum(-1) * dt32[:, t] + d_skip.to(f32) * dy32[:, t]
        ddt[:, t] = (g * (A * hd + u32[:, t, :, None] * B32[:, t, None, :])).sum(-1)
        dla += (g * hd * dt32[:, t, :, None]).sum(0)
        carry = decay * g
    return (du.to(u.dtype), ddt, dB, dC, A * dla, (dy32 * u32).sum((0, 1)), carry)


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


def _launch(u, dt, Bm, Cm, log_a, d_skip, state0, keep_states):
    """Check, launch the forward kernel, count it. Returns (y, final state,
    chunk-start states [B, ceil(T / CHUNK), Di, S] or None)."""
    B, T, Di, S = _check_operands(u, dt, Bm, Cm, log_a, d_skip, state0)
    y = torch.empty((B, T, Di), dtype=torch.float32, device=u.device)
    states = (torch.empty((B, -(-T // CHUNK), Di, S), dtype=torch.float32, device=u.device)
              if keep_states else None)
    if y.numel() == 0:
        if states is not None and states.numel():
            states.copy_(state0[:, None])
        return y, state0.clone(), states
    s_out = torch.empty_like(state0)
    lib = load("ssm_scan")
    args = (u.data_ptr(), dt.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), log_a.data_ptr(),
            d_skip.data_ptr(), state0.data_ptr(), y.data_ptr(), s_out.data_ptr())
    tail = (B, T, Di, S, int(u.dtype == torch.bfloat16), _stream(u.device))
    if keep_states:
        err = lib.selective_scan_states_launch(*args, states.data_ptr(), *tail)
    else:
        err = lib.selective_scan_launch(*args, *tail)
    _raise_on(err, "selective_scan")
    selective_scan.launches += 1
    return y, s_out, states


def _device(u, name):
    if u.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda, got {u.device}")
    return u.device.type


def selective_scan(u, dt, Bm, Cm, log_a, d_skip, state0, *, keep_states=False):
    """The scan (see the module docstring). u [B, T, Di] float32 or
    bfloat16; dt [B, T, Di], Bm and Cm [B, T, S], log_a [Di, S], d_skip
    [Di] and state0 [B, Di, S] float32; on a CUDA tensor all contiguous on
    one card, S at most 16. Returns (y [B, T, Di] float32, final state
    [B, Di, S] float32, a new tensor); with ``keep_states`` (CUDA tensors
    only) also h at the start of every chunk of :data:`CHUNK` tokens, [B,
    ceil(T / CHUNK), Di, S] float32 (chunk 0: state0)."""
    if _device(u, "selective_scan") == "cpu":
        if keep_states:
            raise ValueError("keep_states: the plain version keeps no chunk states")
        return selective_scan_ref(u, dt, Bm, Cm, log_a, d_skip, state0)
    y, s_out, states = _launch(u, dt, Bm, Cm, log_a, d_skip, state0, keep_states)
    return (y, s_out, states) if keep_states else (y, s_out)


def selective_scan_bwd(u, dt, Bm, Cm, log_a, d_skip, state0, dy, d_final=None, *,
                       states=None):
    """The backward of :func:`selective_scan` (no Pallas counterpart: it
    replaces JAX's autodiff of src/repro/models/ssm.py:80). Takes the
    forward's operands, ``dy`` [B, T, Di] float32 and ``d_final`` [B, Di, S]
    float32 (None: zero). Returns (du in u's dtype, ddt [B, T, Di], dB, dC
    [B, T, S], dlog_a [Di, S], dd_skip [Di], dstate0 [B, Di, S]), float32
    but du.

    A CPU tensor takes :func:`selective_scan_bwd_ref`. A CUDA tensor
    launches ``csrc/ssm_scan_bwd.cu`` (:data:`BWD_LAUNCHES` kernels, counted
    on ``selective_scan_bwd.launches``) on ``states``, the chunk-start states
    the forward kernel kept, or, when ``states`` is None, on those of a
    forward launch made here."""
    if _device(u, "selective_scan_bwd") == "cpu":
        return selective_scan_bwd_ref(u, dt, Bm, Cm, log_a, d_skip, state0, dy, d_final)
    B, T, Di, S = _check_operands(u, dt, Bm, Cm, log_a, d_skip, state0)
    dev = u.device
    _check("dy", dy, dev, _F32, (B, T, Di))
    if d_final is not None:
        _check("d_final", d_final, dev, _F32, (B, Di, S))
    if states is None:
        states = selective_scan(u, dt, Bm, Cm, log_a, d_skip, state0, keep_states=True)[2]
    _check("states", states, dev, _F32, (B, -(-T // CHUNK), Di, S))
    du, ddt = torch.empty_like(u), torch.empty_like(dt)
    dB, dC = torch.empty_like(Bm), torch.empty_like(Cm)
    dlog_a, dd_skip, dstate0 = (torch.empty_like(a) for a in (log_a, d_skip, state0))
    if u.numel() == 0:
        for t in (du, ddt, dB, dC, dlog_a, dd_skip):
            t.zero_()
        dstate0.copy_(d_final if d_final is not None else torch.zeros_like(state0))
        return du, ddt, dB, dC, dlog_a, dd_skip, dstate0
    lib = load("ssm_scan_bwd")
    scratch = bwd_scratch(lib, B, T, Di, S, dev)
    err = lib.selective_scan_bwd_launch(
        u.data_ptr(), dt.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), log_a.data_ptr(),
        d_skip.data_ptr(), dy.data_ptr(), None if d_final is None else d_final.data_ptr(),
        states.data_ptr(), du.data_ptr(), ddt.data_ptr(), dB.data_ptr(), dC.data_ptr(),
        dlog_a.data_ptr(), dd_skip.data_ptr(), dstate0.data_ptr(),
        *(t.data_ptr() for t in scratch), B, T, Di, S, int(u.dtype == torch.bfloat16),
        _stream(dev))
    _raise_on(err, "selective_scan_bwd")
    selective_scan_bwd.launches += BWD_LAUNCHES
    return du, ddt, dB, dC, dlog_a, dd_skip, dstate0


def bwd_scratch(lib, B, T, Di, S, device):
    """The float32 scratch (``torch.empty``) of the backward library ``lib``
    at (B, T, Di, S), sized by its ``selective_scan_bwd_scratch_floats``:
    dB's and dC's partial sums over each block's chains; per (b, chunk, di,
    s) the carry pass's L, the fold's carries and dlog_a's terms; per (b,
    chunk, di) the sums of dt and dd_skip's terms."""
    return tuple(torch.empty(lib.selective_scan_bwd_scratch_floats(i, B, T, Di, S),
                             dtype=torch.float32, device=device) for i in range(3))


class SelectiveScan(torch.autograd.Function):
    """The differentiable scan (the arguments and results of
    :func:`selective_scan`). On a CUDA tensor the forward launches the
    kernel and keeps its chunk-start states for the backward kernel
    (:func:`selective_scan_bwd`); on a CPU tensor both take their plain
    versions. Under ``torch.utils.checkpoint`` the forward runs again in the
    backward pass and the states live only until its backward. A gradient
    that is not asked for (``None``: the final state unused, or y) counts as
    zero."""

    @staticmethod
    def forward(ctx, u, dt, Bm, Cm, log_a, d_skip, state0):
        if _device(u, "SelectiveScan") == "cuda":
            y, s_final, states = selective_scan(u, dt, Bm, Cm, log_a, d_skip, state0,
                                                keep_states=True)
            ctx.save_for_backward(u, dt, Bm, Cm, log_a, d_skip, state0, states)
        else:
            y, s_final = selective_scan_ref(u, dt, Bm, Cm, log_a, d_skip, state0)
            ctx.save_for_backward(u, dt, Bm, Cm, log_a, d_skip, state0)
        ctx.set_materialize_grads(False)
        return y, s_final

    @staticmethod
    def backward(ctx, dy, d_final):
        u, dt, Bm, Cm, log_a, d_skip, state0, *saved = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros(u.shape, dtype=torch.float32, device=u.device)
        grads = selective_scan_bwd(u, dt, Bm, Cm, log_a, d_skip, state0, dy.contiguous(),
                                   None if d_final is None else d_final.contiguous(),
                                   states=saved[0] if saved else None)
        return tuple(g if need else None for g, need in zip(grads, ctx.needs_input_grad))


selective_scan.launches = 0
selective_scan_bwd.launches = 0


def reset_launch_counts() -> None:
    """Set the wrappers' ``launches`` counters to 0."""
    selective_scan.launches = 0
    selective_scan_bwd.launches = 0
