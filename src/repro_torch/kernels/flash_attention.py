"""Flash attention forward and backward: online softmax over kv blocks, GQA,
causal and sliding-window masks.

Port of the Pallas kernel ``src/repro/kernels/flash_attention.py`` with the
contract of the model's jnp twin, ``src/repro/models/flash_jnp.py::_fwd``
(what the reference's dense layers run): ``q_offset`` and ``window`` are
runtime integers, T and S may be ragged, and kv positions ``>= S`` are
masked. The kernel is hand-written CUDA for Hopper
(``csrc/flash_attention.cu``; the note at its top says what bounds it and
what its design does about that); :func:`flash_attention_ref`, its plain
PyTorch version, is the port of ``flash_jnp._fwd`` with the same block
scan, so on the CPU the port computes what the JAX model computes.

The backward (:func:`flash_attention_bwd`, ``csrc/flash_attention_bwd.cu``)
ports the reference's hand-scheduled custom VJP, ``flash_jnp._vjp_bwd``: P
is rebuilt per kv block from q, k and the forward's row statistics m and l,
then dV, dP, dS, dQ and dK, in float32 (bf16 on the tensor cores, float32
on the CUDA cores). :class:`FlashAttention` ties the two
into a ``torch.autograd.Function`` (the counterpart of
``flash_jnp.flash_attention_vjp``); the model's training path calls it.

Dispatch is by the device of the tensors, as in the other kernel modules:
a CPU tensor takes the plain version, a CUDA tensor launches the kernel
(building it on first use), a ``meta`` tensor gets its outputs' shapes, any
other device raises. ``flash_attention.launches`` and
``flash_attention_bwd.launches`` count the kernel launches they make:
one a call for the forward, three for the backward; their ``calls`` count
the calls on every route. ``flash_attention_cost`` and
``flash_attention_bwd_cost`` give a call's (FLOPs, bytes) from its live
(query, key) pairs (:func:`live_pairs`).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.kernels.accounting import kernel_call, nbytes, peak_kind
from repro_torch.kernels.build import load
from repro_torch.kernels.mtgc_update import _check, _raise_on, _stream

NEG_INF = -1e30
HEAD_DIMS = (32, 64, 128)
_DTYPES = (torch.float32, torch.bfloat16)


def _expand_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """[B, S, Kv, Dh] -> [B, S, H, Dh] by repeating each kv head."""
    n_kv = k.shape[-2]
    return k if n_kv == n_heads else torch.repeat_interleave(k, n_heads // n_kv, dim=-2)


def _blocks(a: torch.Tensor, n_heads: int, nb: int, block: int) -> torch.Tensor:
    """[B, S, Kv, Dh] -> [B, H, nb * block, Dh] float32, kv heads expanded,
    zero-padded past S (``flash_jnp._blocks`` without the block axis)."""
    a = _expand_kv(a, n_heads).transpose(1, 2).to(torch.float32)
    pad = nb * block - a.shape[2]
    return torch.nn.functional.pad(a, (0, 0, 0, pad)) if pad else a


def _block_mask(qpos, ib: int, block: int, S: int, w_eff: int, causal: bool):
    """``flash_jnp._mask`` for kv block ``ib``: [T, block] bool."""
    kpos = ib * block + torch.arange(block, device=qpos.device)
    msk = (kpos[None, :] < S) & (kpos[None, :] > qpos[:, None] - w_eff)
    if causal:
        msk &= kpos[None, :] <= qpos[:, None]
    return msk


def flash_attention_ref(q, k, v, *, causal=True, window=0, q_offset=0, block=512,
                        return_stats=False):
    """Plain version: ``flash_jnp._fwd``'s online-softmax scan over kv blocks
    of ``block`` keys (zero-padded to a multiple), in float32.

    q: [B, T, H, Dh]; k/v: [B, S, Kv, Dh] (Kv divides H). A masked logit is
    -1e30; ``window <= 0`` means global (an effective window of S + T).
    Returns [B, T, H, Dh] in q's dtype, or with ``return_stats`` the tuple
    ``(o, m, l)``: each row's running max and sum, float32 [B, H, T], as
    ``_fwd`` returns them.
    """
    B, T, H, Dh = q.shape
    S = k.shape[1]
    scale = Dh ** -0.5
    w_eff = window if window > 0 else S + T
    qpos = torch.arange(T, device=q.device) + q_offset
    qh = q.transpose(1, 2).to(torch.float32)                     # [B, H, T, Dh]
    nb = -(-S // block)
    kh, vh = _blocks(k, H, nb, block), _blocks(v, H, nb, block)
    m = torch.full((B, H, T), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, T), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, T, Dh), dtype=torch.float32, device=q.device)
    for ib in range(nb):
        sl = slice(ib * block, (ib + 1) * block)
        logits = torch.einsum("bhqd,bhkd->bhqk", qh, kh[:, :, sl]) * scale
        msk = _block_mask(qpos, ib, block, S, w_eff, causal)
        logits = torch.where(msk, logits, torch.full_like(logits, NEG_INF))
        m_new = torch.maximum(m, logits.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(logits - m_new[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bhqk,bhkd->bhqd", p, vh[:, :, sl])
        m = m_new
    o = (acc / torch.clamp_min(l[..., None], 1e-30)).transpose(1, 2).to(q.dtype)
    return (o, m, l) if return_stats else o


def flash_attention_bwd_ref(q, k, v, o, do, m, l, *, causal=True, window=0, q_offset=0,
                            block=512):
    """Plain version of the backward: ``flash_jnp._vjp_bwd`` line for line,
    in float32. Per kv block of ``block`` keys, P is rebuilt from q, k and
    the forward's row statistics m, l ([B, H, T]); with D = rowsum(do * o):
    dv = P^T do, ds = P * (do v^T - D), dq += ds k * scale, dk = ds^T q *
    scale. dk and dv of each q head are summed over the heads that share a
    kv head (the transpose of the reference's ``_expand_kv``). Returns
    ``(dq [B, T, H, Dh], dk, dv [B, S, Kv, Dh])`` in the inputs' dtypes.
    """
    B, T, H, Dh = q.shape
    S, Kv = k.shape[1], k.shape[2]
    scale = Dh ** -0.5
    w_eff = window if window > 0 else S + T
    qpos = torch.arange(T, device=q.device) + q_offset
    qh = q.transpose(1, 2).to(torch.float32)
    doh = do.transpose(1, 2).to(torch.float32)
    oh = o.transpose(1, 2).to(torch.float32)
    dvec = torch.sum(doh * oh, dim=-1)                           # [B, H, T]
    linv = 1.0 / torch.clamp_min(l, 1e-30)
    nb = -(-S // block)
    kh, vh = _blocks(k, H, nb, block), _blocks(v, H, nb, block)
    dq = torch.zeros((B, H, T, Dh), dtype=torch.float32, device=q.device)
    dks, dvs = [], []
    for ib in range(nb):
        sl = slice(ib * block, (ib + 1) * block)
        kblk, vblk = kh[:, :, sl], vh[:, :, sl]
        logits = torch.einsum("bhqd,bhkd->bhqk", qh, kblk) * scale
        msk = _block_mask(qpos, ib, block, S, w_eff, causal)
        logits = torch.where(msk, logits, torch.full_like(logits, NEG_INF))
        p = torch.exp(logits - m[..., None]) * linv[..., None]
        dvs.append(torch.einsum("bhqk,bhqd->bhkd", p, doh))
        dp = torch.einsum("bhqd,bhkd->bhqk", doh, vblk)
        ds = p * (dp - dvec[..., None])
        dq = dq + torch.einsum("bhqk,bhkd->bhqd", ds, kblk) * scale
        dks.append(torch.einsum("bhqk,bhqd->bhkd", ds, qh) * scale)

    def unblock(parts):  # [B, H, nb * block, Dh] -> [B, S, Kv, Dh], group-summed
        a = torch.cat(parts, dim=2)[:, :, :S].transpose(1, 2)
        return a.reshape(B, S, Kv, H // Kv, Dh).sum(dim=3)

    return (dq.transpose(1, 2).to(q.dtype), unblock(dks).to(k.dtype),
            unblock(dvs).to(v.dtype))


@functools.lru_cache(maxsize=1024)
def live_pairs(T: int, S: int, q_offset: int = 0, window: int = 0, causal: bool = True) -> int:
    """Live (query, key) pairs of one head: query t (position q_offset + t)
    sees the keys k < S with k > q_offset + t - window (``window <= 0``:
    all) and, when causal, k <= q_offset + t -- the kernel's mask."""
    w_eff = window if window > 0 else S + T
    pos = np.arange(T, dtype=np.int64) + q_offset
    hi = np.minimum(pos + 1, S) if causal else np.full(T, S, dtype=np.int64)
    lo = np.maximum(pos - w_eff + 1, 0)
    return int(np.clip(hi - lo, 0, None).sum())


def flash_attention_cost(q, k, v, *, causal=True, window=0, q_offset=0, return_stats=False,
                         **_):
    """(FLOPs, bytes) of one forward call: q and k, v read once, o (and the
    float32 row statistics) written once; QK^T and PV, 2 Dh FLOPs each a
    live pair."""
    B, T, H, Dh = q.shape
    pairs = B * H * live_pairs(T, k.shape[1], int(q_offset), int(window), bool(causal))
    stats = 2 * B * H * T * 4 if return_stats else 0
    return 4 * Dh * pairs, 2 * nbytes(q) + nbytes(k, v) + stats


def flash_attention_bwd_cost(q, k, v, o, do, m, l, *, causal=True, window=0, q_offset=0, **_):
    """(FLOPs, bytes) of one backward call: q, o, do, k, v, m and l read
    once, dq, dk and dv written once; QK^T, dO V^T, dV, dQ and dK, 2 Dh
    FLOPs each a live pair."""
    B, T, H, Dh = q.shape
    pairs = B * H * live_pairs(T, k.shape[1], int(q_offset), int(window), bool(causal))
    return 10 * Dh * pairs, 4 * nbytes(q) + 4 * nbytes(k) + nbytes(m, l)


def flash_attention(q, k, v, *, causal=True, window=0, q_offset=0, block=512,
                    return_stats=False):
    """Forward attention (replaces the Pallas ``flash_attention``,
    src/repro/kernels/flash_attention.py:87). q: [B, T, H, Dh]; k/v:
    [B, S, Kv, Dh] with the kv heads unexpanded (head h reads kv head
    ``h // (H / Kv)``); float32 or bfloat16, one dtype for all three.
    ``q_offset``: absolute position of q[:, 0]; ``window > 0`` keeps keys
    with ``kpos > qpos - window``. ``block`` is the plain version's kv block
    (the kernel tiles by 128 keys in bfloat16, 64 in float32). Returns [B, T, H, Dh] in q's dtype.

    On the card, bfloat16 runs on the tensor cores (wgmma fed by TMA) and
    float32 on the CUDA cores; both agree with the plain version in float32
    to float32 rounding (bf16: plus the output's own rounding). The kernel
    needs Dh in (32, 64, 128), contiguous 16-byte-aligned operands whose
    strides are multiples of 16 bytes (TMA's rule), and a live key for every
    query row (always so for the model's calls; a row with none is rejected
    rather than averaged as the plain version would).

    ``return_stats=True`` returns ``(o, m, l)`` with each query row's
    running max and sum (float32 [B, H, T], the plain version's units), which
    the backward reads; the kernel writes them in its epilogue, and skips
    them when they are not asked for."""
    return kernel_call(flash_attention, lambda: _forward(q, k, v, causal, window, q_offset, block,
                       return_stats), flash_attention_cost, peak_kind(q.dtype), q, k, v,
                       causal=causal, window=window, q_offset=q_offset, return_stats=return_stats)


def _forward(q, k, v, causal, window, q_offset, block, return_stats):
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset, block=block, return_stats=return_stats)
    if q.device.type == "meta":
        B, T, H, _ = q.shape
        out = torch.empty_like(q)
        if not return_stats:
            return out
        return out, *(torch.empty((B, H, T), dtype=torch.float32, device="meta")
                      for _ in range(2))
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda (or meta, shapes only), got {q.device}")
    B, T, H, Dh, S, Kv = _check_attention_operands("forward", q, k, v)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if any(st * t.element_size() % 16 for st in t.stride()[:-1]):
            raise ValueError(f"{name}'s strides {t.stride()} are not multiples of 16 bytes")
    if B * H > 65535 or max(T, S) >= 2 ** 30:
        raise ValueError(f"B * H = {B * H} and T, S = {T}, {S} exceed the kernel's grid")
    window, q_offset = int(window), int(q_offset)
    w_eff = window if window > 0 else S + T
    if q_offset < 0 or S < 1 or q_offset + T - w_eff > S - 1:
        raise ValueError(f"some query row has no live key (S={S}, T={T}, q_offset={q_offset}, "
                         f"window={window})")
    out = torch.empty_like(q)
    m = l = None
    if return_stats:
        m = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
        l = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    if out.numel() > 0:
        err = load("flash_attention").flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if m is None else m.data_ptr(), None if l is None else l.data_ptr(),
            B, T, S, H, Kv, Dh, q_offset, window, int(bool(causal)), Dh ** -0.5,
            int(q.dtype == torch.bfloat16), _stream(q.device))
        _raise_on(err, "flash_attention")
        flash_attention.launches += 1
    return (out, m, l) if return_stats else out


def _check_attention_operands(what, q, k, v):
    """The operand rules both kernels share; returns (B, T, H, Dh, S, Kv)."""
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q and k must be [B, T, H, Dh] and [B, S, Kv, Dh], got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    B, T, H, Dh = q.shape
    S, Kv = k.shape[1], k.shape[2]
    _check("q", q, q.device, _DTYPES)
    _check("k", k, q.device, (q.dtype,), (B, S, Kv, Dh))
    _check("v", v, q.device, (q.dtype,), (B, S, Kv, Dh))
    if Kv < 1 or H % Kv:
        raise ValueError(f"the kv heads ({Kv}) must divide the heads ({H})")
    if Dh not in HEAD_DIMS:
        raise ValueError(f"head dim {Dh} is not one the {what} kernel is built for {HEAD_DIMS}")
    return B, T, H, Dh, S, Kv


def flash_attention_bwd(q, k, v, o, do, m, l, *, causal=True, window=0, q_offset=0,
                        block=512):
    """Backward attention (replaces ``flash_jnp._vjp_bwd``,
    src/repro/models/flash_jnp.py:100, the recompute schedule of the Pallas
    kernel). q, o, do: [B, T, H, Dh]; k, v: [B, S, Kv, Dh], kv heads
    unexpanded; m, l: the forward's float32 [B, H, T] row statistics
    (``flash_attention(..., return_stats=True)``). Returns ``(dq, dk, dv)``
    in the inputs' dtype; dk and dv sum the shares of the H / Kv q heads of
    each kv head. ``block`` is read by the plain version only (its kv
    block); the kernel's tiles are fixed.

    On the card it is three launches: dq (and each row's D), per-q-head
    dk/dv shares in float32 scratch of 2 x [B, S, H, Dh] that this wrapper
    allocates, their sum. bfloat16 runs on the tensor cores (wgmma fed by
    TMA; P and dS split into bf16 high and low parts), float32 on the CUDA
    cores; both agree with the plain version in float32 to float32
    rounding (bf16: plus the outputs' own rounding), and two calls on the
    same inputs give the same bits. Operand rules: the forward's
    (contiguous, 16-byte aligned, Dh in (32, 64, 128)); m and l contiguous
    float32."""
    return kernel_call(flash_attention_bwd, lambda: _backward(q, k, v, o, do, m, l, causal, window,
                       q_offset, block), flash_attention_bwd_cost, peak_kind(q.dtype), q, k, v, o,
                       do, m, l, causal=causal, window=window, q_offset=q_offset)


def _backward(q, k, v, o, do, m, l, causal, window, q_offset, block):
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, o, do, m, l, causal=causal, window=window,
                                       q_offset=q_offset, block=block)
    if q.device.type == "meta":
        return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd runs on cpu or cuda (or meta, shapes only), got {q.device}")
    B, T, H, Dh, S, Kv = _check_attention_operands("backward", q, k, v)
    _check("o", o, q.device, (q.dtype,), q.shape)
    _check("do", do, q.device, (q.dtype,), q.shape)
    _check("m", m, q.device, (torch.float32,), (B, H, T))
    _check("l", l, q.device, (torch.float32,), (B, H, T))
    for name, t in (("q", q), ("k", k), ("v", v), ("o", o), ("do", do)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    bf16 = q.dtype == torch.bfloat16
    if B * H >= 2 ** 31 or max(T, S) > 64 * 65535 or (bf16 and B > 65535):
        raise ValueError(f"B, H = {B}, {H} and T, S = {T}, {S} exceed the kernel's grid")
    w_eff = window if window > 0 else S + T
    if q_offset < 0 or q_offset + T - w_eff > S - 1:
        raise ValueError(f"some query row has no live key (S={S}, T={T}, q_offset={q_offset}, "
                         f"window={window})")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if dq.numel() == 0 or dk.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    lib = load("flash_attention_bwd")
    # Each row's D (bf16: with its log-sum-exp, padded to the kernel's tile).
    dvec = torch.empty((B, H, lib.flash_attention_bwd_dvec_floats(T, int(bf16))),
                       dtype=torch.float32, device=q.device)
    dk_part = torch.empty((B, S, H, Dh), dtype=torch.float32, device=q.device)
    dv_part = torch.empty_like(dk_part)
    err = lib.flash_attention_bwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(), m.data_ptr(),
        l.data_ptr(), dvec.data_ptr(), dk_part.data_ptr(), dv_part.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), B, T, S, H, Kv, Dh, int(q_offset), int(window),
        int(bool(causal)), Dh ** -0.5, int(bf16), _stream(q.device))
    _raise_on(err, "flash_attention_bwd")
    flash_attention_bwd.launches += 3      # dq and D, the dk/dv shares, their sum
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention (the counterpart of
    ``flash_jnp.flash_attention_vjp``): the forward kernel, keeping q, k, v,
    o and the row statistics m, l; the backward kernel on the way back. On
    CPU tensors both are the plain versions. Under
    ``torch.utils.checkpoint`` the forward runs again in the backward pass
    and the statistics come from that recompute.

        o = FlashAttention.apply(q, k, v, causal, window, q_offset, block)
    """

    @staticmethod
    def forward(ctx, q, k, v, causal=True, window=0, q_offset=0, block=512):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        o, m, l = flash_attention(q, k, v, causal=causal, window=window, q_offset=q_offset,
                                  block=block, return_stats=True)
        ctx.save_for_backward(q, k, v, o, m, l)
        ctx.opts = dict(causal=causal, window=window, q_offset=q_offset, block=block)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, m, l = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, do.contiguous(), m, l, **ctx.opts)
        return dq, dk, dv, None, None, None, None


flash_attention.cost = flash_attention_cost
flash_attention_bwd.cost = flash_attention_bwd_cost
WRAPPERS = (flash_attention, flash_attention_bwd)


def reset_launch_counts() -> None:
    """Set both wrappers' ``launches`` and ``calls`` counters to 0."""
    for w in WRAPPERS:
        w.launches = w.calls = 0


reset_launch_counts()
