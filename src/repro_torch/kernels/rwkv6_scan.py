"""Chunked RWKV-6 (Finch) recurrence with an f32 state carried across chunks.

Port of the Pallas kernel ``src/repro/kernels/rwkv6_scan.py``. Per (batch,
head), state S in R^{Dh x Dh}::

    o_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
    S_t = diag(exp(logw_t)) S_{t-1} + k_t v_t^T

The kernel is hand-written CUDA for Hopper (``csrc/rwkv6_scan.cu``: three
launches, chunk-parallel, with anchored sub-chunk decays; the note at its
top says what bounds it and what its design does about that). The plain
PyTorch version is the chunked form of the model's
``_rwkv6_chunked.chunk_fn`` (``src/repro/models/rwkv6.py:96-122``);
:func:`rwkv6_chunk_parallel_ref` repeats the kernel's own arithmetic for
the tests.

Two entry points launch the one kernel and count its launches on one
counter, ``rwkv6_scan.launches`` (three a call: the chunk states, the scan
over chunks, the outputs):

* :func:`rwkv6_scan` -- the Pallas signature: r/k/v/logw ``[BH, T, Dh]``,
  u ``[BH, Dh]``, state ``[BH, Dh, Dh]``;
* :func:`rwkv6_scan_bthd` -- the model's layout: r/k/v ``[B, T, H, Dh]`` in
  the param dtype, logw ``[B, T, H, Dh]`` float32, u ``[H, Dh]``, state
  ``[B, H, Dh, Dh]``; the kernel reads these tensors as they are.

Both return ``(o float32 in the inputs' layout, final state float32)``. A T
that is not a multiple of the chunk is padded with r = k = v = 0, logw = 0
(what the model does: the pad tokens leave the state unchanged); the
reference's Pallas kernel asserts ``T % chunk == 0`` instead. As in the
reference the chunk is ``min(chunk, T)``.

Dispatch is by device: a CPU tensor takes the plain version, a CUDA tensor
launches the kernel (building it on first use) or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import load
from repro_torch.kernels.mtgc_update import _check, _raise_on, _stream

MAX_DH = 64
MAX_CHUNK = 64
SUB_CHUNK = 16          # the kernel's sub-chunk (csrc/rwkv6_scan.cu kSub)
_DTYPES = (torch.float32, torch.bfloat16)


def rwkv6_chunked_ref(r, k, v, logw, u, state, *, chunk=64):
    """Plain version in the model's layout: r/k/v/logw [B, T, H, Dh]; u
    [H, Dh] (or [B, H, Dh]); state [B, H, Dh, Dh]. Returns (o [B, T, H, Dh]
    float32, final state float32)."""
    B, T, H, Dh = r.shape
    C = min(chunk, T)
    pad = (-T) % C
    if pad:
        r, k, v, logw = (torch.nn.functional.pad(a, (0, 0, 0, 0, 0, pad))
                         for a in (r, k, v, logw))
    nc = (T + pad) // C

    def resh(a):  # [B, Tp, H, Dh] -> [nc, B, H, C, Dh] float32
        return a.reshape(B, nc, C, H, Dh).permute(1, 0, 3, 2, 4).to(torch.float32)

    r_, k_, v_, lw_ = map(resh, (r, k, v, logw))
    u = u.to(torch.float32).expand(B, H, Dh)[:, :, None, :]          # [B, H, 1, Dh]
    tri = torch.tril(torch.ones((C, C), dtype=torch.bool, device=r.device), -1)
    S = state.to(torch.float32)
    outs = []
    for c in range(nc):
        rc, kc, vc, lwc = r_[c], k_[c], v_[c], lw_[c]                  # [B, H, C, Dh]
        cum = torch.cumsum(lwc, dim=2)                                 # inclusive
        cum_ex = cum - lwc                                             # exclusive
        a = rc * torch.exp(cum_ex)
        o_state = torch.einsum("bhcd,bhde->bhce", a, S)
        dmat = cum_ex[:, :, :, None, :] - cum[:, :, None, :, :]        # [B, H, C, C, Dh]
        w_pair = torch.where(tri[None, None, :, :, None], torch.exp(dmat),
                             torch.zeros((), dtype=torch.float32, device=r.device))
        att = torch.einsum("bhcd,bhid,bhcid->bhci", rc, kc, w_pair)
        o_intra = torch.einsum("bhci,bhie->bhce", att, vc)
        bonus = (rc * u * kc).sum(-1)                                  # [B, H, C]
        outs.append(o_state + o_intra + bonus[..., None] * vc)
        wtot = torch.exp(cum[:, :, -1, :])
        kdec = kc * torch.exp(cum[:, :, -1:, :] - cum)
        S = wtot[..., None] * S + torch.einsum("bhid,bhie->bhde", kdec, vc)
    o = torch.stack(outs).permute(1, 0, 3, 2, 4).reshape(B, T + pad, H, Dh)[:, :T]
    return o, S


def rwkv6_chunk_parallel_ref(r, k, v, logw, u, state, *, chunk=64, sub=SUB_CHUNK):
    """The kernel's arithmetic in plain PyTorch, for the tests: the three
    passes of ``csrc/rwkv6_scan.cu`` with its anchored sub-chunk factors.
    Same layout and result as :func:`rwkv6_chunked_ref`.

    Each chunk of C tokens is cut into sub-chunks of ``sub`` tokens (the
    last may be shorter). Inside sub-chunk q, ``lc`` is the inclusive and
    ``lx`` the exclusive cumulative sum of logw from the sub-chunk's start
    (``lx[t] = lc[t - 1]``, 0 at the start) and ``tot[q]`` its total; a
    chunk-wide sum is a sum of whole ``tot``s. So every exponent is a sum
    of logw over a run of tokens, never the difference of two long sums,
    and is <= 0 wherever logw <= 0:

    A: dS_c = (k * exp((suf[q] + tot[q]) - lc))^T v with suf[q] the sum of
       the later sub-chunks' totals, and the chunk's log-decay sum(tot);
    B: the short scan S_{c+1} = exp(sum(tot)) * S_c + dS_c from ``state``;
    C: o = ra S_c + att v + (r . (u * k)) v, with
       att[t, i] = sum_d r k exp(lx[t] - lc[i]) inside a sub-chunk, and for
       i in an earlier sub-chunk q (anchored at its last token e)
       att[t, i] = sum_d rx[t] E[p, q] kq[i], where rx = r exp(lx),
       kq = k exp(tot[q] - lc) = k exp(cum[e] - cum[i]) and
       E[p, q] = exp(sum of the totals strictly between q and p);
       ra = rx exp(sum of the totals before p).
    The reference's chunk form (and :func:`rwkv6_chunked_ref`) takes
    ``exp(cum_ex[t] - cum[i])`` from chunk-wide sums, which lose about one
    float32 ulp of |cum| to cancellation: up to 1e-3 on o at logw <= -5.
    """
    B, T, H, Dh = r.shape
    C = min(chunk, T)
    pad = (-T) % C
    if pad:
        r, k, v, logw = (torch.nn.functional.pad(a, (0, 0, 0, 0, 0, pad))
                         for a in (r, k, v, logw))
    nc = (T + pad) // C

    def resh(a):  # [B, Tp, H, Dh] -> [B, H, nc, C, Dh] float32
        return a.reshape(B, nc, C, H, Dh).permute(0, 3, 1, 2, 4).to(torch.float32)

    r_, k_, v_, lw_ = map(resh, (r, k, v, logw))
    subs = [slice(s, min(s + sub, C)) for s in range(0, C, sub)]
    lc = torch.cat([torch.cumsum(lw_[..., q, :], dim=3) for q in subs], dim=3)
    lx = torch.cat([torch.nn.functional.pad(lc[..., q, :][..., :-1, :], (0, 0, 1, 0))
                    for q in subs], dim=3)
    tot = [lc[..., q.stop - 1:q.stop, :] for q in subs]                # [B, H, nc, 1, Dh]

    def run(lo, hi):  # tot[lo] + ... + tot[hi - 1], in that order
        acc = torch.zeros_like(tot[0])
        for j in range(lo, hi):
            acc = acc + tot[j]
        return acc

    ns = len(subs)
    # Pass A.
    kd = torch.cat([k_[..., q, :] * torch.exp((run(j + 1, ns) + tot[j]) - lc[..., q, :])
                    for j, q in enumerate(subs)], dim=3)
    d_state = torch.einsum("bhcid,bhcie->bhcde", kd, v_)
    log_decay = run(0, ns)[..., 0, :]                                 # [B, H, nc, Dh]
    # Pass B.
    S = state.to(torch.float32)
    starts = []
    for c in range(nc):
        starts.append(S)
        S = torch.exp(log_decay[:, :, c])[..., None] * S + d_state[:, :, c]
    starts = torch.stack(starts, dim=2)                               # [B, H, nc, Dh, Dh]
    # Pass C.
    u = u.to(torch.float32).expand(B, H, Dh)[:, :, None, None, :]
    bonus = (r_ * u * k_).sum(-1, keepdim=True)
    rx = r_ * torch.exp(lx)
    att = torch.zeros(B, H, nc, C, C, dtype=torch.float32, device=r.device)
    for j, q in enumerate(subs):
        n = q.stop - q.start
        tri = torch.tril(torch.ones((n, n), dtype=torch.bool, device=r.device), -1)
        w = torch.exp(lx[..., q, None, :] - lc[..., None, q, :])
        w = torch.where(tri[..., None], w, torch.zeros((), device=r.device))
        att[..., q, q] = torch.einsum("bhctd,bhcid,bhctid->bhcti", r_[..., q, :], k_[..., q, :], w)
        kq = k_[..., q, :] * torch.exp(tot[j] - lc[..., q, :])
        for jp in range(j + 1, ns):
            p = subs[jp]
            att[..., p, q] = torch.einsum("bhctd,bhcid->bhcti",
                                          rx[..., p, :] * torch.exp(run(j + 1, jp)), kq)
    ra = torch.cat([rx[..., p, :] * torch.exp(run(0, jp)) for jp, p in enumerate(subs)], dim=3)
    o = (torch.einsum("bhctd,bhcde->bhcte", ra, starts)
         + torch.einsum("bhcti,bhcie->bhcte", att, v_) + bonus * v_)
    o = o.permute(0, 2, 3, 1, 4).reshape(B, T + pad, H, Dh)[:, :T]
    return o, S


def rwkv6_scan_ref(r, k, v, logw, u, state, *, chunk=64):
    """Plain version on the Pallas signature: r/k/v/logw [BH, T, Dh]; u
    [BH, Dh]; state [BH, Dh, Dh]. Returns (o [BH, T, Dh] f32, state)."""
    o, s = rwkv6_chunked_ref(r[:, :, None], k[:, :, None], v[:, :, None], logw[:, :, None],
                             u[:, None], state[:, None], chunk=chunk)
    return o[:, :, 0], s[:, 0]


def _launch(r, k, v, logw, u, state, chunk, B, H, T, Dh, u_b_stride):
    """Check the operands (r/k/v/logw/o in the [B, T, H, Dh] element order;
    the Pallas signature is H = 1), launch the kernel, count it."""
    dev = r.device
    if r.dtype not in _DTYPES:
        raise TypeError(f"r has dtype {r.dtype}; the kernel takes {_DTYPES}")
    for name, t in (("r", r), ("k", k), ("v", v)):
        _check(name, t, dev, (r.dtype,), r.shape)
    _check("logw", logw, dev, (torch.float32,), r.shape)
    _check("u", u, dev, (torch.float32,), u.shape)
    _check("state", state, dev, (torch.float32,), state.shape)
    if state.numel() != B * H * Dh * Dh:
        raise ValueError(f"state has shape {tuple(state.shape)}, expected {B * H} x {Dh} x {Dh}")
    if not 1 <= Dh <= MAX_DH:
        raise ValueError(f"head dim {Dh} exceeds the kernel's {MAX_DH}")
    C = min(chunk, T)
    if not 1 <= C <= MAX_CHUNK:
        raise ValueError(f"chunk {chunk} (T = {T}) is outside the kernel's 1..{MAX_CHUNK}")
    o = torch.empty(r.shape, dtype=torch.float32, device=dev)
    s_out = torch.empty_like(state)
    nc = -(-T // C)
    # Scratch of the three passes: each chunk's state (increment, then start)
    # and its log-decay.
    states = torch.empty(B * H * nc * Dh * Dh, dtype=torch.float32, device=dev)
    log_decay = torch.empty(B * H * nc * Dh, dtype=torch.float32, device=dev)
    err = load("rwkv6_scan").rwkv6_scan_launch(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(), u.data_ptr(),
        state.data_ptr(), o.data_ptr(), s_out.data_ptr(), states.data_ptr(),
        log_decay.data_ptr(), B, H, T, Dh, C, T * H * Dh, H * Dh, Dh, u_b_stride,
        int(r.dtype == torch.bfloat16), _stream(dev))
    _raise_on(err, "rwkv6_scan")
    rwkv6_scan.launches += 3       # chunk states, the scan over chunks, outputs
    return o, s_out


def rwkv6_scan(r, k, v, logw, u, state, *, chunk=64):
    """The recurrence on the Pallas signature (replaces the Pallas
    ``rwkv6_scan``, src/repro/kernels/rwkv6_scan.py:79). r/k/v: [BH, T, Dh]
    float32 or bfloat16; logw [BH, T, Dh], u [BH, Dh], state [BH, Dh, Dh]
    float32. Returns (o [BH, T, Dh] float32, final state)."""
    if r.device.type == "cpu":
        return rwkv6_scan_ref(r, k, v, logw, u, state, chunk=chunk)
    if r.device.type != "cuda":
        raise ValueError(f"rwkv6_scan runs on cpu or cuda, got {r.device}")
    if r.dim() != 3 or u.dim() != 2 or state.dim() != 3:
        raise ValueError("rwkv6_scan takes r [BH, T, Dh], u [BH, Dh], state [BH, Dh, Dh]")
    BH, T, Dh = r.shape
    if tuple(u.shape) != (BH, Dh) or tuple(state.shape) != (BH, Dh, Dh):
        raise ValueError(f"u {tuple(u.shape)} / state {tuple(state.shape)} do not match "
                         f"r {tuple(r.shape)}")
    return _launch(r, k, v, logw, u, state, chunk, BH, 1, T, Dh, Dh)


def rwkv6_scan_bthd(r, k, v, logw, u, state, *, chunk=64):
    """The recurrence in the model's layout: r/k/v [B, T, H, Dh] float32 or
    bfloat16, logw [B, T, H, Dh] float32, u [H, Dh] float32, state
    [B, H, Dh, Dh] float32. Returns (o [B, T, H, Dh] float32, final state)."""
    if r.device.type == "cpu":
        return rwkv6_chunked_ref(r, k, v, logw, u, state, chunk=chunk)
    if r.device.type != "cuda":
        raise ValueError(f"rwkv6_scan runs on cpu or cuda, got {r.device}")
    if r.dim() != 4 or u.dim() != 2 or state.dim() != 4:
        raise ValueError("rwkv6_scan_bthd takes r [B, T, H, Dh], u [H, Dh], "
                         "state [B, H, Dh, Dh]")
    B, T, H, Dh = r.shape
    if tuple(u.shape) != (H, Dh) or tuple(state.shape) != (B, H, Dh, Dh):
        raise ValueError(f"u {tuple(u.shape)} / state {tuple(state.shape)} do not match "
                         f"r {tuple(r.shape)}")
    return _launch(r, k, v, logw, u, state, chunk, B, H, T, Dh, 0)


rwkv6_scan.launches = 0


def reset_launch_counts() -> None:
    """Set the kernel's ``launches`` counter to 0."""
    rwkv6_scan.launches = 0
