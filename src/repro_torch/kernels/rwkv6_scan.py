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

The backward, :func:`rwkv6_scan_bwd`, is a second hand-written kernel
(``csrc/rwkv6_scan_bwd.cu``: the forward's passes in reverse, their
products on the tensor cores at float32 accuracy (3xTF32), plus a fixed-
order reduction of du, four launches on ``rwkv6_scan_bwd.launches``); the
reference has none and trains by JAX's autodiff of the chunk form.
:func:`rwkv6_scan_bwd_ref` repeats its arithmetic. :class:`RWKV6Scan` is
the differentiable recurrence the model trains through on the card: its
forward keeps the scan kernel's chunk-start states for the backward.

Dispatch is by device: a CPU tensor takes the plain version, a CUDA tensor
launches the kernel (building it on first use) or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import load
from repro_torch.kernels.mtgc_update import _check, _raise_on, _stream

MAX_DH = 64
MAX_CHUNK = 64
SUB_CHUNK = 16          # the kernels' sub-chunk (csrc/rwkv6_tiles.cuh kSub)
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


def _to_chunks(tensors, chunk):
    """[B, T, H, Dh] tensors -> ([B, H, nc, C, Dh] float32 tensors, T), T
    padded to a chunk multiple with zeros (the model's padding: r = k = v =
    0, logw = 0; a zero do for the backward)."""
    B, T, H, Dh = tensors[0].shape
    C = min(chunk, T)
    pad = (-T) % C
    nc = (T + pad) // C
    out = []
    for a in tensors:
        if pad:
            a = torch.nn.functional.pad(a, (0, 0, 0, 0, 0, pad))
        out.append(a.reshape(B, nc, C, H, Dh).permute(0, 3, 1, 2, 4).to(torch.float32))
    return out, T


def _from_chunks(a, T):
    """[B, H, nc, C, Dh] -> [B, T, H, Dh] (the pad dropped)."""
    B, H, nc, C, Dh = a.shape
    return a.permute(0, 2, 3, 1, 4).reshape(B, nc * C, H, Dh)[:, :T]


def _anchors(lw_, sub):
    """The sub-chunks of each chunk (slices of the C axis, the last maybe
    shorter), ``lc`` (inclusive) and ``lx`` (exclusive) cumulative sums of
    logw from each sub-chunk's start, and each sub-chunk's total
    ([B, H, nc, 1, Dh] each)."""
    C = lw_.shape[3]
    subs = [slice(s, min(s + sub, C)) for s in range(0, C, sub)]
    lc = torch.cat([torch.cumsum(lw_[..., q, :], dim=3) for q in subs], dim=3)
    lx = torch.cat([torch.nn.functional.pad(lc[..., q, :][..., :-1, :], (0, 0, 1, 0))
                    for q in subs], dim=3)
    tot = [lc[..., q.stop - 1:q.stop, :] for q in subs]
    return subs, lc, lx, tot


def _run(tot, lo, hi):
    """tot[lo] + ... + tot[hi - 1], in that order."""
    acc = torch.zeros_like(tot[0])
    for j in range(lo, hi):
        acc = acc + tot[j]
    return acc


def _chunk_starts(k_, v_, lc, tot, subs, state):
    """Passes A and B of the forward: each chunk's starting state
    [B, H, nc, Dh, Dh] and the final state, from ``state``."""
    ns = len(subs)
    kd = torch.cat([k_[..., q, :] * torch.exp((_run(tot, j + 1, ns) + tot[j]) - lc[..., q, :])
                    for j, q in enumerate(subs)], dim=3)
    d_state = torch.einsum("bhcid,bhcie->bhcde", kd, v_)
    log_decay = _run(tot, 0, ns)[..., 0, :]                          # [B, H, nc, Dh]
    S = state.to(torch.float32)
    starts = []
    for c in range(k_.shape[2]):
        starts.append(S)
        S = torch.exp(log_decay[:, :, c])[..., None] * S + d_state[:, :, c]
    return torch.stack(starts, dim=2), S


def _att(r_, k_, rx, lx, lc, tot, subs):
    """att[t, i] = sum_d r[t] k[i] exp(cum_ex[t] - cum[i]) for i < t in one
    chunk ([B, H, nc, C, C]): pairwise decays inside a sub-chunk, and
    ``rx E kq`` products across sub-chunks (see rwkv6_chunk_parallel_ref)."""
    B, H, nc, C, _ = r_.shape
    att = torch.zeros(B, H, nc, C, C, dtype=torch.float32, device=r_.device)
    for j, q in enumerate(subs):
        n = q.stop - q.start
        tri = torch.tril(torch.ones((n, n), dtype=torch.bool, device=r_.device), -1)
        w = torch.exp(lx[..., q, None, :] - lc[..., None, q, :])
        w = torch.where(tri[..., None], w, torch.zeros((), device=r_.device))
        att[..., q, q] = torch.einsum("bhctd,bhcid,bhctid->bhcti", r_[..., q, :], k_[..., q, :], w)
        kq = k_[..., q, :] * torch.exp(tot[j] - lc[..., q, :])
        for jp in range(j + 1, len(subs)):
            p = subs[jp]
            att[..., p, q] = torch.einsum("bhctd,bhcid->bhcti",
                                          rx[..., p, :] * torch.exp(_run(tot, j + 1, jp)), kq)
    return att


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
    (r_, k_, v_, lw_), T = _to_chunks((r, k, v, logw), chunk)
    B, H, nc, C, Dh = r_.shape
    subs, lc, lx, tot = _anchors(lw_, sub)
    starts, S = _chunk_starts(k_, v_, lc, tot, subs, state)
    u = u.to(torch.float32).expand(B, H, Dh)[:, :, None, None, :]
    bonus = (r_ * u * k_).sum(-1, keepdim=True)
    rx = r_ * torch.exp(lx)
    att = _att(r_, k_, rx, lx, lc, tot, subs)
    ra = torch.cat([rx[..., p, :] * torch.exp(_run(tot, 0, jp)) for jp, p in enumerate(subs)],
                   dim=3)
    o = (torch.einsum("bhctd,bhcde->bhcte", ra, starts)
         + torch.einsum("bhcti,bhcie->bhcte", att, v_) + bonus * v_)
    return _from_chunks(o, T), S


def rwkv6_scan_bwd_ref(r, k, v, logw, u, state, do, d_final=None, *, chunk=64,
                       sub=SUB_CHUNK):
    """The backward of :func:`rwkv6_scan_bthd` in plain PyTorch, repeating
    the arithmetic of ``csrc/rwkv6_scan_bwd.cu``; for the tests and the
    card's checks. r/k/v/logw/do [B, T, H, Dh] (do float32), u [H, Dh],
    state [B, H, Dh, Dh], ``d_final`` the final state's gradient (None: 0).
    Returns (dr, dk, dv in r's dtype, dlogw float32 [B, T, H, Dh], du
    float32 [H, Dh], dstate float32 [B, H, Dh, Dh]).

    With G_t the gradient of the state after token t (G_T = d_final,
    G_{t-1} = r_t do_t^T + diag(w_t) G_t), per chunk of the forward's
    sub-chunk anchors (``lx``, ``lc``, ``tot``; factors fx = exp(lx),
    fc = exp(tot[q] - lc), eg[p] = exp(totals before p), ex[q] =
    exp(totals after q), E[p, q] = exp(totals strictly between)):

    A': the chunk's share of G at its start, (r fx eg)^T do, and its
        log-decay;
    B': the short reverse scan G_start = exp(log_decay) G_end + dG_c from
        ``d_final``, giving each chunk's end gradient Gend_c; dstate is
        chunk 0's G_start;
    C': with bm[t, i] = do_t . v_i and bd[t] = bm[t, t],
        dr = fx (eg S_c do + sum_{q<p} E[p, q] bm kq) + diag(p) + u k bd,
        dk = fc (ex Gend v + sum_{p>q} E[p, q] bm^T rx) + diag(q) + u r bd,
        dv = att^T do + (kq ex) Gend + (r . (u k)) do,
        where diag() are the pairs of one sub-chunk with their pairwise
        decays exp(lx[t] - lc[i]); and
        dlogw[s] = sum_j Send_c Gend_c + sum_{t >= s in c} (r dr')[t+1]
        - (k dk')[t], with dr', dk' the gradients less their u terms and
        Send_c the state at the chunk's end. The last term is the
        per-chunk form of sum_{t>s} r dr' - sum_{t>=s} k dk' over the whole
        sequence: the tokens after the chunk contribute sum_j Send Gend;
    du = sum over b and t of r k bd.
    """
    (r_, k_, v_, lw_, do_), T = _to_chunks((r, k, v, logw, do), chunk)
    B, H, nc, C, Dh = r_.shape
    subs, lc, lx, tot = _anchors(lw_, sub)
    ns = len(subs)
    starts, S_fin = _chunk_starts(k_, v_, lc, tot, subs, state)

    def per_row(f):  # a per-sub-chunk factor [B, H, nc, 1, Dh] on each row
        return torch.cat([f(j).expand(B, H, nc, q.stop - q.start, Dh)
                          for j, q in enumerate(subs)], dim=3)

    fx = torch.exp(lx)
    fc = torch.cat([torch.exp(tot[j] - lc[..., q, :]) for j, q in enumerate(subs)], dim=3)
    eg = per_row(lambda j: torch.exp(_run(tot, 0, j)))
    ex = per_row(lambda j: torch.exp(_run(tot, j + 1, ns)))
    rx, kq = r_ * fx, k_ * fc
    # Pass A'.
    d_g = torch.einsum("bhctd,bhcte->bhcde", rx * eg, do_)
    log_decay = _run(tot, 0, ns)[..., 0, :]
    # Pass B'.
    G = (torch.zeros_like(S_fin) if d_final is None else d_final.to(torch.float32))
    gend = [None] * nc
    for c in reversed(range(nc)):
        gend[c] = G
        G = torch.exp(log_decay[:, :, c])[..., None] * G + d_g[:, :, c]
    gend = torch.stack(gend, dim=2)                                    # [B, H, nc, Dh, Dh]
    # Pass C'.
    bm = torch.einsum("bhcte,bhcie->bhcti", do_, v_)
    bd = torch.diagonal(bm, dim1=-2, dim2=-1)[..., None]              # [B, H, nc, C, 1]
    dr_in = torch.zeros_like(r_)
    dk_in = torch.zeros_like(r_)
    dr_off = torch.zeros_like(r_)
    dk_off = torch.zeros_like(r_)
    for j, q in enumerate(subs):
        n = q.stop - q.start
        tri = torch.tril(torch.ones((n, n), dtype=torch.bool, device=r_.device), -1)
        w = torch.exp(lx[..., q, None, :] - lc[..., None, q, :])
        w = torch.where(tri[..., None], w, torch.zeros((), device=r_.device))
        b = torch.where(tri, bm[..., q, q], torch.zeros((), device=r_.device))
        dr_in[..., q, :] = torch.einsum("bhcti,bhcid,bhctid->bhctd", b, k_[..., q, :], w)
        dk_in[..., q, :] = torch.einsum("bhcti,bhctd,bhctid->bhcid", b, r_[..., q, :], w)
        for jp in range(j + 1, ns):
            p = subs[jp]
            e = torch.exp(_run(tot, j + 1, jp))
            dr_off[..., p, :] += e * torch.einsum("bhcti,bhcid->bhctd", bm[..., p, q],
                                                  kq[..., q, :])
            dk_off[..., q, :] += e * torch.einsum("bhcti,bhctd->bhcid", bm[..., p, q],
                                                  rx[..., p, :])
    dr_st = eg * torch.einsum("bhcde,bhcte->bhctd", starts, do_)
    dk_st = ex * torch.einsum("bhcde,bhcie->bhcid", gend, v_)
    dr_nb = fx * (dr_st + dr_off) + dr_in
    dk_nb = fc * (dk_st + dk_off) + dk_in
    uf = u.to(torch.float32).expand(H, Dh)[None, :, None, None, :]
    dr = dr_nb + uf * k_ * bd
    dk = dk_nb + uf * r_ * bd
    att = _att(r_, k_, rx, lx, lc, tot, subs)
    bonus = (r_ * uf * k_).sum(-1, keepdim=True)
    dv = (torch.einsum("bhcti,bhcte->bhcie", att, do_)
          + torch.einsum("bhcid,bhcde->bhcie", kq * ex, gend) + bonus * do_)
    send = torch.cat([starts[:, :, 1:], S_fin[:, :, None]], dim=2)
    kc = (send * gend).sum(-1)[..., None, :]                          # [B, H, nc, 1, Dh]
    z = torch.nn.functional.pad((r_ * dr_nb)[..., 1:, :], (0, 0, 0, 1)) - k_ * dk_nb
    dlogw = kc + torch.flip(torch.cumsum(torch.flip(z, (3,)), dim=3), (3,))
    du = (r_ * k_ * bd).sum(dim=(0, 2, 3))
    dt = r.dtype
    return (_from_chunks(dr, T).to(dt), _from_chunks(dk, T).to(dt), _from_chunks(dv, T).to(dt),
            _from_chunks(dlogw, T), du, G)


def rwkv6_scan_ref(r, k, v, logw, u, state, *, chunk=64):
    """Plain version on the Pallas signature: r/k/v/logw [BH, T, Dh]; u
    [BH, Dh]; state [BH, Dh, Dh]. Returns (o [BH, T, Dh] f32, state)."""
    o, s = rwkv6_chunked_ref(r[:, :, None], k[:, :, None], v[:, :, None], logw[:, :, None],
                             u[:, None], state[:, None], chunk=chunk)
    return o[:, :, 0], s[:, 0]


def _launch(r, k, v, logw, u, state, chunk, B, H, T, Dh, u_b_stride):
    """Check the operands (r/k/v/logw/o in the [B, T, H, Dh] element order;
    the Pallas signature is H = 1), launch the kernel, count it. Returns
    (o, final state, the chunk-start states [nc, B*H, Dh, Dh] of pass B)."""
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
    states = torch.empty(nc, B * H, Dh, Dh, dtype=torch.float32, device=dev)
    log_decay = torch.empty(B * H * nc * Dh, dtype=torch.float32, device=dev)
    err = load("rwkv6_scan").rwkv6_scan_launch(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(), u.data_ptr(),
        state.data_ptr(), o.data_ptr(), s_out.data_ptr(), states.data_ptr(),
        log_decay.data_ptr(), B, H, T, Dh, C, T * H * Dh, H * Dh, Dh, u_b_stride,
        int(r.dtype == torch.bfloat16), _stream(dev))
    _raise_on(err, "rwkv6_scan")
    rwkv6_scan.launches += 3       # chunk states, the scan over chunks, outputs
    return o, s_out, states


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
    return _launch(r, k, v, logw, u, state, chunk, BH, 1, T, Dh, Dh)[:2]


def _check_bthd(r, u, state, what):
    if r.dim() != 4 or u.dim() != 2 or state.dim() != 4:
        raise ValueError(f"{what} takes r [B, T, H, Dh], u [H, Dh], state [B, H, Dh, Dh]")
    B, T, H, Dh = r.shape
    if tuple(u.shape) != (H, Dh) or tuple(state.shape) != (B, H, Dh, Dh):
        raise ValueError(f"u {tuple(u.shape)} / state {tuple(state.shape)} do not match "
                         f"r {tuple(r.shape)}")
    return B, T, H, Dh


def rwkv6_scan_bthd(r, k, v, logw, u, state, *, chunk=64):
    """The recurrence in the model's layout: r/k/v [B, T, H, Dh] float32 or
    bfloat16, logw [B, T, H, Dh] float32, u [H, Dh] float32, state
    [B, H, Dh, Dh] float32. Returns (o [B, T, H, Dh] float32, final state)."""
    if r.device.type == "cpu":
        return rwkv6_chunked_ref(r, k, v, logw, u, state, chunk=chunk)
    if r.device.type != "cuda":
        raise ValueError(f"rwkv6_scan runs on cpu or cuda, got {r.device}")
    B, T, H, Dh = _check_bthd(r, u, state, "rwkv6_scan_bthd")
    return _launch(r, k, v, logw, u, state, chunk, B, H, T, Dh, 0)[:2]


def rwkv6_scan_bwd(r, k, v, logw, u, state, do, d_final=None, *, chunk=64, saved=None):
    """The backward of :func:`rwkv6_scan_bthd` (no Pallas counterpart: it
    replaces JAX's autodiff of src/repro/models/rwkv6.py::_rwkv6_chunked).
    Takes the forward's inputs, ``do`` [B, T, H, Dh] float32 and the final
    state's gradient ``d_final`` [B, H, Dh, Dh] (None: zero). Returns (dr,
    dk, dv in r's dtype, dlogw [B, T, H, Dh], du [H, Dh], dstate
    [B, H, Dh, Dh] float32).

    A CPU tensor takes :func:`rwkv6_scan_bwd_ref`. A CUDA tensor launches
    ``csrc/rwkv6_scan_bwd.cu`` (four kernels, counted on
    ``rwkv6_scan_bwd.launches``) on ``saved`` = (chunk-start states
    [nc, B*H, Dh, Dh], final state) as the forward kernel left them, or, when
    ``saved`` is None, on those of a forward launch made here."""
    if r.device.type == "cpu":
        return rwkv6_scan_bwd_ref(r, k, v, logw, u, state, do, d_final, chunk=chunk)
    if r.device.type != "cuda":
        raise ValueError(f"rwkv6_scan_bwd runs on cpu or cuda, got {r.device}")
    B, T, H, Dh = _check_bthd(r, u, state, "rwkv6_scan_bwd")
    if saved is None:
        _, s_final, states = _launch(r, k, v, logw, u, state, chunk, B, H, T, Dh, 0)
    else:
        states, s_final = saved
    return _launch_bwd(r, k, v, logw, u, do, d_final, states, s_final, chunk, B, H, T, Dh)


def _launch_bwd(r, k, v, logw, u, do, d_final, states, s_final, chunk, B, H, T, Dh):
    """Check the backward's operands, launch its kernels, count them."""
    dev = r.device
    if r.dtype not in _DTYPES:
        raise TypeError(f"r has dtype {r.dtype}; the kernel takes {_DTYPES}")
    for name, t in (("r", r), ("k", k), ("v", v)):
        _check(name, t, dev, (r.dtype,), r.shape)
    for name, t in (("logw", logw), ("do", do)):
        _check(name, t, dev, (torch.float32,), r.shape)
    _check("u", u, dev, (torch.float32,), (H, Dh))
    C = min(chunk, T)
    if not (1 <= Dh <= MAX_DH and 1 <= C <= MAX_CHUNK):
        raise ValueError(f"head dim {Dh} / chunk {chunk} (T = {T}) is outside the kernel's "
                         f"1..{MAX_DH} / 1..{MAX_CHUNK}")
    nc = -(-T // C)
    _check("states", states, dev, (torch.float32,), (nc, B * H, Dh, Dh))
    _check("final state", s_final, dev, (torch.float32,), (B, H, Dh, Dh))
    if d_final is not None:
        _check("d_final", d_final, dev, (torch.float32,), (B, H, Dh, Dh))
    dr, dk, dv = (torch.empty_like(r) for _ in range(3))
    dlogw = torch.empty_like(logw)
    du = torch.empty_like(u)
    dstate = torch.empty_like(s_final)
    # Scratch: each chunk's share of G at its start, then its end gradient;
    # its log-decay; its partial of du.
    grads = torch.empty_like(states)
    log_decay = torch.empty(nc * B * H * Dh, dtype=torch.float32, device=dev)
    du_part = torch.empty_like(log_decay)
    err = load("rwkv6_scan_bwd").rwkv6_scan_bwd_launch(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(), u.data_ptr(), do.data_ptr(),
        None if d_final is None else d_final.data_ptr(), states.data_ptr(), s_final.data_ptr(),
        dr.data_ptr(), dk.data_ptr(), dv.data_ptr(), dlogw.data_ptr(), du.data_ptr(),
        dstate.data_ptr(), grads.data_ptr(), log_decay.data_ptr(), du_part.data_ptr(),
        B, H, T, Dh, C, T * H * Dh, H * Dh, Dh, int(r.dtype == torch.bfloat16), _stream(dev))
    _raise_on(err, "rwkv6_scan_bwd")
    rwkv6_scan_bwd.launches += 4   # chunk grads, the reverse scan, outputs, du
    return dr, dk, dv, dlogw, du, dstate


class RWKV6Scan(torch.autograd.Function):
    """The differentiable recurrence in the model's layout (the arguments
    and results of :func:`rwkv6_scan_bthd`). On a CUDA tensor the forward
    launches the scan kernel and keeps its chunk-start states for the
    backward kernel (:func:`rwkv6_scan_bwd`); on a CPU tensor both take
    their plain versions. Under ``torch.utils.checkpoint`` the forward runs
    again in the backward pass and the states live only until its
    backward."""

    @staticmethod
    def forward(ctx, r, k, v, logw, u, state, chunk):
        if r.device.type == "cuda":
            B, T, H, Dh = _check_bthd(r, u, state, "RWKV6Scan")
            o, s_final, states = _launch(r, k, v, logw, u, state, chunk, B, H, T, Dh, 0)
            ctx.save_for_backward(r, k, v, logw, u, state, states, s_final)
        else:
            o, s_final = rwkv6_chunked_ref(r, k, v, logw, u, state, chunk=chunk)
            ctx.save_for_backward(r, k, v, logw, u, state)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return o, s_final

    @staticmethod
    def backward(ctx, do, d_final):
        r, k, v, logw, u, state, *saved = ctx.saved_tensors
        if do is None:
            do = torch.zeros(r.shape, dtype=torch.float32, device=r.device)
        grads = rwkv6_scan_bwd(r, k, v, logw, u, state, do.contiguous(),
                               None if d_final is None else d_final.contiguous(),
                               chunk=ctx.chunk, saved=saved or None)
        return (*(g if need else None for g, need in zip(grads, ctx.needs_input_grad)), None)


rwkv6_scan.launches = 0
rwkv6_scan_bwd.launches = 0


def reset_launch_counts() -> None:
    """Set the kernels' ``launches`` counters to 0."""
    rwkv6_scan.launches = 0
    rwkv6_scan_bwd.launches = 0
