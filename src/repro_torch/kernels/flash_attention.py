"""Forward flash attention: online softmax over kv blocks, GQA, causal and
sliding-window masks.

Port of the Pallas kernel ``src/repro/kernels/flash_attention.py`` with the
contract of the model's jnp twin, ``src/repro/models/flash_jnp.py::_fwd``
(what the reference's dense layers run): ``q_offset`` and ``window`` are
runtime integers, T and S may be ragged, and kv positions ``>= S`` are
masked. The kernel is hand-written CUDA for Hopper
(``csrc/flash_attention.cu``; the note at its top says what bounds it and
what its design does about that); :func:`flash_attention_ref`, its plain
PyTorch version, is the port of ``flash_jnp._fwd`` with the same block
scan, so on the CPU the port computes what the JAX model computes.

Dispatch is by the device of the tensors, as in the other kernel modules:
a CPU tensor takes the plain version, a CUDA tensor launches the kernel
(building it on first use) or raises. ``flash_attention.launches`` goes up
by one exactly where the kernel is launched.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import load
from repro_torch.kernels.mtgc_update import _check, _raise_on, _stream

NEG_INF = -1e30
HEAD_DIMS = (32, 64, 128)
_DTYPES = (torch.float32, torch.bfloat16)


def _expand_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """[B, S, Kv, Dh] -> [B, S, H, Dh] by repeating each kv head."""
    n_kv = k.shape[-2]
    return k if n_kv == n_heads else torch.repeat_interleave(k, n_heads // n_kv, dim=-2)


def flash_attention_ref(q, k, v, *, causal=True, window=0, q_offset=0, block=512):
    """Plain version: ``flash_jnp._fwd``'s online-softmax scan over kv blocks
    of ``block`` keys (zero-padded to a multiple), in float32.

    q: [B, T, H, Dh]; k/v: [B, S, Kv, Dh] (Kv divides H). A masked logit is
    -1e30; ``window <= 0`` means global (an effective window of S + T).
    Returns [B, T, H, Dh] in q's dtype.
    """
    B, T, H, Dh = q.shape
    S = k.shape[1]
    scale = Dh ** -0.5
    w_eff = window if window > 0 else S + T
    qpos = torch.arange(T, device=q.device) + q_offset
    qh = q.transpose(1, 2).to(torch.float32)                     # [B, H, T, Dh]
    nb = -(-S // block)
    pad = nb * block - S

    def blocks(a):  # [B, S, Kv, Dh] -> [B, H, nb * block, Dh] float32
        a = _expand_kv(a, H).transpose(1, 2).to(torch.float32)
        return torch.nn.functional.pad(a, (0, 0, 0, pad)) if pad else a

    kh, vh = blocks(k), blocks(v)
    m = torch.full((B, H, T), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, T), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, T, Dh), dtype=torch.float32, device=q.device)
    for ib in range(nb):
        sl = slice(ib * block, (ib + 1) * block)
        kpos = ib * block + torch.arange(block, device=q.device)
        logits = torch.einsum("bhqd,bhkd->bhqk", qh, kh[:, :, sl]) * scale
        msk = (kpos[None, :] < S) & (kpos[None, :] > qpos[:, None] - w_eff)
        if causal:
            msk &= kpos[None, :] <= qpos[:, None]
        logits = torch.where(msk, logits, torch.full_like(logits, NEG_INF))
        m_new = torch.maximum(m, logits.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(logits - m_new[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bhqk,bhkd->bhqd", p, vh[:, :, sl])
        m = m_new
    o = acc / torch.clamp_min(l[..., None], 1e-30)
    return o.transpose(1, 2).to(q.dtype)


def flash_attention(q, k, v, *, causal=True, window=0, q_offset=0, block=512):
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
    rather than averaged as the plain version would)."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset, block=block)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, got {q.device}")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q and k must be [B, T, H, Dh] and [B, S, Kv, Dh], got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    B, T, H, Dh = q.shape
    S, Kv = k.shape[1], k.shape[2]
    _check("q", q, q.device, _DTYPES)
    _check("k", k, q.device, (q.dtype,), (B, S, Kv, Dh))
    _check("v", v, q.device, (q.dtype,), (B, S, Kv, Dh))
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if Kv < 1 or H % Kv:
        raise ValueError(f"the kv heads ({Kv}) must divide the heads ({H})")
    if Dh not in HEAD_DIMS:
        raise ValueError(f"head dim {Dh} is not one the kernel is built for {HEAD_DIMS}")
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
    if out.numel() == 0:
        return out
    err = load("flash_attention").flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, T, S, H, Kv, Dh,
        q_offset, window, int(bool(causal)), Dh ** -0.5, int(q.dtype == torch.bfloat16),
        _stream(q.device))
    _raise_on(err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def reset_launch_counts() -> None:
    """Set the wrapper's ``launches`` counter to 0."""
    flash_attention.launches = 0
