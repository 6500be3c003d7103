"""Transformer building blocks of the LM stack as functional PyTorch.

Port of ``src/repro/models/layers.py``. ``init_*`` builds a params dict
with the reference's leaf names and shapes (drawn from a ``torch.Generator``
on the params' device, in float32 and then cast, as the reference draws);
the apply functions are plain tensor code. Conventions:

* params are stored in the param dtype (bfloat16 for the full-width
  archs); norms, RoPE and softmax compute in float32 and cast back;
* attention supports GQA, RoPE (split-half), optional QKV bias, per-head
  qk-RMSNorm (qwen3), sliding windows (``window <= 0`` means global),
  bidirectional attention (``causal=False``: whisper's encoder) and
  cross-attention over a memory (``kv_memory``: whisper's decoder);
* ``attention_block`` routes one-token decode to
  :func:`gqa_decode_attention`, and everything else to the flash kernel
  (``attn_impl="blocked"``, ``kernels/flash_attention.py``; the model's
  jnp twin ``flash_jnp`` on the reference's side) or to
  :func:`naive_attention`, as the reference routes it. With grad enabled
  the blocked path is the differentiable ``FlashAttention`` (forward and
  backward kernels, the counterpart of ``flash_jnp``'s custom VJP).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import (
    NEG_INF,
    FlashAttention,
    _expand_kv,
    flash_attention,
)

# ---------------------------------------------------------------- basics


def rms_norm(x, scale, eps=1e-6):
    """RMSNorm in float32; ``scale`` is stored as (scale - 1), gemma-style.
    Returns x's dtype."""
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.to(torch.float32))).to(x.dtype)


def init_rms(d, dtype, device):
    return torch.zeros((d,), dtype=dtype, device=device)


def _norm_init(gen, shape, dtype, device, fan_in=None):
    fan_in = fan_in if fan_in is not None else shape[0]
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return ((1.0 / fan_in) ** 0.5 * w).to(dtype)


def init_linear(gen, n_in, n_out, dtype, device, bias=False):
    p = {"w": _norm_init(gen, (n_in, n_out), dtype, device)}
    if bias:
        p["b"] = torch.zeros((n_out,), dtype=dtype, device=device)
    return p


def linear(p, x):
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


# ---------------------------------------------------------------- RoPE


def rope_freqs(d_head: int, base: float, device=None):
    return 1.0 / (base ** (torch.arange(0, d_head, 2, dtype=torch.float32, device=device)
                           / d_head))


def apply_rope(x, positions, base: float):
    """x: [..., T, H, Dh]; positions: [..., T]. Split-half rotation (the
    two halves of Dh, not interleaved pairs), angles in float32."""
    d_head = x.shape[-1]
    freqs = rope_freqs(d_head, base, x.device)                          # [Dh/2]
    ang = positions[..., None].to(torch.float32) * freqs                # [..., T, Dh/2]
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------- attention


def init_attention(gen, d_model, n_heads, n_kv, d_head, dtype, device, qkv_bias=False,
                   qk_norm=False):
    p = {
        "wq": init_linear(gen, d_model, n_heads * d_head, dtype, device, qkv_bias),
        "wk": init_linear(gen, d_model, n_kv * d_head, dtype, device, qkv_bias),
        "wv": init_linear(gen, d_model, n_kv * d_head, dtype, device, qkv_bias),
        "wo": init_linear(gen, n_heads * d_head, d_model, dtype, device),
    }
    if qk_norm:
        p["q_norm"] = init_rms(d_head, dtype, device)
        p["k_norm"] = init_rms(d_head, dtype, device)
    return p


def naive_attention(q, k, v, *, causal=True, window=0, q_offset=0):
    """Reference attention. q: [B, Tq, H, Dh], k/v: [B, Tk, H, Dh].

    ``q_offset``: absolute position of q[0]. ``window > 0`` masks keys older
    than ``window`` positions. The logits are taken in q's dtype and then
    widened to float32, as the reference does.
    """
    B, Tq, H, Dh = q.shape
    Tk = k.shape[1]
    scale = Dh ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32) * scale
    qpos = torch.arange(Tq, device=q.device) + q_offset
    kpos = torch.arange(Tk, device=q.device)
    mask = torch.ones((Tq, Tk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    lo = qpos[:, None] - (window if window > 0 else Tk + Tq)
    mask &= kpos[None, :] > lo
    logits = torch.where(mask[None, None], logits, torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def gqa_decode_attention(q, k, v, *, window=0, q_offset=0):
    """One-token decode attention without expanding the GQA kv heads.

    q: [B, 1, H, Dh]; k/v: [B, S, Kv, Dh]. The logits and the weighted sum
    accumulate in float32, as the reference's ``preferred_element_type``
    does: the cache is widened to float32 for the two products (a
    float32 copy of one layer's cache per step; a decode kernel that reads
    bfloat16 and accumulates in float32 would avoid it). The softmax
    weights are rounded to v's dtype before the second product, as in the
    reference.
    """
    B, Tq, H, Dh = q.shape
    S, Kv = k.shape[1], k.shape[2]
    grp = H // Kv
    qg = q.reshape(B, Tq, Kv, grp, Dh).to(torch.float32)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg, k.to(torch.float32)) * (Dh ** -0.5)
    kpos = torch.arange(S, device=q.device)
    mask = kpos <= q_offset
    mask &= kpos > (q_offset - window if window > 0 else -1)
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    p = torch.softmax(logits, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p.to(v.dtype).to(torch.float32), v.to(torch.float32))
    return o.reshape(B, Tq, H, Dh).to(q.dtype)


def attention_block(
    p, x, *, n_heads, n_kv, d_head, rope_base, causal=True, window=0, qk_norm=False,
    kv_cache=None, cache_index=None, attn_impl="blocked", block=512, kv_memory=None,
):
    """Attention sub-block: proj -> qk-norm -> RoPE -> (cache) -> attn -> out
    proj.

    kv_cache: optional dict(k=[B, S, Kv, Dh], v=...). The new K/V are written
    into it IN PLACE at ``cache_index`` (the reference returns an updated
    copy), and attention runs over the whole cache. ``cache_index`` is a
    Python int; q and k are rotated at positions ``cache_index + arange(T)``.
    kv_memory: optional [B, S_mem, d_model] for cross-attention (whisper's
    decoder): K and V are projected from the memory, neither q nor k is
    rotated, and attention is bidirectional, as it is with ``causal=False``. Returns (out, cache) -- the same cache
    tensors, or None without a cache.
    """
    B, T, _ = x.shape
    q = linear(p["wq"], x).reshape(B, T, n_heads, d_head)
    src = x if kv_memory is None else kv_memory
    k = linear(p["wk"], src).reshape(B, src.shape[1], n_kv, d_head)
    v = linear(p["wv"], src).reshape(B, src.shape[1], n_kv, d_head)

    if qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])

    if kv_memory is None:
        base = 0 if cache_index is None else cache_index
        positions = (torch.arange(T, device=x.device)[None, :] + base).expand(B, T)
        q = apply_rope(q, positions, rope_base)
        k = apply_rope(k, positions, rope_base)
    causal = causal and kv_memory is None

    new_cache = None
    q_offset = 0
    if kv_cache is not None:
        idx = int(cache_index)
        ck, cv = kv_cache["k"], kv_cache["v"]
        if not 0 <= idx <= ck.shape[1] - T:
            raise ValueError(f"cache_index {idx} + {T} tokens overflows a cache of "
                             f"{ck.shape[1]} positions")
        ck[:, idx:idx + T] = k
        cv[:, idx:idx + T] = v
        new_cache = {"k": ck, "v": cv}
        k, v = ck, cv
        q_offset = idx

    if T == 1 and kv_cache is not None:
        o = gqa_decode_attention(q, k, v, window=window, q_offset=q_offset)
    elif attn_impl == "blocked" and torch.is_grad_enabled():
        # Training: the backward kernel reads the forward's row statistics.
        o = FlashAttention.apply(q, k, v, causal, window, q_offset, block)
    elif attn_impl == "blocked":
        # GQA kv heads stay unexpanded: the kernel reads kv head h // (H/Kv).
        o = flash_attention(q.contiguous(), k, v, causal=causal, window=window,
                            q_offset=q_offset, block=block)
    else:
        o = naive_attention(q, _expand_kv(k, n_heads), _expand_kv(v, n_heads),
                            causal=causal, window=window, q_offset=q_offset)
    out = linear(p["wo"], o.reshape(B, T, n_heads * d_head))
    return out, new_cache


# ---------------------------------------------------------------- MLP


def init_swiglu(gen, d_model, d_ff, dtype, device):
    return {
        "wi": init_linear(gen, d_model, d_ff, dtype, device),
        "wg": init_linear(gen, d_model, d_ff, dtype, device),
        "wo": init_linear(gen, d_ff, d_model, dtype, device),
    }


def swiglu(p, x):
    return linear(p["wo"], F.silu(linear(p["wg"], x)) * linear(p["wi"], x))


def init_embedding(gen, vocab, d_model, dtype, device):
    w = torch.randn((vocab, d_model), generator=gen, dtype=torch.float32, device=device)
    return {"table": (0.02 * w).to(dtype)}


def embed(p, tokens):
    return p["table"][tokens.long()]


def unembed(p, x):
    return x @ p["table"].T
