"""The LM stack's decoder, for the six families of the reference.

Port of ``src/repro/models/transformer.py``:

  dense  -- pre-RMSNorm GQA attention + SwiGLU (qwen3: per-head qk-RMSNorm;
            qwen2.5: QKV bias; gemma3: 5 windowed layers to 1 global, tied
            embeddings)
  moe    -- attention + a top-k mixture-of-experts FFN (granite:
            ``models/moe.py``); serving routes dropless when the batch holds
            at most 4096 tokens, and ``loss`` adds 0.01 times the layers'
            summed load-balance loss to the cross-entropy
  ssm    -- RWKV6 time mix + RWKV channel mix (attention-free)
  hybrid -- windowed attention and selective-SSM heads in parallel on the
            same input, mean-fused (hymba; ``models/ssm.py``)
  audio  -- whisper enc-dec: a bidirectional encoder over (stub) frame
            embeddings, and a causal decoder that cross-attends to its
            output after each self-attention
  vlm    -- internvl2: a GELU projector over (stub) patch embeddings,
            prepended to the token stream of a dense decoder; the loss runs
            over the text positions only

All six train, serve and decode. The params tree is the reference's: the
layers' leaves are stacked on axis 0, so ``convert.params_from_numpy``
carries the JAX package's weights across unchanged. A Python loop over the
layer index takes the place of the reference's ``lax.scan``.

Every bundle provides:
  init(seed, device=None)          -> params (on the CUDA card by default)
  loss(params, batch)              -> scalar mean next-token cross-entropy
                                      (+ 0.01 * aux for moe)
  forward(params, batch)           -> logits [B, T, vocab_padded] ([B, P + T, ...]
                                      for vlm with P patches)
  init_cache(batch, seq, device=None) -> cache
  prefill(params, batch, cache)    -> (last-position logits [B, V], cache)
  decode_step(params, batch, cache) -> (logits [B, V], cache)
  memory(params, batch)            -> the audio decoder's memory [B, F, D]:
                                      batch["memory"], else batch["frames"]
                                      encoded; None for the other families
``prefill`` and ``decode_step`` update the cache IN PLACE and return it
(the reference returns a new one). A batch may carry the modality stubs:
``frames`` [B, F, d_model] (audio: encoded by :func:`_encode`), ``memory``
[B, F, d_model] (audio: the encoder's output, computed once at admission
by ``memory`` when serving) or ``patches`` [B, P, vision_dim] (vlm:
projected and prepended to the tokens in ``forward``, ``loss`` and
``prefill``).
``loss`` is the training path: with ``cfg.remat`` each layer runs under
``torch.utils.checkpoint`` (non-reentrant), as the reference wraps its
scanned layer in ``jax.checkpoint`` -- on the card the attention kernels,
the RWKV scan (forward and backward kernels) and the moe dispatch and
combine run again in the backward pass -- and the cross-entropy goes
through :func:`chunked_xent`.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core.device import resolve_device
from repro_torch.core.tree import tree_map
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import rwkv6 as RWKV
from repro_torch.models import ssm as SSM
from repro_torch.models.config import ArchConfig

FAMILIES = ("dense", "moe", "ssm", "hybrid", "audio", "vlm")


class ModelBundle(NamedTuple):
    cfg: ArchConfig
    init: Callable            # (seed, device=None) -> params
    loss: Callable            # (params, batch) -> scalar (train path)
    forward: Callable         # (params, batch) -> logits
    init_cache: Callable      # (batch, seq, device=None) -> cache
    prefill: Callable         # (params, batch, cache) -> (logits, cache)
    decode_step: Callable     # (params, batch, cache) -> (logits, cache)
    memory: Callable          # (params, batch) -> what audio cross-attends to, else None


def _dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


# ------------------------------------------------------------------ layers


def _layer_windows(cfg: ArchConfig) -> np.ndarray:
    """Per-layer sliding window sizes ([L] int32); 0 = global attention."""
    Lh = cfg.num_layers
    if cfg.local_global_ratio > 0:
        r = cfg.local_global_ratio
        w = np.full(Lh, cfg.sliding_window or 1024, np.int32)
        w[r::r + 1] = 0  # every (r+1)-th layer is global
        return w
    return np.full(Lh, cfg.sliding_window, np.int32)


def _init_decoder_layer(cfg: ArchConfig, gen, device) -> dict:
    dt = _dtype(cfg)
    d = cfg.d_model
    p = {"ln1": L.init_rms(d, dt, device), "ln2": L.init_rms(d, dt, device)}
    if cfg.arch_type == "ssm":
        p["rwkv"] = RWKV.init_rwkv6(gen, d, cfg.num_heads, dt, device)
        p["cmix"] = {
            "wr": L.init_linear(gen, d, d, dt, device),
            "wk": L.init_linear(gen, d, cfg.d_ff, dt, device),
            "wv": L.init_linear(gen, cfg.d_ff, d, dt, device),
            "mix": torch.full((2, d), 0.5, dtype=dt, device=device),
        }
        return p
    p["attn"] = L.init_attention(
        gen, d, cfg.num_heads, cfg.num_kv_heads, cfg.d_head, dt, device,
        qkv_bias=cfg.qkv_bias, qk_norm=cfg.qk_norm,
    )
    if cfg.arch_type == "hybrid":
        p["ssm"] = SSM.init_ssm(gen, d, cfg.ssm_d_inner or d, cfg.ssm_state, dt, device)
    if cfg.arch_type == "moe":
        p["moe"] = MOE.init_moe(gen, d, cfg.d_ff, cfg.num_experts, dt, device)
    else:
        p["mlp"] = L.init_swiglu(gen, d, cfg.d_ff, dt, device)
    if cfg.arch_type == "audio":
        p["ln_x"] = L.init_rms(d, dt, device)
        p["xattn"] = L.init_attention(gen, d, cfg.num_heads, cfg.num_kv_heads, cfg.d_head, dt,
                                      device)
    return p


def _rwkv_cmix(p, x, x_prev):
    """RWKV channel mixing with token shift. x: [B, T, D]."""
    xs = torch.cat([x_prev[:, None], x[:, :-1]], dim=1)
    mr, mk = p["mix"][0], p["mix"][1]
    xr = x * mr + xs * (1 - mr)
    xk = x * mk + xs * (1 - mk)
    r = torch.sigmoid(L.linear(p["wr"], xr))
    k = torch.square(torch.relu(L.linear(p["wk"], xk)))
    return r * L.linear(p["wv"], k)


def _apply_decoder_layer(cfg: ArchConfig, p: dict, x, *, window, memory=None, cache=None,
                         cache_index=None, mode: str = "train"):
    """One decoder layer. Returns (x, new_cache, aux): aux is the moe
    layer's load-balance loss (a float32 scalar), 0.0 for the others.
    ``memory`` [B, F, D]: what an audio layer cross-attends to (none: the
    layer skips its cross-attention, as the reference's does).

    cache (per-layer slice) keys by family:
      attention: k, v           [B, S, Kv, Dh]  (written in place)
      ssm:       state, x_prev, ffn_prev
      hybrid:    k, v, sstate    (sstate [B, Di, S] float32)
      audio:     k, v            (self-attention only; the memory's K/V are
                                  projected again each call)
    """
    B, T, D = x.shape
    new_cache = {}

    if cfg.arch_type == "ssm":
        h = L.rms_norm(x, p["ln1"])
        if mode == "decode":
            o, xp, st = RWKV.rwkv6_step(p["rwkv"], h[:, 0], cache["x_prev"], cache["state"],
                                        n_heads=cfg.num_heads)
            o = o[:, None]
        else:
            dh = D // cfg.num_heads
            st0 = (torch.zeros((B, cfg.num_heads, dh, dh), dtype=torch.float32,
                               device=x.device) if cache is None else cache["state"])
            xp0 = torch.zeros((B, D), dtype=x.dtype, device=x.device) if cache is None \
                else cache["x_prev"]
            o, xp, st = RWKV.rwkv6_chunked(p["rwkv"], h, xp0, st0, n_heads=cfg.num_heads,
                                           chunk=cfg.rwkv_chunk)
        new_cache.update(state=st, x_prev=xp)
        x = x + o
        h = L.rms_norm(x, p["ln2"])
        # As in the reference, the channel mix's token shift starts from
        # zeros outside decode, even when a prefill has a cache.
        fp = cache["ffn_prev"] if (cache is not None and mode == "decode") \
            else torch.zeros((B, D), dtype=x.dtype, device=x.device)
        x = x + _rwkv_cmix(p["cmix"], h, fp)
        new_cache["ffn_prev"] = h[:, -1]
        return x, new_cache, 0.0

    h = L.rms_norm(x, p["ln1"])
    kv_cache = None
    if cache is not None and "k" in cache:
        kv_cache = {"k": cache["k"], "v": cache["v"]}
    attn_out, kvc = L.attention_block(
        p["attn"], h,
        n_heads=cfg.num_heads, n_kv=cfg.num_kv_heads, d_head=cfg.d_head,
        rope_base=cfg.rope_base, window=window,
        qk_norm=cfg.qk_norm, kv_cache=kv_cache, cache_index=cache_index,
        attn_impl="blocked" if (T > 1024 or kv_cache is not None) else "naive",
        block=cfg.attn_block,
    )
    if kvc is not None:
        new_cache.update(kvc)

    if cfg.arch_type == "hybrid":
        if mode == "decode":
            sout, st = SSM.ssm_step(p["ssm"], h[:, 0], cache["sstate"])
            sout = sout[:, None]
        else:
            st0 = (torch.zeros((B, cfg.ssm_d_inner or D, cfg.ssm_state), dtype=torch.float32,
                               device=x.device) if cache is None else cache["sstate"])
            sout, st = SSM.ssm_parallel(p["ssm"], h, st0)
        new_cache["sstate"] = st
        # Hymba: parallel heads, mean-fused.
        attn_out = 0.5 * (attn_out + sout.to(attn_out.dtype))
    x = x + attn_out
    if cfg.arch_type == "audio" and memory is not None:
        # Cross-attention over the encoder's output: plain products, as the
        # reference computes them (attn_impl "naive").
        xo, _ = L.attention_block(
            p["xattn"], L.rms_norm(x, p["ln_x"]),
            n_heads=cfg.num_heads, n_kv=cfg.num_kv_heads, d_head=cfg.d_head,
            rope_base=cfg.rope_base, causal=False, kv_memory=memory, attn_impl="naive")
        x = x + xo
    h = L.rms_norm(x, p["ln2"])
    if cfg.arch_type == "moe":
        # Serving routes dropless while the [E, S, D] buffers stay modest;
        # training keeps the dispatch buffers small, serving prefers fewer,
        # larger chunks (the reference's settings).
        mo, aux = MOE.moe_block(
            p["moe"], h, num_experts=cfg.num_experts, top_k=cfg.top_k,
            dropless=(mode != "train" and B * T <= 4096),
            chunk_tokens=4096 if mode == "train" else 16384,
            sequential=(mode == "train"))
        return x + mo, new_cache, aux
    x = x + L.swiglu(p["mlp"], h)
    return x, new_cache, 0.0


# ------------------------------------------------------------------ encoder
# (whisper: bidirectional attention over the stub frontend's frames)


def _init_encoder_layer(cfg: ArchConfig, gen, device) -> dict:
    dt = _dtype(cfg)
    d = cfg.d_model
    return {
        "ln1": L.init_rms(d, dt, device),
        "ln2": L.init_rms(d, dt, device),
        "attn": L.init_attention(gen, d, cfg.num_heads, cfg.num_kv_heads, cfg.d_head, dt,
                                 device),
        "mlp": L.init_swiglu(gen, d, cfg.d_ff, dt, device),
    }


def _encode(cfg: ArchConfig, enc_params: dict, pos_emb, frames):
    """Whisper's encoder: ``frames`` [B, F, D] cast to the param dtype plus
    the learned positions ``pos_emb[:F]``, then ``cfg.encoder_layers``
    pre-RMSNorm layers of bidirectional self-attention (RoPE over
    ``arange(F)``, plain products, as the reference's ``attn_impl="naive"``)
    and SwiGLU. No remat: the reference's encoder scan has none."""
    x = frames.to(_dtype(cfg)) + pos_emb[None, :frames.shape[1]]
    per_layer = tree_map(lambda t: t.unbind(0), enc_params)
    for i in range(cfg.encoder_layers):
        lp = tree_map(lambda t: t[i], per_layer)
        o, _ = L.attention_block(
            lp["attn"], L.rms_norm(x, lp["ln1"]),
            n_heads=cfg.num_heads, n_kv=cfg.num_kv_heads, d_head=cfg.d_head,
            rope_base=cfg.rope_base, causal=False, attn_impl="naive")
        x = x + o
        x = x + L.swiglu(lp["mlp"], L.rms_norm(x, lp["ln2"]))
    return x


# ------------------------------------------------------------------ model


def _stack_init(fn, n: int) -> dict:
    """``n`` layers from ``fn()``, stacked on axis 0 one layer at a time
    (the stacked leaves are filled in place; only one layer's fresh params
    and one leaf's float32 draw are alive besides them)."""
    first = fn()
    out = tree_map(lambda t: torch.empty((n,) + tuple(t.shape), dtype=t.dtype,
                                         device=t.device), first)
    for i in range(n):
        tree_map(lambda s, t: s[i].copy_(t), out, first if i == 0 else fn())
    return out


def chunked_xent(logits_fn, hidden, targets, chunk=512):
    """Mean cross-entropy over the sequence in chunks of positions, so the
    float32 logits of only one chunk are formed at a time (the reference's
    rule: chunks of gcd(T, chunk) positions, or all T when that is under
    64). hidden: [B, T, D]; targets: [B, T] int. Returns a float32 scalar."""
    B, T, D = hidden.shape
    c = math.gcd(T, chunk)
    if c < 64:
        c = T
    nc = T // c
    h = hidden.reshape(B, nc, c, D).transpose(0, 1)
    t = targets.reshape(B, nc, c).transpose(0, 1).long()
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(nc):
        lp = torch.log_softmax(logits_fn(h[i]).to(torch.float32), dim=-1)
        tot = tot - torch.gather(lp, -1, t[i][..., None]).sum()
    return tot / (B * T)


def build_model(cfg: ArchConfig) -> ModelBundle:
    if cfg.arch_type not in FAMILIES:
        raise ValueError(f"unknown arch_type {cfg.arch_type!r}; choose from {FAMILIES}")
    dt = _dtype(cfg)
    windows = [int(w) for w in _layer_windows(cfg)]

    def init(seed: int = 0, device=None) -> dict:
        """Random params from ``seed``, drawn on ``device`` (the CUDA card
        unless ``device="cpu"``) by a generator there, leaf by leaf in
        float32 and cast to the param dtype; the layers are drawn one at a
        time into their stacked leaves."""
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        p = {
            "embed": L.init_embedding(gen, cfg.vocab_padded, cfg.d_model, dt, dev),
            "ln_f": L.init_rms(cfg.d_model, dt, dev),
            "layers": _stack_init(lambda: _init_decoder_layer(cfg, gen, dev),
                                  cfg.num_layers),
        }
        if not cfg.tie_embeddings:
            p["unembed"] = L.init_linear(gen, cfg.d_model, cfg.vocab_padded, dt, dev)
        if cfg.arch_type == "audio":
            p["encoder"] = _stack_init(lambda: _init_encoder_layer(cfg, gen, dev),
                                       cfg.encoder_layers)
            w = torch.randn((cfg.encoder_frames, cfg.d_model), generator=gen,
                            dtype=torch.float32, device=dev)
            p["enc_pos"] = (0.02 * w).to(dt)
        if cfg.arch_type == "vlm":
            p["projector"] = {
                "w1": L.init_linear(gen, cfg.vision_dim, cfg.d_model, dt, dev),
                "w2": L.init_linear(gen, cfg.d_model, cfg.d_model, dt, dev),
            }
        return p

    def _logits(p, hidden):
        if cfg.tie_embeddings:
            return L.unembed(p["embed"], hidden)
        return L.linear(p["unembed"], hidden)

    def _embed_inputs(p, batch):
        """Token embeddings [B, T, D], after the projected patches for vlm
        ([B, P + T, D]): w1, GELU (tanh form, ``jax.nn.gelu``'s default),
        w2."""
        x = L.embed(p["embed"], batch["tokens"])
        if cfg.arch_type == "vlm" and "patches" in batch:
            pr = p["projector"]
            v = F.gelu(L.linear(pr["w1"], batch["patches"].to(dt)), approximate="tanh")
            x = torch.cat([L.linear(pr["w2"], v), x], dim=1)
        return x.to(dt)

    def memory(p, batch):
        """What an audio decoder cross-attends to: the batch's ``memory``
        (serving: the encoder ran once at admission), else its ``frames``
        encoded, else None."""
        if cfg.arch_type != "audio":
            return None
        if "memory" in batch:
            return batch["memory"].to(dt)
        if "frames" in batch:
            return _encode(cfg, p["encoder"], p["enc_pos"], batch["frames"])
        return None

    def _run_layers(p, x, memory=None, cache=None, cache_index=None, mode="train"):
        """(x after the layers, the moe layers' summed aux loss: a float32
        scalar, 0.0 for the other families)."""
        remat = cfg.remat and mode == "train"
        # One unbind of the stacked leaves: its backward stacks the layers'
        # gradients once (indexing layer by layer would build a zero-filled
        # stacked gradient per layer and sum them).
        per_layer = tree_map(lambda t: t.unbind(0), p["layers"])
        aux = 0.0
        for i in range(cfg.num_layers):
            cl = None if cache is None else {k: v[i] for k, v in cache.items()}
            lp = tree_map(lambda t: t[i], per_layer)
            if remat:
                # Only the layer's inputs are kept; its activations are
                # recomputed in the backward pass (jax.checkpoint's role).
                # The memory is an input of its own, so that its gradient
                # reaches the encoder from every layer's cross-attention.
                # The checkpointed function returns (x, aux).
                x, a = checkpoint(lambda h, m, lp=lp, w=windows[i]: _apply_decoder_layer(
                    cfg, lp, h, window=w, memory=m, mode=mode)[::2], x, memory,
                    use_reentrant=False)
                aux = aux + a
                continue
            x, nc, a = _apply_decoder_layer(cfg, lp, x, window=windows[i], memory=memory,
                                            cache=cl, cache_index=cache_index, mode=mode)
            aux = aux + a
            if cache is not None:
                for k, v in nc.items():
                    if v is not cl[k]:  # k/v were written in place already
                        cache[k][i].copy_(v)
        return x, aux

    def forward(p, batch):
        x, _ = _run_layers(p, _embed_inputs(p, batch), memory(p, batch), mode="eval")
        return _logits(p, L.rms_norm(x, p["ln_f"]))

    def loss(p, batch):
        """Mean next-token cross-entropy of ``batch["tokens"]`` against
        ``batch["targets"]`` ([B, T] each), float32, over the text positions
        only (vlm: the patches' positions are sliced off); the moe family
        adds 0.01 times its layers' summed load-balance loss."""
        x, aux = _run_layers(p, _embed_inputs(p, batch), memory(p, batch), mode="train")
        x = L.rms_norm(x, p["ln_f"])
        if cfg.arch_type == "vlm" and "patches" in batch:
            x = x[:, batch["patches"].shape[1]:]
        ce = chunked_xent(lambda h: _logits(p, h), x, batch["targets"])
        return ce + 0.01 * aux if cfg.arch_type == "moe" else ce

    def init_cache(batch_size: int, seq: int, device=None) -> dict:
        dev = resolve_device(device)
        B, S, Lh = batch_size, seq, cfg.num_layers
        if cfg.arch_type == "ssm":
            dh = cfg.d_model // cfg.num_heads
            return {
                "state": torch.zeros((Lh, B, cfg.num_heads, dh, dh), dtype=torch.float32,
                                     device=dev),
                "x_prev": torch.zeros((Lh, B, cfg.d_model), dtype=dt, device=dev),
                "ffn_prev": torch.zeros((Lh, B, cfg.d_model), dtype=dt, device=dev),
            }
        shape = (Lh, B, S, cfg.num_kv_heads, cfg.d_head)
        c = {"k": torch.zeros(shape, dtype=dt, device=dev),
             "v": torch.zeros(shape, dtype=dt, device=dev)}
        if cfg.arch_type == "hybrid":
            c["sstate"] = torch.zeros((Lh, B, cfg.ssm_d_inner or cfg.d_model, cfg.ssm_state),
                                      dtype=torch.float32, device=dev)
        return c

    def prefill(p, batch, cache):
        """Forward the prompt ``batch["tokens"]`` [B, T] (after its patches
        for vlm), writing the cache from position 0; returns the last
        position's logits."""
        x, _ = _run_layers(p, _embed_inputs(p, batch), memory(p, batch), cache=cache,
                           cache_index=0, mode="prefill")
        x = L.rms_norm(x[:, -1:], p["ln_f"])
        return _logits(p, x)[:, 0], cache

    def decode_step(p, batch, cache):
        """One-token decode. batch: {'token': [B, 1], 'index': position},
        and for audio ``memory`` or ``frames``."""
        x = L.embed(p["embed"], batch["token"]).to(dt)
        x, _ = _run_layers(p, x, memory(p, batch), cache=cache,
                           cache_index=int(batch["index"]), mode="decode")
        x = L.rms_norm(x, p["ln_f"])
        return _logits(p, x)[:, 0], cache

    return ModelBundle(cfg=cfg, init=init, loss=loss, forward=forward, init_cache=init_cache,
                       prefill=prefill, decode_step=decode_step, memory=memory)
