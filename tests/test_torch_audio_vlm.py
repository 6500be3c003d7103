"""The audio family (whisper-medium: a bidirectional encoder over stub frame
embeddings, a decoder that cross-attends to it) and the vlm family
(internvl2-26b: a GELU projector over stub patch embeddings prepended to
the prompt, the loss over the text positions) on the port against the JAX
package, on the CPU.

* ``attention_block`` with ``kv_memory`` (K/V projected from the memory,
  no RoPE, bidirectional) and with ``causal=False`` (plain and blocked);
* ``_encode`` and the bundle's ``memory``; ``forward``, ``loss`` and every gradient leaf, with and
  without the modality stub (the unused leaves' gradients exactly zero),
  under remat (the memory an input of each checkpointed layer: the
  encoder's gradient crosses every layer's cross-attention) and without;
* prefill and decode against the reference, audio once with ``memory``
  and once with ``frames``; decode against forward; ``generate`` against
  the reference's greedy loop token for token; bf16;
* one sharded round of each family with the modality leaf in the batch
  (tree + fused) against the reference's, ``pack_arrays`` -> ``fit``
  carrying the leaf into ``loss``, the unused leaves bit for bit unchanged
  under plain MTGC (tree and flat), and both CLIs.

Params come from the reference's ``init`` and cross through
``repro_torch.convert``; inputs come from numpy seeds. Tolerances are the
LM tests' (``test_torch_lm_models.py``, ``test_torch_lm_train.py``):
float32 rtol 1e-4 / atol 1e-5, cache leaves atol 1e-4, z and y at atol
1e-5 / (H lr) and 1e-5 / (H E lr) (ROADMAP queue 3 item 2); bf16 logits
within four bf16 ulps of the largest logit and 2% of their rms (queue 3
item 5).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import api as japi  # noqa: E402
from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import api as tapi  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core.packer import is_flat  # noqa: E402
from repro_torch.core.tree import tree_map  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from test_torch_lm_models import _close_bf16  # noqa: E402

ARCHS = ("whisper-medium", "internvl2-26b")
RTOL, ATOL = 1e-4, 1e-5
# The leaves only the modality stub reaches.
STUB_LEAVES = {"whisper-medium": ("encoder", "enc_pos"), "internvl2-26b": ("projector",)}


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """One intra-op thread: the suite runs files in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, rtol=RTOL, atol=ATOL, tag=""):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), tag
        for k in want:
            _close(got[k], want[k], rtol, atol, f"{tag}/{k}")
        return
    np.testing.assert_allclose(convert.to_numpy(got), np.asarray(want, np.float32),
                               rtol=rtol, atol=atol, err_msg=tag)


def _pair(arch, seed=0, **over):
    """(jax bundle, jax params, port bundle, port params) of the reduced arch."""
    jb = JT.build_model(jget_arch(arch).reduced(**over))
    jp = jb.init(jax.random.PRNGKey(seed))
    return jb, jp, TT.build_model(tconfigs.get_arch(arch).reduced(**over)), \
        convert.params_from_numpy(_np(jp), "cpu")


def _stub(cfg, B, seed):
    """The modality stub of ``cfg``'s family: {"frames": [B, F, D]} or
    {"patches": [B, P, vision_dim]}, float32 from a numpy seed."""
    rng = np.random.default_rng(seed)
    if cfg.arch_type == "audio":
        return {"frames": rng.normal(size=(B, cfg.encoder_frames, cfg.d_model)).astype(np.float32)}
    return {"patches": rng.normal(size=(B, cfg.vision_tokens, cfg.vision_dim)).astype(np.float32)}


def _batch(cfg, B, T, seed, stub=True, targets=True):
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)}
    if targets:
        b["targets"] = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    if stub:
        b.update(_stub(cfg, B, seed + 100))
    return b


def _jx(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _th(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


# ------------------------------------------------------------------ attention


def _attn_params(seed, qk_norm=False, n_heads=4, n_kv=2, d_head=32, d_model=64):
    jp = JL.init_attention(jax.random.PRNGKey(seed), d_model, n_heads, n_kv, d_head,
                           jnp.float32, qk_norm=qk_norm)
    jp = jax.tree.map(lambda a: a + 0.1 if a.ndim == 1 else a, jp)  # nonzero qk-norm scales
    return jp, convert.params_from_numpy(_np(jp), "cpu")


@pytest.mark.parametrize("qk_norm", [False, True])
@pytest.mark.parametrize("S_mem", [7, 23])
def test_attention_block_with_memory(qk_norm, S_mem):
    """Cross-attention: K/V from the memory, neither q nor k rotated, every
    query sees every memory position (the reference's ``causal`` flag is
    overruled)."""
    jp, tp = _attn_params(3, qk_norm)
    rng = np.random.default_rng(S_mem)
    x = rng.normal(size=(2, 11, 64)).astype(np.float32)
    mem = rng.normal(size=(2, S_mem, 64)).astype(np.float32)
    kw = dict(n_heads=4, n_kv=2, d_head=32, rope_base=1e4, qk_norm=qk_norm, causal=True,
              attn_impl="naive")
    jo, _ = JL.attention_block(jp, jnp.asarray(x), kv_memory=jnp.asarray(mem), **kw)
    to, tc = TL.attention_block(tp, _t(x), kv_memory=_t(mem), **kw)
    assert tc is None
    _close(to, jo)
    # One query token (a decode step's cross-attention) takes the same path.
    jo, _ = JL.attention_block(jp, jnp.asarray(x[:, :1]), kv_memory=jnp.asarray(mem), **kw)
    to, _ = TL.attention_block(tp, _t(x[:, :1]), kv_memory=_t(mem), **kw)
    _close(to, jo)


@pytest.mark.parametrize("impl,window", [("naive", 0), ("blocked", 0), ("naive", 5),
                                         ("blocked", 5)])
def test_attention_block_bidirectional(impl, window):
    jp, tp = _attn_params(4, True)
    x = np.random.default_rng(4).normal(size=(2, 19, 64)).astype(np.float32)
    kw = dict(n_heads=4, n_kv=2, d_head=32, rope_base=1e4, window=window, qk_norm=True,
              causal=False, attn_impl=impl, block=8)
    jo, _ = JL.attention_block(jp, jnp.asarray(x), **kw)
    to, _ = TL.attention_block(tp, _t(x), **kw)
    _close(to, jo)
    causal, _ = TL.attention_block(tp, _t(x), **dict(kw, causal=True))
    assert (causal - to).abs().max().item() > 1e-3


@pytest.mark.parametrize("arch", ["whisper-medium", "internvl2-26b"])
def test_bundle_memory(arch):
    """``memory`` is what an audio decoder cross-attends to: the batch's
    ``memory`` as given, else its ``frames`` through the reference's
    encoder; None without either, and None for the vlm family."""
    jb, jp, tb, tp = _pair(arch, seed=5)
    frames = np.random.default_rng(5).normal(size=(2, 16, 128)).astype(np.float32)
    if arch == "internvl2-26b":
        assert tb.memory(tp, {"frames": _t(frames)}) is None
        return
    want = JT._encode(jb.cfg, jp["encoder"], jp["enc_pos"], jnp.asarray(frames))
    _close(tb.memory(tp, {"frames": _t(frames)}), want)
    assert torch.equal(tb.memory(tp, {"memory": _t(frames), "frames": _t(frames[:, :3])}),
                       _t(frames))
    assert tb.memory(tp, {"tokens": torch.zeros((2, 3), dtype=torch.int32)}) is None


# ------------------------------------------------------------------ encoder


def test_encode_matches_reference():
    jb, jp, tb, tp = _pair("whisper-medium", seed=6)
    frames = _stub(jb.cfg, 2, 6)["frames"]
    want = JT._encode(jb.cfg, jp["encoder"], jp["enc_pos"], jnp.asarray(frames))
    got = TT._encode(tb.cfg, tp["encoder"], tp["enc_pos"], _t(frames))
    assert tuple(got.shape) == (2, 16, 128)
    _close(got, want)
    # Fewer frames than encoder_frames take the first positions.
    want = JT._encode(jb.cfg, jp["encoder"], jp["enc_pos"], jnp.asarray(frames[:, :11]))
    _close(TT._encode(tb.cfg, tp["encoder"], tp["enc_pos"], _t(frames[:, :11])), want)


# ------------------------------------------------------------------ models


@pytest.mark.parametrize("stub", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch, stub):
    jb, jp, tb, tp = _pair(arch, seed=1)
    batch = _batch(jb.cfg, 2, 21, 1, stub=stub, targets=False)
    want = jb.forward(jp, _jx(batch))
    got = tb.forward(tp, _th(batch))
    P = jb.cfg.vision_tokens if (stub and arch == "internvl2-26b") else 0
    assert tuple(got.shape) == (2, P + 21, 512)
    _close(got, want)


def _grads(tb, tp, batch):
    """(loss, {path: grad}) of the port, unused leaves' None as zeros."""
    leaves = tree_map(lambda t: t.detach().clone().requires_grad_(), tp)
    flat = jax.tree_util.tree_flatten_with_path(leaves, is_leaf=torch.is_tensor)[0]
    loss = tb.loss(leaves, _th(batch))
    gs = torch.autograd.grad(loss, [t for _, t in flat], allow_unused=True)
    return loss.detach(), {jax.tree_util.keystr(p): (torch.zeros_like(t) if g is None else g)
                           for (p, t), g in zip(flat, gs)}


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("stub", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch, stub, remat):
    """The loss and every gradient leaf against ``jax.value_and_grad``;
    without the stub the leaves only it reaches get exactly zero, with it
    they get nonzero gradients (the encoder's through every decoder
    layer's cross-attention)."""
    jb, jp, tb, tp = _pair(arch, seed=2, remat=remat)
    batch = _batch(jb.cfg, 2, 24, 2, stub=stub)
    jl, jg = jax.value_and_grad(jb.loss)(jp, _jx(batch))
    tl, tg = _grads(tb, tp, batch)
    _close(tl, jl, tag="loss")
    want = {jax.tree_util.keystr(p): g
            for p, g in jax.tree_util.tree_flatten_with_path(_np(jg))[0]}
    assert sorted(tg) == sorted(want)
    for path, g in want.items():
        _close(tg[path], g, tag=path)
        if any(path.startswith(f"['{k}']") for k in STUB_LEAVES[arch]):
            if stub:
                assert tg[path].abs().max().item() > 0, path
            else:
                assert not tg[path].any() and not np.any(g), path


def test_encoder_gradient_crosses_remat():
    """The whisper loss under remat equals it without, gradient for
    gradient, bit for bit: the memory enters each checkpointed layer as an
    input, so its gradient from every layer's cross-attention reaches the
    encoder."""
    _, _, tb, tp = _pair("whisper-medium", seed=3, remat=True)
    tb_off = TT.build_model(dataclasses.replace(tb.cfg, remat=False))
    batch = _batch(tb.cfg, 2, 24, 3)
    l_on, g_on = _grads(tb, tp, batch)
    l_off, g_off = _grads(tb_off, tp, batch)
    assert torch.equal(l_on, l_off)
    for path in g_off:
        assert torch.equal(g_on[path], g_off[path]), path
    assert g_on["['enc_pos']"].abs().max().item() > 0


def test_vlm_loss_is_over_text_positions():
    """The loss is the mean cross-entropy of the text positions' logits
    alone: ``forward``'s last T of its P + T positions against the T
    targets."""
    _, _, tb, tp = _pair("internvl2-26b", seed=4)
    batch = _th(_batch(tb.cfg, 2, 24, 4))
    P = tb.cfg.vision_tokens
    logits = tb.forward(tp, batch)
    lp = torch.log_softmax(logits[:, P:].float(), dim=-1)
    want = -torch.gather(lp, -1, batch["targets"].long()[..., None]).mean()
    assert tuple(logits.shape[:2]) == (2, P + 24)
    torch.testing.assert_close(tb.loss(tp, batch), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("how", ["memory", "frames", "patches"])
def test_prefill_and_decode_match_reference(how):
    """Prefill 13 prompt tokens (after the patches for vlm) into a cache of
    4 more positions, then 4 decode steps: logits and the cache after each
    call. Audio passes the encoder's output as ``memory`` (serving's
    contract) or its ``frames`` (encoded in every call)."""
    arch = "internvl2-26b" if how == "patches" else "whisper-medium"
    jb, jp, tb, tp = _pair(arch, seed=5)
    cfg, T = jb.cfg, 13
    batch = _batch(cfg, 2, T, 5, targets=False)
    P = cfg.vision_tokens if how == "patches" else 0
    extra_j, extra_t = {}, {}
    if how == "memory":
        mem = JT._encode(cfg, jp["encoder"], jp["enc_pos"], jnp.asarray(batch.pop("frames")))
        extra_j, extra_t = {"memory": mem}, {"memory": _t(mem)}
    elif how == "frames":
        f = batch.pop("frames")
        extra_j, extra_t = {"frames": jnp.asarray(f)}, {"frames": _t(f)}
    jc, tc = jb.init_cache(2, P + T + 4), tb.init_cache(2, P + T + 4, device="cpu")
    jl, jc = jb.prefill(jp, {**_jx(batch), **extra_j}, jc)
    tl, tc = tb.prefill(tp, {**_th(batch), **extra_t}, tc)
    _close(tl, jl, tag="prefill logits")
    _close(tc, _np(jc), atol=1e-4, tag="prefill cache")
    nxt = np.random.default_rng(6).integers(0, 256, (2, 4)).astype(np.int32)
    for i in range(4):
        tok = nxt[:, i:i + 1]
        jl, jc = jb.decode_step(jp, {"token": jnp.asarray(tok),
                                     "index": jnp.asarray(P + T + i, jnp.int32), **extra_j}, jc)
        tl, tc = tb.decode_step(tp, {"token": torch.from_numpy(tok), "index": P + T + i,
                                     **extra_t}, tc)
        _close(tl, jl, tag=f"decode {i} logits")
        _close(tc, _np(jc), atol=1e-4, tag=f"decode {i} cache")


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """The port alone (as tests/test_models.py:56): prefill T - 1 tokens and
    decode the last one; its logits equal the full forward's last row."""
    tb = TT.build_model(tconfigs.get_arch(arch).reduced())
    tp = tb.init(1, device="cpu")
    batch = _th(_batch(tb.cfg, 2, 16, 7, targets=False))
    P = tb.cfg.vision_tokens if arch == "internvl2-26b" else 0
    full = tb.forward(tp, batch)[:, -1]
    extra = {"frames": batch["frames"]} if "frames" in batch else {}
    cache = tb.init_cache(2, P + 16, device="cpu")
    _, cache = tb.prefill(tp, dict(batch, tokens=batch["tokens"][:, :-1]), cache)
    lg, _ = tb.decode_step(tp, {"token": batch["tokens"][:, -1:], "index": P + 15, **extra},
                           cache)
    assert (full - lg).abs().max().item() < 5e-4


def _jax_greedy(bundle, params, batch, gen):
    """The reference's greedy loop (``src/repro/launch/serve.py:66-81``):
    audio's decode steps take the frames again; vlm's cache holds the
    patches' positions too, and decoding starts after them."""
    B, T = batch["tokens"].shape
    P = batch["patches"].shape[1] if "patches" in batch else 0
    cache = bundle.init_cache(B, P + T + gen)
    logits, cache = jax.jit(bundle.prefill)(params, batch, cache)
    decode = jax.jit(bundle.decode_step)
    extra = {k: batch[k] for k in ("frames",) if k in batch}
    tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    out = [tok]
    for i in range(gen - 1):
        logits, cache = decode(params, {"token": tok, "index": jnp.asarray(P + T + i, jnp.int32),
                                        **extra}, cache)
        tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
        out.append(tok)
    return np.asarray(jnp.concatenate(out, 1)), np.asarray(logits)


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_matches_reference_loop(arch):
    """``generate`` (the encoder once at admission) against the reference's
    loop token for token, and its last logits."""
    jb, jp, tb, tp = _pair(arch, seed=8)
    batch = _batch(jb.cfg, 3, 19, 8, targets=False)
    want, want_last = _jax_greedy(jb, jp, _jx(batch), 10)
    stub = {k: _t(v) for k, v in batch.items() if k != "tokens"}
    got = serve.generate(tb, tp, torch.from_numpy(batch["tokens"]), 10, **stub)
    assert got.tokens.dtype == torch.int32 and tuple(got.tokens.shape) == (3, 10)
    np.testing.assert_array_equal(got.tokens.numpy(), want)
    _close(got.last_logits, want_last)
    assert (got.encode_ms > 0) == (arch == "whisper-medium")


def test_generate_rejects_a_foreign_stub():
    tb = TT.build_model(tconfigs.get_arch("internvl2-26b").reduced())
    tp = tb.init(0, device="cpu")
    toks = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="frames go with the audio family"):
        serve.generate(tb, tp, toks, 2, frames=torch.zeros(1, 16, 128))


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_prefill_and_decode_match_reference(arch):
    """bf16 params and activations (the full-width dtype), with the stub;
    ``_close_bf16``'s bound (ROADMAP queue 3 item 5)."""
    over = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
    jb, jp, tb, tp = _pair(arch, seed=9, **over)
    batch = _batch(jb.cfg, 2, 13, 9, targets=False)
    P = jb.cfg.vision_tokens if arch == "internvl2-26b" else 0
    extra = {k: batch[k] for k in ("frames",) if k in batch}
    jc, tc = jb.init_cache(2, P + 16), tb.init_cache(2, P + 16, device="cpu")
    jl, jc = jb.prefill(jp, _jx(batch), jc)
    tl, tc = tb.prefill(tp, _th(batch), tc)
    _close_bf16(tl, jl, "prefill logits")
    tok = batch["tokens"][:, :1]
    jl, jc = jb.decode_step(jp, {"token": jnp.asarray(tok),
                                 "index": jnp.asarray(P + 13, jnp.int32), **_jx(extra)}, jc)
    tl, tc = tb.decode_step(tp, {"token": torch.from_numpy(tok), "index": P + 13,
                                 **_th(extra)}, tc)
    _close_bf16(tl, jl, "decode logits")


# ------------------------------------------------------------------ training


G, K, E, H, A, LR = 2, 2, 2, 2, 2, 0.05


def _round_batch(cfg, seed, T=24):
    """One round's batch ``[E, H, A, G, K, 1, ...]`` with the stub."""
    lead = (E, H, A, G, K, 1)
    n = int(np.prod(lead))
    b = _batch(cfg, n, T, seed)
    return {k: v.reshape(lead + v.shape[1:]) for k, v in b.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_round_matches_reference(arch):
    """Reduced model (float32, remat), 2 x 2 clients, E = H = A = 2, tree +
    fused: one round through both packages' build/round_fn from the same
    params and a batch that carries the modality stub."""
    jb, jp, tb, tp = _pair(arch, seed=10, remat=True)
    batch = _round_batch(jb.cfg, 10)
    kw = dict(levels=(G, K), backend="sharded", lr=LR, state_layout="tree", fusion="fused")
    jspec = japi.ExperimentSpec(schedule=japi.RoundSchedule(
        group_rounds=E, local_steps=H, microbatches=A), fused_mode="interpret", **kw)
    tspec = tapi.ExperimentSpec(schedule=tapi.RoundSchedule(
        group_rounds=E, local_steps=H, microbatches=A), **kw)
    jeng, teng = japi.build(jspec, jb.loss), tapi.build(tspec, tb.loss, device="cpu")
    js, jm = jeng.round_fn(jeng.init(jp), _jx(batch))
    ts, tm = teng.round_fn(teng.init(tp), _th(batch))
    np.testing.assert_allclose(tm.loss.numpy(), np.asarray(jm.loss), rtol=1e-5)
    for name, atol in (("params", 1e-5), ("z", 1e-5 / (H * LR)), ("y", 1e-5 / (H * E * LR))):
        got, want = convert.to_numpy(getattr(ts, name)), _np(getattr(js, name))
        _close(got, want, atol=atol, tag=name)
    stub = {k: v for k, v in convert.to_numpy(ts.params).items() if k in STUB_LEAVES[arch]}
    start = {k: v for k, v in _np(jp).items() if k in STUB_LEAVES[arch]}
    assert any(np.any(a != b) for a, b in zip(jax.tree.leaves(stub), jax.tree.leaves(start)))


def _pool_data(cfg, n, T, seed):
    """``n`` samples for ``pack_arrays``: tokens and next-token targets
    from one stream, and the modality stub."""
    rng = np.random.default_rng(seed)
    stream = rng.integers(0, cfg.vocab_size, n * (T + 1)).astype(np.int32)
    win = stream.reshape(n, T + 1)
    return {"tokens": win[:, :-1].copy(), "targets": win[:, 1:].copy(), **_stub(cfg, n, seed)}


@pytest.mark.parametrize("layout", ["tree", "flat"])
@pytest.mark.parametrize("arch", ARCHS)
def test_pack_arrays_fit_carries_the_stub(arch, layout):
    """``pack_arrays`` with the stub beside the tokens -> ``fit``: the stub
    reaches ``loss`` (its leaves move); without it, plain MTGC leaves them
    bit for bit as they were, their z and y zero."""
    cfg = tconfigs.get_arch(arch).reduced(remat=True)
    tb = TT.build_model(cfg)
    p0 = tb.init(11, device="cpu")
    spec = tapi.ExperimentSpec(levels=(G, K), backend="sharded", lr=LR, state_layout=layout,
                               fusion="fused", schedule=tapi.RoundSchedule(
                                   group_rounds=E, local_steps=H, microbatches=A))
    eng = tapi.build(spec, tb.loss, device="cpu")
    arrays = _pool_data(cfg, 12, 16, 11)
    pools = [[np.arange(g * 6 + k * 3, g * 6 + k * 3 + 3) for k in range(K)] for g in range(G)]
    moved = {}
    for with_stub in (True, False):
        data_arrays = arrays if with_stub else {k: arrays[k] for k in ("tokens", "targets")}
        data = eng.pack_arrays(data_arrays, pools, batch_size=1, shards=2,
                               rng=np.random.default_rng(12),
                               generator=torch.Generator().manual_seed(12))
        assert sorted(data.arrays) == sorted(data_arrays)
        st, hz = tapi.fit(eng, data, 1, params=p0)
        assert np.isfinite(np.asarray(hz.metrics.loss)).all()
        params = tree_map(lambda t: t[0, 0], _state_tree(st.params))
        for key in STUB_LEAVES[arch]:
            leaves = zip(jax.tree.leaves(convert.to_numpy(params[key])),
                         jax.tree.leaves(convert.to_numpy(p0[key])))
            moved[(with_stub, key)] = any(np.any(a != b) for a, b in leaves)
            if not with_stub:
                for fld in (st.z, st.y):
                    assert not any(t.any() for t in jax.tree.leaves(
                        _state_tree(fld)[key], is_leaf=torch.is_tensor)), key
    assert all(moved[(True, k)] for k in STUB_LEAVES[arch]), moved
    assert not any(moved[(False, k)] for k in STUB_LEAVES[arch]), moved


def _state_tree(field):
    """A state field as a tree of ``[G, K, ...]`` (or ``[G, ...]``) leaves,
    whichever layout the engine keeps."""
    return field.to_tree() if is_flat(field) else field


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli_smoke(arch, capsys):
    from repro_torch.launch import train
    train.main(["--arch", arch, "--smoke", "--rounds", "1", "--device", "cpu", "--seq", "32",
                "--shards", "2"])
    out = capsys.readouterr().out
    assert f"[train] arch={arch}" in out and "device=cpu" in out
    losses = [float(line.split()[3]) for line in out.splitlines() if line.startswith("round ")]
    assert len(losses) == 1 and np.isfinite(losses).all()


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_smoke(arch, capsys):
    serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2",
                "--prompt-len", "8", "--gen", "4"])
    out = capsys.readouterr().out
    assert f"[serve] arch={arch} device=cpu generated (2, 4)" in out
    assert ("encoder" in out) == (arch == "whisper-medium")
