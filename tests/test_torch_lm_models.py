"""The port's LM stack (``repro_torch.models``) against the JAX package on
the CPU: the layers one by one, then ``forward``/``prefill``/``decode_step``
of the reduced archs (2 layers, width 128, float32, ``attn_block=16``,
``rwkv_chunk=4``, so every call crosses several blocks and chunks):
glm4-9b, qwen3-14b, rwkv6-1.6b, qwen2.5-32b (QKV biases), gemma3-27b at 7
layers (six windowed at the reduced window of 16 and one global, tied
embeddings), hymba-1.5b (windowed attention and the selective SSM in
parallel; its ``sstate`` cache leaf) and granite-moe-1b-a400m (4 experts,
top 2; serving routes dropless at these sizes), whisper-medium and
internvl2-26b (here from tokens alone: their frames and patches are held in
``test_torch_audio_vlm.py``). The windowed archs take prompts longer than
their window. Params come from the reference's ``init`` and
cross through ``repro_torch.convert``; inputs come from numpy seeds.

Tolerances: float32 at rtol 1e-4 / atol 1e-5 (the two packages sum their
products in another order); cache leaves and the RWKV state at atol 1e-4,
because the state is a decayed sum over every token so far and carries
that order's rounding at its own magnitude. The bfloat16 variant is held
twice (ROADMAP queue 3). Each logit lies within four bf16 ulps of the
largest logit (atol 0.0625 for logits in [2, 4)): a bf16 rounding that
lands the other way in one package moves an activation by a bf16 ulp, and
two layers carry it into every logit as an absolute error (the largest
seen was 0.045, three ulps), so a bound relative to each logit's own
magnitude does not hold. And the rms of the difference stays within 2% of
the logits' rms (about 2.5 ulps of an rms-sized logit; 0.8-1.3% seen):
this is the check that catches a port that accumulates its products in
bfloat16, which gave 4.2-5.9% at this size while its largest difference
(0.14-0.20) came close to the first bound.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import rwkv6 as JR  # noqa: E402
from repro.models.transformer import build_model as jbuild  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import rwkv6 as TR  # noqa: E402
from repro_torch.models.config import ArchConfig  # noqa: E402
from repro_torch.models.transformer import build_model as tbuild  # noqa: E402

ARCHS = ("glm4-9b", "qwen3-14b", "rwkv6-1.6b", "qwen2.5-32b", "gemma3-27b", "hymba-1.5b",
         "granite-moe-1b-a400m", "whisper-medium", "internvl2-26b", "mixtral-8x22b")
RTOL, ATOL = 1e-4, 1e-5
# gemma3 at 7 layers: its 6th is global (every (5 + 1)-th), the others windowed.
OVER = {"gemma3-27b": dict(num_layers=7)}
# granite's bf16 logits differ by up to 4.75 bf16 ulps of the largest logit
# (0.074, past this file's bound of four): its two expert layers each carry
# F.silu's one-ulp rounding departure through the down projection.
# tests/test_torch_moe.py holds its bf16 block against the reference with
# that cause shown (ROADMAP queue 3).
# mixtral's expert layers carry the same rounding.
BF16_ARCHS = tuple(a for a in ARCHS if a not in ("granite-moe-1b-a400m", "mixtral-8x22b"))
# Prompt lengths: longer than the reduced window (16) where the arch has one.
WINDOWED = ("gemma3-27b", "hymba-1.5b", "mixtral-8x22b")


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """One intra-op thread: the suite runs files in parallel workers, and
    PyTorch's default of one thread per core would crowd out the other
    workers' (timing-sensitive) tests."""
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
    over = {**OVER.get(arch, {}), **over}
    jcfg = jget_arch(arch).reduced(**over)
    jb = jbuild(jcfg)
    jp = jb.init(jax.random.PRNGKey(seed))
    tcfg = tconfigs.get_arch(arch).reduced(**over)
    return jb, jp, tbuild(tcfg), convert.params_from_numpy(_np(jp), "cpu")


# ------------------------------------------------------------------ configs


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_are_the_reference_numbers(arch):
    import dataclasses
    want = dataclasses.asdict(jget_arch(arch))
    assert dataclasses.asdict(tconfigs.get_arch(arch)) == want
    assert dataclasses.asdict(tconfigs.get_arch(arch).reduced()) == dataclasses.asdict(
        jget_arch(arch).reduced())
    for prop in ("vocab_padded", "sub_quadratic", "supports_decode"):
        assert getattr(tconfigs.get_arch(arch), prop) == getattr(jget_arch(arch), prop)
    assert [f.name for f in dataclasses.fields(ArchConfig)] == list(want)


def test_other_archs_name_their_slice():
    """Every architecture of the reference is ported (mixtral-8x22b, the
    last, came with the multi-card mesh); every family of the reference
    builds."""
    from repro.configs import ARCH_IDS
    from repro.models.transformer import build_model as jbuild_family
    assert tconfigs.ARCH_IDS == ARCH_IDS
    assert set(ARCH_IDS) == set(ARCHS)
    assert set(tconfigs.PORTED) == set(ARCHS)
    assert tconfigs.get_arch("mixtral-8x22b").name == "mixtral-8x22b"
    with pytest.raises(KeyError):
        tconfigs.get_arch("gpt-9")
    for arch in ARCHS:
        cfg = tconfigs.get_arch(arch).reduced()
        assert tbuild(cfg).cfg.arch_type == jbuild_family(jget_arch(arch).reduced()).cfg.arch_type
    from repro_torch.models.transformer import FAMILIES
    assert set(FAMILIES) == {jget_arch(a).arch_type for a in ARCH_IDS}
    with pytest.raises(ValueError, match="unknown arch_type"):
        tbuild(tconfigs.get_arch("qwen3-14b").reduced(arch_type="diffusion"))


def test_gemma3_layer_pattern():
    """tests/test_models.py::test_gemma3_layer_pattern on the port."""
    from repro_torch.models.transformer import _layer_windows
    w = _layer_windows(tconfigs.get_arch("gemma3-27b"))
    assert len(w) == 62
    assert (w == 0).sum() == 10          # every 6th layer is global
    assert (w[:5] == 1024).all() and w[5] == 0
    assert (_layer_windows(tconfigs.get_arch("hymba-1.5b")) == 1024).all()


def test_sliding_window_limits_attention():
    """tests/test_models.py::test_sliding_window_limits_attention on a
    one-layer gemma3 at window 4: a token beyond the window cannot move the
    last position's logits."""
    tb = tbuild(tconfigs.get_arch("gemma3-27b").reduced(sliding_window=4, num_layers=1))
    tp = tb.init(2, device="cpu")
    toks = np.random.default_rng(2).integers(0, 256, (1, 24))
    toks2 = toks.copy()
    toks2[0, 0] = (toks2[0, 0] + 7) % 256        # mutate a far-past token
    l1 = tb.forward(tp, {"tokens": torch.from_numpy(toks)})[:, -1]
    l2 = tb.forward(tp, {"tokens": torch.from_numpy(toks2)})[:, -1]
    np.testing.assert_allclose(l1.numpy(), l2.numpy(), atol=1e-5)
    toks2[0, -4] = (toks2[0, -4] + 7) % 256      # a token inside the window does
    l3 = tb.forward(tp, {"tokens": torch.from_numpy(toks2)})[:, -1]
    assert (l3 - l1).abs().max().item() > 1e-3


# ------------------------------------------------------------------ layers


def test_rms_norm_and_rope():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 7, 3, 32)).astype(np.float32) * 3
    scale = rng.normal(size=(32,)).astype(np.float32) * 0.1
    _close(TL.rms_norm(_t(x), _t(scale)), JL.rms_norm(jnp.asarray(x), jnp.asarray(scale)))
    pos = np.broadcast_to(np.arange(7)[None] + 5, (2, 7)).astype(np.int32)
    for base in (1e4, 1e6):
        _close(TL.apply_rope(_t(x), torch.from_numpy(pos.copy()), base),
               JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), base), atol=1e-5)
    xb = jnp.asarray(x, jnp.bfloat16)
    got = TL.rms_norm(convert.tensor_from_numpy(xb, "cpu"), _t(scale))
    assert got.dtype == torch.bfloat16
    _close(got, JL.rms_norm(xb, jnp.asarray(scale)), rtol=2 ** -7, atol=0)


def _attn_params(seed, n_heads=4, n_kv=2, d_head=32, d_model=64):
    jp = JL.init_attention(jax.random.PRNGKey(seed), d_model, n_heads, n_kv, d_head,
                           jnp.float32, qk_norm=True)
    jp = jax.tree.map(lambda a: a + 0.1 if a.ndim == 1 else a, jp)  # nonzero qk-norm scales
    return jp, convert.params_from_numpy(_np(jp), "cpu")


@pytest.mark.parametrize("impl,window", [("naive", 0), ("blocked", 0), ("blocked", 5),
                                         ("naive", 5)])
def test_attention_block_without_cache(impl, window):
    jp, tp = _attn_params(1)
    x = np.random.default_rng(1).normal(size=(2, 19, 64)).astype(np.float32)
    kw = dict(n_heads=4, n_kv=2, d_head=32, rope_base=1e4, window=window, qk_norm=True,
              attn_impl=impl, block=8)
    jo, _ = JL.attention_block(jp, jnp.asarray(x), **kw)
    to, tc = TL.attention_block(tp, _t(x), **kw)
    assert tc is None
    _close(to, jo)


def test_attention_block_prefill_then_decode_with_cache():
    """Prefill writes T positions of a longer cache and attends over all of
    it (blocked); decode writes one position and takes the GQA decode path."""
    jp, tp = _attn_params(2)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 11, 64)).astype(np.float32)
    x1 = rng.normal(size=(2, 1, 64)).astype(np.float32)
    kw = dict(n_heads=4, n_kv=2, d_head=32, rope_base=1e6, qk_norm=True, block=4)
    jcache = {"k": jnp.zeros((2, 16, 2, 32)), "v": jnp.zeros((2, 16, 2, 32))}
    tcache = {"k": torch.zeros(2, 16, 2, 32), "v": torch.zeros(2, 16, 2, 32)}
    jo, jcache = JL.attention_block(jp, jnp.asarray(x), kv_cache=jcache, cache_index=0, **kw)
    to, tc = TL.attention_block(tp, _t(x), kv_cache=tcache, cache_index=0, **kw)
    assert tc["k"] is tcache["k"]                     # written in place
    _close(to, jo)
    _close(tc, _np(jcache))
    jo, jcache = JL.attention_block(jp, jnp.asarray(x1), kv_cache=jcache,
                                    cache_index=jnp.asarray(11, jnp.int32), **kw)
    to, tc = TL.attention_block(tp, _t(x1), kv_cache=tcache, cache_index=11, **kw)
    _close(to, jo)
    _close(tc, _np(jcache))
    with pytest.raises(ValueError, match="overflows"):
        TL.attention_block(tp, _t(x), kv_cache=tcache, cache_index=8, **kw)


@pytest.mark.parametrize("window,off", [(0, 9), (4, 9), (0, 0)])
def test_gqa_decode_attention(window, off):
    rng = np.random.default_rng(window + off)
    q = rng.normal(size=(2, 1, 6, 32)).astype(np.float32)
    k = rng.normal(size=(2, 12, 2, 32)).astype(np.float32)
    v = rng.normal(size=(2, 12, 2, 32)).astype(np.float32)
    _close(TL.gqa_decode_attention(_t(q), _t(k), _t(v), window=window, q_offset=off),
           JL.gqa_decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   window=window, q_offset=off))


@pytest.mark.parametrize("T,chunk", [(16, 4), (13, 4), (5, 8)])
def test_rwkv6_chunked_and_step(T, chunk):
    """The chunked prefill (ragged T included) and then three one-token
    steps from the carried state."""
    D, H = 64, 4
    jp = JR.init_rwkv6(jax.random.PRNGKey(T), D, H, jnp.float32)
    tp = convert.params_from_numpy(_np(jp), "cpu")
    rng = np.random.default_rng(T)
    x = rng.normal(size=(2, T, D)).astype(np.float32)
    xp = rng.normal(size=(2, D)).astype(np.float32)
    st = rng.normal(size=(2, H, D // H, D // H)).astype(np.float32) * 0.1
    jo, jx, js = JR.rwkv6_chunked(jp, jnp.asarray(x), jnp.asarray(xp), jnp.asarray(st),
                                  n_heads=H, chunk=chunk)
    to, tx, ts = TR.rwkv6_chunked(tp, _t(x), _t(xp), _t(st), n_heads=H, chunk=chunk)
    _close(to, jo)
    _close(tx, jx)
    _close(ts, js, atol=1e-4)
    for i in range(3):
        xt = rng.normal(size=(2, D)).astype(np.float32)
        jo, jx, js = JR.rwkv6_step(jp, jnp.asarray(xt), jx, js, n_heads=H)
        to, tx, ts = TR.rwkv6_step(tp, _t(xt), tx, ts, n_heads=H)
        _close(to, jo, tag=f"step {i}")
        _close(ts, js, atol=1e-4, tag=f"state {i}")


# ------------------------------------------------------------------ models


def _tokens(seed, B, T, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, (B, T)).astype(np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_matches_reference_tree(arch):
    jb, jp, tb, _ = _pair(arch)
    tp = tb.init(0, device="cpu")
    want = jax.tree_util.tree_flatten_with_path(_np(jp))[0]
    got = jax.tree_util.tree_flatten_with_path(convert.to_numpy(tp))[0]
    assert [(jax.tree_util.keystr(p), a.shape) for p, a in got] == \
        [(jax.tree_util.keystr(p), a.shape) for p, a in want]
    dtypes = {str(t.dtype) for t in jax.tree.leaves(tp, is_leaf=torch.is_tensor)}
    assert dtypes <= {"torch.float32"}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tb.init(0)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tb.init_cache(1, 4)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch):
    jb, jp, tb, tp = _pair(arch, seed=1)
    toks = _tokens(1, 2, 21)
    want = jb.forward(jp, {"tokens": jnp.asarray(toks)})
    got = tb.forward(tp, {"tokens": torch.from_numpy(toks)})
    assert tuple(got.shape) == (2, 21, 512)
    _close(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_matches_reference(arch):
    """The training loss (float32) on 2 x 21 tokens and their targets."""
    jb, jp, tb, tp = _pair(arch, seed=2)
    toks, tgts = _tokens(3, 2, 21), _tokens(4, 2, 21)
    want = jb.loss(jp, {"tokens": jnp.asarray(toks), "targets": jnp.asarray(tgts)})
    got = tb.loss(tp, {"tokens": torch.from_numpy(toks), "targets": torch.from_numpy(tgts)})
    assert got.dtype == torch.float32 and got.dim() == 0
    _close(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch):
    """Prefill 13 prompt tokens (21 where the arch has a window) into a
    cache of 7 more positions, then 4 decode steps: logits and every cache
    leaf (hymba's ``sstate`` included) after each call."""
    jb, jp, tb, tp = _pair(arch, seed=2)
    T = 21 if arch in WINDOWED else 13
    toks = _tokens(2, 2, T)
    jc = jb.init_cache(2, T + 7)
    tc = tb.init_cache(2, T + 7, device="cpu")
    _close(tc, _np(jc), tag="init_cache")
    jl, jc = jb.prefill(jp, {"tokens": jnp.asarray(toks)}, jc)
    tl, tc = tb.prefill(tp, {"tokens": torch.from_numpy(toks)}, tc)
    _close(tl, jl, tag="prefill logits")
    _close(tc, _np(jc), atol=1e-4, tag="prefill cache")
    nxt = _tokens(3, 2, 4)
    for i in range(4):
        tok = nxt[:, i:i + 1]
        jl, jc = jb.decode_step(jp, {"token": jnp.asarray(tok),
                                     "index": jnp.asarray(T + i, jnp.int32)}, jc)
        tl, tc = tb.decode_step(tp, {"token": torch.from_numpy(tok), "index": T + i}, tc)
        _close(tl, jl, tag=f"decode {i} logits")
        _close(tc, _np(jc), atol=1e-4, tag=f"decode {i} cache")


def _close_bf16(got, want, tag):
    """Within four bfloat16 ulps of the largest logit, element by element,
    and within 2% of the logits' rms in rms (module docstring)."""
    want = np.asarray(want, np.float32)
    top = float(np.max(np.abs(want)))
    _close(got, want, rtol=0, atol=4 * 2.0 ** (np.floor(np.log2(top)) - 7), tag=tag)
    rms = lambda a: float(np.sqrt(np.mean(np.square(a))))  # noqa: E731
    diff = convert.to_numpy(got) - want
    assert rms(diff) <= 0.02 * rms(want), (tag, rms(diff), rms(want))


@pytest.mark.parametrize("arch", BF16_ARCHS)
def test_bf16_prefill_and_decode_match_reference(arch):
    """The same in bfloat16 params and activations (the full-width dtype);
    tolerance in the module docstring."""
    over = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
    jb, jp, tb, tp = _pair(arch, seed=4, **over)
    assert tp["layers"]["ln1"].dtype == torch.bfloat16
    T = 21 if arch in WINDOWED else 13
    toks = _tokens(4, 2, T)
    jc, tc = jb.init_cache(2, T + 3), tb.init_cache(2, T + 3, device="cpu")
    jl, jc = jb.prefill(jp, {"tokens": jnp.asarray(toks)}, jc)
    tl, tc = tb.prefill(tp, {"tokens": torch.from_numpy(toks)}, tc)
    _close_bf16(tl, jl, "prefill logits")
    jl, jc = jb.decode_step(jp, {"token": jnp.asarray(toks[:, :1]),
                                 "index": jnp.asarray(T, jnp.int32)}, jc)
    tl, tc = tb.decode_step(tp, {"token": torch.from_numpy(toks[:, :1]), "index": T}, tc)
    _close_bf16(tl, jl, "decode logits")


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """The port alone (as tests/test_models.py:56): prefill T - 1 tokens and
    decode the last one; its logits equal the full forward's last row (T
    = 16, 24 where the arch has a window)."""
    tb = tbuild(tconfigs.get_arch(arch).reduced(**OVER.get(arch, {})))
    tp = tb.init(1, device="cpu")
    T = 24 if arch in WINDOWED else 16
    toks = torch.from_numpy(_tokens(1, 2, T))
    full = tb.forward(tp, {"tokens": toks})[:, -1]
    cache = tb.init_cache(2, T, device="cpu")
    _, cache = tb.prefill(tp, {"tokens": toks[:, :-1]}, cache)
    lg, _ = tb.decode_step(tp, {"token": toks[:, -1:], "index": T - 1}, cache)
    assert (full - lg).abs().max().item() < 5e-4


def test_hybrid_cache_crosses_from_reference():
    """A reference prefill's cache (k, v and hymba's ``sstate``) crosses
    through ``params_from_numpy`` and the port decodes from it as the
    reference does; ``to_numpy`` brings the cache back."""
    jb, jp, tb, tp = _pair("hymba-1.5b", seed=5)
    toks = _tokens(5, 2, 19)
    jl, jc = jb.prefill(jp, {"tokens": jnp.asarray(toks)}, jb.init_cache(2, 22))
    tc = convert.params_from_numpy(_np(jc), "cpu")
    assert sorted(tc) == ["k", "sstate", "v"] and tc["sstate"].dtype == torch.float32
    tok = toks[:, -1:]
    jl, jc = jb.decode_step(jp, {"token": jnp.asarray(tok), "index": jnp.asarray(19, jnp.int32)},
                            jc)
    tl, tc = tb.decode_step(tp, {"token": torch.from_numpy(tok), "index": 19}, tc)
    _close(tl, jl)
    _close(tc, _np(jc), atol=1e-4)
