"""The port's remainders against the reference, on the CPU: the tree
helpers, ``make_feature_shift`` and ``make_language``, ``resnet_gn`` and
``lstm``, SCAFFOLD (and MTGC's reduction to it), the optimizers and the
learning-rate schedules.

Tolerances, each with its reason:
* data: draw for draw, exact.
* ``resnet_gn``: rtol 1e-4 with an atol of 1e-4 of the largest entry (of
  the logits, of the gradient), as the CNN is held (ROADMAP queue 3 item 1: PyTorch and XLA sum
  convolutions in another order). Its stride-2 convolutions pad as XLA's
  SAME does, so an even size is exact at the convolution itself.
* ``lstm``: rtol 1e-5 / atol 1e-6.
* SCAFFOLD: rtol 1e-5 / atol 1e-6; its option-II control is a difference
  quotient ``(x0 - x_H) / (H lr)``, so its atol is carried through it.
* optimizers and schedules: bit for bit against the reference run op by op
  (eagerly), apart from AdamW, whose ``sqrt`` PyTorch's CPU kernels round
  to about 0.55 ulp where XLA's and numpy's are correctly rounded: within
  one ulp of each leaf's largest entry a step (seen: two after ten steps,
  on a bias). Under ``jax.jit`` XLA rewrites
  ``x / c`` as ``x * (1 / c)`` and contracts products into FMAs: against
  the jitted reference, four ulps of each leaf's largest entry, and the
  schedules within one ulp of the peak lr (the cosine's slope near its end
  amplifies the one-ulp rewrite).
"""
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.func import grad_and_value, vmap  # noqa: E402

from repro import optim as joptim  # noqa: E402
from repro.core import HFLConfig as JCfg  # noqa: E402
from repro.core import global_model as jglobal  # noqa: E402
from repro.core import hfl_init as jinit_state  # noqa: E402
from repro.core import make_global_round as jmake_round  # noqa: E402
from repro.core import make_scaffold_round as jmake_scaffold  # noqa: E402
from repro.core import scaffold_init as jscaffold_init  # noqa: E402
from repro.core import tree as jtree  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.models import small as jsmall  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import optim as toptim  # noqa: E402
from repro_torch.core import tree as ttree  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402
from repro_torch.models import small as tsmall  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """One intra-op thread: the suite runs files in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(tree):
    return convert.params_from_numpy(_np(tree), "cpu")


def _assert_tree(got, want, rtol, atol, tag):
    got, want = convert.to_numpy(got), _np(want)
    assert sorted(got) == sorted(want), tag
    for k in want:
        if isinstance(want[k], dict):
            _assert_tree(got[k], want[k], rtol, atol, f"{tag}.{k}")
            continue
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol, err_msg=f"{tag}.{k}")


# ----------------------------------------------------------- tree helpers


def test_tree_helpers_match_reference():
    rng = np.random.default_rng(0)
    a = {"w": rng.normal(size=(3, 4)).astype(np.float32), "b": {"c": rng.normal(size=5)
                                                               .astype(np.float32)}}
    b = jax.tree.map(lambda x: (x + rng.normal(size=x.shape) * 1e-3).astype(np.float32), a)
    ja, jb, ta, tb = _np(a), _np(b), _t(a), _t(b)
    for got, want in ((ttree.tree_scale(ta, 0.3), jtree.tree_scale(ja, 0.3)),
                      (ttree.tree_axpy(-1.7, ta, tb), jtree.tree_axpy(-1.7, ja, jb)),
                      (ttree.tree_cast(ta, torch.bfloat16),
                       jax.tree.map(lambda x: x.astype(jnp.float32),
                                    jtree.tree_cast(ja, jnp.bfloat16)))):
        _assert_tree(got, want, 0, 0, "tree")
    assert ttree.tree_cast(ta, torch.bfloat16)["w"].dtype == torch.bfloat16
    for rtol, atol in ((1e-5, 1e-6), (1e-2, 1e-2), (0.0, 0.0)):
        assert ttree.tree_allclose(ta, tb, rtol, atol) == jtree.tree_allclose(ja, jb, rtol, atol)
    assert ttree.tree_allclose(ta, ta) and not ttree.tree_allclose(ta, tb)
    nan = ttree.tree_map(lambda x: x.clone(), ta)
    nan["w"][0, 0] = float("nan")
    assert not ttree.tree_allclose(nan, nan)
    assert ttree.tree_allclose(ttree.tree_cast(ta, torch.bfloat16), ta, rtol=1e-2, atol=1e-2)


# ------------------------------------------------------------------ data


def test_feature_shift_matches_reference():
    rng = np.random.default_rng(1)
    ds = tsyn.make_classification(rng, num_samples=120, dim=12, image_shape=(2, 2, 3))
    assign = rng.integers(0, 3, size=120)
    rot = np.array([0.0, 35.0, -120.0])
    got = tsyn.make_feature_shift(ds, rot, assign)
    want = jsyn.make_feature_shift(jsyn.Dataset(*ds), rot, assign)
    assert got.x.shape == ds.x.shape and got.num_classes == want.num_classes
    np.testing.assert_array_equal(got.x, want.x)
    np.testing.assert_array_equal(got.y, want.y)
    # Only the first two coordinates move, and a rotation keeps their norm.
    flat, src = got.x.reshape(120, -1), ds.x.reshape(120, -1)
    np.testing.assert_array_equal(flat[:, 2:], src[:, 2:])
    np.testing.assert_allclose(np.hypot(flat[:, 0], flat[:, 1]),
                               np.hypot(src[:, 0], src[:, 1]), rtol=1e-5)


def test_language_matches_reference():
    """Draw for draw at ``tests/test_data.py``'s small sizes."""
    rt, rj = np.random.default_rng(4), np.random.default_rng(4)
    (got, gs), (want, ws) = (tsyn.make_language(rt, num_styles=3, vocab=16, samples_per_style=20,
                                                seq_len=40),
                             jsyn.make_language(rj, num_styles=3, vocab=16, samples_per_style=20,
                                                seq_len=40))
    for a, b in ((got.x, want.x), (got.y, want.y), (gs, ws)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert got.num_classes == 16 and rt.integers(1 << 30) == rj.integers(1 << 30)
    np.testing.assert_array_equal(got.y[:, :-1], got.x[:, 1:])


# ---------------------------------------------------------------- models


RESNET_CASES = {
    # (image shape, widths, blocks): an even size puts SAME's (0, 1) pad on
    # every stride-2 convolution, and widths (4, 8, 8) give stage 2 a
    # stride-2 block without a projection (its shortcut subsampled); (7, 5)
    # pads evenly at stride 2.
    "even": ((8, 8, 3), (4, 8, 8), 1),
    "odd": ((7, 5, 3), (4, 8), 1),
}


def _port_params(tinit, seed):
    """Params drawn by the port's init, as numpy arrays for both packages."""
    return convert.to_numpy(tinit(torch.Generator().manual_seed(seed), device="cpu"))


@pytest.mark.parametrize("case", sorted(RESNET_CASES))
def test_resnet_gn_matches_reference(case):
    """Forward and per-client gradients under ``vmap`` over 2 x 2 clients,
    from the same params."""
    shape, widths, blocks = RESNET_CASES[case]
    _, japply = jsmall.resnet_gn(10, shape, widths=widths, blocks_per_stage=blocks,
                                 gn_groups=4)
    tinit, tapply = tsmall.resnet_gn(10, shape, widths=widths, blocks_per_stage=blocks,
                                     gn_groups=4)
    p = _port_params(tinit, 1)
    tp = _t(p)
    assert ("proj" in tp["s1b0"]) == (widths[1] != widths[0])
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 2, 3) + shape).astype(np.float32)
    y = rng.integers(0, 10, size=(2, 2, 3)).astype(np.int32)
    logits = np.asarray(jax.jit(japply)(p, jnp.asarray(x[0, 0])))
    np.testing.assert_allclose(tapply(tp, torch.from_numpy(x[0, 0])).numpy(), logits,
                               rtol=1e-4, atol=1e-4 * float(np.abs(logits).max()))
    stack = lambda t: jax.tree.map(lambda a: np.broadcast_to(a, (2, 2) + a.shape).copy(), t)  # noqa: E731
    jl, jg = jax.jit(jax.vmap(jax.vmap(jax.value_and_grad(jsmall.make_loss(japply)))))(
        stack(_np(p)), {"x": x, "y": y})
    tg, tl = vmap(vmap(grad_and_value(tsmall.make_loss(tapply))))(
        _t(stack(_np(p))), {"x": torch.from_numpy(x), "y": torch.from_numpy(y)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4)
    # atol: 1e-4 of the gradient's largest entry. A convolution's bias in
    # front of a one-channel group of GroupNorm has a zero gradient, which
    # both packages return as rounding noise.
    scale = max(float(np.abs(g).max()) for g in jax.tree.leaves(_np(jg)))
    _assert_tree(tg, jg, 1e-4, 1e-4 * scale, f"resnet_{case}.grad")


def test_resnet_gn_init_shapes():
    jinit, _ = jsmall.resnet_gn(100, (32, 32, 3))
    tinit, _ = tsmall.resnet_gn(100, (32, 32, 3))
    want = jax.eval_shape(jinit, jax.random.PRNGKey(0))
    got = tinit(torch.Generator().manual_seed(0), device="cpu")
    assert ttree.tree_map(lambda t: tuple(t.shape), got) == jax.tree.map(lambda a: a.shape, want)
    assert all(t.dtype == torch.float32 for t in ttree.tree_leaves(got))
    assert all(bool((got[f"s{s}b{b}"][g]["scale"] == 1).all()) for s in range(3)
               for b in range(2) for g in ("gn1", "gn2"))


def test_lstm_matches_reference():
    """Logits ``[B, T, vocab]``, loss and per-client gradients under
    ``vmap`` over 2 x 2 clients, on ``make_language`` sequences."""
    jinit, japply = jsmall.lstm(16, hidden=24, embed=8)
    tinit, tapply = tsmall.lstm(16, hidden=24, embed=8)
    p = _port_params(tinit, 4)
    tp = _t(p)
    ds, _ = tsyn.make_language(np.random.default_rng(5), num_styles=2, vocab=16,
                               samples_per_style=6, seq_len=20)
    x, y = ds.x.reshape(2, 2, 3, 20), ds.y.reshape(2, 2, 3, 20)
    logits = tapply(tp, torch.from_numpy(x[0, 0]))
    assert tuple(logits.shape) == (3, 20, 16)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jax.jit(japply)(p, x[0, 0])),
                               rtol=1e-5, atol=1e-6)
    stack = lambda t: jax.tree.map(lambda a: np.broadcast_to(a, (2, 2) + a.shape).copy(), t)  # noqa: E731
    jl, jg = jax.jit(jax.vmap(jax.vmap(jax.value_and_grad(jsmall.make_loss(japply)))))(
        stack(_np(p)), {"x": x, "y": y})
    tg, tl = vmap(vmap(grad_and_value(tsmall.make_loss(tapply))))(
        _t(stack(_np(p))), {"x": torch.from_numpy(x), "y": torch.from_numpy(y)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5, atol=1e-6)
    _assert_tree(tg, jg, 1e-5, 1e-6, "lstm.grad")
    # init: the reference's shapes, the forget bias not folded into b.
    shapes = jax.tree.map(lambda a: a.shape, jax.eval_shape(jinit, jax.random.PRNGKey(0)))
    got = tinit(torch.Generator().manual_seed(0), device="cpu")
    assert ttree.tree_map(lambda t: tuple(t.shape), got) == shapes
    assert not bool(got["wx"]["b"].any())


# -------------------------------------------------------------- SCAFFOLD


def _quad(lib):
    def loss(params, batch):
        r = batch["a"] * params["w"] - batch["b"]
        return 0.5 * lib.sum(r * r)
    return loss


D = 6


def _scaffold_batches(K, H, seed):
    """Per-client (a, b) varying by step: ``[H, K, D]``."""
    rng = np.random.default_rng(seed)
    return {"a": rng.normal(size=(H, K, D)).astype(np.float32) + 2.0,
            "b": rng.normal(size=(H, K, D)).astype(np.float32)}


@pytest.mark.parametrize("option", ["I", "II"])
def test_scaffold_matches_reference(option):
    K, H, lr = 4, 5, 0.05
    jrf = jax.jit(jmake_scaffold(_quad(jnp), K, H, lr, option=option))
    trf = tcore.make_scaffold_round(_quad(torch), K, H, lr, option=option)
    js = jscaffold_init({"w": jnp.zeros(D)}, K)
    ts = tcore.scaffold_init({"w": torch.zeros(D)}, K)
    for r in range(3):
        b = _scaffold_batches(K, H, seed=r)
        js, jl = jrf(js, jax.tree.map(jnp.asarray, b))
        ts, tl = trf(ts, {k: torch.from_numpy(v) for k, v in b.items()})
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5, atol=1e-6)
        _assert_tree(ts.params, js.params, 1e-5, 1e-6, f"round{r}.params")
        for f in ("c_i", "c"):
            _assert_tree(getattr(ts, f), getattr(js, f), 1e-5, 1e-6 / (H * lr),
                         f"round{r}.{f}")
    assert isinstance(ts, tcore.ScaffoldState) and ts.params["w"].device.type == "cpu"


def test_mtgc_reduces_to_scaffold():
    """``tests/test_reductions.py::test_mtgc_reduces_to_scaffold`` in the
    port: MTGC with one group, E = 1 and the gradient correction init is
    SCAFFOLD option I, round for round, flat + fused and tree."""
    K, H, lr = 4, 5, 0.05
    rng = np.random.default_rng(7)
    a = rng.normal(size=(1, K, D)).astype(np.float32) + 2.0
    b = rng.normal(size=(1, K, D)).astype(np.float32)
    batches = {"a": torch.from_numpy(np.broadcast_to(a, (1, H, 1, K, D)).copy()),
               "b": torch.from_numpy(np.broadcast_to(b, (1, H, 1, K, D)).copy())}
    sc_batches = {k: v[0][:, 0] for k, v in batches.items()}      # [H, K, D]
    for flat in (True, False):
        cfg = tcore.HFLConfig(num_groups=1, clients_per_group=K, local_steps=H, group_rounds=1,
                              lr=lr, algorithm="mtgc", correction_init="gradient",
                              use_fused_update=True, use_flat_state=flat)
        with pytest.warns(DeprecationWarning):
            mtgc = tcore.make_global_round(_quad(torch), cfg, device="cpu")
        state = tcore.hfl_init({"w": torch.zeros(D)}, cfg, device="cpu")
        sc = tcore.make_scaffold_round(_quad(torch), K, H, lr, option="I")
        sc_state = tcore.scaffold_init({"w": torch.zeros(D)}, K)
        for _ in range(3):
            state, _ = mtgc(state, batches)
            sc_state, _ = sc(sc_state, sc_batches)
            np.testing.assert_allclose(tcore.global_model(state)["w"].numpy(),
                                       sc_state.params["w"][0].numpy(), rtol=1e-5, atol=1e-6)
    # And the reference's own MTGC run agrees with the port's SCAFFOLD.
    jcfg = JCfg(num_groups=1, clients_per_group=K, local_steps=H, group_rounds=1, lr=lr,
                algorithm="mtgc", correction_init="gradient")
    with pytest.warns(DeprecationWarning):
        jrf = jax.jit(jmake_round(_quad(jnp), jcfg))
    js = jinit_state({"w": jnp.zeros(D)}, jcfg)
    jb = {k: jnp.asarray(v.numpy()) for k, v in batches.items()}
    sc_state = tcore.scaffold_init({"w": torch.zeros(D)}, K)
    for _ in range(3):
        js, _ = jrf(js, jb)
        sc_state, _ = sc(sc_state, sc_batches)
    np.testing.assert_allclose(sc_state.params["w"][0].numpy(), np.asarray(jglobal(js)["w"]),
                               rtol=1e-5, atol=1e-6)


# ------------------------------------------------------ optimizers, lr


OPTIMIZERS = {
    "sgd": lambda m: m.sgd(0.1),
    "sgd_momentum": lambda m: m.sgd(0.1, momentum=0.9),
    "sgd_cosine": lambda m: m.sgd(m.cosine(0.1, 6), momentum=0.5),
    "adamw": lambda m: m.adamw(1e-2, weight_decay=0.1),
    "adamw_warmup_cosine": lambda m: m.adamw(m.linear_warmup_cosine(1e-2, 3, 8),
                                             weight_decay=0.01),
}


def _spacing_of_max(want):
    return np.spacing(np.float32(np.abs(want).max()))


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizers_match_reference(name):
    """Ten steps over the small CNN's tree (random gradients), against the
    reference op by op and under ``jax.jit`` (see the module docstring)."""
    p0 = _port_params(tsmall.cnn(10, (8, 8, 1))[0], 0)
    rng = np.random.default_rng(3)
    grads = [jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32), p0)
             for _ in range(10)]
    jopt, topt = OPTIMIZERS[name](joptim), OPTIMIZERS[name](toptim)
    runs = {}
    for jit in (False, True):
        jp = jax.tree.map(jnp.asarray, p0)
        js, upd = jopt.init(jp), (jax.jit(jopt.update) if jit else jopt.update)
        for i, g in enumerate(grads):
            jp, js = upd(jax.tree.map(jnp.asarray, g), js, jp, jnp.asarray(i, jnp.int32))
        runs[jit] = _np(jp)
    tp = _t(p0)
    ts = topt.init(tp)
    for i, g in enumerate(grads):
        tp, ts = topt.update(_t(g), ts, tp, torch.tensor(i))
    got = convert.to_numpy(tp)
    exact = name.startswith("sgd")
    for path, want in jax.tree_util.tree_flatten_with_path(runs[False])[0]:
        leaf = got
        for k in path:
            leaf = leaf[k.key]
        gap = np.abs(leaf - want).max()
        if exact:
            np.testing.assert_array_equal(leaf, want, err_msg=str(path))
        else:
            assert gap <= len(grads) * _spacing_of_max(want), (path, gap)
        jitted = jax.tree_util.tree_flatten_with_path(runs[True])[0]
        wj = dict(jitted)[path]
        assert np.abs(leaf - wj).max() <= 4 * _spacing_of_max(wj), path
    if not exact:
        assert all(v.dtype == torch.float32 for v in ttree.tree_leaves(ts["m"]))


def test_adamw_keeps_float32_moments_for_bf16_params():
    p = {"w": torch.ones(3, 5, dtype=torch.bfloat16)}
    opt = toptim.adamw(1e-2, weight_decay=0.1)
    s = opt.init(p)
    assert s["m"]["w"].dtype == torch.float32 and s["v"]["w"].dtype == torch.float32
    g = {"w": torch.linspace(-1, 1, 15).reshape(3, 5).to(torch.bfloat16)}
    new, s = opt.update(g, s, p, 0)
    assert new["w"].dtype == torch.bfloat16 and s["m"]["w"].dtype == torch.float32
    jnew, _ = joptim.adamw(1e-2, weight_decay=0.1).update(
        {"w": jnp.asarray(g["w"].float().numpy(), jnp.bfloat16)},
        joptim.adamw(1e-2).init({"w": jnp.ones((3, 5), jnp.bfloat16)}),
        {"w": jnp.ones((3, 5), jnp.bfloat16)}, jnp.asarray(0))
    np.testing.assert_array_equal(new["w"].float().numpy(),
                                  np.asarray(jnew["w"].astype(jnp.float32)))


SCHEDULES = {
    "constant": (lambda m: m.constant(0.3), 0.3),
    "cosine": (lambda m: m.cosine(0.1, 7), 0.1),
    "linear_warmup_cosine": (lambda m: m.linear_warmup_cosine(0.1, 3, 10), 0.1),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedules_match_reference(name):
    """Steps 0, around the warmup boundary (3), the end of the cosine and
    past ``total_steps``: bit for bit against the reference op by op,
    within one ulp of the peak lr under ``jax.jit``."""
    make, peak = SCHEDULES[name]
    jf, tf = make(joptim), make(toptim)
    for step in (0, 1, 2, 3, 4, 6, 7, 9, 10, 11, 25):
        want = np.float32(jf(jnp.asarray(step, jnp.int32)))
        for s in (step, torch.tensor(step)):
            got = tf(s)
            assert got.dtype == torch.float32 and got.dim() == 0
            assert got.numpy() == want, (name, step, float(got), float(want))
        jitted = np.float32(jax.jit(jf)(jnp.asarray(step, jnp.int32)))
        assert abs(float(tf(step)) - float(jitted)) <= np.spacing(np.float32(peak)), step
