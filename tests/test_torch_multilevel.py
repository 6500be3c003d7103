"""The port's multilevel backend (Appendix E, Algorithm 2) against the JAX
package, on the CPU.

The same numpy-seeded inputs go through ``repro.core.multilevel`` (or
``repro.api``'s ``MultiLevelEngine``) and ``repro_torch.core.multilevel``
(``repro_torch.api``'s). Under partial participation the reference's
masks -- its key schedule ``split(state.rng)`` -> ``split(mkey, M)`` ->
``sample_axis_mask(keys[m], dims[:m+1], p_m, mode)`` -- are handed to the
port's round as ``draws``.

Tolerances: rtol 1e-5 / atol 1e-6 on the quadratic loss and the MLP (the
reference's own flat-against-tree bound, tests/test_flat_state.py); a
correction nu_m = (s - a) / (lr * P_m) turns one float32 ulp of the params
into 1 / (lr * P_m) ulps (XLA may also rewrite the division as a product
with the reciprocal, ROADMAP queue 3 item 2), so nu_m's atol is the
params' atol over ``lr * P_m``. Frozen subtrees are held bit for bit.
"""
import warnings

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro import api as japi  # noqa: E402
from repro.core import multilevel as jml  # noqa: E402
from repro.core import participation as jpart  # noqa: E402
from repro.core.packer import as_tree as jas_tree  # noqa: E402
from repro_torch import api as tapi  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import multilevel as tml  # noqa: E402
from repro_torch.core.driver import GuardSpec, PackedBatches, select_round  # noqa: E402
from repro_torch.core.engine import RoundDraws  # noqa: E402
from repro_torch.core.packer import as_tree  # noqa: E402
from repro_torch.core.participation import ParticipationMasks  # noqa: E402
from test_mtgc_engine import D, make_batches  # noqa: E402
from test_mtgc_engine import quad_loss as jquad  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6
LR = 0.05


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """One intra-op thread: the suite runs files in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tquad(params, batch):
    r = batch["a"] * params["w"] - batch["b"]
    return 0.5 * torch.sum(r * r)


def level_masks(rng, dims, participation, mode):
    """The reference round's masks from its pre-round key (numpy)."""
    mkey, _ = jax.random.split(rng)
    keys = jax.random.split(mkey, len(dims))
    return [np.array(jpart.sample_axis_mask(keys[m], dims[:m + 1], participation[m], mode))
            for m in range(len(dims))]


def quad_batches(dims, P1, seed):
    """[P_1, *dims, D] quadratic-loss batches that change every step."""
    rng = np.random.default_rng(seed)
    return {"a": (rng.normal(size=(P1,) + dims + (D,)) + 2.0).astype(np.float32),
            "b": rng.normal(size=(P1,) + dims + (D,)).astype(np.float32)}


def tbatches(b):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in b.items()}


def jbatches(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def assert_matches(tstate, jstate, periods, tag, rtol=RTOL, atol=ATOL):
    """params and every nu of a port state against a reference state."""
    tp, jp = as_tree(tstate.params), jas_tree(jstate.params)
    for k in jp:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=rtol, atol=atol,
                                   err_msg=f"{tag}: params/{k}")
    assert len(tstate.nus) == len(jstate.nus)
    for m, (tn, jn) in enumerate(zip(tstate.nus, jstate.nus)):
        tn, jn = as_tree(tn), jas_tree(jn)
        for k in jn:
            np.testing.assert_allclose(tn[k].numpy(), np.asarray(jn[k]), rtol=rtol,
                                       atol=atol / (LR * periods[m]),
                                       err_msg=f"{tag}: nus[{m}]/{k}")


def state_tensors(state):
    out = list(as_tree(state.params).values())
    for nu in state.nus:
        out += list(as_tree(nu).values())
    return out


def raw_tensors(state):
    """Every stored tensor (flat buffers as buffers, not unpacked views)."""
    from repro_torch.core.driver import _state_tensors

    return _state_tensors(state)


def same_bits(a, b) -> bool:
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


# ------------------------------------------------------------ two levels


@pytest.mark.parametrize("layout", ["tree", "flat"])
def test_two_level_equivalence(layout):
    """M = 2 with periods (E H, H) reproduces the two-level engine (JAX's)
    and JAX's multilevel round."""
    G, K, E, H = 2, 3, 2, 2
    _, _, batches = make_batches(G, K, E, H, seed=11)
    jspec = japi.ExperimentSpec(levels=(G, K), lr=LR,
                                schedule=japi.RoundSchedule(group_rounds=E, local_steps=H))
    jeng = japi.build(jspec, jquad)
    st2 = jeng.init({"w": jnp.zeros(D)})
    rf2 = jax.jit(jeng.round_fn)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        rfM = jax.jit(jml.make_multilevel_round(jquad, (G, K), (E * H, H), LR))
        trf = tml.make_multilevel_round(tquad, (G, K), (E * H, H), LR, device="cpu")
    stM = jml.multilevel_init({"w": jnp.zeros(D)}, (G, K))
    tst = tml.multilevel_init({"w": torch.zeros(D)}, (G, K), use_flat_state=layout == "flat",
                              device="cpu")
    mb = {k: v.reshape((E * H,) + v.shape[2:]) for k, v in batches.items()}
    for r in range(2):
        st2, _ = rf2(st2, jbatches(batches))
        stM, _ = rfM(stM, jbatches(mb))
        tst, _ = trf(tst, tbatches(mb))
        got = tml.multilevel_global_model(tst)["w"].numpy()
        np.testing.assert_allclose(got, np.asarray(jas_tree(st2.params)["w"])[0, 0],
                                   rtol=RTOL, atol=ATOL, err_msg=f"round {r}: two-level")
        assert_matches(tst, stM, (E * H, H), f"round {r}: multilevel")


@pytest.mark.parametrize("weighting", ["none", "inverse_prob"])
def test_two_level_partial_matches_simulator_engine(weighting):
    """M = 2 under uniform partial participation equals the port's own
    simulator engine given the same masks (group mask, then the client mask
    gated by its group): params replica for replica, nu_1 = y."""
    G, K, E, H = 2, 3, 2, 2
    _, _, batches = make_batches(G, K, E, H, seed=17)
    kw = dict(levels=(G, K), lr=LR, participation_mode="uniform",
              participation_weighting=weighting, state_layout="tree")
    sim = tapi.build(tapi.ExperimentSpec(
        schedule=tapi.RoundSchedule(group_rounds=E, local_steps=H),
        client_participation=0.5, group_participation=0.75, **kw), tquad, device="cpu")
    ml = tapi.build(tapi.ExperimentSpec(
        backend="multilevel", schedule=tapi.RoundSchedule(periods=(E * H, H)),
        level_participation=(0.75, 0.5), **kw), tquad, device="cpu")
    s_sim, s_ml = sim.init({"w": torch.zeros(D)}), ml.init({"w": torch.zeros(D)})
    key = jax.random.PRNGKey(13)
    tb = tbatches(batches)
    for r in range(3):
        gm, cm = level_masks(key, (G, K), (0.75, 0.5), "uniform")
        key = jax.random.split(key)[1]
        masks = ParticipationMasks(torch.tensor(gm), torch.tensor(cm * gm[:, None]))
        s_sim, _ = sim.round_fn(s_sim, tb, draws=RoundDraws(masks=masks))
        s_ml, _ = ml.round_fn(s_ml, tb, draws=[gm, cm])
        np.testing.assert_allclose(s_ml.params["w"].numpy(), s_sim.params["w"].numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=f"round {r}: params")
        np.testing.assert_allclose(s_ml.nus[0]["w"].numpy(), s_sim.y["w"].numpy(),
                                   rtol=RTOL, atol=ATOL / (LR * E * H),
                                   err_msg=f"round {r}: nu_1 = y")


# ---------------------------------------------------- three and four levels


DEEP = [((2, 2, 3), (12, 4, 2)), ((2, 2, 2, 2), (8, 4, 2, 1))]


@pytest.mark.parametrize("layout", ["tree", "flat"])
@pytest.mark.parametrize("dims,periods", DEEP, ids=["3-level", "4-level"])
def test_rounds_match_reference(dims, periods, layout):
    """3 rounds of the port's round against JAX's ``make_multilevel_round``:
    params, every nu and the losses after each round."""
    b = quad_batches(dims, periods[0], seed=65)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        jrf = jax.jit(jml.make_multilevel_round(jquad, dims, periods, LR))
        trf = tml.make_multilevel_round(tquad, dims, periods, LR, device="cpu")
    flat = layout == "flat"
    jst = jml.multilevel_init({"w": jnp.zeros(D)}, dims, use_flat_state=flat)
    tst = tml.multilevel_init({"w": torch.zeros(D)}, dims, use_flat_state=flat, device="cpu")
    for r in range(3):
        jst, jl = jrf(jst, jbatches(b))
        tst, tl = trf(tst, tbatches(b))
        assert tuple(tl.shape) == (periods[0],)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=RTOL, atol=ATOL,
                                   err_msg=f"round {r}: losses")
        assert_matches(tst, jst, periods, f"round {r}")
    assert all(t.is_contiguous() for t in raw_tensors(tst))


@pytest.mark.parametrize("dims,periods", DEEP, ids=["3-level", "4-level"])
def test_flat_matches_tree(dims, periods):
    """The two layouts of the port agree at the reference's own bound
    (rtol 1e-5, atol 1e-6): the flat round adds one nu-sum a block, the
    tree round each nu every step."""
    b = tbatches(quad_batches(dims, periods[0], seed=66))
    rf = tml._build_multilevel_round(tquad, dims, periods, LR)
    st = {lay: tml.multilevel_init({"w": torch.zeros(D)}, dims, use_flat_state=lay == "flat",
                                   device="cpu") for lay in ("tree", "flat")}
    for _ in range(3):
        st = {lay: rf(s, b)[0] for lay, s in st.items()}
    for a, c in zip(state_tensors(st["flat"]), state_tensors(st["tree"])):
        np.testing.assert_allclose(a.numpy(), c.numpy(), rtol=RTOL, atol=ATOL / (LR * periods[-1]))


def test_three_level_invariants_and_convergence():
    """The analogue of tests/test_multilevel.py's: 50 rounds on a 2 x 2 x 2
    tree; each level's corrections sum to zero over its siblings and the
    global model reaches the global optimum."""
    dims, periods = (2, 2, 2), (8, 4, 2)
    rng = np.random.default_rng(12)
    a = rng.normal(size=dims + (D,)).astype(np.float32) + 2.0
    b = rng.normal(size=dims + (D,)).astype(np.float32)
    xstar = (a * b).sum((0, 1, 2)) / (a * a).sum((0, 1, 2))
    batches = {"a": torch.from_numpy(np.broadcast_to(a, (8,) + a.shape).copy()),
               "b": torch.from_numpy(np.broadcast_to(b, (8,) + b.shape).copy())}
    rf = tml._build_multilevel_round(tquad, dims, periods, LR)
    st = tml.multilevel_init({"w": torch.zeros(D)}, dims, device="cpu")
    for _ in range(50):
        st, _ = rf(st, batches)
    for m, nu in enumerate(st.nus):
        np.testing.assert_allclose(nu["w"].numpy().sum(axis=m), 0.0, atol=1e-3)
    x = tml.multilevel_global_model(st)["w"].numpy()
    assert np.linalg.norm(x - xstar) < 3e-2, np.linalg.norm(x - xstar)


# ------------------------------------------------------------ participation


PART = (0.5, 0.75, 0.5)


@pytest.mark.parametrize("layout", ["tree", "flat"])
@pytest.mark.parametrize("mode", ["uniform", "fixed"])
@pytest.mark.parametrize("weighting", ["none", "inverse_prob"])
def test_partial_matches_reference(weighting, mode, layout):
    """3 partial-participation rounds against the reference's engine with
    its masks injected: params, nus, losses; every leaf outside the round's
    active chains keeps its params bits, every node without an active leaf
    its nu bits."""
    dims, periods = (2, 2, 3), (12, 4, 2)
    M = len(dims)
    b = quad_batches(dims, periods[0], seed=67)
    kw = dict(levels=dims, backend="multilevel", lr=LR, state_layout=layout,
              level_participation=PART, participation_mode=mode,
              participation_weighting=weighting)
    jeng = japi.build(japi.ExperimentSpec(schedule=japi.RoundSchedule(periods=periods), **kw),
                      jquad)
    teng = tapi.build(tapi.ExperimentSpec(schedule=tapi.RoundSchedule(periods=periods), **kw),
                      tquad, device="cpu")
    jrf = jax.jit(jeng.legacy_round_fn)
    jst = jeng.init({"w": jnp.zeros(D)}, jax.random.PRNGKey(3))
    tst = teng.init({"w": torch.zeros(D)})
    frozen_seen = False
    for r in range(3):
        masks = level_masks(jst.rng, dims, PART, mode)
        before = tst
        jst, jl = jrf(jst, jbatches(b))
        tst, tl = teng.legacy_round_fn(tst, tbatches(b), draws=masks)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=RTOL, atol=ATOL,
                                   err_msg=f"round {r}: losses")
        assert_matches(tst, jst, periods, f"round {r}")
        # Frozen subtrees: a leaf's activity is its chain's product; a
        # level-m node is active iff some leaf under it is.
        leaf = masks[0]
        for m in range(1, M):
            leaf = leaf[..., None] * masks[m]
        x0, x1 = as_tree(before.params)["w"], as_tree(tst.params)["w"]
        off = torch.from_numpy(leaf == 0)
        assert same_bits(x0[off], x1[off]), f"round {r}: a frozen leaf's params changed"
        for m in range(M):
            act = leaf.reshape(dims[:m + 1] + (-1,)).max(axis=-1)
            off = torch.from_numpy(act == 0)
            n0, n1 = as_tree(before.nus[m])["w"], as_tree(tst.nus[m])["w"]
            assert same_bits(n0[off], n1[off]), f"round {r}: a frozen nus[{m}] changed"
            frozen_seen |= bool(off.any())
        assert all(t.is_contiguous() for t in raw_tensors(tst))
    assert frozen_seen


@pytest.mark.parametrize("layout", ["tree", "flat"])
def test_all_ones_participation_is_full(layout):
    """``participation=None`` and all-ones fractions give the same bits."""
    dims, periods = (2, 2, 3), (8, 4, 2)
    b = tbatches(quad_batches(dims, periods[0], seed=68))
    outs = []
    for part in (None, (1.0, 1.0, 1.0)):
        rf = tml._build_multilevel_round(tquad, dims, periods, LR, participation=part)
        st = tml.multilevel_init({"w": torch.zeros(D)}, dims, use_flat_state=layout == "flat",
                                 device="cpu")
        for _ in range(2):
            st, losses = rf(st, b)
        outs.append(state_tensors(st) + [losses])
    assert all(same_bits(a, c) for a, c in zip(*outs))


def test_generator_draws_masks_when_none_are_given():
    """Without ``draws`` the round draws one ``sample_axis_mask`` a level,
    outermost first, from ``state.rng`` (which advances in place)."""
    from repro_torch.core.participation import sample_axis_mask

    dims, periods = (2, 2, 3), (8, 4, 2)
    b = tbatches(quad_batches(dims, periods[0], seed=69))
    rf = tml._build_multilevel_round(tquad, dims, periods, LR, participation=PART,
                                     participation_mode="fixed")
    st = tml.multilevel_init({"w": torch.zeros(D)}, dims, torch.Generator().manual_seed(5),
                             device="cpu")
    gen = torch.Generator().manual_seed(5)
    masks = [sample_axis_mask(gen, dims[:m + 1], PART[m], "fixed") for m in range(3)]
    a, _ = rf(st, b, draws=masks)
    st2 = tml.multilevel_init({"w": torch.zeros(D)}, dims, torch.Generator().manual_seed(5),
                              device="cpu")
    c, _ = rf(st2, b)
    assert all(same_bits(x, y) for x, y in zip(state_tensors(a), state_tensors(c)))
    assert torch.equal(st2.rng.get_state(), gen.get_state())
    with pytest.raises(ValueError, match="one mask per level"):
        rf(st, b, draws=masks[:2])


# -------------------------------------------------------------- front door


def depth3_pools(dims, n, seed=0):
    rng = np.random.default_rng(seed)
    X = {"a": (rng.normal(size=(n, D)) + 2.0).astype(np.float32),
         "b": rng.normal(size=(n, D)).astype(np.float32)}
    per = n // int(np.prod(dims))
    idx = [[[np.arange(((i * dims[1] + j) * dims[2] + k) * per,
                       ((i * dims[1] + j) * dims[2] + k + 1) * per)
             for k in range(dims[2])] for j in range(dims[1])] for i in range(dims[0])]
    return X, idx


def reference_shard_ids(key, T, E, dims, S):
    """[T, E, *dims] shard ids as the reference driver draws them."""
    out = []
    for _ in range(T):
        sub, key = jax.random.split(key)
        out.append(np.asarray(jax.random.randint(sub, (E,) + dims, 0, S)))
    return np.stack(out)


def test_pack_arrays_depth3_matches_reference():
    """``pack_arrays`` on depth-3 pools equals the reference's packing array
    for array, and ``select_round`` gathers the same batches from the same
    ``[E, *dims]`` ids."""
    dims, periods = (2, 2, 3), (8, 4, 2)
    X, idx = depth3_pools(dims, 12 * 40)
    kw = dict(levels=dims, backend="multilevel", lr=LR)
    jeng = japi.build(japi.ExperimentSpec(schedule=japi.RoundSchedule(periods=periods), **kw),
                      jquad)
    teng = tapi.build(tapi.ExperimentSpec(schedule=tapi.RoundSchedule(periods=periods), **kw),
                      tquad, device="cpu")
    jdata = jeng.pack_arrays(X, idx, batch_size=4, shards=3, rng=np.random.default_rng(1),
                             key=jax.random.PRNGKey(1))
    tdata = teng.pack_arrays(X, idx, batch_size=4, shards=3, rng=np.random.default_rng(1))
    assert tdata.topo_ndim == 3 and tdata.topology == dims and tdata.num_shards == 3
    for k in X:
        np.testing.assert_array_equal(tdata.arrays[k].numpy(), np.asarray(jdata.arrays[k]))
    from repro.core.driver import select_round as jselect

    key = jax.random.PRNGKey(9)
    sid = np.array(jax.random.randint(key, (4,) + dims, 0, 3))
    jb, tb = jselect(jdata, key), select_round(tdata, torch.from_numpy(sid))
    for k in X:
        assert tuple(tb[k].shape) == (4, 2) + dims + (4, D)
        np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))
    with pytest.raises(ValueError, match="does not match levels"):
        teng.pack_arrays(X, idx[0], batch_size=4, rng=np.random.default_rng(1))
    with pytest.raises(ValueError, match="token packing is two-level"):
        teng.pack_tokens(np.arange(100), batch_size=1, seq_len=8, rng=np.random.default_rng(1))


def test_two_level_packing_and_draws_unchanged():
    """At depth 2 the recursive packing is the row-major ``[G][K]`` packing
    draw for draw, and the ``[E, G, K]`` shard ids are the ``(E, G * K)``
    stream."""
    from repro_torch.core.driver import draw_shard_ids, pack_client_shards

    G, K, S, steps, B = 2, 3, 4, 2, 5
    X, _ = depth3_pools((1, G, K), G * K * 20)
    idx = [[np.arange((g * K + k) * 20, (g * K + k + 1) * 20) for k in range(K)]
           for g in range(G)]
    data = pack_client_shards(X, idx, group_rounds=3, local_steps=steps, batch_size=B,
                              shards=S, rng=np.random.default_rng(4),
                              generator=torch.Generator().manual_seed(6), device="cpu")
    rng = np.random.default_rng(4)
    sel = np.stack([np.stack([rng.choice(pool, size=(S, steps, B), replace=True)
                              for pool in group]) for group in idx])
    assert data.topo_ndim == 2 and data.topology == (G, K)
    for k in X:
        np.testing.assert_array_equal(data.arrays[k].numpy(), X[k][sel])
    want = torch.randint(0, S, (3, G * K), generator=torch.Generator().manual_seed(6))
    assert torch.equal(draw_shard_ids(data), want.reshape(3, G, K))


@pytest.mark.parametrize("layout", ["tree", "flat"])
def test_fit_matches_reference(layout):
    """``fit`` for 3 rounds on packed depth-3 data, the reference's shard ids
    injected, equals the reference's ``fit``: state and losses."""
    dims, periods = (2, 2, 3), (8, 4, 2)
    X, idx = depth3_pools(dims, 12 * 40, seed=1)
    kw = dict(levels=dims, backend="multilevel", lr=LR, state_layout=layout)
    jeng = japi.build(japi.ExperimentSpec(schedule=japi.RoundSchedule(periods=periods), **kw),
                      jquad)
    teng = tapi.build(tapi.ExperimentSpec(schedule=tapi.RoundSchedule(periods=periods), **kw),
                      tquad, device="cpu")
    jdata = jeng.pack_arrays(X, idx, batch_size=4, shards=3, rng=np.random.default_rng(2),
                             key=jax.random.PRNGKey(4))
    tdata = teng.pack_arrays(X, idx, batch_size=4, shards=3, rng=np.random.default_rng(2))
    jst, jhz = japi.fit(jeng, jdata, 3, params={"w": jnp.zeros(D)}, donate=False)
    sid = reference_shard_ids(jax.random.PRNGKey(4), 3, 4, dims, 3)
    tst, thz = tapi.fit(teng, tdata, 3, params={"w": torch.zeros(D)}, shard_ids=sid)
    assert thz.metrics.loss.shape == (3, periods[0])
    np.testing.assert_allclose(thz.metrics.loss, np.asarray(jhz.metrics.loss), rtol=RTOL,
                               atol=ATOL)
    assert_matches(tst, jst, periods, layout)
    np.testing.assert_allclose(teng.global_model(tst)["w"].numpy(),
                               np.asarray(jeng.global_model(jst)["w"]), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("layout", ["tree", "flat"])
def test_three_level_fit_runs_and_preserves_invariants(layout):
    """The analogue of tests/test_api_conformance.py's: hand-made depth-3
    packed data through ``build`` -> ``fit``; nu_1 sums to zero over the
    groups."""
    dims, periods = (2, 2, 2), (4, 2, 1)
    engine = tapi.build(tapi.ExperimentSpec(levels=dims, backend="multilevel", lr=LR,
                                            schedule=tapi.RoundSchedule(periods=periods),
                                            state_layout=layout), tquad, device="cpu")
    rng = np.random.default_rng(3)
    shape = dims + (3, periods[-1], D)
    data = PackedBatches(
        {"a": torch.from_numpy((rng.normal(size=shape) + 2.0).astype(np.float32)),
         "b": torch.from_numpy(rng.normal(size=shape).astype(np.float32))},
        torch.Generator().manual_seed(1), periods[0] // periods[-1], periods[-1], None,
        topo_ndim=3)
    state, hz = tapi.fit(engine, data, 3, params={"w": torch.zeros(D)})
    assert hz.metrics.loss.shape == (3, periods[0]) and np.isfinite(hz.metrics.loss).all()
    np.testing.assert_allclose(as_tree(state.nus[0])["w"].numpy().sum(axis=0), 0.0, atol=1e-5)


def test_three_level_example_tracks_reference():
    """``examples/three_level.py``'s run at its own size (the MLP, 6000
    samples, (2, 2, 3) with periods (8, 4, 2), batch 32, 8 shards) for 3
    rounds: the port's losses, accuracy and global model against the
    reference's, the reference's shard ids injected."""
    from repro.data.partition import partition as jpartition
    from repro.data.synthetic import make_classification, train_test_split
    from repro.models import small as jsmall
    from repro_torch.models import small as tsmall

    dims, periods, rounds = (2, 2, 3), (8, 4, 2), 3
    rng = np.random.default_rng(0)
    ds = make_classification(rng, num_samples=6000, num_classes=10, dim=32)
    train, test = train_test_split(ds, rng)
    flat_idx = jpartition(train.y, dims[0], dims[1] * dims[2], mode="both_noniid", alpha=0.1,
                          seed=0)
    idx = [[[flat_idx[k1][k2 * dims[2] + k3] for k3 in range(dims[2])]
            for k2 in range(dims[1])] for k1 in range(dims[0])]
    jinit, japply = jsmall.mlp(10, 32, hidden=64)
    _, tapply = tsmall.mlp(10, 32, hidden=64)
    kw = dict(levels=dims, backend="multilevel", lr=0.1)
    jeng = japi.build(japi.ExperimentSpec(schedule=japi.RoundSchedule(periods=periods), **kw),
                      jsmall.make_loss(japply))
    teng = tapi.build(tapi.ExperimentSpec(schedule=tapi.RoundSchedule(periods=periods), **kw),
                      tsmall.make_loss(tapply), device="cpu")
    arrays = {"x": train.x, "y": train.y}
    jdata = jeng.pack_arrays(arrays, idx, batch_size=32, shards=8, rng=np.random.default_rng(1),
                             key=jax.random.PRNGKey(1))
    tdata = teng.pack_arrays(arrays, idx, batch_size=32, shards=8, rng=np.random.default_rng(1))
    jacc = jsmall.jit_accuracy(japply, jnp.asarray(test.x), jnp.asarray(test.y))
    tacc = tsmall.make_accuracy(tapply, torch.from_numpy(test.x), torch.from_numpy(test.y))
    p0 = jinit(jax.random.PRNGKey(0))
    jst, jhz = japi.fit(jeng, jdata, rounds, params=p0,
                        eval_fn=lambda prev, st: {"acc": jacc(jeng.global_model(st))})
    sid = reference_shard_ids(jax.random.PRNGKey(1), rounds, 4, dims, 8)
    tst, thz = tapi.fit(teng, tdata, rounds,
                        params=convert.params_from_numpy(jax.tree.map(np.asarray, p0), "cpu"),
                        shard_ids=sid,
                        eval_fn=lambda prev, st: {"acc": tacc(teng.global_model(st))})
    np.testing.assert_allclose(thz.metrics.loss, np.asarray(jhz.metrics.loss), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(thz.evals["acc"], np.asarray(jhz.evals["acc"]), atol=1.5 / 1200)
    want = jax.tree.map(np.asarray, jeng.global_model(jst))
    got = convert.to_numpy(teng.global_model(tst))
    for name in want:
        for leaf in want[name]:
            np.testing.assert_allclose(got[name][leaf], want[name][leaf], rtol=RTOL, atol=ATOL,
                                       err_msg=f"{name}/{leaf}")


# --------------------------------------------------------- shim and guard


def test_shim_warns_and_keeps_the_legacy_contract():
    """``make_multilevel_round`` warns, and its round takes ``[P_1, *dims,
    ...]`` batches: the engine's ``[E, H, *dims, ...]`` round on the same
    batches gives the same bits."""
    dims, periods = (2, 2, 3), (8, 4, 2)
    with pytest.warns(DeprecationWarning, match="make_multilevel_round is deprecated"):
        rf = tml.make_multilevel_round(tquad, dims, periods, LR, device="cpu")
    from repro_torch.core import make_multilevel_round, multilevel_global_model, multilevel_init

    assert make_multilevel_round is tml.make_multilevel_round
    assert (multilevel_init, multilevel_global_model) == (tml.multilevel_init,
                                                          tml.multilevel_global_model)
    b = tbatches(quad_batches(dims, periods[0], seed=70))
    st = tml.multilevel_init({"w": torch.zeros(D)}, dims, device="cpu")
    a, losses = rf(st, b)
    assert tuple(losses.shape) == (periods[0],)
    engine = tapi.build(tapi.ExperimentSpec(levels=dims, backend="multilevel", lr=LR,
                                            schedule=tapi.RoundSchedule(periods=periods),
                                            state_layout="tree"), tquad, device="cpu")
    c, met = engine.round_fn(st, {k: v.reshape((4, 2) + tuple(v.shape[1:]))
                                  for k, v in b.items()})
    assert met._fields == ("loss",) and torch.equal(met.loss, losses)
    assert all(same_bits(x, y) for x, y in zip(state_tensors(a), state_tensors(c)))


@pytest.mark.parametrize("layout", ["tree", "flat"])
@pytest.mark.parametrize("participation", [None, PART], ids=["full", "partial"])
def test_guarded_fit_restores_into_the_round_state(layout, participation):
    """A guarded multilevel ``fit`` whose first chunk diverges restores the
    snapshot into the state the round returned (every tensor of it
    materialized, so ``copy_`` into it works) and retries: the result is
    the unguarded run's, bit for bit."""
    dims, periods = (2, 2, 3), (8, 4, 2)
    X, idx = depth3_pools(dims, 12 * 40, seed=5)
    spec = tapi.ExperimentSpec(levels=dims, backend="multilevel", lr=LR, state_layout=layout,
                               schedule=tapi.RoundSchedule(periods=periods),
                               level_participation=participation)
    engine = tapi.build(spec, tquad, device="cpu")

    def data():
        return engine.pack_arrays(X, idx, batch_size=4, shards=3, rng=np.random.default_rng(2))

    sid = torch.randint(0, 3, (4, 4) + dims, generator=torch.Generator().manual_seed(8))
    masks = [[np.ones(dims[:m + 1], np.float32) for m in range(3)] for _ in range(4)]
    if participation is not None:
        rs = np.random.default_rng(9)
        masks = [[(rs.random(dims[:m + 1]) < PART[m]).astype(np.float32) for m in range(3)]
                 for _ in range(4)]
    draws = masks if participation is not None else None
    want, _ = tapi.fit(engine, data(), 4, params={"w": torch.zeros(D)}, chunk=2,
                       shard_ids=sid, draws=draws)
    good, calls = engine.round_fn, []

    def diverging(state, batches, draws=None):
        state, met = good(state, batches, draws=draws)
        calls.append(1)
        if len(calls) == 1:
            assert all(t.is_contiguous() for t in raw_tensors(state))
            met = met._replace(loss=met.loss * float("nan"))
        return state, met

    engine.round_fn = diverging
    got, hz = tapi.fit(engine, data(), 4, params={"w": torch.zeros(D)}, chunk=2,
                       shard_ids=sid, draws=draws,
                       guard=GuardSpec(round_fn_for_retry=lambda attempt: good))
    # Chunk 1 (rounds 1-2) diverges, its retry runs ``good``; chunk 2 is clean.
    assert hz.guard.rollbacks == 1 and hz.guard.retries == 1 and len(calls) == 4
    assert all(same_bits(x, y) for x, y in zip(state_tensors(got), state_tensors(want)))


def test_guard_checks_every_correction():
    """The guard's state check covers every nu level of a multilevel state
    (and the z/y/dyn fields of the two-level states)."""
    from repro_torch.core.config import HFLConfig
    from repro_torch.core.driver import _guard_leaves
    from repro_torch.core.engine import hfl_init

    st = tml.multilevel_init({"w": torch.zeros(D), "v": torch.zeros(2)}, (2, 2, 3),
                             device="cpu")
    assert len(_guard_leaves(st)) == 2 + 3 * 2
    assert len(_guard_leaves(hfl_init({"w": torch.zeros(D)}, HFLConfig(), device="cpu"))) == 3


@pytest.mark.parametrize("participation", [None, (1.0, 0.8, 0.6)], ids=["full", "partial-ht"])
def test_cnn_rounds_match_reference(participation):
    """The CNN (8x8x1) on a 2 x 2 x 3 tree, periods (4, 2, 1), tree layout:
    2 rounds against the reference's engine at rtol 1e-4 (the convolutions
    sum in another order, ROADMAP queue 3 item 1), uniform masks injected
    under Horvitz-Thompson weighting."""
    from repro.models import small as jsmall
    from repro_torch.models import small as tsmall

    dims, periods = (2, 2, 3), (4, 2, 1)
    jinit, japply = jsmall.cnn(10, (8, 8, 1))
    _, tapply = tsmall.cnn(10, (8, 8, 1))
    p0 = jinit(jax.random.PRNGKey(0))
    kw = dict(levels=dims, backend="multilevel", lr=LR, state_layout="tree",
              level_participation=participation, participation_weighting="inverse_prob")
    jeng = japi.build(japi.ExperimentSpec(schedule=japi.RoundSchedule(periods=periods), **kw),
                      jsmall.make_loss(japply))
    teng = tapi.build(tapi.ExperimentSpec(schedule=tapi.RoundSchedule(periods=periods), **kw),
                      tsmall.make_loss(tapply), device="cpu")
    rng = np.random.default_rng(7)
    b = {"x": rng.normal(size=(periods[0],) + dims + (4, 8, 8, 1)).astype(np.float32),
         "y": rng.integers(0, 10, size=(periods[0],) + dims + (4,)).astype(np.int32)}
    jst = jeng.init(p0, jax.random.PRNGKey(2))
    tst = teng.init(convert.params_from_numpy(jax.tree.map(np.asarray, p0), "cpu"))
    jrf = jax.jit(jeng.legacy_round_fn)
    for r in range(2):
        masks = (None if participation is None
                 else level_masks(jst.rng, dims, participation, "uniform"))
        jst, jl = jrf(jst, jbatches(b))
        tst, tl = teng.legacy_round_fn(tst, tbatches(b), draws=masks)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=ATOL,
                                   err_msg=f"round {r}: losses")
        pairs = [(convert.to_numpy(tst.params), jax.tree.map(np.asarray, jst.params), ATOL)]
        pairs += [(convert.to_numpy(tn), jax.tree.map(np.asarray, jn), ATOL / (LR * periods[m]))
                  for m, (tn, jn) in enumerate(zip(tst.nus, jst.nus))]
        for i, (got, want, atol) in enumerate(pairs):
            for name in want:
                for leaf in want[name]:
                    np.testing.assert_allclose(got[name][leaf], want[name][leaf], rtol=1e-4,
                                               atol=atol, err_msg=f"round {r}: {i} {name}/{leaf}")
