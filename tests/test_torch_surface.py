"""The port's low-level surface against the reference's, on the CPU:
``make_global_round``, ``make_round_step``, ``sample_round_batches``,
``partition_stats``, ``accuracy``, ``Engine.participation_masks`` and the
names ``repro.core`` and ``repro.data`` export.

Rounds run the quadratic problem of ``tests/test_mtgc_engine.py``
(``0.5 * ||a * w - b||^2`` with per-client (a, b)) for 3 rounds at the
reference's parity bound, rtol 1e-5 / atol 1e-6; z and y are difference
quotients of the params (z = (x_H - xbar) / (H lr), y = (xbar_j - xbar) /
(H E lr)), so their atol is the params' carried through the same quotient
(ROADMAP queue 3 item 2). Shard ids come from the reference's key
schedule (``key, rng = split(rng)``, then ``randint(key, (E, G, K), 0,
S)``), as ``tests/test_torch_driver.py`` computes them.
"""
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import repro.core as jcore  # noqa: E402
import repro.data as jdata  # noqa: E402
from repro import api as japi  # noqa: E402
from repro.core.driver import PackedBatches as JPacked  # noqa: E402
from repro.models import small as jsmall  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
import repro_torch.data as tdata  # noqa: E402
from repro_torch import api as tapi  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core.driver import PackedBatches as TPacked  # noqa: E402
from repro_torch.core.participation import round_masks  # noqa: E402
from repro_torch.launch.train import ShardedHFLState  # noqa: E402
from repro_torch.models import small as tsmall  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """One intra-op thread: the suite runs files in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


D = 6
G, K, E, H, LR = 2, 3, 2, 2, 0.05
RTOL, ATOL = 1e-5, 1e-6
ALGOS = ("mtgc", "hfedavg", "local_corr", "group_corr", "fedprox", "feddyn")


def jquad(params, batch):
    r = batch["a"] * params["w"] - batch["b"]
    return 0.5 * jnp.sum(r * r)


def tquad(params, batch):
    r = batch["a"] * params["w"] - batch["b"]
    return 0.5 * torch.sum(r * r)


def _quad_batches(seed=0, G=G, K=K, E=E, H=H):
    """Per-client (a, b), constant over steps: ``[E, H, G, K, D]``."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(G, K, D)).astype(np.float32) + 2.0
    b = rng.normal(size=(G, K, D)).astype(np.float32)
    return {"a": np.broadcast_to(a, (E, H, G, K, D)).copy(),
            "b": np.broadcast_to(b, (E, H, G, K, D)).copy()}


def _cfgs(algo, flat, **kw):
    kw = dict(num_groups=G, clients_per_group=K, local_steps=H, group_rounds=E, lr=LR,
              algorithm=algo, use_flat_state=flat,
              prox_mu=0.1 if algo == "fedprox" else 0.0,
              feddyn_alpha=0.1 if algo == "feddyn" else 0.0, **kw)
    return jcore.HFLConfig(**kw), tcore.HFLConfig(**kw)


def _assert_states(tstate, jstate, tag, fields=("params", "z", "y", "dyn")):
    atol = {"z": ATOL / (H * LR), "y": ATOL / (H * E * LR)}
    for f in fields:
        want = np.asarray(jcore.as_tree(getattr(jstate, f))["w"])
        got = tcore.as_tree(getattr(tstate, f))["w"].numpy()
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=atol.get(f, ATOL),
                                   err_msg=f"{tag}.{f}")


def _assert_same_state(a, b, tag):
    for f in ("params", "z", "y", "dyn", "round"):
        x, y = getattr(a, f), getattr(b, f)
        x = tcore.as_tree(x)["w"] if f != "round" else x
        y = tcore.as_tree(y)["w"] if f != "round" else y
        assert torch.equal(x, y), f"{tag}.{f}"


# ------------------------------------------------------- make_global_round


@pytest.mark.parametrize("flat", [True, False], ids=["flat", "tree"])
@pytest.mark.parametrize("algo", ALGOS)
def test_make_global_round_matches_reference(algo, flat):
    jcfg, tcfg = _cfgs(algo, flat)
    with pytest.warns(DeprecationWarning, match="make_global_round is deprecated") as jw:
        jrf = jax.jit(jcore.make_global_round(jquad, jcfg))
    with pytest.warns(DeprecationWarning, match="make_global_round is deprecated") as tw:
        trf = tcore.make_global_round(tquad, tcfg, device="cpu")
    # The same text, the package's own front door named in it.
    assert (str(tw[0].message).replace("repro_torch.api", "repro.api")
            == str(jw[0].message))
    js = jcore.hfl_init({"w": jnp.zeros(D)}, jcfg)
    ts = tcore.hfl_init({"w": torch.zeros(D)}, tcfg, device="cpu")
    assert tcore.is_flat(ts.params) == flat
    for r in range(3):
        b = _quad_batches(seed=r)
        js, jm = jrf(js, jax.tree.map(jnp.asarray, b))
        ts, tm = trf(ts, {k: torch.from_numpy(v) for k, v in b.items()})
        _assert_states(ts, js, f"round{r + 1}")
        for f in jm._fields:
            np.testing.assert_allclose(np.asarray(getattr(tm, f)), np.asarray(getattr(jm, f)),
                                       rtol=RTOL, atol=ATOL, err_msg=f"round{r + 1}.{f}")


def test_make_global_round_fused_launches_the_update(monkeypatch):
    """flat + fused: one ``mtgc_update_flat`` call a local step; tree +
    fused: one ``mtgc_update`` call a leaf a step (their plain versions on
    CPU tensors)."""
    from repro_torch.kernels import ops

    calls = {"flat": 0, "leaf": 0}
    flat_fn, leaf_fn = ops.mtgc_update_flat, ops.mtgc_update

    def count(name, fn):
        def spy(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return spy

    monkeypatch.setattr(ops, "mtgc_update_flat", count("flat", flat_fn))
    monkeypatch.setattr(ops, "mtgc_update", count("leaf", leaf_fn))
    b = {k: torch.from_numpy(v) for k, v in _quad_batches().items()}
    p0 = {"w": torch.zeros(D), "v": torch.zeros(2, 2)}
    b = dict(b, c=torch.ones(E, H, G, K, 2, 2))
    for flat in (True, False):
        cfg = tcore.HFLConfig(num_groups=G, clients_per_group=K, local_steps=H,
                              group_rounds=E, lr=LR, use_fused_update=True,
                              use_flat_state=flat)
        with pytest.warns(DeprecationWarning):
            rf = tcore.make_global_round(lambda p, bt: tquad(p, bt) + torch.sum(bt["c"] * p["v"]),
                                         cfg, device="cpu")
        calls.update(flat=0, leaf=0)
        rf(tcore.hfl_init(p0, cfg, device="cpu"), b)
        assert calls == ({"flat": E * H, "leaf": 0} if flat else {"flat": 0, "leaf": E * H * 2})


# -------------------------------------------------------- make_round_step


def _packed(S=4, seed=0):
    """Packed quadratic data ``[G, K, S, H, D]`` for both drivers."""
    rng = np.random.default_rng(seed)
    arrays = {"a": rng.normal(size=(G, K, S, H, D)).astype(np.float32) + 2.0,
              "b": rng.normal(size=(G, K, S, H, D)).astype(np.float32)}
    jd = JPacked({k: jnp.asarray(v) for k, v in arrays.items()}, jax.random.PRNGKey(1), E, H)
    td = TPacked({k: torch.from_numpy(v) for k, v in arrays.items()},
                 torch.Generator().manual_seed(1), E, H)
    return jd, td


def _reference_ids(key, T, S):
    out = []
    for _ in range(T):
        sub, key = jax.random.split(key)
        out.append(np.asarray(jax.random.randint(sub, (E, G, K), 0, S)))
    return np.stack(out)


@pytest.mark.parametrize("flat", [True, False], ids=["flat", "tree"])
def test_round_step_loop_equals_run_rounds(flat):
    """``make_round_step`` in a loop gives ``run_rounds``' states and
    metrics bit for bit, on the same shard ids; both draw their ids from
    the data's generator alike when none are given."""
    T = 3
    _, tcfg = _cfgs("mtgc", flat, client_participation=0.5)
    with pytest.warns(DeprecationWarning):
        rf = tcore.make_global_round(tquad, tcfg, device="cpu")
    _, td = _packed()
    sid = torch.randint(0, 4, (T, E, G, K), generator=torch.Generator().manual_seed(5))
    want, _, hz = tcore.run_rounds(rf, tcore.hfl_init({"w": torch.zeros(D)}, tcfg, device="cpu"),
                                   td, T, shard_ids=sid)
    step = tcore.make_round_step(rf)
    state = tcore.hfl_init({"w": torch.zeros(D)}, tcfg, device="cpu")
    for t in range(T):
        state, data, m = step(state, td, sid[t])
        assert data is td
        for f in m._fields:
            np.testing.assert_array_equal(getattr(m, f).numpy(), getattr(hz.metrics, f)[t],
                                          err_msg=f"round {t}: {f}")
    _assert_same_state(state, want, "step loop")
    assert torch.equal(state.rng.get_state(), want.rng.get_state())
    # Drawn ids: the same stream as run_rounds draws.
    _, d1 = _packed()
    _, d2 = _packed()
    s1, _, _ = tcore.run_rounds(rf, tcore.hfl_init({"w": torch.zeros(D)}, tcfg, device="cpu"),
                                d1, 2)
    s2 = tcore.hfl_init({"w": torch.zeros(D)}, tcfg, device="cpu")
    for _ in range(2):
        s2, _, _ = step(s2, d2)
    _assert_same_state(s2, s1, "drawn ids")


@pytest.mark.parametrize("donate", [True, False])
def test_round_step_matches_reference(donate):
    """The port's step loop against the reference's ``make_round_step``,
    with the reference's shard ids, at rtol 1e-5."""
    T, S = 3, 4
    jcfg, tcfg = _cfgs("mtgc", True)
    with pytest.warns(DeprecationWarning):
        jstep = jcore.make_round_step(jcore.make_global_round(jquad, jcfg), donate=donate)
        tstep = tcore.make_round_step(tcore.make_global_round(tquad, tcfg, device="cpu"),
                                      donate=donate)
    jd, td = _packed(S)
    js = jcore.hfl_init({"w": jnp.zeros(D)}, jcfg)
    ts = tcore.hfl_init({"w": torch.zeros(D)}, tcfg, device="cpu")
    sid = _reference_ids(jax.random.PRNGKey(1), T, S)
    for t in range(T):
        js, jd, jm = jstep(js, jd)
        ts, td, tm = tstep(ts, td, sid[t])
        _assert_states(ts, js, f"round{t + 1}")
        np.testing.assert_allclose(tm.loss.numpy(), np.asarray(jm.loss), rtol=RTOL, atol=ATOL)


def test_round_step_without_donation_keeps_its_input():
    """``donate=False``: the state passed in keeps its bits and its
    generator, so a second step from it repeats the first bit for bit
    (at participation 0.5 the round draws its masks from ``state.rng``)."""
    _, tcfg = _cfgs("mtgc", True, client_participation=0.5)
    with pytest.warns(DeprecationWarning):
        rf = tcore.make_global_round(tquad, tcfg, device="cpu")
    step = tcore.make_round_step(rf, donate=False)
    _, td = _packed()
    s0 = tcore.hfl_init({"w": torch.zeros(D)}, tcfg, device="cpu")
    s0, _, _ = step(s0, td)          # nonzero params and corrections
    x0 = s0.params.bufs["float32"].clone()
    g0 = s0.rng.get_state()
    sid = torch.randint(0, 4, (E, G, K), generator=torch.Generator().manual_seed(2))
    a, _, ma = step(s0, td, sid)
    b, _, mb = step(s0, td, sid)
    assert torch.equal(s0.params.bufs["float32"], x0) and torch.equal(s0.rng.get_state(), g0)
    _assert_same_state(a, b, "second step")
    assert torch.equal(ma.participation, mb.participation) and torch.equal(ma.loss, mb.loss)
    assert not torch.equal(a.params.bufs["float32"], x0)
    # With donation the state's generator is the round's own: it advances.
    c, _, _ = tcore.make_round_step(rf)(s0, td, sid)
    _assert_same_state(c, a, "donated step")
    assert not torch.equal(s0.rng.get_state(), g0)


def test_round_step_without_donation_copies_a_sharded_state():
    """The sharded backend writes its state in place; ``donate=False``
    copies it first, so the state passed in keeps its bits."""
    spec = tapi.ExperimentSpec(levels=(G, K), backend="sharded", lr=LR,
                               schedule=tapi.RoundSchedule(group_rounds=E, local_steps=H),
                               client_participation=0.5)
    eng = tapi.build(spec, tquad, device="cpu")
    rng = np.random.default_rng(3)
    arrays = {"a": torch.from_numpy(rng.normal(size=(G, K, 4, H, D)).astype(np.float32) + 2.0),
              "b": torch.from_numpy(rng.normal(size=(G, K, 4, H, D)).astype(np.float32))}
    td = TPacked(arrays, torch.Generator().manual_seed(1), E, H, microbatches=1)
    s0 = eng.init({"w": torch.zeros(D)})
    assert isinstance(s0, ShardedHFLState)
    s0, _, _ = tcore.make_round_step(eng.round_fn, donate=False)(s0, td)
    before = convert.to_numpy(s0)
    sid = torch.zeros((E, G, K), dtype=torch.int64)
    step = tcore.make_round_step(eng.round_fn, donate=False)
    a, _, _ = step(s0, td, sid)
    b, _, _ = step(s0, td, sid)
    after = convert.to_numpy(s0)
    for f in before:
        for k in before[f]:
            np.testing.assert_array_equal(after[f][k], before[f][k], err_msg=f"{f}/{k}")
    got_a, got_b = convert.to_numpy(a), convert.to_numpy(b)
    for f in got_a:
        for k in got_a[f]:
            np.testing.assert_array_equal(got_a[f][k], got_b[f][k], err_msg=f"{f}/{k}")
    assert not np.array_equal(got_a["params"]["float32"], before["params"]["float32"])


# ------------------------------------------ sample_round_batches, stats


def _partitioned(seed=2):
    rng = np.random.default_rng(seed)
    ds = tdata.make_classification(rng, num_samples=600, num_classes=10, dim=12)
    idx = tdata.partition(ds.y, 2, 3, mode="both_noniid", alpha=0.3, seed=1)
    return ds, idx


@pytest.mark.parametrize("masked", [False, True])
def test_sample_round_batches_matches_reference(masked):
    ds, idx = _partitioned()
    mask = np.array([[1, 0, 1], [0, 0, 1]], np.float32) if masked else None
    rt, rj = np.random.default_rng(7), np.random.default_rng(7)
    got = tdata.sample_round_batches(ds.x, ds.y, idx, rt, 2, 3, 4, client_mask=mask)
    want = jdata.sample_round_batches(ds.x, ds.y, idx, rj, 2, 3, 4, client_mask=mask)
    for k in ("x", "y"):
        assert isinstance(got[k], np.ndarray) and got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    # The generators stand in the same state: the masked clients drew nothing.
    assert rt.integers(1 << 30) == rj.integers(1 << 30)
    if masked:
        assert not got["x"][:, :, 0, 1].any() and not got["y"][:, :, 1, :2].any()
        assert got["x"][:, :, 1, 2].any()


def test_partition_stats_matches_reference():
    for mode in ("group_iid", "both_noniid", "label_shift"):
        ds, _ = _partitioned()
        idx = tdata.partition(ds.y, 3, 2, mode=mode, alpha=0.2, seed=4)
        assert tdata.partition_stats(ds.y, idx) == jdata.partition_stats(ds.y, idx), mode


# ----------------------------------------------------------- accuracy


def test_accuracy_matches_reference():
    """Streaming accuracy on params carried over from the reference's CNN,
    over 520 samples in batches of 512 (a ragged last batch)."""
    jinit, japply = jsmall.cnn(10, (8, 8, 1))
    _, tapply = tsmall.cnn(10, (8, 8, 1))
    p = jax.jit(jinit)(jax.random.PRNGKey(3))
    rng = np.random.default_rng(0)
    x = rng.normal(size=(520, 8, 8, 1)).astype(np.float32)
    y = rng.integers(0, 10, size=520).astype(np.int32)
    want = jsmall.accuracy(jax.jit(japply), p, jnp.asarray(x), y)
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, p), "cpu")
    got = tsmall.accuracy(tapply, tp, x, y)
    assert isinstance(got, float) and got == want
    assert tsmall.accuracy(tapply, tp, torch.from_numpy(x), torch.from_numpy(y)) == want
    # make_accuracy's float32 mean counts the same hits.
    whole = tsmall.make_accuracy(tapply, torch.from_numpy(x), torch.from_numpy(y))(tp)
    assert round(float(whole) * len(y)) == round(got * len(y))


# ------------------------------------------------- participation_masks


def _partial_engine(**kw):
    kw = dict(dict(client_participation=0.5, group_participation=0.5), **kw)
    spec = tapi.ExperimentSpec(levels=(G, K), lr=LR,
                               schedule=tapi.RoundSchedule(group_rounds=E, local_steps=H), **kw)
    return tapi.build(spec, tquad, device="cpu")


@pytest.mark.parametrize("mode", ["uniform", "fixed"])
def test_participation_masks_are_the_rounds_draw(mode):
    eng = _partial_engine(participation_mode=mode)
    state = eng.init({"w": torch.zeros(D)}, torch.Generator().manual_seed(11))
    before = state.rng.get_state()
    masks, nxt = eng.participation_masks(state.rng)
    assert torch.equal(state.rng.get_state(), before)        # untouched
    want = round_masks(state.rng, eng.spec.to_hfl_config())  # the round's own draw
    assert torch.equal(masks.group, want.group) and torch.equal(masks.client, want.client)
    assert torch.equal(nxt.get_state(), state.rng.get_state())
    # The round freezes exactly the replicas the mask leaves out.
    state = eng.init({"w": torch.zeros(D)}, torch.Generator().manual_seed(11))
    masks, _ = eng.participation_masks(state.rng)
    b = {k: torch.from_numpy(v) for k, v in _quad_batches().items()}
    new, m = eng.round_fn(state, b)
    moved = (new.params.bufs["float32"] != state.params.bufs["float32"]).any(-1).float()
    assert torch.equal(moved, masks.client)
    assert float(m.participation) == float(masks.client.mean())


def test_participation_masks_errors():
    spec = tapi.ExperimentSpec(levels=(G, K), schedule=tapi.RoundSchedule(E, H))
    eng = tapi.build(spec, tquad, device="cpu")
    masks, _ = eng.participation_masks(torch.Generator())     # full participation
    assert bool(masks.client.all()) and tuple(masks.client.shape) == (G, K)
    with pytest.raises(ValueError, match="needs the state's rng"):
        eng.participation_masks(eng.init({"w": torch.zeros(D)}).rng)
    jeng = japi.build(japi.ExperimentSpec(levels=(2, 2, 2), backend="multilevel",
                                          schedule=japi.RoundSchedule(periods=(4, 2, 1))), jquad)
    teng = tapi.build(tapi.ExperimentSpec(levels=(2, 2, 2), backend="multilevel",
                                          schedule=tapi.RoundSchedule(periods=(4, 2, 1))),
                      tquad, device="cpu")
    with pytest.raises(ValueError) as jerr:
        jeng.participation_masks(jax.random.PRNGKey(0))
    with pytest.raises(ValueError) as terr:
        teng.participation_masks(torch.Generator())
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("chunk", [1, 2])
def test_eval_reads_the_pre_round_generator(chunk):
    """``benchmarks/common.py``'s eval: ``participation_masks(prev.rng)``
    inside ``eval_fn(prev, state)`` gives the mask the evaluated round
    froze, at participation 0.5: its inactive replicas keep their bits
    through the round and its active ones change."""
    eng = _partial_engine(group_participation=1.0)
    _, td = _packed()
    seen = []

    def eval_fn(prev, state):
        cmask = eng.participation_masks(prev.rng)[0].client
        x0, x1 = prev.params.bufs["float32"], state.params.bufs["float32"]
        seen.append((cmask, (x1 != x0).any(-1).float()))
        return {"active": cmask.sum()}

    state, hz = tapi.fit(eng, td, 4, params={"w": torch.zeros(D)}, eval_fn=eval_fn,
                         chunk=chunk)
    assert len(seen) == 4
    for t, (cmask, moved) in enumerate(seen):
        assert 0 < float(cmask.sum()) < G * K
        assert torch.equal(moved, cmask), t
        assert float(hz.metrics.participation[t]) == float(cmask.mean())


# ------------------------------------------------------------ exports


def test_exports_cover_the_reference():
    assert set(jcore.__all__) <= set(tcore.__all__)
    assert set(jdata.__all__) <= set(tdata.__all__)
    for mod in (tcore, tdata):
        for name in mod.__all__:
            obj = getattr(mod, name)
            assert isinstance(obj, tuple) or obj.__module__.startswith("repro_torch."), name
    assert tcore.ALGORITHMS == jcore.ALGORITHMS
    assert tcore.FAULT_KINDS == jcore.FAULT_KINDS
