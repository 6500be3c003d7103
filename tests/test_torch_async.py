"""Async group rounds on the port's simulator engine, against the JAX
package, on the CPU.

* ``core.staleness``: the plan against ``repro.core.staleness`` over a grid
  of per-group round tuples, policies and ``max_staleness`` -- every
  property, ``iteration_mask()``, ``discount_weights()`` and
  ``report_mask(t)`` / ``fresh_mask(t)`` for t = 0..7 -- exactly.
* The engine against ``oracle.mtgc_async_run`` at the cases and
  tolerances of ``tests/test_async_rounds.py``.
* The engine against the reference engine round by round, over the four
  policies x {flat + fused (the reference's kernel in interpret mode), tree
  unfused} x {full participation, 0.5/0.75 under both weightings}, the
  reference's masks injected (``RoundDraws``): every state field --
  ``round``, ``snap`` and ``glob`` included -- and ``comm_bytes`` at the
  reference's parity tolerance (rtol 1e-5 in float32; z and y carry the
  params' atol through their quotients, ROADMAP queue 3 item 2).
* The uniform tuple under ``sync`` is the scalar-E round bit for bit; a
  degenerate live plan (cadence 1 everywhere) matches the sync round.
* Timeouts under an async schedule (the realized-download carry ``dl``) and
  the defense against the reference engine, fault masks injected.
* ``global_model`` reads the fastest group; a straggler's idle iterations
  keep its replicas' bits; the guard's rollback restores ``round``,
  ``snap``, ``glob`` and ``dl`` bit for bit.
"""
import dataclasses

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
from oracle import mtgc_async_run  # noqa: E402
from test_mtgc_engine import D as OD  # noqa: E402
from test_mtgc_engine import make_batches as oracle_batches  # noqa: E402
from test_mtgc_engine import np_grad  # noqa: E402
from test_torch_faults import _tplan, reference_draws  # noqa: E402

from repro import api as japi  # noqa: E402
from repro.core import as_tree as jas_tree  # noqa: E402
from repro.core import faults as jflt  # noqa: E402
from repro.core import staleness as jst  # noqa: E402
from repro_torch import api as tapi  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import driver as tdrv  # noqa: E402
from repro_torch.core import staleness as tst  # noqa: E402
from repro_torch.core.config import HFLConfig  # noqa: E402
from repro_torch.core.engine import _build_global_round, hfl_init  # noqa: E402
from repro_torch.core.packer import as_tree  # noqa: E402

D = 5
RTOL, ATOL = 1e-5, 1e-6
POLICIES = ("sync", "naive", "discount", "delay_compensated")
ASYNC_POLICIES = POLICIES[1:]
STATE_FIELDS = ("params", "z", "y", "dyn", "snap", "glob")


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """One intra-op thread: the suite runs files in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def quad2(params, batch):
    """A two-leaf elementwise quadratic, for either package (the flat layout
    then packs two segments)."""
    mod = torch if isinstance(params["w"], torch.Tensor) else jnp
    r = batch["a"] * params["w"] - batch["b"]
    s = batch["c"] * params["v"] - batch["d"]
    return 0.5 * mod.sum(r * r) + 0.5 * mod.sum(s * s)


def quad_loss(params, batch):
    mod = torch if isinstance(params["w"], torch.Tensor) else jnp
    r = batch["a"] * params["w"] - batch["b"]
    return 0.5 * mod.sum(r * r)


def make_batches(lead, seed):
    """``quad2``'s batches with leading axes ``lead`` ([E, H, (A,) G, K])."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return {"a": (rng.normal(size=lead + (D,)) + 2.0).astype(f32),
            "b": rng.normal(size=lead + (D,)).astype(f32),
            "c": (rng.normal(size=lead + (2, 3)) + 2.0).astype(f32),
            "d": rng.normal(size=lead + (2, 3)).astype(f32)}


P0 = {"w": np.linspace(-1.0, 1.0, D).astype(np.float32),
      "v": np.arange(6, dtype=np.float32).reshape(2, 3) / 10.0}


def field_np(v):
    """A state field of either package as {leaf: numpy} (flat: unpacked)."""
    if isinstance(v, torch.Tensor):
        return v.numpy()
    if hasattr(v, "bufs") and not isinstance(next(iter(v.bufs.values())), torch.Tensor):
        return jax.tree.map(np.asarray, jas_tree(v))
    if isinstance(v, dict) and not isinstance(next(iter(v.values())), torch.Tensor):
        return jax.tree.map(np.asarray, v)
    if not isinstance(v, dict) and not hasattr(v, "bufs"):
        return np.asarray(v)
    return convert.to_numpy(as_tree(v))


def assert_close(got, want, rtol, atol, tag):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), tag
        for k in want:
            assert_close(got[k], want[k], rtol, atol, f"{tag}/{k}")
        return
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want), err_msg=f"{tag}: NaN positions")
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=tag)


def run_pair(jspec, tspec, T, seed, loss=quad2, p0=P0, metrics=("loss", "client_drift",
                                                                   "group_drift", "participation",
                                                                   "comm_bytes", "screened")):
    """``T`` chained rounds through both packages' front doors, the
    reference's draws injected; every state field and ``metrics`` compared
    each round. Returns (reference state, port state, port engine)."""
    G, K = jspec.levels
    H, lr = jspec.schedule.local_steps, jspec.lr
    E = jspec.schedule.max_group_rounds
    sharded = jspec.backend == "sharded"
    plan = jspec.staleness_plan()
    e_min = min(plan.effective_rounds) if plan is not None else E
    atol = {"z": ATOL / (H * lr), "y": ATOL / (H * e_min * lr)}
    jeng, teng = japi.build(jspec, loss), tapi.build(tspec, loss, device="cpu")
    jstate = jeng.init(jax.tree.map(jnp.asarray, p0), rng=jax.random.PRNGKey(seed))
    tstate = teng.init(convert.params_from_numpy(p0, "cpu"))
    jround = jax.jit(jeng.round_fn)
    lead = (E, H, 1, G, K) if sharded else (E, H, G, K)
    for r in range(T):
        b = (make_batches(lead, seed + r) if loss is quad2
             else {k: v[:, :, None] if sharded else v
                   for k, v in oracle_batches(G, K, E, H, seed=seed + r)[2].items()})
        draws = reference_draws(jstate.rng, jspec.to_hfl_config(), jspec.faults, None, [])
        jstate, jm = jround(jstate, jax.tree.map(jnp.asarray, b))
        tstate, tm = teng.round_fn(tstate, {k: torch.from_numpy(np.ascontiguousarray(v))
                                            for k, v in b.items()}, draws=draws)
        for f in STATE_FIELDS + ("round", "dl"):
            want = getattr(jstate, f, None)
            got = getattr(tstate, f, None)
            if want is None:
                assert got is None, f"round {r}: {f} should be None"
                continue
            if f in ("round", "dl"):
                np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=f)
                continue
            assert_close(field_np(got), field_np(want), RTOL, atol.get(f, ATOL), f"round {r}: {f}")
        for f in metrics:
            assert_close(getattr(tm, f).numpy(), np.asarray(getattr(jm, f)), RTOL,
                         ATOL, f"round {r}: metric {f}")
        assert float(tm.screened) == float(jm.screened), f"round {r}: screened"
    return jstate, tstate, teng


# ------------------------------------------------------------------- plan

TUPLES = [(4, 2, 1), (2, 1), (3, 3), (1, 2, 3), (8, 1), 3]


@pytest.mark.parametrize("max_staleness", [None, 1, 2])
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("group_rounds", TUPLES, ids=str)
def test_plan_matches_reference(group_rounds, policy, max_staleness):
    G = len(group_rounds) if isinstance(group_rounds, tuple) else 2
    try:
        want = jst.make_plan(group_rounds, G, policy, max_staleness)
    except ValueError as err:
        with pytest.raises(ValueError, match="max_staleness"):
            tst.make_plan(group_rounds, G, policy, max_staleness)
        assert "max_staleness" in str(err)
        return
    got = tst.make_plan(group_rounds, G, policy, max_staleness)
    if want is None:
        assert got is None
        return
    assert tst.STALENESS_POLICIES == jst.STALENESS_POLICIES
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for prop in ("num_groups", "e_pad", "periods", "staleness", "effective_rounds",
                 "needs_round_counter", "needs_snapshots", "fastest_group"):
        assert getattr(got, prop) == getattr(want, prop), prop
    for fn in ("iteration_mask", "discount_weights"):
        a, b = getattr(got, fn)(), np.asarray(getattr(want, fn)())
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b, err_msg=fn)
    for t in range(8):
        tt = torch.tensor(t, dtype=torch.int32)
        for fn in ("report_mask", "fresh_mask"):
            a = getattr(got, fn)(tt)
            assert a.dtype == torch.float32 and a.shape == (G,)
            np.testing.assert_array_equal(a.numpy(), np.asarray(getattr(want, fn)(jnp.int32(t))),
                                          err_msg=f"{fn}({t})")


def test_plan_rejects_what_the_reference_rejects():
    for kw in (dict(group_rounds=(2, 0)), dict(group_rounds=(2, 1), policy="stale_ok"),
               dict(group_rounds=(2, 1), policy="naive", max_staleness=0)):
        with pytest.raises(ValueError):
            jst.StalenessPlan(**kw)
        with pytest.raises(ValueError):
            tst.StalenessPlan(**kw)
    with pytest.raises(ValueError, match="one entry per group"):
        tst.make_plan((3, 1, 2), 2)


# ------------------------------------------------------------ the oracle


@pytest.mark.parametrize("policy", ASYNC_POLICIES)
@pytest.mark.parametrize("group_rounds,max_staleness",
                         [((4, 2, 1), None), ((4, 2, 1), 1), ((2, 1), None)])
def test_simulator_matches_async_oracle(policy, group_rounds, max_staleness):
    """``tests/test_async_rounds.py::test_simulator_matches_async_oracle`` on
    the port, at that test's tolerances."""
    Go, Ko, Ho, lr, windows = len(group_rounds), 2, 2, 0.05, 4
    e_pad = max(group_rounds)
    a, b, batches = oracle_batches(Go, Ko, e_pad, Ho)
    spec = tapi.ExperimentSpec(
        levels=(Go, Ko), algorithm="mtgc", lr=lr, state_layout="tree",
        schedule=tapi.RoundSchedule(group_rounds=group_rounds, local_steps=Ho),
        staleness=policy, max_staleness=max_staleness)
    engine = tapi.build(spec, quad_loss, device="cpu")
    state = engine.init({"w": torch.zeros(OD)})
    tb = {k: torch.from_numpy(v) for k, v in batches.items()}
    for _ in range(windows):
        state, metrics = engine.round_fn(state, tb)
        assert torch.isfinite(metrics.loss).all()
    x, z, y = mtgc_async_run(np.zeros(OD, np.float32), np_grad(a, b), Go, Ko, group_rounds, Ho,
                             lr, windows, policy=policy, max_staleness=max_staleness)
    tag = f"{policy}/{group_rounds}/ms={max_staleness}"
    np.testing.assert_allclose(state.params["w"].numpy(), x, rtol=2e-4, atol=2e-5, err_msg=tag)
    np.testing.assert_allclose(state.z["w"].numpy(), z, rtol=2e-4, atol=2e-4, err_msg=tag)
    np.testing.assert_allclose(state.y["w"].numpy(), y, rtol=2e-4, atol=2e-4, err_msg=tag)
    plan = spec.staleness_plan()
    np.testing.assert_array_equal(engine.global_model(state)["w"].numpy(),
                                  state.params["w"][plan.fastest_group, 0].numpy())


# --------------------------------------------- against the reference engine

PARTICIPATION = {
    "full": {},
    "partial-none": dict(client_participation=0.5, group_participation=0.75),
    "partial-ht": dict(client_participation=0.5, group_participation=0.75,
                       participation_weighting="inverse_prob"),
}


def _spec_pair(G, K, group_rounds, H, policy, extra, backend="simulator", faults=None,
               defense=None, A=None):
    jkw = dict(levels=(G, K), lr=0.05, staleness=policy, backend=backend, **extra)
    if backend == "sharded" and extra.get("fusion") == "fused":
        jkw["fused_mode"] = "interpret"
    tkw = {k: v for k, v in jkw.items() if k != "fused_mode"}
    jspec = japi.ExperimentSpec(schedule=japi.RoundSchedule(group_rounds=group_rounds,
                                                            local_steps=H, microbatches=A),
                                faults=faults, defense=defense, **jkw)
    tspec = tapi.ExperimentSpec(schedule=tapi.RoundSchedule(group_rounds=group_rounds,
                                                            local_steps=H, microbatches=A),
                                faults=_tplan(faults), defense=_tplan(defense), **tkw)
    return jspec, tspec


@pytest.mark.parametrize("participation", sorted(PARTICIPATION))
@pytest.mark.parametrize("layout,fusion", [("flat", "fused"), ("tree", "none")])
@pytest.mark.parametrize("policy", POLICIES)
def test_async_rounds_match_reference_engine(policy, layout, fusion, participation):
    """Four windows of (3, 2, 1) group rounds at 4 groups x 3 clients: every
    state field (round, snap and glob included), the loss, drifts and
    comm_bytes against the reference engine."""
    extra = dict(state_layout=layout, fusion=fusion, **PARTICIPATION[participation])
    jspec, tspec = _spec_pair(4, 3, (3, 2, 1, 2), 2, policy, extra)
    jstate, tstate, _ = run_pair(jspec, tspec, 4, seed=7)
    assert (tstate.snap is not None) == (policy == "delay_compensated")
    assert int(tstate.round) == 4


@pytest.mark.parametrize("layout", ["tree", "flat"])
@pytest.mark.parametrize("algo", ["mtgc", "hfedavg", "local_corr", "group_corr", "fedprox",
                                  "feddyn"])
def test_uniform_tuple_sync_is_bit_exact(algo, layout):
    """(E, ..., E) under ``sync`` runs the scalar-E round, bit for bit."""
    kw = dict(levels=(2, 3), algorithm=algo, lr=0.05, state_layout=layout,
              prox_mu=0.1 if algo == "fedprox" else 0.0,
              feddyn_alpha=0.1 if algo == "feddyn" else 0.0)
    base = tapi.ExperimentSpec(schedule=tapi.RoundSchedule(group_rounds=2, local_steps=2), **kw)
    tup = tapi.ExperimentSpec(schedule=tapi.RoundSchedule(group_rounds=(2, 2), local_steps=2),
                              **kw)
    assert tup.staleness_plan() is None
    outs = []
    for spec in (base, tup):
        eng = tapi.build(spec, quad2, device="cpu")
        state = eng.init(convert.params_from_numpy(P0, "cpu"))
        for r in range(2):
            b = make_batches((2, 2, 2, 3), 30 + r)
            state, _ = eng.round_fn(state, {k: torch.from_numpy(v) for k, v in b.items()})
        outs.append(convert.to_numpy(state))
    for f in ("params", "z", "y", "dyn"):
        for k, v in outs[0][f].items():
            np.testing.assert_array_equal(outs[1][f][k], v, err_msg=f"{f}/{k}")


def test_degenerate_live_plan_matches_legacy():
    """The async machinery forced on with cadence 1 everywhere reproduces
    the sync round (``tests/test_async_rounds.py``'s tolerance)."""
    G, K, E, H = 2, 3, 2, 2
    cfg = HFLConfig(num_groups=G, clients_per_group=K, local_steps=H, group_rounds=E, lr=0.05,
                    use_flat_state=False)
    plan = tst.StalenessPlan((E,) * G, policy="naive")
    assert plan.periods == (1,) * G
    b = make_batches((E, H, G, K), 11)
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    s_legacy = s_async = hfl_init(convert.params_from_numpy(P0, "cpu"), cfg, device="cpu")
    rf_legacy = _build_global_round(quad2, cfg)
    rf_async = _build_global_round(quad2, cfg, plan=plan)
    for _ in range(2):
        s_legacy, _ = rf_legacy(s_legacy, tb)
        s_async, _ = rf_async(s_async, tb)
    for f in ("params", "z", "y"):
        for k in P0:
            np.testing.assert_allclose(getattr(s_async, f)[k].numpy(),
                                       getattr(s_legacy, f)[k].numpy(), rtol=1e-6, atol=1e-6,
                                       err_msg=f"{f}/{k}")


FAULT_SCENARIOS = {
    "timeout": dict(faults=dict(timeout_rate=0.5), defense=None),
    "crash-timeout-explode-screen-clip": dict(
        faults=dict(crash_rate=0.2, timeout_rate=0.4, corrupt_rate=0.3, corrupt_kind="explode",
                    explode_factor=100.0),
        defense=dict(screen_norm=20.0, clip_norm=2.0)),
    "timeout-nan-nonfinite": dict(
        faults=dict(timeout_rate=0.3, corrupt_rate=0.3, corrupt_kind="nan"), defense=dict()),
}


@pytest.mark.parametrize("cp", [1.0, 0.6])
@pytest.mark.parametrize("layout,fusion", [("flat", "fused"), ("tree", "none")])
@pytest.mark.parametrize("policy", ["naive", "delay_compensated"])
@pytest.mark.parametrize("scenario", sorted(FAULT_SCENARIOS))
def test_async_faults_match_reference_engine(scenario, policy, layout, fusion, cp):
    """Timeouts under an async schedule (the realized-download carry ``dl``
    drives the next window's z restart) and the defense, fault masks
    injected: every state field, ``dl`` exactly, ``screened`` exactly, NaN
    positions exactly."""
    sc = FAULT_SCENARIOS[scenario]
    jf = jflt.FaultPlan(**sc["faults"])
    jd = None if sc["defense"] is None else jflt.DefensePlan(**sc["defense"])
    extra = dict(state_layout=layout, fusion=fusion, client_participation=cp)
    jspec, tspec = _spec_pair(3, 3, (3, 2, 1), 2, policy, extra, faults=jf, defense=jd)
    _, tstate, _ = run_pair(jspec, tspec, 4, seed=int(cp * 10) + len(scenario))
    assert tstate.dl is not None and tstate.dl.shape == (3,)


def test_async_timeout_carry_drives_the_z_restart():
    """A group that times out in its report window neither merges nor
    downloads (its y and replicas stay), ``dl`` records the realized
    downloads (``rep x any_obs``), and the next window restarts z only
    where ``dl`` says: with ``dl`` forced to ones instead, group 1's z
    would differ."""
    from repro_torch.core.engine import RoundDraws
    from repro_torch.core.faults import FaultMasks

    G, K, H = 2, 2, 2
    _, tspec = _spec_pair(G, K, (2, 1), H, "naive", dict(state_layout="flat"),
                          faults=jflt.FaultPlan(timeout_rate=0.5))
    eng = tapi.build(tspec, quad2, device="cpu")
    state = eng.init(convert.params_from_numpy(P0, "cpu"))

    def draws(timeout):
        return RoundDraws(faults=FaultMasks(torch.zeros(G, K), torch.tensor(timeout),
                                            torch.zeros(G, K)))

    tb = [{k: torch.from_numpy(v) for k, v in make_batches((2, H, G, K), 40 + r).items()}
          for r in range(3)]
    state, _ = eng.round_fn(state, tb[0], draws=draws([0.0, 0.0]))   # t = 0: group 0 reports
    np.testing.assert_array_equal(state.dl.numpy(), [1.0, 0.0])
    y_before = state.y.bufs["float32"][1].clone()
    state, _ = eng.round_fn(state, tb[1], draws=draws([0.0, 1.0]))   # t = 1: group 1 times out
    np.testing.assert_array_equal(state.dl.numpy(), [1.0, 0.0])
    x = state.params.bufs["float32"]
    assert torch.equal(state.y.bufs["float32"][1], y_before)
    assert not torch.equal(x[1, 0], x[0, 0])                         # no download
    forced = state._replace(dl=torch.ones(G))
    s_dl, _ = eng.round_fn(state, tb[2], draws=draws([0.0, 0.0]))    # t = 2: group 1 not fresh
    s_on, _ = eng.round_fn(forced, tb[2], draws=draws([0.0, 0.0]))
    z_dl, z_on = s_dl.z.bufs["float32"], s_on.z.bufs["float32"]
    assert torch.equal(z_dl[0], z_on[0])
    assert not torch.equal(z_dl[1], z_on[1])


@pytest.mark.parametrize("layout", ["flat", "tree"])
def test_straggler_idle_iteration_keeps_its_bits(monkeypatch, layout):
    """Group 1 runs E_1 = 1 of e_pad = 2 group rounds. Every fused step of
    its idle iteration has the mask row 0 and leaves its replicas' bits;
    its replicas and z leave the window as they entered the idle iteration
    (the masked mean writes nothing); at window 0 it does not report, so
    its y stays zero and it does not download."""
    from repro_torch.kernels import ops

    G, K, H = 2, 3, 2
    spec = tapi.ExperimentSpec(levels=(G, K), lr=0.05, state_layout=layout, fusion="fused",
                               schedule=tapi.RoundSchedule(group_rounds=(2, 1), local_steps=H),
                               staleness="naive")
    eng = tapi.build(spec, quad2, device="cpu")
    calls = []
    if layout == "flat":
        real = ops.mtgc_update_flat

        def spy(x, g, z, y, mask=None, **kw):
            out = real(x, g, z, y, mask, **kw)
            calls.append((x.clone(), z.clone(), mask.clone(), out.clone()))
            return out

        monkeypatch.setattr(ops, "mtgc_update_flat", spy)
    state0 = eng.init(convert.params_from_numpy(P0, "cpu"))
    b = make_batches((2, H, G, K), 50)
    state, _ = eng.round_fn(state0, {k: torch.from_numpy(v) for k, v in b.items()})
    x, z = convert.to_numpy(as_tree(state.params)), convert.to_numpy(as_tree(state.z))
    y = convert.to_numpy(as_tree(state.y))
    for k in P0:
        assert np.array_equal(x[k][1, 0], x[k][1, 1])       # the group model
        assert not np.allclose(x[k][1, 0], x[k][0, 0])      # not the global one
        np.testing.assert_array_equal(y[k][1], 0)
    if layout == "flat":
        assert len(calls) == 2 * H
        for e in range(2):
            for h in range(H):
                xin, zin, mask, out = calls[e * H + h]
                np.testing.assert_array_equal(mask.numpy(), [[1.0] * K, [1.0 - e] * K])
                if e == 1:
                    assert torch.equal(out[1].view(torch.int32), xin[1].view(torch.int32))
        # The window's final replicas and z of group 1 are the ones its idle
        # iteration started from.
        xin, zin = calls[H][0], calls[H][1]
        assert torch.equal(state.params.bufs["float32"][1].view(torch.int32),
                           xin[1].view(torch.int32))
        assert torch.equal(state.z.bufs["float32"][1].view(torch.int32),
                           zin[1].view(torch.int32))


def test_global_model_reads_the_fastest_group():
    spec = tapi.ExperimentSpec(levels=(3, 2), lr=0.05,
                               schedule=tapi.RoundSchedule(group_rounds=(1, 3, 2),
                                                           local_steps=2),
                               staleness="discount")
    eng = tapi.build(spec, quad2, device="cpu")
    assert spec.staleness_plan().fastest_group == 1
    state = eng.init(convert.params_from_numpy(P0, "cpu"))
    b = make_batches((3, 2, 3, 2), 60)
    state, _ = eng.round_fn(state, {k: torch.from_numpy(v) for k, v in b.items()})
    gm = eng.global_model(state)
    full = convert.to_numpy(as_tree(state.params))
    for k in P0:
        np.testing.assert_array_equal(gm[k].numpy(), full[k][1, 0])
        assert not np.array_equal(full[k][0, 0], full[k][1, 0])    # group 0 lags


@pytest.mark.parametrize("layout", ["flat", "tree"])
def test_guard_rollback_restores_the_async_state(layout):
    """Every upload NaN, undefended, delay-compensated with timeouts: each
    retry starts from the snapshot's bits -- ``round``, ``snap``, ``glob``
    and ``dl`` included -- and the guard raises once its retries run out."""
    spec = tapi.ExperimentSpec(
        levels=(2, 2), lr=0.05, state_layout=layout,
        schedule=tapi.RoundSchedule(group_rounds=(2, 1), local_steps=1),
        staleness="delay_compensated",
        faults=tapi.FaultPlan(timeout_rate=0.3, corrupt_rate=0.999, corrupt_kind="nan"))
    eng = tapi.build(spec, quad2, device="cpu")
    warm = tapi.build(dataclasses.replace(spec, faults=tapi.FaultPlan(timeout_rate=0.3)), quad2,
                      device="cpu")
    rng = np.random.default_rng(0)
    arrays = {k: torch.from_numpy(v[0]) for k, v in
              make_batches((1, 2, 2, 4, 1), 70).items()}   # [G, K, S, H, ...]
    data = tdrv.PackedBatches(arrays, torch.Generator().manual_seed(9), 2, 1)
    del rng
    # A warm-up window so that snap, glob and dl are not their initial values.
    state, _ = tapi.fit(warm, data, 3, params=convert.params_from_numpy(P0, "cpu"),
                        rng=torch.Generator().manual_seed(1))
    assert int(state.round) == 3
    want = [t.clone() for t in tdrv._state_tensors(state)]
    starts = []

    def spy(st, batches, **kw):
        starts.append([t.clone() for t in tdrv._state_tensors(st)])
        return eng.round_fn(st, batches, **kw)

    with pytest.raises(RuntimeError, match="exhausted 2 retries"):
        tdrv.run_rounds(spy, state, data, 2, chunk=2,
                        guard=tdrv.GuardSpec(max_retries=2, round_fn_for_retry=lambda a: spy))
    assert len(starts) == 6
    names = [f for f in state._fields
             if getattr(state, f) is not None and not isinstance(getattr(state, f),
                                                                 torch.Generator)
             for _ in tdrv._tensor_leaves(getattr(state, f))]
    assert len(names) == len(want) and {"round", "snap", "glob", "dl"} <= set(names)
    for attempt in (0, 2, 4):
        for name, got, w in zip(names, starts[attempt], want):
            assert torch.equal(got.view(torch.uint8) if got.is_floating_point() else got,
                               w.view(torch.uint8) if w.is_floating_point() else w), name


def test_retry_round_fn_keeps_the_plan():
    spec = tapi.ExperimentSpec(levels=(2, 2), schedule=tapi.RoundSchedule((2, 1), 1),
                               staleness="discount",
                               defense=tapi.DefensePlan(screen_norm=5.0))
    eng = tapi.build(spec, quad2, device="cpu")
    assert eng.retry_round_fn(1) is not eng.round_fn
    assert eng._retry_round_fns[1] is eng.retry_round_fn(1)
    # The tightened round runs the same async window: the same bits as the
    # original round when no upload comes near either threshold.
    state0 = eng.init(convert.params_from_numpy(P0, "cpu"))
    tb = {k: torch.from_numpy(v) for k, v in make_batches((2, 1, 2, 2), 80).items()}
    a, _ = eng.round_fn(state0, tb)
    b, _ = eng.retry_round_fn(1)(state0, tb)
    for f in ("params", "z", "y"):
        for k, v in convert.to_numpy(as_tree(getattr(a, f))).items():
            np.testing.assert_array_equal(convert.to_numpy(as_tree(getattr(b, f)))[k], v)


def test_async_state_crosses_through_numpy():
    """A reference async state (snap, glob, dl, round) crosses into the
    port and continues in lockstep with the reference."""
    jf = jflt.FaultPlan(timeout_rate=0.4)
    jspec, tspec = _spec_pair(3, 2, (2, 1, 2), 2, "delay_compensated",
                              dict(state_layout="flat"), faults=jf)
    jeng, teng = japi.build(jspec, quad2), tapi.build(tspec, quad2, device="cpu")
    js = jeng.init(jax.tree.map(jnp.asarray, P0), rng=jax.random.PRNGKey(3))
    jround = jax.jit(jeng.round_fn)
    b = make_batches((2, 2, 3, 2), 90)
    for _ in range(2):
        js, _ = jround(js, jax.tree.map(jnp.asarray, b))
    host = lambda v: {k: np.asarray(a) for k, a in v.bufs.items()}   # noqa: E731
    ts = convert.state_from_numpy(host(js.params), host(js.z), host(js.y), host(js.dyn),
                                  int(js.round), snap=host(js.snap), glob=host(js.glob),
                                  dl=np.asarray(js.dl), template=P0, device="cpu")
    draws = reference_draws(js.rng, jspec.to_hfl_config(), jspec.faults, None, [])
    js, _ = jround(js, jax.tree.map(jnp.asarray, b))
    ts, _ = teng.round_fn(ts, {k: torch.from_numpy(v) for k, v in b.items()}, draws=draws)
    for f in ("params", "z", "y", "snap", "glob"):
        assert_close(field_np(getattr(ts, f)), field_np(getattr(js, f)), RTOL, 1e-5, f)
    np.testing.assert_array_equal(ts.dl.numpy(), np.asarray(js.dl))
    assert int(ts.round) == int(js.round)
