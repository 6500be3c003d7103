"""Fault injection, screened aggregation and the guarded horizon on the
port's sharded backend (``repro_torch.launch.train``), on the CPU.

* Against the JAX package's sharded round (``repro.api.build(spec)`` with
  ``backend="sharded"``; its fused path runs the Pallas kernel in interpret
  mode), with the reference's participation masks, fault masks and noise
  injected (:func:`test_torch_faults.reference_draws`: the sharded
  reference draws them with the simulator engine's key schedule): every
  state field at the reference's parity tolerance (rtol 1e-5 in float32; z
  and y carry the params' atol, ROADMAP queue 3 item 2), ``screened``
  exactly, NaN positions exactly, and the port's simulator engine in
  lockstep.
* Against ``oracle.mtgc_faulty_run`` with hand-made masks: a client that
  crashed in round 1 starts round 2 from its stale replica, so the round
  keeps a per-replica phase-start model.
* The pieces: with ``_CHUNK`` patched small, the two-pass screen (norms and
  finite flags summed piece by piece, the upload view formed again in the
  mean) against the one-piece round: bit for bit without clipping, and
  within float32 rounding of the piecewise norm with it (ROADMAP queue 3
  item 8(h)).
* The guarded horizon on the in-place round: the restored state equals the
  snapshot bit for bit; zero faults bit-exact; recovery.
* The trainer CLI with ``--fault-corrupt 0.3 --fault-kind explode
  --screen-norm 5``.

The port's round updates its state in place, so every run starts from a
fresh state.
"""
import dataclasses

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
from oracle import mtgc_faulty_run  # noqa: E402
from test_faults import make_batches, np_grad  # noqa: E402
from test_torch_compression import problem  # noqa: E402
from test_torch_faults import _tplan, assert_close, quad_loss, reference_draws  # noqa: E402

from repro import api as japi  # noqa: E402
from repro.core import as_tree as jas_tree  # noqa: E402
from repro.core import compression as jcmp  # noqa: E402
from repro.core import faults as jflt  # noqa: E402
from repro_torch import api as tapi  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import compression as tcmp  # noqa: E402
from repro_torch.core import driver as tdrv  # noqa: E402
from repro_torch.core import faults as tflt  # noqa: E402
from repro_torch.core import tree as tu  # noqa: E402
from repro_torch.core.engine import RoundDraws  # noqa: E402
from repro_torch.core.packer import as_tree  # noqa: E402
from repro_torch.launch import train  # noqa: E402

D = 5
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """One intra-op thread: the suite runs files in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sharded(b):
    """Simulator layout [E, H, G, K, ...] -> sharded [E, H, A=1, G, K, ...]."""
    return {k: np.ascontiguousarray(v[:, :, None]) for k, v in b.items()}


def _torch(b):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in b.items()}


def _w(field):
    return convert.to_numpy(as_tree(field))["w"]


SCENARIOS = {
    "crash-timeout-explode-screen-clip": dict(
        faults=dict(crash_rate=0.2, timeout_rate=0.3, corrupt_rate=0.3, corrupt_kind="explode",
                    explode_factor=100.0),
        defense=dict(screen_norm=20.0, clip_norm=2.0)),
    "crash-nan-nonfinite": dict(
        faults=dict(crash_rate=0.2, corrupt_rate=0.3, corrupt_kind="nan"), defense=dict()),
    "nan-undefended": dict(faults=dict(corrupt_rate=0.3, corrupt_kind="nan"), defense=None),
    "timeout-clip-only": dict(faults=dict(timeout_rate=0.4),
                              defense=dict(screen_nonfinite=False, clip_norm=0.5)),
}


def _specs(scenario, layout, fusion, cp, comp=None, G=3, K=3, E=2, H=2):
    sc = SCENARIOS[scenario]
    jf = None if sc["faults"] is None else jflt.FaultPlan(**sc["faults"])
    jd = None if sc["defense"] is None else jflt.DefensePlan(**sc["defense"])
    jc = None if comp is None else jcmp.CompressionPlan(**comp)
    kw = dict(levels=(G, K), backend="sharded", lr=0.05, state_layout=layout, fusion=fusion,
              client_participation=cp)
    jspec = japi.ExperimentSpec(schedule=japi.RoundSchedule(group_rounds=E, local_steps=H),
                                fused_mode="interpret" if fusion == "fused" else None,
                                faults=jf, defense=jd, compression=jc, **kw)
    tspec = tapi.ExperimentSpec(schedule=tapi.RoundSchedule(group_rounds=E, local_steps=H),
                                faults=_tplan(jf), defense=_tplan(jd), compression=_tplan(jc),
                                **kw)
    return jspec, tspec


def _against_reference(jspec, tspec, T, seed, flips=0.0):
    G, K = jspec.levels
    E, H, lr = jspec.schedule.group_rounds, jspec.schedule.local_steps, jspec.lr
    jeng = japi.build(jspec, quad_loss)
    teng = tapi.build(tspec, quad_loss, device="cpu")
    seng = tapi.build(dataclasses.replace(tspec, backend="simulator"), quad_loss, device="cpu")
    jstate = jeng.init({"w": jnp.zeros(D)}, rng=jax.random.PRNGKey(seed))
    tstate = teng.init({"w": torch.zeros(D)})
    sstate = seng.init({"w": torch.zeros(D)})
    jround = jax.jit(jeng.round_fn)
    atol = {"z": ATOL / (H * lr), "y": ATOL / (H * E * lr)}
    scr = 0.0
    for r in range(T):
        b = make_batches(G, K, E, H, seed=seed + r)[2]
        b = {k: np.asarray(v) for k, v in b.items()}
        draws = reference_draws(jstate.rng, jspec.to_hfl_config(), jspec.faults,
                                jspec.compression, [D])
        jstate, jm = jround(jstate, jax.tree.map(jnp.asarray, _sharded(b)))
        tstate, tm = teng.round_fn(tstate, _torch(_sharded(b)), draws=draws)
        sstate, sm = seng.round_fn(sstate, _torch(b), draws=draws)
        for f in ("params", "z", "y", "efc", "efg"):
            want = getattr(jstate, f)
            if want is None:
                assert getattr(tstate, f) is None, f
                continue
            want, got = np.asarray(jas_tree(want)["w"]), _w(getattr(tstate, f))
            tol = atol.get(f, ATOL)
            if flips:
                np.testing.assert_array_equal(np.isnan(got), np.isnan(want), err_msg=f)
                off = ~np.isclose(got, want, rtol=RTOL, atol=tol, equal_nan=True)
                assert off.mean() <= flips, f"round {r}: {f}: {off.sum()} of {off.size} off"
            else:
                assert_close(got, want, RTOL, tol, f"round {r}: {f}")
        assert float(tm.screened) == float(jm.screened) == float(sm.screened), f"round {r}"
        scr += float(tm.screened)
        for f in ("loss", "participation", "comm_bytes"):
            assert_close(np.asarray(getattr(tm, f)), np.asarray(getattr(jm, f)), RTOL, ATOL,
                         f"round {r}: metric {f}")
        assert_close(_w(tstate.params), _w(sstate.params), 1e-6, 1e-7,
                     f"round {r}: simulator params")
    return tstate, scr


@pytest.mark.parametrize("cp", [1.0, 0.6])
@pytest.mark.parametrize("layout,fusion", [("flat", "fused"), ("tree", "none")])
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_sharded_faulty_rounds_match_reference(scenario, layout, fusion, cp):
    """Three chained rounds of the port's sharded backend against the JAX
    sharded round, the port's simulator engine in lockstep."""
    jspec, tspec = _specs(scenario, layout, fusion, cp)
    _against_reference(jspec, tspec, 3, seed=7 + len(scenario) + int(cp * 10))


@pytest.mark.parametrize("kind", ["explode", "nan"])
@pytest.mark.parametrize("layout", ["flat", "tree"])
def test_sharded_compress_corrupt_screen_matches_reference(layout, kind):
    """An int8 client link with error feedback under crashes, corruption
    and the defense (screen and clip): compress -> corrupt -> screen, the
    residual gated on the screen. A mask can turn one ulp into an int8 step
    (ROADMAP queue 3 item 4): 1% of a field's entries may lie off."""
    sc = "crash-timeout-explode-screen-clip" if kind == "explode" else "crash-nan-nonfinite"
    jspec, tspec = _specs(sc, layout, "fused", 1.0, comp=dict(client_mode="int8_stochastic"))
    state, scr = _against_reference(jspec, tspec, 3, seed=31, flips=0.01)
    assert scr > 0 and np.isfinite(_w(state.efc)).all()


def test_stale_replica_starts_from_its_own_model():
    """Client (1, 1) crashes in round 1 and misses the download; in round 2
    it is active again from its stale replica, and its exploded upload is
    screened: the round keeps per-replica phase-start models and agrees
    with the oracle, and with a fully screened group reverting."""
    G, K, E, H, lr, T = 2, 2, 2, 2, 0.05, 3
    a, b, batches = make_batches(G, K, E, H, seed=12)
    crash = np.zeros((T, G, K), np.float32)
    corrupt = np.zeros((T, G, K), np.float32)
    timeout = np.zeros((T, G), np.float32)
    crash[0, 1, 1] = 1.0
    corrupt[1, 1, 1] = 1.0
    corrupt[1, 0, 0] = corrupt[1, 0, 1] = 1.0      # group 0 fully screened in round 2
    timeout[2, 0] = 1.0
    plan = tflt.FaultPlan(crash_rate=0.1, timeout_rate=0.1, corrupt_rate=0.1,
                          corrupt_kind="explode", explode_factor=1e3)
    defense = tflt.DefensePlan(screen_norm=5.0)
    oracle = mtgc_faulty_run(np.zeros(D), np_grad(a, b), G, K, E, H, lr, T, crash=crash,
                             timeout=timeout, corrupt=corrupt, corrupt_kind="explode",
                             explode_factor=1e3, screen_nonfinite=True, screen_norm=5.0)
    for layout in ("flat", "tree"):
        spec = tapi.ExperimentSpec(levels=(G, K), backend="sharded", lr=lr, state_layout=layout,
                                   fusion="fused",
                                   schedule=tapi.RoundSchedule(group_rounds=E, local_steps=H),
                                   faults=plan, defense=defense)
        eng = tapi.build(spec, quad_loss, device="cpu")
        state = eng.init({"w": torch.zeros(D)})
        scr = 0.0
        for t in range(T):
            fm = tflt.FaultMasks(*(torch.from_numpy(m[t]) for m in (crash, timeout, corrupt)))
            state, m = eng.round_fn(state, _torch(_sharded(batches)),
                                    draws=RoundDraws(faults=fm))
            scr += float(m.screened)
        assert scr == oracle[3] == E * 3
        assert_close(_w(state.params), oracle[0], 2e-4, 2e-5, f"{layout} params")
        assert_close(_w(state.z), oracle[1], 2e-3, 2e-4, f"{layout} z")
        assert_close(_w(state.y), oracle[2], 2e-3, 2e-4, f"{layout} y")


def _quad_problem_specs(layout, faults, defense, comp=None):
    p0, _, tloss, batches = problem("quad")
    spec = tapi.ExperimentSpec(levels=(2, 3), backend="sharded", lr=0.05, state_layout=layout,
                               fusion="fused",
                               schedule=tapi.RoundSchedule(group_rounds=2, local_steps=2),
                               faults=faults, defense=defense, compression=comp)
    return p0, tloss, batches, spec


PIECE_CASES = {
    "explode-screen": (dict(crash_rate=0.1, timeout_rate=0.1, corrupt_rate=0.1,
                            corrupt_kind="explode", explode_factor=1e3),
                       dict(screen_norm=20.0), None),
    "nan-nonfinite-int8": (dict(crash_rate=0.1, corrupt_rate=0.1, corrupt_kind="nan"),
                           dict(), dict(client_mode="int8_stochastic",
                                        group_mode="int8_stochastic")),
    "inf-undefended": (dict(corrupt_rate=0.1, corrupt_kind="inf"), None, None),
    "explode-clip": (dict(corrupt_rate=0.1, corrupt_kind="explode", explode_factor=30.0),
                     dict(clip_norm=3.0), None),
}


@pytest.mark.parametrize("case", sorted(PIECE_CASES))
@pytest.mark.parametrize("layout", ["flat", "tree"])
def test_piecewise_screen_equals_one_piece_round(monkeypatch, layout, case):
    """Every row cut into pieces of 16 elements against one piece a row,
    same injected masks and noise: the two-pass screen gives the one-pass
    bits; with clipping, the clip scale carries the piecewise norm's
    rounding (queue 3 item 8(h)), so the clipped rows agree within 1e-6
    (z and y with the params' atol carried through H * lr = 0.1 and
    H * E * lr = 0.2)."""
    fk, dk, ck = PIECE_CASES[case]
    p0, tloss, batches, spec = _quad_problem_specs(
        layout, tflt.FaultPlan(**fk), None if dk is None else tflt.DefensePlan(**dk),
        None if ck is None else tcmp.CompressionPlan(**ck))
    G, K, E = 2, 3, 2
    rng = np.random.default_rng(8)
    n = sum(v.size for v in p0.values())
    rows = {"flat": [n], "tree": [30, 200]}[layout]          # leaves v, w
    draws = [RoundDraws(
        faults=tflt.FaultMasks(torch.tensor([[0.0, 1.0, 0.0], [0.0, 0.0, 0.0]]),
                               torch.tensor([0.0, float(r == 1)]),
                               torch.tensor([[1.0, 0.0, 0.0], [0.0, 1.0, float(r == 0)]])),
        client_noise=[[torch.from_numpy(rng.random((G * K, m)).astype(np.float32))
                       for m in rows] for _ in range(E)],
        group_noise=[torch.from_numpy(rng.random((G, m)).astype(np.float32)) for m in rows])
        for r in range(2)]
    outs = []
    for chunk in (1 << 26, 16):
        monkeypatch.setattr(train, "_CHUNK", chunk)
        monkeypatch.setattr(tcmp, "_CHUNK", chunk)
        eng = tapi.build(spec, tloss, device="cpu")
        state = eng.init(convert.params_from_numpy(p0, "cpu"))
        mets = []
        for r in range(2):
            state, m = eng.round_fn(state, _torch(_sharded(batches(r))), draws=draws[r])
            mets.append(convert.to_numpy(m))
        outs.append((convert.to_numpy(state), mets))
    assert sum(float(m["screened"]) for m in outs[0][1]) == sum(
        float(m["screened"]) for m in outs[1][1])
    for name in ("params", "z", "y", "efc", "efg"):
        want = outs[0][0].get(name)
        if want is None:
            continue
        want, got = tu.tree_leaves(want), tu.tree_leaves(outs[1][0][name])
        for g, w in zip(got, want):
            if "clip" in case:
                # z and y carry the params' atol through their quotients.
                assert_close(g, w, 1e-6, 1e-7 / {"z": 0.1, "y": 0.2}.get(name, 1.0), name)
            else:
                np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=name)
                np.testing.assert_array_equal(np.nan_to_num(g), np.nan_to_num(w), err_msg=name)


def test_screen_pass_replays_drawn_noise():
    """Under a defended int8 client link with the noise drawn from
    ``state.rng``, pass 2 draws again what pass 1 drew: the round equals
    the round with those same numbers injected."""
    p0, tloss, batches, spec = _quad_problem_specs(
        "flat", tflt.FaultPlan(corrupt_rate=0.2, corrupt_kind="explode"),
        tflt.DefensePlan(screen_norm=50.0),
        tcmp.CompressionPlan(client_mode="int8_stochastic"))
    eng = tapi.build(spec, tloss, device="cpu")
    fm = tflt.FaultMasks(torch.zeros(2, 3), torch.zeros(2), torch.tensor([[1.0, 0, 0], [0, 0, 0]]))
    s1 = eng.init(convert.params_from_numpy(p0, "cpu"), rng=torch.Generator().manual_seed(4))
    gen = torch.Generator().manual_seed(4)
    n = sum(v.size for v in p0.values())
    noise = [[torch.rand((3, n), generator=gen) for _ in range(2)] for _ in range(2)]
    cn = [[torch.cat(noise[e], dim=0)] for e in range(2)]
    s1, m1 = eng.round_fn(s1, _torch(_sharded(batches(0))), draws=RoundDraws(faults=fm))
    s2 = eng.init(convert.params_from_numpy(p0, "cpu"))
    s2, m2 = eng.round_fn(s2, _torch(_sharded(batches(0))),
                          draws=RoundDraws(faults=fm, client_noise=cn))
    for name in ("params", "z", "y", "efc"):
        for t1, t2 in zip(tu.tree_leaves(getattr(s1, name)), tu.tree_leaves(getattr(s2, name))):
            assert torch.equal(t1, t2), name
    assert float(m1.screened) == float(m2.screened) == 2.0
    assert torch.equal(s1.rng.get_state(), gen.get_state())


# ------------------------------------------------------- guarded horizon


def _toy(G, K, E, H, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(G, K, 4, H, D)).astype(np.float32) + 2.0
    b = rng.normal(size=(G, K, 4, H, D)).astype(np.float32)
    return tdrv.PackedBatches({"a": torch.from_numpy(a), "b": torch.from_numpy(b)},
                              torch.Generator().manual_seed(9), E, H, microbatches=1)


def _sharded_engine(layout="flat", **kw):
    spec = tapi.ExperimentSpec(levels=(2, 2), backend="sharded", lr=0.05, state_layout=layout,
                               fusion="fused",
                               schedule=tapi.RoundSchedule(group_rounds=2, local_steps=1,
                                                           microbatches=1), **kw)
    return tapi.build(spec, quad_loss, device="cpu")


@pytest.mark.parametrize("layout", ["flat", "tree"])
def test_sharded_guard_zero_fault_bit_exact(layout):
    eng = _sharded_engine(layout)
    s1, h1 = tapi.fit(eng, _toy(2, 2, 2, 1), 4, params={"w": torch.zeros(D)}, chunk=2)
    s2, h2 = tapi.fit(eng, _toy(2, 2, 2, 1), 4, params={"w": torch.zeros(D)}, chunk=2,
                      guard=True)
    for f in ("params", "z", "y"):
        np.testing.assert_array_equal(_w(getattr(s1, f)), _w(getattr(s2, f)))
    assert h1.guard is None and (h2.guard.rollbacks, h2.guard.retries) == (0, 0)


def test_sharded_guard_restores_the_in_place_state():
    """The sharded round writes its state in place: each retry must start
    from the snapshot's bits (NaN everywhere after a diverged attempt)."""
    eng = _sharded_engine(faults=tapi.FaultPlan(corrupt_rate=0.999, corrupt_kind="nan"))
    state = eng.init({"w": torch.linspace(-1.0, 1.0, D)})
    want = [t.clone() for t in tdrv._state_tensors(state)]
    starts = []

    def spy(st, batches, **kw):
        starts.append([t.clone() for t in tdrv._state_tensors(st)])
        return eng.round_fn(st, batches, **kw)

    with pytest.raises(RuntimeError, match="exhausted 2 retries"):
        tdrv.run_rounds(spy, state, _toy(2, 2, 2, 1), 2, chunk=2,
                        guard=tdrv.GuardSpec(max_retries=2, round_fn_for_retry=lambda a: spy))
    assert len(starts) == 6
    assert not torch.isfinite(tdrv._state_tensors(state)[0]).all()
    for attempt in (0, 2, 4):
        for got, w in zip(starts[attempt], want):
            assert torch.equal(got, w)


def test_sharded_guard_recovers():
    eng = _sharded_engine(faults=tapi.FaultPlan(corrupt_rate=0.08, corrupt_kind="nan"))
    state, hz = tapi.fit(eng, _toy(2, 2, 2, 1, seed=3), 10, params={"w": torch.zeros(D)},
                         chunk=2, rng=torch.Generator().manual_seed(2),
                         guard=tapi.GuardSpec(max_retries=6))
    assert np.isfinite(hz.metrics.loss).all()
    assert torch.isfinite(state.params.bufs["float32"]).all()
    assert hz.guard.rollbacks > 0


def test_train_cli_with_faults_and_defense(capsys):
    """``python -m repro_torch.launch.train --fault-corrupt 0.3 --fault-kind
    explode --screen-norm 5`` on the CPU: a real FaultPlan and DefensePlan
    reach the sharded round, and its losses stay finite."""
    state, hz = train.main(["--arch", "glm4-9b", "--smoke", "--rounds", "2", "--device", "cpu",
                            "--seq", "32", "--shards", "2", "--fault-corrupt", "0.3",
                            "--fault-kind", "explode", "--screen-norm", "5"])
    out = capsys.readouterr().out
    assert "[train] arch=glm4-9b" in out
    assert np.isfinite(hz.metrics.loss).all()
    assert np.asarray(hz.metrics.screened).shape == (2,)
    assert all(bool(torch.isfinite(t).all()) for t in tu.tree_leaves(state.z))
