"""Async group rounds on the port's sharded backend
(``repro_torch.launch.train``), on the CPU.

* Against the JAX package's sharded round (``repro.api.build(spec)`` with
  ``backend="sharded"``; its fused path runs the Pallas kernel in interpret
  mode) and, in lockstep, against the port's simulator engine (the analogue
  of ``tests/test_async_rounds.py::test_async_sharded_matches_simulator``),
  over the four policies x participation (full; 0.5/0.75 under both
  weightings) x {flat + fused, tree unfused}, the reference's masks
  injected: every state field (``round``, ``snap``, ``glob`` included) at
  the reference's parity tolerance (rtol 1e-5 in float32; z and y carry the
  params' atol through their quotients, ROADMAP queue 3 item 2), and the
  simulator at 1e-6. Timeouts (``dl``) and the defense likewise.
* The pieces: with ``train._CHUNK`` patched small, the piecewise merge,
  delay-compensated shift, y update, ``snap``/``glob`` writes and masked
  download equal the one-piece round bit for bit.
* bfloat16: float32 params with bf16 corrections against the reference
  (z and y within one bf16 ulp, with the entries that differ counted), and
  bf16 params, which the reference's round cannot carry (its masked mean
  promotes bf16 to float32 and its scan rejects the changed carry type):
  the port's merge is the float32 expression rounded once into bf16, bit
  for bit, and a per-operation bf16 shift would differ by at most one ulp
  (counted).
* The guard's rollback of the in-place async state, bit for bit.
* The trainer CLI with ``--E 2,1 --staleness-policy delay_compensated``.

The port's round updates its state in place, so every run starts from a
fresh state.
"""
import argparse
import dataclasses

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
from test_torch_async import (  # noqa: E402
    FAULT_SCENARIOS,
    P0,
    PARTICIPATION,
    POLICIES,
    _spec_pair,
    assert_close,
    field_np,
    make_batches,
    quad2,
)
from test_torch_faults import reference_draws  # noqa: E402
from test_torch_sharded import _bf16_ulps, _record_bf16_gap  # noqa: E402

from repro import api as japi  # noqa: E402
from repro.core import faults as jflt  # noqa: E402
from repro_torch import api as tapi  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import driver as tdrv  # noqa: E402
from repro_torch.core import tree as tu  # noqa: E402
from repro_torch.launch import train  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6
FIELDS = ("params", "z", "y", "snap", "glob")


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """One intra-op thread: the suite runs files in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _torch(b):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in b.items()}


def lockstep(jspec, tspec, T, seed):
    """``T`` windows of the reference's sharded round, the port's sharded
    round and the port's simulator engine, the reference's draws injected
    into both of the port's: every state field each window."""
    G, K = jspec.levels
    H, lr = jspec.schedule.local_steps, jspec.lr
    E = jspec.schedule.max_group_rounds
    plan = jspec.staleness_plan()
    atol = {"z": ATOL / (H * lr), "y": ATOL / (H * min(plan.effective_rounds) * lr)}
    jeng, teng = japi.build(jspec, quad2), tapi.build(tspec, quad2, device="cpu")
    sspec = dataclasses.replace(tspec, backend="simulator", schedule=dataclasses.replace(
        tspec.schedule, microbatches=None))
    seng = tapi.build(sspec, quad2, device="cpu")
    jst = jeng.init(jax.tree.map(jnp.asarray, P0), rng=jax.random.PRNGKey(seed))
    tst = teng.init(convert.params_from_numpy(P0, "cpu"))
    sst = seng.init(convert.params_from_numpy(P0, "cpu"))
    jround = jax.jit(jeng.round_fn)
    for r in range(T):
        b = make_batches((E, H, 1, G, K), seed + r)
        draws = reference_draws(jst.rng, jspec.to_hfl_config(), jspec.faults, None, [])
        jst, jm = jround(jst, jax.tree.map(jnp.asarray, b))
        tst, tm = teng.round_fn(tst, _torch(b), draws=draws)
        sst, sm = seng.round_fn(sst, _torch({k: v[:, :, 0] for k, v in b.items()}), draws=draws)
        for f in FIELDS:
            want = getattr(jst, f)
            if want is None:
                assert getattr(tst, f) is None, f
                continue
            got = field_np(getattr(tst, f))
            assert_close(got, field_np(want), RTOL, atol.get(f, ATOL), f"window {r}: {f}")
            assert_close(got, field_np(getattr(sst, f)), 1e-6, 1e-6, f"window {r}: {f} (sim)")
        for f in ("round", "dl"):
            want = getattr(jst, f)
            assert (getattr(tst, f) is None) == (want is None), f
            if want is not None:
                np.testing.assert_array_equal(getattr(tst, f).numpy(), np.asarray(want), f)
        for f in ("loss", "participation", "comm_bytes", "grad_norm"):
            assert_close(getattr(tm, f).numpy(), np.asarray(getattr(jm, f)), RTOL, ATOL,
                         f"window {r}: metric {f}")
        assert float(tm.screened) == float(jm.screened), f"window {r}: screened"
        np.testing.assert_allclose(tm.loss.numpy(), sm.loss.numpy(), rtol=1e-6)
    return tst


@pytest.mark.parametrize("participation", sorted(PARTICIPATION))
@pytest.mark.parametrize("layout,fusion", [("flat", "fused"), ("tree", "none")])
@pytest.mark.parametrize("policy", POLICIES)
def test_sharded_async_matches_reference_and_simulator(policy, layout, fusion, participation):
    extra = dict(state_layout=layout, fusion=fusion, **PARTICIPATION[participation])
    jspec, tspec = _spec_pair(4, 3, (3, 2, 1, 2), 2, policy, extra, backend="sharded", A=1)
    tst = lockstep(jspec, tspec, 3, seed=17)
    assert (tst.round is None) == (policy == "sync")


@pytest.mark.parametrize("cp", [1.0, 0.6])
@pytest.mark.parametrize("layout,fusion", [("flat", "fused"), ("tree", "none")])
@pytest.mark.parametrize("scenario", ["timeout", "crash-timeout-explode-screen-clip"])
def test_sharded_async_faults_match_reference(scenario, layout, fusion, cp):
    """Timeouts under an async schedule (``dl``) and the defense on the
    sharded round, fault masks injected, delay-compensated."""
    sc = FAULT_SCENARIOS[scenario]
    jf = jflt.FaultPlan(**sc["faults"])
    jd = None if sc["defense"] is None else jflt.DefensePlan(**sc["defense"])
    extra = dict(state_layout=layout, fusion=fusion, client_participation=cp)
    jspec, tspec = _spec_pair(3, 3, (3, 2, 1), 2, "delay_compensated", extra, backend="sharded",
                              faults=jf, defense=jd, A=1)
    tst = lockstep(jspec, tspec, 4, seed=int(cp * 10) + len(scenario))
    assert tst.dl is not None


PIECE_CASES = {
    "dc-full": dict(staleness="delay_compensated"),
    "discount-ht": dict(staleness="discount", client_participation=0.5,
                        participation_weighting="inverse_prob"),
    "dc-timeout-defended": dict(staleness="delay_compensated", client_participation=0.6,
                                faults=tapi.FaultPlan(crash_rate=0.2, timeout_rate=0.4,
                                                      corrupt_rate=0.3, corrupt_kind="nan"),
                                defense=tapi.DefensePlan(screen_norm=20.0, clip_norm=2.0)),
}


def _same_bits(a, b, tag):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, tag
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=tag)
    np.testing.assert_array_equal(a.reshape(-1).view(np.uint8), b.reshape(-1).view(np.uint8),
                                  err_msg=tag)


@pytest.mark.parametrize("case", sorted(PIECE_CASES))
@pytest.mark.parametrize("layout", ["flat", "tree"])
def test_piecewise_async_round_equals_one_piece_round(monkeypatch, layout, case):
    """Three windows with every row cut into pieces of 4 elements give the
    bits of the windows with one piece a row: the recovered reports, the
    delay-compensated shift, the merge, y, the masked download, snap, glob,
    dl and the round counter."""
    kw = dict(PIECE_CASES[case])
    spec = tapi.ExperimentSpec(levels=(3, 2), backend="sharded", lr=0.05, state_layout=layout,
                               fusion="fused", schedule=tapi.RoundSchedule(
                                   group_rounds=(2, 1, 2), local_steps=2, microbatches=1), **kw)
    outs = []
    for chunk in (1 << 26, 4):
        monkeypatch.setattr(train, "_CHUNK", chunk)
        eng = tapi.build(spec, quad2, device="cpu")
        state = eng.init(convert.params_from_numpy(P0, "cpu"),
                         torch.Generator().manual_seed(5) if eng._needs_rng() else None)
        mets = []
        for r in range(3):
            state, m = eng.round_fn(state, _torch(make_batches((2, 2, 1, 3, 2), 60 + r)))
            mets.append(convert.to_numpy(m))
        outs.append((convert.to_numpy(state), mets))
    (want, wm), (got, gm) = outs
    assert sorted(want) == sorted(got)
    for name, v in want.items():
        if isinstance(v, dict):
            for leaf in v:
                _same_bits(got[name][leaf], v[leaf], f"{name}/{leaf}")
        else:
            _same_bits(got[name], v, name)
    for a, b in zip(gm, wm):
        for f, v in b.items():
            if f in ("grad_norm", "z_norm", "y_norm"):
                np.testing.assert_allclose(a[f], v, rtol=1e-6, err_msg=f)
            else:
                _same_bits(a[f], v, f)


def test_bf16_corrections_dc_round_matches_reference(record_property):
    """Float32 params with bf16 z and y (``correction_dtype``, tree),
    delay-compensated, two windows against the reference: params at rtol
    1e-5; z and y within one bf16 ulp (each side rounds its own float32
    value, which agree to float32 rounding), the count of entries that
    differ recorded."""
    G, K, H, lr = 2, 2, 2, 0.05
    kw = dict(levels=(G, K), backend="sharded", lr=lr, state_layout="tree",
              correction_dtype="bfloat16", staleness="delay_compensated")
    jspec = japi.ExperimentSpec(schedule=japi.RoundSchedule(group_rounds=(2, 1), local_steps=H,
                                                            microbatches=1), **kw)
    tspec = tapi.ExperimentSpec(schedule=tapi.RoundSchedule(group_rounds=(2, 1), local_steps=H,
                                                            microbatches=1), **kw)
    jeng, teng = japi.build(jspec, quad2), tapi.build(tspec, quad2, device="cpu")
    js = jeng.init(jax.tree.map(jnp.asarray, P0))
    ts = teng.init(convert.params_from_numpy(P0, "cpu"))
    assert ts.z["w"].dtype == torch.bfloat16 and ts.snap["w"].dtype == torch.float32
    for r in range(2):
        b = make_batches((2, H, 1, G, K), 70 + r)
        js, _ = jeng.round_fn(js, jax.tree.map(jnp.asarray, b))
        ts, _ = teng.round_fn(ts, _torch(b))
    for name in ("params", "snap", "glob"):
        assert_close(field_np(getattr(ts, name)), field_np(getattr(js, name)), RTOL, ATOL, name)
    for name in ("z", "y"):
        for leaf in P0:
            got = getattr(ts, name)[leaf].float().numpy()
            want = np.asarray(getattr(js, name)[leaf], np.float32)
            np.testing.assert_allclose(got, want, rtol=2.0 ** -8, atol=1e-6, err_msg=name)
            assert _record_bf16_gap(record_property, f"{name}_{leaf}", got, want) <= 1


def test_bf16_params_dc_merge_is_the_float32_expression_rounded_once(monkeypatch,
                                                                      record_property):
    """bf16 params (glm4-9b's storage), flat, delay-compensated, in pieces:
    a window whose local work is the identity (zero gradient, zero z and y)
    leaves only the global step, from a state with stale snapshots. The
    port's result is, bit for bit, the reference's expression evaluated in
    float32 and rounded once into bf16: the shift ``xbar_j + (glob -
    snap_j)``, the weighted merge, each observed group's y update with its
    own coefficient, the download, snap and glob. Rounding the shift's
    difference to bf16 first (a per-operation bf16 evaluation, which XLA
    need not do) moves some entries by one bf16 ulp; they are counted."""
    monkeypatch.setattr(train, "_CHUNK", 4)
    G, K, N, lr, H = 2, 2, 11, 0.05, 2
    rng = np.random.default_rng(8)

    def bf(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)

    grp = bf(rng.normal(size=(G, N)))
    params = grp[:, None].expand(G, K, N).contiguous()
    snap, glob = bf(rng.normal(size=(G, N))), bf(rng.normal(size=N))
    template = {"w": torch.zeros(N, dtype=torch.bfloat16)}
    from repro_torch.core.packer import FlatBuffers, make_packer
    packer = make_packer(template)
    fb = lambda t: FlatBuffers({"bfloat16": t.clone()}, packer)            # noqa: E731
    state = train.ShardedHFLState(
        params=fb(params), z=fb(torch.zeros(G, K, N, dtype=torch.bfloat16)),
        y=fb(torch.zeros(G, N, dtype=torch.bfloat16)), round=torch.tensor(1, dtype=torch.int32),
        snap=fb(snap), glob=fb(glob))
    spec = tapi.ExperimentSpec(levels=(G, K), backend="sharded", lr=lr, state_layout="flat",
                               fusion="fused", staleness="delay_compensated",
                               schedule=tapi.RoundSchedule(group_rounds=(2, 1), local_steps=H,
                                                           microbatches=1))
    eng = tapi.build(spec, lambda p, b: 0.0 * torch.sum(p["w"].float() * b["a"]), device="cpu")
    new, _ = eng.round_fn(state, {"a": torch.ones(2, H, 1, G, K, N)})
    # The window t = 1 of periods (1, 2): both groups report, group 1 one
    # window stale. The reference's expression in float32, rounded once.
    f = lambda t: t.float().numpy()                                       # noqa: E731
    used32 = f(grp) + (f(glob)[None] - f(snap))
    used = f(bf(used32))
    plan = spec.staleness_plan()
    w = plan.discount_weights()
    xbar = (used * w[:, None]).sum(axis=0, dtype=np.float32) / np.float32(w.sum())
    coef = [np.float32(1.0) / (np.float32(e) * np.float32(H) * np.float32(lr))
            for e in plan.effective_rounds]
    y = np.stack([f(bf((used[g] - xbar) * coef[g])) for g in range(G)])
    want = {"params": np.broadcast_to(f(bf(xbar)), (G, K, N)),
            "snap": np.broadcast_to(f(bf(xbar)), (G, N)), "glob": f(bf(xbar)), "y": y}
    for name, v in want.items():
        got = f(getattr(new, name).bufs["bfloat16"])
        _same_bits(got, np.ascontiguousarray(v, np.float32), name)
    assert int(new.round) == 2
    # A per-operation bf16 shift: at most one bf16 ulp from the rounded-once
    # one, in the entries counted here.
    per_op = f(bf(f(grp) + f(bf(f(glob)[None] - f(snap)))))
    ulps = _bf16_ulps(per_op, used)
    record_property("per_op_shift_entries_differ", int((ulps > 0).sum()))
    record_property("per_op_shift_max_bf16_ulps", int(ulps.max()))
    assert ulps.max() <= 1


def test_sharded_guard_restores_the_in_place_async_state():
    """The in-place async round under the guard: each retry starts from the
    snapshot's bits, ``round``, ``snap``, ``glob`` and ``dl`` included."""
    spec = tapi.ExperimentSpec(
        levels=(2, 2), backend="sharded", lr=0.05, state_layout="flat", fusion="fused",
        schedule=tapi.RoundSchedule(group_rounds=(2, 1), local_steps=1, microbatches=1),
        staleness="delay_compensated",
        faults=tapi.FaultPlan(timeout_rate=0.3, corrupt_rate=0.999, corrupt_kind="nan"))
    eng = tapi.build(spec, quad2, device="cpu")
    state = eng.init(convert.params_from_numpy(P0, "cpu"), torch.Generator().manual_seed(3))
    # A first window without corruption moves snap, glob, dl and the counter.
    clean = tapi.build(dataclasses.replace(spec, faults=tapi.FaultPlan(timeout_rate=0.3)),
                       quad2, device="cpu")
    state, _ = clean.round_fn(state, _torch(make_batches((2, 1, 1, 2, 2), 80)))
    want = [t.clone() for t in tdrv._state_tensors(state)]
    arrays = {k: torch.from_numpy(v[0, 0]) for k, v in make_batches((1, 1, 2, 2, 4, 1), 81)
              .items()}                                          # [G, K, S, H, ...]
    data = tdrv.PackedBatches(arrays, torch.Generator().manual_seed(9), 2, 1, microbatches=1)
    starts = []

    def spy(st, batches, **kw):
        starts.append([t.clone() for t in tdrv._state_tensors(st)])
        return eng.round_fn(st, batches, **kw)

    with pytest.raises(RuntimeError, match="exhausted 2 retries"):
        tdrv.run_rounds(spy, state, data, 2, chunk=2,
                        guard=tdrv.GuardSpec(max_retries=2, round_fn_for_retry=lambda a: spy))
    assert len(starts) == 6
    assert {"round", "snap", "glob", "dl"} <= {f for f in state._fields
                                               if isinstance(getattr(state, f), torch.Tensor)
                                               or hasattr(getattr(state, f), "bufs")}
    for attempt in (0, 2, 4):
        for got, w in zip(starts[attempt], want):
            assert torch.equal(got, w) or (got.is_floating_point()
                                           and torch.equal(got.view(torch.uint8),
                                                           w.view(torch.uint8)))


def test_train_cli_async(capsys):
    """``python -m repro_torch.launch.train --E 2,1 --staleness-policy
    delay_compensated --max-staleness 1``: the trainer builds the spec the
    reference's CLI builds from ``--group-rounds 2,1`` and trains it on the
    CPU, its snapshots and window counter in the state."""
    from repro.core import api as jcore

    args = ["--staleness-policy", "delay_compensated", "--max-staleness", "1"]
    tap, jap = argparse.ArgumentParser(), argparse.ArgumentParser()
    tapi.add_spec_args(tap)
    jcore.add_spec_args(jap)
    tspec = tapi.spec_from_args(tap.parse_args(["--E", "2,1"] + args))
    jspec = jcore.spec_from_args(jap.parse_args(["--group-rounds", "2,1"] + args))
    assert tspec.schedule.group_rounds == jspec.schedule.group_rounds == (2, 1)
    for f in ("staleness", "max_staleness", "levels"):
        assert getattr(tspec, f) == getattr(jspec, f), f
    assert tapi.spec_from_args(tap.parse_args(["--E", "3"])).schedule.group_rounds == 3
    state, hz = train.main(["--arch", "glm4-9b", "--smoke", "--rounds", "2", "--device", "cpu",
                            "--seq", "32", "--shards", "2", "--E", "2,1"] + args)
    out = capsys.readouterr().out
    assert "[train] arch=glm4-9b" in out
    assert np.isfinite(hz.metrics.loss).all() and hz.metrics.loss.shape == (2, 2, 2)
    assert int(state.round) == 2 and state.snap is not None and state.glob is not None
    assert all(bool(torch.isfinite(t).all()) for t in tu.tree_leaves(state.snap))


@pytest.mark.parametrize("layout", ["flat", "tree"])
def test_async_sharded_state_crosses_through_numpy(layout):
    """A reference sharded async state (window counter, snap, glob, dl)
    crosses into the port through ``convert.sharded_state_from_numpy`` and
    the next window agrees with the reference's."""
    jf = jflt.FaultPlan(timeout_rate=0.4)
    jspec, tspec = _spec_pair(3, 2, (2, 1, 2), 2, "delay_compensated",
                              dict(state_layout=layout), backend="sharded", faults=jf, A=1)
    jeng, teng = japi.build(jspec, quad2), tapi.build(tspec, quad2, device="cpu")
    js = jeng.init(jax.tree.map(jnp.asarray, P0), rng=jax.random.PRNGKey(6))
    jround = jax.jit(jeng.round_fn)
    b = make_batches((2, 2, 1, 3, 2), 90)
    for _ in range(2):
        js, _ = jround(js, jax.tree.map(jnp.asarray, b))

    def host(f):
        return ({k: np.asarray(v) for k, v in f.bufs.items()} if hasattr(f, "bufs")
                else jax.tree.map(np.asarray, f))

    ts = convert.sharded_state_from_numpy(
        host(js.params), host(js.z), host(js.y), round=int(js.round), snap=host(js.snap),
        glob=host(js.glob), dl=np.asarray(js.dl), device="cpu",
        template=P0 if layout == "flat" else None)
    assert int(ts.round) == 2 and ts.dl.dtype == torch.float32
    draws = reference_draws(js.rng, jspec.to_hfl_config(), jspec.faults, None, [])
    js, _ = jround(js, jax.tree.map(jnp.asarray, b))
    ts, _ = teng.round_fn(ts, _torch(b), draws=draws)
    for f in FIELDS:
        assert_close(field_np(getattr(ts, f)), field_np(getattr(js, f)), RTOL, 1e-5, f)
    np.testing.assert_array_equal(ts.dl.numpy(), np.asarray(js.dl))
    assert int(ts.round) == int(js.round)
