"""Fault injection, screened aggregation and the guarded horizon on the
port's simulator engine, against the JAX package, on the CPU.

* ``core.faults``: the plans field for field and their validation; the mask
  draws (a ``torch.Generator``; a disabled plan draws nothing); the
  primitives (``corrupt_uploads``, ``all_finite_mask``,
  ``client_delta_sq_norm``, ``screen_and_clip``) against the reference's
  on the same inputs.
* The engine: every case of ``tests/test_faults.py`` (but the benchmark
  claim) against ``oracle.mtgc_faulty_run`` at that file's tolerances, and
  against the reference engine itself at its parity tolerance (rtol 1e-5
  in float32; z and y carry the params' atol through their quotients,
  ROADMAP queue 3 item 2), with the reference's fault masks injected
  (``RoundDraws(faults=)``): :func:`reference_draws` replays the reference
  round's key schedule (``round_masks``, then ``fault_masks``, then the
  compression noise). ``screened`` counts and NaN positions exactly; a
  disabled plan bit-exact with no plan.
* The guarded horizon (``core.driver``): zero faults bit-exact with an
  empty report, exhaustion, recovery with rollbacks recorded, the retry's
  reseeded draws, and ``retry_round_fn``; ``fit(guard=True)``.
"""
import dataclasses
import re

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
from oracle import mtgc_faulty_run  # noqa: E402
from test_faults import make_batches, np_grad, replay_masks  # noqa: E402
from test_faults import run_engine as jrun_engine  # noqa: E402
from test_torch_compression import reference_draws as compression_draws  # noqa: E402

from repro import api as japi  # noqa: E402
from repro.core import as_tree as jas_tree  # noqa: E402
from repro.core import compression as jcmp  # noqa: E402
from repro.core import faults as jflt  # noqa: E402
from repro.core import participation as jpart  # noqa: E402
from repro.core.config import HFLConfig as JHFLConfig  # noqa: E402
from repro_torch import api as tapi  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import driver as tdrv  # noqa: E402
from repro_torch.core import faults as tflt  # noqa: E402
from repro_torch.core.config import HFLConfig  # noqa: E402
from repro_torch.core.engine import RoundDraws, _build_global_round, hfl_init  # noqa: E402
from repro_torch.core.packer import as_tree  # noqa: E402
from repro_torch.core.participation import ParticipationMasks  # noqa: E402

D = 5
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """One intra-op thread: the suite runs files in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def quad_loss(params, batch):
    """``tests/test_faults.py``'s quadratic, for either package."""
    mod = torch if isinstance(params["w"], torch.Tensor) else jnp
    r = batch["a"] * params["w"] - batch["b"]
    return 0.5 * mod.sum(r * r)


def _t(a):
    return torch.from_numpy(np.array(a))


def _tplan(p):
    """The port's plan with a reference plan's fields (None stays None)."""
    if p is None:
        return None
    cls = {jflt.FaultPlan: tflt.FaultPlan, jflt.DefensePlan: tflt.DefensePlan,
           jcmp.CompressionPlan: tapi.CompressionPlan}[type(p)]
    return cls(**dataclasses.asdict(p))


def reference_draws(jrng, jcfg, faults=None, comp=None, sizes=()):
    """The draws the reference simulator round makes from ``jrng``: the
    participation masks, then the fault masks, then the compression noise
    (``test_torch_compression.reference_draws``' schedule)."""
    rng, masks, fm = jrng, None, None
    if not jcfg.full_participation:
        jm, rng = jpart.round_masks(rng, jcfg)
        masks = ParticipationMasks(_t(jm.group), _t(jm.client))
    if faults is not None and faults.enabled:
        m, rng = jflt.fault_masks(rng, faults, jcfg.num_groups, jcfg.clients_per_group)
        fm = tflt.FaultMasks(_t(m.crash), _t(m.timeout), _t(m.corrupt))
    full = dataclasses.replace(jcfg, client_participation=1.0, group_participation=1.0)
    noise = compression_draws(rng, full, comp, list(sizes))
    return RoundDraws(masks=masks, client_noise=noise.client_noise,
                      group_noise=noise.group_noise, faults=fm)


def _w(field):
    return convert.to_numpy(as_tree(field))["w"]


def assert_close(got, want, rtol, atol, tag):
    """allclose with NaN positions required equal."""
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want), err_msg=f"{tag}: NaN positions")
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=tag)


def run_port(cfg, plan, defense, batches, masks, comp=None, noise=None):
    """The port's round over the reference's realization ``masks`` ([T] of
    (crash, timeout, corrupt)); returns (state, screened total, metrics)."""
    rf = _build_global_round(quad_loss, cfg, faults=plan, defense=defense, compression=comp)
    state = hfl_init({"w": torch.zeros(D)}, cfg, None, device="cpu")
    b = {k: _t(v) for k, v in batches.items()}
    scr, mets = 0.0, []
    for t, (c, tm, u) in enumerate(zip(*masks)):
        state, m = rf(state, b, draws=RoundDraws(faults=tflt.FaultMasks(_t(c), _t(tm), _t(u))))
        scr += float(m.screened)
        mets.append(m)
    return state, scr, mets


def _cfgs(**kw):
    return HFLConfig(**kw), JHFLConfig(**kw)


# --------------------------------------------------------- primitives


def test_plans_are_the_reference_plans():
    for tcls, jcls in ((tflt.FaultPlan, jflt.FaultPlan), (tflt.DefensePlan, jflt.DefensePlan)):
        assert ([(f.name, f.default) for f in dataclasses.fields(tcls)]
                == [(f.name, f.default) for f in dataclasses.fields(jcls)])
    assert tflt.FAULT_KINDS == jflt.FAULT_KINDS
    for kw in (dict(), dict(crash_rate=0.1), dict(timeout_rate=0.1), dict(corrupt_rate=0.1)):
        assert tflt.FaultPlan(**kw).enabled == jflt.FaultPlan(**kw).enabled
    for kw in (dict(), dict(screen_nonfinite=False), dict(screen_nonfinite=False, clip_norm=1.0)):
        assert tflt.DefensePlan(**kw).enabled == jflt.DefensePlan(**kw).enabled


def test_fault_masks_deterministic_and_draw_discipline():
    plan = tflt.FaultPlan(crash_rate=0.3, timeout_rate=0.2, corrupt_rate=0.1)
    g1, g2 = torch.Generator().manual_seed(7), torch.Generator().manual_seed(7)
    m1, m2 = tflt.fault_masks(g1, plan, 3, 4), tflt.fault_masks(g2, plan, 3, 4)
    assert all(torch.equal(a, b) for a, b in zip(m1, m2))
    assert torch.equal(g1.get_state(), g2.get_state())
    assert m1.crash.shape == (3, 4) and m1.timeout.shape == (3,) and m1.corrupt.shape == (3, 4)
    assert all(set(t.unique().tolist()) <= {0.0, 1.0} for t in m1)
    # Crash, timeout, corrupt, each a uniform draw compared with its rate.
    g3 = torch.Generator().manual_seed(7)
    for t, rate, shape in zip(m1, (0.3, 0.2, 0.1), ((3, 4), (3,), (3, 4))):
        assert torch.equal(t, (torch.rand(shape, generator=g3) < rate).float())
    # A disabled plan draws nothing (the zero-fault stream is untouched).
    g4 = torch.Generator().manual_seed(7)
    z = tflt.fault_masks(g4, tflt.FaultPlan(), 3, 4)
    assert torch.equal(g4.get_state(), torch.Generator().manual_seed(7).get_state())
    assert all(not t.any() for t in z)


def test_zero_rate_masks_are_exact_zeros():
    m = tflt.fault_masks(torch.Generator().manual_seed(0), tflt.FaultPlan(corrupt_rate=0.5), 2, 3)
    assert not m.crash.any() and not m.timeout.any()


def test_plan_validation():
    for bad in (lambda: tflt.FaultPlan(crash_rate=1.0).validate(),
                lambda: tflt.FaultPlan(corrupt_kind="zeroed").validate(),
                lambda: tflt.FaultPlan(explode_factor=1.0).validate(),
                lambda: tflt.DefensePlan(screen_norm=-1.0).validate(),
                lambda: tflt.DefensePlan(clip_norm=0.0).validate(),
                lambda: tflt.DefensePlan(retry_widen=1.5).validate()):
        with pytest.raises(ValueError):
            bad()
    assert not tflt.FaultPlan().enabled
    assert tflt.FaultPlan(timeout_rate=0.1).enabled


@pytest.mark.parametrize("kind", ["nan", "inf", "explode"])
def test_primitives_match_reference(kind):
    """corrupt_uploads, all_finite_mask, client_delta_sq_norm and
    screen_and_clip (screen and clip) on the same inputs as the reference:
    clean uploads keep their exact bits, NaN positions equal."""
    rng = np.random.default_rng(3)
    xs = {"a": rng.normal(size=(2, 3, 4)).astype(np.float32),
          "b": rng.normal(size=(2, 3, 2, 3)).astype(np.float32)}
    xe = {k: v + rng.normal(size=v.shape).astype(np.float32) for k, v in xs.items()}
    bad = np.array([[1, 0, 0], [0, 1, 1]], np.float32)
    fp = dict(corrupt_rate=0.5, corrupt_kind=kind, explode_factor=50.0)
    jup = jflt.corrupt_uploads(xs, xe, jnp.asarray(bad), jflt.FaultPlan(**fp))
    tup = tflt.corrupt_uploads(convert.params_from_numpy(xs, "cpu"),
                               convert.params_from_numpy(xe, "cpu"), _t(bad),
                               tflt.FaultPlan(**fp))
    for k in xs:
        assert_close(tup[k].numpy(), np.asarray(jup[k]), RTOL, 0.0, f"corrupt {k}")
        np.testing.assert_array_equal(tup[k].numpy()[bad == 0], xe[k][bad == 0])
    np.testing.assert_array_equal(tflt.all_finite_mask(tup, 2).numpy(),
                                  np.asarray(jflt.all_finite_mask(jup, 2)))
    delta = {k: v - xs[k] for k, v in xe.items()}
    np.testing.assert_allclose(
        tflt.client_delta_sq_norm(convert.params_from_numpy(delta, "cpu")).numpy(),
        np.asarray(jflt.client_delta_sq_norm(delta)), rtol=RTOL)
    for dp in (dict(screen_norm=30.0), dict(clip_norm=2.0), dict(screen_norm=1e3, clip_norm=3.0),
               dict(screen_nonfinite=False, clip_norm=1.0)):
        jx, jok = jflt.screen_and_clip(xs, jup, jflt.DefensePlan(**dp))
        tx, tok = tflt.screen_and_clip(convert.params_from_numpy(xs, "cpu"), tup,
                                       tflt.DefensePlan(**dp))
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jok), err_msg=str(dp))
        for k in xs:
            assert_close(tx[k].numpy(), np.asarray(jx[k]), RTOL, 1e-6, f"{dp} {k}")


def test_screen_and_clip_primitives():
    """tests/test_faults.py::test_screen_and_clip_primitives on the port."""
    x0 = {"w": torch.zeros((1, 3, 4))}
    delta = np.zeros((1, 3, 4), np.float32)
    delta[0, 0] = 1.0                     # norm 2, fine
    delta[0, 1] = np.nan                  # non-finite
    delta[0, 2] = 100.0                   # norm 200, over any threshold
    x_up = {"w": _t(delta)}
    scr, ok = tflt.screen_and_clip(x0, x_up, tflt.DefensePlan(screen_norm=10.0))
    np.testing.assert_array_equal(ok.numpy(), [[1.0, 0.0, 0.0]])
    np.testing.assert_array_equal(scr["w"].numpy()[0, 0], delta[0, 0])
    clipped, ok2 = tflt.screen_and_clip(x0, x_up, tflt.DefensePlan(clip_norm=1.0))
    assert ok2[0, 1] == 0.0 and ok2[0, 2] == 1.0
    np.testing.assert_allclose(np.linalg.norm(clipped["w"].numpy()[0, 2]), 1.0, rtol=1e-5)
    assert tflt.all_finite_mask(x_up, 2).tolist() == [[1.0, 0.0, 1.0]]


def test_finiteness_comes_from_the_entries():
    """An ``explode`` delta with finite entries can overflow the float32
    squared norm: the norm screen takes it, the non-finite screen does not."""
    x0 = {"w": torch.zeros((1, 2, 3))}
    up = {"w": torch.tensor([[[1e20, 1e20, 1e20], [1.0, 0.0, 0.0]]])}
    assert torch.isinf(tflt.client_delta_sq_norm(up)[0, 0])
    _, ok = tflt.screen_and_clip(x0, up, tflt.DefensePlan())
    assert ok.tolist() == [[1.0, 1.0]]
    _, ok = tflt.screen_and_clip(x0, up, tflt.DefensePlan(screen_nonfinite=False,
                                                          screen_norm=1e3))
    assert ok.tolist() == [[0.0, 1.0]]
    assert tflt.all_finite(torch.tensor([1e38, 1e38]))
    assert not tflt.all_finite(torch.tensor([1.0, float("inf")]), piece=1)


# ------------------------------------------- zero-fault bit-exactness


@pytest.mark.parametrize("layout", ["tree", "flat"])
@pytest.mark.parametrize("cp", [1.0, 0.5])
def test_disabled_plan_is_bit_exact(layout, cp):
    """faults=FaultPlan() (all rates zero) runs the round without faults:
    states bitwise equal after several rounds, nothing screened."""
    G, K, E, H = 2, 3, 2, 2
    cfg = HFLConfig(num_groups=G, clients_per_group=K, local_steps=H, group_rounds=E,
                    lr=0.05, client_participation=cp, use_flat_state=layout == "flat")
    _, _, batches = make_batches(G, K, E, H)
    b = {k: _t(v) for k, v in batches.items()}
    plain = _build_global_round(quad_loss, cfg)
    gated = _build_global_round(quad_loss, cfg, faults=tflt.FaultPlan())
    s1 = hfl_init({"w": torch.zeros(D)}, cfg, torch.Generator().manual_seed(3), device="cpu")
    s2 = hfl_init({"w": torch.zeros(D)}, cfg, torch.Generator().manual_seed(3), device="cpu")
    for _ in range(3):
        s1, m1 = plain(s1, b)
        s2, m2 = gated(s2, b)
    for f in ("params", "z", "y", "dyn"):
        np.testing.assert_array_equal(_w(getattr(s1, f)), _w(getattr(s2, f)))
    assert torch.equal(m1.loss, m2.loss) and float(m2.screened) == 0.0
    assert torch.equal(s1.rng.get_state(), s2.rng.get_state())


# ------------------------------------------------ oracle, per fault kind


def _check_three(state, jstate, oracle, lr, H, E, z=True, tag=""):
    """The port against the reference engine (parity tolerance) and the
    oracle (``tests/test_faults.py``'s tolerances)."""
    x, zz, y = oracle[:3]
    atol = {"params": ATOL, "z": ATOL / (H * lr), "y": ATOL / (H * E * lr)}
    for f in ("params", "z", "y") if z else ("params", "y"):
        assert_close(_w(getattr(state, f)), np.asarray(jas_tree(getattr(jstate, f))["w"]),
                     RTOL, atol[f], f"{tag} {f} vs reference")
    assert_close(_w(state.params), x, 2e-4, 2e-5, f"{tag} params vs oracle")
    if z:
        assert_close(_w(state.z), zz, 2e-3, 2e-4, f"{tag} z vs oracle")
    assert_close(_w(state.y), y, 2e-3, 2e-4, f"{tag} y vs oracle")


@pytest.mark.parametrize("layout", ["tree", "flat"])
def test_crash_faults_match_oracle(layout):
    G, K, E, H, lr, T = 2, 3, 2, 2, 0.05, 3
    cfg, jcfg = _cfgs(num_groups=G, clients_per_group=K, local_steps=H, group_rounds=E, lr=lr,
                      use_flat_state=layout == "flat")
    a, b, batches = make_batches(G, K, E, H)
    plan = jflt.FaultPlan(crash_rate=0.4)
    jstate, _, rng0 = jrun_engine(jcfg, plan, None, batches, T)
    masks = replay_masks(rng0, plan, G, K, T)
    state, _, _ = run_port(cfg, _tplan(plan), None, batches, masks)
    oracle = mtgc_faulty_run(np.zeros(D), np_grad(a, b), G, K, E, H, lr, T, crash=masks[0])
    _check_three(state, jstate, oracle, lr, H, E)


def test_timeout_faults_match_oracle():
    G, K, E, H, lr, T = 3, 2, 2, 2, 0.05, 3
    cfg, jcfg = _cfgs(num_groups=G, clients_per_group=K, local_steps=H, group_rounds=E, lr=lr,
                      use_flat_state=False)
    a, b, batches = make_batches(G, K, E, H, seed=4)
    plan = jflt.FaultPlan(timeout_rate=0.4)
    jstate, _, rng0 = jrun_engine(jcfg, plan, None, batches, T)
    masks = replay_masks(rng0, plan, G, K, T)
    assert masks[1].sum() > 0
    state, _, _ = run_port(cfg, _tplan(plan), None, batches, masks)
    oracle = mtgc_faulty_run(np.zeros(D), np_grad(a, b), G, K, E, H, lr, T, timeout=masks[1])
    _check_three(state, jstate, oracle, lr, H, E, z=False)


@pytest.mark.parametrize("kind", ["explode", "nan"])
def test_corrupt_faults_match_oracle_defended(kind):
    G, K, E, H, lr, T = 2, 3, 2, 2, 0.05, 3
    cfg, jcfg = _cfgs(num_groups=G, clients_per_group=K, local_steps=H, group_rounds=E, lr=lr,
                      use_flat_state=False)
    a, b, batches = make_batches(G, K, E, H, seed=5)
    plan = jflt.FaultPlan(corrupt_rate=0.3, corrupt_kind=kind)
    defense = jflt.DefensePlan(screen_norm=50.0 if kind == "explode" else None)
    jstate, jscr, rng0 = jrun_engine(jcfg, plan, defense, batches, T)
    masks = replay_masks(rng0, plan, G, K, T)
    assert masks[2].sum() > 0
    state, scr, _ = run_port(cfg, _tplan(plan), _tplan(defense), batches, masks)
    oracle = mtgc_faulty_run(np.zeros(D), np_grad(a, b), G, K, E, H, lr, T, corrupt=masks[2],
                             corrupt_kind=kind, screen_nonfinite=True,
                             screen_norm=defense.screen_norm)
    assert scr == jscr == oracle[3] and scr > 0
    _check_three(state, jstate, oracle, lr, H, E)


def test_undefended_nan_corruption_poisons_undefended_only():
    """NaN uploads poison the model without the screen -- at the
    reference's NaN positions -- and never reach z/y with it."""
    G, K, E, H, T = 2, 3, 2, 2, 2
    cfg, jcfg = _cfgs(num_groups=G, clients_per_group=K, local_steps=H, group_rounds=E,
                      lr=0.05, use_flat_state=False)
    _, _, batches = make_batches(G, K, E, H, seed=6)
    plan = jflt.FaultPlan(corrupt_rate=0.3, corrupt_kind="nan")
    jbad, _, rng0 = jrun_engine(jcfg, plan, None, batches, T)
    masks = replay_masks(rng0, plan, G, K, T)
    bad_state, _, _ = run_port(cfg, _tplan(plan), None, batches, masks)
    w = _w(bad_state.params)
    assert not np.isfinite(w).all()
    atol = {"params": ATOL, "z": ATOL / (H * 0.05), "y": ATOL / (H * E * 0.05)}
    for f in ("params", "z", "y"):
        assert_close(_w(getattr(bad_state, f)), np.asarray(jas_tree(getattr(jbad, f))["w"]),
                     RTOL, atol[f], f)
    good_state, scr, _ = run_port(cfg, _tplan(plan), tflt.DefensePlan(), batches, masks)
    jgood, jscr, _ = jrun_engine(jcfg, plan, jflt.DefensePlan(), batches, T)
    assert scr == jscr > 0
    for leaf in (good_state.z, good_state.y):
        assert np.isfinite(_w(leaf)).all()


def test_screened_client_correction_stays_frozen():
    """A screened contribution never integrates: the corrupted client's z
    stays at its reset value (zero) for the faulted round."""
    G, K, E, H = 1, 3, 1, 2
    cfg = HFLConfig(num_groups=G, clients_per_group=K, local_steps=H, group_rounds=E,
                    lr=0.05, use_flat_state=False)
    _, _, batches = make_batches(G, K, E, H, seed=7)
    plan = jflt.FaultPlan(corrupt_rate=0.45, corrupt_kind="nan")
    fm, _ = jflt.fault_masks(jax.random.PRNGKey(1), plan, G, K)
    corrupt = np.asarray(fm.corrupt)
    assert corrupt.sum() > 0
    masks = ([np.asarray(fm.crash)], [np.asarray(fm.timeout)], [corrupt])
    state, _, _ = run_port(cfg, _tplan(plan), tflt.DefensePlan(), batches, masks)
    z = _w(state.z)
    for g in range(G):
        for k in range(K):
            if corrupt[g, k]:
                np.testing.assert_array_equal(z[g, k], 0.0)
            else:
                assert np.abs(z[g, k]).sum() > 0


@pytest.mark.parametrize("layout", ["tree", "flat"])
def test_fully_screened_group_reverts_not_poisons(layout):
    """Every upload of every group screened: the run is a frozen no-op --
    params stay x0, z and y zero, losses finite."""
    G, K, E, H, T = 2, 3, 2, 2, 2
    cfg = HFLConfig(num_groups=G, clients_per_group=K, local_steps=H, group_rounds=E,
                    lr=0.05, use_flat_state=layout == "flat")
    _, _, batches = make_batches(G, K, E, H, seed=9)
    plan = tflt.FaultPlan(corrupt_rate=0.999, corrupt_kind="nan")
    ones = np.ones((T, G, K), np.float32)
    masks = (0 * ones, np.zeros((T, G), np.float32), ones)
    state, scr, mets = run_port(cfg, plan, tflt.DefensePlan(), batches, masks)
    assert scr == T * E * G * K
    np.testing.assert_array_equal(_w(state.params), np.zeros((G, K, D)))
    np.testing.assert_array_equal(_w(state.z), np.zeros((G, K, D)))
    np.testing.assert_array_equal(_w(state.y), np.zeros((G, D)))
    assert all(torch.isfinite(m.loss).all() for m in mets)


@pytest.mark.parametrize("backend", ["simulator", "sharded"])
def test_async_timeout_matches_reference(backend):
    """A timeout under an async schedule goes through the staleness
    machinery, as in the reference: a timed-out group misses its report,
    and the realized-download mask ``state.dl`` carries freshness into the
    next window. Three windows on either engine against the reference
    engine, the fault masks injected: params, z, y, ``dl`` and the window
    counter."""
    from repro.core import as_tree as jtree

    G, K, E, H, lr = 3, 2, 2, 2, 0.05
    mb = 1 if backend == "sharded" else None
    kw = dict(levels=(G, K), backend=backend, lr=lr, staleness="discount")
    jspec = japi.ExperimentSpec(schedule=japi.RoundSchedule(group_rounds=(2, 1, 1),
                                                            local_steps=H, microbatches=mb),
                                faults=jflt.FaultPlan(timeout_rate=0.5), **kw)
    tspec = tapi.ExperimentSpec(schedule=tapi.RoundSchedule(group_rounds=(2, 1, 1),
                                                            local_steps=H, microbatches=mb),
                                faults=tapi.FaultPlan(timeout_rate=0.5), **kw)
    jeng, teng = japi.build(jspec, quad_loss), tapi.build(tspec, quad_loss, device="cpu")
    jstate = jeng.init({"w": jnp.zeros(D)}, rng=jax.random.PRNGKey(12))
    tstate = teng.init({"w": torch.zeros(D)})
    assert tstate.dl is not None
    for r in range(3):
        b = make_batches(G, K, E, H, seed=40 + r)[2]
        if backend == "sharded":
            b = {k: np.ascontiguousarray(np.asarray(v)[:, :, None]) for k, v in b.items()}
        draws = reference_draws(jstate.rng, jspec.to_hfl_config(), jspec.faults, None, [D])
        jstate, _ = jeng.round_fn(jstate, jax.tree.map(jnp.asarray, b))
        tstate, _ = teng.round_fn(tstate, {k: _t(v) for k, v in b.items()}, draws=draws)
        for f in ("params", "z", "y"):
            assert_close(_w(getattr(tstate, f)), np.asarray(jtree(getattr(jstate, f))["w"]),
                         RTOL, ATOL / (H * lr) if f != "params" else ATOL, f"round {r}: {f}")
        np.testing.assert_array_equal(tstate.dl.numpy(), np.asarray(jstate.dl))
        assert int(tstate.round) == int(jstate.round)


# ------------------------------- the engine against the reference engine


SCENARIOS = {
    "crash-timeout-explode-screen-clip": dict(
        faults=dict(crash_rate=0.2, timeout_rate=0.3, corrupt_rate=0.3, corrupt_kind="explode",
                    explode_factor=100.0),
        defense=dict(screen_norm=20.0, clip_norm=2.0)),
    "crash-nan-nonfinite": dict(
        faults=dict(crash_rate=0.2, corrupt_rate=0.3, corrupt_kind="nan"), defense=dict()),
    "inf-undefended": dict(faults=dict(corrupt_rate=0.3, corrupt_kind="inf"), defense=None),
    "defense-only-clip": dict(faults=None, defense=dict(screen_nonfinite=False, clip_norm=0.5)),
}


@pytest.mark.parametrize("cp", [1.0, 0.6])
@pytest.mark.parametrize("layout,fusion", [("flat", "fused"), ("tree", "none")])
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_faulty_rounds_match_reference_engine(scenario, layout, fusion, cp):
    """Three chained rounds through both packages' front doors with the
    reference's masks injected: every state field and metric at the parity
    tolerance, ``screened`` exactly, NaN positions exactly."""
    G, K, E, H, lr, T = 3, 3, 2, 2, 0.05, 3
    sc = SCENARIOS[scenario]
    jf = None if sc["faults"] is None else jflt.FaultPlan(**sc["faults"])
    jd = None if sc["defense"] is None else jflt.DefensePlan(**sc["defense"])
    kw = dict(levels=(G, K), lr=lr, state_layout=layout, fusion=fusion, client_participation=cp)
    jspec = japi.ExperimentSpec(schedule=japi.RoundSchedule(group_rounds=E, local_steps=H),
                                faults=jf, defense=jd, **kw)
    tspec = tapi.ExperimentSpec(schedule=tapi.RoundSchedule(group_rounds=E, local_steps=H),
                                faults=_tplan(jf), defense=_tplan(jd), **kw)
    _run_against_reference(jspec, tspec, T, seed=int(cp * 10) + len(scenario))


def _run_against_reference(jspec, tspec, T, seed, batches_fn=None, flips=0.0):
    G, K = jspec.levels
    E, H = jspec.schedule.group_rounds, jspec.schedule.local_steps
    jeng, teng = japi.build(jspec, quad_loss), tapi.build(tspec, quad_loss, device="cpu")
    jstate = jeng.init({"w": jnp.zeros(D)}, rng=jax.random.PRNGKey(seed))
    tstate = teng.init({"w": torch.zeros(D)})
    jround = jax.jit(jeng.round_fn)
    lr = jspec.lr
    atol = {"z": ATOL / (H * lr), "y": ATOL / (H * E * lr)}
    for r in range(T):
        batches = make_batches(G, K, E, H, seed=seed + r)[2] if batches_fn is None \
            else batches_fn(r)
        draws = reference_draws(jstate.rng, jeng._cfg, jspec.faults, jspec.compression, [D])
        jstate, jm = jround(jstate, jax.tree.map(jnp.asarray, batches))
        tstate, tm = teng.round_fn(tstate, {k: _t(v) for k, v in batches.items()}, draws=draws)
        for f in ("params", "z", "y", "efc", "efg"):
            want = getattr(jstate, f)
            if want is None:
                assert getattr(tstate, f) is None, f
                continue
            want, got = np.asarray(jas_tree(want)["w"]), _w(getattr(tstate, f))
            if flips:
                np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
                off = ~np.isclose(got, want, rtol=RTOL, atol=atol.get(f, ATOL), equal_nan=True)
                assert off.mean() <= flips, f"round {r}: {f}: {off.sum()} of {off.size} off"
            else:
                assert_close(got, want, RTOL, atol.get(f, ATOL), f"round {r}: {f}")
        assert float(tm.screened) == float(jm.screened), f"round {r}: screened"
        for f in ("loss", "client_drift", "group_drift", "participation", "comm_bytes",
                  "z_norm", "y_norm"):
            assert_close(np.asarray(getattr(tm, f)), np.asarray(getattr(jm, f)), RTOL,
                         ATOL if f not in ("z_norm", "y_norm") else 1e-4,
                         f"round {r}: metric {f}")
    return tstate, jstate


@pytest.mark.parametrize("comp", ["int8-int8", "topk-bf16"])
@pytest.mark.parametrize("kind", ["explode", "nan"])
def test_compress_corrupt_screen_order_matches_reference(comp, kind):
    """Compressed uploads under faults and the defense: the reference's
    compress -> corrupt -> screen order, residuals gated on the screen. A
    masked mean can turn one ulp into an int8 or bf16 step (ROADMAP queue 3
    item 4): 1% of a field's entries may lie off, NaN positions exact."""
    plans = {"int8-int8": dict(client_mode="int8_stochastic", group_mode="int8_stochastic"),
             "topk-bf16": dict(client_mode="topk", group_mode="bf16", topk_frac=0.4)}
    jf = jflt.FaultPlan(crash_rate=0.2, corrupt_rate=0.3, corrupt_kind=kind, explode_factor=50.0)
    jd = jflt.DefensePlan(screen_norm=30.0, clip_norm=3.0)
    jc = jcmp.CompressionPlan(**plans[comp])
    kw = dict(levels=(2, 3), lr=0.05, state_layout="flat", fusion="fused")
    jspec = japi.ExperimentSpec(schedule=japi.RoundSchedule(group_rounds=2, local_steps=2),
                                faults=jf, defense=jd, compression=jc, **kw)
    tspec = tapi.ExperimentSpec(schedule=tapi.RoundSchedule(group_rounds=2, local_steps=2),
                                faults=_tplan(jf), defense=_tplan(jd), compression=_tplan(jc),
                                **kw)
    tstate, _ = _run_against_reference(jspec, tspec, 3, seed=21, flips=0.01)
    assert np.isfinite(_w(tstate.y)).all()


# ------------------------------------------------------- guarded driver


def _toy_data(G, K, E, H, seed=0, gen_seed=9):
    rng = np.random.default_rng(seed)
    S = 4
    a = rng.normal(size=(G, K, S, H, D)).astype(np.float32) + 2.0
    b = rng.normal(size=(G, K, S, H, D)).astype(np.float32)
    return tdrv.PackedBatches({"a": _t(a), "b": _t(b)},
                              torch.Generator().manual_seed(gen_seed), E, H)


def _fields(state):
    return {f: _w(getattr(state, f)) for f in ("params", "z", "y", "dyn")}


@pytest.mark.parametrize("layout", ["tree", "flat"])
def test_guard_zero_fault_is_bit_exact_with_empty_report(layout):
    G, K, E, H = 2, 2, 2, 2
    cfg = HFLConfig(num_groups=G, clients_per_group=K, local_steps=H, group_rounds=E,
                    lr=0.05, use_flat_state=layout == "flat")
    rf = _build_global_round(quad_loss, cfg)
    s0 = hfl_init({"w": torch.zeros(D)}, cfg, device="cpu")
    s1, _, h1 = tdrv.run_rounds(rf, s0, _toy_data(G, K, E, H), 4, chunk=2)
    s2, _, h2 = tdrv.run_rounds(rf, s0, _toy_data(G, K, E, H), 4, chunk=2,
                                guard=tdrv.GuardSpec())
    for f, v in _fields(s1).items():
        np.testing.assert_array_equal(v, _fields(s2)[f])
    assert h1.guard is None
    assert (h2.guard.rollbacks, h2.guard.retries) == (0, 0)
    assert h2.guard.snapshot_bytes == sum(
        t.numel() * t.element_size() for t in tdrv._state_tensors(s0))


def test_guard_rolls_back_and_exhausts():
    """An always-NaN round diverges every attempt: the guard retries
    ``max_retries`` times from the restored snapshot, then raises."""
    G, K, E, H = 2, 2, 1, 1
    cfg = HFLConfig(num_groups=G, clients_per_group=K, local_steps=H, group_rounds=E,
                    lr=0.05, use_flat_state=False)
    rf = _build_global_round(quad_loss, cfg,
                             faults=tflt.FaultPlan(corrupt_rate=0.999, corrupt_kind="nan"))
    s0 = hfl_init({"w": torch.zeros(D)}, cfg, torch.Generator().manual_seed(0), device="cpu")
    want = {f: v.copy() for f, v in _fields(s0).items()}
    seen = []

    def spy(state, batches, **kw):
        seen.append({f: v.copy() for f, v in _fields(state).items()})
        return rf(state, batches, **kw)

    guard = tdrv.GuardSpec(max_retries=2, round_fn_for_retry=lambda a: spy)
    with pytest.raises(RuntimeError, match="exhausted 2 retries"):
        tdrv.run_rounds(spy, s0, _toy_data(G, K, E, H), 2, chunk=2, guard=guard)
    # Three attempts of the 2-round chunk, each starting from the snapshot.
    assert len(seen) == 6
    for attempt in (0, 2, 4):
        for f, v in want.items():
            np.testing.assert_array_equal(seen[attempt][f], v)


def test_guard_recovers_via_reseeded_generators():
    """At a moderate fault rate a retry (reseeded generators) draws a clean
    chunk: the run completes finite with rollbacks recorded, and the same
    seeds give the same run."""
    G, K, E, H = 2, 3, 2, 2
    cfg = HFLConfig(num_groups=G, clients_per_group=K, local_steps=H, group_rounds=E,
                    lr=0.05, use_flat_state=False)
    rf = _build_global_round(quad_loss, cfg,
                             faults=tflt.FaultPlan(corrupt_rate=0.05, corrupt_kind="nan"))
    runs = []
    for _ in range(2):
        s0 = hfl_init({"w": torch.zeros(D)}, cfg, torch.Generator().manual_seed(1), device="cpu")
        state, _, hz = tdrv.run_rounds(rf, s0, _toy_data(G, K, E, H, seed=1), 10, chunk=2,
                                       guard=tdrv.GuardSpec(max_retries=6))
        assert np.isfinite(hz.metrics.loss).all()
        assert np.isfinite(_w(state.params)).all()
        assert hz.guard.rollbacks > 0 and hz.guard.retries >= hz.guard.rollbacks
        runs.append(_w(state.params))
    np.testing.assert_array_equal(runs[0], runs[1])


def test_retry_reseeds_state_and_data_generators():
    """A retry starts from the snapshot's tensors with both generators
    reseeded from (their snapshot, salt): another draw than the first
    attempt's, the same for the same salt."""
    G, K, E, H = 2, 2, 1, 1
    cfg = HFLConfig(num_groups=G, clients_per_group=K, local_steps=H, group_rounds=E, lr=0.05,
                    use_flat_state=False)
    s0 = hfl_init({"w": torch.zeros(D)}, cfg, torch.Generator().manual_seed(5), device="cpu")
    data = _toy_data(G, K, E, H)
    snap = tdrv._HostSnapshot()
    snap.take(s0, data)
    first = torch.rand(4, generator=s0.rng)
    tdrv.draw_shard_ids(data)
    s1 = snap.restore(s0, data, salt=7)
    again = torch.rand(4, generator=s1.rng)
    assert not torch.equal(first, again)
    snap.restore(s0, data, salt=7)
    assert torch.equal(torch.rand(4, generator=s0.rng), again)
    assert snap.nbytes > 0 and snap.seconds >= 0.0


def _api_fixture(faults=None, defense=None, backend="simulator", layout="tree"):
    G, K = 2, 3
    spec = tapi.ExperimentSpec(
        levels=(G, K), lr=0.02, backend=backend, state_layout=layout,
        schedule=tapi.RoundSchedule(group_rounds=2, local_steps=2,
                                    microbatches=1 if backend == "sharded" else None),
        faults=faults, defense=defense)
    engine = tapi.build(spec, quad_loss, device="cpu")
    rng = np.random.default_rng(0)
    X = {"a": rng.normal(size=(G * K * 64, D)).astype(np.float32) + 2.0,
         "b": rng.normal(size=(G * K * 64, D)).astype(np.float32)}
    idx = [[np.arange((g * K + k) * 64, (g * K + k + 1) * 64) for k in range(K)]
           for g in range(G)]
    data = engine.pack_arrays(X, idx, batch_size=8, rng=np.random.default_rng(1),
                              generator=torch.Generator().manual_seed(2))
    return engine, data


def test_api_validation_rejects_contradictions():
    bad = [
        dict(correction_init="gradient", faults=tapi.FaultPlan(crash_rate=0.1)),
        dict(server_lr=0.5, faults=tapi.FaultPlan(crash_rate=0.1)),
        dict(server_lr=0.5, defense=tapi.DefensePlan()),
        dict(faults=tapi.FaultPlan(crash_rate=2.0)),
        dict(defense=tapi.DefensePlan(retry_widen=2.0)),
        dict(backend="multilevel", levels=(2, 2, 2), faults=tapi.FaultPlan(crash_rate=0.1)),
        dict(population=8, levels=(2, 4), faults=tapi.FaultPlan(crash_rate=0.1)),
    ]
    for kw in bad:
        with pytest.raises(ValueError) as want:
            japi.ExperimentSpec(**{k: _tplan_any(v) for k, v in kw.items()}).validate()
        with pytest.raises(ValueError, match=f"^{re.escape(str(want.value))}$"):
            tapi.ExperimentSpec(**kw).validate()
    # A disabled plan is not fault mode: the combination becomes legal.
    tapi.ExperimentSpec(server_lr=0.5, faults=tapi.FaultPlan()).validate()
    spec = tapi.ExperimentSpec(faults=tapi.FaultPlan(crash_rate=0.1), defense=tapi.DefensePlan())
    assert spec.fault_mode and spec.defended


def _tplan_any(v):
    """The reference's plan for a port plan (other values as they are)."""
    cls = {tflt.FaultPlan: jflt.FaultPlan, tflt.DefensePlan: jflt.DefensePlan}.get(type(v))
    return v if cls is None else cls(**dataclasses.asdict(v))


@pytest.mark.parametrize("backend,layout", [("simulator", "flat"), ("sharded", "tree")])
def test_api_defended_fit_survives_faults(backend, layout):
    engine, data = _api_fixture(
        faults=tapi.FaultPlan(corrupt_rate=0.3, corrupt_kind="explode"),
        defense=tapi.DefensePlan(screen_norm=5.0), backend=backend, layout=layout)
    state, hz = tapi.fit(engine, data, 6, params={"w": torch.zeros(D)}, chunk=2, guard=True)
    loss = hz.metrics.loss
    assert np.isfinite(loss).all()
    assert float(np.sum(hz.metrics.screened)) > 0
    assert np.mean(loss[-1]) < np.mean(loss[0])
    assert hz.guard is not None and hz.guard.snapshot_bytes > 0
    assert torch.isfinite(engine.global_model(state)["w"]).all()


@pytest.mark.parametrize("backend", ["simulator", "sharded"])
def test_api_retry_round_fn_tightens_screen(backend):
    engine, _ = _api_fixture(faults=tapi.FaultPlan(corrupt_rate=0.2, corrupt_kind="explode"),
                             defense=tapi.DefensePlan(screen_norm=8.0), backend=backend)
    rf0, rf1, rf1b, rf2 = (engine.retry_round_fn(r) for r in (0, 1, 1, 2))
    assert rf0 is engine.round_fn
    assert rf1 is not rf0 and rf2 is not rf1
    assert rf1 is rf1b          # cached per retry level
    # The rebuilt round screens at 8 * 0.5: an upload of norm 6 passes the
    # original screen and not the first retry's.
    G, K = engine.spec.levels
    x0 = {"w": torch.zeros((G, K, D))}
    up = {"w": torch.full((G, K, D), 6.0 / np.sqrt(D))}
    for r, want in ((0, 1.0), (1, 0.0)):
        widened = 8.0 * 0.5 ** r
        _, ok = tflt.screen_and_clip(x0, up, tflt.DefensePlan(screen_norm=widened))
        assert float(ok.min()) == want
    engine2, _ = _api_fixture(faults=tapi.FaultPlan(corrupt_rate=0.2), defense=tapi.DefensePlan(),
                              backend=backend)
    assert engine2.retry_round_fn(1) is engine2.round_fn


def test_fit_wires_retry_round_fn_into_the_guard():
    engine, data = _api_fixture(faults=tapi.FaultPlan(corrupt_rate=0.999, corrupt_kind="nan"))
    asked = []
    real = engine.retry_round_fn

    def retry(r):
        asked.append(r)
        return real(r)

    engine.retry_round_fn = retry
    with pytest.raises(RuntimeError, match="exhausted 1 retries"):
        tapi.fit(engine, data, 2, params={"w": torch.zeros(D)}, chunk=2,
                 guard=tapi.GuardSpec(max_retries=1))
    assert asked == [1]


def test_sharded_zero_fault_bit_exact_via_api():
    engine_a, data_a = _api_fixture(backend="sharded")
    engine_b, data_b = _api_fixture(faults=tapi.FaultPlan(), backend="sharded")
    sa, _ = tapi.fit(engine_a, data_a, 3, params={"w": torch.zeros(D)})
    sb, _ = tapi.fit(engine_b, data_b, 3, params={"w": torch.zeros(D)})
    for f in ("params", "z", "y"):
        np.testing.assert_array_equal(_w(getattr(sa, f)), _w(getattr(sb, f)))
