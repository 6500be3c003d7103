"""The port's compressed uploads against the JAX package, on the CPU.

* Kernels: the plain int8 and top-k round trips against ``repro.kernels.ref``
  and the Pallas kernels in interpret mode, bit for bit.
* ``core.compression``: ``CompressionPlan``, ``roundtrip`` per mode with
  the reference's noise, and the wire-byte model.
* The engine: compressed rounds against the reference ``SimulatorEngine``
  on the flat and tree layouts, fused and unfused, with the reference's
  random draws injected (``round_fn(state, batches, draws=...)``); against
  the numpy top-k error-feedback oracle of ``tests/test_compression.py``;
  a disabled plan against no plan; and a compressed state through numpy.

JAX's threefry bits cannot be drawn in PyTorch, so :func:`reference_draws`
replays the reference round's key schedule (engine.py: ``round_masks``
first, then ``ckey, rng = split(rng)``, ``kc, kg = split(ckey)``,
``split(kc, E)`` per group round, and ``fold_in(key, leaf)`` per leaf in
compression.py) and hands the same arrays to both packages.
"""
import dataclasses

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
from test_compression import mtgc_topk_ef_oracle  # noqa: E402
from test_torch_engine import MODELS, _batches, _few_torch_threads  # noqa: E402,F401

from repro import api as japi  # noqa: E402
from repro.core import compression as jcmp  # noqa: E402
from repro.core import participation as jpart  # noqa: E402
from repro.kernels import quantize as jqz  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import small as jsmall  # noqa: E402
from repro_torch import api as tapi  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import compression as tcmp  # noqa: E402
from repro_torch.core.engine import RoundDraws  # noqa: E402
from repro_torch.core.tree import tree_leaves as ttree_leaves  # noqa: E402
from repro_torch.core.participation import ParticipationMasks  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import quantize as qz  # noqa: E402
from repro_torch.models import small as tsmall  # noqa: E402
from torch_devices import other_device  # noqa: E402

G, K, E, H = 2, 3, 2, 2
RTOL, ATOL = 1e-5, 1e-6
# The CNN's convolutions sum in another order in XLA and in PyTorch
# (ROADMAP queue 3, item 1): rtol 1e-4 for the CNN, never looser.
CNN_RTOL = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def _same_bits(got, want):
    """Bit-exact, NaN for NaN (so -0.0 and +0.0 differ)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    ints = np.int32 if got.dtype == np.float32 else np.int16
    np.testing.assert_array_equal(got[~nan].view(ints), want[~nan].view(ints))


# --------------------------------------------------------------- kernels

SWEEP = [(1, 1), (3, 7), (2, 128), (4, 1000), (1, 8195)]


def _int8_operands(R, n, seed):
    u = jax.random.normal(jax.random.PRNGKey(seed), (R, n), jnp.float32) * 3.0
    amax = jnp.max(jnp.abs(u), axis=1)
    scale = jnp.where(amax > 0, amax / 127.0, 1.0)
    noise = jax.random.uniform(jax.random.PRNGKey(seed + 1), (R, n), jnp.float32)
    return u, scale, noise


@pytest.mark.parametrize("R,n", SWEEP)
def test_int8_plain_matches_reference_bitexact(R, n):
    u, scale, noise = _int8_operands(R, n, R * 100 + n)
    got = qz.int8_roundtrip_ref(_t(u), _t(scale), _t(noise))
    assert got.dtype == torch.float32
    _same_bits(got.numpy(), np.asarray(jref.int8_roundtrip_ref(u, scale, noise)))
    _same_bits(got.numpy(), np.asarray(jqz.int8_roundtrip(u, scale, noise, interpret=True)))


@pytest.mark.parametrize("R,n", SWEEP)
def test_topk_plain_matches_reference_bitexact(R, n):
    u = jax.random.normal(jax.random.PRNGKey(R + n), (R, n), jnp.float32)
    k = max(1, n // 10)
    thresh = jax.lax.top_k(jnp.abs(u), k)[0][:, -1]
    got = qz.topk_mask_ref(_t(u), _t(thresh)).numpy()
    _same_bits(got, np.asarray(jref.topk_mask_ref(u, thresh)))
    _same_bits(got, np.asarray(jqz.topk_mask(u, thresh, interpret=True)))
    # The port's threshold is the reference's.
    tk = torch.topk(torch.abs(_t(u)), k, dim=1).values[:, -1]
    np.testing.assert_array_equal(tk.numpy(), np.asarray(thresh))


def test_plain_special_rows_match_reference():
    """Zero rows (scale 1), +-Inf, NaN (through the clip), bfloat16 u, and
    ties at the top-k threshold (all kept)."""
    u = np.zeros((4, 130), np.float32)
    u[1, 3] = 5.0
    u[2, ::7] = np.inf
    u[2, 1::7] = -np.inf
    u[3, ::5] = np.nan
    u[3, 1::5] = 2.0
    scale = np.array([1.0, 5.0 / 127.0, 0.5, 0.25], np.float32)
    noise = np.full(u.shape, 0.999, np.float32)
    got = qz.int8_roundtrip_ref(_t(u), _t(scale), _t(noise)).numpy()
    _same_bits(got, np.asarray(jref.int8_roundtrip_ref(
        jnp.asarray(u), jnp.asarray(scale), jnp.asarray(noise))))
    np.testing.assert_array_equal(got[0], np.zeros(130))
    assert got[1, 3] == pytest.approx(5.0, rel=1e-6)
    assert (got[2, ::7] == 127 * 0.5).all() and (got[2, 1::7] == -127 * 0.5).all()
    assert np.isnan(got[3, ::5]).all()
    ub = jnp.asarray(np.random.default_rng(0).normal(size=(3, 257)) * 2, jnp.bfloat16)
    sb = jnp.max(jnp.abs(ub).astype(jnp.float32), axis=1) / 127.0
    nb = jax.random.uniform(jax.random.PRNGKey(9), ub.shape)
    gotb = qz.int8_roundtrip_ref(convert.tensor_from_numpy(np.asarray(ub), "cpu"),
                                 _t(sb), _t(nb))
    assert gotb.dtype == torch.bfloat16
    _same_bits(gotb.view(torch.int16).numpy(),
               np.asarray(jref.int8_roundtrip_ref(ub, sb, nb)).view(np.int16))
    ties = np.array([[1.0, -1.0, 0.5, 1.0, -2.0, 0.0]], np.float32)
    thresh = np.array([1.0], np.float32)
    got = qz.topk_mask_ref(_t(ties), _t(thresh)).numpy()
    _same_bits(got, np.asarray(jref.topk_mask_ref(jnp.asarray(ties), jnp.asarray(thresh))))
    np.testing.assert_array_equal(got, [[1.0, -1.0, 0.0, 1.0, -2.0, 0.0]])


def test_ops_exports_the_wrappers_and_cpu_takes_plain_without_a_launch():
    assert ops.int8_roundtrip is qz.int8_roundtrip and ops.topk_mask is qz.topk_mask
    u, scale, noise = (_t(a) for a in _int8_operands(3, 300, 5))
    ops.reset_launch_counts()
    assert torch.equal(ops.int8_roundtrip(u, scale, noise),
                       qz.int8_roundtrip_ref(u, scale, noise))
    thresh = torch.topk(u.abs(), 30, dim=1).values[:, -1]
    assert torch.equal(ops.topk_mask(u, thresh), qz.topk_mask_ref(u, thresh))
    assert qz.int8_roundtrip.launches == 0 and qz.topk_mask.launches == 0
    other, row = other_device(2, 3), other_device(2)
    with pytest.raises(ValueError, match="runs on cpu or cuda"):
        qz.int8_roundtrip(other, row, other)
    with pytest.raises(ValueError, match="runs on cpu or cuda"):
        qz.topk_mask(other, row)
    meta = torch.empty((2, 3), device="meta")
    for got in (qz.int8_roundtrip(meta, meta[:, 0], meta), qz.topk_mask(meta, meta[:, 0])):
        assert got.device.type == "meta" and got.shape == meta.shape


# ------------------------------------------------- compression module

def test_compression_plan_matches_reference():
    assert ([(f.name, f.default) for f in dataclasses.fields(tcmp.CompressionPlan)]
            == [(f.name, f.default) for f in dataclasses.fields(jcmp.CompressionPlan)])
    assert tcmp.COMPRESSION_MODES == jcmp.COMPRESSION_MODES
    for cm in jcmp.COMPRESSION_MODES:
        for gm in jcmp.COMPRESSION_MODES:
            for ef in (False, True):
                tp = tcmp.CompressionPlan(cm, gm, ef)
                jp = jcmp.CompressionPlan(cm, gm, ef)
                for prop in ("enabled", "stochastic", "ef_client", "ef_group"):
                    assert getattr(tp, prop) == getattr(jp, prop), (cm, gm, ef, prop)
    for bad in (dict(client_mode="int4"), dict(group_mode="fp8"), dict(topk_frac=0.0),
                dict(topk_frac=1.5)):
        with pytest.raises(ValueError):
            tcmp.CompressionPlan(**bad).validate()
        with pytest.raises(ValueError):
            jcmp.CompressionPlan(**bad).validate()


@pytest.mark.parametrize("mode", ["bf16", "int8_stochastic", "topk"])
@pytest.mark.parametrize("lead_ndim", [1, 2])
@pytest.mark.parametrize("fused", [False, True])
def test_roundtrip_matches_reference(mode, lead_ndim, fused):
    """Per-leaf rows, per-row scales/thresholds, the same noise: bit for bit."""
    rng = np.random.default_rng(lead_ndim)
    lead = (2, 3)[:lead_ndim] if lead_ndim == 2 else (4,)
    delta = {"b": rng.normal(size=lead + (7,)).astype(np.float32),
             "a": {"w": rng.normal(size=lead + (5, 3)).astype(np.float32) * 10}}
    jdelta = jax.tree.map(jnp.asarray, delta)
    key = jax.random.PRNGKey(3) if mode == "int8_stochastic" else None
    want = jcmp.roundtrip(jdelta, mode=mode, lead_ndim=lead_ndim, frac=0.3, key=key,
                          dispatch="interpret" if fused else "ref")
    noise = None
    if key is not None:
        noise = []
        for i, leaf in enumerate(jax.tree.leaves(jdelta)):
            rows = int(np.prod(leaf.shape[:lead_ndim]))
            noise.append(_t(jax.random.uniform(jax.random.fold_in(key, i),
                                               (rows, leaf[(0,) * lead_ndim].size))))
    got = tcmp.roundtrip(convert.params_from_numpy(delta, "cpu"), mode=mode,
                         lead_ndim=lead_ndim, frac=0.3, noise=noise, fused=fused)
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want),
                            [got["a"]["w"], got["b"]]):
        _same_bits(g.numpy(), np.asarray(w))
    assert tcmp.roundtrip(delta, mode="none", lead_ndim=lead_ndim) is delta
    if mode == "int8_stochastic":
        with pytest.raises(ValueError, match="noise"):
            tcmp.roundtrip(convert.params_from_numpy(delta, "cpu"), mode=mode,
                           lead_ndim=lead_ndim)


def test_wire_model_matches_reference_for_mixed_leaves():
    stacked = {"a": jnp.zeros((2, 3, 100), jnp.float32),
               "b": jnp.zeros((2, 3, 9, 2), jnp.bfloat16)}
    sizes = jcmp.model_leaf_sizes(stacked)
    tstacked = {"a": torch.zeros(2, 3, 100),
                "b": torch.zeros(2, 3, 9, 2, dtype=torch.bfloat16)}
    assert tcmp.model_leaf_sizes(tstacked) == sizes
    for mode in jcmp.COMPRESSION_MODES:
        for frac in (0.001, 0.05, 0.5, 1.0):
            assert tcmp.upload_bytes(sizes, mode, frac) == jcmp.upload_bytes(sizes, mode, frac)
    for cm, gm in (("none", "none"), ("int8_stochastic", "int8_stochastic"),
                   ("topk", "bf16"), ("bf16", "none")):
        jp, tp = jcmp.CompressionPlan(cm, gm, topk_frac=0.1), tcmp.CompressionPlan(
            cm, gm, topk_frac=0.1)
        for nc, ng in ((12, 2), (5.0, 1.0)):
            assert (tcmp.round_comm_bytes(tstacked, tp, nc, ng).item()
                    == float(jcmp.round_comm_bytes(stacked, jp, nc, ng)))


# -------------------------------------------------------------- engine

def reference_draws(jrng, jcfg, jplan, leaf_sizes):
    """The draws the reference round makes from ``jrng``, as a RoundDraws.

    ``leaf_sizes``: elements per model of each state leaf, in leaf order.
    """
    Gc, Kc, Ec = jcfg.num_groups, jcfg.clients_per_group, jcfg.group_rounds
    rng, masks = jrng, None
    if not jcfg.full_participation:
        jm, rng = jpart.round_masks(rng, jcfg)
        masks = ParticipationMasks(_t(jm.group), _t(jm.client))
    cn = gn = None
    if jplan is not None and jplan.enabled and jplan.stochastic:
        ckey, rng = jax.random.split(rng)
        kc, kg = jax.random.split(ckey)
        if jplan.client_mode == "int8_stochastic":
            eks = jax.random.split(kc, Ec)
            cn = [[_t(jax.random.uniform(jax.random.fold_in(eks[e], i), (Gc * Kc, n)))
                   for i, n in enumerate(leaf_sizes)] for e in range(Ec)]
        if jplan.group_mode == "int8_stochastic":
            gn = [_t(jax.random.uniform(jax.random.fold_in(kg, i), (Gc, n)))
                  for i, n in enumerate(leaf_sizes)]
    return RoundDraws(masks=masks, client_noise=cn, group_noise=gn)


FIELDS = ("params", "z", "y", "dyn", "efc", "efg")


def _jax_state(state):
    out = {}
    for f in FIELDS:
        v = getattr(state, f)
        if v is None:
            continue
        out[f] = ({k: np.asarray(b) for k, b in v.bufs.items()} if hasattr(v, "bufs")
                  else jax.tree.map(np.asarray, v))
    out["round"] = np.asarray(state.round)
    return out


def _close(want, got, rtol, atol, tag, flips=0.0):
    """assert_allclose leaf by leaf; ``flips`` > 0 lets at most that
    fraction of a leaf's entries lie outside the tolerance (see
    :func:`run_pair`)."""
    if isinstance(want, dict):
        assert sorted(want) == sorted(got), (tag, sorted(want), sorted(got))
        for k in want:
            _close(want[k], got[k], rtol, atol, f"{tag}.{k}", flips)
        return
    got, want = np.asarray(got), np.asarray(want)
    if flips:
        assert got.shape == want.shape, tag
        off = ~np.isclose(got, want, rtol=rtol, atol=atol, equal_nan=True)
        assert off.mean() <= flips, f"{tag}: {off.sum()} of {off.size} entries off"
        return
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=tag)


def quad_loss(params, batch):
    """The reference compression tests' quadratic model (elementwise, so
    both packages compute it in the same order), with two leaves."""
    mod = torch if isinstance(params["w"], torch.Tensor) else jnp
    r = batch["a"] * params["w"] - batch["b"]
    s = batch["c"] * params["v"] - batch["e"]
    return 0.5 * mod.sum(r * r) + 0.5 * mod.sum(s * s)


def problem(name):
    """(params numpy tree, reference loss, port loss, batches(seed))."""
    if name == "quad":
        def batches(seed):
            rng = np.random.default_rng(seed)

            def f(n, off):
                return (rng.normal(size=(E, H, G, K, n)) + off).astype(np.float32)
            return {"a": f(200, 1.0), "b": f(200, 0.0), "c": f(30, 1.0), "e": f(30, 0.0)}
        p0 = {"w": np.zeros(200, np.float32), "v": np.zeros(30, np.float32)}
        return p0, quad_loss, quad_loss, batches
    factory, feat = MODELS[name]
    jinit, japply = factory(jsmall)
    _, tapply = factory(tsmall)
    p0 = jax.tree.map(np.asarray, jinit(jax.random.PRNGKey(0)))
    return (p0, jsmall.make_loss(japply), tsmall.make_loss(tapply),
            lambda seed: _batches(seed, feat))


def run_pair(name, spec_kw, rounds=3, rtol=RTOL, seed=0, sync=False, flips=0.0):
    """``rounds`` rounds of one spec through both packages from the same
    params, batches and draws; every state field and metric compared after
    each round. z and y carry the params' atol through their difference
    quotients (ROADMAP queue 3, item 2). Returns the port's final state.

    The models with matrix products (``mlp``, ``cnn``) sum in another
    order in XLA and in PyTorch, and a compressor turns a one-ulp
    disagreement of its input into a whole quantization step (int8, bf16)
    or another kept entry (top-k) now and then (ROADMAP queue 3, item 4;
    :func:`test_int8_step_flips_come_from_one_ulp`). Their cases pass
    ``sync`` -- every round of the port starts from the reference's state
    (through numpy, efc and efg included) -- and ``flips``, the fraction of
    a leaf's entries allowed outside the tolerance. The ``quad`` problem
    computes elementwise and is held to the tolerance everywhere, chained.
    """
    p0, jloss, tloss, batches = problem(name)
    kw = dict(levels=(G, K), lr=0.1, algorithm="mtgc")
    kw.update(spec_kw)
    jkw, tkw = dict(kw), dict(kw)
    plan = kw.pop("compression", None)
    if plan is not None:
        jkw["compression"] = jcmp.CompressionPlan(**plan)
        tkw["compression"] = tcmp.CompressionPlan(**plan)
    jspec = japi.ExperimentSpec(schedule=japi.RoundSchedule(group_rounds=E, local_steps=H),
                                **jkw)
    tspec = tapi.ExperimentSpec(schedule=tapi.RoundSchedule(group_rounds=E, local_steps=H),
                                **tkw)
    jeng = japi.build(jspec, jloss)
    teng = tapi.build(tspec, tloss, device="cpu")
    jstate = jeng.init(jax.tree.map(jnp.asarray, p0), rng=jax.random.PRNGKey(seed))
    tstate = teng.init(convert.params_from_numpy(p0, "cpu"))
    template = p0 if kw.get("state_layout", "flat") == "flat" else None
    jround = jax.jit(jeng.round_fn)
    sizes = [int(np.prod(leaf.shape[2:])) for leaf in jax.tree.leaves(jstate.params)]
    lr = kw["lr"]
    atol = {"z": ATOL / (H * lr), "y": ATOL / (H * E * lr)}
    for r in range(rounds):
        b = batches(r)
        draws = reference_draws(jstate.rng, jeng._cfg, jkw.get("compression"), sizes)
        if sync and r > 0:
            f = _jax_state(jstate)
            tstate = convert.state_from_numpy(
                f["params"], f["z"], f["y"], f["dyn"], f["round"], efc=f.get("efc"),
                efg=f.get("efg"), template=template, device="cpu")
        jstate, jm = jround(jstate, jax.tree.map(jnp.asarray, b))
        tstate, tm = teng.round_fn(tstate, {k: torch.from_numpy(v) for k, v in b.items()},
                                   draws=draws)
        want, got = _jax_state(jstate), convert.to_numpy(tstate)
        assert sorted(want) == sorted(got), (sorted(want), sorted(got))
        for f in want:
            _close(want[f], got[f], rtol, atol.get(f, ATOL), f"round{r + 1}.{f}", flips)
        _close({f: np.asarray(v) for f, v in jm._asdict().items()}, convert.to_numpy(tm),
               rtol, ATOL, f"round{r + 1}.metrics", flips)
    return tstate


def test_int8_step_flips_come_from_one_ulp():
    """The mechanism behind ``flips``: one ulp more in the model moves
    floor(u / s + noise) of the upload delta u by a whole step on a few
    entries -- each by one step s -- in both packages alike."""
    x = jax.random.normal(jax.random.PRNGKey(7), (8, 20000), jnp.float32)
    step = jax.random.normal(jax.random.PRNGKey(8), x.shape, jnp.float32) * 1e-3
    noise = jax.random.uniform(jax.random.PRNGKey(9), x.shape, jnp.float32)
    u = (x + step) - x
    u_ulp = jnp.nextafter(x + step, jnp.inf) - x
    scale = jnp.max(jnp.abs(u), axis=1) / 127.0
    for fn in (lambda a: np.asarray(jref.int8_roundtrip_ref(a, scale, noise)),
               lambda a: qz.int8_roundtrip_ref(_t(a), _t(scale), _t(noise)).numpy()):
        d = fn(u_ulp) - fn(u)
        flips = d != 0
        assert 0 < flips.mean() < 0.02
        rows = np.nonzero(flips)[0]
        np.testing.assert_allclose(np.abs(d[flips]), np.asarray(scale)[rows], rtol=2e-5)


PLANS = {
    "int8-int8": dict(client_mode="int8_stochastic", group_mode="int8_stochastic"),
    "topk-bf16": dict(client_mode="topk", group_mode="bf16", topk_frac=0.1),
    "int8-none-noef": dict(client_mode="int8_stochastic", error_feedback=False),
}


@pytest.mark.parametrize("plan", sorted(PLANS))
@pytest.mark.parametrize("layout,fusion", [("flat", "none"), ("flat", "fused"),
                                           ("tree", "none"), ("tree", "fused")])
def test_compressed_rounds_match_reference(plan, layout, fusion):
    run_pair("quad", dict(state_layout=layout, fusion=fusion, compression=PLANS[plan]))


@pytest.mark.parametrize("layout,plan", [("flat", "int8-int8"), ("tree", "topk-bf16")])
def test_compressed_mlp_rounds_match_reference(layout, plan):
    """At most 1% of a leaf's entries may sit a compressor step off (see
    run_pair)."""
    run_pair("mlp", dict(state_layout=layout, fusion="fused", compression=PLANS[plan]),
             rounds=2, sync=True, flips=0.01)


@pytest.mark.parametrize("layout", ["flat", "tree"])
def test_compressed_cnn_rounds_match_reference(layout):
    """Top-k on both links: a kept entry changes only where two magnitudes
    at a row's threshold lie within the convolutions' disagreement, so the
    CNN is held to its tolerance on all but 0.2% of each leaf's entries:
    those few are residuals and z entries where the cancellation in
    u = x_end - x leaves the convolutions' absolute disagreement (up to
    ~8e-6; 8 of the head weight's 30,720 residuals) above atol, the same
    share of the head weight that ROADMAP queue 3, item 1 reports. (That
    ~1e-6 relative disagreement would move int8 and bf16 steps on a large
    share of entries; those modes are held on the quad problem.)"""
    run_pair("cnn", dict(state_layout=layout, fusion="fused",
                         compression=dict(client_mode="topk", group_mode="topk",
                                          topk_frac=0.1)),
             rounds=2, rtol=CNN_RTOL, flips=2e-3)


@pytest.mark.parametrize("algo", ["hfedavg", "local_corr", "group_corr", "fedprox",
                                  "feddyn"])
def test_compressed_baselines_match_reference(algo):
    run_pair("quad", dict(algorithm=algo, prox_mu=0.1 if algo == "fedprox" else 0.0,
                          feddyn_alpha=0.1 if algo == "feddyn" else 0.0,
                          compression=PLANS["int8-int8"]))


def test_engine_matches_topk_ef_oracle():
    """tests/test_compression.py::test_engine_matches_topk_ef_oracle for the
    port: client-link top-k with error feedback, replayed in numpy."""
    rounds, frac, lr, d = 3, 0.4, 0.05, 5
    rng = np.random.default_rng(0)
    a = rng.normal(size=(G, K, d)).astype(np.float32) + 2.0
    b = rng.normal(size=(G, K, d)).astype(np.float32)
    batch = {"a": torch.from_numpy(np.broadcast_to(a, (E, H, G, K, d)).copy()),
             "b": torch.from_numpy(np.broadcast_to(b, (E, H, G, K, d)).copy())}
    for layout in ("tree", "flat"):
        spec = tapi.ExperimentSpec(
            levels=(G, K), schedule=tapi.RoundSchedule(group_rounds=E, local_steps=H), lr=lr,
            state_layout=layout,
            compression=tapi.CompressionPlan(client_mode="topk", topk_frac=frac))
        eng = tapi.build(spec, lambda p, bt: 0.5 * torch.sum((bt["a"] * p["w"] - bt["b"]) ** 2),
                         device="cpu")
        state = eng.init({"w": torch.zeros(d)})
        for _ in range(rounds):
            state, _ = eng.round_fn(state, batch)
        ox, oz, oy, oef = mtgc_topk_ef_oracle(np.zeros((d,)), a, b, G, K, E, H, lr,
                                              rounds, frac)
        tree = (state if layout == "tree" else
                state._replace(params=state.params.to_tree(), z=state.z.to_tree(),
                               y=state.y.to_tree(), efc=state.efc.to_tree()))
        np.testing.assert_allclose(tree.params["w"].numpy(), ox, rtol=2e-5, atol=1e-6)
        np.testing.assert_allclose(tree.efc["w"].numpy(), oef, rtol=2e-5, atol=1e-6)
        np.testing.assert_allclose(tree.z["w"].numpy(), oz, rtol=2e-4, atol=1e-5)
        np.testing.assert_allclose(tree.y["w"].numpy(), oy, rtol=2e-4, atol=1e-5)
        assert float(np.abs(oef).max()) > 0


@pytest.mark.parametrize("layout", ["flat", "tree"])
@pytest.mark.parametrize("participation", [1.0, 0.6])
def test_disabled_plan_is_bitexact(layout, participation):
    """CompressionPlan() (both links 'none') adds no efc/efg and gives the
    uncompressed round bit for bit, at full and partial participation."""
    factory, feat = MODELS["mlp"]
    _, apply = factory(tsmall)
    p0 = factory(tsmall)[0](torch.Generator().manual_seed(0), device="cpu")
    b = {k: torch.from_numpy(v) for k, v in _batches(0, feat).items()}
    outs = []
    for plan in (None, tapi.CompressionPlan()):
        spec = tapi.ExperimentSpec(
            levels=(G, K), schedule=tapi.RoundSchedule(group_rounds=E, local_steps=H),
            state_layout=layout, client_participation=participation, compression=plan)
        eng = tapi.build(spec, tsmall.make_loss(apply), device="cpu")
        state = eng.init(p0, rng=torch.Generator().manual_seed(3))
        assert state.efc is None and state.efg is None
        mets = []
        for _ in range(2):
            state, m = eng.round_fn(state, b)
            mets.append(convert.to_numpy(m))
        assert state.efc is None and state.efg is None
        outs.append({"state": convert.to_numpy(state),
                     **{f"metrics{i}": m for i, m in enumerate(mets)}})
    _close(outs[0], outs[1], 0.0, 0.0, f"{layout}.{participation}")


def test_generator_draws_equal_injected_draws():
    """Without injected draws the round draws masks first, then the client
    noise of each group round, then the group noise, from state.rng: the
    same numbers drawn by hand and injected give the same round."""
    factory, feat = MODELS["mlp"]
    _, apply = factory(tsmall)
    p0 = factory(tsmall)[0](torch.Generator().manual_seed(0), device="cpu")
    b = {k: torch.from_numpy(v) for k, v in _batches(0, feat).items()}
    spec = tapi.ExperimentSpec(
        levels=(G, K), schedule=tapi.RoundSchedule(group_rounds=E, local_steps=H),
        client_participation=0.5, group_participation=0.5, participation_mode="fixed",
        compression=tapi.CompressionPlan("int8_stochastic", "int8_stochastic"))
    eng = tapi.build(spec, tsmall.make_loss(apply), device="cpu")
    state = eng.init(p0, rng=torch.Generator().manual_seed(11))
    n = sum(p.numel() for leaf in p0.values() for p in leaf.values())
    gen = torch.Generator().manual_seed(11)
    from repro_torch.core.participation import round_masks
    masks = round_masks(gen, eng._cfg)
    cn = [[torch.rand((G * K, n), generator=gen)] for _ in range(E)]
    gn = [torch.rand((G, n), generator=gen)]
    s1, m1 = eng.round_fn(state, b)
    s2, m2 = eng.round_fn(state._replace(rng=None), b, draws=RoundDraws(masks, cn, gn))
    _close(convert.to_numpy(s1), convert.to_numpy(s2), 0.0, 0.0, "state")
    _close(convert.to_numpy(m1), convert.to_numpy(m2), 0.0, 0.0, "metrics")
    assert torch.equal(state.rng.get_state(), gen.get_state())
    with pytest.raises(ValueError, match="rng"):
        eng.round_fn(state._replace(rng=None), b)


def test_init_carries_residuals_and_seeds_the_generator():
    """efc/efg exist exactly where the plan feeds back errors, start at
    zero with the state's shapes, and a stochastic plan gets a generator."""
    factory, _ = MODELS["mlp"]
    p0 = factory(tsmall)[0](torch.Generator().manual_seed(0), device="cpu")
    for plan, efc, efg in ((tapi.CompressionPlan("topk", "bf16"), True, True),
                           (tapi.CompressionPlan("int8_stochastic", error_feedback=False),
                            False, False),
                           (tapi.CompressionPlan(group_mode="topk"), False, True)):
        for layout in ("flat", "tree"):
            eng = tapi.build(tapi.ExperimentSpec(levels=(G, K), state_layout=layout,
                                                 compression=plan), lambda p, b: None,
                             device="cpu")
            state = eng.init(p0)
            assert (state.efc is not None) == efc and (state.efg is not None) == efg
            assert (state.rng is not None) == plan.stochastic
            for field, like in (("efc", state.params), ("efg", state.y)):
                got = getattr(state, field)
                if got is not None:
                    for r, t in zip(ttree_leaves(got), ttree_leaves(like)):
                        assert r.shape == t.shape and not r.any()


@pytest.mark.parametrize("layout", ["flat", "tree"])
def test_compressed_state_crosses_through_numpy(layout):
    """A compressed reference state (efc and efg live) goes through numpy
    into the port and back, bit for bit, and the port's next round from it
    matches the reference's."""
    p0, jloss, tloss, batches = problem("quad")
    kw = dict(levels=(G, K), state_layout=layout)
    plan = PLANS["topk-bf16"]
    jeng = japi.build(japi.ExperimentSpec(schedule=japi.RoundSchedule(E, H),
                                          compression=jcmp.CompressionPlan(**plan), **kw),
                      jloss)
    teng = tapi.build(tapi.ExperimentSpec(schedule=tapi.RoundSchedule(E, H),
                                          compression=tcmp.CompressionPlan(**plan), **kw),
                      tloss, device="cpu")
    jround = jax.jit(jeng.round_fn)
    jstate, _ = jround(jeng.init(jax.tree.map(jnp.asarray, p0)),
                       jax.tree.map(jnp.asarray, batches(0)))
    fields = _jax_state(jstate)
    for f in ("efc", "efg"):
        assert np.abs(np.concatenate([np.ravel(v) for v in jax.tree.leaves(fields[f])])
                      ).max() > 0
    tstate = convert.state_from_numpy(
        fields["params"], fields["z"], fields["y"], fields["dyn"], fields["round"],
        efc=fields["efc"], efg=fields["efg"], template=p0 if layout == "flat" else None,
        device="cpu")
    _close(fields, convert.to_numpy(tstate), 0.0, 0.0, "crossed")
    b = batches(1)
    jstate, _ = jround(jstate, jax.tree.map(jnp.asarray, b))
    tstate, _ = teng.round_fn(tstate, {k: torch.from_numpy(v) for k, v in b.items()})
    got = convert.to_numpy(tstate)
    atol = {"z": ATOL / (H * 0.1), "y": ATOL / (H * E * 0.1)}
    for f, v in _jax_state(jstate).items():
        _close(v, got[f], RTOL, atol.get(f, ATOL), f)
