"""Compressed uploads and piecewise partial participation on the port's
sharded backend (``repro_torch.launch.train``), on the CPU.

* Against the JAX package's sharded round (``repro.api.build(spec)`` with
  ``backend="sharded"``; its fused path runs the Pallas kernels in
  interpret mode): the analogue of
  ``tests/test_compression.py::test_sim_and_sharded_engines_in_lockstep``
  across layouts, plans, fusion and participation, with the reference's
  masks and noise injected (the sharded reference draws them with the
  simulator engine's key schedule, which
  ``tests/test_torch_compression.py::reference_draws`` replays); params, z,
  y, efc, efg and comm_bytes at the reference's parity tolerance (rtol
  1e-5 in float32; z and y carry the params' atol through their quotients,
  ROADMAP queue 3 item 2), and the port's own simulator engine in lockstep
  at the reference's 1e-6. The ``quad`` problem computes elementwise, so at
  full participation no one-ulp disagreement can move an int8 step or a
  bf16 rounding. A masked mean is another matter: XLA divides the masked
  sum by the active count as a product with its reciprocal, the port truly
  divides (ROADMAP queue 3 item 2), and that ulp turns a bf16 or int8
  rounding of a report the other way now and then (queue 3 item 4; the
  port's simulator engine shows the same entries against the reference's).
  So under a mask, with an int8 or bf16 link, at most its stated share, 1%
  of a field's entries (its leaves together), may lie outside the
  tolerance.
* The analogues of ``::test_engine_matches_topk_ef_oracle[sharded]`` and
  ``::test_disabled_plan_is_bitexact[sharded]``.
* The pieces: with ``_CHUNK`` patched small, the piecewise top-k threshold
  equals ``torch.topk`` bit for bit (ties, +-Inf, NaN, zero rows, k larger
  than a piece), the piecewise int8 round trip equals the whole row's, and
  the round's piecewise masked means, replica writes and masked gradient
  norm equal the whole-leaf versions bit for bit.
* The trainer CLI with a compressed client link.

The port's round updates its state in place, so every run starts from a
fresh state.
"""
import dataclasses
import math

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
from test_compression import mtgc_topk_ef_oracle  # noqa: E402
from test_torch_compression import problem, reference_draws  # noqa: E402

from repro import api as japi  # noqa: E402
from repro.core import compression as jcmp  # noqa: E402
from repro_torch import api as tapi  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import compression as tcmp  # noqa: E402
from repro_torch.core import tree as tu  # noqa: E402
from repro_torch.core.engine import RoundDraws  # noqa: E402
from repro_torch.core.participation import ParticipationMasks  # noqa: E402
from repro_torch.launch import train  # noqa: E402

G, K, E, H, LR = 2, 3, 2, 2, 0.05
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """One intra-op thread: the suite runs files in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _field(x):
    """A state field of either package as {leaf name: numpy}, unpacked."""
    if x is None:
        return None
    if hasattr(x, "to_tree"):
        x = x.to_tree()
    if isinstance(x, dict) and x and isinstance(next(iter(x.values())), torch.Tensor):
        return convert.to_numpy(x)
    return jax.tree.map(np.asarray, x)


def _same_bits(a, b, tag):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, tag
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=tag)
    ok = ~np.isnan(b)
    ints = {4: np.int32, 2: np.int16}[a.dtype.itemsize]
    np.testing.assert_array_equal(a[ok].view(ints), b[ok].view(ints), err_msg=tag)


def _specs(layout, plan, fusion="none", participation=1.0):
    kw = dict(levels=(G, K), backend="sharded", lr=LR, state_layout=layout, fusion=fusion,
              client_participation=participation)
    jspec = japi.ExperimentSpec(schedule=japi.RoundSchedule(group_rounds=E, local_steps=H),
                                fused_mode="interpret" if fusion == "fused" else None,
                                compression=None if plan is None
                                else jcmp.CompressionPlan(**plan), **kw)
    tspec = tapi.ExperimentSpec(schedule=tapi.RoundSchedule(group_rounds=E, local_steps=H),
                                compression=None if plan is None
                                else tcmp.CompressionPlan(**plan), **kw)
    return jspec, tspec


def _sharded(b):
    """Simulator layout [E, H, G, K, ...] -> sharded [E, H, A=1, G, K, ...]."""
    return {k: np.ascontiguousarray(v[:, :, None]) for k, v in b.items()}


def _torch(b):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in b.items()}


LOCKSTEP_PLANS = {
    "int8-none": dict(client_mode="int8_stochastic", group_mode="none"),
    "topk-bf16": dict(client_mode="topk", group_mode="bf16"),
    "int8-int8": dict(client_mode="int8_stochastic", group_mode="int8_stochastic"),
}


@pytest.mark.parametrize("participation", [1.0, 0.6])
@pytest.mark.parametrize("fusion", ["none", "fused"])
@pytest.mark.parametrize("plan", sorted(LOCKSTEP_PLANS))
@pytest.mark.parametrize("layout", ["flat", "tree"])
def test_sharded_compressed_rounds_match_reference(layout, plan, fusion, participation):
    """Two chained compressed rounds of the port's sharded backend against
    the JAX sharded round (every state field and comm_bytes), with the
    port's simulator engine in lockstep (params, efc, comm_bytes)."""
    p0, jloss, tloss, batches = problem("quad")
    cfg = LOCKSTEP_PLANS[plan]
    jspec, tspec = _specs(layout, cfg, fusion, participation)
    jeng = japi.build(jspec, jloss)
    teng = tapi.build(tspec, tloss, device="cpu")
    seng = tapi.build(dataclasses.replace(tspec, backend="simulator"), tloss, device="cpu")
    jstate = jeng.init(jax.tree.map(jnp.asarray, p0), rng=jax.random.PRNGKey(3))
    tstate = teng.init(convert.params_from_numpy(p0, "cpu"))
    sstate = seng.init(convert.params_from_numpy(p0, "cpu"))
    assert (tstate.efc is not None, tstate.efg is not None) == (
        jstate.efc is not None, jstate.efg is not None)
    sizes = [int(np.prod(leaf.shape[2:])) for leaf in jax.tree.leaves(jstate.params)]
    flips_allowed = participation < 1.0 and any(m in ("int8_stochastic", "bf16")
                                          for m in cfg.values())
    jround = jax.jit(jeng.round_fn)
    atol = {"z": ATOL / (H * LR), "y": ATOL / (H * E * LR)}
    for r in range(2):
        b = batches(r)
        draws = reference_draws(jstate.rng, jspec.to_hfl_config(), jspec.compression, sizes)
        jstate, jm = jround(jstate, jax.tree.map(jnp.asarray, _sharded(b)))
        tstate, tm = teng.round_fn(tstate, _torch(_sharded(b)), draws=draws)
        sstate, sm = seng.round_fn(sstate, _torch(b), draws=draws)
        for name in ("params", "z", "y", "efc", "efg"):
            want, got = _field(getattr(jstate, name)), _field(getattr(tstate, name))
            assert (want is None) == (got is None), name
            if want is None:
                continue
            tol = dict(rtol=RTOL, atol=atol.get(name, ATOL))
            if not flips_allowed:
                for leaf in want:
                    np.testing.assert_allclose(got[leaf], want[leaf], **tol,
                                               err_msg=f"round {r}: {name}/{leaf}")
                continue
            off = np.concatenate([~np.isclose(got[leaf], want[leaf], **tol).ravel()
                                  for leaf in want])
            assert off.mean() <= 0.01, f"round {r}: {name}: {off.sum()} of {off.size} off"
        for f in ("loss", "participation", "comm_bytes"):
            np.testing.assert_allclose(np.asarray(getattr(tm, f)), np.asarray(getattr(jm, f)),
                                       rtol=RTOL, err_msg=f"round {r}: metric {f}")
        assert float(tm.comm_bytes) == float(sm.comm_bytes)
        for name in ("params", "efc"):
            got, sim = _field(getattr(tstate, name)), _field(getattr(sstate, name))
            for leaf in sim or ():
                np.testing.assert_allclose(got[leaf], sim[leaf], rtol=1e-6, atol=1e-7,
                                           err_msg=f"round {r}: simulator {name}/{leaf}")
    for name in ("efc", "efg"):
        f = _field(getattr(tstate, name))
        if f is not None:
            assert max(float(np.abs(v).max()) for v in f.values()) > 0, name


def test_sharded_matches_topk_ef_oracle():
    """tests/test_compression.py::test_engine_matches_topk_ef_oracle[sharded]:
    client-link top-k with error feedback on the tree layout, replayed in
    numpy."""
    rounds, frac, d = 3, 0.4, 5
    rng = np.random.default_rng(0)
    a = rng.normal(size=(G, K, d)).astype(np.float32) + 2.0
    b = rng.normal(size=(G, K, d)).astype(np.float32)
    batch = {"a": torch.from_numpy(np.broadcast_to(a, (E, H, 1, G, K, d)).copy()),
             "b": torch.from_numpy(np.broadcast_to(b, (E, H, 1, G, K, d)).copy())}
    spec = tapi.ExperimentSpec(
        levels=(G, K), backend="sharded", lr=LR, state_layout="tree",
        schedule=tapi.RoundSchedule(group_rounds=E, local_steps=H),
        compression=tapi.CompressionPlan(client_mode="topk", topk_frac=frac))
    eng = tapi.build(spec, lambda p, bt: 0.5 * torch.sum((bt["a"] * p["w"] - bt["b"]) ** 2),
                     device="cpu")
    state = eng.init({"w": torch.zeros(d)})
    for _ in range(rounds):
        state, _ = eng.round_fn(state, batch)
    ox, oz, oy, oef = mtgc_topk_ef_oracle(np.zeros((d,)), a, b, G, K, E, H, LR, rounds, frac)
    np.testing.assert_allclose(state.params["w"].numpy(), ox, rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(state.efc["w"].numpy(), oef, rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(state.z["w"].numpy(), oz, rtol=2e-4, atol=1e-5)
    np.testing.assert_allclose(state.y["w"].numpy(), oy, rtol=2e-4, atol=1e-5)
    assert float(np.abs(oef).max()) > 0


@pytest.mark.parametrize("participation", [1.0, 0.6])
@pytest.mark.parametrize("layout", ["flat", "tree"])
def test_sharded_disabled_plan_is_bitexact(layout, participation):
    """tests/test_compression.py::test_disabled_plan_is_bitexact[sharded]:
    CompressionPlan() adds no residuals and gives the uncompressed round
    bit for bit."""
    p0, _, tloss, batches = problem("quad")
    outs = []
    for plan in (None, {}):
        _, spec = _specs(layout, plan, participation=participation)
        eng = tapi.build(spec, tloss, device="cpu")
        state = eng.init(convert.params_from_numpy(p0, "cpu"),
                         rng=torch.Generator().manual_seed(3))
        assert state.efc is None and state.efg is None
        mets = []
        for r in range(2):
            state, m = eng.round_fn(state, _torch(_sharded(batches(r))))
            mets.append(convert.to_numpy(m))
        assert state.efc is None and state.efg is None
        outs.append((convert.to_numpy(state), mets))
    for name in ("params", "z", "y"):
        for leaf, want in _field(outs[0][0][name]).items():
            _same_bits(_field(outs[1][0][name])[leaf], want, f"{name}/{leaf}")
    for m0, m1 in zip(outs[0][1], outs[1][1]):
        for f, v in m0.items():
            _same_bits(m1[f], v, f)


# ------------------------------------------------------------ the pieces

def _threshold_rows(case, dtype):
    """[4, 100] rows for the threshold check."""
    u = torch.from_numpy(np.random.default_rng(5).normal(size=(4, 100)).astype(np.float32))
    if case == "ties":
        u = torch.round(u * 2) / 2                 # many equal magnitudes
        u[1] = 0.5
        u[2, ::3] = -1.0
    elif case == "inf":
        u[0, ::9] = math.inf
        u[1, ::4] = -math.inf
        u[2, 3] = math.inf
    elif case == "nan":
        u[0, ::9] = math.nan
        u[1, ::2] = math.nan
        u[2, 50] = math.nan
        u[3] = math.nan
    elif case == "zeros":
        u[0] = 0.0
        u[2] = -0.0
    return u.to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["normal", "ties", "inf", "nan", "zeros"])
def test_piecewise_threshold_equals_topk(monkeypatch, case, dtype):
    """The threshold from pieces of 16 elements is ``torch.topk(|u|, k)
    .values[:, -1]`` of the whole row, bit for bit, for k from 1 to the
    whole row (k = 30 and 100 exceed a piece)."""
    monkeypatch.setattr(tcmp, "_CHUNK", 16)
    u = _threshold_rows(case, dtype)
    n = u.shape[1]
    assert len(tcmp.row_pieces(n)) == 7
    for frac in (0.001, 0.05, 0.1, 0.3, 1.0):
        k = max(1, min(n, math.ceil(frac * n)))
        want = torch.topk(torch.abs(u), k, dim=1).values[:, -1]
        got = tcmp.row_params("topk", (u[:, sl] for sl in tcmp.row_pieces(n)), n, frac)
        _same_bits(got.float().numpy(), want.float().numpy(), f"{case} k={k}")


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["int8_stochastic", "topk"])
def test_piecewise_roundtrip_equals_whole_row(monkeypatch, mode, dtype, fused):
    """``roundtrip`` in pieces of 16 elements equals the whole-row round
    trip with the same noise, bit for bit, on rows with zeros, +-Inf and
    NaN; the int8 scale equals the whole row's ``amax`` scale."""
    rng = np.random.default_rng(6)
    u = torch.from_numpy((rng.normal(size=(2, 3, 100)) * 3).astype(np.float32))
    u[0, 1] = 0.0
    u[1, 0, ::11] = math.inf
    u[1, 2, 7] = math.nan
    u = u.to(dtype)
    noise = [torch.from_numpy(rng.random((6, 100)).astype(np.float32))]
    kw = dict(mode=mode, lead_ndim=2, frac=0.2, fused=fused,
              noise=noise if mode == "int8_stochastic" else None)
    whole = tcmp.roundtrip({"w": u}, **kw)["w"]
    rows = u.reshape(6, 100)
    amax = torch.amax(torch.abs(rows).to(torch.float32), dim=1)
    monkeypatch.setattr(tcmp, "_CHUNK", 16)
    pieced = tcmp.roundtrip({"w": u}, **kw)["w"]
    ints = torch.int32 if dtype == torch.float32 else torch.int16
    assert torch.equal(torch.isnan(pieced), torch.isnan(whole))
    ok = ~torch.isnan(whole)
    assert torch.equal(pieced.view(ints)[ok], whole.view(ints)[ok])
    if mode == "int8_stochastic":
        scale = tcmp.row_params(mode, (rows[:, sl] for sl in tcmp.row_pieces(100)), 100)
        want = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
        _same_bits(scale.numpy(), want.numpy(), "scale")


def test_generator_noise_is_one_draw_per_short_row_and_per_piece_past_it(monkeypatch):
    """Without injected noise, a row of at most ``_CHUNK`` elements draws its
    noise as one [rows, n] block (the simulator engine's order, unchanged);
    a longer row draws one [rows, piece] block per piece, in order."""
    u = {"v": torch.randn(2, 3, 40), "w": torch.randn(2, 3, 10)}
    for chunk, shapes in ((1 << 26, [(6, 40), (6, 10)]), (16, [(6, 16), (6, 16), (6, 8),
                                                               (6, 10)])):
        monkeypatch.setattr(tcmp, "_CHUNK", chunk)
        gen = torch.Generator().manual_seed(1)
        got = tcmp.roundtrip(u, mode="int8_stochastic", lead_ndim=2, generator=gen)
        gen2 = torch.Generator().manual_seed(1)
        noise = [torch.rand(s, generator=gen2) for s in shapes]
        if chunk == 16:
            noise = [torch.cat(noise[:3], dim=1), noise[3]]
        want = tcmp.roundtrip(u, mode="int8_stochastic", lead_ndim=2, noise=noise)
        for leaf in u:
            assert torch.equal(got[leaf], want[leaf]), (chunk, leaf)
        assert torch.equal(gen.get_state(), gen2.get_state())


def _masked_problem(dtype):
    gen = torch.Generator().manual_seed(2)
    x = torch.randn((G, K, 50), generator=gen).to(dtype)
    cmask = torch.tensor([[1.0, 0.0, 1.0], [0.0, 0.0, 0.0]])   # group 1 empty
    gmask = torch.tensor([1.0, 1.0])
    return x, cmask, gmask


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("weighting", ["none", "inverse_prob"])
def test_piecewise_masked_means_equal_whole_leaf(monkeypatch, weighting, dtype):
    """The round's masked means, taken per group on [K, piece] blocks and at
    the global step on [G, K, piece] blocks, equal ``tree_masked_mean`` and
    ``tree_group_global_mean`` of the whole leaf bit for bit."""
    monkeypatch.setattr(train, "_CHUNK", 16)
    x, cmask, gmask = _masked_problem(dtype)
    cdenom, gdenom = (None, None) if weighting == "none" else (1.5, 1.0)
    cols = train._cols(x.shape[-1])
    assert len(cols) == 4
    whole = tu.tree_masked_mean(x, cmask, axis=1, denom=cdenom)
    pieced = torch.stack([torch.cat([
        tu.tree_masked_mean(x[g:g + 1, :, sl], cmask[g:g + 1], axis=1, denom=cdenom)[0]
        for sl in cols]) for g in range(G)])
    _same_bits(pieced.float().numpy(), whole.float().numpy(), "group mean")
    assert pieced.dtype == whole.dtype
    xj, xbar, gact = tu.tree_group_global_mean(x, cmask, gmask if cdenom else None, gdenom)
    xj_p, xbar_p = [], []
    for sl in cols:
        own = tu.tree_masked_mean(x[:, :, sl], cmask, axis=1)
        xj_p.append(own)
        if gdenom is None:
            xbar_p.append(tu.tree_masked_mean(own, gact, axis=0))
        else:
            xbar_p.append(tu.tree_masked_mean(
                torch.where(tu.expand_mask(gact, own) != 0, own, 0), gmask, axis=0,
                denom=gdenom))
    _same_bits(torch.cat(xj_p, dim=1).float().numpy(), xj.float().numpy(), "recovery")
    _same_bits(torch.cat(xbar_p).float().numpy(), xbar.float().numpy(), "estimate")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_replica_writes_and_masked_norm_equal_whole_leaf(monkeypatch, dtype):
    """``_put`` (the round's writes to active replicas) leaves the bits of
    ``dst.copy_(where(mask, new, dst))``, a float32 source included; the
    masked gradient norm with the frozen replicas zeroed in place equals
    ``_sq_norm`` of the where-copy (pieced norms past ``_CHUNK``)."""
    monkeypatch.setattr(train, "_CHUNK", 16)
    x, cmask, _ = _masked_problem(dtype)
    active = cmask.numpy() != 0
    for new in (torch.randn(x.shape), torch.randn(x.shape).to(dtype),
                torch.randn(x.shape[-1]).expand(x.shape)):
        want = x.clone()
        want.copy_(torch.where(tu.expand_mask(cmask, new) != 0, new, want))
        got = x.clone()
        train._put(got.view(G * K, -1), new.reshape(G * K, -1), active.reshape(-1))
        assert torch.equal(got.view(torch.int32 if dtype == torch.float32 else torch.int16),
                           want.view(torch.int32 if dtype == torch.float32 else torch.int16))
    acc = {"a": x.clone(), "b": x[:, :, :10].clone()}
    want = train._sq_norm(tu.tree_map(
        lambda t: torch.where(tu.expand_mask(cmask, t) != 0, t, 0), acc))
    for t in acc.values():
        t.masked_fill_(tu.expand_mask(cmask, t) == 0, 0)
    assert torch.equal(train._sq_norm(acc), want)


ROUND_PLANS = {
    "none": None,
    "int8-topk": dict(client_mode="int8_stochastic", group_mode="topk", topk_frac=0.15),
    "topk-int8": dict(client_mode="topk", group_mode="int8_stochastic", topk_frac=0.15),
}


@pytest.mark.parametrize("weighting", ["none", "inverse_prob"])
@pytest.mark.parametrize("plan", sorted(ROUND_PLANS))
@pytest.mark.parametrize("layout", ["flat", "tree"])
def test_piecewise_round_equals_one_piece_round(monkeypatch, layout, plan, weighting):
    """The whole sharded round with every row cut into pieces of 16
    elements gives the bits of the round with one piece a row, under a
    mask with a frozen replica and an empty group, fused, compressed or
    not, noise injected."""
    p0, _, tloss, batches = problem("quad")
    _, spec = _specs(layout, ROUND_PLANS[plan], "fused", 0.5)
    spec = dataclasses.replace(spec, participation_weighting=weighting)
    masks = ParticipationMasks(torch.tensor([1.0, 1.0]),
                               torch.tensor([[1.0, 0.0, 1.0], [0.0, 0.0, 0.0]]))
    rng = np.random.default_rng(4)
    n = sum(v.size for v in p0.values())
    rows = {"flat": [n], "tree": [30, 200]}[layout]          # leaves v, w
    draws = RoundDraws(masks=masks,
                       client_noise=[[torch.from_numpy(rng.random((G * K, m)).astype(np.float32))
                                      for m in rows] for _ in range(E)],
                       group_noise=[torch.from_numpy(rng.random((G, m)).astype(np.float32))
                                    for m in rows])
    outs = []
    for chunk in (1 << 26, 16):
        monkeypatch.setattr(train, "_CHUNK", chunk)
        eng = tapi.build(spec, tloss, device="cpu")
        state = eng.init(convert.params_from_numpy(p0, "cpu"))
        state, m = eng.round_fn(state, _torch(_sharded(batches(0))), draws=draws)
        outs.append((convert.to_numpy(state), convert.to_numpy(m)))
    for name in ("params", "z", "y", "efc", "efg"):
        want = _field(outs[0][0].get(name))
        for leaf in want or ():
            _same_bits(_field(outs[1][0][name])[leaf], want[leaf], f"{name}/{leaf}")
    for f, v in outs[0][1].items():
        if f in ("grad_norm", "z_norm", "y_norm"):
            # _sq_norm reduces a leaf past _CHUNK with vector_norm: another
            # summation order by design, at every piece size the same rule.
            np.testing.assert_allclose(outs[1][1][f], v, rtol=1e-6, err_msg=f)
        else:
            _same_bits(outs[1][1][f], v, f)
    frozen = outs[0][0]["params"]
    start = _field(convert.to_numpy(
        tapi.build(spec, tloss, device="cpu").init(convert.params_from_numpy(p0, "cpu"))
        .params))
    for leaf, v in _field(frozen).items():
        np.testing.assert_array_equal(v[0, 1], start[leaf][0, 1])
        np.testing.assert_array_equal(v[1], start[leaf][1])


def test_train_cli_with_compressed_client_link(capsys):
    """``python -m repro_torch.launch.train --compress-client int8_stochastic``
    runs on the CPU and its client-link residuals are nonzero."""
    state, hz = train.main(["--arch", "glm4-9b", "--smoke", "--rounds", "2", "--device", "cpu",
                            "--seq", "32", "--shards", "2",
                            "--compress-client", "int8_stochastic"])
    out = capsys.readouterr().out
    assert "[train] arch=glm4-9b" in out
    assert state.efc is not None and state.efg is None
    efc = [t for t in tu.tree_leaves(state.efc)]
    assert all(bool(torch.isfinite(t).all()) for t in efc)
    assert any(bool((t != 0).any()) for t in efc)
    comm = np.asarray(hz.metrics.comm_bytes)
    sizes = tcmp.model_leaf_sizes(state.params)
    want = tcmp.upload_bytes(sizes, "int8_stochastic") * E * 2 * 2 + tcmp.upload_bytes(sizes) * 2
    np.testing.assert_allclose(comm, want, rtol=2.0 ** -22)
