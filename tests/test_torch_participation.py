"""The port's partial participation against the JAX package, on the CPU.

* The masked tree helpers and the sampling arithmetic against
  ``repro.core.tree`` / ``repro.core.participation``.
* Engine rounds under ``uniform`` and ``fixed`` masks with ``none`` and
  ``inverse_prob`` weighting, flat and tree, fused and unfused, against the
  reference ``SimulatorEngine`` with the reference's masks injected
  (``round_fn(state, batches, draws=...)``; ``tests/test_torch_compression.py``
  replays its key schedule), including partial participation together with
  group-link compression.
* The port's own contracts: frozen replicas keep their bits, all-ones
  masks equal full participation, the generator draws as documented.
"""
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
from test_torch_compression import PLANS, _close, problem, run_pair  # noqa: E402
from test_torch_engine import _few_torch_threads  # noqa: E402,F401

from repro.core import participation as jpart  # noqa: E402
from repro.core import tree as jtree  # noqa: E402
from repro_torch import api as tapi  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import participation as tpart  # noqa: E402
from repro_torch.core import tree as ttree  # noqa: E402
from repro_torch.core.engine import RoundDraws  # noqa: E402
from repro_torch.core.packer import FlatBuffers, make_packer  # noqa: E402
from repro_torch.kernels import mtgc_update as mu  # noqa: E402

G, K, E, H = 2, 3, 2, 2
RTOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------- tree helpers

MASKS = {
    "mixed": np.array([[1, 0, 1], [0, 0, 1]], np.float32),
    "empty-group": np.array([[0, 0, 0], [1, 1, 0]], np.float32),
    "all": np.ones((2, 3), np.float32),
}


@pytest.mark.parametrize("mask", sorted(MASKS))
@pytest.mark.parametrize("denom", [None, 1.5, 2.0])
def test_masked_mean_matches_reference(mask, denom):
    rng = np.random.default_rng(0)
    tree = {"a": rng.normal(size=(2, 3, 4, 5)).astype(np.float32),
            "b": rng.normal(size=(2, 3, 7)).astype(np.float32)}
    m = MASKS[mask]
    tree["a"][m == 0] = np.nan  # frozen replicas' bits never reach a mean
    want = jtree.tree_masked_mean(jax.tree.map(jnp.asarray, tree), jnp.asarray(m), 1, denom)
    got = ttree.tree_masked_mean(convert.params_from_numpy(tree, "cpu"), _t(m), 1, denom)
    _close(jax.tree.map(np.asarray, want), convert.to_numpy(got), RTOL, 1e-7, "mean")
    if denom is None and mask == "empty-group":
        assert (got["a"][0] == 0).all() and not torch.signbit(got["a"][0]).any()
    want = jtree.tree_masked_sq_norm(jax.tree.map(jnp.asarray, tree), jnp.asarray(m))
    got = ttree.tree_masked_sq_norm(convert.params_from_numpy(tree, "cpu"), _t(m))
    np.testing.assert_allclose(got.item(), float(want), rtol=RTOL)


@pytest.mark.parametrize("mask", sorted(MASKS))
@pytest.mark.parametrize("ht", [False, True])
def test_group_global_mean_matches_reference(mask, ht):
    """On FlatBuffers: recovery over clients, estimation over groups."""
    rng = np.random.default_rng(1)
    template = {"w": torch.zeros(4, 3), "v": torch.zeros(5)}
    packer = make_packer(template)
    x = rng.normal(size=(2, 3, packer.num_params)).astype(np.float32)
    cm = MASKS[mask]
    gm = np.array([1.0, 1.0], np.float32)
    gdenom = 1.0 * G if ht else None
    jx, jc, jg = jnp.asarray(x), jnp.asarray(cm), jnp.asarray(gm)
    wj, w, wa = jtree.tree_group_global_mean(jx, jc, jg if ht else None, gdenom)
    fb = FlatBuffers({"float32": _t(x)}, packer)
    gj, g, ga = ttree.tree_group_global_mean(fb, _t(cm), _t(gm) if ht else None, gdenom)
    np.testing.assert_allclose(gj.bufs["float32"].numpy(), np.asarray(wj), rtol=RTOL)
    np.testing.assert_allclose(g.bufs["float32"].numpy(), np.asarray(w), rtol=RTOL)
    np.testing.assert_array_equal(ga.numpy(), np.asarray(wa))


def test_select_keeps_frozen_bits():
    a = {"w": torch.full((2, 3, 4), float("nan"))}
    b = {"w": torch.arange(24, dtype=torch.float32).reshape(2, 3, 4)}
    m = _t(MASKS["mixed"])
    out = ttree.tree_select(m, a, b)
    assert torch.equal(out["w"][m == 0], b["w"][m == 0])
    assert torch.isnan(out["w"][m != 0]).all()


# ----------------------------------------------------------- sampling

def test_fixed_count_and_inclusion_prob_match_reference():
    for n in range(1, 13):
        for frac in (0.05, 0.1, 0.25, 0.3, 0.5, 0.6, 0.75, 0.99, 1.0):
            assert tpart.fixed_count(frac, n) == jpart.fixed_count(frac, n)
            for mode in tpart.MODES:
                assert tpart.inclusion_prob(frac, n, mode) == jpart.inclusion_prob(
                    frac, n, mode)
    assert tpart.MODES == jpart.MODES and tpart.WEIGHTINGS == jpart.WEIGHTINGS
    with pytest.raises(ValueError, match="participation mode"):
        tpart.inclusion_prob(0.5, 4, "poisson")


@pytest.mark.parametrize("seed", range(4))
def test_sampled_masks_follow_their_mode(seed):
    gen = torch.Generator().manual_seed(seed)
    for g, k, frac in ((3, 5, 0.4), (4, 7, 0.5), (1, 1, 0.5)):
        fixed = tpart.sample_axis_mask(gen, (g, k), frac, "fixed")
        assert (fixed.sum(dim=1) == tpart.fixed_count(frac, k)).all()
        assert set(fixed.unique().tolist()) <= {0.0, 1.0}
    m = tpart.sample_hfl_masks(gen, 6, 4, 0.5, 0.5, "fixed")
    assert m.group.sum() == 3
    assert (m.client[m.group == 0] == 0).all()
    assert (m.client[m.group == 1].sum(dim=1) == 2).all()
    u = tpart.sample_axis_mask(gen, (20000,), 0.3, "uniform")
    assert abs(u.mean().item() - 0.3) < 0.02
    before = gen.get_state()
    assert (tpart.sample_axis_mask(gen, (3, 4), 1.0, "uniform") == 1).all()
    assert torch.equal(gen.get_state(), before)  # frac 1 draws nothing


# ------------------------------------------------------------- engine

WEIGHTED = [
    ("uniform", "none", 0.5, 1.0), ("uniform", "inverse_prob", 0.5, 1.0),
    ("fixed", "none", 0.5, 0.5), ("fixed", "inverse_prob", 0.5, 0.5),
    ("uniform", "inverse_prob", 0.6, 0.5),
]


@pytest.mark.parametrize("mode,weighting,cp,gp", WEIGHTED)
@pytest.mark.parametrize("layout,fusion", [("flat", "none"), ("flat", "fused"),
                                           ("tree", "none"), ("tree", "fused")])
def test_partial_rounds_match_reference(mode, weighting, cp, gp, layout, fusion):
    run_pair("mlp", dict(state_layout=layout, fusion=fusion, client_participation=cp,
                         group_participation=gp, participation_mode=mode,
                         participation_weighting=weighting), rounds=3, seed=5)


@pytest.mark.parametrize("algo", ["hfedavg", "local_corr", "group_corr", "fedprox",
                                  "feddyn"])
@pytest.mark.parametrize("weighting", ["none", "inverse_prob"])
def test_partial_baselines_match_reference(algo, weighting):
    """On the quad problem, the model of the reference's own participation
    tests: under inverse_prob the MLP's weights grow several-fold within two
    rounds and its products' sum-order differences grow past rtol 1e-5."""
    run_pair("quad", dict(algorithm=algo, prox_mu=0.1 if algo == "fedprox" else 0.0,
                          feddyn_alpha=0.1 if algo == "feddyn" else 0.0,
                          client_participation=0.5, participation_weighting=weighting),
             rounds=2, seed=3)


@pytest.mark.parametrize("extra", [
    {"correction_init": "gradient"},
    {"correction_init": "gradient", "participation_weighting": "inverse_prob",
     "group_participation": 0.5},
    {"server_lr": 0.5},
    {"server_lr": 0.5, "state_layout": "tree"},
])
def test_partial_round_variants_match_reference(extra):
    run_pair("mlp", dict(client_participation=0.5, **extra), rounds=2, seed=7)


@pytest.mark.parametrize("plan", ["int8-int8", "topk-bf16", "group-topk"])
@pytest.mark.parametrize("weighting", ["none", "inverse_prob"])
@pytest.mark.parametrize("layout", ["flat", "tree"])
def test_partial_with_compression_matches_reference(plan, weighting, layout):
    """Partial participation with a compressed group link (the reference's
    engine.py:894 branch) and client link (masked residuals). The int8 and
    bf16 links may move a step on a few entries (see run_pair): those plans
    start each round from the reference's state, 1% of entries may be off."""
    comp = PLANS.get(plan, dict(group_mode="topk", topk_frac=0.2))
    steps = plan != "group-topk"
    run_pair("quad", dict(state_layout=layout, fusion="fused", client_participation=0.5,
                          group_participation=0.5, participation_mode="uniform",
                          participation_weighting=weighting, compression=comp),
             rounds=3, seed=2, sync=steps, flips=0.01 if steps else 0.0)


def _round(spec_kw, p0, loss, b, draws=None, rng=None):
    spec = tapi.ExperimentSpec(levels=(G, K),
                               schedule=tapi.RoundSchedule(group_rounds=E, local_steps=H),
                               **spec_kw)
    eng = tapi.build(spec, loss, device="cpu")
    state = eng.init(convert.params_from_numpy(p0, "cpu"), rng=rng)
    new, m = eng.round_fn(state, b, draws=draws)
    return state, new, m


@pytest.mark.parametrize("layout,fusion", [("flat", "fused"), ("flat", "none"),
                                           ("tree", "fused")])
def test_frozen_replicas_keep_their_bits(layout, fusion):
    """Inactive clients' params, z, dyn and residual, and an empty group's
    y and residual, come out of a round bit for bit as they went in, even
    when their batches are NaN."""
    p0, _, loss, batches = problem("quad")
    b = {k: torch.from_numpy(v) for k, v in batches(0).items()}
    cm = torch.tensor([[0.0, 0.0, 0.0], [1.0, 0.0, 1.0]])
    frozen = cm == 0
    b["a"][:, :, frozen] = float("nan")
    draws = RoundDraws(masks=tpart.ParticipationMasks(torch.ones(G), cm))
    kw = dict(state_layout=layout, fusion=fusion, client_participation=0.5,
              compression=tapi.CompressionPlan("topk", "topk", topk_frac=0.5))
    state, new, m = _round(kw, p0, loss, b, draws)
    # A second round from a state whose replicas all differ.
    state = new
    new, m = _round(kw, p0, loss, b, draws)[1:]
    s0, s1 = convert.to_numpy(state), convert.to_numpy(new)
    for f in ("params", "z", "dyn", "efc"):
        for k in s0[f]:
            a0, a1 = np.asarray(s0[f][k]), np.asarray(s1[f][k])
            np.testing.assert_array_equal(a1[frozen.numpy()].view(np.int32),
                                          a0[frozen.numpy()].view(np.int32), err_msg=f)
    for f in ("y", "efg"):
        for k in s0[f]:
            np.testing.assert_array_equal(np.asarray(s1[f][k])[0], np.asarray(s0[f][k])[0])
    for f in m._fields:
        assert np.isfinite(convert.to_numpy(getattr(m, f))).all(), f
    assert m.participation.item() == pytest.approx(2 / 6)


def test_all_ones_masks_equal_full_participation():
    """A partial spec fed all-ones masks gives the full-participation
    round bit for bit (the masked means divide the same sums by K)."""
    p0, _, loss, batches = problem("mlp")
    b = {k: torch.from_numpy(v) for k, v in batches(0).items()}
    ones = RoundDraws(masks=tpart.ParticipationMasks(torch.ones(G), torch.ones(G, K)))
    for layout in ("flat", "tree"):
        outs = []
        for kw, d in (({}, None), ({"client_participation": 0.5}, ones)):
            _, new, m = _round(dict(state_layout=layout, fusion="fused", **kw), p0, loss, b, d)
            outs.append({"state": convert.to_numpy(new), "metrics": convert.to_numpy(m)})
        _close(outs[0], outs[1], 0.0, 0.0, layout)


def test_fused_masked_step_equals_unfused_on_cpu():
    """The flat fused step hands the mask to mtgc_update_flat (its plain
    version here, no launch); the unfused step selects with where: same
    bits."""
    p0, _, loss, batches = problem("mlp")
    b = {k: torch.from_numpy(v) for k, v in batches(1).items()}
    d = RoundDraws(masks=tpart.sample_hfl_masks(torch.Generator().manual_seed(4), G, K,
                                                0.5, 1.0, "fixed"))
    mu.reset_launch_counts()
    outs = [convert.to_numpy(_round(dict(fusion=f, client_participation=0.5), p0, loss, b,
                                    d)[1]) for f in ("none", "fused")]
    _close(outs[0], outs[1], 0.0, 0.0, "fused")
    assert mu.mtgc_update_flat.launches == 0


def test_engine_draws_masks_from_the_state_generator():
    """Without injected masks the round draws them from state.rng with
    round_masks; the same generator state gives the same masks; the spec's
    init seeds a generator when the run is partial."""
    p0, _, loss, batches = problem("mlp")
    b = {k: torch.from_numpy(v) for k, v in batches(0).items()}
    kw = dict(client_participation=0.5, participation_mode="fixed")
    state, new, m = _round(kw, p0, loss, b)
    assert isinstance(state.rng, torch.Generator)
    gen = torch.Generator().manual_seed(0)
    cfg = tapi.ExperimentSpec(levels=(G, K), **kw).to_hfl_config()
    masks = tpart.round_masks(gen, cfg)
    assert torch.equal(state.rng.get_state(), gen.get_state())
    _, again, m2 = _round(kw, p0, loss, b, RoundDraws(masks=masks))
    _close(convert.to_numpy(new), convert.to_numpy(again), 0.0, 0.0, "state")
    assert m.participation.item() == pytest.approx(4 / 6)
    full = tapi.build(tapi.ExperimentSpec(levels=(G, K)), loss, device="cpu")
    assert full.init(convert.params_from_numpy(p0, "cpu")).rng is None
