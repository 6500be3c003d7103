"""The port's round engine against the JAX reference engine, on the CPU.

The same params (initialized by the JAX package) and the same numpy
batches go through ``repro.api.build(spec).round_fn`` and
``repro_torch.api.build(spec, device="cpu").round_fn`` for two global
rounds; after each round the states (params, z, y, dyn, round) and every
``RoundMetrics`` field must agree within the reference's own parity bound,
rtol 1e-5 / atol 1e-6 in float32 (tests/test_flat_state.py). The JAX fused
path runs its Pallas kernel in interpret mode, as the reference's own tests
run it off the TPU; the port's fused path takes the kernels' plain
versions on CPU tensors.

z and y are difference quotients of the params, z = (x_H - xbar) /
(H * lr) and y = (xbar_j - xbar) / (H * E * lr), so one float32 ulp of
disagreement in x becomes 1 / (H * lr) ulps in z. Their absolute tolerance
is the params' atol carried through the same quotient (ATOL / (H * lr) and
ATOL / (H * E * lr)); rtol is unchanged.
"""
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro import api as japi  # noqa: E402
from repro.models import small as jsmall  # noqa: E402
from repro_torch import api as tapi  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.models import small as tsmall  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """One intra-op thread: the suite runs files in parallel workers, and
    PyTorch's default of one thread per core would crowd out the other
    workers' (timing-sensitive) tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

G, K, E, H, B = 2, 3, 2, 2, 4
RTOL, ATOL = 1e-5, 1e-6
# The CNN's convolutions sum in another order in XLA and in PyTorch; after
# one round of 4 steps a few entries of the head weight already differ by
# ~1.6e-4 relative (1.7e-6 absolute), so the CNN cases use rtol 1e-4
# (never looser).
CNN_RTOL = 1e-4

MODELS = {
    "mlp": (lambda m: m.mlp(10, 16, hidden=32), (16,)),
    "cnn": (lambda m: m.cnn(10, (8, 8, 1)), (8, 8, 1)),
}
ALGOS = ("mtgc", "hfedavg", "local_corr", "group_corr", "fedprox", "feddyn")


def _spec_kwargs(algo, layout, extra):
    kw = dict(levels=(G, K), algorithm=algo, lr=0.1, state_layout=layout,
              prox_mu=0.1 if algo == "fedprox" else 0.0,
              feddyn_alpha=0.1 if algo == "feddyn" else 0.0)
    kw.update(extra)
    return kw


def _batches(seed, feat):
    rng = np.random.default_rng(seed)
    return {"x": rng.normal(size=(E, H, G, K, B) + feat).astype(np.float32),
            "y": rng.integers(0, 10, size=(E, H, G, K, B)).astype(np.int32)}


def _jax_fields(state, flat):
    """{field: numpy} of a reference state (flat: the per-dtype buffers)."""
    out = {}
    for f in ("params", "z", "y", "dyn"):
        v = getattr(state, f)
        out[f] = ({k: np.asarray(b) for k, b in v.bufs.items()} if flat
                  else jax.tree.map(np.asarray, v))
    out["round"] = np.asarray(state.round)
    return out


def _assert_tree_close(want, got, rtol, tag, atol=ATOL):
    if isinstance(want, dict):
        assert sorted(want) == sorted(got), (tag, sorted(want), sorted(got))
        for k in want:
            _assert_tree_close(want[k], got[k], rtol, f"{tag}.{k}", atol)
        return
    got = np.asarray(got)
    assert got.shape == np.shape(want), (tag, got.shape, np.shape(want))
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol, err_msg=tag)


def _assert_state_close(want, got, rtol, tag, lr):
    """Field by field, with z's and y's atol carried through their
    difference quotients (see the module docstring)."""
    atol = {"z": ATOL / (H * lr), "y": ATOL / (H * E * lr)}
    assert sorted(want) == sorted(got), (tag, sorted(want), sorted(got))
    for f in want:
        _assert_tree_close(want[f], got[f], rtol, f"{tag}.{f}", atol.get(f, ATOL))


def run_pair(model, algo, layout, extra=None, rounds=2, rtol=RTOL):
    factory, feat = MODELS[model]
    jinit, japply = factory(jsmall)
    _, tapply = factory(tsmall)
    kw = _spec_kwargs(algo, layout, extra or {})
    jspec = japi.ExperimentSpec(schedule=japi.RoundSchedule(group_rounds=E, local_steps=H), **kw)
    tspec = tapi.ExperimentSpec(schedule=tapi.RoundSchedule(group_rounds=E, local_steps=H), **kw)
    jeng = japi.build(jspec, jsmall.make_loss(japply))
    teng = tapi.build(tspec, tsmall.make_loss(tapply), device="cpu")
    p0 = jinit(jax.random.PRNGKey(0))
    jstate = jeng.init(p0)
    tstate = teng.init(convert.params_from_numpy(jax.tree.map(np.asarray, p0), "cpu"))
    round_fn = jax.jit(jeng.round_fn)
    flat = layout == "flat"
    for r in range(rounds):
        b = _batches(r, feat)
        jstate, jm = round_fn(jstate, jax.tree.map(jnp.asarray, b))
        tstate, tm = teng.round_fn(tstate, {k: torch.from_numpy(v) for k, v in b.items()})
        _assert_state_close(_jax_fields(jstate, flat), convert.to_numpy(tstate), rtol,
                            f"round{r + 1}.state", kw["lr"])
        assert tuple(tm._fields) == tuple(jm._fields)
        _assert_tree_close({f: np.asarray(v) for f, v in jm._asdict().items()},
                           convert.to_numpy(tm), rtol, f"round{r + 1}.metrics")
    return jstate, tstate


@pytest.mark.parametrize("layout", ["flat", "tree"])
@pytest.mark.parametrize("algo", ALGOS)
def test_rounds_match_reference(algo, layout):
    run_pair("mlp", algo, layout)


@pytest.mark.parametrize("algo,layout,extra", [
    ("mtgc", "flat", {"correction_init": "gradient"}),
    ("mtgc", "tree", {"correction_init": "gradient"}),
    ("group_corr", "flat", {"correction_init": "gradient"}),
    ("mtgc", "flat", {"server_lr": 0.5}),
    ("mtgc", "tree", {"server_lr": 0.5}),
    ("mtgc", "flat", {"fusion": "fused"}),
    ("mtgc", "tree", {"fusion": "fused"}),
])
def test_round_variants_match_reference(algo, layout, extra):
    run_pair("mlp", algo, layout, extra)


@pytest.mark.parametrize("layout,fusion", [("flat", "none"), ("flat", "fused"),
                                           ("tree", "fused")])
def test_cnn_rounds_match_reference(layout, fusion):
    run_pair("cnn", "mtgc", layout, {"fusion": fusion}, rtol=CNN_RTOL)


def test_fused_equals_unfused_on_cpu():
    """On CPU tensors the fused step takes the kernel's plain version, whose
    op order is the unfused mtgc step's: the two layouts' fused and unfused
    rounds agree bit for bit."""
    factory, feat = MODELS["mlp"]
    _, tapply = factory(tsmall)
    loss = tsmall.make_loss(tapply)
    p0 = tsmall.mlp(10, 16, hidden=32)[0](torch.Generator().manual_seed(0), device="cpu")
    b = {k: torch.from_numpy(v) for k, v in _batches(0, feat).items()}
    for layout in ("flat", "tree"):
        out = []
        for fusion in ("none", "fused"):
            spec = tapi.ExperimentSpec(
                levels=(G, K), schedule=tapi.RoundSchedule(group_rounds=E, local_steps=H),
                state_layout=layout, fusion=fusion)
            eng = tapi.build(spec, loss, device="cpu")
            state, m = eng.round_fn(eng.init(p0), b)
            out.append((convert.to_numpy(state), convert.to_numpy(m)))
        _assert_tree_close(out[0][0], out[1][0], 0.0, f"{layout}.state")
        _assert_tree_close(out[0][1], out[1][1], 0.0, f"{layout}.metrics")


def test_global_model_and_state_layout():
    """hfl_init broadcasts one model to every client; global_model reads it
    back as a tree in both layouts, with the reference's leaf shapes."""
    init, _ = tsmall.cnn(10, (8, 8, 1))
    p0 = init(torch.Generator().manual_seed(1), device="cpu")
    for layout in ("flat", "tree"):
        spec = tapi.ExperimentSpec(levels=(G, K), state_layout=layout)
        eng = tapi.build(spec, lambda p, b: None, device="cpu")
        state = eng.init(p0)
        gm = eng.global_model(state)
        for name in p0:
            for leaf in p0[name]:
                assert torch.equal(gm[name][leaf], p0[name][leaf])
        assert int(state.round) == 0
        if layout == "flat":
            assert tuple(state.params.bufs["float32"].shape)[:2] == (G, K)
            assert tuple(state.y.bufs["float32"].shape)[0] == G
