"""The port's sharded round on a ``torch.distributed`` mesh, on the CPU.

One spawn of four gloo ranks (``tests/torch_mesh_worker.py``, its store a
``FileStore`` under the test's temporary directory, every collective and
the join under a timeout) runs every case on meshes (group, client) =
(2, 2), (2, 1), (1, 2) and (1, 1) over G = K = 2, E = H = A = 2: the
quadratic problem under mtgc and hfedavg, tree and flat, fused and
unfused, at full participation and at partial participation under both
weightings (the masks drawn with the JAX package's key schedule and
injected through ``draws=``), and a reduced glm4-9b under three of those.
Each gathered state is held against the port's single-card round from the
same start and batches -- bit for bit on the (1, 1) mesh, within rtol 1e-6
elsewhere (the states come back bit for bit there too; the metrics sum in
another order) -- and against the JAX package's sharded round at its
parity tolerance (rtol 1e-5, atol 1e-6 for the params, the same over
``H lr`` for z and over ``H E lr`` for y; ROADMAP queue 3 item 2). What a
mesh round rejects is checked in this process on a mesh over PyTorch's
``fake`` process-group backend.
"""
import dataclasses
import functools
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch_mesh_worker as W  # noqa: E402

from repro import api as japi  # noqa: E402
from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.core.participation import sample_hfl_masks as jmasks  # noqa: E402
from repro.models.transformer import build_model as jbuild  # noqa: E402
from repro_torch import api as tapi  # noqa: E402
from repro_torch import convert  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
MASK_KEY = 3
WORLD = 4
JOIN_S = 150
CASES = W.QUAD_CASES + W.LM_CASES
# The reference's reduced glm4 round compiles for 10-17 s on the CPU: one
# LM case is held against it (every combination runs on the quadratic).
REFERENCE_CASES = W.QUAD_CASES + ("lm-mtgc-flat-fused-partial",)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """One intra-op thread, as the ranks run: the suite runs files in
    parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reference_masks() -> dict:
    """The JAX round's masks for ``W.ROUNDS`` rounds from ``PRNGKey(3)``:
    ``mkey, rng = split(rng)`` then ``sample_hfl_masks`` each round."""
    p = W.PARTICIPATION["partial"]
    key, out = jax.random.PRNGKey(MASK_KEY), {}
    for r in range(W.ROUNDS):
        mkey, key = jax.random.split(key)
        m = jmasks(mkey, W.G, W.K, p["client_participation"], p["group_participation"],
                   p["participation_mode"])
        out[f"group{r}"] = np.asarray(m.group, np.float32)
        out[f"client{r}"] = np.asarray(m.client, np.float32)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The directory the four ranks wrote their results to."""
    out = tmp_path_factory.mktemp("mesh")
    np.savez(out / "masks.npz", **_reference_masks())
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests")] + [p for p in [os.environ.get("PYTHONPATH")]
                                                   if p]))
    procs = [subprocess.Popen([sys.executable, str(ROOT / "tests" / "torch_mesh_worker.py"),
                               "--rank", str(r), "--world", str(WORLD), "--out", str(out)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(WORLD)]
    # The references while the ranks run.
    for case in CASES:
        _one_card(case)
    for case in REFERENCE_CASES:
        _reference(case)
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=JOIN_S)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail(f"the mesh ranks did not finish within {JOIN_S} s")
    bad = [(r, p.returncode, log[-3000:]) for r, (p, log) in enumerate(zip(procs, logs))
           if p.returncode != 0]
    assert not bad, bad
    return out


@functools.lru_cache(maxsize=None)
def _masks() -> dict:
    return _reference_masks()


@functools.lru_cache(maxsize=None)
def _one_card(case: str) -> dict:
    return W.to_host(*W.run_case(case, _masks()))


@functools.lru_cache(maxsize=None)
def _reference(case: str) -> dict:
    """The JAX package's sharded round from the same start and batches."""
    c = W.parse(case)
    loss_fn, params, batches = W.problem(c["problem"])
    if c["problem"] == "quad":
        def jloss(p, b):
            r = b["a"] * p["w"] - b["b"]
            return 0.5 * jnp.sum(r * r)
    else:
        jloss = jbuild(jget_arch("glm4-9b").reduced()).loss
    tspec = W.spec_of(case)
    jspec = japi.ExperimentSpec(
        levels=tspec.levels, backend="sharded", lr=tspec.lr, algorithm=tspec.algorithm,
        state_layout=tspec.state_layout, fusion=tspec.fusion,
        fused_mode="interpret" if tspec.fusion == "fused" else None,
        schedule=japi.RoundSchedule(**dataclasses.asdict(tspec.schedule)),
        **W.PARTICIPATION[c["part"]])
    eng = japi.build(jspec, jloss)
    jp = jax.tree.map(jnp.asarray, convert.to_numpy(params))
    st = eng.init(jp, jax.random.PRNGKey(MASK_KEY)) if c["part"] != "full" else eng.init(jp)
    jb = jax.tree.map(jnp.asarray, batches)
    metrics = []
    for _ in range(W.ROUNDS):
        st, m = eng.round_fn(st, jb)
        metrics.append(m)
    out = {}
    for name in ("params", "z", "y"):
        t = getattr(st, name)
        t = t.to_tree() if hasattr(t, "to_tree") else t
        out[name] = jax.tree.map(np.asarray, t)
    out["metrics"] = {f: np.stack([np.asarray(getattr(m, f)) for m in metrics])
                      for f in metrics[0]._fields}
    return out


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_leaves(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree)}


def _load(runs, case, mesh):
    return torch.load(runs / f"{case}@{mesh}.pt", weights_only=False)


@pytest.mark.parametrize("mesh", list(W.MESHES))
@pytest.mark.parametrize("case", CASES)
def test_mesh_round_matches_one_card(runs, case, mesh):
    """The mesh's gathered state, global model and metrics against the
    single-card round: bit for bit on (1, 1), rtol 1e-6 elsewhere."""
    got, want = _load(runs, case, mesh), _one_card(case)
    for name in ("params", "z", "y", "global"):
        g, w = _leaves(got[name]), _leaves(want[name])
        assert g.keys() == w.keys()
        for leaf in w:
            if mesh == "1x1":
                np.testing.assert_array_equal(g[leaf], w[leaf], err_msg=f"{name}{leaf}")
            else:
                np.testing.assert_allclose(g[leaf], w[leaf], rtol=1e-6, atol=0,
                                           err_msg=f"{name}{leaf}")
    for f, w in want["metrics"].items():
        if mesh == "1x1":
            np.testing.assert_array_equal(got["metrics"][f], w, err_msg=f)
        else:
            np.testing.assert_allclose(got["metrics"][f], w, rtol=1e-6, atol=0, err_msg=f)


@pytest.mark.parametrize("mesh", list(W.MESHES))
@pytest.mark.parametrize("case", REFERENCE_CASES)
def test_mesh_round_matches_reference(runs, case, mesh):
    """The mesh's gathered state and metrics against the JAX package's
    sharded round (its masks drawn from the same key)."""
    got, want = _load(runs, case, mesh), _reference(case)
    H, E, lr = W.H, W.E, W.LR
    atol = {"params": 1e-6, "z": 1e-6 / (H * lr), "y": 1e-6 / (H * E * lr)}
    for name, a in atol.items():
        g, w = _leaves(got[name]), _leaves(want[name])
        assert g.keys() == w.keys()
        for leaf in w:
            np.testing.assert_allclose(g[leaf], w[leaf], rtol=1e-5, atol=a,
                                       err_msg=f"{name}{leaf}")
    fields = ("loss", "participation", "comm_bytes")
    if W.parse(case)["part"] == "full":
        fields += ("grad_norm", "z_norm", "y_norm")
    for f in fields:
        np.testing.assert_allclose(got["metrics"][f], want["metrics"][f], rtol=1e-5, err_msg=f)


def test_state_moves_onto_the_mesh_and_back(runs):
    """``shard_state`` gives each rank its rows, ``gather_state`` the whole
    state back bit for bit (tree and flat; params, z, y and both
    residuals)."""
    ok = torch.load(runs / "roundtrip@2x2.pt", weights_only=False)
    assert ok and all(ok.values()), ok


# ------------------------------------------------------------------ rejections


@pytest.fixture
def fake_world():
    """A process group of 4 ranks over PyTorch's ``fake`` backend, in this
    process (rank 0); its meshes are built with device_type="cpu"."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    yield
    dist.destroy_process_group()


def _mesh(shape):
    from repro_torch.launch.mesh import smoke_mesh

    return smoke_mesh(shape, W.MESH_NAMES, device_type="cpu")


def _spec(**kw):
    return dataclasses.replace(W.spec_of("quad-mtgc-flat-fused-full"), **kw)


REJECTED = {
    "compression": dict(compression=tapi.CompressionPlan(client_mode="int8_stochastic")),
    "faults": dict(faults=tapi.FaultPlan(crash_rate=0.1)),
    "defense": dict(defense=tapi.DefensePlan(screen_nonfinite=True)),
    "async": dict(schedule=tapi.RoundSchedule(group_rounds=(2, 1), local_steps=2,
                                              microbatches=2)),
    "population": dict(population=4, levels=(2, 2)),
    "narrow_corrections": dict(correction_dtype="bfloat16", state_layout="tree",
                               fusion="none"),
}


@pytest.mark.parametrize("option", list(REJECTED))
def test_mesh_round_rejects(fake_world, option):
    """Each option the mesh does not run yet raises and names the slice
    that brings it (ROADMAP queue 1)."""
    spec = _spec(**REJECTED[option])
    spec.validate()
    with pytest.raises(ValueError, match="ROADMAP queue 1") as err:
        tapi.build(spec, W.quad_loss, device="cpu", mesh=_mesh((1, 2, 1, 1)))
    assert "mesh" in str(err.value)


@pytest.mark.parametrize("axis,shape", [("fsdp", (1, 1, 2, 1)), ("model", (1, 1, 1, 2))])
def test_mesh_round_rejects_inner_axes(fake_world, axis, shape):
    """An fsdp or model dim larger than 1 raises, naming its slice."""
    with pytest.raises(ValueError, match=f"{axis}=2 .* ROADMAP queue 1"):
        tapi.build(_spec(), W.quad_loss, device="cpu", mesh=_mesh(shape))


def test_mesh_needs_group_and_client_dims(fake_world):
    from repro_torch.launch.mesh import smoke_mesh

    with pytest.raises(ValueError, match="'client' dim"):
        tapi.build(_spec(), W.quad_loss, device="cpu",
                   mesh=smoke_mesh((2, 2), ("group", "data"), device_type="cpu"))
    with pytest.raises(ValueError, match="runs on one device"):
        tapi.build(dataclasses.replace(_spec(), backend="simulator", fusion="none",
                                       schedule=tapi.RoundSchedule(group_rounds=2,
                                                                   local_steps=2)),
                   W.quad_loss, device="cpu", mesh=_mesh((2, 2, 1, 1)))


def test_mesh_levels_must_split(fake_world):
    """Levels that the mesh's dims do not divide raise at init."""
    eng = tapi.build(dataclasses.replace(_spec(), levels=(3, 2)), W.quad_loss, device="cpu",
                     mesh=_mesh((2, 2, 1, 1)))
    with pytest.raises(ValueError, match="do not split"):
        eng.init({"w": torch.zeros(W.D)})
