"""The port's mtgc_update kernels on the CPU: their plain versions against
the JAX oracles and Pallas kernels (interpret mode), and the wrappers'
dispatch. The CUDA kernels themselves are tested on a card by
tests/test_torch_cuda.py.

Sweeps follow tests/test_kernels.py (shapes, float32/bfloat16, mask,
g_scale) with the reference's own tolerances: rtol/atol 1e-6 in float32
and 1e-2 in bfloat16.
"""
import pytest

pytest.importorskip("torch")

import importlib  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.convert import tensor_from_numpy, to_numpy  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels import mtgc_update as mu  # noqa: E402
from torch_devices import other_device  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """One intra-op thread: the suite runs files in parallel workers, and
    PyTorch's default of one thread per core would crowd out the other
    workers' (timing-sensitive) tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

# The package re-exports the function under the module's name.
jmu = importlib.import_module("repro.kernels.mtgc_update")

DTYPES = {"float32": (jnp.float32, 1e-6), "bfloat16": (jnp.bfloat16, 1e-2)}


def _pair(arrays, jdtype):
    """The same values as JAX arrays and CPU tensors of one dtype."""
    jx = [jnp.asarray(a, jdtype) for a in arrays]
    return jx, [tensor_from_numpy(np.asarray(a), "cpu") for a in jx]


@pytest.mark.parametrize("shape", [(5,), (128,), (1000,), (33, 129), (2, 3, 130)])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_leaf_plain_matches_reference(shape, dtype):
    jdtype, tol = DTYPES[dtype]
    rng = np.random.default_rng(len(shape) * 1000 + shape[-1])
    jx, tx = _pair([rng.normal(size=shape) for _ in range(4)], jdtype)
    got = mu.mtgc_update_ref(*tx, 0.1)
    assert got.dtype == tx[0].dtype and tuple(got.shape) == shape
    got = to_numpy(got)
    for want in (jref.mtgc_update_ref(*jx, 0.1),
                 jmu.mtgc_update(*jx, lr=0.1, interpret=True, block_rows=8)):
        np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=tol, atol=tol)


@pytest.mark.parametrize("G,K,N", [(2, 2, 300), (3, 1, 1), (1, 4, 128 * 9 + 5),
                                   (2, 3, 4096)])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_flat_plain_matches_reference(G, K, N, masked, dtype):
    jdtype, tol = DTYPES[dtype]
    rng = np.random.default_rng(G * 100 + K * 10 + N + masked)
    arrays = [rng.normal(size=(G, K, N)) for _ in range(3)] + [rng.normal(size=(G, N))]
    jx, tx = _pair(arrays, jdtype)
    mask = rng.integers(0, 2, size=(G, K)).astype(np.float32) if masked else None
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.from_numpy(mask)
    got = mu.mtgc_update_flat_ref(*tx, tm, 0.07, 0.5)
    assert got.dtype == tx[0].dtype and tuple(got.shape) == (G, K, N)
    got_np = to_numpy(got)
    wants = [jref.mtgc_update_flat_ref(*jx, jm, 0.07, 0.5)]
    if dtype == "float32":
        wants.append(jmu.mtgc_update_flat(*jx, jm, lr=0.07, g_scale=0.5, interpret=True,
                                          block_rows=16))
    for want in wants:
        np.testing.assert_allclose(got_np, np.asarray(want, np.float32), rtol=tol, atol=tol)
    if masked:
        frozen = mask == 0
        assert torch.equal(got[torch.from_numpy(frozen)], tx[0][torch.from_numpy(frozen)])


def test_flat_plain_nonfinite_row_isolation():
    """A masked-out replica keeps its exact bits even when its g/z carry
    NaN/Inf, and a poisoned active row contaminates only itself
    (tests/test_kernels.py::test_mtgc_update_flat_nonfinite_row_isolation)."""
    G, K, N = 2, 3, 300
    rng = np.random.default_rng(0)
    x = rng.normal(size=(G, K, N)).astype(np.float32)
    g = rng.normal(size=(G, K, N)).astype(np.float32)
    z = rng.normal(size=(G, K, N)).astype(np.float32)
    y = rng.normal(size=(G, N)).astype(np.float32)
    g[0, 1] = np.nan
    z[0, 1] = np.inf
    g[1, 2] = np.nan
    mask = np.ones((G, K), np.float32)
    mask[0, 1] = 0.0
    t = [torch.from_numpy(a) for a in (x, g, z, y, mask)]
    got = to_numpy(mu.mtgc_update_flat(*t[:4], t[4], lr=0.07))
    np.testing.assert_array_equal(got[0, 1], x[0, 1])
    assert not np.isfinite(got[1, 2]).any()
    want = np.asarray(jref.mtgc_update_flat_ref(*(jnp.asarray(a) for a in (x, g, z, y)),
                                                jnp.asarray(mask), 0.07, 1.0))
    for gi in range(G):
        for ki in range(K):
            if (gi, ki) not in ((0, 1), (1, 2)):
                np.testing.assert_allclose(got[gi, ki], want[gi, ki], rtol=1e-6, atol=1e-6)


def test_leaf_plain_nonfinite_propagates():
    """The unmasked leaf update has no gate: NaN in g reaches the output
    (tests/test_kernels.py::test_mtgc_update_tree_nonfinite_propagates)."""
    rng = np.random.default_rng(1)
    x, z, y, g = (torch.from_numpy(rng.normal(size=(40,)).astype(np.float32))
                  for _ in range(4))
    g[7] = float("nan")
    got = mu.mtgc_update(x, g, z, y, lr=0.05)
    assert torch.isnan(got[7])
    assert torch.isfinite(torch.cat([got[:7], got[8:]])).all()


def test_cpu_tensors_take_the_plain_version_without_a_launch():
    """The wrappers pick the plain version only because the tensors are on
    the CPU; no launch is counted. ``ops`` hands the engine the wrappers
    themselves, launch counters included."""
    assert ops.mtgc_update is mu.mtgc_update
    assert ops.mtgc_update_flat is mu.mtgc_update_flat
    rng = np.random.default_rng(2)
    x, g, z = (torch.from_numpy(rng.normal(size=(2, 3, 50)).astype(np.float32))
               for _ in range(3))
    y = torch.from_numpy(rng.normal(size=(2, 50)).astype(np.float32))
    mu.reset_launch_counts()
    assert torch.equal(ops.mtgc_update_flat(x, g, z, y, lr=0.1),
                       mu.mtgc_update_flat_ref(x, g, z, y, None, 0.1))
    assert torch.equal(ops.mtgc_update(x, g, z, x, lr=0.1),
                       mu.mtgc_update_ref(x, g, z, x, 0.1))
    assert mu.mtgc_update_flat.launches == 0 and mu.mtgc_update.launches == 0


@pytest.mark.parametrize("masked", [False, True])
def test_flat_out_argument_updates_in_place(masked):
    """``out=x`` writes the update into x itself (the sharded trainer's
    fused step) and gives what the out-of-place call returns; a separate
    ``out`` leaves x alone."""
    rng = np.random.default_rng(3)
    x, g, z = (torch.from_numpy(rng.normal(size=(2, 3, 40)).astype(np.float32))
               for _ in range(3))
    y = torch.from_numpy(rng.normal(size=(2, 40)).astype(np.float32))
    mask = torch.tensor([[1.0, 0.0, 1.0], [0.0, 1.0, 1.0]]) if masked else None
    want = mu.mtgc_update_flat(x, g, z, y, mask, lr=0.1, g_scale=0.5)
    x0 = x.clone()
    out = torch.empty_like(x)
    assert mu.mtgc_update_flat(x, g, z, y, mask, lr=0.1, g_scale=0.5, out=out) is out
    assert torch.equal(out, want) and torch.equal(x, x0)
    assert mu.mtgc_update_flat(x, g, z, y, mask, lr=0.1, g_scale=0.5, out=x) is x
    assert torch.equal(x, want)


def test_flat_out_argument_rejects_overlap_and_bad_shape():
    x, g, z = (torch.zeros(2, 2, 8) for _ in range(3))
    y = torch.zeros(2, 8)
    with pytest.raises(ValueError, match="overlap"):
        mu.mtgc_update_flat(x, g, z, y, lr=0.1, out=g)
    buf = torch.zeros(2 * 2 * 8 + 4)
    with pytest.raises(ValueError, match="overlap"):
        mu.mtgc_update_flat(buf[:32].view(2, 2, 8), g, z, y, lr=0.1,
                            out=buf[4:].view(2, 2, 8))
    with pytest.raises(ValueError, match="shape"):
        mu.mtgc_update_flat(x, g, z, y, lr=0.1, out=torch.zeros(2, 2, 9))


def test_other_devices_raise():
    """Neither wrapper falls back to the plain version off the CPU; a meta
    tensor gets the output's shape."""
    x, y = other_device(2, 3, 4), other_device(2, 4)
    with pytest.raises(ValueError, match="runs on cpu or cuda"):
        mu.mtgc_update_flat(x, x, x, y, lr=0.1)
    with pytest.raises(ValueError, match="runs on cpu or cuda"):
        mu.mtgc_update(x, x, x, x, lr=0.1)
    x = torch.empty((2, 3, 4), device="meta")
    y = torch.empty((2, 4), device="meta")
    assert mu.mtgc_update_flat(x, x, x, y, lr=0.1).shape == x.shape
    assert mu.mtgc_update_flat(x, x, x, y, lr=0.1, out=x) is x
    assert mu.mtgc_update(x, x, x, x, lr=0.1).device.type == "meta"


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """A host without the CUDA compiler gets an error, never a quiet build
    skip."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    if build.Path("/usr/local/cuda/bin/nvcc").is_file():
        pytest.skip("this host has a CUDA toolkit at /usr/local/cuda")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.nvcc_path()


def test_library_name_tracks_the_source():
    """The built library's name carries a hash of the source and flags, so
    an edited kernel is rebuilt rather than a stale one loaded."""
    p = build.library_path("mtgc_update")
    assert p.parent == build.BUILD_DIR and p.name.startswith("libmtgc_update-")
    assert p == build.library_path("mtgc_update")
