"""The port's small models against the JAX package's on the same params:
logits, loss and per-client gradients (the engine's vmap over [G, K]),
rtol 1e-5 in float32. The CNNs' gradients sum their convolutions in
another order in XLA and in PyTorch (a few weight-gradient entries differ
by ~5e-5 relative), so they are held at rtol 1e-4, never looser."""
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.core import engine as jengine  # noqa: E402
from repro.models import small as jsmall  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import engine as tengine  # noqa: E402
from repro_torch.core.packer import tree_paths  # noqa: E402
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

RTOL, ATOL = 1e-5, 1e-6
CNN_GRAD_RTOL = 1e-4
MODELS = {
    "mlp": (lambda m: m.mlp(10, 16, hidden=32), (16,)),
    "deep_mlp": (lambda m: m.deep_mlp(10, 16, hidden=8, depth=4), (16,)),
    "cnn": (lambda m: m.cnn(10, (8, 8, 1)), (8, 8, 1)),
    "cnn_rgb": (lambda m: m.cnn(10, (12, 12, 3)), (12, 12, 3)),
}


def _close(want_tree, got_tree, tag, rtol):
    got = dict(tree_paths(convert.to_numpy(got_tree)))
    for path, w in tree_paths(jax.tree.map(np.asarray, want_tree)):
        np.testing.assert_allclose(got[path], w, rtol=rtol, atol=ATOL, err_msg=f"{tag}{path}")


def _setup(name, lead, batch=5, seed=0):
    factory, feat = MODELS[name]
    jinit, japply = factory(jsmall)
    _, tapply = factory(tsmall)
    p = jinit(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    x = rng.normal(size=lead + (batch,) + feat).astype(np.float32)
    y = rng.integers(0, 10, size=lead + (batch,)).astype(np.int32)
    return p, japply, tapply, x, y


@pytest.mark.parametrize("name", sorted(MODELS))
def test_logits_and_loss_match(name):
    p, japply, tapply, x, y = _setup(name, ())
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, p), "cpu")
    np.testing.assert_allclose(
        tapply(tp, torch.from_numpy(x)).numpy(), np.asarray(jax.jit(japply)(p, jnp.asarray(x))),
        rtol=RTOL, atol=ATOL)
    jl = jax.jit(jsmall.make_loss(japply))(p, {"x": jnp.asarray(x), "y": jnp.asarray(y)})
    tl = tsmall.make_loss(tapply)(tp, {"x": torch.from_numpy(x), "y": torch.from_numpy(y)})
    np.testing.assert_allclose(tl.item(), float(jl), rtol=RTOL)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_per_client_grads_match(name):
    """Per-client (loss, grad) over [G, K] with per-client weights."""
    G, K = 2, 3
    p, japply, tapply, x, y = _setup(name, (G, K), seed=1)
    rng = np.random.default_rng(2)
    jstack = jax.tree.map(
        lambda a: jnp.asarray(np.asarray(a)[None, None]
                              + 0.01 * rng.normal(size=(G, K) + a.shape).astype(np.float32)),
        p)
    tstack = convert.params_from_numpy(jax.tree.map(np.asarray, jstack), "cpu")
    jloss, jgrad = jax.jit(lambda p_, b_: jengine._client_grads(
        jsmall.make_loss(japply), p_, b_))(jstack, {"x": jnp.asarray(x), "y": jnp.asarray(y)})
    tloss, tgrad = tengine._client_grads(tsmall.make_loss(tapply), tstack,
                                         {"x": torch.from_numpy(x), "y": torch.from_numpy(y)})
    np.testing.assert_allclose(tloss.numpy(), np.asarray(jloss), rtol=RTOL, atol=ATOL)
    _close(jgrad, tgrad, f"{name}.grad", CNN_GRAD_RTOL if name.startswith("cnn") else RTOL)


def test_port_init_shapes_match_reference():
    """The port's own init (from a torch.Generator) gives the reference's
    leaf names, shapes and dtypes."""
    for name, (factory, _) in MODELS.items():
        jp = factory(jsmall)[0](jax.random.PRNGKey(0))
        tp = factory(tsmall)[0](torch.Generator().manual_seed(0), device="cpu")
        want = [(path, tuple(a.shape), a.dtype.name) for path, a in
                tree_paths(jax.tree.map(np.asarray, jp))]
        got = [(path, tuple(t.shape), str(t.dtype).removeprefix("torch."))
               for path, t in tree_paths(tp)]
        assert got == want, name


def test_accuracy():
    _, tapply = tsmall.mlp(3, 4, hidden=8)
    p = tsmall.mlp(3, 4, hidden=8)[0](torch.Generator().manual_seed(0), device="cpu")
    x = torch.randn(20, 4, generator=torch.Generator().manual_seed(1))
    pred = torch.argmax(tapply(p, x), -1)
    y = pred.clone()
    y[:5] = (y[:5] + 1) % 3
    assert tsmall.make_accuracy(tapply, x, y)(p).item() == pytest.approx(0.75)
