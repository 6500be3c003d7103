"""The port's flat-state packer against the reference's (core/packer.py).

The segment table (leaf order, buffers, offsets, sizes, shapes and
``buffer_sizes``) must equal ``repro.core.packer.make_packer``'s exactly on
the same template, so ``[G, K, N]`` buffers cross between the packages
through numpy unchanged.
"""
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro import api as japi  # noqa: E402
from repro.core import packer as jpacker  # noqa: E402
from repro.models import small as jsmall  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import packer as tpacker  # noqa: E402
from repro_torch.core import tree as tu  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """One intra-op thread: the suite runs files in parallel workers, and
    PyTorch's default of one thread per core would crowd out the other
    workers' (timing-sensitive) tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

TEMPLATES = {
    "mlp": lambda m: m.mlp(10, 16, hidden=32),
    "deep_mlp": lambda m: m.deep_mlp(10, 16, hidden=8, depth=12),
    "cnn": lambda m: m.cnn(10, (8, 8, 1)),
}


def _params(name):
    init, _ = TEMPLATES[name](jsmall)
    p = init(jax.random.PRNGKey(0))
    return p, convert.params_from_numpy(jax.tree.map(np.asarray, p), "cpu")


@pytest.mark.parametrize("name", sorted(TEMPLATES))
def test_segment_table_equals_reference(name):
    jp, tp = _params(name)
    jpk, tpk = jpacker.make_packer(jp), tpacker.make_packer(tp)
    assert tpk.buffer_sizes == jpk.buffer_sizes
    assert tpk.num_params == jpk.num_params
    assert len(tpk.segments) == len(jpk.segments)
    for ts, js in zip(tpk.segments, jpk.segments):
        assert (ts.buffer, ts.offset, ts.size, ts.shape) == (
            js.buffer, js.offset, js.size, js.shape)
    # Leaf order is jax.tree's: sorted keys at every level.
    paths = [jax.tree_util.keystr(k) for k, _ in jax.tree_util.tree_flatten_with_path(jp)[0]]
    assert ["".join(f"['{p}']" for p in path) for path in tpk.paths] == paths
    assert tpk.state_bytes((2, 3)) == jpk.state_bytes((2, 3))


def test_cnn_leaf_order():
    _, tp = _params("cnn")
    assert ["/".join(p) for p in tpacker.make_packer(tp).paths] == [
        "c1/b", "c1/w", "c2/b", "c2/w", "f1/b", "f1/w", "out/b", "out/w"]


@pytest.mark.parametrize("name", sorted(TEMPLATES))
@pytest.mark.parametrize("lead", [(), (3,), (2, 3)])
def test_flatten_matches_reference_and_round_trips(name, lead):
    jp, tp = _params(name)
    rng = np.random.default_rng(len(lead))
    jtree = jax.tree.map(lambda a: jnp.asarray(
        rng.normal(size=lead + a.shape).astype(np.float32)), jp)
    ttree = convert.params_from_numpy(jax.tree.map(np.asarray, jtree), "cpu")
    jflat = jpacker.make_packer(jp).flatten(jtree)
    tpk = tpacker.make_packer(tp)
    tflat = tpk.flatten(ttree)
    assert tflat.lead_shape == lead
    for k, b in jflat.bufs.items():
        np.testing.assert_array_equal(convert.to_numpy(tflat.bufs[k]), np.asarray(b))
    back = tpk.unflatten(tflat)
    for (pa, a), (pb, b) in zip(tpacker.tree_paths(back), tpacker.tree_paths(ttree)):
        assert pa == pb and torch.equal(a, b)
    assert torch.equal(tpk.flatten(back).bufs["float32"], tflat.bufs["float32"])


def test_mixed_dtype_buffers():
    tree = {"a": torch.ones(3, dtype=torch.bfloat16), "b": torch.arange(4.0),
            "c": {"d": torch.zeros(2, 2, dtype=torch.bfloat16)}}
    pk = tpacker.make_packer(tree)
    assert pk.buffer_sizes == (("bfloat16", 7), ("float32", 4))
    flat = pk.flatten(tu.tree_map(lambda t: t.expand((2,) + tuple(t.shape)), tree))
    assert {k: tuple(v.shape) for k, v in flat.bufs.items()} == {
        "bfloat16": (2, 7), "float32": (2, 4)}
    assert pk.zeros((2,)).bufs["bfloat16"].dtype == torch.bfloat16
    assert tpacker.as_tree(flat)["c"]["d"].shape == (2, 2, 2)
    assert tpacker.as_tree(tree) is tree and not tpacker.is_flat(tree)


def test_reference_flat_state_crosses_through_numpy():
    """A JAX FlatBuffers state, handed over as numpy buffers, unpacks in
    the port to the same tree the reference unpacks."""
    jinit, japply = jsmall.cnn(10, (8, 8, 1))
    p0 = jinit(jax.random.PRNGKey(3))
    spec = japi.ExperimentSpec(levels=(2, 3))
    jstate = japi.build(spec, jsmall.make_loss(japply)).init(p0)
    jstate = jstate._replace(z=jax.tree.map(lambda b: b + 0.5, jstate.z))
    fields = [{k: np.asarray(v) for k, v in getattr(jstate, f).bufs.items()}
              for f in ("params", "z", "y", "dyn")]
    tstate = convert.state_from_numpy(*fields, round=7, template=jax.tree.map(np.asarray, p0),
                                      device="cpu")
    assert int(tstate.round) == 7
    for f in ("params", "z", "y", "dyn"):
        jt = jpacker.as_tree(getattr(jstate, f))
        tt = tpacker.as_tree(getattr(tstate, f))
        for (path, a) in tpacker.tree_paths(tt):
            node = jt
            for k in path:
                node = node[k]
            np.testing.assert_array_equal(convert.to_numpy(a), np.asarray(node))
    back = convert.to_numpy(tstate)
    for k, v in jstate.z.bufs.items():
        np.testing.assert_array_equal(back["z"][k], np.asarray(v))


def test_bfloat16_crosses_bit_for_bit():
    a = np.asarray(jnp.asarray(np.linspace(-3, 3, 17), jnp.bfloat16))
    t = convert.tensor_from_numpy(a, "cpu")
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(convert.to_numpy(t), a.astype(np.float32))


def test_tree_helpers_match_reference():
    """core/tree.py's helpers against repro.core.tree on the same stacked
    trees, including FlatBuffers (mapped buffer by buffer)."""
    from repro.core import tree as jtree
    rng = np.random.default_rng(4)
    shapes = {"a": {"w": (2, 3, 4, 5), "b": (2, 3, 5)}, "c": (2, 3, 7)}
    mk = lambda: jax.tree.map(lambda s: rng.normal(size=s).astype(np.float32), shapes,
                              is_leaf=lambda s: isinstance(s, tuple))
    na, nb = mk(), mk()
    ja, jb = jax.tree.map(jnp.asarray, na), jax.tree.map(jnp.asarray, nb)
    ta, tb = (convert.params_from_numpy(t, "cpu") for t in (na, nb))
    mask = np.array([[1, 0, 1], [0, 0, 1]], np.float32)

    def same(jt, tt, rtol=1e-6):
        for (path, t) in tpacker.tree_paths(tt):
            node = jt
            for k in path:
                node = node[k]
            np.testing.assert_allclose(convert.to_numpy(t), np.asarray(node), rtol=rtol,
                                       atol=1e-6)

    same(jtree.tree_add(ja, jb), tu.tree_add(ta, tb))
    same(jtree.tree_sub(ja, jb), tu.tree_sub(ta, tb))
    same(jtree.tree_mean(ja, 1), tu.tree_mean(ta, 1))
    same(jtree.tree_mean(ja, (0, 1)), tu.tree_mean(ta, (0, 1)))
    same(jtree.tree_zeros_like(ja), tu.tree_zeros_like(ta))
    same(jtree.tree_select(jnp.asarray(mask), ja, jb),
         tu.tree_select(torch.from_numpy(mask), ta, tb))
    same(jtree.tree_broadcast_to_axis(jtree.tree_mean(ja, 1), 1, 4),
         tu.tree_broadcast_to_axis(tu.tree_mean(ta, 1), 1, 4))
    np.testing.assert_allclose(tu.tree_sq_norm(ta).item(), float(jtree.tree_sq_norm(ja)),
                               rtol=1e-6)
    # FlatBuffers map buffer by buffer and keep their packer.
    tmpl = tu.tree_map(lambda t: t[0, 0], ta)
    pk = tpacker.make_packer(tmpl)
    fa, fb = pk.flatten(ta), pk.flatten(tb)
    fs = tu.tree_add(fa, fb)
    assert tpacker.is_flat(fs) and fs.packer is pk
    assert torch.equal(fs.bufs["float32"], fa.bufs["float32"] + fb.bufs["float32"])
    np.testing.assert_allclose(tu.tree_sq_norm(fa).item(), tu.tree_sq_norm(ta).item(),
                               rtol=1e-5)
