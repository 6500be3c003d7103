"""The port's multi-card mesh, its pure parts, against the JAX package:
the plans, the assigned shapes, the partition rules of every arch's
full-size parameters (``train_state_specs`` at its plan's axis sizes,
``serve_param_specs`` at kv-split sizes), the cache and batch rules, and
the production meshes at 256 and 512 ranks, built in this process over
PyTorch's ``fake`` process-group backend (the counterparts of
``tests/test_system.py``'s partition-spec tests).

The port's full-size parameter trees are ``meta`` tensors
(``configs.shapes.param_specs``); the reference's come from
``jax.eval_shape``. Spec trees are compared leaf for leaf by path. The
reference's serve rules read a JAX mesh's ``axis_names`` and
``devices.shape`` only, so they take a stand-in with those two.
"""
import contextlib
import dataclasses
import functools
import types

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
from jax.sharding import PartitionSpec  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.configs import shapes as jshapes  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro.models.transformer import build_model as jbuild  # noqa: E402
from repro.sharding import specs as jspecs  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.configs import shapes as tshapes  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models.transformer import build_model as tbuild  # noqa: E402
from repro_torch.sharding import specs as tspecs  # noqa: E402

ARCHS = jconfigs.ARCH_IDS
MOE = tuple(a for a in ARCHS if jconfigs.get_arch(a).num_experts)


@contextlib.contextmanager
def fake_world(n: int, rank: int = 0):
    """A process group of ``n`` ranks over the ``fake`` backend, this
    process rank ``rank``."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


@functools.lru_cache(maxsize=None)
def _shapes(arch):
    """(reference eval_shape tree, port meta tree) of the full-size params."""
    jcfg, tcfg = jconfigs.get_arch(arch), tconfigs.get_arch(arch)
    return (jax.eval_shape(jbuild(jcfg).init, jax.random.PRNGKey(0)),
            tshapes.param_specs(tcfg, tbuild(tcfg)))


def _jleaves(tree, is_spec=False):
    """{path: leaf} of a reference tree (PartitionSpecs as tuples)."""
    kw = dict(is_leaf=lambda x: isinstance(x, PartitionSpec)) if is_spec else {}
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, **kw)
    return {"/".join(str(k.key) for k in path): (tuple(v) if is_spec else v) for path, v in flat}


def _tleaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_tleaves(tree[k], f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tree}


def _same_meta(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k]
        assert g.device.type == "meta", k
        assert tuple(g.shape) == tuple(w.shape), k
        assert str(g.dtype).replace("torch.", "") == str(w.dtype), k


# ------------------------------------------------------------------ configs


def test_registry_is_the_reference():
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS
    assert tconfigs.SHAPE_IDS == jconfigs.SHAPE_IDS
    assert set(tconfigs.PORTED) == set(ARCHS)
    archs = tconfigs.all_archs()
    assert tuple(archs) == ARCHS
    for a, cfg in archs.items():
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jconfigs.get_arch(a))


@pytest.mark.parametrize("arch", ARCHS)
def test_plan_is_the_reference(arch):
    got, want = tconfigs.get_plan(arch), jconfigs.get_plan(arch)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.validate(256) is got
    g, k, f, m = got.train_factors
    assert g * k * f * m == 256 and got.clients == want.clients == g * k
    with pytest.raises(AssertionError):
        got.validate(512)


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_specs_are_the_reference(arch, multi_pod):
    cfg, plan = tconfigs.get_arch(arch), tconfigs.get_plan(arch)
    want = jshapes.train_specs(jconfigs.get_arch(arch), jconfigs.get_plan(arch),
                               multi_pod=multi_pod)
    _same_meta(tshapes.train_specs(cfg, plan, multi_pod=multi_pod), want)


@pytest.mark.parametrize("shape_id", ["prefill_32k", "decode_32k", "long_500k"])
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_specs_are_the_reference(arch, shape_id):
    jcfg, tcfg = jconfigs.get_arch(arch), tconfigs.get_arch(arch)
    try:
        want = jshapes.serve_specs(jcfg, shape_id)
    except jshapes.SkipShape as e:
        with pytest.raises(tshapes.SkipShape, match="long_500k skipped"):
            tshapes.serve_specs(tcfg, shape_id)
        assert "long_500k skipped" in str(e)
        return
    got = tshapes.serve_specs(tcfg, shape_id)
    _same_meta(_tleaves(got), _jleaves(want))


def test_long_500k_skip_set():
    """tests/test_system.py::test_shape_skip_rules on the port."""
    skipped = set()
    for arch in ARCHS:
        try:
            tshapes.serve_specs(tconfigs.get_arch(arch), "long_500k")
        except tshapes.SkipShape:
            skipped.add(arch)
    assert skipped == {"internvl2-26b", "whisper-medium", "glm4-9b", "qwen2.5-32b",
                       "qwen3-14b", "granite-moe-1b-a400m"}
    assert tshapes.SHAPES == jshapes.SHAPES


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_are_the_full_tree_on_meta(arch):
    """Every leaf of the full-size parameter tree, path, shape and dtype,
    on the meta device (nothing allocated, nothing drawn)."""
    want, got = _shapes(arch)
    _same_meta(_tleaves(got), _jleaves(want))


# ------------------------------------------------------------------ rules


def _train_sizes(arch, multi_pod=False):
    g, k, f, m = tconfigs.get_plan(arch).train_factors
    return {"group": g * (2 if multi_pod else 1), "client": k, "fsdp": f, "model": m}


@pytest.mark.parametrize("arch", ARCHS)
def test_train_state_specs_are_the_reference(arch):
    """params / z / y spec trees at the plan's axis sizes, leaf for leaf
    (tests/test_system.py::test_param_specs_cover_every_leaf's rules), and
    every sharded dim divides its axis."""
    jp, tp = _shapes(arch)
    sizes = _train_sizes(arch)
    want = jspecs.train_state_specs(jp, sizes, cfg=jconfigs.get_arch(arch))
    got = tspecs.train_state_specs(tp, sizes, cfg=tconfigs.get_arch(arch))
    assert set(got) == set(want) == {"params", "z", "y"}
    leaves = _tleaves(tp)
    for field in want:
        w, g = _jleaves(want[field], is_spec=True), _tleaves(got[field])
        assert g.keys() == w.keys()
        for path, spec in w.items():
            assert isinstance(g[path], tspecs.PartitionSpec)
            assert tuple(g[path]) == spec, (field, path)
            lead = (2,) if field != "y" else (1,)
            shape = (sizes["group"], sizes["client"])[:lead[0]] + tuple(leaves[path].shape)
            for dim, ax in zip(shape, spec):
                if ax is not None:
                    assert dim % sizes[ax] == 0, (field, path, dim, ax)


@pytest.mark.parametrize("ep", ["1", "0"])
@pytest.mark.parametrize("arch", MOE)
def test_moe_expert_parallel_switch(arch, ep, monkeypatch):
    """``REPRO_MOE_EP`` switches expert parallelism in both packages."""
    monkeypatch.setenv("REPRO_MOE_EP", ep)
    jp, tp = _shapes(arch)
    sizes = dict(_train_sizes(arch), fsdp=8)
    want = _jleaves(jspecs.param_spec_tree(jp, axis_sizes=sizes, cfg=jconfigs.get_arch(arch)),
                    is_spec=True)
    got = _tleaves(tspecs.param_spec_tree(tp, axis_sizes=sizes, cfg=tconfigs.get_arch(arch)))
    assert {k: tuple(v) for k, v in got.items()} == want
    moe = [k for k in want if "/moe/" in k and len(want[k]) == 4]
    assert moe and all((want[k][1] == "fsdp") == (ep == "1") for k in moe)


def _serve_sizes(arch):
    cfg = tconfigs.get_arch(arch)
    kv = tmesh.serve_kv_split(cfg.num_heads, cfg.num_kv_heads)
    assert kv == jmesh.serve_kv_split(cfg.num_heads, cfg.num_kv_heads)
    if kv > 1:
        return {"data": 16, "kv": kv, "tp": 16 // kv}
    return {"data": 16, "model": 16}


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_param_specs_are_the_reference(arch):
    """Single-copy serving params at the arch's kv-split sizes, leaf for
    leaf; the ("kv", "tp") dims keep kv major."""
    jp, tp = _shapes(arch)
    sizes = _serve_sizes(arch)
    want = _jleaves(jspecs.serve_param_specs(jconfigs.get_arch(arch), jp, sizes), is_spec=True)
    got = _tleaves(tspecs.serve_param_specs(tconfigs.get_arch(arch), tp, sizes))
    assert {k: tuple(v) for k, v in got.items()} == want
    if "kv" in sizes:
        assert any(("kv", "tp") in s for s in want.values())


def _jmesh_like(sizes: dict):
    return types.SimpleNamespace(axis_names=tuple(sizes),
                                 devices=np.empty(tuple(sizes.values())))


def _tmesh_like(sizes: dict):
    return types.SimpleNamespace(mesh_dim_names=tuple(sizes), shape=tuple(sizes.values()))


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("shape_id", ["prefill_32k", "decode_32k", "long_500k"])
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cache_and_batch_specs_are_the_reference(arch, shape_id, multi_pod):
    jcfg, tcfg = jconfigs.get_arch(arch), tconfigs.get_arch(arch)
    if shape_id == "long_500k" and not tcfg.sub_quadratic:
        return
    sizes = _serve_sizes(arch)
    if multi_pod:
        sizes = {"pod": 2, **sizes}
    jm, tm = _jmesh_like(sizes), _tmesh_like(sizes)
    assert tspecs.serve_data_axes(tm) == jspecs.serve_data_axes(jm)
    want, got = jshapes.serve_specs(jcfg, shape_id), tshapes.serve_specs(tcfg, shape_id)
    wc = _jleaves(jspecs.serve_cache_specs(jcfg, want["cache"], shape_id, jm), is_spec=True)
    gc = _tleaves(tspecs.serve_cache_specs(tcfg, got["cache"], shape_id, tm))
    assert {k: tuple(v) for k, v in gc.items()} == wc
    wb = _jleaves(jspecs.serve_batch_specs(want["batch"], jm), is_spec=True)
    gb = _tleaves(tspecs.serve_batch_specs(got["batch"], tm))
    assert {k: tuple(v) for k, v in gb.items()} == wb


def test_batch_spec_and_lead_are_the_reference():
    cfg, plan = tconfigs.get_arch("internvl2-26b"), tconfigs.get_plan("internvl2-26b")
    tb = tshapes.train_specs(cfg, plan)
    jb = jshapes.train_specs(jconfigs.get_arch("internvl2-26b"),
                             jconfigs.get_plan("internvl2-26b"))
    want = _jleaves(jspecs.train_batch_spec(jb), is_spec=True)
    assert {k: tuple(v) for k, v in _tleaves(tspecs.train_batch_spec(tb)).items()} == want
    jp, tp = _shapes("glm4-9b")
    _same_meta(_tleaves(tspecs.with_lead(tp, (4, 2))), _jleaves(jspecs.with_lead(jp, (4, 2))))


# ------------------------------------------------------------------ meshes


@pytest.mark.parametrize("multi_pod", [False, True])
def test_train_meshes_at_256_and_512(multi_pod):
    """Every arch's logical train mesh over the fake backend: dims named,
    the plan's shape (pods multiply ``group``), the physical rank order
    relabelled, and every sharded dim of its training state divides."""
    n = 512 if multi_pod else 256
    with fake_world(n):
        prod = tmesh.make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        assert prod.mesh_dim_names == (("pod", "data", "model") if multi_pod
                                       else ("data", "model"))
        assert torch.equal(prod.mesh.flatten(), torch.arange(n, dtype=prod.mesh.dtype))
        for arch in ARCHS:
            plan = tconfigs.get_plan(arch)
            m = tmesh.make_train_mesh(plan, multi_pod=multi_pod, device_type="cpu")
            g, k, f, mm = plan.train_factors
            assert m.mesh_dim_names == ("group", "client", "fsdp", "model")
            assert tuple(m.shape) == ((2 * g if multi_pod else g), k, f, mm)
            assert torch.equal(m.mesh.flatten(), prod.mesh.flatten())
            assert list(m.get_coordinate()) == [0, 0, 0, 0]
            sizes = dict(zip(m.mesh_dim_names, m.shape))
            assert sizes == _train_sizes(arch, multi_pod)
            assert tmesh.describe(m) == (f"mesh{sizes} ({n} chips)")
            _, tp = _shapes(arch)
            specs = tspecs.train_state_specs(tp, sizes, cfg=tconfigs.get_arch(arch))
            for path, spec in _tleaves(specs["params"]).items():
                placements = tspecs.to_placements(m, spec)
                assert len(placements) == 4


@pytest.mark.parametrize("multi_pod", [False, True])
def test_serve_meshes_at_256_and_512(multi_pod):
    """kv-split serve meshes: the (kv, tp) split of the model dim, ranks in
    order, and a ("kv", "tp") dim sharded kv-major by its placements: the
    rank at (kv i, tp j) holds block i * tp + j (checked as that rank)."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    n = 512 if multi_pod else 256
    head = ("pod",) if multi_pod else ()
    for kv in (1, 2, 4, 8, 16):
        tp = 16 // kv
        with fake_world(n):
            m = tmesh.make_serve_mesh(multi_pod=multi_pod, kv=kv, device_type="cpu")
            if kv == 1:
                assert m.mesh_dim_names == head + ("data", "model")
                continue
            assert m.mesh_dim_names == head + ("data", "kv", "tp")
            assert tuple(m.shape) == ((2,) if multi_pod else ()) + (16, kv, tp)
            assert torch.equal(m.mesh.flatten(), torch.arange(n, dtype=m.mesh.dtype))
            spec = tspecs.PartitionSpec(None, ("kv", "tp"))
            pl = tspecs.to_placements(m, spec)
            assert pl == (Replicate(),) * len(head) + (Replicate(), Shard(1), Shard(1))
            with pytest.raises(ValueError, match="out of the mesh's dim order"):
                tspecs.to_placements(m, tspecs.PartitionSpec(None, ("tp", "kv")))
        dim = 16 * 128
        for i, j in ((0, 0), (kv - 1, 0), (kv - 1, tp - 1), (kv // 2, min(1, tp - 1))):
            with fake_world(n, rank=i * tp + j):
                m = tmesh.make_serve_mesh(multi_pod=multi_pod, kv=kv, device_type="cpu")
                assert list(m.get_coordinate()) == [0] * len(head) + [0, i, j]
                shape, off = compute_local_shape_and_global_offset((4, dim), m, pl)
                assert tuple(shape) == (4, dim // 16)
                assert tuple(off) == (0, (i * tp + j) * (dim // 16))


def test_kv_split_and_describe_are_the_reference():
    for arch in ARCHS:
        cfg = tconfigs.get_arch(arch)
        assert (tmesh.serve_kv_split(cfg.num_heads, cfg.num_kv_heads)
                == jmesh.serve_kv_split(cfg.num_heads, cfg.num_kv_heads))
    assert tmesh.SINGLE_POD == jmesh.SINGLE_POD and tmesh.MULTI_POD == jmesh.MULTI_POD
    with fake_world(4):
        m = tmesh.smoke_mesh((2, 2), device_type="cpu")
        assert tmesh.describe(m) == jmesh.describe(_jmesh_like({"data": 2, "model": 2}))


def test_meshes_need_a_process_group_and_a_device():
    with pytest.raises(RuntimeError, match="init_process_group"):
        tmesh.smoke_mesh((1, 1), device_type="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmesh.smoke_mesh((1, 1))
    with fake_world(4):
        with pytest.raises(ValueError, match="needs 256 ranks"):
            tmesh.make_production_mesh(device_type="cpu")
