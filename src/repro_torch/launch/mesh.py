"""Production meshes over ``torch.distributed`` (port of
``src/repro/launch/mesh.py``).

Physical meshes are pinned by the deployment target:

    single-pod : (16, 16)       axes ("data", "model")   = 256 chips
    multi-pod  : (2, 16, 16)    axes ("pod", "data", "model") = 512 chips

The ranks of the default process group are laid out in their order:
rank ``r`` sits at ``r``'s row-major position. Functions (never
module-level constants), so importing this module touches no process
group; each call needs ``torch.distributed.init_process_group`` to have
run with at least as many ranks, and every rank of that group makes the
call (a ``DeviceMesh`` makes one process group per mesh dim). Meshes are
built on the CUDA card unless the caller passes ``device_type="cpu"``.

Training *re-factors the same rank array* into the logical HFL mesh
``(group, client, fsdp, model)`` per the architecture's MeshPlan: groups x
clients carry the paper's topology (MTGC's two all-reduce timescales), and
fsdp x model shard each client's replica. On the multi-pod mesh the pod
axis multiplies the group axis -- pods ARE groups, so the infrequent
global aggregation (every E*H steps) is the only traffic on the slow
inter-pod links, which is exactly the paper's communication design.
"""
from __future__ import annotations

import math

import torch

from repro_torch.sharding.plan import MeshPlan

SINGLE_POD = (16, 16)
MULTI_POD = (2, 16, 16)


def _mesh(ranks: torch.Tensor, names: tuple, device_type: str):
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"meshes are built on 'cuda' or 'cpu', got {device_type!r}")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available: meshes are built on the GPU by "
                           "default; pass device_type='cpu' to build one on the CPU")
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs torch.distributed.init_process_group(backend, "
                           "init_method=..., world_size=..., rank=...) to have run first")
    if ranks.numel() > dist.get_world_size():
        raise ValueError(f"a mesh of {tuple(ranks.shape)} needs {ranks.numel()} ranks; the "
                         f"process group has {dist.get_world_size()}")
    return DeviceMesh(device_type, ranks, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    shape = MULTI_POD if multi_pod else SINGLE_POD
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(torch.arange(math.prod(shape)).reshape(shape), axes, device_type)


def make_train_mesh(plan: MeshPlan, *, multi_pod: bool = False, device_type: str = "cuda"):
    """Logical (group, client, fsdp, model) mesh over the production ranks.

    The physical rank order is preserved (pure relabeling): the last
    logical axis runs over the last physical axis, so ``model`` stays the
    fastest dim and ``group`` spans pods in the 2-pod case.
    """
    g, k, f, m = plan.validate().train_factors
    shape = MULTI_POD if multi_pod else SINGLE_POD
    if multi_pod:
        g *= MULTI_POD[0]
    ranks = torch.arange(math.prod(shape)).reshape(shape).reshape(g, k, f, m)
    return _mesh(ranks, ("group", "client", "fsdp", "model"), device_type)


def make_serve_mesh(*, multi_pod: bool = False, kv: int = 1, device_type: str = "cuda"):
    """Serving mesh. ``kv`` splits the 16-way model axis into (kv, tp):
    GQA kv-heads get their own axis so the KV cache shards by HEAD.

    Why: when kv_heads doesn't divide 16, the cache would otherwise shard
    by sequence, and the one-token cache write at a traced index on a
    sharded dim rewrites the entire cache shard every layer. kv=1
    degenerates to the plain (data, model) mesh.
    """
    if kv <= 1:
        return make_production_mesh(multi_pod=multi_pod, device_type=device_type)
    tp = 16 // kv
    shape = MULTI_POD if multi_pod else SINGLE_POD
    ranks = torch.arange(math.prod(shape))
    if multi_pod:
        return _mesh(ranks.reshape(2, 16, kv, tp), ("pod", "data", "kv", "tp"), device_type)
    return _mesh(ranks.reshape(16, kv, tp), ("data", "kv", "tp"), device_type)


def serve_kv_split(num_heads: int, num_kv_heads: int) -> int:
    """Largest power-of-2 divisor of 16 that divides both head counts."""
    for kv in (16, 8, 4, 2):
        if num_kv_heads % kv == 0 and num_heads % kv == 0:
            return kv
    return 1


def describe(mesh) -> str:
    return f"mesh{dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))} ({mesh.size()} chips)"


def smoke_mesh(shape=(2, 2), axes=("data", "model"), *, device_type: str = "cuda"):
    """A small mesh over the first ``prod(shape)`` ranks (for tests and
    single-host runs)."""
    n = math.prod(shape)
    return _mesh(torch.arange(n).reshape(tuple(shape)), tuple(axes), device_type)
