"""A round state on a ``DeviceMesh``: what each rank holds, how a whole
state moves onto the mesh and back, and the collectives the sharded round
runs over the mesh's (group, client) axes.

A rank at mesh coordinate (g, k, ...) holds the block ``[g * G_l:(g + 1) *
G_l, k * K_l:(k + 1) * K_l]`` of every ``[G, K, ...]`` field (params, z,
the client-link residuals; tree or flat buffers) and ``[g * G_l:(g + 1) *
G_l]`` of every ``[G, ...]`` field (y, the snapshots, the group-link
residuals, the download mask), replicated over ``client`` -- the layout
``sharding.specs.train_state_specs`` gives the tree and the same lead-axis
rule gives flat ``[G, K, N]`` buffers; ``G_l = G / |group|``, ``K_l = K /
|client|``. Other fields (the generator, the window counter, ``glob``)
are replicated.

Only the (group, client) axes carry work: a mesh may have ``fsdp`` and
``model`` dims, of size 1 (their placements come with the slices that run
them).
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.core import tree as tu
from repro_torch.kernels import accounting

Tree = Any

_GK_FIELDS = ("params", "z", "efc")
_G_FIELDS = ("y", "snap", "efg", "dl")
_LATER_AXES = {"fsdp": "the fsdp axis at run time (ZeRO-3 gathers and reduce-scatters around "
                       "the local step; ROADMAP queue 1)",
               "model": "the model axis (tensor-parallel attention, MLP and experts around the "
                        "hand kernels; ROADMAP queue 1)"}


class MeshAxes:
    """The round's view of a mesh: the sizes of its ``group`` and
    ``client`` dims, this rank's coordinates on them, and their process
    groups (None for a dim of size 1, which needs no collective)."""

    def __init__(self, mesh):
        names = tuple(mesh.mesh_dim_names or ())
        for need in ("group", "client"):
            if need not in names:
                raise ValueError(f"a round mesh needs a {need!r} dim; this one has {names}")
        shape = tuple(mesh.shape)
        for name, size in zip(names, shape):
            if name in ("group", "client"):
                continue
            if name not in _LATER_AXES:
                raise ValueError(f"a round mesh has dims (group, client[, fsdp, model]); "
                                 f"got {names}")
            if size > 1:
                raise ValueError(f"a round mesh with {name}={size} is not supported yet: "
                                 f"it needs {_LATER_AXES[name]}")
        coord = mesh.get_coordinate()
        if coord is None:
            raise ValueError("this rank is not in the mesh")
        self.mesh = mesh
        self.n_group = shape[names.index("group")]
        self.n_client = shape[names.index("client")]
        self.group_coord = coord[names.index("group")]
        self.client_coord = coord[names.index("client")]
        self.pg = {"group": mesh.get_group("group") if self.n_group > 1 else None,
                   "client": mesh.get_group("client") if self.n_client > 1 else None}

    @property
    def trivial(self) -> bool:
        """Whether both axes have size 1 (the single-card round's code)."""
        return self.n_group == 1 and self.n_client == 1

    def totals(self, G_l: int, K_l: int) -> tuple[int, int]:
        """The whole (G, K) of a state whose rank block is (G_l, K_l)."""
        return G_l * self.n_group, K_l * self.n_client

    def block(self, G: int, K: int) -> tuple[slice, slice]:
        """This rank's rows of the whole [G, K] topology."""
        if G % self.n_group or K % self.n_client:
            raise ValueError(f"levels ({G}, {K}) do not split over the mesh's "
                             f"(group {self.n_group}, client {self.n_client})")
        gl, kl = G // self.n_group, K // self.n_client
        g0, k0 = self.group_coord * gl, self.client_coord * kl
        return slice(g0, g0 + gl), slice(k0, k0 + kl)

    def sum_(self, t: torch.Tensor, *axes: str) -> torch.Tensor:
        """All-reduce ``t`` (SUM, in place) over each of ``axes`` whose dim
        is larger than 1, on the process group the mesh was built on. Each
        all-reduce is reported to the cost counter
        (``launch/cost_analysis.py``); on a ``meta`` tensor it is counted
        and not made."""
        import torch.distributed as dist

        for a in axes:
            if self.pg[a] is not None:
                accounting.collective("all-reduce", t)
                if t.device.type != "meta":
                    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.pg[a])
        return t

    def broadcast_(self, t: torch.Tensor, *axes: str) -> torch.Tensor:
        """Broadcast ``t`` in place from coordinate 0 of each of ``axes``."""
        import torch.distributed as dist

        for a in axes:
            pg = self.pg[a]
            if pg is not None:
                dist.broadcast(t, src=dist.get_global_rank(pg, 0), group=pg)
        return t

    def gather_(self, t: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
        """The blocks of ``axis``'s ranks, concatenated along ``dim``."""
        import torch.distributed as dist

        pg = self.pg[axis]
        if pg is None:
            return t
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(dist.get_world_size(pg))]
        dist.all_gather(parts, t, group=pg)
        return torch.cat(parts, dim=dim)


def _map_fields(state, fn_gk, fn_g):
    out = {}
    for name in state._fields:
        v = getattr(state, name)
        if v is None:
            continue
        if name in _GK_FIELDS:
            out[name] = tu.tree_map(fn_gk, v)
        elif name in _G_FIELDS:
            out[name] = tu.tree_map(fn_g, v)
    return state._replace(**out)


def shard_state(state, mesh):
    """This rank's block of a whole round state (copies: the round updates
    its state in place)."""
    ax = MeshAxes(mesh)
    G, K = tu.tree_leaves(state.params)[0].shape[:2]
    gs, ks = ax.block(G, K)
    return _map_fields(state, lambda t: t[gs, ks].clone(memory_format=torch.contiguous_format),
                       lambda t: t[gs].clone(memory_format=torch.contiguous_format))


def gather_state(state, mesh):
    """The whole round state from the ranks' blocks, on every rank of the
    mesh (an all-gather over ``client``, then over ``group``; ``[G, ...]``
    fields over ``group`` alone, being replicated over ``client``)."""
    ax = MeshAxes(mesh)
    return _map_fields(state,
                       lambda t: ax.gather_(ax.gather_(t, "client", 1), "group", 0),
                       lambda t: ax.gather_(t, "group", 0))
