"""Partition rules for every parameter / batch / cache leaf (port of
``src/repro/sharding/specs.py``, rule for rule and in its order).

A spec is a :class:`PartitionSpec`: a tuple with one entry per tensor dim,
each an axis name, ``None`` (not sharded) or a tuple of axis names (the
dim split over several mesh axes, the first the major one) -- the
counterpart of ``jax.sharding.PartitionSpec``. :func:`to_placements` turns
one into DTensor placements on a ``DeviceMesh`` (where the reference's
``to_shardings`` makes a ``NamedSharding``).

Rules are path-based (Megatron/MaxText-style logical axis rules):

* "in"-projections  (wq/wk/wv/wi/wg/win/wdt/wb/wc, embed)  shard their
  output dim over ``model`` and the d_model dim over ``fsdp``;
* "out"-projections (wo/wout, cmix wv) shard the contracting dim over
  ``model`` (the all-reduce after them is the Megatron pattern);
* MoE expert stacks [L, E, D, F] shard (D->fsdp, F->model) at train and
  (D->data, F->model) at serve (mixtral's 282 GB does not fit model-only);
* vectors / norms / token-shift mixes are replicated.

An axis is only assigned when the dim is divisible by the axis size --
otherwise it is dropped (replicated on that axis). Vocab dims are padded to
a multiple of 512 by the model (``ArchConfig.vocab_padded``) so embedding /
unembedding shard cleanly.

Training state is stacked: params/z get ("group", "client") prepended,
y gets ("group",). Batches shard [E,H,A,G,K,chunk,T] over
(group, client, fsdp) -- grad-accumulation chunks stay local to a client.
"""
from __future__ import annotations

import os
from typing import Any, Callable

import torch

from repro_torch.models.config import ArchConfig

PyTree = Any

# Leaf names whose 2-D matmul weight is an out-projection (contracting dim
# is the sharded "feature" dim; Megatron row-parallel).
_OUT_PROJ = ("wo", "wout")

_REPLICATED_NAMES = (
    "mix", "u", "decay_base", "d_skip", "log_a", "enc_pos",
    "ln1", "ln2", "ln_x", "ln_f", "ln_out", "q_norm", "k_norm",
    "scale", "bias", "b",
)


class PartitionSpec(tuple):
    """One entry per tensor dim: an axis name, None, or a tuple of names (a
    one-name tuple is that name, as ``jax.sharding.PartitionSpec`` has it)."""

    def __new__(cls, *axes):
        return super().__new__(cls, (a[0] if isinstance(a, tuple) and len(a) == 1 else a
                                     for a in axes))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def _map_with_path(fn: Callable, tree: PyTree, *rest: PyTree, path: tuple = ()) -> PyTree:
    """``fn(path, leaf, *rest_leaves)`` over a nested dict (``path``: the
    keys from the root); a leaf is anything that is not a dict."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, tree[k], *(r[k] for r in rest), path=path + (k,))
                for k in sorted(tree)}
    return fn(path, tree, *rest)


def _path_names(path) -> list[str]:
    return [str(e) for e in path]


def _div(dim: int, size: int) -> bool:
    return size > 1 and dim % size == 0


def _axis(dim: int, name, size: int):
    return name if _div(dim, size) else None


def _size_of(name, axis_sizes: dict) -> int:
    """Axis size; ``name`` may be a tuple of mesh axes (product)."""
    if name is None:
        return 1
    if isinstance(name, tuple):
        n = 1
        for a in name:
            n *= axis_sizes.get(a, 1)
        return n
    return axis_sizes.get(name, 1)


def param_pspec(
    path, shape: tuple[int, ...], *, axis_sizes: dict[str, int],
    model: str = "model", fsdp: str | None = "fsdp", cfg: ArchConfig | None = None,
    attn_model=None,
) -> PartitionSpec:
    """PartitionSpec for one (unstacked) parameter leaf.

    ``model`` may be a tuple of axes (serve meshes split it into (kv, tp));
    ``attn_model`` overrides the axis used for attention head dims (serve:
    just "kv", so head sharding aligns with the head-sharded cache).
    """
    names = _path_names(path)
    leaf = names[-1]
    parent = names[-2] if len(names) >= 2 else ""
    stacked = "layers" in names or "encoder" in names
    tail = shape[1:] if stacked else shape
    msz = _size_of(model, axis_sizes)
    fsz = _size_of(fsdp, axis_sizes)
    attn_model = attn_model if attn_model is not None else model
    asz = _size_of(attn_model, axis_sizes)

    def out(*tail_spec):
        lead = (None,) if stacked else ()
        return P(*(lead + tail_spec))

    if leaf in _REPLICATED_NAMES or parent in _REPLICATED_NAMES or len(tail) <= 1:
        return out(*(None,) * len(tail))

    if parent == "embed" and leaf == "table":            # [V, D]
        # never shard the gathered (vocab) dim: each lookup would gather
        # the whole table.
        return out(None, _axis(tail[1], fsdp, fsz))

    # attention projections reshape to [.., heads, d_head]: only shard the
    # head dim when whole heads land on each model shard, else every reshape
    # needs a full reshard.
    if cfg is not None and parent in ("wq", "wk", "wv", "wo") and (
        "attn" in names or "xattn" in names
    ):
        n_h = cfg.num_heads if parent in ("wq", "wo") else cfg.num_kv_heads
        heads_ok = asz > 1 and n_h % asz == 0
        if parent == "wo":  # row-parallel [H*Dh, D]
            return out(_axis(tail[0], attn_model, asz) if heads_ok else None,
                       _axis(tail[1], fsdp, fsz))
        return out(_axis(tail[0], fsdp, fsz),
                   _axis(tail[1], attn_model, asz) if heads_ok else None)
    if parent == "unembed":                              # [D, V]
        return out(_axis(tail[0], fsdp, fsz), _axis(tail[1], model, msz))
    if parent == "moe" and len(tail) == 3:               # [E, D, F] / [E, F, D]
        # Expert parallelism: when the expert count divides the fsdp axis,
        # shard EXPERTS over it (each shard owns whole experts; the dispatch
        # routes tokens with a small all-to-all) instead of sharding d_model
        # (which all-reduces the full [E, C, D] dispatch buffers after every
        # contraction). REPRO_MOE_EP=0 switches it off, as in the reference.
        if _div(tail[0], fsz) and os.environ.get("REPRO_MOE_EP", "1") != "0":
            if leaf == "wo":
                return out(fsdp, _axis(tail[1], model, msz), None)
            return out(fsdp, None, _axis(tail[2], model, msz))
        if leaf == "wo":
            return out(None, _axis(tail[1], model, msz), _axis(tail[2], fsdp, fsz))
        return out(None, _axis(tail[1], fsdp, fsz), _axis(tail[2], model, msz))

    if len(tail) == 2:
        if parent in _OUT_PROJ or (parent == "cmix" and leaf == "w"):
            # row-parallel: contract over model-sharded dim
            return out(_axis(tail[0], model, msz), _axis(tail[1], fsdp, fsz))
        if leaf == "w" and names[-2] == "wv" and "cmix" in names:  # [F, D]
            return out(_axis(tail[0], model, msz), _axis(tail[1], fsdp, fsz))
        # column-parallel default: [d_model, out]
        return out(_axis(tail[0], fsdp, fsz), _axis(tail[1], model, msz))

    return out(*(None,) * len(tail))


def param_spec_tree(
    params_shape: PyTree, *, axis_sizes, model="model", fsdp="fsdp", lead: tuple = (),
    cfg: ArchConfig | None = None, attn_model=None,
) -> PyTree:
    """Tree of PartitionSpecs; ``lead`` prepends FL topology axes."""

    def f(path, leaf):
        # ``params_shape`` leaves are UNstacked; ``lead`` only prefixes the
        # emitted spec (the stacked state adds those axes separately).
        spec = param_pspec(path, tuple(leaf.shape), axis_sizes=axis_sizes,
                           model=model, fsdp=fsdp, cfg=cfg, attn_model=attn_model)
        return P(*(lead + tuple(spec)))

    return _map_with_path(f, params_shape)


def with_lead(params_shape: PyTree, lead_shape: tuple) -> PyTree:
    """Meta tensors with FL topology axes prepended."""
    return _map_with_path(
        lambda _, s: torch.empty(tuple(lead_shape) + tuple(s.shape), dtype=s.dtype,
                                 device="meta"), params_shape)


def train_state_specs(params_shape: PyTree, axis_sizes: dict,
                      cfg: ArchConfig | None = None) -> dict:
    """PartitionSpecs for the stacked (params, z, y) trees of the round."""
    gk = ("group", "client")
    kw = dict(axis_sizes=axis_sizes, cfg=cfg)
    return {
        "params": param_spec_tree(params_shape, lead=gk, **kw),
        "z": param_spec_tree(params_shape, lead=gk, **kw),
        "y": param_spec_tree(params_shape, lead=("group",), **kw),
    }


def train_batch_spec(batch_specs: PyTree) -> PyTree:
    """[E, H, A, G, K, chunk, ...] -> (group, client, fsdp) on axes 3..5."""

    def f(_, leaf):
        tail = (None,) * (len(leaf.shape) - 6)
        return P(None, None, None, "group", "client", "fsdp", *tail)

    return _map_with_path(f, batch_specs)


# ------------------------------------------------------------------ serve


def serve_param_specs(cfg: ArchConfig, params_shape: PyTree, axis_sizes: dict) -> PyTree:
    """Single-copy serving params: model-parallel only; MoE experts also
    shard d_model over the ``data`` axis (fits mixtral in HBM).

    On kv-split serve meshes (axes data/kv/tp) the tensor-parallel axis is
    the combined ("kv", "tp") pair, while attention head dims shard over
    just "kv" -- aligned with the head-sharded cache."""
    kv_mesh = "kv" in axis_sizes
    model = ("kv", "tp") if kv_mesh else "model"
    attn_model = "kv" if kv_mesh else None
    fsdp = "data" if cfg.num_experts else None
    tree = param_spec_tree(params_shape, axis_sizes=axis_sizes, model=model,
                           fsdp=fsdp, cfg=cfg, attn_model=attn_model)
    if cfg.num_experts:
        # only the 3-D expert stacks keep the data-axis factor; everything
        # else stays replicated over data (decode re-reads weights per token,
        # so gathering non-expert weights every step would dominate).
        def fix(path, spec, leaf):
            names = _path_names(path)
            if "moe" in names and len(leaf.shape) == 4:
                return spec
            return P(*(s if s != "data" else None for s in spec))

        tree = _map_with_path(fix, tree, params_shape)
    return tree


def _axis_sizes(mesh) -> dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def serve_data_axes(mesh) -> tuple:
    """Batch-bearing axes of the serving mesh (('pod','data') when present)."""
    return tuple(a for a in mesh.mesh_dim_names if a not in ("model", "kv", "tp"))


def serve_cache_specs(cfg: ArchConfig, cache_shape: PyTree, shape_id: str, mesh) -> PyTree:
    """KV/recurrent cache specs. decode_32k shards batch over data and kv
    heads over model; long_500k (batch=1) shards the *sequence* over data."""
    axis_sizes = _axis_sizes(mesh)
    data = serve_data_axes(mesh)
    dsz = 1
    for a in data:
        dsz *= axis_sizes[a]

    kv_mesh = "kv" in axis_sizes
    head_ax = "kv" if kv_mesh else "model"
    hsz = axis_sizes.get(head_ax, 1)

    def f(path, leaf):
        names = _path_names(path)
        shp = tuple(leaf.shape)
        if names[-1] in ("k", "v"):                 # [L, B, S, kv, Dh]
            if shape_id == "long_500k":
                return P(None, None, _axis(shp[2], data, dsz), _axis(shp[3], head_ax, hsz), None)
            # batch over data; kv heads over their own axis (kv-split mesh)
            # or the model axis. Sequence-sharding is the last resort: the
            # one-token cache write then rewrites whole shards per layer.
            if _div(shp[3], hsz):
                return P(None, _axis(shp[1], data, dsz), None, head_ax, None)
            return P(None, _axis(shp[1], data, dsz), _axis(shp[2], head_ax, hsz), None, None)
        if names[-1] == "state":                    # rwkv [L, B, H, dh, dh]
            return P(None, _axis(shp[1], data, dsz), _axis(shp[2], head_ax, hsz), None, None)
        if names[-1] == "sstate":                   # hymba [L, B, Di, S]
            return P(None, _axis(shp[1], data, dsz), _axis(shp[2], head_ax, hsz), None)
        if names[-1] in ("x_prev", "ffn_prev"):     # [L, B, D]
            return P(None, _axis(shp[1], data, dsz), None)
        return P(*(None,) * len(shp))

    return _map_with_path(f, cache_shape)


def serve_batch_specs(batch_shape: PyTree, mesh) -> PyTree:
    data = serve_data_axes(mesh)
    axis_sizes = _axis_sizes(mesh)
    dsz = 1
    for a in data:
        dsz *= axis_sizes[a]

    def f(_, leaf):
        if not leaf.shape:
            return P()
        b = _axis(leaf.shape[0], data, dsz)
        return P(b, *(None,) * (len(leaf.shape) - 1))

    return _map_with_path(f, batch_shape)


def to_placements(mesh, spec: PartitionSpec) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: one per mesh dim,
    ``Shard(d)`` where tensor dim d names that mesh dim, else
    ``Replicate()``. A tensor dim split over several mesh dims (a tuple
    entry) takes them major to minor, which DTensor's placements express
    only in the mesh's own dim order: another order raises."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    shard_of: dict[str, int] = {}
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        for a in axes:
            if a not in names:
                raise ValueError(f"spec {spec} names axis {a!r}, not one of the mesh's {names}")
            if a in shard_of:
                raise ValueError(f"spec {spec} uses mesh axis {a!r} twice")
            shard_of[a] = d
        order = [names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(f"spec {spec} splits dim {d} over {axes}, out of the mesh's "
                             f"dim order {names}")
    return tuple(Shard(shard_of[n]) if n in shard_of else Replicate() for n in names)

