"""Carry weights and round state across from the JAX package via numpy.

Both packages name and shape their params alike and pack flat state with
the same segment table (``core.packer``), so a model, an ``HFLState`` or a
``ShardedHFLState`` crosses as plain numpy arrays: the JAX side hands over
``np.asarray`` of each leaf (of each ``FlatBuffers.bufs`` entry for a flat
state), this module builds the port's tensors, and :func:`to_numpy` goes
back. A virtual population's store crosses the same way: its ``[G, P, N]``
numpy buffers as they are, bfloat16 as its 16-bit pattern
(:func:`store_from_reference`, :func:`store_to_reference_data`). Nothing
here imports JAX.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.core.engine import HFLState
from repro_torch.core.packer import FlatBuffers, Packer, Segment, key_dtype, make_packer, tree_paths
from repro_torch.core.population import PopulationStore
from repro_torch.core.tree import tree_map
from repro_torch.launch.train import ShardedHFLState


def tensor_from_numpy(a, device=None) -> torch.Tensor:
    """One array as a tensor on ``device`` (a copy). A bfloat16 array (the
    ``ml_dtypes`` type JAX hands out) crosses bit for bit."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
        return t.view(torch.bfloat16).to(resolve_device(device))
    return torch.from_numpy(np.array(a, copy=True)).to(resolve_device(device))


def params_from_numpy(tree, device=None):
    """A params tree (nested dict of arrays) as the port's params dict, same
    names, shapes and dtypes, on ``device`` (``None``: the CUDA card)."""
    dev = resolve_device(device)
    return tree_map(lambda a: tensor_from_numpy(a, dev), tree)


def _field_builder(template, dev):
    """A state field from numpy: a nested dict of arrays (``template`` None,
    tree layout) or a ``{dtype key: array}`` dict wrapped with the segment
    table of the single-model ``template`` (flat layout)."""
    if template is None:
        return lambda f: params_from_numpy(f, dev)
    packer = make_packer(tree_map(lambda a: torch.empty(
        np.shape(a), dtype=key_dtype(np.asarray(a).dtype.name)), template))
    return lambda f: FlatBuffers({k: tensor_from_numpy(v, dev) for k, v in f.items()}, packer)


def _mask(a, dev):
    return None if a is None else torch.as_tensor(np.array(a, np.float32)).to(dev)


def state_from_numpy(params, z, y, dyn, round=0, *, snap=None, glob=None, dl=None, efc=None,
                     efg=None, template=None, rng=None, device=None) -> HFLState:
    """An ``HFLState`` from numpy fields.

    Tree layout (``template=None``): each of params / z / y / dyn (and the
    async fields snap / glob, the error-feedback residuals efc / efg, when
    given) is a nested dict of stacked arrays; ``dl`` is a [G] array. Flat
    layout: pass the single-model ``template`` params tree (shapes and
    dtypes are all that is read); each field is then a
    ``{dtype key: [*lead, N] array}`` dict -- the reference's
    ``FlatBuffers.bufs`` -- wrapped with the segment table
    ``make_packer(template)``, identical to the reference's.
    """
    dev = resolve_device(device)
    field = _field_builder(template, dev)
    return HFLState(*(field(f) for f in (params, z, y, dyn)), rng=rng,
                    round=torch.as_tensor(np.array(round), dtype=torch.int32).to(dev),
                    snap=None if snap is None else field(snap),
                    glob=None if glob is None else field(glob),
                    dl=_mask(dl, dev),
                    efc=None if efc is None else field(efc),
                    efg=None if efg is None else field(efg))


def sharded_state_from_numpy(params, z, y, *, round=None, snap=None, glob=None, dl=None,
                             template=None, rng=None, device=None) -> ShardedHFLState:
    """A ``ShardedHFLState`` (the sharded backend's state) from numpy fields:
    params and z stacked ``[G, K, ...]``, y ``[G, ...]``, each a nested dict
    of arrays (tree layout; z and y may be bfloat16 arrays, the reference's
    ``correction_dtype``) or, with the single-model ``template`` params tree,
    a ``{dtype key: array}`` dict wrapped with ``make_packer(template)``
    (flat layout). An async state's window counter ``round``, snapshots
    ``snap`` [G, ...] / ``glob`` [...] (laid out like params) and download
    mask ``dl`` [G] cross when given. ``rng``: the port's generator for
    partial participation."""
    dev = resolve_device(device)
    field = _field_builder(template, dev)
    return ShardedHFLState(
        params=field(params), z=field(z), y=field(y), rng=rng,
        round=None if round is None else torch.as_tensor(np.array(round),
                                                         dtype=torch.int32).to(dev),
        snap=None if snap is None else field(snap), glob=None if glob is None else field(glob),
        dl=_mask(dl, dev))


def to_numpy(obj: Any):
    """Tensors -> numpy arrays, recursively through dicts, lists and tuples
    (a multilevel state's ``nus``), FlatBuffers (to their ``bufs`` dict) and
    NamedTuples (``HFLState``, ``ShardedHFLState``,
    ``RoundMetrics``: to
    a dict of fields, leaving out a None or ``torch.Generator`` field, so a
    state carries ``efc``/``efg`` only where it has them).
    bfloat16 tensors come back as float32 arrays."""
    if isinstance(obj, torch.Tensor):
        t = obj.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        return t.numpy()
    if isinstance(obj, FlatBuffers):
        return {k: to_numpy(v) for k, v in obj.bufs.items()}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return {f: to_numpy(v) for f, v in obj._asdict().items()
                if v is not None and not isinstance(v, torch.Generator)}
    if isinstance(obj, dict):
        return {k: to_numpy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_numpy(v) for v in obj)
    return obj


def _packer_from_reference(packer) -> Packer:
    """The port's segment table equal to a reference ``Packer``'s: the same
    segments and buffer sizes, the leaf paths read off its treedef."""
    n = len(packer.segments)
    order = tree_paths(packer.treedef.unflatten(list(range(n))))
    paths = [None] * n
    for path, i in order:
        paths[i] = path
    return Packer(paths=tuple(paths),
                  segments=tuple(Segment(s.buffer, s.offset, s.size, tuple(s.shape))
                                 for s in packer.segments),
                  buffer_sizes=tuple(packer.buffer_sizes))


def _bits(a: np.ndarray) -> np.ndarray:
    """A store buffer as the port holds it: bfloat16 as its uint16 pattern."""
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def store_from_reference(store) -> PopulationStore:
    """The port's :class:`PopulationStore` holding a reference store's rows
    (copies of its ``[G, P, N]`` buffers; bfloat16 as uint16 bits), its
    segment tables and layout flags (its cohort generator seeded with 0)."""
    data = {f: {key: np.array(_bits(buf)) for key, buf in store.data[f].items()}
            for f in store.fields}
    packers = {f: _packer_from_reference(p) for f, p in store.packers.items()}
    return PopulationStore(store.fields, store.num_groups, store.population, packers,
                           dict(store.flat), data)


def store_to_reference_data(store: PopulationStore) -> dict:
    """A port store's buffers as the reference's ``store.data`` holds them,
    ``{field: {dtype key: [G, P, N] array}}``, bfloat16 as its uint16
    pattern (view it as the reference's bfloat16 to compare)."""
    return {f: {key: np.array(buf) for key, buf in bufs.items()} for f, bufs in store.data.items()}
