"""Step-tagged checkpoints as .npz plus metadata, in the reference's format
(port of ``src/repro/checkpoint/checkpoint.py``).

A checkpoint of step ``s`` is ``ckpt_{s:08d}.npz`` (written through a
``.tmp.npz`` and ``os.replace``) and ``ckpt_{s:08d}.json`` with ``"step"``.
Each leaf is stored under its key path as the reference's
``jax.tree_util`` prints it, the parts joined by ``||``: a NamedTuple field
is ``.name``, a dict key ``['k']``, a sequence index ``[i]``; a
:class:`~repro_torch.core.packer.FlatBuffers` is keyed by its dtype keys and
a :class:`~repro_torch.core.population.PopulationStore` by
``f"{field}.{dtype}"`` (``['state']||.params||['float32']``,
``['population']||['z.float32']``). A None field is structure, not a leaf.
So a reference checkpoint restores into the port's states, and an rng-free
port checkpoint into the reference's.

* bfloat16 leaves are written as the raw 16-bit pattern (numpy void
  ``V2``, as ``np.savez`` writes the reference's bfloat16 arrays) and read
  back from it through a 16-bit view.
* A ``torch.Generator`` leaf (a state's ``rng``, a store's cohort
  generator ``['population']||['rng']``, ``fit``'s ``data_rng``) is written
  as its ``get_state()`` bytes (uint8). Restoring a reference checkpoint,
  whose key there is the JAX key (uint32 ``[2]``), reseeds the generator
  from those two words: threefry's stream is not replayed. The reference
  reads only the leaves of its ``like`` tree, so it ignores the store's
  generator; a generator leaf of a state has no shape it accepts.
"""
from __future__ import annotations

import json
import os
import re
from typing import Any

import numpy as np
import torch

from repro_torch.core.packer import FlatBuffers
from repro_torch.core.population import PopulationStore, host_tensor

Tree = Any
_SEP = "||"


def _store_keys(store: PopulationStore, path: tuple) -> list:
    """(path, field, dtype key) of every buffer of a store, in the
    reference's order (fields in order, dtype keys sorted)."""
    return [(path + (f"[{f + '.' + key!r}]",), f, key)
            for f in store.fields for key in sorted(store.data[f])]


def _flatten(tree: Tree, path: tuple = ()) -> list:
    """``[(path, leaf)]`` in the reference's leaf order."""
    if tree is None:
        return []
    if isinstance(tree, PopulationStore):
        out = [(p, host_tensor(tree.data[f][key], key)) for p, f, key in _store_keys(tree, path)]
        return out + [(path + ("['rng']",), tree.generator)]
    if isinstance(tree, FlatBuffers):
        return [(path + (f"[{k!r}]",), tree.bufs[k]) for k in sorted(tree.bufs)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [kv for f in tree._fields for kv in _flatten(getattr(tree, f), path + (f".{f}",))]
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _flatten(tree[k], path + (f"[{k!r}]",))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree) for kv in _flatten(v, path + (f"[{i}]",))]
    return [(path, tree)]


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Generator):
        return leaf.get_state().numpy()
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.contiguous().view(torch.int16).numpy().view(np.dtype("V2"))
        return t.numpy()
    return np.asarray(leaf)


def save(directory: str, step: int, tree: Tree, metadata: dict | None = None) -> str:
    """Write ``tree`` as checkpoint ``step`` in ``directory``; returns the
    .npz path."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"ckpt_{step:08d}.npz")
    tmp = path + ".tmp.npz"
    np.savez(tmp, **{_SEP.join(p): _to_numpy(leaf) for p, leaf in _flatten(tree)})
    os.replace(tmp, path)
    meta = dict(metadata or {})
    meta["step"] = step
    with open(os.path.join(directory, f"ckpt_{step:08d}.json"), "w") as f:
        json.dump(meta, f)
    return path


def latest_step(directory: str) -> int | None:
    """The largest step with a checkpoint in ``directory``, or None."""
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for f in os.listdir(directory)
             if (m := re.fullmatch(r"ckpt_(\d+)\.npz", f))]
    return max(steps) if steps else None


def _generator(key: str, arr: np.ndarray, like: torch.Generator) -> torch.Generator:
    gen = torch.Generator(device=like.device)
    want = tuple(like.get_state().shape)
    if arr.dtype == np.uint8 and arr.shape == want:
        gen.set_state(torch.from_numpy(arr.copy()))
    elif arr.dtype == np.uint32 and arr.shape == (2,):
        # A reference checkpoint's JAX key: reseed from its two words.
        gen.manual_seed((int(arr[0]) << 32) | int(arr[1]))
    else:
        raise ValueError(f"checkpoint leaf {key!r} has shape {arr.shape} ({arr.dtype}), but the "
                         f"`like` state expects a generator state {want} (uint8) or a JAX key "
                         "(2,) (uint32)")
    return gen


def _check_shape(key: str, arr: np.ndarray, shape) -> None:
    if arr.shape != tuple(shape):
        raise ValueError(f"checkpoint leaf {key!r} has shape {arr.shape}, but the `like` state "
                         f"expects {tuple(shape)}")


def _leaf(key: str, arr: np.ndarray, like):
    """``arr`` as a value like ``like`` (its type, dtype and device)."""
    if isinstance(like, torch.Generator):
        return _generator(key, arr, like)
    _check_shape(key, arr, like.shape if hasattr(like, "shape") else np.shape(like))
    if isinstance(like, torch.Tensor):
        if not arr.flags.writeable:
            arr = arr.copy()
        if arr.dtype.kind == "V":            # bfloat16 bits
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        return t.to(device=like.device, dtype=like.dtype, copy=True)
    dtype = np.asarray(like).dtype
    if arr.dtype.kind == "V":
        bits = arr.view(np.uint16)
        return np.array(bits.view(dtype)) if dtype.itemsize == 2 else bits.astype(dtype)
    return arr.astype(dtype)


def _rebuild(like: Tree, load, path: tuple = ()):
    if like is None:
        return None
    if isinstance(like, PopulationStore):
        data = {f: {} for f in like.fields}
        for p, f, key in _store_keys(like, path):
            data[f][key] = _leaf(_SEP.join(p), load(p), like.data[f][key])
        rng_path = path + ("['rng']",)
        if load(rng_path, required=False) is not None:
            gen = _generator(_SEP.join(rng_path), load(rng_path), like.generator)
        else:                                 # a reference store has no generator leaf
            gen = torch.Generator().manual_seed(0)
            gen.set_state(like.generator.get_state())
        return PopulationStore(like.fields, like.num_groups, like.population, like.packers,
                               like.flat, data, gen)
    if isinstance(like, FlatBuffers):
        return FlatBuffers({k: _leaf(_SEP.join(path + (f"[{k!r}]",)),
                                     load(path + (f"[{k!r}]",)), like.bufs[k])
                            for k in sorted(like.bufs)}, like.packer)
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_rebuild(getattr(like, f), load, path + (f".{f}",))
                            for f in like._fields))
    if isinstance(like, dict):
        return {k: _rebuild(like[k], load, path + (f"[{k!r}]",)) for k in sorted(like)}
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, load, path + (f"[{i}]",)) for i, v in enumerate(like))
    return _leaf(_SEP.join(path), load(path), like)


def restore(directory: str, step: int, like: Tree) -> Tree:
    """Restore checkpoint ``step`` into the structure of ``like``: values
    replaced, dtypes and devices kept, new tensors, generators and stores
    (``like`` is not modified). Raises ``ValueError`` for a leaf the file
    lacks or a shape that differs."""
    path = os.path.join(directory, f"ckpt_{step:08d}.npz")
    with np.load(path) as data:
        def load(p: tuple, required: bool = True):
            key = _SEP.join(p)
            if key not in data.files:
                if not required:
                    return None
                raise ValueError(f"checkpoint {path} has no leaf {key!r}; was it saved from "
                                 "a state with a different structure?")
            return data[key]

        return _rebuild(like, load)
