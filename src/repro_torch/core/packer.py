"""Flat parameter buffers: pack per-client trees into contiguous tensors.

Port of ``src/repro/core/packer.py``. Every model leaf is packed into **one
contiguous buffer per dtype**, leading topology axes preserved and the
trailing axis the concatenation of every raveled leaf::

    FlatBuffers(bufs={"float32": f32_buf, ...}, packer=<static Packer>)
      f32_buf: [*lead, N_f32]   N_f32 = sum of sizes of all f32 leaves

Leaves are ordered as ``jax.tree.flatten`` orders them -- dict keys in
sorted order at every level -- and buffers are keyed by the dtype's numpy
name (``"float32"``), so the segment table (offsets, sizes,
``buffer_sizes``) equals the reference's on the same template and a
``[G, K, N]`` buffer crosses between the two packages through numpy
unchanged.

``unflatten`` returns views into the buffers (slices reshaped), never
copies; the engine treats them as read-only.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

Tree = Any


def dtype_key(dtype: torch.dtype) -> str:
    """The numpy-style name of a torch dtype (``torch.float32`` -> ``"float32"``)."""
    return str(dtype).removeprefix("torch.")


def key_dtype(key: str) -> torch.dtype:
    """Inverse of :func:`dtype_key`."""
    dtype = getattr(torch, key, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown dtype key {key!r}")
    return dtype


def tree_paths(tree: Tree, prefix: tuple[str, ...] = ()) -> list[tuple[tuple[str, ...], Any]]:
    """``[(path, leaf), ...]`` of a nested dict, keys in sorted order at
    every level (``jax.tree.flatten``'s order for dicts)."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(tree_paths(tree[k], prefix + (k,)))
        return out
    return [(prefix, tree)]


def tree_from_paths(paths, leaves) -> Tree:
    """Rebuild the nested dict that :func:`tree_paths` flattened."""
    if len(paths) == 1 and paths[0] == ():
        return leaves[0]
    root: dict = {}
    for path, leaf in zip(paths, leaves):
        node = root
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return root


@dataclasses.dataclass(frozen=True)
class Segment:
    """Where one template leaf lives inside its dtype buffer."""

    buffer: str            # dtype key, e.g. "float32"
    offset: int            # start (in elements) inside the buffer
    size: int              # number of elements
    shape: tuple[int, ...]  # original leaf shape (without leading axes)


@dataclasses.dataclass(frozen=True)
class Packer:
    """Static pack/unpack table built from a single-model template tree.

    ``flatten`` and ``unflatten`` accept any number of leading axes,
    inferred per call from the difference between actual and template
    leaf ranks.
    """

    paths: tuple[tuple[str, ...], ...]  # one key path per leaf, in leaf order
    segments: tuple[Segment, ...]       # one per template leaf, in leaf order
    buffer_sizes: tuple[tuple[str, int], ...]  # (dtype key, total elements)

    @property
    def num_params(self) -> int:
        return sum(n for _, n in self.buffer_sizes)

    def flatten(self, tree: Tree) -> "FlatBuffers":
        """Pack ``tree`` (template structure + arbitrary leading axes)."""
        leaves = [leaf for _, leaf in tree_paths(tree)]
        if len(leaves) != len(self.segments):
            raise ValueError(f"tree has {len(leaves)} leaves, packer has "
                             f"{len(self.segments)}")
        lead = None
        parts: dict[str, list[torch.Tensor]] = {key: [] for key, _ in self.buffer_sizes}
        for seg, leaf in zip(self.segments, leaves):
            nlead = leaf.dim() - len(seg.shape)
            if lead is None:
                lead = tuple(leaf.shape[:nlead])
            parts[seg.buffer].append(leaf.reshape(lead + (seg.size,)))
        bufs = {
            key: (chunks[0].contiguous() if len(chunks) == 1
                  else torch.cat(chunks, dim=-1))
            for key, chunks in parts.items()
        }
        return FlatBuffers(bufs, self)

    def unflatten(self, flat: "FlatBuffers | dict[str, torch.Tensor]") -> Tree:
        """Rebuild the template-structured tree (leading axes preserved)."""
        bufs = flat.bufs if isinstance(flat, FlatBuffers) else flat
        leaves = []
        for seg in self.segments:
            buf = bufs[seg.buffer]
            lead = tuple(buf.shape[:-1])
            leaves.append(buf[..., seg.offset:seg.offset + seg.size].reshape(lead + seg.shape))
        return tree_from_paths(self.paths, leaves)

    def zeros(self, lead: tuple[int, ...] = (), device=None) -> "FlatBuffers":
        """Zero-filled flat buffers with the given leading axes."""
        bufs = {
            key: torch.zeros(tuple(lead) + (n,), dtype=key_dtype(key), device=device)
            for key, n in self.buffer_sizes
        }
        return FlatBuffers(bufs, self)

    def state_bytes(self, lead: tuple[int, ...] = ()) -> int:
        """Total bytes of the flat buffers under the given leading axes,
        from the static segment table (no tensors are built)."""
        mult = math.prod(lead) if lead else 1
        return sum(mult * n * key_dtype(key).itemsize for key, n in self.buffer_sizes)

    def size_report(self, lead: tuple[int, ...] = ()) -> dict[str, Any]:
        """Per-dtype-buffer size breakdown under the given leading axes (the
        reference's): ``{"lead": lead, "total_bytes": ..., "buffers": {dtype
        key: {"elements", "bytes", "leaves"}}}``."""
        mult = math.prod(lead) if lead else 1
        leaves_per = {key: 0 for key, _ in self.buffer_sizes}
        for seg in self.segments:
            leaves_per[seg.buffer] += 1
        buffers = {
            key: {"elements": mult * n, "bytes": mult * n * key_dtype(key).itemsize,
                  "leaves": leaves_per[key]}
            for key, n in self.buffer_sizes
        }
        return {"lead": tuple(lead), "total_bytes": self.state_bytes(lead), "buffers": buffers}


def make_packer(template: Tree) -> Packer:
    """Build the static segment table from a single-model template tree."""
    offsets: dict[str, int] = {}
    paths, segments = [], []
    for path, leaf in tree_paths(template):
        key = dtype_key(leaf.dtype)
        shape = tuple(leaf.shape)
        size = math.prod(shape) if shape else 1
        off = offsets.get(key, 0)
        paths.append(path)
        segments.append(Segment(key, off, size, shape))
        offsets[key] = off + size
    return Packer(
        paths=tuple(paths),
        segments=tuple(segments),
        buffer_sizes=tuple(sorted(offsets.items())),
    )


class FlatBuffers:
    """Contiguous per-dtype buffers + the packer that made them.

    ``core.tree``'s helpers map over the buffers in sorted key order, so
    two FlatBuffers from the same packer combine like any two trees.
    """

    __slots__ = ("bufs", "packer")

    def __init__(self, bufs: dict[str, torch.Tensor], packer: Packer):
        self.bufs = {k: bufs[k] for k in sorted(bufs)}
        self.packer = packer

    def to_tree(self) -> Tree:
        """Unpack back into the template-structured tree."""
        return self.packer.unflatten(self)

    @property
    def lead_shape(self) -> tuple[int, ...]:
        return tuple(next(iter(self.bufs.values())).shape[:-1])

    def __repr__(self) -> str:
        shapes = {k: tuple(v.shape) for k, v in self.bufs.items()}
        return f"FlatBuffers({shapes})"


def is_flat(tree: Tree) -> bool:
    return isinstance(tree, FlatBuffers)


def as_tree(tree: Tree) -> Tree:
    """Unpack FlatBuffers into its template tree; identity on plain trees."""
    return tree.to_tree() if isinstance(tree, FlatBuffers) else tree
