"""Tree algebra used by every HFL algorithm (port of ``src/repro/core/tree.py``).

A tree is a nested dict of tensors, or a :class:`~repro_torch.core.packer.
FlatBuffers` (mapped buffer by buffer). All hierarchical-FL state is
*stacked*: each leaf carries leading topology axes (``[G, K, ...]`` =
groups x clients-per-group). Leaves are visited in sorted key order, as
``jax.tree`` visits dict keys, so reductions over leaves sum in the
reference's order.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.core.packer import FlatBuffers, tree_paths

Tree = Any


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """Apply ``fn`` leafwise over trees of one structure."""
    if isinstance(tree, FlatBuffers):
        return FlatBuffers(
            {k: fn(b, *(r.bufs[k] for r in rest)) for k, b in tree.bufs.items()},
            tree.packer)
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    return fn(tree, *rest)


def tree_leaves(tree: Tree) -> list:
    """Leaves in the reference's order (sorted keys; buffers by dtype key)."""
    if isinstance(tree, FlatBuffers):
        return list(tree.bufs.values())
    return [leaf for _, leaf in tree_paths(tree)]


def tree_add(a: Tree, b: Tree) -> Tree:
    return tree_map(torch.add, a, b)


def tree_sub(a: Tree, b: Tree) -> Tree:
    return tree_map(torch.sub, a, b)


def tree_scale(a: Tree, s) -> Tree:
    return tree_map(lambda x: x * s, a)


def tree_axpy(alpha, x: Tree, y: Tree) -> Tree:
    """alpha * x + y."""
    return tree_map(lambda xi, yi: alpha * xi + yi, x, y)


def tree_zeros_like(a: Tree) -> Tree:
    return tree_map(torch.zeros_like, a)


def tree_mean(a: Tree, axis) -> Tree:
    """Mean over one or more leading axes (group/client aggregation)."""
    return tree_map(lambda x: torch.mean(x, dim=axis), a)


def expand_mask(mask: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Right-pad a leading-axes mask with unit dims so it broadcasts to x."""
    return mask.reshape(tuple(mask.shape) + (1,) * (x.dim() - mask.dim()))


def tree_select(mask: torch.Tensor, a: Tree, b: Tree) -> Tree:
    """Leafwise where(mask != 0, a, b); mask covers the leading topology
    axes. The unselected branch never propagates (frozen replicas keep
    their exact bits)."""
    return tree_map(lambda ai, bi: torch.where(expand_mask(mask, ai) != 0, ai, bi), a, b)


def tree_masked_mean(a: Tree, mask: torch.Tensor, axis: int,
                     denom: float | None = None) -> Tree:
    """Mean over ``axis`` counting only entries with mask != 0 (``mask``
    spans the leading topology axes of every leaf).

    ``denom=None`` (realized-count weighting): the masked sum over the
    number of active entries; a slice with no active entry returns exact
    zeros (masked sum 0 over a count clamped to 1). A fixed ``denom``
    (inverse-probability weighting: the expected active count) divides the
    masked sum by that constant, the Horvitz-Thompson estimator of the
    full mean. Masked-out entries go through ``where`` (never a multiply),
    so non-finite values in frozen replicas cannot reach the aggregate.
    """
    if denom is not None:
        def _ht(x):
            w = expand_mask(mask, x) != 0
            return torch.sum(torch.where(w, x, 0), dim=axis) / denom

        return tree_map(_ht, a)

    dn = torch.clamp(torch.sum(mask, dim=axis), min=1)

    def _m(x):
        w = expand_mask(mask, x) != 0
        s = torch.sum(torch.where(w, x, 0), dim=axis)
        return s / expand_mask(dn, s)

    return tree_map(_m, a)


def tree_group_global_mean(x: Tree, cmask: torch.Tensor,
                           gmask: torch.Tensor | None = None,
                           gdenom: float | None = None):
    """Global aggregate of disseminated ``[G, K, ...]`` replicas under
    partial participation (Alg. 1 line 10).

    Axis 1 is recovery: every active replica of group j holds the same
    disseminated xbar_j, so the realized-count mean reads it back exactly
    under either weighting. Axis 0 is estimation: with ``gdenom=None`` the
    realized-count mean over groups with at least one active client; with
    a fixed ``gdenom`` the Horvitz-Thompson sum over the reachable-group
    mask ``gmask``, an empty reachable group contributing an exact zero.

    Returns ``(xbar_j [G, ...], xbar [...], gact [G])``.
    """
    gact = (torch.sum(cmask, dim=1) > 0).to(torch.float32)
    xbar_j = tree_masked_mean(x, cmask, axis=1)
    if gdenom is None:
        return xbar_j, tree_masked_mean(xbar_j, gact, axis=0), gact
    xbar_j0 = tree_map(lambda v: torch.where(expand_mask(gact, v) != 0, v, 0), xbar_j)
    xbar = tree_masked_mean(xbar_j0, gmask, axis=0, denom=gdenom)
    return xbar_j, xbar, gact


def tree_masked_sq_norm(a: Tree, mask: torch.Tensor) -> torch.Tensor:
    """||a||^2 restricted to entries with mask != 0 on the leading axes."""
    return tree_sq_norm(tree_map(lambda x: torch.where(expand_mask(mask, x) != 0, x, 0), a))


def tree_broadcast_to_axis(a: Tree, axis: int, size: int) -> Tree:
    """Insert a broadcast leading axis (dissemination after aggregation).

    Returns ``expand`` views, like the reference's ``broadcast_to``; a
    caller that needs storage (the CUDA kernels take contiguous operands)
    materializes with ``.contiguous()``.
    """

    def _b(x):
        x = x.unsqueeze(axis)
        shape = list(x.shape)
        shape[axis] = size
        return x.expand(shape)

    return tree_map(_b, a)


def tree_dot(a: Tree, b: Tree) -> torch.Tensor:
    """Global inner product <a, b>, summed leaf by leaf in leaf order."""
    total = None
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        s = torch.sum(x.to(torch.float32) * y.to(torch.float32))
        total = s if total is None else total + s
    return total


def tree_sq_norm(a: Tree) -> torch.Tensor:
    return tree_dot(a, a)


def tree_allclose(a: Tree, b: Tree, rtol=1e-5, atol=1e-6) -> bool:
    """Whether every leaf pair is ``allclose`` in their promoted dtype (a NaN
    is never close)."""
    def close(x, y):
        dt = torch.promote_types(x.dtype, y.dtype)
        return bool(torch.allclose(x.to(dt), y.to(dt), rtol=rtol, atol=atol))

    return all(close(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b), strict=True))


def tree_cast(a: Tree, dtype) -> Tree:
    return tree_map(lambda x: x.to(dtype), a)
