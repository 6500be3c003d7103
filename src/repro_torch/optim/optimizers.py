"""Functional optimizers: ``init(params) -> state`` and ``update(grads,
state, params, step) -> (params, state)`` over trees of tensors (port of
``src/repro/optim/optimizers.py``).

``step`` is the 0-based update count (an int or a tensor). As in the
reference, the step count and the schedules' values are float32 (the
reference's ``t`` and ``step`` are float32 arrays): AdamW's bias
corrections ``1 - b**t`` are formed in float32 tensors, not in Python
doubles. AdamW's moments are float32 for any parameter dtype, and each
updated parameter is cast back to its own dtype.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.core.tree import tree_map

Tree = Any


class Optimizer(NamedTuple):
    init: Callable[[Tree], Tree]
    update: Callable[[Tree, Tree, Tree, Any], tuple[Tree, Tree]]
    # update(grads, opt_state, params, step) -> (new_params, new_opt_state)


def _lr_fn(lr):
    return lr if callable(lr) else (lambda _: lr)


def sgd(lr: float | Callable, momentum: float = 0.0) -> Optimizer:
    """SGD, with heavy-ball momentum ``m <- momentum * m + g`` when
    ``momentum`` is nonzero."""
    lr_fn = _lr_fn(lr)

    def init(params):
        return () if momentum == 0.0 else tree_map(torch.zeros_like, params)

    def update(grads, state, params, step):
        lr_t = lr_fn(step)
        if momentum == 0.0:
            return tree_map(lambda p, g: p - lr_t * g, params, grads), state
        state = tree_map(lambda m, g: momentum * m + g, state, grads)
        return tree_map(lambda p, m: p - lr_t * m, params, state), state

    return Optimizer(init, update)


def adamw(
    lr: float | Callable,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
) -> Optimizer:
    """AdamW with decoupled weight decay and bias-corrected moments."""
    lr_fn = _lr_fn(lr)
    f32 = torch.float32

    def init(params):
        z = tree_map(lambda p: torch.zeros_like(p, dtype=f32), params)
        return {"m": z, "v": tree_map(torch.zeros_like, z)}

    def update(grads, state, params, step):
        t = torch.as_tensor(step).to(f32) + 1.0
        m = tree_map(lambda mi, g: b1 * mi + (1 - b1) * g, state["m"], grads)
        v = tree_map(lambda vi, g: b2 * vi + (1 - b2) * g * g, state["v"], grads)
        bc1 = 1 - torch.pow(torch.tensor(b1, dtype=f32), t)
        bc2 = 1 - torch.pow(torch.tensor(b2, dtype=f32), t)
        lr_t = lr_fn(step)

        def upd(p, mi, vi):
            u = (mi / bc1) / (torch.sqrt(vi / bc2) + eps)
            return (p - lr_t * (u + weight_decay * p)).to(p.dtype)

        return tree_map(upd, params, m, v), {"m": m, "v": v}

    return Optimizer(init, update)
