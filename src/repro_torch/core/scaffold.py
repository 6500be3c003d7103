"""Flat (star-topology) SCAFFOLD [Karimireddy et al., 2020], in PyTorch.

Port of ``src/repro/core/scaffold.py``, for the paper's Sec. 3.3 claim:
MTGC with one group and E = 1 group round *is* SCAFFOLD. Both
control-variate options:

* option I  (fresh gradient): c_i = grad F_i(x^t, xi) at the round start,
  what MTGC's theoretical correction init (Alg. 1 line 3) reduces to;
* option II (model difference): c_i <- c_i - c + (x^t - x_{i,H}) / (H lr).

The reference computes the update with ``jax.tree.map`` (no Pallas
kernel), so this is plain tensor code: ``torch.func.vmap`` over the
clients, as ``core/engine.py`` does. The state lives where ``params0``
lies.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch
from torch.func import grad_and_value, vmap

from repro_torch.core import tree as tu
from repro_torch.core.engine import _stack_leading

Tree = Any


class ScaffoldState(NamedTuple):
    params: Tree  # [K, ...] per-client models
    c_i: Tree     # [K, ...] client control variates
    c: Tree       # [...]    server control variate


def _stack(tree: Tree, K: int) -> Tree:
    return tu.tree_map(lambda x: _stack_leading(x, (K,)), tree)


def scaffold_init(params0: Tree, num_clients: int) -> ScaffoldState:
    """Broadcast ``params0`` to ``num_clients`` clients, zero controls."""
    stacked = _stack(params0, num_clients)
    return ScaffoldState(params=stacked, c_i=tu.tree_zeros_like(stacked),
                         c=tu.tree_zeros_like(params0))


def make_scaffold_round(
    loss_fn: Callable[[Tree, Tree], torch.Tensor],
    num_clients: int,
    local_steps: int,
    lr: float,
    option: str = "I",
) -> Callable[[ScaffoldState, Tree], tuple[ScaffoldState, torch.Tensor]]:
    """``round_fn(state, batches) -> (state, losses [H])`` over batches with
    leaves ``[H, K, ...]``."""
    if option not in ("I", "II"):
        raise ValueError(f"unknown SCAFFOLD option {option!r}")
    K, H = num_clients, local_steps

    def vg(x, batch):
        g, loss = vmap(grad_and_value(loss_fn))(x, batch)
        return loss, g

    @torch.no_grad()
    def round_fn(state: ScaffoldState, batches: Tree):
        x0 = state.params
        if option == "I":
            # Fresh-gradient control variates at the round-start model on
            # the first local batch (MTGC Alg. 1 line 3).
            _, c_i = vg(x0, tu.tree_map(lambda b: b[0], batches))
            c_cur = tu.tree_mean(c_i, axis=0)
        else:
            c_i, c_cur = state.c_i, state.c
        c_b = tu.tree_broadcast_to_axis(c_cur, 0, K)
        x, losses = x0, []
        for h in range(H):
            loss, g = vg(x, tu.tree_map(lambda b: b[h], batches))
            x = tu.tree_map(lambda xi, gi, cii, ci: xi - lr * (gi - cii + ci), x, g, c_i, c_b)
            losses.append(torch.mean(loss))
        if option == "II":
            c_i = tu.tree_map(lambda cii, ci, x0i, xe: cii - ci + (x0i - xe) / (H * lr),
                              c_i, c_b, x0, x)
        xbar = tu.tree_mean(x, axis=0)
        return (ScaffoldState(params=_stack(xbar, K), c_i=c_i, c=tu.tree_mean(c_i, axis=0)),
                torch.stack(losses))

    return round_fn
