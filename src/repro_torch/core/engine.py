"""The hierarchical-FL round engine (paper Algorithm 1), in PyTorch.

Port of ``src/repro/core/engine.py``. One *global round* is the unit of
work:

    for e in range(E):                 # group rounds
        for h in range(H):             # local steps
            g_i   = grad F_i(x_i, xi)                  # vmapped over [G, K]
            x_i  -= lr * (g_i + z_i + y_j [+ prox/dyn terms])
        group aggregation + z update (Alg. 1, lines 8-9)
    global aggregation + y update     (Alg. 1, lines 10-11)

All per-client state is stacked with leading axes ``[G, K, ...]``. The
reference's ``lax.scan`` loops are Python loops here (PyTorch runs
eagerly), and its ``vmap(vmap(value_and_grad))`` is ``torch.func.vmap``
twice over ``grad_and_value``.

This slice covers full participation under the sync schedule, all six
algorithms (``mtgc``, ``hfedavg``, ``local_corr``, ``group_corr``,
``fedprox``, ``feddyn``), ``correction_init`` ``zero`` and ``gradient``,
``server_lr``, the flat and tree state layouts, and the fused (mtgc only)
and unfused local steps. Partial participation, faults and defense,
compression, async rounds, populations and the other backends are later
slices of the port; asking for them raises ``ValueError`` naming the slice.

Flat state (``cfg.use_flat_state``, default on): params, z and dyn live in
contiguous ``[G, K, N]`` buffers (one per dtype) and y in ``[G, N]``
(``core.packer``). The gradient loop consumes tree views unpacked once per
local phase; every aggregation, correction update and norm runs on the
whole buffer. With ``use_fused_update`` each local step is one launch of
the CUDA kernel ``mtgc_update_flat`` per dtype buffer (y stays ``[G, N]``
and is broadcast inside the kernel); the tree layout launches the per-leaf
kernel ``mtgc_update`` once per leaf.

The state is never updated in place: each round returns new tensors, as
the reference's functional round does, so the caller's state stays valid.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch
from torch.func import grad_and_value, vmap

from repro_torch.core import tree as tu
from repro_torch.core.compression import round_comm_bytes
from repro_torch.core.config import HFLConfig
from repro_torch.core.device import resolve_device
from repro_torch.core.packer import FlatBuffers, as_tree, is_flat, make_packer
from repro_torch.kernels import ops as kops

Tree = Any

PARTIAL_SLICE = "the partial-participation slice of the port"
FAULTS_SLICE = "the faults-and-defense slice of the port"
COMPRESSION_SLICE = "the compressed-uploads slice of the port"
ASYNC_SLICE = "the async-rounds slice of the port"


class HFLState(NamedTuple):
    """State carried between global rounds.

    params: [G, K, ...]  per-client models (all equal right after a round).
    z:      [G, K, ...]  client->group correction (zeros when unused).
    y:      [G, ...]     group->global correction (zeros when unused).
    dyn:    [G, K, ...]  FedDyn gradient memory (zeros when unused).
    rng:    a ``torch.Generator`` for the later slices' random draws (full
            participation draws nothing), or None.
    round:  global round counter t (int32 scalar tensor on the device).
    """

    params: Tree
    z: Tree
    y: Tree
    dyn: Tree
    rng: Any
    round: torch.Tensor


class RoundMetrics(NamedTuple):
    loss: torch.Tensor          # [E, H] mean training loss per local step
    client_drift: torch.Tensor  # [E] mean ||x_i - xbar_j||^2 at group agg
    group_drift: torch.Tensor   # scalar mean ||xbar_j - xbar||^2 at global agg
    z_norm: torch.Tensor        # scalar mean ||z||^2 after the round
    y_norm: torch.Tensor        # scalar mean ||y||^2 after the round
    participation: torch.Tensor  # scalar fraction of clients active (1 here)
    screened: torch.Tensor      # scalar count of screened contributions (0 here)
    comm_bytes: torch.Tensor    # scalar modeled upload bytes on the wire


def _stack_leading(t: torch.Tensor, lead: tuple[int, ...]) -> torch.Tensor:
    """Materialized broadcast of one model leaf to ``lead + t.shape``."""
    return t.expand(lead + tuple(t.shape)).contiguous()


def hfl_init(params0: Tree, cfg: HFLConfig, rng=None, *, device=None) -> HFLState:
    """Broadcast a single model to every client and zero the corrections.

    ``device=None`` runs on the CUDA card and raises on a host without one;
    pass ``device="cpu"`` for the CPU. With ``cfg.use_flat_state`` the state
    leaves are FlatBuffers (recover trees with ``as_tree``).
    """
    dev = resolve_device(device)
    G, K = cfg.num_groups, cfg.clients_per_group
    params0 = tu.tree_map(lambda t: torch.as_tensor(t).to(dev), params0)
    round0 = torch.zeros((), dtype=torch.int32, device=dev)
    if cfg.use_flat_state:
        packer = make_packer(params0)
        flat0 = packer.flatten(params0)
        return HFLState(
            params=tu.tree_map(lambda b: _stack_leading(b, (G, K)), flat0),
            z=packer.zeros((G, K), dev),
            y=packer.zeros((G,), dev),
            dyn=packer.zeros((G, K), dev),
            rng=rng,
            round=round0,
        )
    stacked = tu.tree_map(lambda t: _stack_leading(t, (G, K)), params0)
    return HFLState(
        params=stacked,
        z=tu.tree_zeros_like(stacked),
        y=tu.tree_map(lambda t: torch.zeros((G,) + tuple(t.shape), dtype=t.dtype,
                                            device=dev), params0),
        dyn=tu.tree_zeros_like(stacked),
        rng=rng,
        round=round0,
    )


def _client_grads(loss_fn: Callable, params: Tree, batch: Tree):
    """(loss, grad) of the local loss, vmapped over the [G, K] leading axes."""
    g, loss = vmap(vmap(grad_and_value(loss_fn)))(params, batch)
    return loss, g


def _index(tree: Tree, i: int) -> Tree:
    return tu.tree_map(lambda b: b[i], tree)


def _contiguous(tree: Tree) -> Tree:
    return tu.tree_map(lambda t: t.contiguous(), tree)


def _build_global_round(
    loss_fn: Callable[[Tree, Tree], torch.Tensor],
    cfg: HFLConfig,
    plan=None,
    faults=None,
    defense=None,
    compression=None,
) -> Callable[[HFLState, Tree], tuple[HFLState, RoundMetrics]]:
    """The round builder behind ``repro_torch.api``'s simulator engine.

    ``loss_fn(params, batch) -> scalar`` is a single-client loss; batches
    passed to the returned function have leaves ``[E, H, G, K, ...]``. The
    returned function adapts to the layout of the state it is given.
    ``plan``, ``faults``, ``defense`` and ``compression`` exist for the
    reference's signature; anything but None raises (later slices).
    """
    cfg.validate()
    for value, what, where in ((plan, "an async staleness plan", ASYNC_SLICE),
                               (faults, "fault injection", FAULTS_SLICE),
                               (defense, "screened aggregation", FAULTS_SLICE),
                               (compression, "compressed uploads", COMPRESSION_SLICE)):
        if value is not None:
            raise ValueError(f"{what} needs {where}")
    if not cfg.full_participation:
        raise ValueError(f"client/group participation < 1 needs {PARTIAL_SLICE}")
    algo = cfg.algorithm
    if algo not in ("mtgc", "hfedavg", "local_corr", "group_corr", "fedprox", "feddyn"):
        raise ValueError(f"unknown algorithm {algo!r}")
    use_z = algo in ("mtgc", "local_corr")
    use_y = algo in ("mtgc", "group_corr")
    use_prox = algo == "fedprox"
    use_dyn = algo == "feddyn"
    G, K, H, E = cfg.num_groups, cfg.clients_per_group, cfg.local_steps, cfg.group_rounds
    lr = cfg.lr
    use_fused = cfg.use_fused_update

    @torch.no_grad()
    def global_round(state: HFLState, batches: Tree) -> tuple[HFLState, RoundMetrics]:
        x, z, y, dyn = state.params, state.z, state.y, state.dyn
        flat = is_flat(x)
        packer = x.packer if flat else None

        def local_phase_tree(x, z, batches_eh):
            """H local SGD steps (Alg. 1, lines 6-7). batches_eh: [H, G, K, ...]."""
            y_b = tu.tree_broadcast_to_axis(y, 1, K)  # [G, K, ...]
            if use_fused:
                y_b = _contiguous(y_b)
            losses = []
            for h in range(H):
                loss, g = _client_grads(loss_fn, x, _index(batches_eh, h))
                if use_fused:
                    # The kernel takes contiguous operands; autograd may hand
                    # back a strided gradient (the CNN's permuted weights).
                    x = tu.tree_map(
                        lambda xi, gi, zi, yi: kops.mtgc_update(
                            xi.contiguous(), gi.contiguous(), zi.contiguous(), yi, lr=lr),
                        x, g, z, y_b)
                else:
                    d = g
                    if use_z:
                        d = tu.tree_add(d, z)
                    if use_y:
                        d = tu.tree_add(d, y_b)
                    if use_prox:
                        d = tu.tree_map(lambda di, xi, ai: di + cfg.prox_mu * (xi - ai),
                                        d, x, anchor)
                    if use_dyn:
                        d = tu.tree_map(
                            lambda di, mi, xi, ai: di - mi + cfg.feddyn_alpha * (xi - ai),
                            d, dyn, x, anchor)
                    x = tu.tree_map(lambda xi, di: xi - lr * di, x, d)
                losses.append(torch.mean(loss))
            return x, torch.stack(losses)

        def local_phase_flat(x, z, batches_eh):
            """Flat local phase: unpack at the phase boundary, never per step."""
            losses = []
            if use_fused:
                # One kernel launch per dtype buffer per step over the whole
                # model: y stays [G, N] (broadcast inside the kernel).
                for h in range(H):
                    loss, g = _client_grads(loss_fn, packer.unflatten(x),
                                            _index(batches_eh, h))
                    gf = packer.flatten(g)
                    x = FlatBuffers(
                        {k: kops.mtgc_update_flat(x.bufs[k], gf.bufs[k], z.bufs[k],
                                                  y.bufs[k], None, lr=lr)
                         for k in x.bufs},
                        packer)
                    losses.append(torch.mean(loss))
                return x, torch.stack(losses)

            # z, y, anchor and dyn are constant for the whole phase: unpack
            # them once ([G, N] y stays a factor K smaller than the replicas).
            extra = []
            if use_z:
                extra.append(z.to_tree())
            if use_y:
                extra.append(y.to_tree())
            if use_prox or use_dyn:
                extra.append(anchor.to_tree())
            if use_dyn:
                extra.append(dyn.to_tree())

            def upd(xi, gi, *rest):
                it = iter(rest)
                d = gi
                if use_z:
                    d = d + next(it)
                if use_y:
                    d = d + next(it).unsqueeze(1)
                if use_prox or use_dyn:
                    ai = next(it)
                if use_prox:
                    d = d + cfg.prox_mu * (xi - ai)
                if use_dyn:
                    d = d - next(it) + cfg.feddyn_alpha * (xi - ai)
                return xi - lr * d

            x_t = packer.unflatten(x)
            for h in range(H):
                loss, g = _client_grads(loss_fn, x_t, _index(batches_eh, h))
                x_t = tu.tree_map(upd, x_t, g, *extra)
                losses.append(torch.mean(loss))
            return packer.flatten(x_t), torch.stack(losses)

        local_phase = local_phase_flat if flat else local_phase_tree

        # --- Round initialization (lines 2-4) ---------------------------
        if use_z or (use_y and cfg.correction_init == "gradient"):
            g0 = None
            if cfg.correction_init == "gradient":
                # Evaluated with the first local batch xi_{i,0}^{t,0}.
                _, g0 = _client_grads(loss_fn, as_tree(x), _index(_index(batches, 0), 0))
                if flat:
                    g0 = packer.flatten(g0)
        if use_z:
            if cfg.correction_init == "zero":
                # Footnote 2: experiments initialize z = 0 each round.
                z = tu.tree_zeros_like(z)
            else:
                # Theoretical init (line 3): z_i = -g_i + mean_group g_i.
                g0m = tu.tree_broadcast_to_axis(tu.tree_mean(g0, 1), 1, K)
                z = tu.tree_sub(g0m, g0)
        if use_y and cfg.correction_init == "gradient":
            # y_j = mean g - mean_group g, at the first round only.
            is_first = state.round == 0
            gj = tu.tree_mean(g0, 1)                              # [G, ...]
            gg = tu.tree_mean(gj, 0)                              # [...]
            y_init = tu.tree_map(lambda gjj, ggg: ggg - gjj, gj, gg)
            y = tu.tree_map(lambda yg, yo: torch.where(is_first, yg, yo), y_init, y)

        anchor = x  # group-round-start model (FedProx / FedDyn reference)

        # --- E group rounds (lines 5-9) ---------------------------------
        # y, dyn and anchor are constant across the group rounds.
        losses, drifts = [], []
        for e in range(E):
            x_end, loss_e = local_phase(x, z, _index(batches, e))
            # Group aggregation (line 8): xbar_j = mean over clients.
            xbar_b = tu.tree_broadcast_to_axis(tu.tree_mean(x_end, 1), 1, K)
            drifts.append(tu.tree_sq_norm(tu.tree_sub(x_end, xbar_b)) / (G * K))
            # Client-group correction update (line 9):
            #   z_i += (x_{i,H} - xbar_j) / (H * lr)
            if use_z:
                z = tu.tree_map(lambda zi, xe, xb: zi + (xe - xb) / (H * lr),
                                z, x_end, xbar_b)
            # Model dissemination: every client restarts from the group model.
            x = _contiguous(xbar_b)
            losses.append(loss_e)

        # --- Global aggregation (line 10) --------------------------------
        xbar_j = tu.tree_map(lambda xi: xi[:, 0], x)    # [G, ...] (clients equal)
        xbar = tu.tree_mean(xbar_j, 0)                  # [...]
        gdrift = tu.tree_sq_norm(
            tu.tree_sub(xbar_j, tu.tree_broadcast_to_axis(xbar, 0, G))) / G

        # Group-global correction update (line 11):
        #   y_j += (xbar_j^{t,E} - xbar^{t+1}) / (H * E * lr)
        if use_y:
            y = tu.tree_map(lambda yj, xj, xg: yj + (xj - xg) / (H * E * lr),
                            y, xbar_j, xbar)

        # FedDyn gradient-memory update (per client, after its local work).
        if use_dyn:
            dyn = tu.tree_map(lambda mi, xi, ai: mi - cfg.feddyn_alpha * (xi - ai),
                              dyn, x, anchor)

        # Dissemination from the (server-lr) global model.
        if cfg.server_lr != 1.0:
            prev = tu.tree_map(lambda xi: xi[0, 0], state.params)
            xbar = tu.tree_map(lambda p, xb: p + cfg.server_lr * (xb - p), prev, xbar)
        x = tu.tree_map(lambda xg: _stack_leading(xg, (G, K)), xbar)

        dev = tu.tree_leaves(x)[0].device
        metrics = RoundMetrics(
            loss=torch.stack(losses),
            client_drift=torch.stack(drifts),
            group_drift=gdrift,
            z_norm=tu.tree_sq_norm(z) / (G * K),
            y_norm=tu.tree_sq_norm(y) / G,
            participation=torch.ones((), dtype=torch.float32, device=dev),
            screened=torch.zeros((), dtype=torch.float32, device=dev),
            comm_bytes=round_comm_bytes(state.params, None, E * G * K, G),
        )
        new_state = HFLState(params=x, z=z, y=y, dyn=dyn, rng=state.rng,
                             round=state.round + 1)
        return new_state, metrics

    return global_round


def global_model(state: HFLState) -> Tree:
    """The current global model xbar (every replica holds it between
    full-participation rounds); flat states are unpacked into the tree."""
    return as_tree(tu.tree_map(lambda x: x[0, 0], state.params))
