"""MTGC for an arbitrary number of levels (paper Appendix E, Algorithm 2).

Port of ``src/repro/core/multilevel.py``. The M-level tree is described by
``dims = (N_1, ..., N_M)``: the global server (level-1 aggregator) has N_1
children, each of those N_2 children, ..., and the leaves (clients) are
indexed by (k_1, ..., k_M). Client models are stacked with leading shape
``dims``; the level-m correction nu_m (one per edge between a level-m
aggregator and its child) has leading shape ``dims[:m]``.

Periods ``P_1 > P_2 > ... > P_M`` with ``P_{m+1} | P_m``: the level-m
aggregation fires every P_m local iterations, deepest first (the nested
form, Algorithm 1 verbatim for M = 2). Corrections are zero-initialized.

Local update (Alg. 2 line 5):  x <- x - lr * (g + sum_m nu_{k_1..k_m}).
Level-m update (line 9):       nu_n += (subtree_mean(n) - parent_mean) / (lr * P_m).

The reference's nested ``lax.scan`` blocks are Python loops here, and its
M nested ``vmap``\\ s of ``value_and_grad`` are one ``torch.func.vmap`` over
the flattened ``prod(dims)`` client axis: each client's gradient is the
same function of its own params and batch either way, the reshape of the
contiguous state is a view, and one batching level serves every depth.

Partial participation: ``participation[m]`` is the fraction of
level-(m+1) nodes whose uplink is live each global round; a node is
active iff its whole ancestor chain is live. Aggregations become
hierarchical masked means over active subtrees, frozen subtrees keep
their params and nus bit for bit, and nu updates and re-initializations
fire only where an active leaf exists. ``participation_weighting=
"inverse_prob"`` divides the outermost step of each aggregation by the
expected live-child count (Horvitz-Thompson), deeper steps reading the
disseminated values back with realized-count means. The masks come from
``state.rng`` (a ``torch.Generator`` on the state's device, one
``sample_axis_mask`` per level, outermost first), unless the round is
handed them: ``round_fn(state, batches, draws=masks)`` with ``masks[m]``
of shape ``dims[:m + 1]``, as the parity tests hand it the reference's.

Flat state (``multilevel_init(..., use_flat_state=True)``): params and
every nu level live in contiguous ``[*lead, N]`` buffers (``core.packer``).
The nu-sum is constant across the innermost P_M-step block, so it is formed
once a block as one correction buffer, and the params are unpacked once a
block; the tree layout adds each nu every step, so the two layouts round
differently (tests/test_torch_multilevel.py holds them at rtol 1e-5).

Every tensor a round returns as state is materialized, never an expanded
view: the guard's restore copies into each state tensor in place.
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Sequence

import torch
from torch.func import grad_and_value, vmap

from repro_torch.core import tree as tu
from repro_torch.core.device import resolve_device
from repro_torch.core.engine import _contiguous, _stack_leading
from repro_torch.core.packer import as_tree, is_flat, make_packer
from repro_torch.core.participation import inclusion_prob, sample_axis_mask

Tree = Any


class MultiLevelState(NamedTuple):
    """params: ``[*dims, ...]``; nus: ``nus[m - 1]`` has leading shape
    ``dims[:m]``, m = 1..M; rng: a ``torch.Generator`` on the state's
    device for the participation masks (it advances in place)."""

    params: Tree
    nus: tuple
    rng: Any = None


def multilevel_init(params0: Tree, dims: Sequence[int], rng: torch.Generator | None = None,
                    *, use_flat_state: bool = False, device=None) -> MultiLevelState:
    """Broadcast one model to every leaf and zero every level's correction.

    ``device=None`` runs on the CUDA card and raises on a host without one;
    pass ``device="cpu"`` for the CPU. ``rng=None`` gets a generator on that
    device seeded with 0 (the reference's ``PRNGKey(0)``).
    """
    dims = tuple(int(n) for n in dims)
    dev = resolve_device(device)
    if rng is None:
        rng = torch.Generator(device=dev).manual_seed(0)
    params0 = tu.tree_map(lambda t: torch.as_tensor(t).to(dev), params0)
    if use_flat_state:
        packer = make_packer(params0)
        stacked = tu.tree_map(lambda b: _stack_leading(b, dims), packer.flatten(params0))
        nus = tuple(packer.zeros(dims[:m + 1], dev) for m in range(len(dims)))
        return MultiLevelState(params=stacked, nus=nus, rng=rng)
    stacked = tu.tree_map(lambda t: _stack_leading(t, dims), params0)
    nus = tuple(tu.tree_map(lambda t: torch.zeros(dims[:m + 1] + tuple(t.shape), dtype=t.dtype,
                                                  device=dev), params0)
                for m in range(len(dims)))
    return MultiLevelState(params=stacked, nus=nus, rng=rng)


def _subtree_mean(x: Tree, level: int, M: int) -> Tree:
    """Mean over all axes below ``level`` (axes level..M-1). level=0 => global."""
    axes = tuple(range(level, M))
    return tu.tree_mean(x, axis=axes) if axes else x


def _broadcast_back(a: Tree, dims: tuple, level: int) -> Tree:
    """Broadcast a ``[dims[:level], ...]`` tree back to ``[*dims, ...]``
    (an expanded view; a state tensor materializes it)."""
    M = len(dims)

    def _b(x):
        x = x.reshape(tuple(x.shape[:level]) + (1,) * (M - level) + tuple(x.shape[level:]))
        return x.expand(dims + tuple(x.shape[M:]))

    return tu.tree_map(_b, a)


def _masked_levels(x: Tree, leaf_act: torch.Tensor, to_level: int, dims: tuple):
    """Hierarchical masked means from the leaves down to ``to_level``.

    Child-equal-weighted: a level-a node's value is the plain mean of its
    active children's values, where a child is active iff some leaf in its
    subtree is active. Returns (vals, acts) with vals[l] the mean tree with
    leading shape dims[:l] and acts[l] the 0/1 activity of level-l nodes,
    for l in [to_level, M]. A slice with no active child reads zero; its
    activity bit is 0, so no update reads it.
    """
    M = len(dims)
    vals = {M: x}
    acts = {M: leaf_act}
    val, w = x, leaf_act
    for a in range(M - 1, to_level - 1, -1):
        has = torch.sum(w, dim=a) > 0
        val = tu.tree_masked_mean(val, w, axis=a)
        w = has.to(torch.float32)
        vals[a] = val
        acts[a] = w
    return vals, acts


def _masked_levels_ht(x: Tree, chains: tuple, leaf_act: torch.Tensor, to_level: int,
                      dims: tuple, denoms: tuple):
    """Horvitz-Thompson variant of :func:`_masked_levels`.

    Only the outermost step (axis ``to_level``) of an aggregation is
    estimation: the level-(to_level+1) node values' chain-masked sum
    (``chains[m]`` marks nodes whose whole uplink chain to the root is live)
    divides by the fixed expected live-child count ``denoms[to_level]``, a
    node with no active leaf contributing an exact zero. Every deeper axis
    is recovery: the active leaves under a node hold its disseminated value,
    which realized-count means read back exactly. Activity gating equals
    the realized-count variant's, so both weightings freeze the same
    replicas.
    """
    vals, acts = _masked_levels(x, leaf_act, to_level + 1, dims)
    top, act_top = vals[to_level + 1], acts[to_level + 1]
    # An empty subtree contributes an exact zero through where (never a
    # product), so a frozen non-finite replica cannot leak.
    top0 = tu.tree_map(lambda v: torch.where(tu.expand_mask(act_top, v) != 0, v, 0), top)
    vals[to_level] = tu.tree_masked_mean(top0, chains[to_level], axis=to_level,
                                         denom=denoms[to_level])
    acts[to_level] = (torch.sum(act_top, dim=to_level) > 0).to(torch.float32)
    return vals, acts


def make_multilevel_round(
    loss_fn: Callable[[Tree, Tree], torch.Tensor],
    dims: Sequence[int],
    periods: Sequence[int],
    lr: float,
    *,
    participation: Sequence[float] | None = None,
    participation_mode: str = "uniform",
    participation_weighting: str = "none",
    device=None,
) -> Callable:
    """Build one global round (= P_1 local iterations).

    .. deprecated::
        ``make_multilevel_round`` is the legacy constructor; new code
        declares an ``ExperimentSpec(backend="multilevel",
        schedule=RoundSchedule(periods=...))`` and uses
        ``repro_torch.api.build(spec, loss_fn)``. This shim delegates to
        that engine and returns its ``legacy_round_fn``, which keeps this
        function's ``[P_1, *dims, ...]`` batch contract (the engine's own
        ``round_fn`` takes the driver layout ``[E, H, *dims, ...]``).

    Returns ``round_fn(state, batches, draws=None) -> (state, losses[P_1])``.
    """
    import warnings

    from repro_torch.core.api import ExperimentSpec, RoundSchedule, build

    warnings.warn(
        "make_multilevel_round is deprecated: declare an "
        "ExperimentSpec(backend='multilevel', "
        "schedule=RoundSchedule(periods=...)) and use "
        "repro_torch.api.build(spec, loss_fn)",
        DeprecationWarning, stacklevel=2)

    dims = tuple(int(n) for n in dims)
    periods = tuple(int(p) for p in periods)
    spec = ExperimentSpec(
        levels=dims,
        schedule=RoundSchedule(group_rounds=max(periods[0] // periods[-1], 1),
                               local_steps=periods[-1], periods=periods),
        algorithm="mtgc",
        lr=lr,
        backend="multilevel",
        state_layout="tree",  # the round adapts to the state it is given
        level_participation=(None if participation is None
                             else tuple(float(p) for p in participation)),
        participation_mode=participation_mode,
        participation_weighting=participation_weighting,
    )
    return build(spec, loss_fn, device=device).legacy_round_fn


def _build_multilevel_round(
    loss_fn: Callable[[Tree, Tree], torch.Tensor],
    dims: Sequence[int],
    periods: Sequence[int],
    lr: float,
    *,
    participation: Sequence[float] | None = None,
    participation_mode: str = "uniform",
    participation_weighting: str = "none",
) -> Callable:
    """The M-level round builder behind ``repro_torch.api``'s engine.

    The returned ``round_fn(state, batches, draws=None)`` takes batches
    ``[P_1, *dims, ...]`` and adapts to the layout of the state it is
    given; ``draws`` (M masks, ``masks[m]`` of shape ``dims[:m + 1]``)
    replaces the round's participation draw. Returns ``(state,
    losses[P_1])``.
    """
    dims = tuple(dims)
    periods = tuple(periods)
    M = len(dims)
    if len(periods) != M:
        raise ValueError(f"one period per level: {periods} for {M} levels")
    for a, b in zip(periods, periods[1:]):
        if not (a > b and a % b == 0):
            raise ValueError(f"periods must nest: {periods}")
    if participation_weighting not in ("none", "inverse_prob"):
        raise ValueError(f"unknown participation_weighting {participation_weighting!r}")
    if participation is not None:
        participation = tuple(float(p) for p in participation)
        if len(participation) != M:
            raise ValueError("one participation fraction per level: "
                             f"{participation} for {M} levels")
        if not all(0.0 < p <= 1.0 for p in participation):
            raise ValueError(f"participation fractions must be in (0, 1]: {participation}")
    partial = participation is not None and any(p < 1.0 for p in participation)
    ht = partial and participation_weighting == "inverse_prob"
    denoms = (tuple(inclusion_prob(participation[m], dims[m], participation_mode) * dims[m]
                    for m in range(M)) if ht else None)
    P = math.prod(dims)
    vg = vmap(grad_and_value(loss_fn))

    def grads(x: Tree, batch: Tree):
        """(loss [*dims], grad [*dims, ...]) of every client."""
        flat = tu.tree_map(lambda t: t.reshape((P,) + tuple(t.shape[M:])), x)
        bflat = tu.tree_map(lambda t: t.reshape((P,) + tuple(t.shape[M:])), batch)
        g, loss = vg(flat, bflat)
        return loss.reshape(dims), tu.tree_map(lambda t: t.reshape(dims + tuple(t.shape[1:])), g)

    def step_loss(loss, act):
        if partial:
            return torch.sum(torch.where(act != 0, loss, 0)) / torch.clamp(torch.sum(act),
                                                                           min=1.0)
        return torch.mean(loss)

    def local_phase_tree(x, nus, act, batches, start):
        """P_M local steps (Alg. 2 line 5) on a tree state."""
        losses = []
        for h in range(start, start + periods[M - 1]):
            loss, g = grads(x, tu.tree_map(lambda b: b[h], batches))
            d = g
            for m in range(M):
                d = tu.tree_add(d, _broadcast_back(nus[m], dims, m + 1))
            x_new = tu.tree_map(lambda xi, di: xi - lr * di, x, d)
            x = tu.tree_select(act, x_new, x) if partial else x_new
            losses.append(step_loss(loss, act))
        return x, losses

    def local_phase_flat(x, nus, act, batches, start):
        """P_M local steps on a flat state: the nu-sum formed once as one
        correction buffer and the params unpacked once, at the block
        boundary; the participation gate folds into the update."""
        packer = x.packer
        corr = None
        for m in range(M):
            bb = _broadcast_back(nus[m], dims, m + 1)
            corr = bb if corr is None else tu.tree_add(corr, bb)
        corr_t = packer.unflatten(corr)

        def upd(xi, gi, ci):
            x_new = xi - lr * (gi + ci)
            if partial:
                return torch.where(tu.expand_mask(act, x_new) != 0, x_new, xi)
            return x_new

        x_t = packer.unflatten(x)
        losses = []
        for h in range(start, start + periods[M - 1]):
            loss, g = grads(x_t, tu.tree_map(lambda b: b[h], batches))
            x_t = tu.tree_map(upd, x_t, g, corr_t)
            losses.append(step_loss(loss, act))
        return packer.flatten(x_t), losses

    def block(level, x, nus, act, chains, batches, start):
        """P_level steps (steps ``start ..`` of the round) followed by the
        level-``level`` aggregation."""
        if level == M:
            local = local_phase_flat if is_flat(x) else local_phase_tree
            x, losses = local(x, nus, act, batches, start)
        else:
            losses = []
            for r in range(periods[level - 1] // periods[level]):
                x, nus, more = block(level + 1, x, nus, act, chains, batches,
                                     start + r * periods[level])
                losses += more
        nus = list(nus)
        scale = lr * periods[level - 1]
        if partial:
            # Child means at ``level`` and parent means at ``level - 1``
            # over active subtrees only (realized count) or chain-masked
            # Horvitz-Thompson sums over expected counts (inverse_prob).
            if ht:
                vals, acts = _masked_levels_ht(x, chains, act, level - 1, dims, denoms)
            else:
                vals, acts = _masked_levels(x, act, level - 1, dims)
            s, a_val = vals[level], vals[level - 1]
            a_to_s = _broadcast_back(a_val, dims[:level], level - 1)
            nu_new = tu.tree_map(lambda nu, si, ai: nu + (si - ai) / scale,
                                 nus[level - 1], s, a_to_s)
            nus[level - 1] = tu.tree_select(acts[level], nu_new, nus[level - 1])
            # Re-initialize deeper corrections (Alg. 2 line 11) only where
            # the subtree took part in this block.
            for m in range(level, M):
                nus[m] = tu.tree_select(acts[m + 1], tu.tree_zeros_like(nus[m]), nus[m])
            # Dissemination: active leaves restart from their level-(level-1)
            # ancestor; frozen leaves keep their params.
            x = tu.tree_select(act, _broadcast_back(a_val, dims, level - 1), x)
        else:
            s = _subtree_mean(x, level, M)          # child subtree means
            a = _subtree_mean(x, level - 1, M)      # parent means
            a_to_s = _broadcast_back(a, dims[:level], level - 1)
            nus[level - 1] = tu.tree_map(lambda nu, si, ai: nu + (si - ai) / scale,
                                         nus[level - 1], s, a_to_s)
            for m in range(level, M):
                nus[m] = tu.tree_zeros_like(nus[m])
            # Dissemination: every client under a parent restarts from it.
            x = _contiguous(_broadcast_back(a, dims, level - 1))
        return x, tuple(nus), losses

    @torch.no_grad()
    def round_fn(state: MultiLevelState, batches: Tree, draws=None):
        x = state.params
        dev = tu.tree_leaves(x)[0].device
        leaf_act, chains = None, ()
        if partial:
            if draws is not None:
                masks = [torch.as_tensor(m).to(dev, torch.float32) for m in draws]
                if [tuple(m.shape) for m in masks] != [dims[:m + 1] for m in range(M)]:
                    raise ValueError(
                        f"draws must be one mask per level, masks[m] of shape dims[:m + 1] "
                        f"for dims={dims}; got {[tuple(m.shape) for m in masks]}")
            else:
                if state.rng is None:
                    raise ValueError(f"this round draws participation masks: give the state "
                                     f"an rng (a torch.Generator on {dev}) or pass draws=")
                masks = [sample_axis_mask(state.rng, dims[:m + 1], participation[m],
                                          participation_mode, device=dev) for m in range(M)]
            chains = []
            for mask in masks:
                leaf_act = mask if leaf_act is None else (
                    leaf_act.reshape(tuple(leaf_act.shape) + (1,)) * mask)
                # chains[m]: a level-(m+1) node's whole uplink chain is live.
                chains.append(leaf_act)
            chains = tuple(chains)
        x, nus, losses = block(1, x, state.nus, leaf_act, chains, batches, 0)
        return MultiLevelState(params=x, nus=nus, rng=state.rng), torch.stack(losses)

    return round_fn


def multilevel_global_model(state: MultiLevelState) -> Tree:
    """The global model: leaf client 0 (every leaf holds it between
    full-participation rounds); flat states are unpacked into the tree."""
    ndim_lead = len(state.nus)
    return as_tree(tu.tree_map(lambda a: a[(0,) * ndim_lead], state.params))
