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

The port covers the sync schedule with all six algorithms (``mtgc``,
``hfedavg``, ``local_corr``, ``group_corr``, ``fedprox``, ``feddyn``),
``correction_init`` ``zero`` and ``gradient``, ``server_lr``, the flat and
tree state layouts, the fused (mtgc only) and unfused local steps, partial
participation (``uniform``/``fixed`` masks, ``none``/``inverse_prob``
weighting), compressed uploads (``core.compression``) with error
feedback, and fault injection with screened aggregation
(``core.faults``), and async group rounds (``core.staleness``); virtual
client populations wrap it from outside (``core.population``). The
M-level generalization (Appendix E) is ``core.multilevel``.

Async group rounds (``plan=``, a ``core.staleness.StalenessPlan``): a
window runs ``e_pad = max(E_g)`` group rounds; the static iteration mask
``em`` joins the activity mask (``em x cmask``, handed to the fused flat
kernel as its mask), so a straggler past its E_g rounds is frozen like an
unsampled client. The report and fresh masks come from the round counter
(``state.round``); only fresh groups restart z; the global step merges the
reporting groups (weights ``rep x dw``, a delay-compensated report shifted
by ``glob - snap_g``), y updates per group with ``1 / (E_g r_g H lr)``, and
only reporting groups download. Under timeouts a timed-out group misses
its report and the realized-download mask ``dl`` carries freshness.

Partial participation: per-round 0/1 masks (``core.participation``);
inactive clients keep their params and corrections frozen (``where``
selects, never arithmetic), every aggregation is a masked mean, and z/y
update only for participants. The flat fused step hands the client mask
to the ``mtgc_update_flat`` kernel, which copies frozen rows' bits.

Compressed uploads, at the reference's seams: each client's upload delta
``x_end - x`` (plus its residual ``efc``) goes through the client link's
round trip inside every group round, and each group's report delta
against its round-start model (plus ``efg``) through the group link's. z
and y update from the pre-wire models, never from the dequantized view;
a residual advances only for an upload that entered its aggregate.

Faults and defense, at the same seam: crashes fold into the activity
mask, a timed-out group misses the global exchange, corruption rewrites
the upload view after the compression round trip (compress -> corrupt ->
screen), and the defense's screen gates every mean and every z/y update
(``core.faults``). Under either plan the masked machinery runs even at
full participation.

Random draws (masks first, then the fault masks, then the client-link
noise of each group round, then the group-link noise) come from
``state.rng``, a ``torch.Generator``
on the state's device, unless the round function is handed them as a
:class:`RoundDraws` (``round_fn(state, batches, draws=...)``), as the
parity tests hand it the reference's draws.

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

import numpy as np
import torch
from torch.func import grad_and_value, vmap

from repro_torch.core import tree as tu
from repro_torch.core.compression import round_comm_bytes, roundtrip
from repro_torch.core.config import HFLConfig
from repro_torch.core.device import resolve_device
from repro_torch.core.faults import (
    FaultMasks,
    all_finite_mask,
    corrupt_uploads,
    fault_masks,
    screen_and_clip,
)
from repro_torch.core.packer import FlatBuffers, as_tree, is_flat, make_packer
from repro_torch.core.participation import ParticipationMasks, inclusion_prob, round_masks
from repro_torch.kernels import ops as kops

Tree = Any


class HFLState(NamedTuple):
    """State carried between global rounds.

    params: [G, K, ...]  per-client models (all equal right after a round
                         under full participation; frozen replicas keep
                         stale params under partial participation).
    z:      [G, K, ...]  client->group correction (zeros when unused).
    y:      [G, ...]     group->global correction (zeros when unused).
    dyn:    [G, K, ...]  FedDyn gradient memory (zeros when unused).
    rng:    a ``torch.Generator`` on the state's device for the round's
            random draws (participation masks, stochastic-rounding noise),
            or None when the round draws nothing. It advances in place.
    round:  global round counter t (int32 scalar tensor on the device).
    snap:   [G, ...]     the global model each group last downloaded, carried
            only for delay-compensated async rounds (``hfl_init(...,
            staleness_snapshots=True)``); else None.
    glob:   [...]        the last aggregated global model, paired with
            ``snap`` (a copy: it never aliases the params); else None.
    dl:     [G]          realized-download mask (which groups downloaded at
            the end of the last window), carried only when group timeouts
            meet an async schedule (``hfl_init(..., fault_download=True)``);
            else None.
    efc:    [G, K, ...]  client-link error-feedback residual, carried only
            when a ``CompressionPlan`` with error feedback compresses the
            client uploads (``hfl_init(..., ef_client=True)``); else None.
    efg:    [G, ...]     group-link residual, likewise (``ef_group=True``).
    """

    params: Tree
    z: Tree
    y: Tree
    dyn: Tree
    rng: Any
    round: torch.Tensor
    snap: Tree | None = None
    glob: Tree | None = None
    dl: torch.Tensor | None = None
    efc: Tree | None = None
    efg: Tree | None = None


class RoundMetrics(NamedTuple):
    loss: torch.Tensor          # [E, H] mean training loss per local step
    client_drift: torch.Tensor  # [E] mean ||x_i - xbar_j||^2 at group agg
    group_drift: torch.Tensor   # scalar mean ||xbar_j - xbar||^2 at global agg
    z_norm: torch.Tensor        # scalar mean ||z||^2 after the round
    y_norm: torch.Tensor        # scalar mean ||y||^2 after the round
    participation: torch.Tensor  # scalar fraction of clients active this round
    screened: torch.Tensor      # scalar count of screened contributions
    comm_bytes: torch.Tensor    # scalar modeled upload bytes on the wire


class RoundDraws(NamedTuple):
    """One round's random draws, handed to the round function explicitly
    (``round_fn(state, batches, draws=RoundDraws(...))``). A field left
    None is drawn from ``state.rng`` instead.

    masks:        ParticipationMasks (group [G], client [G, K]).
    client_noise: E lists (one per group round) of one U[0, 1) tensor per
                  state leaf, ``[G * K, n]`` (any shape of that size).
    group_noise:  one U[0, 1) tensor per state leaf, ``[G, n]``.
    faults:       FaultMasks (crash [G, K], timeout [G], corrupt [G, K]),
                  read only when the round has an enabled ``FaultPlan``.
    """

    masks: ParticipationMasks | None = None
    client_noise: list | None = None
    group_noise: list | None = None
    faults: FaultMasks | None = None


def _stack_leading(t: torch.Tensor, lead: tuple[int, ...]) -> torch.Tensor:
    """Materialized broadcast of one model leaf to ``lead + t.shape``."""
    return t.expand(lead + tuple(t.shape)).contiguous()


def hfl_init(params0: Tree, cfg: HFLConfig, rng=None, *, staleness_snapshots: bool = False,
             fault_download: bool = False, ef_client: bool = False,
             ef_group: bool = False, device=None) -> HFLState:
    """Broadcast a single model to every client and zero the corrections.

    ``device=None`` runs on the CUDA card and raises on a host without one;
    pass ``device="cpu"`` for the CPU. With ``cfg.use_flat_state`` the state
    leaves are FlatBuffers (recover trees with ``as_tree``). Under partial
    participation ``rng=None`` gets a generator on that device seeded with
    0 (the reference's ``PRNGKey(0)``); otherwise the state carries the
    ``rng`` given (None: the round draws nothing of its own).
    ``staleness_snapshots`` carries the download snapshots ``snap`` [G, ...]
    and ``glob`` [...] of delay-compensated async rounds, both copies of the
    initial model (the first compensation is exactly zero);
    ``fault_download`` carries the realized-download mask ``dl`` (all ones:
    every group starts fresh) of timeouts under an async schedule.
    ``ef_client`` / ``ef_group`` carry the zero-initialized error-feedback
    residuals (``efc`` [G, K, ...] / ``efg`` [G, ...]) of a compression plan.
    """
    dev = resolve_device(device)
    G, K = cfg.num_groups, cfg.clients_per_group
    if rng is None and min(cfg.client_participation, cfg.group_participation) < 1.0:
        rng = torch.Generator(device=dev).manual_seed(0)
    params0 = tu.tree_map(lambda t: torch.as_tensor(t).to(dev), params0)
    round0 = torch.zeros((), dtype=torch.int32, device=dev)
    dl = torch.ones(G, dtype=torch.float32, device=dev) if fault_download else None
    if cfg.use_flat_state:
        packer = make_packer(params0)
        flat0 = packer.flatten(params0)
        snap = glob = None
        if staleness_snapshots:
            # Copies: glob and snap never alias the caller's params.
            glob = tu.tree_map(lambda b: b.clone(), flat0)
            snap = tu.tree_map(lambda b: _stack_leading(b, (G,)), flat0)
        return HFLState(
            params=tu.tree_map(lambda b: _stack_leading(b, (G, K)), flat0),
            z=packer.zeros((G, K), dev),
            y=packer.zeros((G,), dev),
            dyn=packer.zeros((G, K), dev),
            rng=rng,
            round=round0,
            snap=snap,
            glob=glob,
            dl=dl,
            efc=packer.zeros((G, K), dev) if ef_client else None,
            efg=packer.zeros((G,), dev) if ef_group else None,
        )
    stacked = tu.tree_map(lambda t: _stack_leading(t, (G, K)), params0)
    y0 = tu.tree_map(lambda t: torch.zeros((G,) + tuple(t.shape), dtype=t.dtype,
                                           device=dev), params0)
    snap = glob = None
    if staleness_snapshots:
        glob = tu.tree_map(lambda t: t.clone(memory_format=torch.contiguous_format), params0)
        snap = tu.tree_map(lambda t: _stack_leading(t, (G,)), params0)
    return HFLState(
        params=stacked,
        z=tu.tree_zeros_like(stacked),
        y=y0,
        dyn=tu.tree_zeros_like(stacked),
        rng=rng,
        round=round0,
        snap=snap,
        glob=glob,
        dl=dl,
        efc=tu.tree_zeros_like(stacked) if ef_client else None,
        efg=tu.tree_zeros_like(y0) if ef_group else None,
    )


def _client_grads(loss_fn: Callable, params: Tree, batch: Tree):
    """(loss, grad) of the local loss, vmapped over the [G, K] leading axes."""
    g, loss = vmap(vmap(grad_and_value(loss_fn)))(params, batch)
    return loss, g


def _index(tree: Tree, i: int) -> Tree:
    return tu.tree_map(lambda b: b[i], tree)


def _contiguous(tree: Tree) -> Tree:
    return tu.tree_map(lambda t: t.contiguous(), tree)


def _active_group_drift(xbar_j: Tree, xbar: Tree, gact: torch.Tensor, G: int) -> torch.Tensor:
    """Mean ||xbar_j - xbar||^2 over the groups with gact != 0."""
    return tu.tree_masked_sq_norm(
        tu.tree_sub(xbar_j, tu.tree_broadcast_to_axis(xbar, 0, G)), gact
    ) / torch.clamp(torch.sum(gact), min=1.0)


def make_global_round(loss_fn: Callable[[Tree, Tree], torch.Tensor], cfg: HFLConfig, *,
                      device=None) -> Callable[..., tuple[HFLState, RoundMetrics]]:
    """Build the global-round function for ``cfg.algorithm``.

    .. deprecated::
        ``make_global_round`` is the legacy constructor; new code declares
        an ``ExperimentSpec(backend="simulator")`` and uses
        ``repro_torch.api.build(spec, loss_fn)``. This shim returns that
        engine's ``round_fn``, so both are the same program.

    ``loss_fn(params, batch) -> scalar`` is a single-client loss; batches
    passed to the returned function have leaves ``[E, H, G, K, ...]``. The
    function takes the state ``hfl_init(params, cfg)`` makes and adapts to
    its layout (flat or tree); ``loss_fn`` always sees model trees.
    ``device`` places the engine (``None``: the CUDA card); the round runs
    where its state lies.
    """
    import warnings

    from repro_torch.core.api import ExperimentSpec, build

    warnings.warn(
        "make_global_round is deprecated: declare an "
        "ExperimentSpec(backend='simulator') and use "
        "repro_torch.api.build(spec, loss_fn)", DeprecationWarning, stacklevel=2)
    return build(ExperimentSpec.from_hfl_config(cfg), loss_fn, device=device).round_fn


def _build_global_round(
    loss_fn: Callable[[Tree, Tree], torch.Tensor],
    cfg: HFLConfig,
    plan=None,
    faults=None,
    defense=None,
    compression=None,
) -> Callable[..., tuple[HFLState, RoundMetrics]]:
    """The round builder behind ``repro_torch.api``'s simulator engine.

    ``loss_fn(params, batch) -> scalar`` is a single-client loss; batches
    passed to the returned function have leaves ``[E, H, G, K, ...]``. The
    returned function ``global_round(state, batches, draws=None)`` adapts
    to the layout of the state it is given. ``plan`` (a
    ``core.staleness.StalenessPlan``) runs async group rounds: ``E`` is the
    padded loop length ``max(E_g)``, the iteration mask joins the activity
    mask, and the global step is the staleness-aware merge of the groups
    reporting this window; None runs the sync round. ``compression`` (a
    ``core.compression.CompressionPlan``) compresses the client and/or
    group uploads; ``faults`` (a ``core.faults.FaultPlan``) injects
    per-round crashes, timeouts and corrupted uploads; ``defense`` (a
    ``core.faults.DefensePlan``) screens and clips uploads before any
    aggregate or correction update sees them. A disabled plan (or None)
    runs the round without it and draws nothing.
    """
    cfg.validate()
    faults = faults if (faults is not None and faults.enabled) else None
    defense = defense if (defense is not None and defense.enabled) else None
    fault_mode, defended = faults is not None, defense is not None
    if fault_mode:
        faults.validate()
    if defended:
        defense.validate()
    f_crash = fault_mode and faults.crash_rate > 0
    f_timeout = fault_mode and faults.timeout_rate > 0
    f_corrupt = fault_mode and faults.corrupt_rate > 0
    if fault_mode or defended:
        if cfg.correction_init != "zero":
            raise ValueError(
                "fault injection / screened aggregation require correction_init='zero' "
                "(the gradient init has no screened analogue)")
        if cfg.server_lr != 1.0:
            raise ValueError("fault injection / screened aggregation require server_lr=1.0")
    comp = compression if (compression is not None and compression.enabled) else None
    if comp is not None:
        comp.validate()
        if plan is not None:
            raise ValueError(
                "compressed uploads under an async schedule are not supported yet (the "
                "staleness merge would need per-window residual bookkeeping; see ROADMAP)")
        if cfg.correction_init != "zero":
            raise ValueError(
                "compressed uploads require correction_init='zero' (the "
                "gradient init has no compressed analogue)")
        if cfg.server_lr != 1.0:
            raise ValueError("compressed uploads require server_lr=1.0")
    comp_c = comp is not None and comp.client_mode != "none"
    comp_g = comp is not None and comp.group_mode != "none"
    ef_c = comp is not None and comp.ef_client
    ef_g = comp is not None and comp.ef_group
    c_noise = comp_c and comp.client_mode == "int8_stochastic"
    g_noise = comp_g and comp.group_mode == "int8_stochastic"
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
    partial = not cfg.full_participation
    async_mode = plan is not None
    if async_mode:
        if plan.num_groups != G:
            raise ValueError(f"staleness plan covers {plan.num_groups} groups, config has {G}")
        if plan.e_pad != E:
            raise ValueError(f"cfg.group_rounds must be the padded loop length "
                             f"max(E_g)={plan.e_pad}, got {E}")
        if cfg.correction_init != "zero":
            raise ValueError("async group rounds require correction_init='zero' (the "
                             "gradient init has no per-cycle analogue)")
        if cfg.server_lr != 1.0:
            raise ValueError("async group rounds require server_lr=1.0")
        # The plan's static constants, copied to a round's device once.
        plan_np = (plan.iteration_mask(), plan.discount_weights(),
                   np.asarray(plan.effective_rounds, np.float32))
        plan_on = {}
    # Horvitz-Thompson denominators (expected active counts per level);
    # None = realized-count weighting.
    ht = partial and cfg.participation_weighting == "inverse_prob"
    cdenom = (inclusion_prob(cfg.client_participation, K, cfg.participation_mode) * K
              if ht else None)
    gdenom = (inclusion_prob(cfg.group_participation, G, cfg.participation_mode) * G
              if ht else None)

    @torch.no_grad()
    def global_round(state: HFLState, batches: Tree,
                     draws: RoundDraws | None = None) -> tuple[HFLState, RoundMetrics]:
        x, z, y, dyn = state.params, state.z, state.y, state.dyn
        flat = is_flat(x)
        packer = x.packer if flat else None
        dev = tu.tree_leaves(x)[0].device
        draws = draws if draws is not None else RoundDraws()

        def generator(what: str) -> torch.Generator:
            if state.rng is None:
                raise ValueError(
                    f"this round draws {what}: give the state an rng (a "
                    f"torch.Generator on {dev}) or pass them in draws=")
            return state.rng

        # Masks first, then the fault masks, then the compression noise
        # (drawn where it is used).
        if partial:
            if draws.masks is not None:
                masks = ParticipationMasks(
                    *(torch.as_tensor(m).to(dev, torch.float32) for m in draws.masks))
            else:
                masks = round_masks(generator("participation masks"), cfg)
            cmask, gmask = masks.client, masks.group
        else:
            cmask = gmask = None
        if fault_mode:
            fm = (draws.faults if draws.faults is not None
                  else fault_masks(generator("fault masks"), faults, G, K))
            fm = FaultMasks(*(torch.as_tensor(m).to(dev, torch.float32) for m in fm))
            if f_crash:
                # A crashed client is frozen exactly like an unsampled one.
                alive = 1.0 - fm.crash
                cmask = alive if cmask is None else cmask * alive
            if f_timeout:
                tm_keep = 1.0 - fm.timeout                     # [G]
        if (fault_mode or defended) and cmask is None:
            # The screens and faults compose with a mask even at full
            # participation.
            cmask = torch.ones((G, K), dtype=torch.float32, device=dev)
        masked = cmask is not None
        n_active = torch.clamp(torch.sum(cmask), min=1.0) if masked else None

        if async_mode:
            if dev not in plan_on:
                plan_on[dev] = tuple(torch.from_numpy(a).to(dev) for a in plan_np)
            em_all, dw, e_eff = plan_on[dev]
            # The window's report and fresh masks from the round counter.
            rep = plan.report_mask(state.round)                # [G]
            fresh = plan.fresh_mask(state.round)               # [G]
            if f_timeout:
                # A timed-out group misses its report; freshness then comes
                # from the realized downloads of the last window.
                if state.dl is None:
                    raise ValueError(
                        "group-timeout faults under an async schedule carry the "
                        "realized-download mask in the state: build it with "
                        "hfl_init(..., fault_download=True) (repro_torch.api.build does "
                        "this for you)")
                rep = rep * tm_keep
                fresh = state.dl

        def noise_kw(injected) -> dict:
            """roundtrip's noise: the injected tensors, else state.rng."""
            if injected is not None:
                return {"noise": [torch.as_tensor(t).to(dev) for t in injected]}
            return {"generator": generator("stochastic-rounding noise")}

        def step_loss_mean(loss, am, n_act):
            if defended:
                # A corrupted client that has not healed yet (downloaded a
                # clean model) has a non-finite loss while its upload is
                # screened: the metric screens it the same way.
                w = am * torch.isfinite(loss).to(torch.float32)
                return (torch.sum(torch.where(w != 0, loss, 0))
                        / torch.clamp(torch.sum(w), min=1.0))
            if am is not None:
                return torch.sum(torch.where(am != 0, loss, 0)) / n_act
            return torch.mean(loss)

        def local_phase_tree(x, z, batches_eh, am, n_act):
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
                    x_new = tu.tree_map(
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
                    x_new = tu.tree_map(lambda xi, di: xi - lr * di, x, d)
                x = tu.tree_select(am, x_new, x) if am is not None else x_new
                losses.append(step_loss_mean(loss, am, n_act))
            return x, torch.stack(losses)

        def local_phase_flat(x, z, batches_eh, am, n_act):
            """Flat local phase: unpack at the phase boundary, never per step."""
            losses = []
            if use_fused:
                # One kernel launch per dtype buffer per step over the whole
                # model: y stays [G, N] (broadcast inside the kernel) and the
                # activity mask is applied in the kernel (frozen rows copy x).
                for h in range(H):
                    loss, g = _client_grads(loss_fn, packer.unflatten(x),
                                            _index(batches_eh, h))
                    gf = packer.flatten(g)
                    x = FlatBuffers(
                        {k: kops.mtgc_update_flat(x.bufs[k], gf.bufs[k], z.bufs[k],
                                                  y.bufs[k], am, lr=lr)
                         for k in x.bufs},
                        packer)
                    losses.append(step_loss_mean(loss, am, n_act))
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
                x_new = xi - lr * d
                if am is not None:
                    return torch.where(tu.expand_mask(am, x_new) != 0, x_new, xi)
                return x_new

            x_t = packer.unflatten(x)
            for h in range(H):
                loss, g = _client_grads(loss_fn, x_t, _index(batches_eh, h))
                x_t = tu.tree_map(upd, x_t, g, *extra)
                losses.append(step_loss_mean(loss, am, n_act))
            return packer.flatten(x_t), torch.stack(losses)

        local_phase = local_phase_flat if flat else local_phase_tree

        def group_round(e, x, z, efc, batches_eh):
            """One group round: local phase, client upload, group aggregation
            and z update (Alg. 1, lines 5-9)."""
            if async_mode:
                # Iteration liveness joins the activity mask: a straggler
                # past its E_g rounds this window is frozen exactly like an
                # unsampled client, so the mean, z update and dissemination
                # below need no further gating.
                em = em_all[e]
                am = (em[:, None] * cmask if masked
                      else em[:, None].expand(G, K).contiguous())
                n_act = torch.clamp(torch.sum(am), min=1.0)
            else:
                am, n_act = cmask, n_active
            x_end, loss_e = local_phase(x, z, batches_eh, am, n_act)
            # Upload view: compression first (the wire carries the
            # dequantized delta), then corruption rewrites and the defense
            # screens what the group server would reconstruct; frozen and
            # clean clients keep their exact bits (where-selects).
            x_up = x_end
            if comp_c:
                delta = tu.tree_sub(x_end, x)
                u = tu.tree_add(delta, efc) if ef_c else delta
                deq = roundtrip(u, mode=comp.client_mode, lead_ndim=2, frac=comp.topk_frac,
                                fused=use_fused,
                                **(noise_kw(None if draws.client_noise is None
                                            else draws.client_noise[e]) if c_noise else {}))
                x_cmp = tu.tree_add(x, deq)
                x_up = tu.tree_select(am, x_cmp, x_end) if am is not None else x_cmp
            if f_corrupt:
                x_up = corrupt_uploads(x, x_up, fm.corrupt * am, faults)
            if defended:
                x_up, ok = screen_and_clip(x, x_up, defense)
                smask = am * ok
                scr = torch.sum(am) - torch.sum(smask)
                n_srv = torch.clamp(torch.sum(smask), min=1.0)
            else:
                smask, scr, n_srv = am, None, n_act
            # z is the client's own state: it updates from the client's model
            # (the corrupted and clipped upload uncompressed; the corrupted
            # pre-wire model under compression), never from the residual the
            # wire re-applies.
            x_loc = x_up
            if comp_c:
                x_loc = x_end
                if f_corrupt:
                    x_loc = corrupt_uploads(x, x_loc, fm.corrupt * am, faults)
            if ef_c:
                # The residual advances only for an upload that entered the
                # aggregate: an inactive or screened client keeps its own.
                err = tu.tree_sub(u, deq)
                efc = tu.tree_select(smask, err, efc) if smask is not None else err
            # Group aggregation (line 8): xbar_j = mean over the active,
            # surviving clients.
            if smask is not None:
                xbar = tu.tree_masked_mean(x_up, smask, axis=1, denom=cdenom)
            else:
                xbar = tu.tree_mean(x_up, 1)
            xbar_b = tu.tree_broadcast_to_axis(xbar, 1, K)
            diff = tu.tree_sub(x_up, xbar_b)
            drift = (tu.tree_masked_sq_norm(diff, smask) / n_srv if smask is not None
                     else tu.tree_sq_norm(diff) / (G * K))
            # Client-group correction update (line 9), gated on the screen:
            #   z_i += (x_{i,H} - xbar_j) / (H * lr)
            if use_z:
                z_new = tu.tree_map(lambda zi, xe, xb: zi + (xe - xb) / (H * lr),
                                    z, x_loc, xbar_b)
                z = tu.tree_select(smask, z_new, z) if smask is not None else z_new
            # Dissemination: active clients restart from the group model;
            # inactive clients stay frozen. Under the defense a screened but
            # active client downloads too (that heals it), unless its whole
            # group was screened: then the group's active clients revert to
            # their group-round start model, so no screened upload survives
            # in a replica.
            if smask is None:
                x = _contiguous(xbar_b)
            elif defended:
                has_srv = (torch.sum(smask, dim=1) > 0).to(torch.float32)
                x = tu.tree_select(am * has_srv[:, None], xbar_b, x)
            else:
                x = tu.tree_select(am, xbar_b, x_up)
            return x, z, efc, loss_e, drift, scr

        # --- Round initialization (lines 2-4) ---------------------------
        if cfg.correction_init == "gradient" and (use_z or use_y):
            # Evaluated with the first local batch xi_{i,0}^{t,0}.
            _, g0 = _client_grads(loss_fn, as_tree(x), _index(_index(batches, 0), 0))
            if flat:
                g0 = packer.flatten(g0)
        if use_z:
            if cfg.correction_init == "zero":
                # Footnote 2: experiments initialize z = 0 each round
                # (participants only -- frozen clients keep their z). Async:
                # once per report cycle, for the groups that start from a
                # fresh download (mid-cycle stragglers keep accumulating).
                z0 = tu.tree_zeros_like(z)
                if async_mode:
                    zmask = (fresh[:, None] * cmask if masked
                             else fresh[:, None].expand(G, K))
                    z = tu.tree_select(zmask, z0, z)
                else:
                    z = tu.tree_select(cmask, z0, z) if masked else z0
            elif partial:
                # Theoretical init (line 3): z_i = -g_i + mean_group g_i.
                g0m = tu.tree_broadcast_to_axis(
                    tu.tree_masked_mean(g0, cmask, axis=1, denom=cdenom), 1, K)
                z = tu.tree_select(cmask, tu.tree_sub(g0m, g0), z)
            else:
                g0m = tu.tree_broadcast_to_axis(tu.tree_mean(g0, 1), 1, K)
                z = tu.tree_sub(g0m, g0)
        if use_y and cfg.correction_init == "gradient":
            # y_j = mean g - mean_group g, at the first round only; a group
            # with no active client keeps its y.
            is_first = state.round == 0
            if partial:
                gact0 = (torch.sum(cmask, dim=1) > 0).to(torch.float32)
                gj = tu.tree_masked_mean(g0, cmask, axis=1, denom=cdenom)  # [G, ...]
                gg = (tu.tree_masked_mean(gj, gmask, axis=0, denom=gdenom) if ht
                      else tu.tree_masked_mean(gj, gact0, axis=0))         # [...]
            else:
                gj = tu.tree_mean(g0, 1)
                gg = tu.tree_mean(gj, 0)
            y_init = tu.tree_map(lambda gjj, ggg: ggg - gjj, gj, gg)
            if partial:
                y_init = tu.tree_select(gact0, y_init, y)
            y = tu.tree_map(lambda yg, yo: torch.where(is_first, yg, yo), y_init, y)

        anchor = x  # group-round-start model (FedProx / FedDyn reference)

        efc = state.efc if ef_c else None
        if ef_c and efc is None:
            raise ValueError(
                "client-link error feedback carries per-client residuals in the "
                "state: build it with hfl_init(..., ef_client=True) "
                "(repro_torch.api.build does this for you)")

        # --- E group rounds (lines 5-9) ---------------------------------
        # y, dyn and anchor are constant across the group rounds.
        losses, drifts, scrs = [], [], []
        for e in range(E):
            x, z, efc, loss_e, drift, scr = group_round(e, x, z, efc, _index(batches, e))
            losses.append(loss_e)
            drifts.append(drift)
            scrs.append(scr)
        screened = (torch.sum(torch.stack(scrs)) if defended
                    else torch.zeros((), dtype=torch.float32, device=dev))

        # --- Global aggregation (line 10) --------------------------------
        efg = state.efg if ef_g else None
        if ef_g and efg is None:
            raise ValueError(
                "group-link error feedback carries per-group residuals in the "
                "state: build it with hfl_init(..., ef_group=True) "
                "(repro_torch.api.build does this for you)")

        def compress_group(xbar_j, gref, gact):
            """Compress each group's report delta against its round-start
            model (the reference both ends of the link share); groups with
            gact == 0 keep their recovered mean's exact bits. Returns
            (xbar_j', u, deq) for the residual."""
            ug = tu.tree_sub(xbar_j, gref)
            if ef_g:
                ug = tu.tree_add(ug, efg)
            deqg = roundtrip(ug, mode=comp.group_mode, lead_ndim=1, frac=comp.topk_frac,
                             fused=use_fused,
                             **(noise_kw(draws.group_noise) if g_noise else {}))
            xbar_c = tu.tree_add(gref, deqg)
            if gact is not None:
                xbar_c = tu.tree_select(gact, xbar_c, xbar_j)
            return xbar_c, ug, deqg

        if async_mode:
            # Staleness-aware merge of the groups reporting this window:
            # weights rep x dw x the participation estimator; groups that do
            # not report neither upload nor download.
            if masked:
                gact = (torch.sum(cmask, dim=1) > 0).to(torch.float32)
                gup = torch.sum(rep * gact)  # reports actually sent (before the screen)
                # Recovery: active replicas of group j hold its xbar_j from
                # its last live iteration.
                xbar_j = tu.tree_masked_mean(x, cmask, axis=1)
                if defended and defense.screen_nonfinite:
                    gfin = all_finite_mask(xbar_j, 1)
                    screened = screened + torch.sum(cmask * (gact * (1.0 - gfin))[:, None])
                    gact = gact * gfin
                obs = rep * gact
            else:
                xbar_j = tu.tree_map(lambda xi: xi[:, 0], x)
                obs = rep
                gup = torch.sum(rep)
            if plan.needs_snapshots:
                if state.snap is None or state.glob is None:
                    raise ValueError(
                        "staleness='delay_compensated' carries per-group download "
                        "snapshots in the state: build it with hfl_init(..., "
                        "staleness_snapshots=True) (repro_torch.api.build does this for "
                        "you)")
                # First-order delay compensation: a stale report shifted by
                # the global progress its group missed (exactly zero for a
                # fresh group).
                xbar_used = tu.tree_map(lambda xj, gl, sn: xj + (gl.unsqueeze(0) - sn),
                                        xbar_j, state.glob, state.snap)
            else:
                xbar_used = xbar_j
            w = rep * dw                                       # [G]
            if ht:
                # Horvitz-Thompson over reachable groups composed with the
                # report and policy weights: an empty reachable report
                # contributes an exact zero, the denominator stays the
                # expected reporting mass.
                wsum = w * gmask
                sup = wsum * gact
                den = (gdenom / G) * torch.sum(w)
            elif masked:
                wsum = w * gact
                sup = wsum
                den_raw = torch.sum(wsum)
                den = torch.where(den_raw > 0, den_raw, 1.0)
            else:
                # >= 1: the pace-setting group reports every window.
                wsum = w
                sup = wsum
                den = torch.sum(w)

            def stale_merge(v):
                live = tu.expand_mask(sup, v) != 0
                return torch.sum(torch.where(live, v, 0) * tu.expand_mask(wsum, v),
                                 dim=0) / den

            xbar = tu.tree_map(stale_merge, xbar_used)
            gdrift = tu.tree_masked_sq_norm(
                tu.tree_sub(xbar_j, tu.tree_broadcast_to_axis(xbar, 0, G)), obs
            ) / torch.clamp(torch.sum(obs), min=1.0)
        elif masked and (fault_mode or defended or comp_g):
            # tree_group_global_mean's recovery/estimation split, opened up
            # so timeouts, the group link and the group-level finite screen
            # compose into the estimation mask between the two stages.
            xbar_j = tu.tree_masked_mean(x, cmask, axis=1)
            gact = (torch.sum(cmask, dim=1) > 0).to(torch.float32)
            if f_timeout:
                # A timed-out group misses the global exchange: no upload,
                # no y update, no download.
                gact = gact * tm_keep
            gup = torch.sum(gact)  # reports actually sent (before the screen)
            if comp_g:
                gref = tu.tree_masked_mean(state.params, cmask, axis=1)
                xbar_srv = xbar_j  # the group server's own (pre-wire) aggregate
                xbar_j, ug, deqg = compress_group(xbar_j, gref, gact)
            if defended and defense.screen_nonfinite:
                # Backstop: a report that still carries non-finite bits never
                # enters the merge (it counts every active client it speaks
                # for).
                gfin = all_finite_mask(xbar_j, 1)
                screened = screened + torch.sum(cmask * (gact * (1.0 - gfin))[:, None])
                gact = gact * gfin
            if ht:
                xbar_j0 = tu.tree_map(
                    lambda v: torch.where(tu.expand_mask(gact, v) != 0, v, 0), xbar_j)
                xbar = tu.tree_masked_mean(xbar_j0, gmask, axis=0, denom=gdenom)
            else:
                xbar = tu.tree_masked_mean(xbar_j, gact, axis=0)
            gdrift = _active_group_drift(xbar_j, xbar, gact, G)
        elif partial:
            # A group with no active client feeds neither y nor the
            # dissemination of its own replicas (gact gating).
            xbar_j, xbar, gact = tu.tree_group_global_mean(
                x, cmask, gmask if ht else None, gdenom)
            gup = torch.sum(gact)
            gdrift = _active_group_drift(xbar_j, xbar, gact, G)
        else:
            xbar_j = tu.tree_map(lambda xi: xi[:, 0], x)    # [G, ...] (clients equal)
            gup = G
            if comp_g:
                gref = tu.tree_map(lambda xi: xi[:, 0], state.params)
                xbar_srv = xbar_j
                xbar_j, ug, deqg = compress_group(xbar_j, gref, None)
            xbar = tu.tree_mean(xbar_j, 0)                  # [...]
            gdrift = tu.tree_sq_norm(
                tu.tree_sub(xbar_j, tu.tree_broadcast_to_axis(xbar, 0, G))) / G

        if ef_g:
            # Only a report that entered the merge (after the timeouts and
            # the screen) advances its residual.
            errg = tu.tree_sub(ug, deqg)
            efg = tu.tree_select(gact, errg, efg) if masked else errg

        # Group-global correction update (line 11), from the group's own
        # (pre-wire) aggregate:
        #   y_j += (xbar_j^{t,E} - xbar^{t+1}) / (H * E * lr)
        if use_y and async_mode:
            # Per report cycle: a reporting group ran E_g * r_g group rounds
            # since its last download. The policy discount weights the merge
            # only; y tracks at full rate.
            coef = 1.0 / (e_eff * H * lr)                      # [G]
            xbar_g = tu.tree_broadcast_to_axis(xbar, 0, G)
            y_new = tu.tree_map(lambda yj, xj, xg: yj + tu.expand_mask(coef, yj) * (xj - xg),
                                y, xbar_used, xbar_g)
            y = tu.tree_select(obs, y_new, y)
        elif use_y:
            y_src = xbar_srv if comp_g else xbar_j
            y_new = tu.tree_map(lambda yj, xj, xg: yj + (xj - xg) / (H * E * lr),
                                y, y_src, xbar)
            y = tu.tree_select(gact, y_new, y) if masked else y_new

        # FedDyn gradient-memory update (per client, after its local work).
        if use_dyn:
            dyn_new = tu.tree_map(lambda mi, xi, ai: mi - cfg.feddyn_alpha * (xi - ai),
                                  dyn, x, anchor)
            dyn = tu.tree_select(cmask, dyn_new, dyn) if masked else dyn_new

        # Dissemination from the (server-lr) global model; frozen clients
        # keep what they have.
        if cfg.server_lr != 1.0:
            if partial:
                # No stored global model under partial participation: anchor
                # the server step on the mean over all replicas.
                prev = tu.tree_mean(state.params, (0, 1))
            else:
                prev = tu.tree_map(lambda xi: xi[0, 0], state.params)
            xbar = tu.tree_map(lambda p, xb: p + cfg.server_lr * (xb - p), prev, xbar)
        any_obs = None
        if async_mode:
            if fault_mode or defended or plan.needs_snapshots:
                any_obs = (torch.sum(obs) > 0).to(torch.float32)
            if fault_mode or defended:
                # Reporting groups download only when the window merged
                # something (a window whose every report was screened has an
                # exact-zero merge).
                dm = rep[:, None] * cmask * any_obs
            elif masked:
                # Only reporting groups download; stragglers keep their
                # mid-cycle replicas (the lag that makes their report stale).
                dm = rep[:, None] * cmask
            else:
                dm = rep[:, None].expand(G, K)
            x_glob = tu.tree_map(lambda xg: xg.expand((G, K) + tuple(xg.shape)), xbar)
            x = tu.tree_select(dm, x_glob, x)
        elif masked:
            dm = cmask
            if fault_mode or defended:
                # Timed-out groups miss the download too, and no one
                # downloads a global mean with no surviving group.
                dm = dm * (torch.sum(gact) > 0).to(torch.float32)
                if f_timeout:
                    dm = dm * tm_keep[:, None]
            x_glob = tu.tree_map(lambda xg: xg.expand((G, K) + tuple(xg.shape)), xbar)
            x = tu.tree_select(dm, x_glob, x)
        else:
            x = tu.tree_map(lambda xg: _stack_leading(xg, (G, K)), xbar)

        snap, glob, dl = state.snap, state.glob, state.dl
        if async_mode and plan.needs_snapshots:
            # Reporting groups record the global model they downloaded; the
            # server records it as the latest global when the window merged
            # anything. New tensors: nothing aliases the params.
            snap = tu.tree_select(obs, tu.tree_broadcast_to_axis(xbar, 0, G), snap)
            glob = tu.tree_select(any_obs, xbar, glob)
        if async_mode and f_timeout:
            # Realized downloads this window (rep already excludes timed-out
            # groups): next window's freshness for the z restart.
            dl = rep * any_obs

        # Bytes on the wire: every upload actually sent this round (screened
        # uploads spent their bytes; crashed, unsampled and timed-out ones
        # sent none).
        if async_mode:
            n_up_c = (torch.sum(em_all[:, :, None] * cmask[None]) if masked
                      else torch.sum(em_all) * K)
        else:
            n_up_c = E * torch.sum(cmask) if masked else E * G * K
        metrics = RoundMetrics(
            loss=torch.stack(losses),
            client_drift=torch.stack(drifts),
            group_drift=gdrift,
            z_norm=tu.tree_sq_norm(z) / (G * K),
            y_norm=tu.tree_sq_norm(y) / G,
            participation=(torch.sum(cmask) / (G * K) if masked
                           else torch.ones((), dtype=torch.float32, device=dev)),
            screened=screened,
            comm_bytes=round_comm_bytes(state.params, comp, n_up_c, gup),
        )
        new_state = HFLState(params=x, z=z, y=y, dyn=dyn, rng=state.rng,
                             round=state.round + 1, snap=snap, glob=glob, dl=dl,
                             efc=efc if ef_c else state.efc,
                             efg=efg if ef_g else state.efg)
        return new_state, metrics

    return global_round


def global_model(state: HFLState) -> Tree:
    """The current global model xbar, read from replica [0, 0] (every
    replica holds it between full-participation rounds; under partial
    participation a frozen replica may be stale, as in the reference);
    flat states are unpacked into the tree."""
    return as_tree(tu.tree_map(lambda x: x[0, 0], state.params))
