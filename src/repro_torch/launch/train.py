"""The production MTGC training round (sharded backend, microbatched), and
the LM trainer's command line.

Port of ``src/repro/launch/train.py``: Algorithm 1 with the same update
equations as ``core.engine``, restructured as the reference's production
round --

* every local step accumulates the gradient over ``A`` microbatch chunks
  (batches ``[E, H, A, G, K, ...]``) and steps with their mean ``g / A``;
* state is stacked ``[G, K, ...]`` (flat ``[G, K, N]`` buffers with
  ``sharded_init(..., use_flat_state=True)``), and the group-global
  correction ``y`` stays ``[G, ...]``;
* z and y may be stored narrow (``correction_dtype``, tree layout only):
  their updates run in float32 and round once into the storage type;
* with ``use_fused_update`` (mtgc) the local step is the CUDA kernel
  ``mtgc_update_flat`` with ``g_scale = 1 / A``: one launch per leaf (tree)
  or per dtype buffer (flat);
* partial participation as on the simulator engine: masks drawn from
  ``state.rng`` (a ``torch.Generator``) or handed in as
  ``draws=RoundDraws(masks=...)``, frozen replicas, masked aggregation
  under either weighting, gated z/y updates;
* compressed uploads (``compression=CompressionPlan(...)``) at the
  reference's seams: each client's delta against its phase-start model
  (plus its residual ``efc``) goes through the client link's round trip
  every group round, each group's report against its round-start model
  (plus ``efg``) through the group link's, z and y update from the
  pre-wire models, and a residual advances only for an upload that entered
  its mean; the stochastic-rounding noise comes from ``state.rng`` (after
  the masks) or ``draws=RoundDraws(client_noise=, group_noise=)``;
* faults and defense (``faults=FaultPlan(...)``, ``defense=DefensePlan(...)``)
  with the simulator engine's semantics (``core/faults.py``): crashes join
  the activity mask, a timed-out group misses the global exchange, a
  corrupted upload is rewritten after the client link's round trip, and
  the screen gates every mean and z/y update (compress -> corrupt ->
  screen); the fault masks come from ``state.rng`` (after the
  participation masks) or ``draws=RoundDraws(faults=)``;
* async group rounds (``plan=``, a ``core.staleness.StalenessPlan``) with
  the simulator engine's semantics: the iteration mask joins the activity
  mask of each group round (``em x cmask``, the fused kernel's mask), the
  report and fresh masks come from the window counter ``state.round``, the
  global step is the staleness-aware merge of the reporting groups
  (``dw`` weights, the delay-compensated shift ``glob - snap_g``), each
  reporting group's y updates with its own ``1 / (E_g r_g H lr)``, and only
  reporting groups download.

The reference vmaps ``value_and_grad`` over ``[G, K]``; here the per-client
gradients are a Python loop over the replicas, each ``torch.autograd.grad``
of the loss at views of the stacked leaves, added into a ``[G, K]``
accumulator in the reference's order (``(0 + g_1) + g_2 ...``). That loop
composes with ``torch.utils.checkpoint`` in the model and holds one
replica's activations at a time. Virtual client populations wrap the round
from outside (``core.population``; ``--population``/``--cohort-size``/
``--client-state`` on the CLI).

On a mesh (``mesh=``, a ``torch.distributed`` ``DeviceMesh`` with
``group`` and ``client`` dims, e.g. ``launch.mesh.make_train_mesh``; the
counterpart of jitting the reference's round with ``train_state_specs``
shardings) the round is the same and only the layout of the state
changes: each rank holds its block ``[G / |group|, K / |client|, ...]`` of
params and z and ``[G / |group|, ...]`` of y (``sharding/state.py``;
``shard_state``/``gather_state`` move a whole state on and off), runs the
client loop and the local step over it, and every mean over an axis the
mesh shards is a float32 sum over the block, an all-reduce (SUM) over
that axis's process group and the reference's division: the group mean
over ``client`` (the paper's fast timescale), the global mean over
``group`` (the slow one), the masked means and their counts, and the
metrics. An axis of size 1 takes the single-card code. Every rank draws
the whole ``[G, K]`` participation mask from the same generator (or takes
it from ``draws=``) and reads its own rows. The mesh runs mtgc and
hfedavg, tree and flat, fused and unfused, at full and partial
participation; compression, faults and the defense, async plans,
populations, narrow corrections and ``fsdp``/``model`` dims larger than 1
raise, naming the slice that brings them.

Memory: the round updates the state's tensors IN PLACE and returns them in
the new state, as the reference's driver donates the state to each round:
the caller must not reuse the state it passed in. The uploads, the
aggregations, the z/y updates and the residuals run leaf by leaf and piece
by piece, over column pieces of at most ``_CHUNK`` elements of each row
(``[K, piece]`` of one group, ``[G, K, piece]`` at the global step): no
temporary as large as a leaf is formed, masked or not (a flat glm4-9b
``[2, 2, N]`` buffer is 13.2 GB). A frozen replica is never written. What
the round holds beyond the state: the phase-start model under client-link
compression, corruption or the defense (``[G, ...]`` when the active
replicas of each group hold one model, else a ``[G, K, ...]`` copy: a
client that missed a download, by a crash or a timeout, starts from a stale
model) and the group link's round-start reference (``[G, ...]``).

A defended group round reads the uploads twice: pass 1 accumulates each
client's float32 squared delta norm and the all-finite flag of its upload
view over every piece of every leaf (the screen needs the whole model's
norm before any mean), pass 2 forms each piece's upload view again
(corruption payload, clip scale) inside the masked mean; the upload view is
never stored. Stochastic-rounding noise drawn from ``state.rng`` is drawn
again in pass 2 from the generator's state before pass 1. The global step's
non-finite backstop reads every group report once before the merge.

An async round takes its host copies at the start: the activity mask and
the window's report mask in one copy; each group round's active rows are
that copy times the static iteration mask. Its global step works piece by
piece too: the recovered reports, the delay-compensated shift (in float32,
rounded once to the report's dtype), the weighted merge, the per-group y
update, the masked download and the ``snap``/``glob`` writes.

CLI (a reduced model on the CPU)::

    PYTHONPATH=src python -m repro_torch.launch.train --arch glm4-9b --smoke \\
        --rounds 2 --device cpu
"""
from __future__ import annotations

import argparse
import itertools
import math
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch.core import compression as cmp
from repro_torch.core import tree as tu
from repro_torch.core.compression import _CHUNK, round_comm_bytes
from repro_torch.core.device import resolve_device
from repro_torch.core.engine import RoundDraws
from repro_torch.core.faults import FaultMasks, all_finite, fault_masks, payload, screen_tests
from repro_torch.core.packer import is_flat, make_packer
from repro_torch.core.participation import ParticipationMasks, inclusion_prob, sample_hfl_masks
from repro_torch.kernels import ops as kops

Tree = Any


class ShardedHFLState(NamedTuple):
    """State carried between production rounds (the reference's fields).

    params: [G, K, ...] per-client replicas (tree, or flat [G, K, N]).
    z:      [G, K, ...] client->group corrections (``correction_dtype``).
    y:      [G, ...]    group->global corrections.
    rng:    ``torch.Generator`` for the participation masks, the fault masks
            and the stochastic-rounding noise (None: the round draws nothing).
    round:  the window counter (int32 scalar) that async report cadences are
            read from (``sharded_init(..., round_counter=True)``); else None.
    snap:   [G, ...]    the global model each group last downloaded, for
            delay-compensated async rounds (``staleness_snapshots=True``).
    glob:   [...]       the last global model (a copy), paired with ``snap``.
    dl:     [G]         realized-download mask, for timeouts under an async
            schedule (``fault_download=True``); else None.
    efc:    [G, K, ...] client-link error-feedback residuals, in the params'
            dtype (``sharded_init(..., ef_client=True)``); else None.
    efg:    [G, ...]    group-link residuals, likewise (``ef_group=True``).
    """

    params: Tree
    z: Tree
    y: Tree
    rng: Any = None
    round: torch.Tensor | None = None
    snap: Tree | None = None
    glob: Tree | None = None
    dl: torch.Tensor | None = None
    efc: Tree | None = None
    efg: Tree | None = None


class ShardedMetrics(NamedTuple):
    loss: torch.Tensor           # [E, H] mean loss per local step (active clients)
    grad_norm: torch.Tensor      # scalar ||g / A||^2 of the last step
    z_norm: torch.Tensor
    y_norm: torch.Tensor
    participation: torch.Tensor  # fraction of clients active this round
    screened: torch.Tensor       # count of screened contributions
    comm_bytes: torch.Tensor     # modeled upload bytes on the wire this round


def _torch_dtype(dtype) -> torch.dtype | None:
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, str(dtype))


def sharded_init(params0: Tree, G: int, K: int, *, use_flat_state: bool = False,
                 correction_dtype=None, rng: torch.Generator | None = None,
                 round_counter: bool = False, staleness_snapshots: bool = False,
                 fault_download: bool = False, ef_client: bool = False,
                 ef_group: bool = False, device=None) -> ShardedHFLState:
    """Stacked per-client state on ``device`` (the CUDA card unless
    ``device="cpu"``). ``correction_dtype`` (a torch dtype or its name, e.g.
    ``"bfloat16"``) stores z and y narrower than the params; the flat layout
    packs params and corrections into one buffer per dtype, so it rejects
    it. ``rng`` draws the per-round participation masks and the
    stochastic-rounding noise (rounds that draw neither ignore it).
    ``round_counter`` carries the window counter async report cadences are
    read from; ``staleness_snapshots`` the download snapshots ``snap``
    [G, ...] and ``glob`` (copies of the initial model) of delay-compensated
    async rounds; ``fault_download`` the realized-download mask ``dl`` (all
    ones) of timeouts under an async schedule. ``ef_client`` / ``ef_group``
    carry the per-link error-feedback residuals compressed uploads
    accumulate, zero and always in the params' dtype (they store
    upload-delta error, not corrections)."""
    dev = resolve_device(device)
    cdt = _torch_dtype(correction_dtype)
    params0 = tu.tree_map(lambda t: torch.as_tensor(t).to(dev), params0)

    def stack(t, lead):
        return t.expand(lead + tuple(t.shape)).contiguous()

    rnd = torch.zeros((), dtype=torch.int32, device=dev) if round_counter else None
    dl = torch.ones(G, dtype=torch.float32, device=dev) if fault_download else None

    def snapshots(model):
        """(snap, glob): copies of the initial model, never views of it."""
        if not staleness_snapshots:
            return None, None
        return (tu.tree_map(lambda t: stack(t, (G,)), model),
                tu.tree_map(lambda t: t.clone(memory_format=torch.contiguous_format), model))

    if use_flat_state:
        if cdt is not None:
            raise ValueError("flat state packs params and corrections into one buffer per "
                             "dtype; correction_dtype needs the tree layout")
        packer = make_packer(params0)
        flat0 = packer.flatten(params0)
        snap, glob = snapshots(flat0)
        return ShardedHFLState(params=tu.tree_map(lambda b: stack(b, (G, K)), flat0),
                               z=packer.zeros((G, K), dev), y=packer.zeros((G,), dev), rng=rng,
                               round=rnd, snap=snap, glob=glob, dl=dl,
                               efc=packer.zeros((G, K), dev) if ef_client else None,
                               efg=packer.zeros((G,), dev) if ef_group else None)

    def zeros(lead, dtype=None):
        return tu.tree_map(lambda t: torch.zeros(lead + tuple(t.shape), dtype=dtype or t.dtype,
                                                 device=dev), params0)

    snap, glob = snapshots(params0)
    return ShardedHFLState(
        params=tu.tree_map(lambda t: stack(t, (G, K)), params0),
        z=zeros((G, K), cdt), y=zeros((G,), cdt), rng=rng,
        round=rnd, snap=snap, glob=glob, dl=dl,
        efc=zeros((G, K)) if ef_client else None,
        efg=zeros((G,)) if ef_group else None)


def make_sharded_round(loss_fn: Callable, *, E: int, H: int, lr: float,
                       algorithm: str = "mtgc", use_fused_update: bool = False,
                       fused_mode: str | None = None, client_participation: float = 1.0,
                       group_participation: float = 1.0, participation_mode: str = "uniform",
                       participation_weighting: str = "none", device=None):
    """One production round; batches ``[E, H, A, G, K, ...]``.

    .. deprecated::
        The legacy constructor, kept as in the reference: declare an
        ``ExperimentSpec(backend="sharded")`` and use
        ``repro_torch.api.build(spec, loss_fn)``, which this delegates to.
        The returned function reads (G, K) from the state it is given.
    """
    import warnings

    from repro_torch.core.api import ExperimentSpec, RoundSchedule, build

    warnings.warn("make_sharded_round is deprecated: declare an "
                  "ExperimentSpec(backend='sharded') and use repro_torch.api.build",
                  DeprecationWarning, stacklevel=2)
    spec = ExperimentSpec(
        schedule=RoundSchedule(group_rounds=E, local_steps=H), algorithm=algorithm, lr=lr,
        backend="sharded", state_layout="tree",
        fusion="fused" if use_fused_update else "none", fused_mode=fused_mode,
        client_participation=client_participation, group_participation=group_participation,
        participation_mode=participation_mode, participation_weighting=participation_weighting)
    return build(spec, loss_fn, device=device).round_fn


def _cols(n: int) -> list[slice]:
    """The contiguous pieces of a row of ``n`` elements, at most ``_CHUNK``
    each, in order."""
    return [slice(s, min(s + _CHUNK, n)) for s in range(0, n, _CHUNK)]


def _mean(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``torch.mean(x, dim)`` over a leading axis, one row of the axes
    before ``dim`` at a time, into contiguous pieces of the output of at
    most ``_CHUNK`` elements. PyTorch's CUDA reduction of a narrow tensor
    whose operands span more than 2^31 bytes allocates a float32
    accumulation buffer as large as its output's span (13.2 GB for the
    group mean of the flat glm4-9b state at 2 x 2, and as much again for a
    strided slice of that output); a contiguous piece keeps it to the
    piece. Each output element is the same mean over the same entries, so
    the result does not change."""
    out = torch.empty(x.shape[:dim] + x.shape[dim + 1:], dtype=x.dtype, device=x.device)
    n = math.prod(x.shape[dim + 1:])
    for idx in itertools.product(*(range(s) for s in x.shape[:dim])):
        rows, dst = x[idx].reshape(x.shape[dim], n), out[idx].view(n)
        for s in range(0, n, _CHUNK):
            torch.mean(rows[:, s:s + _CHUNK], dim=0, out=dst[s:s + _CHUNK])
    return out


def _sq_norm(tree: Tree) -> torch.Tensor:
    """``tree.tree_sq_norm`` (float32 sum of squares, leaf by leaf in leaf
    order). A leaf of more than ``_CHUNK`` elements is reduced by
    ``vector_norm`` in float32 without a float32 copy (its square then
    carries an ulp of the square root's rounding)."""
    total = None
    for x in tu.tree_leaves(tree):
        if x.numel() <= _CHUNK:
            s = torch.sum(x.to(torch.float32) * x.to(torch.float32))
        else:
            s = torch.linalg.vector_norm(x, dtype=torch.float32) ** 2
        total = s if total is None else total + s
    return total


def _put(dst: torch.Tensor, src: torch.Tensor, rows) -> None:
    """dst[r] <- src[r] for the rows r with ``rows[r]`` (a host bool array;
    None: all), in dst's dtype; the other rows keep their exact bits (the
    bits ``dst.copy_(where(rows, src, dst))`` leaves, without the copy)."""
    if rows is None:
        dst.copy_(src)
        return
    for r in np.flatnonzero(rows).tolist():
        dst[r].copy_(src[r])


def _correction_step(c: torch.Tensor, src: torch.Tensor, ref: torch.Tensor,
                     denom: float | None = None, coef: float | None = None) -> None:
    """c <- c + (src - ref) / denom (or c + coef * (src - ref), the async
    round's per-group float32 coefficient, as the reference writes it) in
    float32, stored in c's dtype, IN PLACE, on one piece of one replica (z:
    ``ref`` is its group's aggregate; y: the global one)."""
    # In place on one float32 temporary: a narrower operand is widened
    # exactly inside each op, so every rounding is the expression's
    # (c + (src - ref) / denom), and the last copy rounds into c's dtype.
    d = src.to(torch.float32, copy=True)
    d.sub_(ref)
    if coef is None:
        d.div_(denom)
    else:
        d.mul_(coef)
    d.add_(c)
    c.copy_(d)


# What a mesh round does not run yet, and where it comes from.
MESH_LATER = ("the mesh under compression, faults, async plans, populations and narrow "
              "corrections (ROADMAP queue 1)")


def _build_sharded_round(
    loss_fn: Callable[[Tree, Tree], torch.Tensor],
    *, E: int, H: int, lr: float, algorithm: str = "mtgc",
    use_fused_update: bool = False,
    fused_mode: str | None = None,
    client_participation: float = 1.0,
    group_participation: float = 1.0,
    participation_mode: str = "uniform",
    participation_weighting: str = "none",
    plan=None,
    faults=None,
    defense=None,
    compression=None,
    mesh=None,
) -> Callable[..., tuple[ShardedHFLState, ShardedMetrics]]:
    """The production-round builder behind ``repro_torch.api``'s sharded
    engine (the reference's signature). Returns ``round_fn(state, batches,
    draws=None)``; batches have leaves ``[E, H, A, G, K, ...]``, and
    ``draws=RoundDraws(masks=, client_noise=, group_noise=)`` fixes a
    round's participation masks, fault masks and stochastic-rounding noise
    (a field left None is drawn from ``state.rng``: the masks, then the
    fault masks, then each group round's client noise, then the group
    noise). ``fused_mode`` takes None or
    "auto" (the kernel on a CUDA tensor, its plain version on a CPU
    tensor); the reference's "pallas" and "interpret" have no counterpart
    here. ``compression`` (a ``CompressionPlan``) compresses the upload
    deltas of both links as the reference does, its round trips through
    the quantize kernels when ``use_fused_update`` holds and their plain
    versions otherwise, with the residuals ``sharded_init(...,
    ef_client=, ef_group=)`` carries. ``faults`` (a ``FaultPlan``) and
    ``defense`` (a ``DefensePlan``) inject faults and screen the uploads as
    the simulator engine does. ``plan`` (a ``StalenessPlan``) runs async
    group rounds as the simulator engine does, ``E`` being the padded loop
    length ``max(E_g)``; the state then carries the window counter (and,
    by the plan, ``snap``/``glob`` and ``dl``). ``mesh`` (a ``DeviceMesh``)
    runs the round over its (group, client) dims: the state is each rank's
    block, the batches the whole ``[E, H, A, G, K, ...]`` or the rank's
    block of them, ``draws.masks`` the whole ``[G, K]`` masks."""
    use_corr = algorithm == "mtgc"
    if algorithm not in ("mtgc", "hfedavg"):
        raise ValueError(f"unknown sharded algorithm {algorithm!r} (choose 'mtgc' or 'hfedavg')")
    if use_fused_update and not use_corr:
        raise ValueError("use_fused_update fuses exactly g/A + z + y: mtgc only")
    if fused_mode not in (None, "auto"):
        raise ValueError(f"fused_mode {fused_mode!r} has no counterpart in the port: the "
                         "kernel runs on a CUDA tensor, its plain version on a CPU tensor "
                         "(None or 'auto')")
    if participation_mode not in ("uniform", "fixed"):
        raise ValueError(f"unknown participation mode {participation_mode!r}")
    if participation_weighting not in ("none", "inverse_prob"):
        raise ValueError(f"unknown participation weighting {participation_weighting!r}")
    if not (0.0 < client_participation <= 1.0 and 0.0 < group_participation <= 1.0):
        raise ValueError("participation fractions must be in (0, 1], got "
                         f"{client_participation}/{group_participation}")
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
    comp = compression if (compression is not None and compression.enabled) else None
    if comp is not None:
        comp.validate()
        if plan is not None:
            raise ValueError(
                "compressed uploads under an async schedule are not supported yet: stale "
                "reports would need their own residual timeline (see ROADMAP)")
    async_mode = plan is not None
    if async_mode:
        if plan.e_pad != E:
            raise ValueError(f"E must be the padded loop length max(E_g)={plan.e_pad}, got {E}")
        # The plan's static constants: the iteration mask on the host (each
        # group round's active rows) and on the device (its mask), the merge
        # weights, and each group's y coefficient 1 / (E_g r_g H lr) in
        # float32 as the reference computes it.
        em_np = plan.iteration_mask()
        dw_np = plan.discount_weights()
        y_coef = [float(np.float32(1.0) / (np.float32(e) * np.float32(H) * np.float32(lr)))
                  for e in plan.effective_rounds]
        plan_on = {}
    cmode = comp.client_mode if comp is not None else "none"
    gmode = comp.group_mode if comp is not None else "none"
    comp_c, comp_g = cmode != "none", gmode != "none"
    ef_c = comp is not None and comp.ef_client
    ef_g = comp is not None and comp.ef_group
    frac = comp.topk_frac if comp is not None else 0.01
    partial = client_participation < 1.0 or group_participation < 1.0
    ht = partial and participation_weighting == "inverse_prob"
    # The phase-start model is kept when an upload is taken against it: the
    # client link's delta, a corrupted delta, the screen's norm and clip, and
    # the revert of a fully screened group.
    keep_start = comp_c or f_corrupt or defended
    mx = None
    if mesh is not None:
        from repro_torch.sharding.state import MeshAxes

        for on, what in ((comp is not None, "compressed uploads"), (fault_mode, "faults"),
                         (defended, "the defense"), (async_mode, "async group rounds")):
            if on:
                raise ValueError(f"{what} on a mesh are not supported yet: they come with "
                                 f"{MESH_LATER}")
        mx = MeshAxes(mesh)
        if mx.trivial:
            mx = None

    def client_grads(x_tree: Tree, acc_tree: Tree, batch_h: Tree, G: int, K: int):
        """Per-client summed loss [G, K] and the gradient summed over the A
        chunks into ``acc_tree`` (zeroed first), one replica at a time."""
        acc_leaves = tu.tree_leaves(acc_tree)
        for a in acc_leaves:
            a.zero_()
        A = tu.tree_leaves(batch_h)[0].shape[0]
        lsum = torch.zeros((G, K), dtype=torch.float32, device=acc_leaves[0].device)
        for a in range(A):
            for g in range(G):
                for k in range(K):
                    with torch.enable_grad():
                        p = tu.tree_map(lambda t: t[g, k].detach().requires_grad_(), x_tree)
                        leaves = tu.tree_leaves(p)
                        loss = loss_fn(p, tu.tree_map(lambda b: b[a, g, k], batch_h))
                        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
                    for acc, gr in zip(acc_leaves, grads):
                        if gr is not None:
                            acc[g, k].add_(gr)
                    lsum[g, k] += loss.detach().to(torch.float32)
        # A reference cycle made inside loss_fn (the lazy imports of its first
        # call in a process capture the calling frames) can keep this frame
        # and round_fn's alive after the round, until the next collection:
        # they hold no gradient memory when they return.
        del acc_leaves, acc_tree, acc, gr, grads
        return lsum, 1.0 / A

    @torch.no_grad()
    def round_fn(state: ShardedHFLState, batches: Tree,
                 draws: RoundDraws | None = None) -> tuple[ShardedHFLState, ShardedMetrics]:
        x, z, y = state.params, state.z, state.y
        flat = is_flat(x)
        packer = x.packer if flat else None
        G, K = tu.tree_leaves(x)[0].shape[:2]
        dev = tu.tree_leaves(x)[0].device
        draws = draws if draws is not None else RoundDraws()
        # The whole topology (Gt, Kt) and this rank's rows of it (a mesh
        # holds the block [gs, ks]; one card, all of it).
        Gt, Kt, gs, ks = G, K, slice(None), slice(None)
        if mx is not None:
            Gt, Kt = mx.totals(G, K)
            gs, ks = mx.block(Gt, Kt)
            lead = tuple(tu.tree_leaves(batches)[0].shape[3:5])
            if lead == (Gt, Kt) and (Gt, Kt) != (G, K):
                batches = tu.tree_map(lambda b: b[:, :, :, gs, ks], batches)
            elif lead != (G, K):
                raise ValueError(f"batches [E, H, A, G, K, ...] of (G, K) = {lead}: expected the "
                                 f"whole {(Gt, Kt)} or this rank's block {(G, K)}")

        def generator(what: str) -> torch.Generator:
            if state.rng is None:
                raise ValueError(
                    f"this round draws {what} from the state: build it with "
                    f"sharded_init(..., rng=torch.Generator(...)) or pass them in draws=")
            return state.rng

        # Masks first, then the fault masks, then the rounding noise (drawn
        # where it is used).
        cmask = gmask = cdenom = gdenom = cm_all = None
        if partial:
            if draws.masks is not None:
                masks = ParticipationMasks(
                    *(torch.as_tensor(m).to(dev, torch.float32) for m in draws.masks))
            else:
                masks = sample_hfl_masks(generator("per-round masks"), Gt, Kt,
                                         client_participation, group_participation,
                                         participation_mode)
            cmask, gmask = masks.client, masks.group
            if mx is not None:
                # Every rank holds the whole mask and reads its own rows.
                cm_all = cmask
                cmask, gmask = cmask[gs, ks].contiguous(), gmask[gs].contiguous()
            cdenom = (inclusion_prob(client_participation, Kt, participation_mode) * Kt
                      if ht else None)
            gdenom = (inclusion_prob(group_participation, Gt, participation_mode) * Gt
                      if ht else None)
        if fault_mode:
            fm = (draws.faults if draws.faults is not None
                  else fault_masks(generator("fault masks"), faults, G, K))
            fm = FaultMasks(*(torch.as_tensor(m).to(dev, torch.float32) for m in fm))
            if f_crash:
                # A crashed client is frozen exactly like an unsampled one.
                alive = 1.0 - fm.crash
                cmask = alive if cmask is None else cmask * alive
        if (fault_mode or defended) and cmask is None:
            cmask = torch.ones((G, K), dtype=torch.float32, device=dev)
        rep = fresh = None
        rep_read = async_mode and (plan.needs_round_counter or f_timeout)
        if async_mode:
            if plan.num_groups != G:
                raise ValueError(f"staleness plan covers {plan.num_groups} groups, state has {G}")
            if plan.needs_round_counter and state.round is None:
                raise ValueError(
                    "this async schedule reads report cadences from the window counter: "
                    "build the state with sharded_init(..., round_counter=True) "
                    "(repro_torch.api.build does this for you)")
            if dev not in plan_on:
                plan_on[dev] = tuple(torch.from_numpy(a).to(dev, non_blocking=True)
                                     for a in (em_np, dw_np))
            em_all, dw = plan_on[dev]
            t = (state.round if state.round is not None
                 else torch.zeros((), dtype=torch.int32, device=dev))
            rep, fresh = plan.report_mask(t), plan.fresh_mask(t)      # [G] each
            if f_timeout:
                # A timed-out group misses its report; freshness comes from
                # the realized downloads of the last window.
                if state.dl is None:
                    raise ValueError(
                        "group-timeout faults under an async schedule carry the "
                        "realized-download mask in the state: build it with "
                        "sharded_init(..., fault_download=True) (repro_torch.api.build does "
                        "this for you)")
                rep = rep * (1.0 - fm.timeout)
                fresh = state.dl
        # One host copy: the activity mask (which replicas to touch) and the
        # window's report mask (which groups merge and download).
        host = [m.reshape(-1) for m in (cmask if cm_all is None else cm_all,
                                         rep if rep_read else None) if m is not None]
        host = torch.cat(host).cpu().numpy() != 0 if host else None
        rep_host = (host[-G:] if rep_read else np.ones(G, dtype=bool)) if async_mode else None
        active_all = gact_all = cnt_all = None
        if cmask is not None:
            if cm_all is None:
                n_active = torch.clamp(torch.sum(cmask), min=1.0)
                active = host[:G * K].reshape(G, K)
                gact = (torch.sum(cmask, dim=1) > 0).to(torch.float32)
            else:
                # The counts and the groups' activity from the whole mask;
                # the host rows of the whole mask decide, alike on every
                # rank of a collective, which groups aggregate.
                n_active = torch.clamp(torch.sum(cm_all), min=1.0)
                active_all = host[:Gt * Kt].reshape(Gt, Kt)
                active = active_all[gs, ks]
                cnt_all = torch.sum(cm_all, dim=1)
                gact_all = (cnt_all > 0).to(torch.float32)
                gact = gact_all[gs].contiguous()
        else:
            n_active = active = gact = None
        bad = bad_host = None
        if f_corrupt:
            # Only a client that worked this round can upload garbage.
            bad = fm.corrupt * cmask
            bad_host = bad.cpu().numpy() != 0
        # The group round's activity: the round's own, or under an async
        # schedule that times the iteration mask (set per group round).
        am, n_act, act, bad_e, bad_host_e = cmask, n_active, active, bad, bad_host

        def live(e: int):
            """Group round e's (mask, active count, host rows, corrupted
            uploads, their host rows) under an async schedule: the iteration
            mask times the activity mask, taken without another host copy."""
            em = em_all[e][:, None]
            am_e = em * cmask if cmask is not None else em.expand(G, K).contiguous()
            emh = em_np[e][:, None] != 0
            act_e = emh & active if active is not None else np.repeat(emh, K, axis=1)
            return (am_e, torch.clamp(torch.sum(am_e), min=1.0), act_e,
                    None if bad is None else bad * em, None if bad_host is None else bad_host & emh)

        def rand(shape) -> torch.Tensor:
            """U[0, 1) stochastic-rounding noise from ``state.rng``."""
            return torch.rand(shape, generator=generator("stochastic-rounding noise"),
                              dtype=torch.float32, device=dev)

        def injected(t, rows: int, sl: slice) -> torch.Tensor:
            """Columns ``sl`` of an injected noise tensor of ``rows`` rows."""
            return torch.as_tensor(t).to(dev).reshape(rows, -1)[:, sl]

        def replayable():
            """The generator's state before a screening pass that draws the
            noise its second pass must draw again (None: nothing to replay)."""
            return state.rng.get_state() if state.rng is not None else None

        def replay(rng_state) -> None:
            if rng_state is not None:
                state.rng.set_state(rng_state)

        def select_(dst: torch.Tensor, new: torch.Tensor) -> None:
            """dst <- new on the group round's active replicas of a [G, K, ...]
            leaf (all at full participation)."""
            _put(dst.view(G * K, -1), new.reshape(G * K, -1),
                 None if act is None else act.reshape(-1))

        efc = efg = None
        for on, field, flag in ((ef_c, "efc", "ef_client"), (ef_g, "efg", "ef_group")):
            if on and getattr(state, field) is None:
                raise ValueError(
                    f"error feedback carries the {field} residuals in the state: build it "
                    f"with sharded_init(..., {flag}=True) (repro_torch.api.build does this "
                    f"for you)")
        if ef_c:
            efc = [t.view(G, K, -1) for t in tu.tree_leaves(state.efc)]
        if ef_g:
            efg = [t.view(G, -1) for t in tu.tree_leaves(state.efg)]

        # The group link's reference, which both of its ends hold: each
        # group's round-start model (full participation), or the mean of its
        # participating replicas' round-start models, kept as their sum in
        # the params' dtype and divided by their count where it is read.
        gref = gref_dn = None
        if comp_g:
            gref = []
            for xi in tu.tree_leaves(x):
                x3 = xi.view(G, K, -1)
                if cmask is None:
                    gref.append(x3[:, 0].clone(memory_format=torch.contiguous_format))
                    continue
                gs = torch.empty_like(x3[:, 0], memory_format=torch.contiguous_format)
                for sl in _cols(x3.shape[-1]):
                    xp = x3[:, :, sl]
                    gs[:, sl] = torch.sum(torch.where(tu.expand_mask(cmask, xp) != 0, xp, 0),
                                          dim=1)
                gref.append(gs)
            if cmask is not None:
                gref_dn = torch.clamp(torch.sum(cmask, dim=1), min=1)

        def gref_piece(i: int, sl: slice) -> torch.Tensor:
            gs = gref[i][:, sl]
            return gs if gref_dn is None else gs / tu.expand_mask(gref_dn, gs)

        def step_loss_mean(lsum, inv_a):
            lpc = lsum * inv_a
            if mx is not None:
                # This rank's share of the numerator; the round reduces it
                # over the mesh and divides once at its end.
                return (torch.sum(torch.where(am != 0, lpc, 0)) if am is not None
                        else torch.sum(lpc))
            if defended:
                # A corrupted client that has not healed yet has a non-finite
                # loss while its upload is screened: so is the metric.
                w = am * torch.isfinite(lpc).to(torch.float32)
                return (torch.sum(torch.where(w != 0, lpc, 0))
                        / torch.clamp(torch.sum(w), min=1.0))
            if am is not None:
                return torch.sum(torch.where(am != 0, lpc, 0)) / n_act
            return torch.mean(lpc)

        if use_corr:
            # Alg. 1 line 3 (footnote 2's zero init): z restarts every global
            # round, for participants only; only y persists across rounds.
            # Async: once per report cycle, for the groups that start from a
            # fresh download (mid-cycle stragglers keep accumulating).
            zmask = cmask
            if async_mode:
                zmask = fresh[:, None] * cmask if cmask is not None else fresh[:, None]
            for zl in tu.tree_leaves(z):
                if zmask is None:
                    zl.zero_()
                else:
                    zl.masked_fill_(tu.expand_mask(zmask, zl) != 0, 0)

        def phase_start(i: int, g: int, sl: slice) -> torch.Tensor:
            """Group g's phase-start model of leaf i, one piece ([piece] shared
            by the group's replicas, or [K, piece])."""
            return xs[i][g, sl] if xs[i].dim() == 2 else xs[i][g, :, sl]

        def client_u(i: int, g: int, sl: slice, start: torch.Tensor) -> torch.Tensor:
            """The client link's input: the K deltas plus their residuals."""
            u = x_leaves[i][g, :, sl] - start
            return u + efc[i][g, :, sl] if ef_c else u

        def client_views(e: int, i: int, g: int, sl: slice, param):
            """One piece of group g's K uploads of leaf i: ``(x_end, start,
            x_up, x_loc, u, deq)`` -- the local models (a view of the state),
            the phase-start model, the upload view (through the client link,
            then corrupted), the client's own view z updates from (the upload
            uncompressed; the corrupted pre-wire model compressed), and the
            link's input and output."""
            x_end = x_leaves[i][g, :, sl]
            start = None if xs is None else phase_start(i, g, sl)
            x_up, u, deq = x_end, None, None
            if comp_c:
                # The wire carries the dequantized delta.
                u = client_u(i, g, sl, start)
                noise = None
                if cmode == "int8_stochastic":
                    noise = (rand((K, sl.stop - sl.start)) if draws.client_noise is None
                             else injected(draws.client_noise[e][i], G * K,
                                           sl)[g * K:(g + 1) * K])
                deq = cmp.roundtrip_block(u, cmode, param, noise, use_fused_update)
                x_up = start + deq
            x_loc = x_up
            if f_corrupt and bad_host_e[g].any():
                rows = bad_e[g][:, None] != 0
                x_up = torch.where(rows, start + payload(x_up - start, faults), x_up)
                x_loc = (torch.where(rows, start + payload(x_end - start, faults), x_end)
                         if comp_c else x_up)
            elif comp_c:
                x_loc = x_end
            return x_end, start, x_up, x_loc, u, deq

        def link_param(i: int, g: int):
            """The client link's row parameters of group g's uploads of leaf i
            (the int8 scale, the top-k threshold): a pass over the pieces."""
            if not comp_c:
                return None
            n = x_leaves[i].shape[-1]
            return cmp.row_params(
                cmode, (client_u(i, g, sl, phase_start(i, g, sl)) for sl in _cols(n)), n, frac)

        def screen(e: int):
            """Pass 1 of a defended group round: each client's float32 squared
            delta norm and the all-finite flag of its upload view's entries,
            over every leaf, piece by piece; then the defense's verdict."""
            sqn = torch.zeros((G, K), dtype=torch.float32, device=dev)
            fin = torch.ones((G, K), dtype=torch.bool, device=dev)
            rng_state = replayable() if comp_c else None
            for i in range(len(x_leaves)):
                for g in range(G):
                    param = link_param(i, g)
                    for sl in _cols(x_leaves[i].shape[-1]):
                        _, start, x_up, *_ = client_views(e, i, g, sl, param)
                        d = (x_up - start).to(torch.float32)
                        sqn[g] += torch.sum(d * d, dim=1)
                        fin[g] &= torch.isfinite(x_up).all(dim=1)
                        del d, x_up
            replay(rng_state)
            ok, hit, scale = screen_tests(sqn, fin.to(torch.float32), defense)
            smask = am * ok
            if hit is not None:
                hit = hit & (am != 0)   # a frozen client uploads nothing
            has_srv = torch.sum(smask, dim=1) > 0
            return {"smask": smask, "srv": smask.cpu().numpy() != 0,
                    "has_srv": has_srv.cpu().numpy(), "hit": hit, "scale": scale,
                    "hit_host": None if hit is None else hit.cpu().numpy(),
                    "screened": torch.sum(am) - torch.sum(smask)}

        def aggregate_group(e: int, i: int, zi: torch.Tensor, sv) -> None:
            """One leaf's client uploads, group mean over the surviving clients
            (line 8), z update (line 9) and dissemination, group by group and
            piece by piece: the temporaries are [K, piece]."""
            z3 = zi.view(G, K, -1)
            cols = _cols(x_leaves[i].shape[-1])
            for g in range(G):
                act_g = None if act is None else act[g]
                # On a mesh the whole group's activity decides (alike on
                # every rank of the client all-reduce).
                act_w = act_g if active_all is None else active_all[gs][g]
                if act_w is not None and not act_w.any() and not comp_c:
                    # No active replica (a straggler's idle iteration): its
                    # mean is an exact zero that nothing reads, and no
                    # replica or z is written. (The client link draws its
                    # noise for every group, so it goes through.)
                    continue
                srv = act_g if sv is None else sv["srv"][g]
                smask_g = (None if am is None
                           else (am if sv is None else sv["smask"])[g:g + 1])
                param = link_param(i, g)
                for sl in cols:
                    x_end, start, x_up, x_loc, u, deq = client_views(e, i, g, sl, param)
                    if sv is not None and sv["hit"] is not None and sv["hit_host"][g].any():
                        clipped = start + tu.expand_mask(sv["scale"][g], x_up).to(
                            x_up.dtype) * (x_up - start)
                        x_up = torch.where(sv["hit"][g][:, None], clipped, x_up)
                        if not comp_c:
                            x_loc = x_up
                    if ef_c:
                        # The residual advances only for an upload that entered
                        # the mean.
                        _put(efc[i][g, :, sl], u - deq, srv)
                    if mx is not None and mx.pg["client"] is not None:
                        xbar = client_mean(x_up, None if am is None else smask_g[0], g)
                    elif am is None:
                        xbar = _mean(x_up, 0)
                    else:
                        xbar = tu.tree_masked_mean(x_up[None], smask_g, axis=1,
                                                   denom=cdenom)[0]
                    del x_up, u, deq
                    if use_corr:
                        # z_i += (x_{i,H} - xbar_j) / (H * lr), gated on the
                        # screen.
                        for k in range(K):
                            if srv is None or srv[k]:
                                _correction_step(z3[g, k, sl], x_loc[k], xbar, H * lr)
                    del x_loc
                    # Active clients download (a screened one too: that heals
                    # it), unless the whole group was screened: then they
                    # revert to the phase-start model.
                    if sv is None or sv["has_srv"][g]:
                        _put(x_end, xbar.expand(x_end.shape), act_g)
                    else:
                        _put(x_end, start.expand(x_end.shape), act_g)
                    if xs is not None and e < E - 1:
                        # The next phase starts from what was disseminated.
                        if xs[i].dim() == 3:
                            xs[i][g, :, sl].copy_(x_end)
                        elif (sv is None or sv["has_srv"][g]) and (act_g is None
                                                                   or act_g.any()):
                            xs[i][g, sl].copy_(xbar)

        def client_mean(xk: torch.Tensor, mk, g: int) -> torch.Tensor:
            """Group g's mean over the client axis of the mesh from this
            rank's rows ``xk`` [K_l, piece] (masked by ``mk`` [K_l]): the
            float32 sum of the rows, all-reduced over ``client``, then the
            single-card expression's division -- ``torch.mean``'s (the sum
            over K, in the rows' dtype), or the masked mean's (the sum
            rounded to the rows' dtype, over the group's active count or
            the inverse-probability denominator)."""
            if mk is None:
                s = mx.sum_(torch.sum(xk, dim=0, dtype=torch.float32), "client")
                return s.div_(Kt).to(xk.dtype)
            s = torch.sum(torch.where(mk[:, None] != 0, xk, 0), dim=0, dtype=torch.float32)
            s = mx.sum_(s, "client").to(xk.dtype)
            if cdenom is not None:
                return s / cdenom
            return s / torch.clamp(cnt_all[gs][g:g + 1], min=1)

        def own(i: int, sl: slice) -> torch.Tensor:
            """The groups' own (pre-wire) aggregates of one piece of leaf i
            [G, piece]: the recovery mean under a mask (every active replica
            of a group holds its xbar_j), else replica 0."""
            x3 = x_leaves[i]
            if cmask is None:
                return x3[:, 0, sl]
            if mx is not None and mx.pg["client"] is not None:
                xp = x3[:, :, sl]
                s = torch.sum(torch.where(tu.expand_mask(cmask, xp) != 0, xp, 0), dim=1,
                              dtype=torch.float32)
                s = mx.sum_(s, "client").to(xp.dtype)
                return s / tu.expand_mask(torch.clamp(cnt_all[gs], min=1), s)
            return tu.tree_masked_mean(x3[:, :, sl], cmask, axis=1)

        def group_mean(wire: torch.Tensor) -> torch.Tensor:
            """The global mean over the group axis of the mesh from this
            rank's group reports ``wire`` [G_l, piece], as
            :func:`client_mean` forms the group mean: float32 sums
            all-reduced over ``group``, then the single-card division."""
            def total(w):
                s = torch.sum(w, dim=0, dtype=torch.float32)
                return mx.sum_(s, "group")

            if cmask is None:
                return total(wire).div_(Gt).to(wire.dtype)
            if gdenom is None:
                s = total(torch.where(tu.expand_mask(gact, wire) != 0, wire, 0)).to(wire.dtype)
                return s / torch.clamp(torch.sum(gact_all), min=1).reshape(1)
            live = torch.where(tu.expand_mask(gact, wire) != 0, wire, 0)
            s = total(torch.where(tu.expand_mask(gmask, live) != 0, live, 0)).to(wire.dtype)
            return s / gdenom

        def group_u(i: int, sl: slice, xbar_j: torch.Tensor) -> torch.Tensor:
            """The group link's input: the G report deltas plus residuals."""
            ug = xbar_j - gref_piece(i, sl)
            return ug + efg[i][:, sl] if ef_g else ug

        def global_reports(i: int, sl: slice, param, gsel):
            """One piece of leaf i's G group reports: ``(xbar_j, wire, ug,
            deq)`` -- the groups' own aggregates, the reports through the
            group link (a group outside ``gsel`` keeps its own), and the
            link's input and output."""
            xbar_j = own(i, sl)
            wire, ug, deq = xbar_j, None, None
            if comp_g:
                ref = gref_piece(i, sl)
                ug = group_u(i, sl, xbar_j)
                noise = None
                if gmode == "int8_stochastic":
                    noise = (rand((G, sl.stop - sl.start)) if draws.group_noise is None
                             else injected(draws.group_noise[i], G, sl))
                deq = cmp.roundtrip_block(ug, gmode, param, noise, use_fused_update)
                wire = ref + deq
                if gsel is not None:
                    wire = torch.where(tu.expand_mask(gsel, wire) != 0, wire, xbar_j)
            return xbar_j, wire, ug, deq

        def group_link_param(i: int):
            if not comp_g:
                return None
            n = x_leaves[i].shape[-1]
            return cmp.row_params(gmode, (group_u(i, sl, own(i, sl)) for sl in _cols(n)), n,
                                  frac)

        def aggregate_global(i: int, yi: torch.Tensor, rows) -> None:
            """One leaf's group reports (through the group link), global mean
            over the merging groups (line 10), y update (line 11) and
            dissemination to ``rows`` (host bools over the G * K replicas;
            None: all), piece by piece: the temporaries are [G, K, piece] at
            most."""
            x3, y2 = x_leaves[i], yi.view(G, -1)
            param = group_link_param(i)
            for sl in _cols(x3.shape[-1]):
                xbar_j, wire, ug, deq = global_reports(i, sl, param, gact)
                if ef_g:
                    _put(efg[i][:, sl], ug - deq, gact_host)
                if mx is not None and mx.pg["group"] is not None:
                    xbar = group_mean(wire)
                elif cmask is None:
                    xbar = _mean(wire, 0)
                elif gdenom is None:
                    xbar = tu.tree_masked_mean(wire, gact, axis=0)
                else:
                    xbar = tu.tree_masked_mean(
                        torch.where(tu.expand_mask(gact, wire) != 0, wire, 0), gmask, axis=0,
                        denom=gdenom)
                del wire, ug, deq
                if use_corr:
                    # y_j += (xbar_j - xbar) / (H * E * lr), from the group's
                    # own (pre-wire) aggregate; only merging groups.
                    for g in range(G):
                        if gact_host is None or gact_host[g]:
                            _correction_step(y2[g, sl], xbar_j[g], xbar, H * E * lr)
                del xbar_j
                _put(x3[:, :, sl].reshape(G * K, -1), xbar.expand(G * K, xbar.shape[-1]), rows)

        def aggregate_global_async(i: int, yi: torch.Tensor, weights, obs_host, rows,
                                   glob_write: bool) -> None:
            """One leaf's staleness-aware merge (the async global step), piece
            by piece: the groups' recovered reports (shifted by ``glob -
            snap_g`` under delay compensation, in float32 and rounded once to
            the report's dtype), their weighted merge ``weights = (wsum,
            sup, den)``, the y update of the observed groups (``obs_host``)
            with each group's own coefficient, the download to ``rows`` and
            the ``snap``/``glob`` writes."""
            x3, y2 = x_leaves[i], yi.view(G, -1)
            wsum, sup, den = weights
            if dc:
                snap2, glob1 = snap_leaves[i], glob_leaves[i]
            for sl in _cols(x3.shape[-1]):
                xbar_j = own(i, sl)
                used = xbar_j
                if dc:
                    # Copies, never views of the state: the download below
                    # overwrites the replicas they are read from.
                    shift = glob1[sl].to(torch.float32) - snap2[:, sl].to(torch.float32)
                    used = (xbar_j.to(torch.float32) + shift).to(xbar_j.dtype)
                    del shift
                live = tu.expand_mask(sup, used) != 0
                xbar = torch.sum(torch.where(live, used, 0) * tu.expand_mask(wsum, used),
                                 dim=0) / den
                del live
                if use_corr:
                    # y_j += (report_j - xbar) / (E_j r_j H lr): a reporting
                    # group ran E_j r_j group rounds since its download.
                    for g in range(G):
                        if obs_host[g]:
                            _correction_step(y2[g, sl], used[g], xbar, coef=y_coef[g])
                del used, xbar_j
                _put(x3[:, :, sl].reshape(G * K, -1), xbar.expand(G * K, xbar.shape[-1]), rows)
                if dc:
                    # Reporting groups record the model they downloaded; the
                    # server records it when the window merged anything.
                    _put(snap2[:, sl], xbar.expand(G, xbar.shape[-1]), obs_host)
                    if glob_write:
                        glob1[sl].copy_(xbar)

        def local_update(acc, acc_tree, corr_t, inv_a) -> None:
            """The local step (Alg. 1 line 7) from the summed gradient."""
            if use_fused_update:
                # g / A + z + y and the step in one kernel launch per leaf
                # (tree) or per dtype buffer (flat); y stays [G, ...] and
                # the mask gates frozen replicas inside the kernel.
                for xi, gi, zi, yi in zip(tu.tree_leaves(x), tu.tree_leaves(acc),
                                          tu.tree_leaves(z), tu.tree_leaves(y)):
                    xg = xi.view(G, K, -1)
                    kops.mtgc_update_flat(xg, gi.view(G, K, -1), zi.view(G, K, -1),
                                          yi.view(G, -1), am, lr=lr, g_scale=inv_a, out=xg)
            elif use_corr and flat:
                for xi, gi, ci in zip(tu.tree_leaves(x_tree), tu.tree_leaves(acc_tree),
                                      tu.tree_leaves(corr_t)):
                    select_(xi, xi - lr * (gi * inv_a + ci))
            elif use_corr:
                for xi, gi, zi, yi in zip(tu.tree_leaves(x), tu.tree_leaves(acc),
                                          tu.tree_leaves(z), tu.tree_leaves(y)):
                    select_(xi, xi - lr * (gi * inv_a + zi.to(gi.dtype)
                                           + yi[:, None].to(gi.dtype)))
            else:
                for xi, gi in zip(tu.tree_leaves(x_tree), tu.tree_leaves(acc_tree)):
                    select_(xi, xi - lr * gi * inv_a)

        # The [G, K] gradient accumulator (the reference's scan carry).
        acc = tu.tree_zeros_like(x)
        x_tree = packer.unflatten(x) if flat else x
        acc_tree = packer.unflatten(acc) if flat else acc
        x_leaves = [t.view(G, K, -1) for t in tu.tree_leaves(x)]

        losses, last_g, xs, scrs = [], None, None, []
        for e in range(E):
            if async_mode:
                am, n_act, act, bad_e, bad_host_e = live(e)
            if keep_start and e == 0:
                # The phase-start model the uploads are taken against: [G, ...]
                # when the active replicas of each group hold one model (and
                # then after each dissemination), else a copy of the
                # [G, K, ...] replicas (a client that missed a download holds
                # a stale model).
                def agree(t3, g):
                    ks = range(K) if act is None else np.flatnonzero(act[g]).tolist()
                    return all(torch.equal(t3[g, k], t3[g, ks[0]]) for k in ks[1:])

                shared = all(agree(t, g) for t in x_leaves for g in range(G))
                xs = []
                for t in x_leaves:
                    if not shared:
                        xs.append(t.clone(memory_format=torch.contiguous_format))
                        continue
                    first = [0 if act is None or not act[g].any()
                             else int(np.flatnonzero(act[g])[0]) for g in range(G)]
                    xs.append(torch.stack([t[g, k] for g, k in enumerate(first)]))
            loss_e = []
            # Flat, unfused: z + y folded into one correction for the phase.
            corr_t = None
            if flat and use_corr and not use_fused_update:
                corr_t = packer.unflatten(tu.tree_map(lambda zb, yb: zb + yb[:, None], z, y))
            for h in range(H):
                batch_h = tu.tree_map(lambda b: b[e, h], batches)
                lsum, inv_a = client_grads(x_tree, acc_tree, batch_h, G, K)
                local_update(acc, acc_tree, corr_t, inv_a)
                loss_e.append(step_loss_mean(lsum, inv_a))
                if e == E - 1 and h == H - 1:
                    if am is not None:
                        # The last step's gradient is read only here: zero the
                        # frozen replicas' (and, defended, the non-finite
                        # ones') in place, the bits a where-copy would hold,
                        # rather than copying the accumulator.
                        keep = am != 0
                        if defended:
                            for t in tu.tree_leaves(acc):
                                t3 = t.view(G, K, -1)
                                keep &= torch.stack([
                                    torch.stack([all_finite(t3[g, k]) for k in range(K)])
                                    for g in range(G)])
                        for t in tu.tree_leaves(acc):
                            t.masked_fill_(tu.expand_mask(~keep, t), 0)
                        del t, keep
                    last_g = _sq_norm(acc) * inv_a * inv_a
            losses.append(torch.stack(loss_e))
            sv = screen(e) if defended else None
            if sv is not None:
                scrs.append(sv["screened"])
            for i, zi in enumerate(tu.tree_leaves(z)):
                aggregate_group(e, i, zi, sv)
            del sv
        del acc, acc_tree, corr_t, xs
        screened = (torch.sum(torch.stack(scrs)) if scrs
                    else torch.zeros((), dtype=torch.float32, device=dev))

        # The merging groups: active, not timed out, and (defended) with a
        # finite report -- the backstop reads every report first. (Under an
        # async schedule a timed-out group is out of the report mask.)
        gup = Gt
        gact_host = rows = gfin = None
        if cmask is not None:
            if f_timeout and not async_mode:
                gact = gact * (1.0 - fm.timeout)
            # Reports actually sent (before the screen).
            gup = (torch.sum(gact if gact_all is None else gact_all) if not async_mode
                   else torch.sum(rep * gact))
            if defended and defense.screen_nonfinite:
                gfin = torch.ones(G, dtype=torch.bool, device=dev)
                rng_state = replayable() if comp_g else None
                for i in range(len(x_leaves)):
                    param = group_link_param(i)
                    for sl in _cols(x_leaves[i].shape[-1]):
                        wire = global_reports(i, sl, param, gact)[1]
                        gfin &= torch.isfinite(wire).all(dim=1)
                replay(rng_state)
                gfin = gfin.to(torch.float32)
                screened = screened + torch.sum(cmask * (gact * (1.0 - gfin))[:, None])
                gact = gact * gfin
            if not async_mode:
                gact_host = gact.cpu().numpy() != 0
                dm = cmask
                if fault_mode or defended:
                    # Timed-out groups miss the download too, and no one
                    # downloads a global mean with no merging group.
                    dm = dm * (torch.sum(gact) > 0).to(torch.float32)
                    if f_timeout:
                        dm = dm * (1.0 - fm.timeout)[:, None]
                rows = dm.cpu().numpy().reshape(-1) != 0
        if async_mode:
            # The staleness-aware merge of the groups reporting this window:
            # weights rep x dw x the participation estimator.
            if cmask is not None:
                # Observed: reporting, active and (defended) finite; from the
                # round's host copy and, after the backstop, its verdict.
                obs_host = rep_host & active.any(axis=1)
                if gfin is not None:
                    obs_host = obs_host & (gfin.cpu().numpy() != 0)
            else:
                obs_host = rep_host
                gup = torch.sum(rep)
            any_obs = bool(obs_host.any())
            w = rep * dw
            if ht:
                wsum = w * gmask
                sup = wsum * gact
                den = (gdenom / G) * torch.sum(w)
            elif cmask is not None:
                wsum = sup = w * gact
                den_raw = torch.sum(wsum)
                den = torch.where(den_raw > 0, den_raw, 1.0)
            else:
                wsum = sup = w
                den = torch.sum(w)
            # Only reporting groups download (stragglers keep their
            # mid-cycle replicas); with faults or the defense, none from a
            # window that merged nothing.
            dm_host = np.repeat(rep_host[:, None], K, axis=1)
            if cmask is not None:
                dm_host = dm_host & active
            if (fault_mode or defended) and not any_obs:
                dm_host = np.zeros_like(dm_host)
            dc = plan.needs_snapshots
            if dc:
                if state.snap is None or state.glob is None:
                    raise ValueError(
                        "staleness='delay_compensated' carries per-group download snapshots "
                        "in the state: build it with sharded_init(..., "
                        "staleness_snapshots=True) (repro_torch.api.build does this for you)")
                snap_leaves = [t.view(G, -1) for t in tu.tree_leaves(state.snap)]
                glob_leaves = [t.view(-1) for t in tu.tree_leaves(state.glob)]
            for i, yi in enumerate(tu.tree_leaves(y)):
                aggregate_global_async(i, yi, (wsum, sup, den), obs_host, dm_host.reshape(-1),
                                       any_obs)
        else:
            for i, yi in enumerate(tu.tree_leaves(y)):
                aggregate_global(i, yi, rows)
        del gref

        # Bytes on the wire: every upload actually sent (screened uploads
        # spent their bytes; crashed, unsampled and timed-out ones none).
        if async_mode:
            n_up_c = (torch.sum(em_all[:, :, None] * cmask[None]) if cmask is not None
                      else torch.sum(em_all) * K)
        else:
            n_up_c = (E * torch.sum(cmask if cm_all is None else cm_all) if cmask is not None
                      else E * Gt * Kt)
        loss, z_sq, y_sq = torch.stack(losses), _sq_norm(z), _sq_norm(y)
        if mx is not None:
            # One all-reduce over the mesh for the loss numerators, the last
            # gradient's and z's squared norms; y's over ``group`` alone (it
            # is replicated over ``client``).
            red = mx.sum_(torch.cat([loss.reshape(-1), last_g.reshape(1), z_sq.reshape(1)]),
                          "client", "group")
            loss = red[:-2].reshape(loss.shape) / (n_active if cmask is not None else Gt * Kt)
            last_g, z_sq = red[-2], red[-1]
            y_sq = mx.sum_(y_sq.reshape(1), "group")[0]
        metrics = ShardedMetrics(
            loss=loss,
            grad_norm=last_g,
            z_norm=z_sq / (Gt * Kt),
            y_norm=y_sq / Gt,
            participation=(torch.sum(cmask if cm_all is None else cm_all) / (Gt * Kt)
                           if cmask is not None
                           else torch.ones((), dtype=torch.float32, device=dev)),
            screened=screened,
            comm_bytes=round_comm_bytes(x, comp, n_up_c, gup),
        )
        new = state._replace(params=x, z=z, y=y)
        if state.round is not None:
            new = new._replace(round=state.round + 1)
        if async_mode and f_timeout:
            # Realized downloads this window (rep already excludes timed-out
            # groups): the next window's freshness for the z restart.
            new = new._replace(dl=rep * float(any_obs))
        return new, metrics

    return round_fn


# --------------------------------------------------------------------- CLI


def main(argv=None):
    """The reference CLI (``python -m repro.launch.train``) on the port:
    the same flags, plus ``--device`` (the CUDA card by default). Returns
    the final state and the ``Horizon`` of the run."""
    import numpy as np

    from repro_torch.configs import get_arch
    from repro_torch.core.api import (
        ExperimentSpec,
        RoundSchedule,
        add_spec_args,
        build,
        fit,
        spec_from_args,
    )
    from repro_torch.core.tree import tree_leaves
    from repro_torch.data.lm import make_lm_tokens
    from repro_torch.models.transformer import build_model

    defaults = ExperimentSpec(
        backend="sharded", lr=0.05, state_layout="tree",
        schedule=RoundSchedule(group_rounds=2, local_steps=2, microbatches=1))
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    add_spec_args(ap, defaults=defaults, exclude=("backend",))
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (2 layers, d<=512), small enough for the CPU")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--chunk", type=int, default=1,
                    help="global rounds per host transfer of the metrics "
                         "(core/driver.py run_rounds); 0 = once at the end")
    ap.add_argument("--shards", type=int, default=8,
                    help="packed batch blocks per client uploaded once")
    ap.add_argument("--device", default=None,
                    help="where to train: the CUDA card unless 'cpu' is given")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    bundle = build_model(cfg)
    rng = np.random.default_rng(args.seed)
    toks, _ = make_lm_tokens(rng, cfg.vocab_size, 200_000)
    device = resolve_device(args.device)
    params = bundle.init(args.seed, device=device)
    n_params = sum(t.numel() for t in tree_leaves(params))

    spec = spec_from_args(args, defaults=defaults, backend="sharded", microbatches=1)
    print(f"[train] arch={cfg.name} params={n_params / 1e6:.1f}M algo={spec.algorithm} "
          f"device={device}")
    engine = build(spec, bundle.loss, device=device)
    data = engine.pack_tokens(toks, batch_size=args.batch, seq_len=args.seq,
                              shards=args.shards, rng=rng,
                              generator=torch.Generator().manual_seed(args.seed + 1))
    if spec.population is not None:
        G, K = spec.levels
        if spec.client_state == "stateful":
            # Segment-table arithmetic: the host store holds [G, P]
            # correction rows, the device only [G, K].
            per_client = make_packer(params).state_bytes()
            nfields = len(engine.population_fields)
            print(f"[train] population={spec.population}/group cohort={K} "
                  f"store={G * spec.population * per_client * nfields / 1e6:.1f}MB host, "
                  f"device corrections {G * K * per_client * nfields / 1e6:.1f}MB")
        else:
            print(f"[train] population={spec.population}/group cohort={K} stateless (no store)")
    rng_state = (None if spec.full_participation
                 else torch.Generator(device=device).manual_seed(args.seed + 2))
    state, hz = fit(engine, data, args.rounds, params=params, rng=rng_state, chunk=args.chunk)
    for t in range(args.rounds):
        print(f"round {t}: loss {float(hz.metrics.loss[t].mean()):.4f} "
              f"z^2 {float(hz.metrics.z_norm[t]):.3e} "
              f"y^2 {float(hz.metrics.y_norm[t]):.3e}")
    return state, hz


if __name__ == "__main__":
    main()
