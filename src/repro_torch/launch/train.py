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
  under either weighting, gated z/y updates.

The reference vmaps ``value_and_grad`` over ``[G, K]``; here the per-client
gradients are a Python loop over the replicas, each ``torch.autograd.grad``
of the loss at views of the stacked leaves, added into a ``[G, K]``
accumulator in the reference's order (``(0 + g_1) + g_2 ...``). That loop
composes with ``torch.utils.checkpoint`` in the model and holds one
replica's activations at a time. This is the single-card form of the
backend; the reference's mesh (``sharding/``, ``launch/mesh.py``) is a later
slice, as are compressed uploads, faults and defense, async schedules and
virtual populations on this backend (each raises ``ValueError`` naming its
slice).

Memory: the round updates the state's tensors IN PLACE and returns them in
the new state, as the reference's driver donates the state to each round:
the caller must not reuse the state it passed in. The aggregations, the z/y
updates and the norms run leaf by leaf, and replica by replica in chunks of
at most ``_CHUNK`` elements, so no float32 copy of a whole ``[G, K, ...]``
leaf (9.9 GB for glm4-9b's embedding at 2 x 2) is formed.

CLI (a reduced model on the CPU)::

    PYTHONPATH=src python -m repro_torch.launch.train --arch glm4-9b --smoke \\
        --rounds 2 --device cpu
"""
from __future__ import annotations

import argparse
import itertools
import math
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.core import tree as tu
from repro_torch.core.compression import round_comm_bytes
from repro_torch.core.device import resolve_device
from repro_torch.core.engine import (ASYNC_SLICE, FAULTS_SLICE, SHARDED_COMPRESSION_SLICE,
                                     RoundDraws)
from repro_torch.core.packer import is_flat, make_packer
from repro_torch.core.participation import ParticipationMasks, inclusion_prob, sample_hfl_masks
from repro_torch.kernels import ops as kops

Tree = Any

# Elements per piece of the float32 work on a leaf (256 MB of float32).
_CHUNK = 1 << 26


class ShardedHFLState(NamedTuple):
    """State carried between production rounds: the reference's sync
    fields (its async, fault and error-feedback fields come with those
    slices).

    params: [G, K, ...] per-client replicas (tree, or flat [G, K, N]).
    z:      [G, K, ...] client->group corrections (``correction_dtype``).
    y:      [G, ...]    group->global corrections.
    rng:    ``torch.Generator`` for the participation masks (None = full).
    """

    params: Tree
    z: Tree
    y: Tree
    rng: Any = None


class ShardedMetrics(NamedTuple):
    loss: torch.Tensor           # [E, H] mean loss per local step (active clients)
    grad_norm: torch.Tensor      # scalar ||g / A||^2 of the last step
    z_norm: torch.Tensor
    y_norm: torch.Tensor
    participation: torch.Tensor  # fraction of clients active this round
    screened: torch.Tensor       # count of screened contributions (0 here)
    comm_bytes: torch.Tensor     # modeled upload bytes on the wire this round


def _torch_dtype(dtype) -> torch.dtype | None:
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, str(dtype))


def sharded_init(params0: Tree, G: int, K: int, *, use_flat_state: bool = False,
                 correction_dtype=None, rng: torch.Generator | None = None,
                 device=None) -> ShardedHFLState:
    """Stacked per-client state on ``device`` (the CUDA card unless
    ``device="cpu"``). ``correction_dtype`` (a torch dtype or its name, e.g.
    ``"bfloat16"``) stores z and y narrower than the params; the flat layout
    packs params and corrections into one buffer per dtype, so it rejects
    it. ``rng`` draws the per-round participation masks (rounds at full
    participation ignore it)."""
    dev = resolve_device(device)
    cdt = _torch_dtype(correction_dtype)
    params0 = tu.tree_map(lambda t: torch.as_tensor(t).to(dev), params0)

    def stack(t, lead):
        return t.expand(lead + tuple(t.shape)).contiguous()

    if use_flat_state:
        if cdt is not None:
            raise ValueError("flat state packs params and corrections into one buffer per "
                             "dtype; correction_dtype needs the tree layout")
        packer = make_packer(params0)
        flat0 = packer.flatten(params0)
        return ShardedHFLState(params=tu.tree_map(lambda b: stack(b, (G, K)), flat0),
                               z=packer.zeros((G, K), dev), y=packer.zeros((G,), dev), rng=rng)
    return ShardedHFLState(
        params=tu.tree_map(lambda t: stack(t, (G, K)), params0),
        z=tu.tree_map(lambda t: torch.zeros((G, K) + tuple(t.shape), dtype=cdt or t.dtype,
                                            device=dev), params0),
        y=tu.tree_map(lambda t: torch.zeros((G,) + tuple(t.shape), dtype=cdt or t.dtype,
                                            device=dev), params0),
        rng=rng)


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


def _pieces(t: torch.Tensor, lead: int):
    """``t``'s ``lead``-axis slices, each cut into pieces of at most
    ``_CHUNK`` elements: yields (index tuple, slice of the slice's flat
    view)."""
    n = math.prod(t.shape[lead:])
    for idx in itertools.product(*(range(s) for s in t.shape[:lead])):
        for s in range(0, n, _CHUNK):
            yield idx, slice(s, min(s + _CHUNK, n))


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


def _correction_update(c: torch.Tensor, src: torch.Tensor, ref: torch.Tensor, denom: float,
                       active, lead: int) -> None:
    """c[j] <- (c[j] + (src[j] - ref[j]) / denom) in float32, stored in c's
    dtype, IN PLACE, for every replica j of c's ``lead`` leading axes with
    ``active[j]`` (None: all). ``ref`` is the aggregate the replicas are
    held against: ``[G, ...]`` read as ``ref[g]`` for z (lead 2), ``[...]``
    for y (lead 1)."""
    for idx, sl in _pieces(c, lead):
        if active is not None and not active[idx]:
            continue
        cv = c[idx].reshape(-1)[sl]
        r = (ref[idx[0]] if lead == 2 else ref).reshape(-1)[sl]
        # In place on one float32 temporary: a narrower operand is widened
        # exactly inside each op, so every rounding is the expression's
        # (c + (src - ref) / denom), and the last copy rounds into c's dtype.
        d = src[idx].reshape(-1)[sl].to(torch.float32, copy=True)
        d.sub_(r).div_(denom).add_(cv)
        cv.copy_(d)


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
) -> Callable[..., tuple[ShardedHFLState, ShardedMetrics]]:
    """The production-round builder behind ``repro_torch.api``'s sharded
    engine (the reference's signature). Returns ``round_fn(state, batches,
    draws=None)``; batches have leaves ``[E, H, A, G, K, ...]``, and
    ``draws=RoundDraws(masks=...)`` fixes a partial-participation round's
    masks. ``fused_mode`` takes None or "auto" (the kernel on a CUDA tensor,
    its plain version on a CPU tensor); the reference's "pallas" and
    "interpret" have no counterpart here. ``plan``, ``faults``, ``defense``
    and an enabled ``compression`` raise, naming their slice."""
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
    for value, what, where in ((plan, "an async staleness plan", ASYNC_SLICE),
                               (faults, "fault injection", FAULTS_SLICE),
                               (defense, "screened aggregation", FAULTS_SLICE)):
        if value is not None and getattr(value, "enabled", True):
            raise ValueError(f"{what} on the sharded backend needs {where}")
    if compression is not None and compression.enabled:
        raise ValueError(f"compressed uploads on the sharded backend need "
                         f"{SHARDED_COMPRESSION_SLICE}")
    partial = client_participation < 1.0 or group_participation < 1.0
    ht = partial and participation_weighting == "inverse_prob"

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
        return lsum, 1.0 / A

    @torch.no_grad()
    def round_fn(state: ShardedHFLState, batches: Tree,
                 draws: RoundDraws | None = None) -> tuple[ShardedHFLState, ShardedMetrics]:
        x, z, y = state.params, state.z, state.y
        flat = is_flat(x)
        packer = x.packer if flat else None
        G, K = tu.tree_leaves(x)[0].shape[:2]
        dev = tu.tree_leaves(x)[0].device

        if partial:
            if draws is not None and draws.masks is not None:
                masks = ParticipationMasks(
                    *(torch.as_tensor(m).to(dev, torch.float32) for m in draws.masks))
            else:
                if state.rng is None:
                    raise ValueError(
                        "partial participation draws per-round masks from the state: build "
                        "it with sharded_init(..., rng=torch.Generator(...))")
                masks = sample_hfl_masks(state.rng, G, K, client_participation,
                                         group_participation, participation_mode)
            cmask, gmask = masks.client, masks.group
            cdenom = inclusion_prob(client_participation, K, participation_mode) * K if ht else None
            gdenom = inclusion_prob(group_participation, G, participation_mode) * G if ht else None
            n_active = torch.clamp(torch.sum(cmask), min=1.0)
            active = cmask.cpu().numpy() != 0          # host copy: which replicas to touch
        else:
            cmask = cdenom = gdenom = n_active = active = None

        def step_loss_mean(lsum, inv_a):
            lpc = lsum * inv_a
            if cmask is not None:
                return torch.sum(torch.where(cmask != 0, lpc, 0)) / n_active
            return torch.mean(lpc)

        def select_(dst: torch.Tensor, new: torch.Tensor) -> None:
            """dst <- new on the active replicas (all at full participation)."""
            if cmask is None:
                dst.copy_(new)
            else:
                dst.copy_(torch.where(tu.expand_mask(cmask, new) != 0, new, dst))

        if use_corr:
            # Alg. 1 line 3 (footnote 2's zero init): z restarts every global
            # round, for participants only; only y persists across rounds.
            for zl in tu.tree_leaves(z):
                if cmask is None:
                    zl.zero_()
                else:
                    zl.masked_fill_(tu.expand_mask(cmask, zl) != 0, 0)

        # The [G, K] gradient accumulator (the reference's scan carry).
        acc = tu.tree_zeros_like(x)
        x_tree = packer.unflatten(x) if flat else x
        acc_tree = packer.unflatten(acc) if flat else acc

        losses, last_g = [], None
        for e in range(E):
            loss_e = []
            # Flat, unfused: z + y folded into one correction for the phase.
            corr_t = None
            if flat and use_corr and not use_fused_update:
                corr_t = packer.unflatten(tu.tree_map(lambda zb, yb: zb + yb[:, None], z, y))
            for h in range(H):
                batch_h = tu.tree_map(lambda b: b[e, h], batches)
                lsum, inv_a = client_grads(x_tree, acc_tree, batch_h, G, K)
                if use_fused_update:
                    # g / A + z + y and the step in one kernel launch per leaf
                    # (tree) or per dtype buffer (flat); y stays [G, ...] and
                    # the mask gates frozen replicas inside the kernel.
                    pairs = (zip(tu.tree_leaves(x), tu.tree_leaves(acc), tu.tree_leaves(z),
                                 tu.tree_leaves(y)))
                    for xi, gi, zi, yi in pairs:
                        xg = xi.view(G, K, -1)
                        kops.mtgc_update_flat(xg, gi.view(G, K, -1), zi.view(G, K, -1),
                                              yi.view(G, -1), cmask, lr=lr, g_scale=inv_a,
                                              out=xg)
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
                loss_e.append(step_loss_mean(lsum, inv_a))
                if e == E - 1 and h == H - 1:
                    gsq = (_sq_norm(acc) if cmask is None else
                           _sq_norm(tu.tree_map(lambda t: torch.where(
                               tu.expand_mask(cmask, t) != 0, t, 0), acc)))
                    last_g = gsq * inv_a * inv_a
            losses.append(torch.stack(loss_e))

            # Group aggregation (line 8), z update (line 9) and dissemination,
            # leaf by leaf: xbar_j = mean over (active) clients.
            for xi, zi in zip(tu.tree_leaves(x), tu.tree_leaves(z)):
                xbar = (tu.tree_masked_mean(xi, cmask, axis=1, denom=cdenom)
                        if cmask is not None else _mean(xi, 1))
                if use_corr:
                    # z_i += (x_{i,H} - xbar_j) / (H * lr), in float32.
                    _correction_update(zi, xi, xbar, H * lr, active, lead=2)
                select_(xi, xbar[:, None].expand(xi.shape))
                del xbar
        del acc, acc_tree, corr_t

        # Global aggregation (line 10), y update (line 11), dissemination.
        gact = None
        for xi, yi in zip(tu.tree_leaves(x), tu.tree_leaves(y)):
            if partial:
                xbar_j, xbar, gact = tu.tree_group_global_mean(
                    xi, cmask, gmask if ht else None, gdenom)
            else:
                xbar_j = xi[:, 0]                        # clients equal
                xbar = _mean(xbar_j, 0)
            if use_corr:
                # y_j += (xbar_j - xbar) / (H * E * lr), in float32; only
                # groups with an active client.
                gmask_host = None if gact is None else gact.cpu().numpy() != 0
                _correction_update(yi, xbar_j, xbar, H * E * lr, gmask_host, lead=1)
            select_(xi, xbar.expand(xi.shape))
            del xbar_j, xbar

        n_up_c = E * torch.sum(cmask) if partial else E * G * K
        gup = torch.sum(gact) if partial else G
        metrics = ShardedMetrics(
            loss=torch.stack(losses),
            grad_norm=last_g,
            z_norm=_sq_norm(z) / (G * K),
            y_norm=_sq_norm(y) / G,
            participation=(torch.sum(cmask) / (G * K) if partial
                           else torch.ones((), dtype=torch.float32, device=dev)),
            screened=torch.zeros((), dtype=torch.float32, device=dev),
            comm_bytes=round_comm_bytes(x, None, n_up_c, gup),
        )
        return state._replace(params=x, z=z, y=y), metrics

    return round_fn


# --------------------------------------------------------------------- CLI


def main(argv=None) -> None:
    """The reference CLI (``python -m repro.launch.train``) on the port:
    the same flags, plus ``--device`` (the CUDA card by default)."""
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
    rng_state = (None if spec.full_participation
                 else torch.Generator(device=device).manual_seed(args.seed + 2))
    state, hz = fit(engine, data, args.rounds, params=params, rng=rng_state, chunk=args.chunk)
    for t in range(args.rounds):
        print(f"round {t}: loss {float(hz.metrics.loss[t].mean()):.4f} "
              f"z^2 {float(hz.metrics.z_norm[t]):.3e} "
              f"y^2 {float(hz.metrics.y_norm[t]):.3e}")


if __name__ == "__main__":
    main()
