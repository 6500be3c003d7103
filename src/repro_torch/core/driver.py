"""The training horizon: packed client shards, per-round batch selection on
the device, and ``run_rounds`` (port of ``src/repro/core/driver.py``).

* **Packed dataset** (:class:`PackedBatches`): for every client, ``shards``
  pre-formed blocks of ``H`` step-batches (``H * A`` with ``A``
  microbatches, the sharded backend's layout) are sampled once on the host
  and uploaded once -- tensors ``[G, K, S, steps, B, ...]``. Each round
  then picks one block per (group round, client) and gathers its batches
  on the device (:func:`select_round`); the host never packs batches
  again. :func:`pack_client_shards` packs an array dataset,
  :func:`pack_lm_shards` a token stream.
* **Shard ids.** The reference draws them with ``jax.random.randint``,
  whose bits PyTorch cannot reproduce. Here :func:`select_round` takes the
  ids as a tensor, and :func:`run_rounds` draws them from the dataset's
  ``torch.Generator`` unless the caller passes them (the parity tests pass
  the reference's ids).
* **Horizon** (:func:`run_rounds`): ``T`` rounds in a Python loop. Metrics
  come back to the host once per ``chunk`` rounds; the eval function runs
  at multiples of ``eval_every`` and at the final round.
  :func:`make_round_step` is one round of it (selection + round), the
  host-loop building block.
* **Guarded horizon** (``run_rounds(..., guard=GuardSpec())``): each chunk
  is snapshotted to host memory before it runs, checked for divergence
  after, and rolled back and retried on divergence. The reference folds
  the retry into its JAX keys; here a retry reseeds the state's and the
  data's generators from (their snapshot, salt), so it draws another
  realization, deterministically.
"""
from __future__ import annotations

import hashlib
import math
import time
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch.core.device import clone_generator
from repro_torch.core.faults import all_finite

Tree = Any


class PackedBatches:
    """A once-uploaded, device-resident training dataset for the driver.

    arrays: dict of tensors ``[G, K, S, steps, B, ...]`` -- ``S``
        pre-sampled blocks per client, each holding ``steps = H * (A or 1)``
        step-batches. Deeper topologies (the multilevel backend) carry all
        their client axes up front: ``[*dims, S, steps, ...]`` with
        ``topo_ndim = len(dims)``.
    generator: the ``torch.Generator`` that draws the shard ids; it
        advances in place, so passing the same object to a later
        ``run_rounds`` continues the stream.
    group_rounds / local_steps: the static layout (E, H) of one round.
    microbatches: A, the sharded backend's gradient-accumulation chunks per
        local step, or None (the simulator's layout, no A axis).
    topo_ndim: how many leading axes index the client topology (2 for the
        two-level engines, M for an M-level tree).
    """

    __slots__ = ("arrays", "generator", "group_rounds", "local_steps", "microbatches",
                 "topo_ndim")

    def __init__(self, arrays: dict, generator: torch.Generator,
                 group_rounds: int, local_steps: int, microbatches: int | None = None,
                 topo_ndim: int = 2):
        self.arrays = arrays
        self.generator = generator
        self.group_rounds = int(group_rounds)
        self.local_steps = int(local_steps)
        self.microbatches = None if microbatches is None else int(microbatches)
        self.topo_ndim = int(topo_ndim)

    @property
    def _first(self) -> torch.Tensor:
        return next(iter(self.arrays.values()))

    @property
    def topology(self) -> tuple[int, ...]:
        return tuple(self._first.shape[:self.topo_ndim])

    @property
    def num_shards(self) -> int:
        return self._first.shape[self.topo_ndim]

    def __repr__(self) -> str:
        shapes = [tuple(x.shape) for x in self.arrays.values()]
        return (f"PackedBatches(E={self.group_rounds}, H={self.local_steps}, "
                f"A={self.microbatches}, leaves={shapes})")


def draw_shard_ids(data: PackedBatches) -> torch.Tensor:
    """One shard index per (group round, client): int64 ``[E, *dims]``
    (``[E, G, K]`` on the two-level engines), drawn from ``data.generator``."""
    return torch.randint(0, data.num_shards, (data.group_rounds,) + data.topology,
                         generator=data.generator, device=data.generator.device)


def select_round(data: PackedBatches, sid) -> dict:
    """Gather one global round of batches from the packed shards, on the
    device. ``sid``: ``[E, *dims]`` shard indices. Returns tensors
    ``[E, H, *dims, B, ...]``, or ``[E, H, A, *dims, B, ...]`` when the data
    carries ``A`` microbatches (``dims`` is ``(G, K)`` on the two-level
    engines)."""
    E, H, A = data.group_rounds, data.local_steps, data.microbatches
    dims = data.topology
    P = math.prod(dims)
    device = data._first.device
    sid = torch.as_tensor(sid).to(device=device, dtype=torch.int64)
    if tuple(sid.shape) != (E,) + dims:
        raise ValueError(f"shard ids must be [E, *dims] = {(E,) + dims}, "
                         f"got {tuple(sid.shape)}")
    rows = torch.arange(P, device=device)[None, :]
    sid = sid.reshape(E, P)

    def gather(leaf):
        sel = leaf.reshape((P,) + tuple(leaf.shape[len(dims):]))[rows, sid]  # [E, P, steps, ...]
        sel = sel.movedim(2, 1)                                              # [E, steps, P, ...]
        sel = sel.reshape(tuple(sel.shape[:2]) + dims + tuple(sel.shape[3:]))
        if A is None:
            return sel
        return sel.reshape((E, H, A) + tuple(sel.shape[2:]))

    return {name: gather(leaf) for name, leaf in data.arrays.items()}


def pack_client_shards(
    data_arrays: dict[str, np.ndarray],
    indices: list,
    *,
    group_rounds: int,
    local_steps: int,
    batch_size: int,
    shards: int = 16,
    microbatches: int | None = None,
    rng: np.random.Generator,
    generator: torch.Generator | None = None,
    device=None,
) -> PackedBatches:
    """Pack a partitioned array dataset (``data.partition``) for the driver.

    ``indices`` nests the per-client index pools: ``[G][K]`` for the
    two-level engines, ``[N_1][N_2]...[N_M]`` for an M-level tree (the
    nesting depth becomes ``topo_ndim``). For every client, in row-major
    order, pre-samples ``shards`` blocks of ``steps x batch_size`` examples
    (``steps = local_steps * (microbatches or 1)``) with replacement from
    its pool with numpy's ``rng.choice`` -- draw for draw as the reference
    packs -- and uploads the gathered features once as ``[*dims, S, steps,
    B, ...]`` tensors on ``device``. ``generator`` (default: a CPU generator
    seeded with 0) draws the per-round shard ids.
    """
    steps = local_steps * (microbatches or 1)

    def draw(node):
        if isinstance(node, (list, tuple)):
            return np.stack([draw(child) for child in node])
        return rng.choice(node, size=(shards, steps, batch_size), replace=True)

    sel = draw(indices)                                            # [*dims, S, steps, B]
    arrays = {name: torch.from_numpy(np.ascontiguousarray(arr[sel])).to(device)
              for name, arr in data_arrays.items()}
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    return PackedBatches(arrays, generator, group_rounds, local_steps, microbatches,
                         topo_ndim=sel.ndim - 3)


def pack_lm_shards(
    tokens: np.ndarray | list,
    *,
    num_groups: int,
    clients_per_group: int,
    group_rounds: int,
    local_steps: int,
    batch_size: int,
    seq_len: int,
    shards: int = 8,
    microbatches: int | None = None,
    rng: np.random.Generator,
    generator: torch.Generator | None = None,
    device=None,
) -> PackedBatches:
    """Pack a token stream (``data.lm``) for the driver (port of the
    reference's ``pack_lm_shards``, draw for draw).

    Samples random ``seq_len`` windows (next-token targets shifted by one,
    as ``lm_batches`` does) into ``{"tokens", "targets"}`` int32 blocks of
    shape ``[G, K, S, steps, B, seq_len]``, uploaded once. ``tokens`` is one
    shared stream (every client samples from it) or a ``[G][K]`` nesting of
    per-client streams (each client samples from its own).
    """
    G, K = num_groups, clients_per_group
    steps = local_steps * (microbatches or 1)

    def windows(stream, size):
        stream = np.asarray(stream)
        starts = rng.integers(0, len(stream) - seq_len - 1, size=size)
        win = starts[..., None] + np.arange(seq_len)
        return stream[win].astype(np.int32), stream[win + 1].astype(np.int32)

    if isinstance(tokens, np.ndarray):
        toks, targs = windows(tokens, (G, K, shards, steps, batch_size))
    else:
        per_client = [[windows(tokens[g][k], (shards, steps, batch_size))
                       for k in range(K)] for g in range(G)]
        toks = np.stack([[per_client[g][k][0] for k in range(K)] for g in range(G)])
        targs = np.stack([[per_client[g][k][1] for k in range(K)] for g in range(G)])
    arrays = {"tokens": torch.from_numpy(toks).to(device),
              "targets": torch.from_numpy(targs).to(device)}
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    return PackedBatches(arrays, generator, group_rounds, local_steps, microbatches)


class Horizon(NamedTuple):
    """Stacked results of a multi-round driver run.

    metrics: the round function's metrics as numpy arrays, ``[T, ...]``.
    evals: ``eval_fn`` outputs at the evaluated rounds as numpy arrays,
        ``[len(eval_rounds), ...]``, or None when no ``eval_fn`` was given.
    eval_rounds: 1-based global round indices that were evaluated
        (multiples of ``eval_every`` plus the final round).
    data: the :class:`PackedBatches` (its generator advanced past this
        horizon) to continue training from.
    population: the ``core.population.PopulationStore`` of a virtual
        population run (updated in place), else None.
    guard: a :class:`GuardReport` when the run was guarded, else None.
    """

    metrics: Any
    evals: Any | None
    eval_rounds: np.ndarray
    data: Any | None = None
    population: Any | None = None
    guard: Any | None = None


class GuardSpec(NamedTuple):
    """Self-healing horizon policy for ``run_rounds(..., guard=...)`` (the
    reference's fields).

    Before each chunk the driver copies the state (and the generators'
    states) to host memory; after the chunk it checks for divergence and,
    on divergence, restores the snapshot and retries the chunk with
    reseeded generators, up to ``max_retries`` times, then raises
    ``RuntimeError``. Divergence is:

    * a non-finite value in the chunk's ``metrics.loss``, or
    * (``check_state``) a non-finite value in the state's ``z``/``y``/
      ``dyn`` fields (every leaf when it has none of them). ``params`` is
      not checked: under faults a frozen replica may carry non-finite bits
      until its next download heals it, without entering an aggregate; or
    * the chunk's final-round mean loss above ``loss_spike`` times the last
      accepted chunk's (the first chunk has no reference).

    ``round_fn_for_retry(attempt)`` (attempt >= 1) gives the round function
    of a retry (``repro_torch.api.fit`` wires the engine's
    ``retry_round_fn`` here); None retries the original.
    """

    max_retries: int = 2
    loss_spike: float = 10.0
    check_state: bool = True
    round_fn_for_retry: Callable[[int], Callable] | None = None


class GuardReport(NamedTuple):
    """What the guarded horizon did: chunks rolled back at least once, retry
    attempts in all, and the cost of its snapshots -- seconds spent copying
    the state to the host (every chunk's copy), bytes a snapshot holds, and
    seconds spent allocating its host buffers (once a run; page-locked
    memory for a card's state, which PyTorch caches for later runs)."""

    rollbacks: int
    retries: int
    snapshot_s: float = 0.0
    snapshot_bytes: int = 0
    alloc_s: float = 0.0


_GUARD_FIELDS = ("z", "y", "dyn", "glob")


def _tensor_leaves(tree) -> list:
    """The tensors of a tree, a list of trees or a tuple of trees (a
    multilevel state's ``nus``), in leaf order."""
    from repro_torch.core.tree import tree_leaves

    if isinstance(tree, (list, tuple)):
        return [t for sub in tree for t in _tensor_leaves(sub)]
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _state_tensors(state) -> list:
    """Every tensor of a round state, field by field (generators aside)."""
    fields = state if isinstance(state, tuple) else (state,)
    out = []
    for f in fields:
        if f is not None and not isinstance(f, torch.Generator):
            out += _tensor_leaves(f)
    return out


def _guard_leaves(state) -> list:
    """The leaves the guard's state check covers (see GuardSpec)."""
    picked = [getattr(state, f) for f in _GUARD_FIELDS if getattr(state, f, None) is not None]
    return _tensor_leaves(picked) if picked else _state_tensors(state)


def _finite_chunk(state, losses: np.ndarray, check_state: bool) -> bool:
    if not np.isfinite(losses).all():
        return False
    if check_state:
        flags = [all_finite(t) for t in _guard_leaves(state) if t.is_floating_point()]
        if flags and not bool(torch.stack([f.cpu() for f in flags]).all()):
            return False
    return True


def _reseed(gen: torch.Generator, snap: torch.Tensor, salt: int) -> None:
    """Seed ``gen`` from a snapshot of a generator's state and ``salt``."""
    h = hashlib.blake2b(snap.numpy().tobytes() + salt.to_bytes(8, "little"), digest_size=8)
    gen.manual_seed(int.from_bytes(h.digest(), "little") >> 1)


class _HostSnapshot:
    """The guard's copy of a state in host memory, in buffers kept from one
    chunk to the next (page-locked for a card's tensors): every tensor of
    every field, an async state's window counter, ``snap``, ``glob`` and
    ``dl`` among them, so a restore gives the snapshot's bits back."""

    def __init__(self):
        self.bufs, self.seconds, self.nbytes, self.alloc_s = None, 0.0, 0, 0.0

    def take(self, state, data: PackedBatches) -> None:
        ts = _state_tensors(state)
        if self.bufs is None or [(b.shape, b.dtype) for b in self.bufs] != [
                (t.shape, t.dtype) for t in ts]:
            t0 = time.perf_counter()
            self.bufs = [torch.empty(t.shape, dtype=t.dtype, pin_memory=t.is_cuda) for t in ts]
            self.alloc_s += time.perf_counter() - t0
            self.nbytes = sum(b.numel() * b.element_size() for b in self.bufs)
        t0 = time.perf_counter()
        for b, t in zip(self.bufs, ts):
            b.copy_(t, non_blocking=t.is_cuda)
        if any(t.is_cuda for t in ts):
            torch.cuda.synchronize()
        self.seconds += time.perf_counter() - t0
        rng = getattr(state, "rng", None)
        self.rng = rng.get_state() if isinstance(rng, torch.Generator) else None
        self.data_rng = data.generator.get_state()

    def restore(self, state, data: PackedBatches, salt: int):
        """Copy the snapshot into ``state``'s tensors (the same structure as
        the snapshotted state's: the state a diverged chunk returned) and
        reseed the state's and the data's generators from their snapshots
        and ``salt``. Returns ``state``."""
        ts = _state_tensors(state)
        if [(t.shape, t.dtype) for t in ts] != [(b.shape, b.dtype) for b in self.bufs]:
            raise ValueError("the state a chunk returned does not match its snapshot")
        for t, b in zip(ts, self.bufs):
            t.copy_(b)
        if self.rng is not None:
            _reseed(state.rng, self.rng, salt)
        _reseed(data.generator, self.data_rng, salt)
        return state


def eval_mask_for_chunk(done: int, n: int, T: int, eval_every: int) -> np.ndarray:
    """Per-round eval booleans for rounds ``done+1 .. done+n`` of ``T``:
    True at multiples of ``eval_every`` plus the final round."""
    return np.array([(done + i + 1) % eval_every == 0 or done + i + 1 == T
                     for i in range(n)])


def _pre_round(state):
    """``state`` with a copy of its generator (a round advances the
    generator in place), so that an eval reads ``prev.rng`` as it stood
    before the round, e.g. to re-derive the round's participation masks."""
    rng = getattr(state, "rng", None)
    return state._replace(rng=clone_generator(rng)) if isinstance(rng, torch.Generator) else state


def _undonated(state):
    """A state a round may consume while ``state`` stays usable: its
    generator copied, and, for the sharded backend, which writes its state
    in place, every tensor copied too."""
    from repro_torch.core.tree import tree_map
    from repro_torch.launch.train import ShardedHFLState

    if isinstance(state, ShardedHFLState):
        def copy(f):
            if f is None:
                return None
            if isinstance(f, torch.Generator):
                return clone_generator(f)
            return tree_map(torch.clone, f)

        return type(state)(*(copy(f) for f in state))
    return _pre_round(state)


def make_round_step(round_fn: Callable, *, donate: bool = True):
    """One global round of the driver as a host-loop step (the reference's
    ``make_round_step``; what :func:`run_rounds` runs for each round).

    Returns ``step(state, data, shard_ids=None) -> (state, data,
    metrics)``: one shard selection (``shard_ids`` ``[E, *dims]``, else
    drawn from ``data.generator``, which advances in place as in
    ``run_rounds``) and one ``round_fn`` call. With ``donate`` (the
    default) the round may consume the state passed in, so the caller must
    not reuse it (the sharded backend writes it in place, and the state's
    generator advances). With ``donate=False`` the state passed in stays
    usable and unchanged: the step hands the round a copy of its generator
    (and, on the sharded backend, of its tensors), so a second step from it
    on the same shard ids repeats the first, bit for bit.
    """

    def step(state, data: PackedBatches, shard_ids=None):
        sid = draw_shard_ids(data) if shard_ids is None else shard_ids
        batches = select_round(data, sid)
        state, metrics = round_fn(state if donate else _undonated(state), batches)
        return state, data, metrics

    return step


def dispatch_chunk(round_fn: Callable, state: Tree, data: PackedBatches, mask: np.ndarray, *,
                   done: int = 0, eval_fn: Callable | None = None, shard_ids=None,
                   draws=None) -> tuple[Tree, list, list]:
    """Queue rounds ``done+1 .. done+len(mask)`` (batch selection +
    ``round_fn``) without a host synchronization of its own (the
    reference's ``dispatch_chunk``), so the host may work (a population
    store's gather) while the card runs them; once the card's launch queue
    is full, queuing itself waits for the card. ``shard_ids`` (``[T, E, *dims]``) and
    ``draws`` (T entries) are indexed by the global round ``done + i``;
    ``eval_fn(prev, state)`` runs where ``mask`` is True, ``prev`` the
    state the round started from with its generator as it stood then (a
    copy; a sharded state's tensors are the round's own, written in
    place). Returns ``(state, metrics, evals)``: per-round results still
    on the device, for :func:`_to_host`."""
    mets, evs = [], []
    for i in range(len(mask)):
        sid = shard_ids[done + i] if shard_ids is not None else draw_shard_ids(data)
        d = draws[done + i] if draws is not None else None
        prev = _pre_round(state) if eval_fn is not None and mask[i] else state
        batches = select_round(data, sid)
        state, metrics = (round_fn(state, batches) if d is None
                          else round_fn(state, batches, draws=d))
        mets.append(metrics)
        if eval_fn is not None and mask[i]:
            evs.append(eval_fn(prev, state))
    return state, mets, evs


def _to_host(items: list):
    """Stack a list of same-structured results (NamedTuple / dict / tensor)
    along a new leading axis, as numpy arrays (waits for the device)."""
    first = items[0]
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*(_to_host([it[i] for it in items])
                             for i in range(len(first))))
    if isinstance(first, dict):
        return {k: _to_host([it[k] for it in items]) for k in first}
    return torch.stack([torch.as_tensor(it) for it in items]).cpu().numpy()


def _concat(parts: list):
    first = parts[0]
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*(_concat([p[i] for p in parts]) for i in range(len(first))))
    if isinstance(first, dict):
        return {k: _concat([p[k] for p in parts]) for k in first}
    return np.concatenate(parts)


def run_rounds(
    round_fn: Callable,
    state: Tree,
    data: PackedBatches,
    T: int,
    *,
    chunk: int | None = None,
    eval_every: int = 1,
    eval_fn: Callable[[Tree, Tree], Tree] | None = None,
    shard_ids=None,
    draws=None,
    guard: GuardSpec | None = None,
    on_chunk: Callable[[int, Tree, PackedBatches], None] | None = None,
) -> tuple[Tree, PackedBatches, Horizon]:
    """Run ``T`` global rounds of (batch selection + ``round_fn``).

    ``shard_ids`` (optional, ``[T, E, *dims]``) fixes every round's shard
    selection; otherwise each round draws ``[E, *dims]`` ids from
    ``data.generator``. ``draws`` (optional, T entries, each a
    ``RoundDraws`` or None) fixes rounds' random draws
    (``round_fn(state, batches, draws=...)``); a retry replays them as
    given. ``eval_fn(prev_state, state)`` runs after rounds ``eval_every,
    2 * eval_every, ..., T``. Metrics (and evals) are copied to the host
    once per ``chunk`` rounds (``None`` or 0: once at the end), so the
    device runs a chunk without a host synchronization.

    With ``guard`` (a :class:`GuardSpec`) each chunk is snapshotted,
    checked and, on divergence, rolled back and retried (see GuardSpec);
    the Horizon then carries a :class:`GuardReport`. A retry reseeds the
    generators from their snapshots and the salt ``done * (max_retries +
    1) + attempt`` (``done``: rounds before the chunk), as the reference
    folds that salt into its keys. ``on_chunk(done, state, data)`` runs
    after every accepted chunk (``api.fit`` autosaves checkpoints there).

    Returns ``(state, data, Horizon)``.
    """
    if T < 1 or eval_every < 1:
        raise ValueError(f"need T >= 1 and eval_every >= 1, got T={T}, "
                         f"eval_every={eval_every}")
    if chunk is not None and chunk < 0:
        raise ValueError(f"chunk must be None or >= 0, got {chunk}")
    chunk = T if not chunk else min(int(chunk), T)
    if shard_ids is not None:
        shard_ids = torch.as_tensor(np.asarray(shard_ids))
        if shard_ids.shape[0] != T:
            raise ValueError(f"shard_ids has {shard_ids.shape[0]} rounds, T={T}")
    if draws is not None and len(draws) != T:
        raise ValueError(f"draws has {len(draws)} rounds, T={T}")

    def run_chunk(rf, state, done: int, mask: np.ndarray):
        state, chunk_mets, chunk_evs = dispatch_chunk(
            rf, state, data, mask, done=done, eval_fn=eval_fn, shard_ids=shard_ids, draws=draws)
        return state, _to_host(chunk_mets), _to_host(chunk_evs) if chunk_evs else None

    mets, evs, masks = [], [], []
    done, loss_ref, rollbacks, retries = 0, None, 0, 0
    snap = _HostSnapshot() if guard is not None else None
    while done < T:
        n = min(chunk, T - done)
        mask = eval_mask_for_chunk(done, n, T, eval_every)
        if guard is None:
            state, chunk_mets, chunk_evs = run_chunk(round_fn, state, done, mask)
        else:
            snap.take(state, data)
            attempt = 0
            while True:
                rf = round_fn
                if attempt > 0:
                    state = snap.restore(state, data, done * (guard.max_retries + 1) + attempt)
                    if guard.round_fn_for_retry is not None:
                        rf = guard.round_fn_for_retry(attempt)
                state, chunk_mets, chunk_evs = run_chunk(rf, state, done, mask)
                losses = getattr(chunk_mets, "loss", None)
                if losses is None:
                    raise ValueError("a guarded run_rounds needs a `loss` field in the round "
                                     "metrics to detect divergence")
                ok = _finite_chunk(state, losses, guard.check_state)
                final = float(np.mean(losses[-1])) if ok else np.inf
                if ok and loss_ref is not None and loss_ref > 0.0:
                    ok = final <= guard.loss_spike * loss_ref
                if ok:
                    loss_ref = final
                    rollbacks += int(attempt > 0)
                    retries += attempt
                    break
                if attempt >= guard.max_retries:
                    raise RuntimeError(
                        f"guarded horizon diverged at rounds {done + 1}..{done + n} and "
                        f"exhausted {guard.max_retries} retries (last final-round loss "
                        f"{final}, reference {loss_ref})")
                attempt += 1
        mets.append(chunk_mets)
        if chunk_evs is not None:
            evs.append(chunk_evs)
        masks.append(mask)
        done += n
        if on_chunk is not None:
            on_chunk(done, state, data)

    eval_rounds = np.nonzero(np.concatenate(masks))[0] + 1
    evals = _concat(evs) if eval_fn is not None else None
    report = (GuardReport(rollbacks, retries, snap.seconds, snap.nbytes, snap.alloc_s)
              if guard is not None else None)
    return state, data, Horizon(metrics=_concat(mets), evals=evals, eval_rounds=eval_rounds,
                                data=data, guard=report)
