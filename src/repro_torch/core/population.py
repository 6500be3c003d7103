"""Virtual client populations: cohort-shaped device state for many clients
(port of ``src/repro/core/population.py``, name for name).

The engines hold per-client state as ``[G, K, ...]`` tensors, so K is the
cohort that is materialized on the device. A population of ``P`` virtual
clients a group lives in a host store that holds only what persists per
client: the correction ``z`` (and FedDyn's ``dyn``). Params need no store:
every participant downloads the global model at dissemination.

The store reuses the :class:`~repro_torch.core.packer.Packer` segment
table: per persistent field, one numpy buffer per dtype key with leading
axes ``[G, P]``, laid out as the reference lays its store out (a bfloat16
buffer holds its bits as ``uint16``: numpy has no bfloat16). Each driver
chunk runs

    gather -> chunk -> scatter

the sampled cohort's rows are gathered into a page-locked staging buffer
and copied into the state's own tensors in place (``install``), the
chunk's rounds are queued on the card, and the updated rows come back
(``extract``, the one synchronization of a chunk) and are scattered into
the store. With ``overlap=True`` the host draws and gathers the next
cohort after queuing the chunk, while the card runs it, then patches the
rows both cohorts share from the freshly scattered store (``refresh``).
A chunk whose launches fill the card's launch queue holds the host until
its last launches are queued, which leaves the gather little to hide
behind.

Cohort draws come from a CPU ``torch.Generator`` the store owns (seeded
like the reference's ``PRNGKey(0)`` default with 0 unless given): a draw
never waits for the card. JAX's draws cannot be replayed, so the parity
tests inject the reference's cohorts (``run_population_rounds(cohorts=)``).
With ``population == cohort`` nothing is drawn and the generators are
untouched: the cohort path is then bit for bit the materialized one.

Stateless clients (``client_state="stateless"``) have no store:
:func:`stateless_round` zeroes the persistent fields before every round.
"""
from __future__ import annotations

import math
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core import tree as tu
from repro_torch.core.driver import (
    Horizon,
    PackedBatches,
    _concat,
    _to_host,
    dispatch_chunk,
    eval_mask_for_chunk,
)
from repro_torch.core.packer import FlatBuffers, Packer, is_flat, key_dtype, make_packer, tree_paths

Tree = Any
HostBuffers = dict[str, dict[str, np.ndarray]]   # field -> dtype key -> [G, P or K, N]

#: Host steps whose wall seconds a store accumulates (``PopulationStore.seconds``).
STEPS = ("gather", "install", "extract", "scatter", "refresh")


def numpy_dtype(key: str) -> np.dtype:
    """The store's numpy dtype for a buffer's dtype key: bfloat16 is held as
    its 16-bit pattern (``uint16``)."""
    return np.dtype(np.uint16) if key == "bfloat16" else np.dtype(key)


def host_array(t: torch.Tensor) -> np.ndarray:
    """A CPU tensor as a numpy array sharing its memory (bfloat16 as uint16 bits)."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def host_tensor(a: np.ndarray, key: str) -> torch.Tensor:
    """Inverse of :func:`host_array`: a tensor sharing ``a``'s memory, of the
    dtype that ``key`` names."""
    if key == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def population_fields(algorithm: str) -> tuple[str, ...]:
    """Which state fields persist per client: ``z`` for every algorithm, and
    FedDyn's gradient memory ``dyn`` (fields a state type lacks, such as the
    sharded state's ``dyn``, are dropped when the store is built)."""
    return ("z", "dyn") if algorithm == "feddyn" else ("z",)


def draw_cohort(generator: torch.Generator, num_groups: int, population: int,
                cohort: int) -> np.ndarray:
    """One cohort: ``[G, cohort]`` distinct client ids (int64) per group, a
    ``randperm`` per group from ``generator`` (a CPU generator, so the draw
    never waits for the card)."""
    return np.stack([torch.randperm(population, generator=generator)[:cohort].numpy()
                     for _ in range(num_groups)])


def _lead(value) -> tuple[int, ...]:
    if is_flat(value):
        return value.lead_shape
    return tuple(tu.tree_leaves(value)[0].shape[:2])


def _device(value) -> torch.device:
    return tu.tree_leaves(value)[0].device


class CohortBuffers:
    """Host buffers for one cohort's rows of every persistent field
    (``[G, K, N]`` per dtype key), page-locked when the state lives on a
    card, and the CUDA event after the last copy that reads them.

    ``arrays`` are numpy views of ``tensors``; ``wait()`` blocks until no
    queued copy still reads the buffers, so the host may overwrite them.
    """

    def __init__(self, store: "PopulationStore", cohort: int, pin: bool):
        self.tensors = {
            f: {key: torch.empty((store.num_groups, cohort, n), dtype=key_dtype(key),
                                 pin_memory=pin)
                for key, n in store.packers[f].buffer_sizes}
            for f in store.fields}
        self.arrays = {f: {key: host_array(t) for key, t in bufs.items()}
                       for f, bufs in self.tensors.items()}
        self.event = None

    @property
    def nbytes(self) -> int:
        return sum(a.nbytes for bufs in self.arrays.values() for a in bufs.values())

    def wait(self) -> None:
        if self.event is not None:
            self.event.synchronize()
            self.event = None


class PopulationStore:
    """Host-side per-client persistent state for ``P`` virtual clients a group.

    data: per persistent field, one numpy buffer per dtype key of shape
        ``[G, P, N_dtype]`` -- the segment table of the state field, the
        cohort axis widened to the population (bfloat16 as uint16 bits).
        New clients start at zero, as a fresh materialized state does.
    packers / flat: per field, the segment table and whether the state
        holds the field as :class:`FlatBuffers` (else a tree, installed and
        extracted leaf by leaf through the table).
    generator: the CPU ``torch.Generator`` of the cohort draws.
    seconds: host wall seconds per step (:data:`STEPS`), accumulated over
        every run on this store; ``extract`` includes the wait for the
        chunk.
    """

    __slots__ = ("fields", "num_groups", "population", "packers", "flat", "data",
                 "generator", "seconds")

    def __init__(self, fields: tuple[str, ...], num_groups: int, population: int,
                 packers: dict[str, Packer], flat: dict[str, bool], data: HostBuffers,
                 generator: torch.Generator | None = None):
        self.fields = tuple(fields)
        self.num_groups = int(num_groups)
        self.population = int(population)
        self.packers = dict(packers)
        self.flat = dict(flat)
        self.data = data
        self.generator = generator if generator is not None else torch.Generator().manual_seed(0)
        self.seconds = dict.fromkeys(STEPS, 0.0)

    @classmethod
    def from_state(cls, state, population: int, fields: tuple[str, ...] = ("z",),
                   generator: torch.Generator | None = None) -> "PopulationStore":
        """A zeroed store for ``state``'s persistent fields (flat or tree
        layout, ``[G, K, ...]`` leading axes; fields the state lacks or holds
        as None are dropped), rows ``[0, K)`` seeded from the state's current
        values (a resumed state keeps its corrections)."""
        present = tuple(f for f in fields if getattr(state, f, None) is not None)
        if not present:
            raise ValueError(f"state has none of the persistent fields {fields!r}")
        packers: dict[str, Packer] = {}
        flat: dict[str, bool] = {}
        num_groups = None
        for f in present:
            value = getattr(state, f)
            if is_flat(value):
                packers[f], flat[f] = value.packer, True
            else:
                packers[f] = make_packer(tu.tree_map(lambda x: x[0, 0], value))
                flat[f] = False
            lead = _lead(value)
            if len(lead) != 2:
                raise ValueError(f"field {f!r} needs [G, K, ...] leading axes, got lead "
                                 f"shape {lead}")
            num_groups = lead[0]
            if population < lead[1]:
                raise ValueError(f"population ({population}) < materialized cohort "
                                 f"({lead[1]})")
        data = {f: {key: np.zeros((num_groups, population, n), numpy_dtype(key))
                    for key, n in packers[f].buffer_sizes}
                for f in present}
        store = cls(present, num_groups, population, packers, flat, data, generator)
        cohort = store.cohort_of(state)
        store.scatter(np.broadcast_to(np.arange(cohort), (num_groups, cohort)),
                      store.extract(state))
        store.seconds = dict.fromkeys(STEPS, 0.0)
        return store

    # -------------------------------------------------- host <-> device

    def gather(self, idx: np.ndarray, out: CohortBuffers | None = None) -> HostBuffers:
        """Copy the cohort rows ``idx [G, K]`` out of the store (into
        ``out``'s buffers when given, after waiting for their last copy)."""
        t0 = time.perf_counter()
        idx = np.asarray(idx, np.int64)
        if out is None:
            staged = {f: {key: np.empty((self.num_groups, idx.shape[1], buf.shape[2]), buf.dtype)
                          for key, buf in bufs.items()} for f, bufs in self.data.items()}
        else:
            out.wait()
            staged = out.arrays
        for f, bufs in self.data.items():
            for key, buf in bufs.items():
                dst = staged[f][key]
                for g, k in np.ndindex(*idx.shape):      # row copies: no temporary
                    dst[g, k] = buf[g, idx[g, k]]
        self.seconds["gather"] += time.perf_counter() - t0
        return staged

    def scatter(self, idx: np.ndarray, host_vals: HostBuffers) -> None:
        """Write the cohort rows back into the store, in place."""
        t0 = time.perf_counter()
        idx = np.asarray(idx, np.int64)
        for f, bufs in host_vals.items():
            for key, arr in bufs.items():
                buf = self.data[f][key]
                for g, k in np.ndindex(*idx.shape):
                    buf[g, idx[g, k]] = arr[g, k]
        self.seconds["scatter"] += time.perf_counter() - t0

    def refresh(self, staged: HostBuffers, idx_new: np.ndarray, idx_old: np.ndarray) -> None:
        """Re-read the staged rows that ``idx_old``'s scatter just updated
        (the overlapped driver gathered ``idx_new`` before that scatter)."""
        t0 = time.perf_counter()
        for g in range(self.num_groups):
            for k in np.flatnonzero(np.isin(idx_new[g], idx_old[g])):
                for f, bufs in staged.items():
                    for key, arr in bufs.items():          # row copies: no temporary
                        arr[g, k] = self.data[f][key][g, idx_new[g][k]]
        self.seconds["refresh"] += time.perf_counter() - t0

    def install(self, state, staged: HostBuffers | CohortBuffers):
        """Copy staged cohort rows into the state's persistent fields, in
        place (the state's own tensors: no new device allocation for the
        flat layout; the tree layout copies each dtype buffer to the device
        once and then leaf by leaf through the segment table). On a card
        the copies are queued (``non_blocking``); with :class:`CohortBuffers`
        an event after them guards the buffers' reuse. Returns ``state``."""
        t0 = time.perf_counter()
        bufs = staged if isinstance(staged, CohortBuffers) else None
        cuda = False
        for f in self.fields:
            value = getattr(state, f)
            cuda = cuda or _device(value).type == "cuda"
            src = (bufs.tensors[f] if bufs is not None else
                   {key: host_tensor(a, key) for key, a in staged[f].items()})
            if self.flat[f]:
                for key, dst in value.bufs.items():
                    dst.copy_(src[key], non_blocking=True)
                continue
            dev = _device(value)
            flat = FlatBuffers({key: s.to(dev, non_blocking=True) for key, s in src.items()},
                               self.packers[f])
            for (_, dst), (_, new) in zip(tree_paths(value), tree_paths(flat.to_tree())):
                dst.copy_(new)
        if bufs is not None and cuda:
            bufs.event = torch.cuda.Event()
            bufs.event.record()
        self.seconds["install"] += time.perf_counter() - t0
        return state

    def extract(self, state, out: CohortBuffers | None = None) -> HostBuffers:
        """Copy the persistent fields off the device (into ``out``'s
        page-locked buffers when given) and wait for them: the one
        synchronization of a chunk."""
        t0 = time.perf_counter()
        host: HostBuffers = {}
        cuda = False
        for f in self.fields:
            value = getattr(state, f)
            cuda = cuda or _device(value).type == "cuda"
            if not self.flat[f]:
                value = self.packers[f].flatten(value)
            host[f] = {}
            for key, buf in value.bufs.items():
                if out is None:
                    host[f][key] = host_array(buf.detach().to("cpu", copy=True))
                else:
                    out.tensors[f][key].copy_(buf, non_blocking=True)
                    host[f][key] = out.arrays[f][key]
        if out is not None and cuda:
            torch.cuda.current_stream().synchronize()
        self.seconds["extract"] += time.perf_counter() - t0
        return host

    # -------------------------------------------------------- reporting

    def cohort_of(self, state) -> int:
        """The materialized cohort size K of this state's leading axes."""
        return int(_lead(getattr(state, self.fields[0]))[1])

    def state_bytes(self) -> int:
        """Host bytes of the full ``[G, P]`` population store."""
        return sum(self.packers[f].state_bytes((self.num_groups, self.population))
                   for f in self.fields)

    def device_bytes(self, cohort: int) -> int:
        """Device bytes of the persistent fields at cohort size K."""
        return sum(self.packers[f].state_bytes((self.num_groups, cohort)) for f in self.fields)

    def size_report(self, cohort: int | None = None) -> dict[str, Any]:
        """Segment-table size breakdown, host store against device cohort."""
        report: dict[str, Any] = {
            "num_groups": self.num_groups,
            "population": self.population,
            "fields": {f: self.packers[f].size_report((self.num_groups, self.population))
                       for f in self.fields},
            "host_bytes": self.state_bytes(),
        }
        if cohort is not None:
            report["cohort"] = int(cohort)
            report["device_bytes"] = self.device_bytes(cohort)
        return report

    def __repr__(self) -> str:
        return (f"PopulationStore(G={self.num_groups}, P={self.population}, "
                f"fields={self.fields}, bytes={self.state_bytes()})")


def stateless_round(round_fn: Callable, fields: tuple[str, ...] = ("z", "dyn")) -> Callable:
    """Zero the persistent per-client fields before every round (the
    stateless-client contract: no store; corrections act within a round).
    Fields the state lacks or holds as None pass through."""

    def wrapped(state, batches, **kw):
        resets = {f: tu.tree_zeros_like(getattr(state, f))
                  for f in fields if getattr(state, f, None) is not None}
        return round_fn(state._replace(**resets), batches, **kw)

    return wrapped


def run_population_rounds(
    round_fn: Callable,
    state,
    store: PopulationStore,
    data: PackedBatches,
    T: int,
    *,
    chunk: int | None = None,
    eval_every: int = 1,
    eval_fn: Callable | None = None,
    overlap: bool = True,
    cohorts=None,
    shard_ids=None,
    draws=None,
) -> tuple[Any, PackedBatches, Horizon]:
    """``run_rounds`` over a virtual population: gather -> chunk -> scatter.

    Per chunk a cohort of K (the state's materialized shape) is drawn from
    the store's P clients a group, installed into the state, the chunk's
    rounds are queued, and the updated rows are extracted and scattered
    back. A cohort is fixed within a chunk. With ``overlap`` the next
    cohort's draw and gather run on the host while the card runs the chunk,
    and the rows both cohorts share are patched after the scatter;
    ``overlap=False`` gathers after the scatter (bit for bit the same).
    Two page-locked cohort buffers (for a card's state) are allocated once
    a run and alternate: one takes the next cohort's gather while the other
    holds the extract.

    ``cohorts`` (``[ceil(T / chunk), G, K]``) injects the cohort ids,
    ``shard_ids`` (``[T, E, G, K]``) and ``draws`` (T entries) the rounds'
    draws, as in ``run_rounds``. With ``P == K`` and no ``cohorts`` nothing
    is drawn (identity cohorts) and the generators are untouched.

    Returns ``(state, data, Horizon)``, ``Horizon.population`` the store
    (updated in place).
    """
    if T < 1 or eval_every < 1:
        raise ValueError(f"need T >= 1 and eval_every >= 1, got T={T}, "
                         f"eval_every={eval_every}")
    if chunk is not None and chunk < 0:
        raise ValueError(f"chunk must be None or >= 0, got {chunk}")
    chunk = T if not chunk else min(int(chunk), T)
    G, P = store.num_groups, store.population
    K = store.cohort_of(state)
    n_chunks = math.ceil(T / chunk)
    if cohorts is not None:
        cohorts = np.asarray(cohorts, np.int64)
        if cohorts.shape != (n_chunks, G, K):
            raise ValueError(f"cohorts must be [ceil(T / chunk), G, K] = {(n_chunks, G, K)}, "
                             f"got {cohorts.shape}")
        if cohorts.min() < 0 or cohorts.max() >= P or any(
                len(set(row.tolist())) != K for row in cohorts.reshape(-1, K)):
            raise ValueError(f"every cohort row needs {K} distinct ids in [0, {P})")
    if shard_ids is not None:
        shard_ids = torch.as_tensor(np.asarray(shard_ids))
        if shard_ids.shape[0] != T:
            raise ValueError(f"shard_ids has {shard_ids.shape[0]} rounds, T={T}")
    if draws is not None and len(draws) != T:
        raise ValueError(f"draws has {len(draws)} rounds, T={T}")

    drawn = 0

    def draw() -> np.ndarray:
        nonlocal drawn
        drawn += 1
        if cohorts is not None:
            return cohorts[drawn - 1]
        if P == K:
            return np.broadcast_to(np.arange(K), (G, K))
        return draw_cohort(store.generator, G, P, K)

    pin = _device(getattr(state, store.fields[0])).type == "cuda"
    cur, nxt = CohortBuffers(store, K, pin), CohortBuffers(store, K, pin)
    idx = draw()
    store.gather(idx, out=cur)
    state = store.install(state, cur)

    mets, evs, masks = [], [], []
    done = 0
    while done < T:
        n = min(chunk, T - done)
        mask = eval_mask_for_chunk(done, n, T, eval_every)
        state, chunk_mets, chunk_evs = dispatch_chunk(
            round_fn, state, data, mask, done=done, eval_fn=eval_fn, shard_ids=shard_ids,
            draws=draws)
        done += n
        # The chunk is queued: until extract() the host works beside the card.
        idx_next = None
        if done < T:
            idx_next = draw()
            if overlap:
                store.gather(idx_next, out=nxt)
        store.scatter(idx, store.extract(state, out=cur))
        if idx_next is not None:
            if overlap:
                store.refresh(nxt.arrays, idx_next, idx)
            else:
                store.gather(idx_next, out=nxt)
            state = store.install(state, nxt)
            idx, cur, nxt = idx_next, nxt, cur
        mets.append(_to_host(chunk_mets))
        if chunk_evs:
            evs.append(_to_host(chunk_evs))
        masks.append(mask)

    eval_rounds = np.nonzero(np.concatenate(masks))[0] + 1
    evals = _concat(evs) if eval_fn is not None else None
    return state, data, Horizon(metrics=_concat(mets), evals=evals, eval_rounds=eval_rounds,
                                data=data, population=store)
