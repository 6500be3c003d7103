"""The port's front door: ``ExperimentSpec`` -> ``build`` -> ``fit``.

Port of ``src/repro/core/api.py``. The spec keeps the reference's full
field list, so one set of keyword arguments builds both packages' specs,
and rejects a contradictory spec with the reference's message, in the
reference's order. Partial participation (``client_participation``/``group_participation`` <
1), compressed uploads (``compression=CompressionPlan(...)``), fault
injection with screened aggregation (``faults=FaultPlan(...)``,
``defense=DefensePlan(...)``), async group rounds (a per-group
``RoundSchedule(group_rounds=(E_1, ..., E_G))`` with ``staleness=`` and
``max_staleness=``) and virtual client populations (``population=``,
``cohort_size=``, ``client_state=``; ``core.population``) run on both
engines, with the reference's rejections of contradictory combinations.
:func:`build` turns a spec into a :class:`SimulatorEngine`, a
:class:`MultiLevelEngine` (Appendix E's M-level MTGC over
``levels=(N_1, ..., N_M)`` with ``schedule=RoundSchedule(periods=...)`` and
``level_participation=``; ``core.multilevel``) or a :class:`ShardedEngine`
on a device (the CUDA card unless ``device="cpu"`` is passed) and :func:`fit` drives it
through the horizon driver (``core.driver``), guarded against divergence
with ``fit(..., guard=True)``, autosaving checkpoints with
``fit(..., checkpoint_every=, checkpoint_path=)`` (``repro_torch.checkpoint``)
and resuming with ``resume=True``::

    from repro_torch import api
    spec = api.ExperimentSpec(
        levels=(4, 5), algorithm="mtgc", lr=0.1,
        schedule=api.RoundSchedule(group_rounds=4, local_steps=5))
    engine = api.build(spec, loss_fn)                  # on cuda
    data = engine.pack_arrays({"x": X, "y": Y}, client_index_pools,
                              batch_size=32, rng=np.random.default_rng(0))
    state, horizon = api.fit(engine, data, 30, params=model_params,
                             eval_every=5, eval_fn=my_eval_fn)
    model = engine.global_model(state)

The CLI table (:data:`CLI_FLAGS`, :func:`add_spec_args`,
:func:`spec_from_args`) is the reference's: one argparse flag per spec
field, so ``launch/train.py`` takes the reference trainer's flags.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch.core.compression import COMPRESSION_MODES, CompressionPlan
from repro_torch.core.config import HFLConfig
from repro_torch.core.device import clone_generator, resolve_device
from repro_torch.core.faults import FAULT_KINDS, DefensePlan, FaultPlan
from repro_torch.core.driver import (
    GuardSpec,
    Horizon,
    PackedBatches,
    pack_client_shards,
    pack_lm_shards,
    run_rounds,
)
from repro_torch.core.engine import (
    RoundMetrics,
    _build_global_round,
    global_model,
    hfl_init,
)
from repro_torch.core.packer import as_tree
from repro_torch.core.participation import sample_hfl_masks
from repro_torch.core.population import (
    PopulationStore,
    population_fields,
    run_population_rounds,
    stateless_round,
)
from repro_torch.core.staleness import STALENESS_POLICIES, make_plan
from repro_torch.core.tree import tree_map

Tree = Any

ALGORITHMS = ("mtgc", "hfedavg", "local_corr", "group_corr", "fedprox", "feddyn")
BACKENDS = ("simulator", "multilevel", "sharded")
LAYOUTS = ("tree", "flat")
FUSIONS = ("none", "fused")
CLIENT_STATES = ("stateful", "stateless")

# Which algorithms each backend implements (the reference's table).
BACKEND_ALGORITHMS = {
    "simulator": ALGORITHMS,
    "multilevel": ("mtgc",),
    "sharded": ("mtgc", "hfedavg"),
}


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


@dataclasses.dataclass(frozen=True)
class RoundSchedule:
    """When each timescale fires (the reference's fields).

    group_rounds: E -- group aggregations per global round. A scalar, or a
        per-group tuple ``(E_1, ..., E_G)`` (length ``levels[0]``): a
        non-uniform tuple enables async group rounds -- each group runs its
        own E_g inside a padded ``max(E_g)`` window, and
        ``ExperimentSpec.staleness`` picks the stale-report policy.
    local_steps: H -- local SGD steps per group round.
    microbatches: A -- gradient-accumulation chunks per local step; a
        sharded-backend knob (None elsewhere).
    periods: M-level aggregation periods ``(P_1, ..., P_M)``, each
        dividing the one before -- a multilevel-backend knob; they define
        ``(group_rounds, local_steps) = (P_1 // P_M, P_M)``.
    """

    group_rounds: int | tuple[int, ...] = 2
    local_steps: int = 5
    microbatches: int | None = None
    periods: tuple[int, ...] | None = None

    def __post_init__(self):
        if isinstance(self.group_rounds, (list, tuple)):
            object.__setattr__(self, "group_rounds",
                               tuple(int(e) for e in self.group_rounds))
        if self.periods is not None:
            object.__setattr__(self, "periods", tuple(int(p) for p in self.periods))

    @property
    def is_uniform(self) -> bool:
        """True when every group runs the same number of group rounds."""
        if isinstance(self.group_rounds, tuple):
            return all(e == self.group_rounds[0] for e in self.group_rounds)
        return True

    @property
    def uniform_group_rounds(self) -> int:
        """E as a scalar; raises for non-uniform (async) schedules."""
        if isinstance(self.group_rounds, tuple):
            _require(self.is_uniform,
                     "this code path needs a uniform group-round schedule "
                     f"(got {self.group_rounds}); async per-group schedules "
                     "run through the padded max(E_g) loop "
                     "(max_group_rounds)")
            return self.group_rounds[0]
        return int(self.group_rounds)

    @property
    def max_group_rounds(self) -> int:
        """max(E_g) -- equals E for uniform schedules."""
        if isinstance(self.group_rounds, tuple):
            return max(self.group_rounds)
        return int(self.group_rounds)

    def level_periods(self, num_levels: int) -> tuple[int, ...]:
        """Aggregation periods for an ``num_levels``-deep topology."""
        if self.periods is not None:
            return self.periods
        E, H = self.uniform_group_rounds, self.local_steps
        _require(num_levels == 2,
                 f"a {num_levels}-level topology needs explicit "
                 "schedule.periods (group_rounds/local_steps only define "
                 "the two-level schedule)")
        return (E * H, H)

    def validate(self, levels: tuple[int, ...]) -> "RoundSchedule":
        gr = self.group_rounds
        if isinstance(gr, tuple):
            _require(len(gr) == levels[0],
                     f"per-group group_rounds needs one entry per group: "
                     f"{len(gr)} entries for {levels[0]} groups")
            _require(all(e >= 1 for e in gr), f"group_rounds must be >= 1: {gr}")
        else:
            _require(gr >= 1, f"group_rounds must be >= 1, got {gr}")
        _require(self.local_steps >= 1,
                 f"local_steps must be >= 1, got {self.local_steps}")
        _require(self.microbatches is None or self.microbatches >= 1,
                 f"microbatches must be None or >= 1, got {self.microbatches}")
        if self.periods is not None:
            _require(self.is_uniform,
                     "explicit schedule.periods (the multilevel backend) "
                     "require a uniform group-round schedule, got "
                     f"group_rounds={self.group_rounds}")
            _require(len(self.periods) == len(levels),
                     f"one period per level: {len(self.periods)} periods for "
                     f"{len(levels)} levels")
            for a, b in zip(self.periods, self.periods[1:]):
                _require(a > b and a % b == 0,
                         f"periods must nest (P_m > P_m+1, divisible): {self.periods}")
            # periods are authoritative: an explicitly different E/H would
            # be ignored, so the conflict is rejected (the field defaults
            # count as unset).
            derived = (self.periods[0] // self.periods[-1], self.periods[-1])
            given = (self.uniform_group_rounds, self.local_steps)
            defaults = (RoundSchedule.group_rounds, RoundSchedule.local_steps)
            _require(given == derived or given == defaults,
                     f"schedule.periods={self.periods} implies "
                     f"(group_rounds, local_steps)={derived}, which "
                     f"conflicts with the explicit {given}; set periods "
                     "alone or keep them consistent")
        return self


@dataclasses.dataclass(frozen=True)
class ExperimentSpec:
    """Everything that defines one HFL experiment (the reference's fields;
    see ``src/repro/core/api.py`` for each one's meaning).

    The port runs the simulator backend under the sync schedule or async
    group rounds, in either state layout, fused (mtgc) or not, at full or
    partial participation, with or without a ``CompressionPlan`` (sync
    schedules only, as in the reference), a ``FaultPlan`` and a
    ``DefensePlan``; the multilevel backend (mtgc) over any ``levels`` depth
    with ``schedule.periods`` and ``level_participation``, in either layout,
    at full or partial participation; and the sharded backend (mtgc,
    hfedavg) like the simulator, with ``schedule.microbatches`` and
    ``correction_dtype``. ``fused_mode`` takes None or "auto" (the reference's
    "pallas"/"interpret" have no counterpart: the kernel runs on a CUDA
    tensor, its plain version on a CPU tensor).
    """

    levels: tuple[int, ...] = (2, 2)
    schedule: RoundSchedule = RoundSchedule()
    algorithm: str = "mtgc"
    lr: float = 0.1
    backend: str = "simulator"
    state_layout: str = "flat"
    fusion: str = "none"
    fused_mode: str | None = None
    correction_init: str = "zero"
    prox_mu: float = 0.0
    feddyn_alpha: float = 0.0
    server_lr: float = 1.0
    client_participation: float = 1.0
    group_participation: float = 1.0
    level_participation: tuple[float, ...] | None = None
    participation_mode: str = "uniform"
    participation_weighting: str = "none"
    correction_dtype: str | None = None
    staleness: str = "sync"
    max_staleness: int | None = None
    population: int | None = None
    cohort_size: int | None = None
    client_state: str = "stateful"
    faults: FaultPlan | None = None
    defense: DefensePlan | None = None
    compression: Any | None = None

    def __post_init__(self):
        object.__setattr__(self, "levels", tuple(int(n) for n in self.levels))
        if self.level_participation is not None:
            object.__setattr__(self, "level_participation",
                               tuple(float(p) for p in self.level_participation))

    def validate(self) -> "ExperimentSpec":
        """Reject a contradictory spec with the reference's message, checking
        in the reference's order (so the first rule a spec breaks names the
        same fault in both packages). Returns the spec."""
        _require(len(self.levels) >= 2,
                 f"levels needs at least (groups, clients), got {self.levels}")
        _require(all(n >= 1 for n in self.levels),
                 f"every topology dim must be >= 1: {self.levels}")
        _require(self.backend in BACKENDS,
                 f"unknown backend {self.backend!r} (choose from {BACKENDS})")
        _require(self.algorithm in ALGORITHMS,
                 f"unknown algorithm {self.algorithm!r} (choose from {ALGORITHMS})")
        _require(self.algorithm in BACKEND_ALGORITHMS[self.backend],
                 f"algorithm {self.algorithm!r} is not implemented by the {self.backend!r} "
                 f"backend (supported: {BACKEND_ALGORITHMS[self.backend]})")
        _require(len(self.levels) == 2 or self.backend == "multilevel",
                 f"{len(self.levels)}-level topologies need backend='multilevel', "
                 f"got {self.backend!r}")
        self.schedule.validate(self.levels)
        _require(self.schedule.microbatches is None or self.backend == "sharded",
                 "schedule.microbatches is a sharded-backend knob")
        if self.backend == "multilevel":
            self.schedule.level_periods(len(self.levels))

        # Async group rounds.
        _require(self.staleness in STALENESS_POLICIES,
                 f"unknown staleness policy {self.staleness!r} "
                 f"(choose from {STALENESS_POLICIES})")
        uniform = self.schedule.is_uniform
        _require(uniform or self.backend != "multilevel",
                 "non-uniform group_rounds (async group rounds) are a two-level feature: the "
                 "multilevel backend requires a uniform schedule")
        _require(self.staleness == "sync" or not uniform,
                 f"staleness={self.staleness!r} is a no-op with uniform group_rounds: stale "
                 "reports only arise when groups run different round counts -- set a "
                 "per-group tuple or drop the policy")
        _require(self.max_staleness is None or self.staleness != "sync",
                 "max_staleness bounds async reporting; it needs a non-'sync' staleness "
                 "policy")
        _require(self.max_staleness is None or self.max_staleness >= 1,
                 f"max_staleness must be None or >= 1, got {self.max_staleness}")
        _require(uniform or self.correction_init == "zero",
                 "async group rounds require correction_init='zero' (the gradient init has "
                 "no per-cycle analogue)")
        _require(uniform or self.server_lr == 1.0, "async group rounds require server_lr=1.0")

        _require(self.state_layout in LAYOUTS,
                 f"unknown state_layout {self.state_layout!r} (choose from {LAYOUTS})")
        _require(self.fusion in FUSIONS,
                 f"unknown fusion {self.fusion!r} (choose from {FUSIONS})")
        _require(self.fusion == "none" or self.algorithm == "mtgc",
                 "fusion='fused' fuses exactly g + z + y: mtgc only")
        _require(self.fusion == "none" or self.backend != "multilevel",
                 "the multilevel backend has no fused-kernel path")
        _require(self.fused_mode is None or self.backend == "sharded",
                 "fused_mode overrides the sharded backend's kernel dispatch")
        _require(self.fused_mode in (None, "auto"),
                 f"fused_mode {self.fused_mode!r} has no counterpart in the port: the kernel "
                 "runs on a CUDA tensor, its plain version on a CPU tensor (None or 'auto')")
        _require(self.correction_dtype is None
                 or (self.backend == "sharded" and self.state_layout == "tree"),
                 "correction_dtype (narrow z/y storage) exists only on the sharded "
                 "backend's tree layout")

        _require(self.correction_init in ("zero", "gradient"),
                 f"correction_init must be 'zero' or 'gradient', "
                 f"got {self.correction_init!r}")
        _require(self.correction_init == "zero" or self.backend == "simulator",
                 "correction_init='gradient' is a simulator-engine feature")
        for name in ("prox_mu", "feddyn_alpha"):
            _require(getattr(self, name) == 0.0 or self.backend == "simulator",
                     f"{name} only affects the simulator engine's fedprox/feddyn "
                     "algorithms")
        _require(self.server_lr == 1.0 or self.backend == "simulator",
                 "server_lr is a simulator-engine knob")

        for name in ("client_participation", "group_participation"):
            frac = getattr(self, name)
            _require(0.0 < frac <= 1.0, f"{name} must be in (0, 1], got {frac}")
        _require(self.participation_mode in ("uniform", "fixed"),
                 f"participation_mode must be 'uniform' or 'fixed', "
                 f"got {self.participation_mode!r}")
        _require(self.participation_weighting in ("none", "inverse_prob"),
                 f"participation_weighting must be 'none' or 'inverse_prob', "
                 f"got {self.participation_weighting!r}")
        if self.level_participation is not None:
            _require(self.backend == "multilevel",
                     "level_participation is a multilevel-backend knob; two-level backends "
                     "use client_/group_participation")
            _require(len(self.level_participation) == len(self.levels),
                     "one participation fraction per level: "
                     f"{len(self.level_participation)} for {len(self.levels)} levels")
            _require(all(0.0 < p <= 1.0 for p in self.level_participation),
                     f"participation fractions must be in (0, 1]: {self.level_participation}")

        # Virtual populations.
        _require(self.client_state in CLIENT_STATES,
                 f"unknown client_state {self.client_state!r} "
                 f"(choose from {CLIENT_STATES})")
        _require(self.cohort_size is None or self.population is not None,
                 "cohort_size describes the sampled cohort of a virtual population; set "
                 "population too")
        _require(self.client_state == "stateful" or self.population is not None,
                 "client_state='stateless' is a virtual-population contract; set population "
                 "(the materialized engines are stateful by construction)")
        if self.population is not None:
            _require(self.population >= 1, f"population must be >= 1, got {self.population}")
            _require(len(self.levels) == 2,
                     f"a virtual population is two-level (groups x clients); got "
                     f"levels={self.levels}")
            _require(self.backend != "multilevel",
                     "the multilevel backend has no cohort gather/scatter path; use the "
                     "simulator or sharded backend")
            _require(self.cohort_size is None or self.cohort_size == self.levels[1],
                     f"cohort_size ({self.cohort_size}) must equal levels[1] "
                     f"({self.levels[1]}), the compiled cohort shape -- levels stays the "
                     "single authoritative topology")
            _require(self.population >= self.levels[1],
                     f"population ({self.population}) must be >= the cohort levels[1] "
                     f"({self.levels[1]}): a cohort larger than the population cannot be "
                     "sampled without replacement")
        if self.virtual_population:
            _require(self.full_participation,
                     "a virtual population (population > levels[1]) samples its cohort from "
                     "the store -- that *is* the participation mechanism; in-round partial "
                     "participation would freeze slots whose occupants change between "
                     "chunks. Keep client_/group_participation at 1.0")
            _require(self.schedule.is_uniform and self.staleness == "sync",
                     "virtual populations require a uniform sync schedule: async per-group "
                     "cadences assume slot occupants persist across windows (follow-up work)")

        # Fault tolerance.
        if self.faults is not None:
            self.faults.validate()
        if self.defense is not None:
            self.defense.validate()
        if self.fault_mode or self.defended:
            _require(self.backend != "multilevel",
                     "fault injection / screened aggregation are two-level features "
                     "(simulator and sharded backends); the multilevel backend is follow-up "
                     "work")
            _require(self.population is None,
                     "fault injection with a virtual population is follow-up work: screened "
                     "slots would need store-side healing")
            _require(self.correction_init == "zero",
                     "fault injection / screened aggregation require correction_init='zero' "
                     "(the gradient init has no crash-consistent analogue)")
            _require(self.server_lr == 1.0,
                     "fault injection / screened aggregation require server_lr=1.0")

        # Compressed uploads.
        if self.compression is not None:
            self.compression.validate()
        if self.compressed:
            _require(self.backend != "multilevel",
                     "compressed uploads are a two-level feature (simulator and sharded "
                     "backends); per-level plans for the multilevel backend are follow-up "
                     "work")
            _require(self.staleness == "sync" and self.schedule.is_uniform,
                     "compressed uploads under an async schedule are not supported yet: "
                     "stale reports would need their own residual timeline (see ROADMAP)")
            _require(self.correction_init == "zero",
                     "compressed uploads require correction_init='zero' "
                     "(the gradient init predates the upload seam)")
            _require(self.server_lr == 1.0, "compressed uploads require server_lr=1.0")
            if self.compression.error_feedback:
                _require(self.client_state == "stateful",
                         "error feedback is per-client persistent state; client_state="
                         "'stateless' contradicts it -- set CompressionPlan(error_feedback=False)")
                _require(self.population is None,
                         "error feedback with a virtual population is follow-up work: "
                         "per-client residuals would need store-side gather/scatter like z; "
                         "set CompressionPlan(error_feedback=False)")
            else:
                _require(self.population is None or self.compression.client_mode == "none",
                         "client-link compression with a virtual population is follow-up work "
                         "(the cohort seam predates the upload seam)")
        return self

    @property
    def full_participation(self) -> bool:
        if self.level_participation is not None:
            return all(p >= 1.0 for p in self.level_participation)
        return self.client_participation >= 1.0 and self.group_participation >= 1.0

    @property
    def fault_mode(self) -> bool:
        """True when the spec injects any faults."""
        return self.faults is not None and self.faults.enabled

    @property
    def defended(self) -> bool:
        """True when screened aggregation is active."""
        return self.defense is not None and self.defense.enabled

    @property
    def compressed(self) -> bool:
        """True when any upload link carries a non-trivial compressor."""
        return self.compression is not None and self.compression.enabled

    @property
    def virtual_population(self) -> bool:
        """True when the population exceeds the materialized cohort (cohort
        draws then sample; ``population == levels[1]`` materializes all)."""
        return self.population is not None and self.population > self.levels[1]

    def participation_by_level(self) -> tuple[float, ...]:
        """Per-level live-uplink fractions for the multilevel engine: the
        ``level_participation``, else the two scalar fractions (groups at
        level 1, clients at the deepest level, 1.0 between)."""
        if self.level_participation is not None:
            return self.level_participation
        return ((self.group_participation,) + (1.0,) * (len(self.levels) - 2)
                + (self.client_participation,))

    def staleness_plan(self):
        """The :class:`~repro_torch.core.staleness.StalenessPlan` this spec's
        schedule implies, or None for the uniform sync schedule (the engines
        then run their sync round)."""
        return make_plan(self.schedule.group_rounds, self.levels[0], self.staleness,
                         self.max_staleness)

    def to_hfl_config(self) -> HFLConfig:
        """The equivalent two-level ``HFLConfig`` (simulator engine);
        ``group_rounds`` is the padded loop length ``max(E_g)``."""
        _require(len(self.levels) == 2,
                 f"HFLConfig is two-level; spec has levels={self.levels}")
        return HFLConfig(
            num_groups=self.levels[0],
            clients_per_group=self.levels[1],
            local_steps=self.schedule.local_steps,
            group_rounds=self.schedule.max_group_rounds,
            lr=self.lr,
            algorithm=self.algorithm,
            correction_init=self.correction_init,
            prox_mu=self.prox_mu,
            feddyn_alpha=self.feddyn_alpha,
            server_lr=self.server_lr,
            client_participation=self.client_participation,
            group_participation=self.group_participation,
            participation_mode=self.participation_mode,
            participation_weighting=self.participation_weighting,
            use_fused_update=self.fusion == "fused",
            use_flat_state=self.state_layout == "flat",
        )

    @classmethod
    def from_hfl_config(cls, cfg: HFLConfig) -> "ExperimentSpec":
        return cls(
            levels=(cfg.num_groups, cfg.clients_per_group),
            schedule=RoundSchedule(group_rounds=cfg.group_rounds,
                                   local_steps=cfg.local_steps),
            algorithm=cfg.algorithm,
            lr=cfg.lr,
            state_layout="flat" if cfg.use_flat_state else "tree",
            fusion="fused" if cfg.use_fused_update else "none",
            correction_init=cfg.correction_init,
            prox_mu=cfg.prox_mu,
            feddyn_alpha=cfg.feddyn_alpha,
            server_lr=cfg.server_lr,
            client_participation=cfg.client_participation,
            group_participation=cfg.group_participation,
            participation_mode=cfg.participation_mode,
            participation_weighting=cfg.participation_weighting,
        )


LossFn = Callable[[Tree, Tree], torch.Tensor]


def _index_depth(indices) -> int:
    depth = 0
    node = indices
    while isinstance(node, (list, tuple)):
        depth += 1
        node = node[0]
    return depth


class _EngineBase:
    """What both engines share: the stateless-client wrapper, the population
    store, and the guarded horizon's retry rounds."""

    def _wrap_stateless(self) -> None:
        """Wrap the round once at build time under ``client_state="stateless"``
        (``z`` and ``dyn`` zeroed before every round)."""
        if self.spec.client_state == "stateless":
            self.round_fn = stateless_round(self.round_fn, ("z", "dyn"))

    @property
    def population_fields(self) -> tuple[str, ...]:
        """State fields the population store persists for this spec."""
        return population_fields(self.spec.algorithm)

    def init_population(self, state, generator: torch.Generator | None = None
                        ) -> PopulationStore:
        """A zeroed host store for ``spec.population`` virtual clients, rows
        ``[0, K)`` seeded from ``state``'s corrections; ``generator`` (a CPU
        generator, default seeded with 0) draws the cohorts."""
        _require(self.spec.population is not None, "init_population needs spec.population set")
        _require(self.spec.client_state == "stateful",
                 "stateless clients keep no per-client state; no store exists to initialize")
        return PopulationStore.from_state(state, self.spec.population, self.population_fields,
                                          generator)

    def retry_round_fn(self, retry: int):
        """The round function for guarded-horizon retry ``retry`` (>= 1).

        With a norm screen in the spec, each retry rebuilds the round with
        ``screen_norm * retry_widen ** retry``, so a chunk that diverged
        because a corrupted but finite delta slipped under the threshold
        meets a tighter screen on replay; otherwise the original round is
        retried (the reseeded generators alone change the draws). Rebuilt
        rounds are cached per retry level."""
        spec = self.spec
        if retry <= 0 or spec.defense is None or spec.defense.screen_norm is None:
            return self.round_fn
        cache = self.__dict__.setdefault("_retry_round_fns", {})
        if retry not in cache:
            widened = dataclasses.replace(
                spec.defense,
                screen_norm=spec.defense.screen_norm * spec.defense.retry_widen ** retry)
            cache[retry] = build(dataclasses.replace(spec, defense=widened), self.loss_fn,
                                 device=self.device).round_fn
        return cache[retry]

    def participation_masks(self, rng: torch.Generator):
        """``(masks, next_rng)``: the participation masks the next two-level
        round draws from a state whose generator is ``rng`` (the
        reference's ``participation_masks``), and a generator in the state
        that round leaves it in after the draw. The draw is made from a
        copy, so ``rng`` is untouched; eval closures re-derive a round's
        masks from ``prev.rng``."""
        _require(len(self.spec.levels) == 2,
                 "participation_masks is two-level; the multilevel backend "
                 "draws hierarchical chain masks internally")
        _require(rng is not None, "participation_masks needs the state's rng (a state "
                 "without one draws no masks)")
        spec = self.spec
        gen = clone_generator(rng)
        masks = sample_hfl_masks(gen, *spec.levels, spec.client_participation,
                                 spec.group_participation, spec.participation_mode)
        return masks, gen

    def _fault_download(self) -> bool:
        """Whether the state carries the realized-download mask ``dl``: only
        where it is read, timeouts under an async schedule."""
        spec = self.spec
        return (spec.fault_mode and spec.faults.timeout_rate > 0
                and self._plan is not None)

    # The driver layout (E, H[, A]) of one round's packed batches.
    @property
    def _pack_rounds(self) -> int:
        return self.spec.schedule.max_group_rounds

    @property
    def _pack_steps(self) -> int:
        return self.spec.schedule.local_steps

    @property
    def _pack_microbatches(self) -> int | None:
        return None

    def pack_arrays(self, data_arrays: dict[str, np.ndarray], indices: list, *,
                    batch_size: int, shards: int = 16, rng: np.random.Generator,
                    generator: torch.Generator | None = None) -> PackedBatches:
        """Pack a partitioned array dataset for :func:`fit` (uploads once):
        ``indices`` nests one index pool per client, as deep as ``levels``."""
        _require(_index_depth(indices) == len(self.spec.levels),
                 f"index nesting depth {_index_depth(indices)} does not "
                 f"match levels={self.spec.levels}")
        return pack_client_shards(
            data_arrays, indices, group_rounds=self._pack_rounds,
            local_steps=self._pack_steps, batch_size=batch_size, shards=shards,
            microbatches=self._pack_microbatches, rng=rng, generator=generator,
            device=self.device)

    def pack_tokens(self, tokens, *, batch_size: int, seq_len: int, shards: int = 8,
                    rng: np.random.Generator,
                    generator: torch.Generator | None = None) -> PackedBatches:
        """Pack an LM token stream (one shared stream, or ``[G][K]``
        per-client streams) for :func:`fit`: ``seq_len`` windows, A
        microbatches of ``batch_size`` a local step on the sharded backend
        (uploads once). Two-level backends only."""
        _require(len(self.spec.levels) == 2,
                 "token packing is two-level; use pack_arrays with nested "
                 "index pools for deeper trees")
        G, K = self.spec.levels
        return pack_lm_shards(
            tokens, num_groups=G, clients_per_group=K, group_rounds=self._pack_rounds,
            local_steps=self._pack_steps, batch_size=batch_size, seq_len=seq_len,
            shards=shards, microbatches=self._pack_microbatches, rng=rng,
            generator=generator, device=self.device)

    def _needs_rng(self) -> bool:
        """Whether the state carries a generator: participation masks, fault
        masks or stochastic-rounding noise, or a virtual population (the
        reference's state then carries its cohort key; the port draws
        cohorts from the store's own CPU generator)."""
        spec = self.spec
        comp = spec.compression if spec.compressed else None
        return (not spec.full_participation or spec.fault_mode or spec.virtual_population
                or (comp is not None and comp.stochastic))


class SimulatorEngine(_EngineBase):
    """The paper engine (``core.engine``) behind the uniform surface.

    spec: the validated :class:`ExperimentSpec`.
    device: where the state, the packed data and the kernels live.
    round_fn: ``(state, batches) -> (state, metrics)`` over batches
        ``[E, H, G, K, ...]`` (what ``select_round`` emits).
    metric_fields: the names of :class:`RoundMetrics`' fields.
    """

    def __init__(self, spec: ExperimentSpec, loss_fn: LossFn, device: torch.device):
        self.spec = spec
        self.loss_fn = loss_fn
        self.device = device
        self._cfg = spec.to_hfl_config().validate()
        self._plan = spec.staleness_plan()
        self.metric_fields = RoundMetrics._fields
        self.round_fn = _build_global_round(loss_fn, self._cfg, plan=self._plan,
                                            faults=spec.faults, defense=spec.defense,
                                            compression=spec.compression)
        self._wrap_stateless()

    def init(self, params: Tree, rng: torch.Generator | None = None):
        """Broadcast one model into the round state on the engine's device,
        with the error-feedback residuals the compression plan carries, and
        an async schedule's download snapshots (delay compensation) and
        realized-download mask (timeouts under an async schedule).

        A partial-participation, fault-injecting or stochastic-rounding run
        (or a virtual population's) draws from the state's ``rng``; without
        one it gets a generator on the engine's device seeded with 0 (the
        reference's ``PRNGKey(0)``).
        """
        spec = self.spec
        comp = spec.compression if spec.compressed else None
        if rng is None and self._needs_rng():
            rng = torch.Generator(device=self.device).manual_seed(0)
        plan = self._plan
        return hfl_init(params, self._cfg, rng,
                        staleness_snapshots=plan is not None and plan.needs_snapshots,
                        fault_download=self._fault_download(),
                        ef_client=comp is not None and comp.ef_client,
                        ef_group=comp is not None and comp.ef_group,
                        device=self.device)

    def global_model(self, state) -> Tree:
        """The global model: replica [0, 0], or under an async schedule
        replica 0 of the plan's fastest group (only a cadence-1 group's
        replicas hold the fresh global model between windows)."""
        if self._plan is not None:
            g = self._plan.fastest_group
            return as_tree(tree_map(lambda x: x[g, 0], state.params))
        return global_model(state)



class MultiLevelMetrics(NamedTuple):
    """Metrics of the multilevel backend (losses only)."""

    loss: torch.Tensor  # [P_1] mean training loss per local step


class MultiLevelEngine(_EngineBase):
    """Appendix E's M-level engine (``core.multilevel``) behind the uniform
    surface.

    spec: the validated :class:`ExperimentSpec` (``backend="multilevel"``).
    device: where the state and the packed data live.
    round_fn: ``(state, batches, draws=None) -> (state, metrics)`` over the
        driver layout ``[E, H, *dims, ...]`` (``E * H = P_1``); it merges the
        two leading axes into ``legacy_round_fn``'s ``[P_1, *dims, ...]``.
        ``draws`` (M masks, ``masks[m]`` of shape ``dims[:m + 1]``) replaces
        a partial-participation round's draw.
    metric_fields: the names of :class:`MultiLevelMetrics`' fields.
    """

    def __init__(self, spec: ExperimentSpec, loss_fn: LossFn, device: torch.device):
        from repro_torch.core import multilevel as _ml

        self.spec = spec
        self.loss_fn = loss_fn
        self.device = device
        self.metric_fields = MultiLevelMetrics._fields
        self.legacy_round_fn = _ml._build_multilevel_round(
            loss_fn, spec.levels, spec.schedule.level_periods(len(spec.levels)), spec.lr,
            participation=None if spec.full_participation else spec.participation_by_level(),
            participation_mode=spec.participation_mode,
            participation_weighting=spec.participation_weighting)
        E, H, raw = self._pack_rounds, self._pack_steps, self.legacy_round_fn

        def round_fn(state, batches, draws=None):
            merged = tree_map(lambda b: b.reshape((E * H,) + tuple(b.shape[2:])), batches)
            state, losses = raw(state, merged, draws=draws)
            return state, MultiLevelMetrics(loss=losses)

        self.round_fn = round_fn

    @property
    def _pack_rounds(self) -> int:
        periods = self.spec.schedule.level_periods(len(self.spec.levels))
        return periods[0] // periods[-1]

    @property
    def _pack_steps(self) -> int:
        return self.spec.schedule.level_periods(len(self.spec.levels))[-1]

    def init(self, params: Tree, rng: torch.Generator | None = None):
        """Broadcast one model to every leaf on the engine's device, in the
        spec's layout, with zero corrections; without ``rng`` the state gets
        a generator on the device seeded with 0 (the reference's
        ``PRNGKey(0)``)."""
        from repro_torch.core.multilevel import multilevel_init

        return multilevel_init(params, self.spec.levels, rng,
                               use_flat_state=self.spec.state_layout == "flat",
                               device=self.device)

    def global_model(self, state) -> Tree:
        """The global model, read from leaf client 0 (flat states unpacked)."""
        from repro_torch.core.multilevel import multilevel_global_model

        return multilevel_global_model(state)


class ShardedEngine(_EngineBase):
    """The production microbatched round (``launch.train``) behind the
    uniform surface.

    spec: the validated :class:`ExperimentSpec` (``backend="sharded"``).
    device: where the state, the packed data and the kernels live.
    round_fn: ``(state, batches, draws=None) -> (state, metrics)`` over
        batches ``[E, H, A, G, K, ...]``; it updates the state's tensors in
        place (the reference donates them), so a caller keeps only the
        state it returns.
    metric_fields: the names of ``ShardedMetrics``' fields.
    mesh: the ``DeviceMesh`` the round runs over (None: one device). Its
        states are this rank's blocks (``sharding/state.py``); packed data
        stays whole and the round reads its rows.
    """

    def __init__(self, spec: ExperimentSpec, loss_fn: LossFn, device: torch.device,
                 mesh=None):
        from repro_torch.launch import train as _train

        self.spec = spec
        self.loss_fn = loss_fn
        self.device = device
        self.mesh = mesh
        if mesh is not None:
            for on, what in ((spec.population is not None, "virtual client populations"),
                             (spec.correction_dtype is not None,
                              "narrow corrections (correction_dtype)")):
                _require(not on, f"{what} on a mesh are not supported yet: they come with "
                                 f"{_train.MESH_LATER}")
        self.metric_fields = _train.ShardedMetrics._fields
        self._plan = spec.staleness_plan()
        self.round_fn = _train._build_sharded_round(
            loss_fn, E=spec.schedule.max_group_rounds, H=spec.schedule.local_steps,
            lr=spec.lr, algorithm=spec.algorithm, use_fused_update=spec.fusion == "fused",
            fused_mode=spec.fused_mode, client_participation=spec.client_participation,
            group_participation=spec.group_participation,
            participation_mode=spec.participation_mode,
            participation_weighting=spec.participation_weighting, plan=self._plan,
            faults=spec.faults, defense=spec.defense, compression=spec.compression, mesh=mesh)
        self._wrap_stateless()

    @property
    def microbatches(self) -> int:
        return self.spec.schedule.microbatches or 1

    @property
    def _pack_microbatches(self) -> int:
        return self.microbatches

    def init(self, params: Tree, rng: torch.Generator | None = None):
        """Broadcast one model into the ``[G, K]`` state on the engine's
        device, with the error-feedback residuals the compression plan
        carries and an async schedule's round counter, download snapshots
        and realized-download mask. A partial-participation, fault-injecting or
        stochastic-rounding run draws from the state's ``rng``; without one
        it gets a generator on the engine's device seeded with 0 (the
        reference's ``PRNGKey(0)``). On a mesh: this rank's block of that
        state (every rank passes the same params and generator state)."""
        from repro_torch.launch.train import sharded_init

        spec = self.spec
        G, K = spec.levels
        if self.mesh is not None:
            from repro_torch.sharding.state import MeshAxes

            gs, ks = MeshAxes(self.mesh).block(G, K)
            G, K = gs.stop - gs.start, ks.stop - ks.start
        comp = spec.compression if spec.compressed else None
        if rng is None and self._needs_rng():
            rng = torch.Generator(device=self.device).manual_seed(0)
        plan = self._plan
        return sharded_init(params, G, K, use_flat_state=spec.state_layout == "flat",
                            correction_dtype=spec.correction_dtype, rng=rng,
                            round_counter=plan is not None and plan.needs_round_counter,
                            staleness_snapshots=plan is not None and plan.needs_snapshots,
                            fault_download=self._fault_download(),
                            ef_client=comp is not None and comp.ef_client,
                            ef_group=comp is not None and comp.ef_group,
                            device=self.device)

    def global_model(self, state) -> Tree:
        """The global model, read from replica [0, 0] (under an async
        schedule, replica 0 of the plan's fastest group; flat states
        unpacked). On a mesh every rank calls it and gets replica [0, 0],
        broadcast from the rank that holds it."""
        g = 0 if self._plan is None else self._plan.fastest_group
        model = tree_map(lambda x: x[g, 0], state.params)
        if self.mesh is not None:
            from repro_torch.sharding.state import MeshAxes

            ax = MeshAxes(self.mesh)
            model = tree_map(lambda t: ax.broadcast_(t.clone(), "client", "group"), model)
        return as_tree(model)


_ENGINES = {"simulator": SimulatorEngine, "multilevel": MultiLevelEngine,
            "sharded": ShardedEngine}


def build(spec: ExperimentSpec, loss_fn: LossFn, *, device=None, mesh=None):
    """Validate ``spec`` and construct its backend's engine on ``device``
    (``None``: the CUDA card; a host without one raises -- pass
    ``device="cpu"``). ``mesh`` (a ``torch.distributed`` ``DeviceMesh``
    with ``group`` and ``client`` dims) runs the sharded backend's round
    over it; every rank of the mesh builds the engine alike."""
    spec = spec.validate()
    if mesh is not None:
        _require(spec.backend == "sharded", "mesh= runs the sharded backend's round; "
                 f"backend {spec.backend!r} runs on one device")
        return ShardedEngine(spec, loss_fn, resolve_device(device), mesh=mesh)
    return _ENGINES[spec.backend](spec, loss_fn, resolve_device(device))


def fit(
    engine: SimulatorEngine | MultiLevelEngine | ShardedEngine,
    data: PackedBatches,
    T: int,
    *,
    state: Tree | None = None,
    params: Tree | None = None,
    rng=None,
    chunk: int | None = None,
    eval_every: int = 1,
    eval_fn: Callable[[Tree, Tree], Tree] | None = None,
    shard_ids=None,
    draws=None,
    guard: GuardSpec | bool | None = None,
    population_store: PopulationStore | None = None,
    overlap: bool = True,
    cohorts=None,
    checkpoint_every: int | None = None,
    checkpoint_path: str | None = None,
    resume: bool = False,
) -> tuple[Tree, Horizon]:
    """Train ``T`` global rounds through the horizon driver.

    Pass either a ready ``state`` (to continue a run, with the previous
    ``horizon.data``) or the initial model ``params``. ``shard_ids``
    (``[T, E, *levels]``) fixes the per-round shard selection; otherwise it is
    drawn from ``data.generator``. ``draws`` (T ``RoundDraws``, or None
    entries) fixes rounds' random draws. ``guard`` (a ``GuardSpec``, or
    True for the defaults) makes the horizon self-heal: each chunk is
    snapshotted, checked for divergence, and rolled back and retried with
    reseeded generators (``core.driver.GuardSpec``); unless the spec says
    otherwise, retries run ``engine.retry_round_fn``, whose norm screen
    tightens by ``retry_widen`` each attempt, and ``horizon.guard`` reports
    the rollbacks and retries taken.

    With ``spec.population`` set and stateful clients, the run goes through
    ``core.population.run_population_rounds``: each chunk gathers the
    sampled cohort's corrections from a host :class:`PopulationStore`
    (``engine.init_population`` unless ``population_store`` is passed --
    pass ``horizon.population`` to continue a run; its cohort generator is
    seeded with ``rng.initial_seed()``, or 0 without ``rng``) and scatters
    them back, overlapped with the card's work unless ``overlap=False``;
    ``cohorts`` (``[ceil(T / chunk), G, K]``) injects the cohort ids. The
    store comes back on ``horizon.population``. A guard and checkpoint
    autosave are materialized-path features (the reference's rule).

    ``checkpoint_every=N`` with ``checkpoint_path=dir`` saves ``{"state",
    "data_rng"}`` (``data_rng``: ``data.generator``) through
    ``repro_torch.checkpoint`` at every chunk boundary that is a multiple of
    N rounds, and at round T (``chunk`` defaults to N). ``resume=True``
    restores the latest checkpoint in ``checkpoint_path`` (if any) and runs
    only the remaining rounds, bit for bit the uninterrupted run.

    Returns ``(state, horizon)``.
    """
    if state is None:
        _require(params is not None,
                 "fit() needs either state=... or params=... to start from")
        state = engine.init(params, rng)
    if checkpoint_every is not None or resume:
        _require(checkpoint_path is not None, "checkpoint autosave/resume needs checkpoint_path=")
    if checkpoint_every is not None:
        _require(checkpoint_every >= 1, f"checkpoint_every must be >= 1, got {checkpoint_every}")
        if chunk is None:
            chunk = checkpoint_every
    if guard is True:
        guard = GuardSpec()
    if guard and guard.round_fn_for_retry is None:
        guard = guard._replace(round_fn_for_retry=engine.retry_round_fn)

    spec = engine.spec
    if spec.population is not None and spec.client_state == "stateful":
        _require(not guard and checkpoint_every is None and not resume,
                 "guarded horizons and checkpoint autosave are materialized-path features; the "
                 "population gather/scatter loop is follow-up work")
        store = population_store
        if store is None:
            seed = 0 if rng is None else rng.initial_seed()
            store = engine.init_population(state, torch.Generator().manual_seed(seed))
        state, _, horizon = run_population_rounds(
            engine.round_fn, state, store, data, T, chunk=chunk, eval_every=eval_every,
            eval_fn=eval_fn, overlap=overlap, cohorts=cohorts, shard_ids=shard_ids, draws=draws)
        return state, horizon
    _require(cohorts is None, "cohorts= injects a virtual population's cohort draws")

    from repro_torch import checkpoint as _ckpt

    start = 0
    if resume:
        step = _ckpt.latest_step(checkpoint_path)
        if step is not None:
            restored = _ckpt.restore(checkpoint_path, step,
                                     {"state": state, "data_rng": data.generator})
            state = restored["state"]
            data.generator.set_state(restored["data_rng"].get_state())
            start = step
            _require(start < T, f"checkpoint at round {start} >= T={T}: nothing left to resume")

    on_chunk = None
    if checkpoint_every is not None:
        def on_chunk(done, st, da):
            rounds = start + done
            if rounds % checkpoint_every == 0 or rounds == T:
                _ckpt.save(checkpoint_path, rounds, {"state": st, "data_rng": da.generator})

    state, _, horizon = run_rounds(
        engine.round_fn, state, data, T - start, chunk=chunk, eval_every=eval_every,
        eval_fn=eval_fn, shard_ids=None if shard_ids is None else shard_ids[start:],
        draws=None if draws is None else draws[start:], guard=guard or None, on_chunk=on_chunk)
    return state, horizon


# ------------------------------------------------------------------- CLI


@dataclasses.dataclass(frozen=True)
class CliFlag:
    """One row of the declarative spec<->argparse table (the reference's).

    ``optional`` rows default to None on the parser and are skipped by
    :func:`spec_from_args` when unset -- for flags that override another
    row's field only when given (``--group-rounds`` over ``--E``) or whose
    spec default is None (``--max-staleness``).
    """

    field: str                     # ExperimentSpec field ("schedule.x" ok)
    flag: str                      # e.g. "--client-participation"
    help: str
    type: Callable = str
    choices: tuple | None = None
    nargs: str | None = None
    optional: bool = False

    @property
    def dest(self) -> str:
        return self.flag.lstrip("-").replace("-", "_")


def _parse_group_rounds(s: str) -> tuple[int, ...]:
    """'4,2,1' -> (4, 2, 1) -- the --group-rounds argparse type."""
    return tuple(int(part) for part in s.split(","))


def _parse_e(s: str) -> int | tuple[int, ...]:
    """'2' -> 2 and '2,1' -> (2, 1) -- the --E argparse type: a scalar E as
    in the reference, or per-group counts as its --group-rounds takes them."""
    return _parse_group_rounds(s) if "," in s else int(s)


#: The reference's table: every row maps one ExperimentSpec (or
#: RoundSchedule / plan) field to one argparse flag.
CLI_FLAGS: tuple[CliFlag, ...] = (
    CliFlag("levels", "--levels", "topology dims, e.g. --levels 2 2 (G K)",
            type=int, nargs="+"),
    CliFlag("schedule.group_rounds", "--E",
            "group aggregations per global round, or per-group counts "
            "comma-separated (e.g. 2,1: async group rounds)", type=_parse_e),
    CliFlag("schedule.group_rounds", "--group-rounds",
            "per-group async round counts, comma-separated (e.g. 4,2,1); "
            "overrides --E", type=_parse_group_rounds, optional=True),
    CliFlag("schedule.local_steps", "--H",
            "local SGD steps per group round", type=int),
    CliFlag("algorithm", "--algorithm", "HFL algorithm", choices=ALGORITHMS),
    CliFlag("lr", "--lr", "client learning rate", type=float),
    CliFlag("backend", "--backend", "round engine implementation", choices=BACKENDS),
    CliFlag("state_layout", "--state-layout",
            "state storage: contiguous flat buffers or model pytrees", choices=LAYOUTS),
    CliFlag("fusion", "--fusion",
            "route the MTGC local step through the fused CUDA kernel", choices=FUSIONS),
    CliFlag("client_participation", "--client-participation",
            "fraction of each group's clients sampled per round", type=float),
    CliFlag("group_participation", "--group-participation",
            "fraction of groups reachable per round", type=float),
    CliFlag("participation_mode", "--participation-mode",
            "Bernoulli draws or exact counts", choices=("uniform", "fixed")),
    CliFlag("participation_weighting", "--weighting",
            "masked-aggregation weighting: realized count or inverse "
            "inclusion probability (Horvitz-Thompson)",
            choices=("none", "inverse_prob")),
    CliFlag("staleness", "--staleness-policy",
            "stale-report policy for async (non-uniform) group rounds",
            choices=STALENESS_POLICIES),
    CliFlag("max_staleness", "--max-staleness",
            "bound on report staleness; groups beyond it are force-synced",
            type=int, optional=True),
    CliFlag("population", "--population",
            "virtual clients per group, backed by the host-side population "
            "store; device state stays cohort-shaped", type=int, optional=True),
    CliFlag("cohort_size", "--cohort-size",
            "sampled cohort per group -- must equal levels[1], the compiled "
            "shape (declarative alias; requires --population)", type=int, optional=True),
    CliFlag("client_state", "--client-state",
            "stateful persists per-client corrections in the population "
            "store; stateless zero-inits them every round (no store)",
            choices=CLIENT_STATES),
    CliFlag("faults.crash_rate", "--fault-crash",
            "per-(round, client) crash probability -- a crashed client "
            "does no local work and uploads nothing", type=float, optional=True),
    CliFlag("faults.timeout_rate", "--fault-timeout",
            "per-(round, group) timeout probability -- the group misses "
            "the global exchange", type=float, optional=True),
    CliFlag("faults.corrupt_rate", "--fault-corrupt",
            "per-(round, client) corrupted-upload probability", type=float, optional=True),
    CliFlag("faults.corrupt_kind", "--fault-kind",
            "corrupted-upload payload: nan/inf poison or a norm-exploded delta",
            choices=FAULT_KINDS, optional=True),
    CliFlag("defense.screen_norm", "--screen-norm",
            "screen out client deltas whose L2 norm exceeds this", type=float, optional=True),
    CliFlag("defense.clip_norm", "--clip-norm",
            "clip surviving client deltas to this L2 norm", type=float, optional=True),
    CliFlag("defense.screen_nonfinite", "--screen-nonfinite",
            "screen out non-finite client uploads (1, the plan default; 0 disables)",
            type=int, optional=True),
    CliFlag("compression.client_mode", "--compress-client",
            "client->group upload compressor", choices=COMPRESSION_MODES, optional=True),
    CliFlag("compression.group_mode", "--compress-group",
            "group->global upload compressor", choices=COMPRESSION_MODES, optional=True),
    CliFlag("compression.error_feedback", "--error-feedback",
            "carry per-link error-feedback residuals (1, the plan default; 0 disables)",
            type=int, optional=True),
    CliFlag("compression.topk_frac", "--topk-frac",
            "fraction of entries a topk link keeps per upload", type=float, optional=True),
)

#: Constructors for the nested spec fields a CLI row may target with a
#: dotted ``field`` when the spec's default for it is None.
_NESTED_FIELDS = {"schedule": RoundSchedule, "faults": FaultPlan, "defense": DefensePlan,
                  "compression": CompressionPlan}


def _spec_get(spec: ExperimentSpec, field: str):
    obj = spec
    for part in field.split("."):
        obj = getattr(obj, part)
    return obj


def add_spec_args(parser, *, defaults: ExperimentSpec | None = None,
                  exclude: tuple[str, ...] = ()) -> None:
    """Generate argparse flags for :class:`ExperimentSpec` from the table.

    ``defaults`` seeds each flag's default (so entry points can ship their
    own baseline spec); ``exclude`` drops fields an entry point pins
    (``launch.train`` pins ``backend='sharded'``).
    """
    defaults = defaults or ExperimentSpec()
    for row in CLI_FLAGS:
        if row.field in exclude or row.flag in exclude:
            continue
        if row.optional:
            default, kwargs = None, dict(help=row.help)
        else:
            default = _spec_get(defaults, row.field)
            kwargs = dict(help=f"{row.help} (default: {default})")
        if row.choices is not None:
            kwargs["choices"] = row.choices
        else:
            kwargs["type"] = row.type
        if row.nargs is not None:
            kwargs["nargs"] = row.nargs
            kwargs["type"] = row.type
        parser.add_argument(row.flag, default=default, dest=row.dest, **kwargs)


def spec_from_args(args, *, defaults: ExperimentSpec | None = None,
                   **overrides) -> ExperimentSpec:
    """Build the :class:`ExperimentSpec` an argparse namespace describes.

    ``overrides`` (field=value, including ``schedule`` shortcuts like
    ``microbatches=1``) win over CLI values. Dotted rows update the nested
    dataclass via ``dataclasses.replace``; a nested field whose spec default
    is None is built from its defaults the first time one of its flags is
    given, so ``--fault-crash 0.05`` alone yields a full ``FaultPlan``.
    """
    defaults = defaults or ExperimentSpec()
    spec_kw: dict[str, Any] = {}
    nested_kw: dict[str, dict[str, Any]] = {}
    for row in CLI_FLAGS:
        if not hasattr(args, row.dest):
            continue
        value = getattr(args, row.dest)
        if row.optional and value is None:
            continue
        target, _, sub = row.field.partition(".")
        if sub:
            nested_kw.setdefault(target, {})[sub] = value
        else:
            spec_kw[target] = value
    for name, value in overrides.items():
        if name in ("group_rounds", "local_steps", "microbatches", "periods"):
            nested_kw.setdefault("schedule", {})[name] = value
        else:
            spec_kw[name] = value
    for target, kw in nested_kw.items():
        base = getattr(defaults, target)
        if base is None:
            base = _NESTED_FIELDS[target]()
        spec_kw[target] = dataclasses.replace(base, **kw)
    return dataclasses.replace(defaults, **spec_kw)


__all__ = [
    "ALGORITHMS",
    "BACKENDS",
    "BACKEND_ALGORITHMS",
    "CLIENT_STATES",
    "CLI_FLAGS",
    "COMPRESSION_MODES",
    "CliFlag",
    "CompressionPlan",
    "DefensePlan",
    "ExperimentSpec",
    "FAULT_KINDS",
    "FUSIONS",
    "FaultPlan",
    "GuardSpec",
    "Horizon",
    "LAYOUTS",
    "MultiLevelEngine",
    "MultiLevelMetrics",
    "PackedBatches",
    "PopulationStore",
    "RoundSchedule",
    "STALENESS_POLICIES",
    "ShardedEngine",
    "SimulatorEngine",
    "add_spec_args",
    "build",
    "fit",
    "spec_from_args",
]
