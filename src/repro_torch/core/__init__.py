"""repro_torch.core -- MTGC and its HFL baselines, in PyTorch.

New code builds experiments through the front door, ``repro_torch.api``
(``ExperimentSpec`` -> ``build`` -> ``fit``); the names below are the
low-level surface the reference's ``repro.core`` exports, each from the
port's own modules (the ``make_*_round`` entry points are shims over the
api's engines).

  HFLConfig, HFLState, hfl_init, make_global_round, global_model
  ScaffoldState, scaffold_init, make_scaffold_round
  MultiLevelState, multilevel_init, make_multilevel_round
  Packer, FlatBuffers, make_packer, as_tree (flat-state plumbing)
  PackedBatches, run_rounds, make_round_step (the horizon driver)
  PopulationStore, run_population_rounds, stateless_round (virtual clients)
  FaultPlan, DefensePlan, GuardSpec (fault injection, self-healing horizon)
"""
from repro_torch.core.api import ALGORITHMS
from repro_torch.core.config import HFLConfig
from repro_torch.core.driver import (
    GuardReport,
    GuardSpec,
    Horizon,
    PackedBatches,
    dispatch_chunk,
    make_round_step,
    pack_client_shards,
    pack_lm_shards,
    run_rounds,
    select_round,
)
from repro_torch.core.engine import (
    HFLState,
    RoundMetrics,
    global_model,
    hfl_init,
    make_global_round,
)
from repro_torch.core.faults import (
    FAULT_KINDS,
    DefensePlan,
    FaultMasks,
    FaultPlan,
    fault_masks,
)
from repro_torch.core.multilevel import (
    MultiLevelState,
    make_multilevel_round,
    multilevel_global_model,
    multilevel_init,
)
from repro_torch.core.packer import FlatBuffers, Packer, as_tree, is_flat, make_packer
from repro_torch.core.participation import ParticipationMasks, round_masks, sample_hfl_masks
from repro_torch.core.population import (
    PopulationStore,
    draw_cohort,
    population_fields,
    run_population_rounds,
    stateless_round,
)
from repro_torch.core.scaffold import ScaffoldState, make_scaffold_round, scaffold_init

__all__ = [
    "ALGORITHMS",
    "HFLConfig",
    "FlatBuffers",
    "Packer",
    "as_tree",
    "is_flat",
    "make_packer",
    "ParticipationMasks",
    "round_masks",
    "sample_hfl_masks",
    "HFLState",
    "RoundMetrics",
    "global_model",
    "hfl_init",
    "make_global_round",
    "FAULT_KINDS",
    "DefensePlan",
    "FaultMasks",
    "FaultPlan",
    "fault_masks",
    "GuardReport",
    "GuardSpec",
    "Horizon",
    "PackedBatches",
    "dispatch_chunk",
    "make_round_step",
    "pack_client_shards",
    "pack_lm_shards",
    "run_rounds",
    "select_round",
    "PopulationStore",
    "draw_cohort",
    "population_fields",
    "run_population_rounds",
    "stateless_round",
    "MultiLevelState",
    "make_multilevel_round",
    "multilevel_global_model",
    "multilevel_init",
    "ScaffoldState",
    "make_scaffold_round",
    "scaffold_init",
]
