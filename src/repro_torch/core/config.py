"""Configuration for hierarchical-FL training runs (the paper's setting).

A copy of ``src/repro/core/config.py``: the port imports nothing of the JAX
package, so the two dataclasses are kept field for field alike.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class HFLConfig:
    """Two-level HFL topology + algorithm knobs (paper notation).

    Attributes:
      num_groups:        N  -- number of group aggregators.
      clients_per_group: n  -- clients under each group aggregator (uniform
                              n_j = n; the weighted case folds coefficients
                              into F_i as in the paper, Sec. 2.1).
      local_steps:       H  -- local SGD iterations per group round.
      group_rounds:      E  -- group aggregations per global round.
      lr:                gamma.
      algorithm:         one of core.algorithms.ALGORITHMS.
      correction_init:   'zero' (paper's experiments, footnote 2) or
                         'gradient' (paper's theoretical initialization).
      prox_mu:           FedProx proximal coefficient (only used by fedprox).
      feddyn_alpha:      FedDyn regularization coefficient.
      server_lr:         aggregator-side learning rate (1.0 = plain average,
                         kept for beyond-paper experimentation).
      client_participation: C_k -- fraction of each group's clients sampled
                         per global round (1.0 = the paper's full
                         participation).
      group_participation:  C_g -- fraction of groups reachable per global
                         round; a skipped group freezes all of its clients
                         and its y_j for the round.
      participation_mode: 'uniform' (independent Bernoulli draws) or 'fixed'
                         (exactly the nearest count max(1, floor(C*n + 0.5))
                         participants -- half-up, never banker's rounding;
                         see participation.fixed_count -- sampled without
                         replacement).
      participation_weighting: 'none' divides masked aggregations by the
                         *realized* participant count; 'inverse_prob'
                         divides by the *expected* count (Horvitz-Thompson:
                         ``inclusion_prob * n`` per level, the group level
                         composing ``group_participation``), which keeps the
                         group/global aggregates -- and the averages the
                         z/y corrections track -- unbiased under Bernoulli
                         sampling at the cost of variance. The two coincide
                         under 'fixed' sampling and at full participation
                         (see core/participation.py).
      use_fused_update:  route the MTGC local step through the fused CUDA
                         kernel (kernels/mtgc_update.py); its plain version
                         on CPU tensors. Only valid for algorithm='mtgc'.
                         Combined with ``use_flat_state`` the whole model
                         is one batched kernel call with the participation
                         mask folded in.
      use_flat_state:    store params/z/dyn as contiguous ``[G, K, N]``
                         buffers (one per dtype) and ``y`` as ``[G, N]``
                         (see core/packer.py). The round hot path then runs
                         as a handful of whole-model ops instead of
                         per-leaf dispatch; ``hfl_init`` returns a
                         FlatBuffers-state and the round function adapts to
                         whichever state layout it is traced with. Default
                         on (the simulator engine's flat/tree parity is
                         covered by tests/test_flat_state.py).
    """

    num_groups: int = 2
    clients_per_group: int = 2
    local_steps: int = 5
    group_rounds: int = 2
    lr: float = 0.1
    algorithm: str = "mtgc"
    correction_init: str = "zero"
    prox_mu: float = 0.0
    feddyn_alpha: float = 0.0
    server_lr: float = 1.0
    client_participation: float = 1.0
    group_participation: float = 1.0
    participation_mode: str = "uniform"
    participation_weighting: str = "none"
    use_fused_update: bool = False
    use_flat_state: bool = True

    @property
    def total_clients(self) -> int:
        return self.num_groups * self.clients_per_group

    @property
    def full_participation(self) -> bool:
        return self.client_participation >= 1.0 and self.group_participation >= 1.0

    def validate(self) -> "HFLConfig":
        """Raise ``ValueError`` on an invalid config (never ``assert``:
        asserts vanish under ``python -O``, silently accepting bad configs;
        ``ExperimentSpec.validate`` mirrors these checks)."""
        def require(cond: bool, msg: str) -> None:
            if not cond:
                raise ValueError(msg)

        require(self.num_groups >= 1 and self.clients_per_group >= 1,
                f"topology dims must be >= 1, got G={self.num_groups} "
                f"K={self.clients_per_group}")
        require(self.local_steps >= 1 and self.group_rounds >= 1,
                f"schedule must be >= 1 step/round, got H={self.local_steps} "
                f"E={self.group_rounds}")
        require(self.correction_init in ("zero", "gradient"),
                f"correction_init must be 'zero' or 'gradient', "
                f"got {self.correction_init!r}")
        require(0.0 < self.client_participation <= 1.0,
                f"client_participation must be in (0, 1], "
                f"got {self.client_participation}")
        require(0.0 < self.group_participation <= 1.0,
                f"group_participation must be in (0, 1], "
                f"got {self.group_participation}")
        require(self.participation_mode in ("uniform", "fixed"),
                f"participation_mode must be 'uniform' or 'fixed', "
                f"got {self.participation_mode!r}")
        require(self.participation_weighting in ("none", "inverse_prob"),
                f"participation_weighting must be 'none' or 'inverse_prob', "
                f"got {self.participation_weighting!r}")
        require(not (self.use_fused_update and self.algorithm != "mtgc"),
                "use_fused_update fuses exactly g + z + y: mtgc only")
        return self
