"""Async group rounds: the static staleness plan behind both engines.

Port of ``src/repro/core/staleness.py``. A heterogeneous per-group round
count ``(E_1, ..., E_G)`` plus a staleness policy becomes the static
quantities the simulator and sharded rounds need:

* **Padded inner loop**: every global round ("window") runs
  ``e_pad = max(E_g)`` group rounds; group g is live only at iterations
  ``e < E_g`` (:meth:`StalenessPlan.iteration_mask`, a ``[e_pad, G]``
  numpy constant). A dead iteration freezes the group's replicas exactly
  like a participation mask.
* **Report cadence**: under an async policy group g reports (uploads its
  group model and downloads the global one) every
  ``r_g = ceil(e_pad / E_g)`` windows, ``tau_g = r_g - 1`` aggregations
  stale; ``max_staleness`` caps ``r_g`` at ``max_staleness + 1``. The
  per-window report and fresh masks are functions of the round counter t.
* **Stale-merge policy**: ``"sync"`` (every group reports every window),
  ``"naive"`` (stale reports at full weight), ``"discount"`` (weight
  ``1 / (1 + tau)`` in the merge only; y updates at full rate) and
  ``"delay_compensated"`` (a report shifted by ``glob - snap_g``, the
  global progress its group missed; the state carries ``snap``/``glob``).

A reporting group's y increment is ``(xbar_g - xbar) / (H * E_g * r_g *
lr)``. :func:`make_plan` returns None for a uniform schedule under
``"sync"``: the engines then run their sync round unchanged.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

#: Stale-merge policies accepted by ``ExperimentSpec.staleness``.
STALENESS_POLICIES = ("sync", "naive", "discount", "delay_compensated")


@dataclasses.dataclass(frozen=True)
class StalenessPlan:
    """Static async-round quantities for one two-level experiment.

    group_rounds: per-group E_g, one entry per group.
    policy: one of :data:`STALENESS_POLICIES`.
    max_staleness: bound on tau_g; groups whose cadence would exceed it
        are force-synced every ``max_staleness + 1`` windows.
    """

    group_rounds: tuple[int, ...]
    policy: str = "sync"
    max_staleness: int | None = None

    def __post_init__(self):
        object.__setattr__(self, "group_rounds", tuple(int(e) for e in self.group_rounds))
        if self.policy not in STALENESS_POLICIES:
            raise ValueError(f"unknown staleness policy {self.policy!r} "
                             f"(choose from {STALENESS_POLICIES})")
        if any(e < 1 for e in self.group_rounds):
            raise ValueError(f"group_rounds must be >= 1: {self.group_rounds}")
        if self.max_staleness is not None and self.max_staleness < 1:
            raise ValueError(f"max_staleness must be None or >= 1, got {self.max_staleness}")

    # ------------------------------------------------------------- static

    @property
    def num_groups(self) -> int:
        return len(self.group_rounds)

    @property
    def e_pad(self) -> int:
        """Padded inner-loop length: max(E_g) group rounds per window."""
        return max(self.group_rounds)

    @property
    def periods(self) -> tuple[int, ...]:
        """Report cadence r_g in windows (1 = reports every window)."""
        if self.policy == "sync":
            return (1,) * self.num_groups
        rs = tuple(math.ceil(self.e_pad / e) for e in self.group_rounds)
        if self.max_staleness is not None:
            rs = tuple(min(r, self.max_staleness + 1) for r in rs)
        return rs

    @property
    def staleness(self) -> tuple[int, ...]:
        """tau_g: global aggregations a group's report is behind by."""
        return tuple(r - 1 for r in self.periods)

    @property
    def effective_rounds(self) -> tuple[int, ...]:
        """Group rounds a group runs per report cycle (the y divisor)."""
        return tuple(e * r for e, r in zip(self.group_rounds, self.periods))

    @property
    def needs_round_counter(self) -> bool:
        """True when report/fresh masks depend on the round counter t."""
        return any(r > 1 for r in self.periods)

    @property
    def needs_snapshots(self) -> bool:
        """True when the state must carry snap/glob (delay compensation)."""
        return self.policy == "delay_compensated"

    @property
    def fastest_group(self) -> int:
        """A group with r_g = 1: its replicas hold the fresh global model
        between windows (where an async state's global model is read)."""
        return int(np.argmax(np.asarray(self.group_rounds)))

    def iteration_mask(self) -> np.ndarray:
        """[e_pad, G] float32: group g is live at inner iteration e < E_g."""
        e = np.arange(self.e_pad)[:, None]
        return (e < np.asarray(self.group_rounds)[None, :]).astype(np.float32)

    def discount_weights(self) -> np.ndarray:
        """[G] float32 stale-merge weights (1/(1+tau) under 'discount')."""
        if self.policy == "discount":
            return (1.0 / (1.0 + np.asarray(self.staleness))).astype(np.float32)
        return np.ones(self.num_groups, np.float32)

    # ---------------------------------------------------- per window (t)

    def _cadence(self, t: torch.Tensor, shift: int) -> torch.Tensor:
        t = torch.as_tensor(t)
        if not self.needs_round_counter:
            return torch.ones(self.num_groups, dtype=torch.float32, device=t.device)
        r = torch.tensor(self.periods, dtype=torch.int32, device=t.device)
        return ((t.to(torch.int32) + shift) % r == 0).to(torch.float32)

    def report_mask(self, t) -> torch.Tensor:
        """[G] float32 0/1 on ``t``'s device: group g reports (uploads and
        downloads) at window ``t`` (the 0-based int32 round counter). A group
        of cadence r reports at windows r-1, 2r-1, ...; constant ones when
        no cadence exceeds 1."""
        return self._cadence(t, 1)

    def fresh_mask(self, t) -> torch.Tensor:
        """[G] float32 0/1: group g starts window ``t`` from a fresh download
        (it reported at the end of window t-1; everyone is fresh at t = 0),
        so its z restarts this window."""
        return self._cadence(t, 0)


def make_plan(group_rounds, num_groups: int, policy: str = "sync",
              max_staleness: int | None = None) -> StalenessPlan | None:
    """The plan for a schedule, or None for the uniform sync schedule.

    ``group_rounds`` is a scalar E or a per-group tuple; a uniform schedule
    under ``"sync"`` returns None, so callers run the sync round.
    """
    if isinstance(group_rounds, (list, tuple)):
        vec = tuple(int(e) for e in group_rounds)
        if len(vec) != num_groups:
            raise ValueError(f"per-group group_rounds needs one entry per group: {len(vec)} "
                             f"entries for {num_groups} groups")
    else:
        vec = (int(group_rounds),) * num_groups
    uniform = all(e == vec[0] for e in vec)
    if uniform and policy == "sync":
        if max_staleness is not None:
            raise ValueError("max_staleness only bounds async (non-sync) staleness policies")
        return None
    return StalenessPlan(group_rounds=vec, policy=policy, max_staleness=max_staleness)
