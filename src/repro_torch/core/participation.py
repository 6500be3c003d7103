"""Per-round participation sampling (port of ``src/repro/core/participation.py``).

Under partial participation each global round draws 0/1 float masks: which
groups are reachable and which clients are active (already gated by their
group). Inactive replicas keep their params and corrections frozen, and
every aggregation becomes a masked mean (``core.tree``).

Weighting (``participation_weighting``): ``"none"`` divides masked
aggregations by the realized participant count; ``"inverse_prob"`` divides
by the expected count ``inclusion_prob * n`` (a Horvitz-Thompson
estimator). Under ``fixed`` sampling the two coincide.

Draws come from a ``torch.Generator``, which cannot reproduce the
reference's ``jax.random`` bits: the parity tests compute the masks with
the reference's ``round_masks`` and hand them to the round function.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

MODES = ("uniform", "fixed")
WEIGHTINGS = ("none", "inverse_prob")


class ParticipationMasks(NamedTuple):
    """0/1 float32 masks for one global round.

    group:  [G]    -- group j is reachable this round.
    client: [G, K] -- client (j, i) is active (already gated by its group).
    """

    group: torch.Tensor
    client: torch.Tensor


def fixed_count(frac: float, n: int) -> int:
    """Participants per parent under 'fixed' sampling: the nearest count,
    half up, and never zero."""
    return max(1, int(frac * n + 0.5))


def inclusion_prob(frac: float, n: int, mode: str) -> float:
    """Per-unit inclusion probability of :func:`sample_axis_mask`:
    ``frac`` under 'uniform', ``fixed_count(frac, n) / n`` under 'fixed'."""
    if frac >= 1.0:
        return 1.0
    if mode == "uniform":
        return float(frac)
    if mode == "fixed":
        return fixed_count(frac, n) / n
    raise ValueError(f"unknown participation mode {mode!r}")


def sample_axis_mask(generator: torch.Generator, shape: tuple, frac: float, mode: str,
                     device=None) -> torch.Tensor:
    """0/1 float32 mask of ``shape``; the last axis is the sampled population.

    'uniform': independent Bernoulli(frac) per entry (a row may come up
    empty). 'fixed': exactly ``fixed_count(frac, shape[-1])`` ones per row,
    uniformly without replacement (rank the uniform draws and threshold).
    ``frac >= 1`` draws nothing.
    """
    device = generator.device if device is None else device
    if frac >= 1.0:
        return torch.ones(shape, dtype=torch.float32, device=device)
    u = torch.rand(shape, generator=generator, dtype=torch.float32, device=device)
    if mode == "uniform":
        return (u < frac).to(torch.float32)
    if mode == "fixed":
        k = fixed_count(frac, shape[-1])
        rank = torch.argsort(torch.argsort(u, dim=-1), dim=-1)
        return (rank < k).to(torch.float32)
    raise ValueError(f"unknown participation mode {mode!r}")


def sample_hfl_masks(generator: torch.Generator, num_groups: int, clients_per_group: int,
                     client_frac: float, group_frac: float,
                     mode: str = "uniform") -> ParticipationMasks:
    """Two-level masks: group availability gates every client under it.
    The group mask is drawn first, then the client mask."""
    gmask = sample_axis_mask(generator, (num_groups,), group_frac, mode)
    cmask = sample_axis_mask(generator, (num_groups, clients_per_group), client_frac,
                             mode) * gmask[:, None]
    return ParticipationMasks(group=gmask, client=cmask)


def round_masks(generator: torch.Generator, cfg) -> ParticipationMasks:
    """The masks for the upcoming round, drawn from a state's ``rng``
    (which advances in place)."""
    return sample_hfl_masks(generator, cfg.num_groups, cfg.clients_per_group,
                            cfg.client_participation, cfg.group_participation,
                            cfg.participation_mode)
