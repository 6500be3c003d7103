"""Deterministic fault injection and screened-aggregation defense plans.

Port of ``src/repro/core/faults.py``. Real hierarchical deployments lose
updates three ways: clients *crash* mid-round (their update never
uploads), whole groups *time out* (the group misses its report window),
and uploads arrive *corrupted* (non-finite bits, or deltas whose norm
exploded). MTGC's corrections z and y integrate deltas over time, so one
poisoned upload would stay in the correction state for the rest of the
horizon.

* :class:`FaultPlan` declares per-round fault rates; :func:`fault_masks`
  draws one round's 0/1 masks from a ``torch.Generator`` (the reference
  draws them with ``jax.random``, whose bits PyTorch cannot reproduce, so
  the round engines also take the masks as tensors: ``RoundDraws(faults=)``).
  A disabled plan draws nothing.
* :class:`DefensePlan` declares the screen the round engines apply to
  uploads before any aggregate or correction update sees them: non-finite
  screening, an optional hard norm screen and optional norm clipping.

Fault semantics in the two-level engines (``core/engine.py``,
``launch/train.py``):

* **crash** ``[G, K]``: folds into the round's activity mask -- a crashed
  client is frozen exactly like an unsampled one (no local work, no
  upload, no z reset or update, no download).
* **timeout** ``[G]``: the group's clients run their local phases and
  group aggregations, but the group misses the global exchange: no upload
  into the global mean, no y update, no download.
* **corrupt** ``[G, K]``: at each group aggregation an active client's
  upload delta is replaced by the payload (``nan``/``inf`` added, or
  ``explode`` = the delta times ``explode_factor``). An active client
  whose upload the defense screens still downloads the group model, which
  heals it.

Every rewrite of an upload is a ``where``-select, so clean uploads keep
their exact bits.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.core import tree as tu

FAULT_KINDS = ("nan", "inf", "explode")


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Per-round fault rates, drawn i.i.d. per round (the reference's fields).

    crash_rate: P(client crashes this round) -- its update never uploads.
    timeout_rate: P(group misses its report this round).
    corrupt_rate: P(an active client's upload is corrupted this round).
    corrupt_kind: ``"nan"`` / ``"inf"`` add a non-finite constant to the
        delta; ``"explode"`` scales it by ``explode_factor`` (finite, but
        its norm explodes).
    explode_factor: the ``"explode"`` scale (> 1).
    """

    crash_rate: float = 0.0
    timeout_rate: float = 0.0
    corrupt_rate: float = 0.0
    corrupt_kind: str = "nan"
    explode_factor: float = 1e4

    @property
    def enabled(self) -> bool:
        """True when any fault kind can fire."""
        return self.crash_rate > 0 or self.timeout_rate > 0 or self.corrupt_rate > 0

    def validate(self) -> "FaultPlan":
        for name in ("crash_rate", "timeout_rate", "corrupt_rate"):
            rate = getattr(self, name)
            _require(0.0 <= rate < 1.0, f"{name} must be in [0, 1), got {rate}")
        _require(self.corrupt_kind in FAULT_KINDS,
                 f"unknown corrupt_kind {self.corrupt_kind!r} (choose from {FAULT_KINDS})")
        _require(self.explode_factor > 1.0,
                 f"explode_factor must be > 1, got {self.explode_factor}")
        return self


@dataclasses.dataclass(frozen=True)
class DefensePlan:
    """Screened aggregation of uploads (the reference's fields).

    screen_nonfinite: screen out client uploads with any non-finite entry,
        and (backstop) group reports still non-finite at the global stage.
    screen_norm: screen out a client delta with L2 norm above this (a
        non-finite norm compares False, so it is screened too). None: off.
    clip_norm: clip (not screen) finite client deltas to this L2 norm.
        None: off.
    retry_widen: each guarded-horizon retry (``core/driver.py``) rebuilds
        the round with ``screen_norm * retry_widen ** retry`` (< 1).

    Screened uploads are where-masked out of the group and global means
    (reweighted by the engines' estimators) and the z/y updates are gated
    on the same mask.
    """

    screen_nonfinite: bool = True
    screen_norm: float | None = None
    clip_norm: float | None = None
    retry_widen: float = 0.5

    @property
    def enabled(self) -> bool:
        return (self.screen_nonfinite or self.screen_norm is not None
                or self.clip_norm is not None)

    def validate(self) -> "DefensePlan":
        _require(self.screen_norm is None or self.screen_norm > 0,
                 f"screen_norm must be None or > 0, got {self.screen_norm}")
        _require(self.clip_norm is None or self.clip_norm > 0,
                 f"clip_norm must be None or > 0, got {self.clip_norm}")
        _require(0.0 < self.retry_widen < 1.0,
                 f"retry_widen must be in (0, 1), got {self.retry_widen}")
        return self


class FaultMasks(NamedTuple):
    """One round's realized faults (0/1 float32 masks, 1 = faulted)."""

    crash: torch.Tensor    # [G, K] client crashed: its update never uploads
    timeout: torch.Tensor  # [G]    group missed its report window
    corrupt: torch.Tensor  # [G, K] client upload corrupted


def fault_masks(generator: torch.Generator, plan: FaultPlan, G: int, K: int) -> FaultMasks:
    """Draw one round's fault masks on ``generator``'s device (it advances in
    place): crash, then timeout, then corrupt, each a Bernoulli draw of its
    rate; a kind whose rate is 0 draws nothing and is exact zeros, and a
    disabled plan draws nothing at all."""
    device = generator.device

    def draw(rate, shape):
        if rate <= 0:
            return torch.zeros(shape, dtype=torch.float32, device=device)
        u = torch.rand(shape, generator=generator, dtype=torch.float32, device=device)
        return (u < rate).to(torch.float32)

    return FaultMasks(crash=draw(plan.crash_rate, (G, K)),
                      timeout=draw(plan.timeout_rate, (G,)),
                      corrupt=draw(plan.corrupt_rate, (G, K)))


def payload(delta: torch.Tensor, plan: FaultPlan) -> torch.Tensor:
    """A corrupted upload's delta: ``delta * explode_factor`` or
    ``delta + nan/inf``, in the delta's dtype (the factor rounded into it
    first, as JAX's weakly typed scalar is)."""
    if plan.corrupt_kind == "explode":
        return delta * torch.tensor(plan.explode_factor, dtype=delta.dtype, device=delta.device)
    return delta + (float("nan") if plan.corrupt_kind == "nan" else float("inf"))


def corrupt_uploads(x_start, x_end, bad: torch.Tensor, plan: FaultPlan):
    """The upload view of ``x_end``: clients with ``bad != 0`` (``[G, K]``,
    corrupt mask x activity) replace their delta ``x_end - x_start`` with
    the fault payload; the others keep their exact bits."""
    corrupted = tu.tree_map(lambda xs, xe: xs + payload(xe - xs, plan), x_start, x_end)
    return tu.tree_select(bad, corrupted, x_end)


def all_finite_mask(t, lead_ndim: int) -> torch.Tensor:
    """0/1 float32 mask over the first ``lead_ndim`` axes: 1 where every
    entry of every leaf under that index is finite."""
    out = None
    for leaf in tu.tree_leaves(t):
        fin = torch.isfinite(leaf)
        if leaf.dim() > lead_ndim:
            fin = fin.reshape(tuple(leaf.shape[:lead_ndim]) + (-1,)).all(dim=-1)
        out = fin if out is None else out & fin
    return out.to(torch.float32)


def all_finite(t: torch.Tensor, piece: int = 1 << 26) -> torch.Tensor:
    """A device bool: every entry of ``t`` is finite, read ``piece`` elements
    at a time (``isfinite`` of a whole full-width buffer would form
    temporaries twice its size)."""
    flat = t.reshape(-1)
    return torch.stack([torch.isfinite(flat[s:s + piece]).all()
                        for s in range(0, max(flat.numel(), 1), piece)]).all()


def client_delta_sq_norm(delta) -> torch.Tensor:
    """[G, K] float32 squared L2 norm of each client's whole-model delta,
    summed leaf by leaf in leaf order."""
    out = None
    for leaf in tu.tree_leaves(delta):
        f = leaf.to(torch.float32)
        s = torch.sum((f * f).reshape(tuple(f.shape[:2]) + (-1,)), dim=-1)
        out = s if out is None else out + s
    return out


def screen_tests(sqn: torch.Tensor, finite: torch.Tensor | None, defense: DefensePlan):
    """The defense's verdict on each client from its float32 squared delta
    norm ``sqn`` and its all-finite flag ``finite`` (the entries', never
    derived from the norm: an ``explode`` delta with finite entries may
    overflow the float32 norm).

    Returns ``(ok, hit, scale)``: the ``[G, K]`` 0/1 survivor mask; without
    clipping ``hit = scale = None``, else the bool mask of clipped clients
    (finite norm above ``clip_norm``) and their scale
    ``c * rsqrt(max(sqn, c^2))`` (1 elsewhere)."""
    ok = torch.ones(sqn.shape, dtype=torch.float32, device=sqn.device)
    if defense.screen_nonfinite:
        ok = ok * finite
    if defense.screen_norm is not None:
        thr = torch.tensor(defense.screen_norm, dtype=torch.float32, device=sqn.device) ** 2
        # NaN/Inf squared norms compare False: screened here too.
        ok = ok * (sqn <= thr).to(torch.float32)
    if defense.clip_norm is None:
        return ok, None, None
    c = torch.tensor(defense.clip_norm, dtype=torch.float32, device=sqn.device)
    hit = torch.isfinite(sqn) & (sqn > c * c)
    scale = torch.where(hit, c * torch.rsqrt(torch.maximum(sqn, c * c)), 1.0)
    return ok, hit, scale


def screen_and_clip(x_start, x_up, defense: DefensePlan):
    """Apply the defense to one group round's uploads.

    Returns ``(x_up', ok)``: the (possibly clipped) upload view and the
    ``[G, K]`` 0/1 survivor mask, which callers AND into the activity mask.
    Clipping rewrites only clipped clients (``where``-select), so the other
    uploads keep their exact bits."""
    delta = tu.tree_sub(x_up, x_start)
    sqn = client_delta_sq_norm(delta)
    finite = all_finite_mask(x_up, 2) if defense.screen_nonfinite else None
    ok, hit, scale = screen_tests(sqn, finite, defense)
    if hit is not None:
        x_clip = tu.tree_map(
            lambda xs, d: xs + tu.expand_mask(scale, d).to(d.dtype) * d, x_start, delta)
        x_up = tu.tree_select(hit.to(torch.float32), x_clip, x_up)
    return x_up, ok
