"""Cost budgets: the audited chunks' counted work, pinned to disk (port of
``src/repro/analysis/budgets.py``).

For every audit case, the cost counter (``launch/cost_analysis.py``) counts
the FLOPs, bytes and collective bytes of one recorded driver chunk. Those
numbers are checked into ``analysis/budgets.json`` with a relative
tolerance band; a lost fusion, a doubled pass or a fattened collective then
fails the audit before any benchmark runs.

The count is of the ops PyTorch dispatches, so the file records the torch
version and the device it was counted on. The count does not depend on the
route (a hand kernel counts its ``cost(...)`` whether it ran its plain
version on the CPU or its kernel on the card; a copy from the host to the
card is ``transfer_bytes``, not ``bytes``), so a card run counts what the
CPU stamp holds: :func:`check_route` holds it there to ``ROUTE_RTOL``. The
drift check is a band for changes of the code; on a mismatched stamp it
degrades to notes (severity ``"note"``) unless forced
(``--strict-budgets``).
Refresh with::

    python -m repro_torch.launch.audit --update
"""
from __future__ import annotations

import json
from pathlib import Path

import torch

from repro_torch.analysis.invariants import Finding

BUDGET_PATH = Path(__file__).with_name("budgets.json")
METRICS = ("flops", "bytes", "collective_bytes")
DEFAULT_RTOL = 0.2
# A count taken on another route (the card) against the CPU's stamp: the
# same ops of the same shapes, so equal but for the float sums' rounding.
ROUTE_RTOL = 1e-9


def measure(lc) -> dict[str, float]:
    """The counted work of one recorded chunk (the whole chunk)."""
    c = lc.costs
    return {"flops": float(c.flops), "bytes": float(c.bytes),
            "collective_bytes": float(c.collective_bytes)}


def load(path: Path | str = BUDGET_PATH) -> dict:
    path = Path(path)
    if not path.exists():
        return {}
    return json.loads(path.read_text())


def save(measured: dict[str, dict[str, float]], path: Path | str = BUDGET_PATH,
         rtol: float = DEFAULT_RTOL, device: str = "cpu") -> dict:
    doc = {
        "torch": torch.__version__,
        "device": device,
        "rtol": rtol,
        "specs": {name: {k: round(v, 3) for k, v in m.items()}
                  for name, m in sorted(measured.items())},
    }
    Path(path).write_text(json.dumps(doc, indent=1) + "\n")
    return doc


def environment_matches(doc: dict, device: str = "cpu") -> bool:
    return doc.get("torch") == torch.__version__ and doc.get("device") == device


def check(measured: dict[str, dict[str, float]], doc: dict | None = None, *,
          strict: bool | None = None, complete: bool = True,
          device: str = "cpu") -> list[Finding]:
    """Compare measured costs to the checked-in budgets.

    ``strict=None`` enforces only when the budget file was stamped with
    this torch version and ``device``; pass ``strict=True``/``False`` to
    force either mode.
    """
    doc = load() if doc is None else doc
    if not doc:
        return [Finding(name, "budget", "no budgets.json checked in (run audit --update)",
                        "note") for name in sorted(measured)]
    if strict is None:
        strict = environment_matches(doc, device)
    severity = "error" if strict else "note"
    rtol = float(doc.get("rtol", DEFAULT_RTOL))
    budgets = doc.get("specs", {})
    out: list[Finding] = []
    if not strict:
        out.append(Finding(
            "*", "budget",
            f"budgets stamped torch {doc.get('torch')}/{doc.get('device')}, running torch "
            f"{torch.__version__}/{device}: drift reported but not enforced", "note"))
    for name in sorted(measured):
        ref = budgets.get(name)
        if ref is None:
            out.append(Finding(name, "budget", "no budget entry (run audit --update)",
                               severity))
            continue
        for metric in METRICS:
            got, want = measured[name][metric], float(ref.get(metric, 0.0))
            tol = rtol * max(abs(want), 1.0)
            if abs(got - want) > tol:
                out.append(Finding(
                    name, "budget",
                    f"{metric} drifted: measured {got:.6g}, budget {want:.6g} "
                    f"(|delta| {abs(got - want):.6g} > {rtol:.0%} band {tol:.6g})", severity))
    stale = sorted(set(budgets) - set(measured)) if complete else []
    if stale:
        out.append(Finding("*", "budget", f"stale budget entries (cases gone): {stale}", "note"))
    return out


def check_route(measured: dict[str, dict[str, float]], doc: dict | None = None,
                rtol: float = ROUTE_RTOL) -> list[Finding]:
    """Hold counts taken on another route (the card) to the stamp's, every
    metric within ``rtol``: errors, whatever the stamp's device or torch
    version, for every case the stamp holds."""
    doc = load() if doc is None else doc
    budgets = doc.get("specs", {})
    out: list[Finding] = []
    for name in sorted(measured):
        ref = budgets.get(name)
        if ref is None:
            out.append(Finding(name, "budget-route", "no budget entry to hold the count to"))
            continue
        for metric in METRICS:
            got, want = measured[name][metric], float(ref.get(metric, 0.0))
            if abs(got - want) > rtol * max(abs(want), 1.0):
                out.append(Finding(
                    name, "budget-route",
                    f"{metric} counted {got:.12g} on this route, {want:.12g} in the "
                    f"{doc.get('device')} stamp: the count depends on the route"))
    return out
