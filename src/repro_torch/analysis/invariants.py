"""Invariants of a recorded driver chunk (port of
``src/repro/analysis/invariants.py``).

Every check here reads a :class:`repro_torch.core.driver.LoweredChunk` --
one driver chunk of ``CHUNK`` rounds that ``trace_chunk`` ran under a
recorder -- and returns :class:`Finding`\\ s instead of raising, so the
audit CLI reports the whole matrix in one run. The checks keep the
reference's names, so the two reports line up:

* **donation** -- the state stays in place. The sharded backend writes its
  state in place (ROADMAP queue 3 item 8(a)), so every leaf of its output
  state must share storage with its input leaf. The simulator and
  multilevel engines return a new state; for them no tensor of the input
  state may still be alive when the chunk ends (weak references, after a
  collection), unless the output holds it. A leaf still alive means the
  driver holds a second copy of the state: the regression the reference's
  alias check guards.
* **host-sync** -- on the card, the chunk runs under
  ``torch.cuda.set_sync_debug_mode("warn")`` and each synchronization is
  attributed to the port's file, line, function and source text. The
  known sites of ROADMAP queue 1 item 4 (the sharded round's host copies
  of masks and flags) are :data:`KNOWN_SYNCS`, by file, function and text,
  and are reported as notes; any other site is an error. On the CPU the
  check is one note.
* **f64** -- any op whose output is ``float64`` or ``complex128`` is an
  error naming the op and its scope.
* **correction-dtype** -- z and y carry ``spec.correction_dtype`` in the
  input state and in the output state.
* **fusion** -- the kernel wrappers' ``calls`` over the chunk equal the
  case's ``expected_by_wrapper``, wrapper by wrapper; on the card their
  ``launches`` do too, and so does ``torch.profiler``'s count of their
  ``__global__`` functions (``kernels/ops.py::KERNEL_NAMES``).
* **retrace** -- eager PyTorch keeps no trace cache, so there is nothing
  to miss: a note naming ROADMAP queue 1 item 4 (a captured chunk), where
  a cache would come back.
"""
from __future__ import annotations

import dataclasses

import torch

# The host synchronizations ROADMAP queue 1 item 4 lists: (file under
# src/repro_torch, function, the call's source text) -> what the sharded
# round copies to the host there. A sync matches an entry when its frame is
# in that file and function (the innermost named one: a generator
# expression's is the function around it) and its line holds the text, so
# the table does not move with edits elsewhere in the file. They stay,
# reported as notes, until that item makes the round host-free.
KNOWN_SYNCS = {
    ("launch/train.py", "round_fn", "torch.cat(host).cpu().numpy()"):
        "the activity and report masks (one host copy a round)",
    ("launch/train.py", "round_fn", "bad.cpu().numpy()"): "the corrupted uploads' rows",
    ("launch/train.py", "screen", "smask.cpu().numpy()"): "the screen's surviving clients",
    ("launch/train.py", "screen", "has_srv.cpu().numpy()"):
        "the screen's groups with a survivor",
    ("launch/train.py", "screen", "hit.cpu().numpy()"): "the screen's clipped clients",
    ("launch/train.py", "agree", "torch.equal(t3[g, k], t3[g, ks[0]])"):
        "the phase-start model's agreement test (torch.equal)",
    ("launch/train.py", "round_fn", "gact.cpu().numpy()"): "the merging groups",
    ("launch/train.py", "round_fn", "dm.cpu().numpy()"): "the download rows",
    ("launch/train.py", "round_fn", "gfin.cpu().numpy()"): "the finite reports (async)",
}
KNOWN_SYNCS_ITEM = "ROADMAP queue 1 item 4 (host-free round chunks)"

_WIDE = (torch.float64, torch.complex128)


@dataclasses.dataclass(frozen=True)
class Finding:
    """One audit violation (or skip note, when ``severity == "note"``)."""

    case: str
    check: str
    message: str
    severity: str = "error"

    def __str__(self) -> str:
        return f"[{self.case}] {self.check}: {self.message}"


def _leaves(state) -> list:
    from repro_torch.core.driver import _state_tensors

    return _state_tensors(state)


def check_donation(case: str, lc) -> list[Finding]:
    """The sharded state updated in place; no other state kept alive."""
    if not lc.donate:
        return [Finding(case, "donation", "chunk recorded with donate=False", "note")]
    from repro_torch.launch.train import ShardedHFLState

    if isinstance(lc.out_state, ShardedHFLState):
        moved = [i for i, s in enumerate(lc.shared) if not s]
        if not moved:
            return []
        leaves = _leaves(lc.state)
        descr = ", ".join(f"leaf {i} ({str(leaves[i].dtype).removeprefix('torch.')}"
                          f"{list(leaves[i].shape)})" for i in moved)
        return [Finding(case, "donation",
                        f"{len(moved)}/{len(lc.shared)} state leaves of the sharded round did "
                        f"not stay in place: {descr}")]
    if not lc.kept:
        return []
    return [Finding(case, "donation",
                    f"{len(lc.kept)} input state tensors outlived the chunk (a second copy "
                    f"of the state): {', '.join(lc.kept)}")]


def known_sync(site) -> str | None:
    """What a known sync site copies (:data:`KNOWN_SYNCS`), else None; a
    site is ``(file, line, function, source text)``."""
    if site is None:
        return None
    path, _, func, text = site
    for (kpath, kfunc, ktext), what in KNOWN_SYNCS.items():
        if path == kpath and func == kfunc and ktext in text:
            return what
    return None


def check_host_sync(case: str, lc) -> list[Finding]:
    """Every host synchronization of the chunk is a known one."""
    if lc.syncs is None:
        return [Finding(case, "host-sync",
                        f"not watched on {lc.device.type}: the sync check needs a card "
                        "(torch.cuda.set_sync_debug_mode)", "note")]
    out, seen = [], {}
    for site in lc.syncs:
        site = None if site is None else tuple(site)
        seen[site] = seen.get(site, 0) + 1
    for site, n in seen.items():
        where = "outside the port" if site is None else \
            f"{site[0]}:{site[1]} ({site[2]}: {site[3]!r})"
        what = known_sync(site)
        if what is not None:
            out.append(Finding(case, "host-sync",
                               f"{where} x{n}: {what}; {KNOWN_SYNCS_ITEM}", "note"))
        else:
            out.append(Finding(case, "host-sync",
                               f"unlisted host synchronization at {where} x{n}"))
    return out


def check_no_f64(case: str, lc) -> list[Finding]:
    """No op of the chunk produces float64 or complex128."""
    out = []
    for rec in lc.ops:
        wide = sorted({str(d).removeprefix("torch.") for d, _ in rec.outputs if d in _WIDE})
        if wide:
            out.append(Finding(case, "f64",
                               f"{rec.name} produces {'/'.join(wide)} (scope {rec.scope})"))
    return out


def _correction_leaves(state) -> list:
    from repro_torch.core.tree import tree_leaves

    picked = [getattr(state, f) for f in ("z", "y") if getattr(state, f, None) is not None]
    return [t for p in picked for t in tree_leaves(p)]


def check_correction_dtype(case: str, lc, spec) -> list[Finding]:
    """z/y leaves carry ``spec.correction_dtype`` on the way in AND out."""
    want = spec.correction_dtype
    if want is None:
        return []
    out = []
    for side, state in (("input", lc.state), ("output", lc.out_state)):
        leaves = _correction_leaves(state)
        if not leaves:
            out.append(Finding(case, "correction-dtype",
                               f"{side} state has no z/y leaves to check"))
            continue
        bad = sorted({str(x.dtype).removeprefix("torch.") for x in leaves
                      if str(x.dtype).removeprefix("torch.") != want})
        if bad:
            out.append(Finding(case, "correction-dtype",
                               f"{side} state z/y leaves are {bad}, spec says {want!r}"))
    return out


def check_fusion(case: str, lc, expected: dict) -> list[Finding]:
    """The wrappers' calls (and, on the card, launches and the profiler's
    kernels) over the chunk equal ``expected``, wrapper by wrapper."""
    want = nonzero_counts(expected)
    kind = "fused" if want else "unfused"
    out = []
    if nonzero_counts(lc.calls) != want:
        out.append(Finding(case, "fusion",
                           f"{kind} spec made {sum(lc.calls.values())} kernel-route calls "
                           f"({nonzero_counts(lc.calls)}), expected {sum(want.values())} ({want})"))
    if lc.device.type == "cuda":
        if nonzero_counts(lc.launches) != want:
            out.append(Finding(case, "fusion",
                               f"{kind} spec launched {sum(lc.launches.values())} kernels "
                               f"({nonzero_counts(lc.launches)}), expected {sum(want.values())} "
                               f"({want})"))
        if lc.profiled is None:
            out.append(Finding(case, "fusion", "no profiler count recorded",
                               "note"))
        elif nonzero_counts(lc.profiled) != want:
            out.append(Finding(case, "fusion",
                               f"{kind} spec: torch.profiler saw {sum(lc.profiled.values())} "
                               f"kernels ({nonzero_counts(lc.profiled)}), expected "
                               f"{sum(want.values())} ({want})"))
    return out


def nonzero_counts(counts: dict) -> dict:
    """``counts`` without its zero entries (wrappers a chunk never called)."""
    return {k: v for k, v in counts.items() if v}


def check_retrace(case: str) -> list[Finding]:
    """Eager PyTorch has no trace cache to miss (see the module note)."""
    return [Finding(case, "retrace",
                    "eager PyTorch keeps no trace cache; a captured chunk comes with "
                    f"{KNOWN_SYNCS_ITEM}", "note")]


def run_invariants(case, lc) -> list[Finding]:
    """All per-chunk invariant checks for one audited case."""
    out = []
    out += check_donation(case.name, lc)
    out += check_host_sync(case.name, lc)
    out += check_no_f64(case.name, lc)
    out += check_correction_dtype(case.name, lc, case.spec)
    out += check_fusion(case.name, lc, case.expected_by_wrapper)
    return out
