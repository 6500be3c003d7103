"""The port's auditor: ``python -m repro_torch.launch.audit`` (port of
``src/repro/launch/audit.py``).

Builds every representative :class:`repro_torch.api.ExperimentSpec`
through ``build(spec)`` and records one driver chunk of each with
``Engine.lower_chunk`` -- run on tiny tensors, on the CPU or the card
(``--device``) -- then gates (see ``repro_torch.analysis``):

1. invariants: the state in place (or no second copy), no unlisted host
   sync on the card, no float64, ``correction_dtype`` end to end, and the
   kernel-call contract (calls; on the card launches and the profiler's
   kernels too);
2. the generator lint over ``src/repro_torch``;
3. cost budgets against ``analysis/budgets.json`` (FLOPs / bytes /
   collective bytes of the cost counter, within a tolerance band);
4. the comm model: every compressed link must shrink the modeled upload
   bytes (``core/compression.py``).

Usage::

    python -m repro_torch.launch.audit --fast            # the blocking subset
    python -m repro_torch.launch.audit                   # the full matrix
    python -m repro_torch.launch.audit --update          # regenerate budgets.json
    python -m repro_torch.launch.audit --device cuda --strict-budgets
    python -m repro_torch.launch.audit --report out.json
    python -m repro_torch.launch.audit --cases sim_mtgc_flat_fused --list

Exit status is nonzero exactly when an error-severity finding remains.
Budget drift is enforced only when ``budgets.json`` was stamped with this
torch version and device (``--strict-budgets`` enforces it anywhere).
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path


def _lint_roots() -> list[Path]:
    """The port's package directory."""
    import repro_torch

    return [Path(repro_torch.__file__).resolve().parent]


def _check_comm_model(case, params):
    """Modeled per-upload wire bytes of every active compressed link; an
    error finding for any link that fails to shrink below uncompressed."""
    import torch

    from repro_torch.analysis.invariants import Finding
    from repro_torch.core import compression as cmp
    from repro_torch.core.tree import tree_map

    plan = case.spec.compression
    stacked = tree_map(lambda p: torch.empty(tuple(case.spec.levels) + tuple(p.shape),
                                             dtype=p.dtype, device="meta"), params)
    sizes = cmp.model_leaf_sizes(stacked)
    base = cmp.upload_bytes(sizes, "none")
    model = {"uncompressed_upload_bytes": base}
    findings = []
    for link, mode in (("client", plan.client_mode), ("group", plan.group_mode)):
        if mode == "none":
            continue
        got = cmp.upload_bytes(sizes, mode, plan.topk_frac)
        model[f"{link}_upload_bytes"] = got
        if got >= base:
            findings.append(Finding(
                case.name, "comm-budget",
                f"{link} link mode {mode!r} models {got:.0f} bytes per upload, not smaller "
                f"than uncompressed {base:.0f}"))
    return model, findings


def audit_case(case, device: str = "cpu") -> tuple[dict, list, object]:
    """Record one case's chunk and check it: ``(program, findings, lc)``."""
    from repro_torch.analysis import budgets, invariants
    from repro_torch.analysis.specs import abstract_data, abstract_params

    engine = case.build_engine(device=device)
    params = abstract_params()
    lc = engine.lower_chunk(abstract_data(engine), params=params)
    findings = invariants.run_invariants(case, lc)
    findings += invariants.check_retrace(case.name)
    measure = budgets.measure(lc)
    program = {
        "kernel_calls": sum(lc.calls.values()),
        "expected_calls": case.expected_calls,
        "kernel_launches": sum(lc.launches.values()),
        "profiled_launches": None if lc.profiled is None else sum(lc.profiled.values()),
        "calls_by_wrapper": invariants.nonzero_counts(lc.calls),
        "expected_by_wrapper": case.expected_by_wrapper,
        "launches_by_wrapper": invariants.nonzero_counts(lc.launches),
        "profiled_by_wrapper": None if lc.profiled is None else invariants.nonzero_counts(lc.profiled),
        "state_leaves": len(lc.shared),
        "in_place_leaves": sum(lc.shared),
        "kept": lc.kept,
        "syncs": None if lc.syncs is None else [list(s) if s else None for s in lc.syncs],
        "ops": len(lc.ops),
        **measure,
    }
    if case.spec.compressed:
        # Modeled comm budget: every compressed link must shrink the
        # per-upload wire bytes against uncompressed (one card has no
        # collectives to measure, so the wire model is the auditable
        # quantity).
        model, comm_findings = _check_comm_model(case, params)
        program["comm_model"] = model
        findings += comm_findings
    return program, findings, lc


def run_audit(fast: bool = False, case_names: list[str] | None = None, update: bool = False,
              strict_budgets: bool | None = None, budget_path: Path | None = None,
              verbose: bool = True, device: str = "cpu") -> dict:
    """Run every pass; returns the report dict."""
    import torch

    from repro_torch.analysis import budgets, invariants, keys
    from repro_torch.analysis.specs import audit_cases, case_by_name

    t0 = time.time()
    cases = [case_by_name(n) for n in case_names] if case_names else audit_cases(fast_only=fast)

    findings: list = []
    measured: dict[str, dict[str, float]] = {}
    programs: dict[str, dict] = {}
    for case in cases:
        if verbose:
            print(f"[audit] recording {case.name} on {device} ...", flush=True)
        program, found, _ = audit_case(case, device)
        findings += found
        programs[case.name] = program
        measured[case.name] = {m: program[m] for m in budgets.METRICS}

    # -- the generator lint over the port's source tree
    roots = _lint_roots()
    key_findings = keys.lint_paths(roots)
    for f in keys.unsuppressed(key_findings):
        findings.append(invariants.Finding("keys", f.rule, f"{f.path}:{f.line}: {f.message}"))

    # -- budgets: regenerate or drift-check
    budget_path = budget_path or budgets.BUDGET_PATH
    if update:
        budgets.save(measured, budget_path, device=device)
        if verbose:
            print(f"[audit] wrote {len(measured)} budgets -> {budget_path}")
    else:
        doc = budgets.load(budget_path)
        findings += budgets.check(measured, doc, strict=strict_budgets,
                                  complete=not (fast or case_names), device=device)

    errors = [f for f in findings if f.severity == "error"]
    notes = [f for f in findings if f.severity != "error"]
    return {
        "torch": torch.__version__,
        "device": device,
        "mode": "update" if update else "fast" if fast else "full",
        "cases": sorted(c.name for c in cases),
        "programs": programs,
        "lint": {
            "roots": [str(r) for r in roots],
            "files": sum(len(list(Path(r).rglob("*.py"))) for r in roots),
            "suppressed": [str(f) for f in key_findings if f.suppressed],
        },
        "errors": [str(f) for f in errors],
        "notes": [str(f) for f in notes],
        "elapsed_s": round(time.time() - t0, 2),
        "ok": not errors,
    }


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.audit", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--fast", action="store_true", help="the blocking subset of the matrix")
    ap.add_argument("--cases", default=None, help="comma-separated case names (see --list)")
    ap.add_argument("--update", action="store_true",
                    help="regenerate analysis/budgets.json from this run")
    ap.add_argument("--strict-budgets", action="store_true",
                    help="enforce budget drift even on a mismatched torch version/device")
    ap.add_argument("--budget-file", default=None, help="alternate budgets.json path")
    ap.add_argument("--report", default=None, help="write the full JSON report here")
    ap.add_argument("--list", action="store_true", dest="list_cases",
                    help="list audit case names and exit")
    ap.add_argument("--device", default="cpu", choices=("cpu", "cuda"),
                    help="where the chunks run (cuda adds launches, the profiler's count "
                         "and the host-sync watch)")
    ap.add_argument("-q", "--quiet", action="store_true")
    args = ap.parse_args(argv)

    if args.list_cases:
        from repro_torch.analysis.specs import audit_cases
        for c in audit_cases():
            print(f"{c.name:32s} fast={c.fast} backend={c.spec.backend} "
                  f"layout={c.spec.state_layout} fusion={c.spec.fusion} "
                  f"expected_calls={c.expected_calls}")
        return 0
    if args.update and args.fast:
        ap.error("--update needs the full matrix (drop --fast)")

    report = run_audit(
        fast=args.fast, case_names=args.cases.split(",") if args.cases else None,
        update=args.update, strict_budgets=True if args.strict_budgets else None,
        budget_path=Path(args.budget_file) if args.budget_file else None,
        verbose=not args.quiet, device=args.device)
    if args.report:
        out = Path(args.report)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(report, indent=1))
    if not args.quiet:
        for line in report["notes"]:
            print(f"[audit] note: {line}")
    for line in report["errors"]:
        print(f"[audit] FAIL: {line}")
    status = "ok" if report["ok"] else f"{len(report['errors'])} errors"
    print(f"[audit] {len(report['cases'])} cases, {report['mode']} mode, {report['device']}, "
          f"{report['elapsed_s']}s: {status}")
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
