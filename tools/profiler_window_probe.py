"""Where ``torch.profiler`` places the card's kernels against the host's
clock as a process ages, and whether a short trace keeps every kernel: the
question behind ``core/driver.py::_TRACE_PAD_S``.

Every ``--every`` seconds for ``--seconds``, two traces (one with no pad,
one with ``--pad`` seconds of idle host time at each end) each record
``--kernels`` launches of one element-wise kernel, 1 ms apart, each stamped
with the host's clock (``time.time_ns``) just before its launch. For each
trace the script records how many kernels the profiler kept, and the
median, first and last of (the kernel's start in the trace, on the trace's
clock, minus its launch on the host's). Then it runs the audit matrix's
fused cases through ``trace_chunk`` and records their profiled counts
against their expected ones.

    PYTHONPATH=src python tools/profiler_window_probe.py --seconds 360 \\
        --out build/profiler_window_probe.json
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path


def one_trace(torch, x, kernels: int, pad: float) -> dict:
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    launched = []
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(pad)
        for _ in range(kernels):
            launched.append(time.time_ns())
            x.add_(1.0)
            time.sleep(0.001)
        torch.cuda.synchronize()
        time.sleep(pad)
    start_ns = prof.profiler.kineto_results.trace_start_ns()
    seen = sorted(start_ns + int(ev.time_range.start * 1000) for ev in prof.events()
                  if str(getattr(ev, "device_type", "")).endswith("CUDA")
                  and "elementwise" in ev.name)
    out = {"pad_s": pad, "launched": kernels, "kept": len(seen)}
    if len(seen) == kernels:
        offsets = [(s - h) / 1e6 for s, h in zip(seen, launched)]
        out.update(offset_ms_median=statistics.median(offsets), offset_ms_first=offsets[0],
                   offset_ms_last=offsets[-1])
    elif seen:
        # Which end was lost: the kept kernels' offsets against the first
        # and against the last launches.
        out.update(offset_ms_if_first_kept=(seen[0] - launched[0]) / 1e6,
                   offset_ms_if_last_kept=(seen[-1] - launched[-1]) / 1e6)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seconds", type=float, default=360.0)
    ap.add_argument("--every", type=float, default=15.0)
    ap.add_argument("--kernels", type=int, default=20)
    ap.add_argument("--pad", type=float, default=None,
                    help="idle host time at each end of the padded trace "
                         "(default: core/driver.py::_TRACE_PAD_S)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("profiler_window_probe.py: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
    from repro_torch.core import driver

    pad = driver._TRACE_PAD_S if args.pad is None else args.pad
    x = torch.zeros(1 << 20, device="cuda")
    t0 = time.perf_counter()
    rows = []
    while True:
        age = time.perf_counter() - t0
        row = {"age_s": age, "bare": one_trace(torch, x, args.kernels, 0.0),
               "padded": one_trace(torch, x, args.kernels, pad)}
        rows.append(row)
        print(json.dumps(row), flush=True)
        if age >= args.seconds:
            break
        time.sleep(max(0.0, args.every - (time.perf_counter() - t0 - age)))

    from repro_torch.analysis import invariants, specs

    chunks = {}
    for case in specs.audit_cases():
        if not case.expected_calls:
            continue
        engine = case.build_engine(device="cuda")
        lc = engine.lower_chunk(specs.abstract_data(engine), params=specs.abstract_params())
        chunks[case.name] = {"expected": case.expected_by_wrapper,
                             "profiled": invariants.nonzero_counts(lc.profiled),
                             "launches": invariants.nonzero_counts(lc.launches)}
    report = {"device": torch.cuda.get_device_name(0), "pad_s": pad,
              "process_s": time.perf_counter() - t0, "traces": rows, "chunks": chunks}
    print(json.dumps({"chunks": chunks, "process_s": report["process_s"]}), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
