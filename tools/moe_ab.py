#!/usr/bin/env python3
"""Run the moe phases on two checkouts in turns on one NVIDIA card.

    python3 tools/moe_ab.py PARENT_DIR [--rounds 2]

Run from the root of a checkout (the change) on a host with a CUDA card and
the CUDA toolkit. PARENT_DIR is another checkout to compare with, such as
the parent commit unpacked by ``git archive`` into a directory that
``.gitignore`` lists (``build/parent``). Each round runs
``tools/moe_phases.py`` -- the card tests of the moe kernels, phase 12c of
``chip_smoke.py`` (the dispatch, combine and gate-gradient kernels checked
and timed), (f4), (w1) and (w3) -- once in each checkout, in the order
parent, change, change, parent, ... so that a drift of the card's state
falls on both. Each run is a process of its own and builds its own
libraries. It prints the card's name and power limit, one line a run with
the kernels' times (training, prefill and, where the run has it, decode
shape; ``index_select`` and ``embedding_bag`` beside them), (f4)'s prefill
and (w1)'s round time, and writes every run's ``moe_phases.json`` to
``chiprun_out/moe_ab.json``. Fails if any run fails.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
import chip_smoke as cs  # noqa: E402  (device_line, log)


def summary(phases: dict) -> dict:
    """The numbers of one run that the comparison reads."""
    times = phases["kernels"]["times"]
    out = {}
    for name in ("moe_gather", "moe_combine", "moe_gate_grad"):
        t = times[name]
        # ms is the wrapper called eagerly; graph_ms, where a revision has
        # it, the device time from a CUDA graph over operands in HBM.
        out[name] = {"training_eager": t["ms"], "training_graph": t.get("graph_ms"),
                     "library": t.get("library_ms"),
                     "library_graph": t.get("library_graph_ms")}
        for shape in ("prefill", "decode"):
            s = t.get(f"{shape}_shape")
            if s:
                out[name][f"{shape}_eager"] = s["ms"]
                out[name][f"{shape}_graph"] = s.get("graph_ms")
                out[name][f"{shape}_library"] = s.get("library_ms")
    out["f4_prefill_ms"] = phases["f4"].get("prefill_ms")
    out["w1_round_ms"] = phases["w1"].get("round_ms")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent", type=Path)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    parent = args.parent.resolve()
    if not (parent / "tools" / "moe_phases.py").is_file():
        print(f"moe_ab.py: {parent} holds no tools/moe_phases.py", file=sys.stderr)
        return 2
    cs.log(cs.device_line())
    order = []
    for i in range(args.rounds):
        pair = [("parent", parent), ("change", ROOT)]
        order += pair if i % 2 == 0 else pair[::-1]
    runs = []
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    for i, (tag, where) in enumerate(order):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "tools/moe_phases.py"], cwd=where,
                              capture_output=True, text=True)
        (out / f"moe_ab_{i}_{tag}.log").write_text(proc.stdout + proc.stderr)
        cs.require(proc.returncode == 0, f"run {i} ({tag}) failed with exit {proc.returncode}; "
                   f"its log: chiprun_out/moe_ab_{i}_{tag}.log")
        phases = json.loads((where / "chiprun_out" / "moe_phases.json").read_text())
        runs.append({"run": i, "tag": tag, "seconds": time.perf_counter() - t0,
                     "summary": summary(phases), "phases": phases})
        cs.log(f"run {i} {tag} ({runs[-1]['seconds']:.1f} s): "
               f"{json.dumps(runs[-1]['summary'], default=str)}")
        (out / "moe_ab.json").write_text(json.dumps(runs, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
