#!/usr/bin/env python3
"""Time hymba-1.5b's training round (phase (y1)) on two checkouts in turns
on one NVIDIA card.

    python3 tools/hybrid_ab.py PARENT_DIR [--rounds 2]

Run from the root of a checkout (the change) on a host with a CUDA card and
the CUDA toolkit. PARENT_DIR is another checkout to compare with, such as
the parent commit unpacked by ``git archive`` into a directory that
``.gitignore`` lists (``build/parent``). Each run is a process of its own in
its checkout: it builds the libraries that hybrid training launches, then
runs that checkout's ``chip_smoke.phase_lm_train`` for (y1) (hymba-1.5b at
full width and all 32 layers, flat + fused, 2 x 2 clients: a warm-up round,
one timed round whose launch counts are checked, one traced round). The
runs go parent, change, change, parent, ... so that a drift of the host or
the card falls on both. It prints the card's name and power limit, one
line a run with the timed round, the busy share of the traced one, the
hand-written kernels' launches a round and the selective scan's device time
by direction, and writes every run's numbers to
``chiprun_out/hybrid_ab.json``. Fails if any run fails. About two minutes a
run on an H100, the first run of each checkout longer for its builds.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# The libraries hybrid training launches, built side by side before the run.
LIBRARIES = ("flash_attention", "flash_attention_bwd", "ssm_scan", "ssm_scan_bwd", "mtgc_update")
KEYS = ("warmup_round_ms", "round_ms", "busy_share", "busy_ms", "selective_scan_ms",
        "selective_scan_share", "gemm_share", "flash_bwd_share", "peak_gb", "launches")


def run_one(root: Path, out: Path) -> int:
    """(y1) in the checkout at ``root``, with that checkout's harness."""
    sys.path[:0] = [str(root / "src"), str(root)]
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    built = build.build_all(LIBRARIES)
    y1 = cs.phase_lm_train(torch, np, "flat", rounds=1, trace=True, tag="y1",
                           arch=cs.HYBRID_TRAIN_ARCH, layers=cs.HYBRID_TRAIN_LAYERS)
    res = {k: y1.get(k) for k in KEYS}
    res.update(build_s=built["seconds"], seconds=time.perf_counter() - t0)
    out.write_text(json.dumps(res, default=str))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent", type=Path, nargs="?")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--one", type=Path, help=argparse.SUPPRESS)   # a run's JSON, in its checkout
    args = ap.parse_args()
    if args.one:
        return run_one(Path.cwd(), args.one)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs

    if args.parent is None or not (args.parent / "chip_smoke.py").is_file():
        print(f"hybrid_ab.py: {args.parent} is not a checkout with chip_smoke.py", file=sys.stderr)
        return 2
    parent = args.parent.resolve()
    cs.log(cs.device_line())
    order = []
    for i in range(args.rounds):
        pair = [("parent", parent), ("change", ROOT)]
        order += pair if i % 2 == 0 else pair[::-1]
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    runs = []
    for i, (tag, where) in enumerate(order):
        res = out / f"hybrid_ab_{i}_{tag}.json"
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--one", str(res)],
                              cwd=where, capture_output=True, text=True)
        (out / f"hybrid_ab_{i}_{tag}.log").write_text(proc.stdout + proc.stderr)
        cs.require(proc.returncode == 0, f"run {i} ({tag}) failed with exit {proc.returncode}; "
                   f"its log: chiprun_out/hybrid_ab_{i}_{tag}.log")
        runs.append({"run": i, "tag": tag, **json.loads(res.read_text())})
        r = runs[-1]
        cs.log(f"run {i} {tag} ({r['seconds']:.1f} s, builds {r['build_s']:.1f} s): (y1) "
               f"warm-up {r['warmup_round_ms']:.1f} ms, round {r['round_ms']:.1f} ms, busy share "
               f"{r['busy_share']:.3f} of the traced round ({r['busy_ms']:.1f} ms busy), "
               f"selective scan {r['selective_scan_ms']} ms, peak {r['peak_gb']:.2f} GB, "
               f"launches {r['launches']}")
        (out / "hybrid_ab.json").write_text(json.dumps(runs, default=str))
    for tag in ("parent", "change"):
        ms = [r["round_ms"] for r in runs if r["tag"] == tag]
        cs.log(f"{tag}: (y1) rounds {ms} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
