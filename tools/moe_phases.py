#!/usr/bin/env python3
"""Run the moe family's phases of ``chip_smoke.py`` alone on one NVIDIA card.

    python3 tools/moe_phases.py

Run from the root of a checkout on a host with a CUDA card and the CUDA
toolkit. It builds the four libraries the moe paths use (``moe_dispatch``,
the two flash attention sources, ``mtgc_update``), runs the card tests of
the moe kernels (``pytest tests/test_torch_cuda.py -k moe``), then
``chip_smoke.py``'s phase 12c (the dispatch, combine and gate-gradient
kernels against their plain versions, timed), (f4) (granite-moe-1b-a400m
served at full width: 4 x 2048 prompt tokens, 32 generated), (w1) (one
flat + fused sharded round of granite at full width and all 24 layers,
warm-up, timed and traced) and (w3) (a reduced granite round on the card
against the CPU), with each phase's checks. It prints the card's name and
power limit first and the seconds after each phase, and writes every
number to ``chiprun_out/moe_phases.json``. About two minutes of command
on an H100.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
import chip_smoke as cs  # noqa: E402  (the card harness and its phases)


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("moe_phases.py: no CUDA device is available", file=sys.stderr)
        return 2
    from repro_torch import convert
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_dispatch as md
    from repro_torch.kernels import rwkv6_scan as rw
    from repro_torch.kernels import ssm_scan as ss

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    cs.log(cs.device_line())
    built = build.build_all(("moe_dispatch", "flash_attention", "flash_attention_bwd",
                             "mtgc_update"))
    cs.log(f"build {built['seconds']:.1f} s")
    tests = subprocess.run([sys.executable, "-m", "pytest", "-q", "tests/test_torch_cuda.py",
                            "-k", "moe", "-p", "no:cacheprovider"], cwd=ROOT,
                           env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    cs.require(tests.returncode == 0, "the moe card tests failed")
    cs.log(f"card tests passed, {time.perf_counter() - t0:.1f} s")
    errs, times = cs.phase_moe_kernels(torch, md, built["log"])
    cs.log(f"phase 12c done, {time.perf_counter() - t0:.1f} s")
    serve = cs.phase_serve(torch, np, cs.MOE_ARCH, lambda: cs.serve_launches(fa, rw, ss, md))
    cs.log(f"(f4) done, {time.perf_counter() - t0:.1f} s")
    w1 = cs.phase_lm_train(torch, np, "flat", rounds=1, trace=True, tag="w1", arch=cs.MOE_ARCH,
                           layers=cs.MOE_LAYERS)
    cs.log(f"(w1) done, {time.perf_counter() - t0:.1f} s")
    w3 = cs.phase_lm_train_card_vs_cpu(torch, np, convert, arch=cs.MOE_ARCH)
    cs.log(f"(w3) done, {time.perf_counter() - t0:.1f} s")
    out = Path("chiprun_out")
    out.mkdir(exist_ok=True)
    (out / "moe_phases.json").write_text(json.dumps(
        {"device": cs.device_line(), "kernels": {"max_abs_err": errs, "times": times},
         "f4": serve, "w1": w1, "w3": w3}, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
