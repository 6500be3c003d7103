#!/usr/bin/env python3
"""Time variants of the selective scan's kernel on one NVIDIA card.

    python3 tools/ssm_scan_variants.py

Run from the root of a checkout on a host with a CUDA card and the CUDA
toolkit. ``src/repro_torch/kernels/csrc/ssm_scan.cu`` runs four threads a
(b, di) chain, loads four tokens ahead and takes its decays from
``ex2.approx``. This script builds the same source with one choice changed
at a time -- two threads a chain (eight states each), two or eight tokens
ahead, ``expf`` decays -- beside the shipped library, checks each against
``selective_scan_ref`` at hymba-1.5b's prefill shape (u [4, 2048, 3200]
bfloat16, S = 16, a nonzero state; within 1e-5 of max|y| and max|h|, as
``chip_smoke.py`` holds the shipped kernel), and times a call of each by
CUDA events, twice in turns (each variant forward, then in reverse). It
prints the card's name and power limit, each variant's registers and
spills (``ptxas -v``), and as its last line one JSON object with every
number.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
import chip_smoke  # noqa: E402  (the card harness: cuda_ms, device_line, scan_inputs)

NAME = "ssm_scan"
SHAPE = (4, 2048, 3200, 16)          # hymba-1.5b's prefill: B, T, Di, S
LANES = "constexpr int kLanes = 4;"
AHEAD = "constexpr int kAhead = 4;"
EXP2 = ("exp2_approx(cd[i] * a[j])", " * kLog2e : 0.f;")
VARIANTS = {
    "lanes2": [(LANES, "constexpr int kLanes = 2;")],
    "ahead2": [(AHEAD, "constexpr int kAhead = 2;")],
    "ahead8": [(AHEAD, "constexpr int kAhead = 8;")],
    "expf": [(EXP2[0], "expf(cd[i] * a[j])"), (EXP2[1], " : 0.f;")],
}


def build_variants(build) -> tuple[dict, dict]:
    """The shipped library and every variant's, built side by side (one
    nvcc each, all started together); returns ({name: path}, {name: ptxas
    lines of its kernels})."""
    build.build_all((NAME,))
    paths = {"shipped": build.library_path(NAME)}
    src = (build.CSRC / f"{NAME}.cu").read_text()
    out_dir = build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"variant {name}: {old!r} is not in csrc/{NAME}.cu")
            text = text.replace(old, new)
        cu = out_dir / f"{NAME}-{name}.cu"
        cu.write_text(text)
        paths[name] = out_dir / f"lib{NAME}-{name}.so"
        procs[name] = subprocess.Popen(
            [build.nvcc_path(), *build.nvcc_flags(NAME), "-o", str(paths[name]), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    ptxas = {}
    for name, proc in procs.items():
        text = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{text}")
        ptxas[name] = [f"{e}: {r}; {s}" for e, r, s in chip_smoke.ptxas_entries(text)]
    return paths, ptxas


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("ssm_scan_variants.py: no CUDA device is available", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    from repro_torch.kernels import ssm_scan as ss

    smi = chip_smoke.device_line()
    chip_smoke.log(smi)
    chip_smoke.log(f"toolkit: {build.toolkit_version()}")
    paths, ptxas = build_variants(build)
    for name, lines in ptxas.items():
        for line in lines:
            chip_smoke.log(f"  {name}: {line}")
    B, T, Di, S = SHAPE
    gen = torch.Generator(device="cuda").manual_seed(24)
    args = chip_smoke.scan_inputs(torch, gen, B, T, Di, S, torch.bfloat16)
    want = ss.selective_scan_ref(*args)
    y = torch.empty((B, T, Di), dtype=torch.float32, device="cuda")
    s_out = torch.empty((B, Di, S), dtype=torch.float32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    result = {"device": smi, "shape": list(SHAPE), "variants": {}}
    launches = {}
    for name, path in paths.items():
        lib = ctypes.CDLL(str(path))
        lib.selective_scan_launch.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        lib.selective_scan_launch.restype = ctypes.c_int

        def launch(lib=lib, name=name):
            err = lib.selective_scan_launch(*(a.data_ptr() for a in args), y.data_ptr(),
                                            s_out.data_ptr(), B, T, Di, S, 1, stream)
            chip_smoke.require(err == 0, f"{name}: CUDA error {err} at launch")

        launch()
        torch.cuda.synchronize()
        rel = max((y - want[0]).abs().max().item() / want[0].abs().max().item(),
                  (s_out - want[1]).abs().max().item() / want[1].abs().max().item())
        chip_smoke.require(rel <= 1e-5, f"{name} differs from the plain version: {rel}")
        launches[name] = launch
        result["variants"][name] = {"rel_err": rel, "ptxas": ptxas.get(name), "ms_readings": []}
    order = list(launches)
    for sweep in (order, order[::-1]):
        for name in sweep:
            result["variants"][name]["ms_readings"].append(
                chip_smoke.cuda_ms(torch, launches[name], iters=20))
    for name, v in result["variants"].items():
        v["ms"] = sum(v["ms_readings"]) / len(v["ms_readings"])
        chip_smoke.log(f"{name}: {v['ms']:.4f} ms a call {v['ms_readings']}, within "
                       f"{v['rel_err']:.3g} of the plain version's largest entry")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
