#!/usr/bin/env python3
"""Build variants of the selective scan's forward kernel on one NVIDIA card,
hold them against the shipped kernel bit for bit and time them.

    python3 tools/ssm_scan_variants.py [--source NAME=PATH ...]

Run from the root of a checkout on a host with a CUDA card and the CUDA
toolkit. It builds, side by side (one nvcc each, all started together):

* ``shipped``: ``src/repro_torch/kernels/csrc/ssm_scan.cu`` as the port
  builds it (four threads a chain, a ring of 4 stages of 16 tokens filled by
  cp.async, the decays of 8 tokens formed together, one-warp blocks of 8
  chains);
* ``lanes2``, ``tile32s2``, ``group4``: the same source with two threads a
  chain (16 chains a block), 2 ring stages of 32 tokens (and states every
  32 tokens, which this tool does not read), or the decays of 4 tokens
  formed together;
* each ``--source NAME=PATH``: another ``ssm_scan.cu`` with the same
  ``selective_scan_launch`` entry point, such as the first design's
  (``git show eaa80de:src/repro_torch/kernels/csrc/ssm_scan.cu``).

The shipped kernel is held against ``selective_scan_ref`` within 1e-5 of
max|y| and of max|h| (as ``chip_smoke.py`` holds it), then every other
build against the shipped kernel's outputs bit for bit, at hymba-1.5b's
prefill shape (u [4, 2048, 3200], S = 16) and training shape (u [1, 2048,
3200]) with u in bf16 and in float32, and at ``chip_smoke.py``'s ragged
shapes. It times each build at the prefill and training shapes (u bf16)
twice in turns (every build forward, then in reverse), each from a CUDA
graph of calls over operand sets that together move four times the L2
cache (``chip_smoke.graph_ms``, ``cold_copies``), and records each build's
registers and spills (``ptxas -v``) and its SASS counts of MUFU.EX2 and
LDGSTS. It also measures the card's rate of ``ex2.approx`` (``tools/sfu_rate.cu``:
every thread 8 independent chains of 2^-x, at 8 blocks of 256 threads an SM
and at one warp an SM), the floor that the scan's one ex2 a (b, t, di, s)
sets. It prints the card's name and power limit first, writes everything
to ``chiprun_out/ssm_scan_variants.json`` and prints one JSON object as its
last line. Exits 1 if a build's outputs differ from the shipped kernel's
at any shape.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
import chip_smoke as cs  # noqa: E402  (the card harness: graph_ms, scan_inputs, ...)

NAME = "ssm_scan"
VARIANTS = {
    "shipped": [],
    "lanes2": [("constexpr int kLanes = 4;", "constexpr int kLanes = 2;")],
    "tile32s2": [("constexpr int kTile = 16;", "constexpr int kTile = 32;"),
                 ("constexpr int kStages = 4;", "constexpr int kStages = 2;"),
                 ("constexpr int kChunk = 16;", "constexpr int kChunk = 32;")],
    "group4": [("constexpr int kGroup = 8;", "constexpr int kGroup = 4;")],
}
PREFILL = (cs.LM_BATCH, cs.LM_PROMPT, cs.HYMBA_DI, cs.HYMBA_S)
TRAINING = (cs.LM_TRAIN_BATCH, cs.LM_TRAIN_SEQ, cs.HYMBA_DI, cs.HYMBA_S)
P, I32 = ctypes.c_void_p, ctypes.c_int


def build_libraries(build, others: dict) -> tuple[dict, dict]:
    """Every library, built side by side; returns ({name: path}, {name:
    nvcc output})."""
    src = (build.CSRC / f"{NAME}.cu").read_text()
    out_dir = build.BUILD_DIR / "ssm_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    sources = dict(others)
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"variant {name}: {old!r} is not in csrc/{NAME}.cu")
            text = text.replace(old, new)
        sources[name] = out_dir / f"{NAME}-{name}.cu"
        sources[name].write_text(text)
    procs, paths = {}, {}
    for name, cu in sources.items():
        paths[name] = out_dir / f"lib{NAME}-{name}.so"
        procs[name] = subprocess.Popen(
            [build.nvcc_path(), *build.nvcc_flags(NAME), f"-I{build.CSRC}", "-o",
             str(paths[name]), str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    logs = {}
    for name, proc in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{logs[name]}")
    return paths, logs


def open_library(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    lib.selective_scan_launch.argtypes = [P] * 9 + [I32] * 5 + [P]
    lib.selective_scan_launch.restype = I32
    return lib


def launcher(torch, name, lib, args, y, s_out):
    """A launch of ``lib`` on ``args`` into (y, s_out), returning y."""
    B, T, Di = args[0].shape
    S = args[2].shape[-1]
    bf16 = int(args[0].dtype == torch.bfloat16)

    def call():
        err = lib.selective_scan_launch(*(a.data_ptr() for a in args), y.data_ptr(),
                                        s_out.data_ptr(), B, T, Di, S, bf16,
                                        torch.cuda.current_stream().cuda_stream)
        cs.require(err == 0, f"{name}: CUDA error {err} at launch")
        return y

    return call


def sfu_rate(torch, build) -> dict:
    """The card's ex2.approx rate from ``tools/sfu_rate.cu``, a second and a
    second an SM, at 8 blocks of 256 threads an SM and at one warp an SM."""
    cu = ROOT / "tools" / "sfu_rate.cu"
    so = build.BUILD_DIR / "ssm_variants" / "libsfu_rate.so"
    so.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([build.nvcc_path(), *build.nvcc_flags(NAME), "-o", str(so), str(cu)],
                          capture_output=True, text=True)
    cs.require(proc.returncode == 0, f"nvcc failed on tools/sfu_rate.cu:\n{proc.stdout}"
                                     f"{proc.stderr}")
    lib = ctypes.CDLL(str(so))
    lib.sfu_rate_launch.argtypes = [P, I32, I32, I32, P]
    lib.sfu_rate_launch.restype = I32
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {"sms": sms}
    for tag, per_sm, threads, iters in (("full", 8, 256, 4096), ("one_warp", 1, 32, 4096)):
        blocks = sms * per_sm
        res = torch.empty(blocks * threads, device="cuda")

        def run():
            cs.require(lib.sfu_rate_launch(res.data_ptr(), blocks, threads, iters,
                                           torch.cuda.current_stream().cuda_stream) == 0,
                       "sfu_rate: CUDA error at launch")

        ms = cs.cuda_ms(torch, run, iters=5, warmup=2)
        rate = blocks * threads * iters * lib.sfu_rate_chains() / ms * 1e3
        out[tag] = {"ms": ms, "ex2_per_s": rate, "ex2_per_s_per_sm": rate / sms}
        cs.log(f"ex2.approx ({tag}: {per_sm} x {threads} threads an SM): {rate:.4g} a second, "
               f"{rate / sms:.4g} a second an SM ({ms:.4f} ms)")
    return out


def sass_ops(path: Path, build) -> dict:
    sass = cs.sass_text(path, build)
    return {op: sum(1 for line in sass.splitlines() if op in line)
            for op in ("MUFU.EX2", "LDGSTS", "SHFL")}


def source_arg(text: str) -> tuple[str, Path]:
    name, _, path = text.partition("=")
    if not name or not path or name in VARIANTS:
        raise argparse.ArgumentTypeError(f"want NAME=PATH with a new NAME, got {text!r}")
    return name, Path(path)


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", type=source_arg, action="append", default=[],
                    help="another ssm_scan.cu to build, check and time as NAME")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("ssm_scan_variants.py: no CUDA device is available", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    from repro_torch.kernels import ssm_scan as ss

    smi = cs.device_line()
    cs.log(smi)
    cs.log(f"toolkit: {build.toolkit_version()}; L2 {cs.l2_bytes(torch)} bytes")
    result_sfu = sfu_rate(torch, build)
    paths, logs = build_libraries(build, dict(opts.source))
    libs = {name: open_library(path) for name, path in paths.items()}
    result = {"device": smi, "sfu": result_sfu, "builds": {}, "shapes": {}, "same_bits": True}
    for name, path in paths.items():
        entries = [f"{e}: {r}; {s}" for e, r, s in cs.ptxas_entries(logs[name])]
        result["builds"][name] = {"ptxas": entries, "sass": sass_ops(path, build)}
        cs.log(f"{name}: {entries}; SASS {result['builds'][name]['sass']}")
    gen = torch.Generator(device="cuda").manual_seed(128)
    shapes = [("prefill", PREFILL, torch.bfloat16, 0.0),
              ("prefill/f32", PREFILL, torch.float32, 0.0),
              ("training", TRAINING, torch.bfloat16, 0.0),
              ("training/f32", TRAINING, torch.float32, 0.0)]
    shapes += [(f"ragged {B}x{T}x{Di} S{S} shift {sh} {str(dt).removeprefix('torch.')}",
                (B, T, Di, S), dt, sh)
               for B, T, Di, S, sh in ((2, 1, 37, 16, 0.0), (2, 37, 37, 16, 0.0),
                                       (1, 2049, 37, 16, -3.0), (3, 50, 33, 5, 0.0),
                                       (2, 300, 64, 16, -6.0))
               for dt in (torch.bfloat16, torch.float32)]
    for tag, (B, T, Di, S), udtype, shift in shapes:
        args = cs.scan_inputs(torch, gen, B, T, Di, S, udtype, shift)
        want = ss.selective_scan_ref(*args)
        outs = {}
        for name, lib in libs.items():
            y = torch.empty((B, T, Di), dtype=torch.float32, device="cuda")
            s_out = torch.empty((B, Di, S), dtype=torch.float32, device="cuda")
            launcher(torch, name, lib, args, y, s_out)()
            outs[name] = (y, s_out)
        torch.cuda.synchronize()
        ref = outs["shipped"]
        rel = max((g - w).abs().max().item() / w.abs().max().item() for g, w in zip(ref, want))
        cs.require(rel <= 1e-5, f"shipped differs from the plain version at {tag}: {rel}")
        same = {name: all(torch.equal(a, b) for a, b in zip(o, ref)) for name, o in outs.items()}
        result["shapes"][tag] = {"rel_err_shipped": rel, "same_bits": same}
        result["same_bits"] = result["same_bits"] and all(same.values())
        cs.log(f"{tag}: shipped within {rel:.3g} of the plain version; bit for bit with the "
               f"shipped kernel: {same}")
        del args, want, outs
    times = {name: {"prefill": [], "training": []} for name in libs}
    for tag, shape in (("prefill", PREFILL), ("training", TRAINING)):
        B, T, Di, S = shape
        args = cs.scan_inputs(torch, gen, B, T, Di, S, torch.bfloat16)
        nbytes = sum(a.numel() * a.element_size() for a in args) + B * T * Di * 4
        sets = cs.cold_copies(torch, args, nbytes)
        calls = {}
        for name, lib in libs.items():
            fns = []
            for st in sets:
                y = torch.empty((B, T, Di), dtype=torch.float32, device="cuda")
                s_out = torch.empty((B, Di, S), dtype=torch.float32, device="cuda")
                fns.append(launcher(torch, name, lib, st, y, s_out))
            calls[name] = fns
        order = list(libs)
        for sweep in (order, order[::-1]):
            for name in sweep:
                times[name][tag].append(cs.graph_ms(torch, calls[name], iters=40, replays=3))
        result["shapes"][tag]["cold_sets"] = len(sets)
        del args, sets, calls
        torch.cuda.empty_cache()
    for name, t in times.items():
        b = result["builds"][name]
        for tag in ("prefill", "training"):
            b[f"{tag}_ms_readings"] = t[tag]
            b[f"{tag}_ms"] = sum(t[tag]) / len(t[tag])
        cs.log(f"{name}: prefill {b['prefill_ms']:.4f} ms {t['prefill']}, training "
               f"{b['training_ms']:.4f} ms {t['training']} (device time from CUDA graphs)")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "ssm_scan_variants.json").write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0 if result["same_bits"] else 1


if __name__ == "__main__":
    sys.exit(main())
