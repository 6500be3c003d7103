#!/usr/bin/env python3
"""Check the scan backward's ptxas workaround on one NVIDIA card.

    python3 tools/scan_bwd_ptxas_check.py [--sanitize]

Run from the root of a checkout on a host with a CUDA card and the CUDA
toolkit. ``src/repro_torch/kernels/build.py`` builds
``csrc/rwkv6_scan_bwd.cu`` with ``-Xptxas -O1``: ptxas 12.9 at its default
-O3 compiled the C' pass (``rwkv6_bwd_chunk_out_kernel``) into code whose
outputs were NaN and differed from call to call. This script prints the
toolkit's version, builds the same source without that flag (ptxas -O3)
beside the shipped library, and runs both: at [1, 130, 2, 64] in bfloat16
and float32 and at rwkv6-1.6b's training shape [1, 2048, 32, 64] in
bfloat16, whether the outputs are finite, whether two calls give the same
bits and each gradient's largest error against ``rwkv6_scan_bwd_ref`` as a
share of its largest entry (``within``: inside the kernel's contract, 5e-6
of the largest entry, dlogw 2e-5, one more bf16 ulp for bf16 dr/dk/dv);
then the time of a call at the training shape by CUDA events, in turns
(shipped, -O3, -O3, shipped). Run it after a toolkit change: it shows
whether the workaround is still needed and what it costs.

With ``--sanitize`` it also builds ``tools/scan_bwd_sanitize.cu``, which
makes one call of the launch at [1, 130, 2, 64] in bfloat16 with no PyTorch
in the process, and runs it on each build alone and under
compute-sanitizer's racecheck, synccheck and initcheck, each in its own
process, and reports what the tool printed (it stops at the first
sanitized run that prints no summary). The last line of the output is one
JSON object with every number.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import scan_bwd_emulate as emulate  # beside this script

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402  (the card harness: cuda_ms, device_line)

SMALL = (1, 130, 2, 64)
TRAIN = (1, 2048, 32, 64)
CHUNK = 64
NAME = "rwkv6_scan_bwd"
OUTPUTS = ("dr", "dk", "dv", "dlogw", "du", "dstate")
SANITIZER_TOOLS = ("racecheck", "synccheck", "initcheck")


def build_o3(build) -> Path:
    """``csrc/rwkv6_scan_bwd.cu`` compiled with the shared flags alone (ptxas
    at its default -O3) into ``build/repro_torch/variants/``."""
    flags = build.NVCC_FLAGS
    h = hashlib.sha256()
    for path in build.source_files(NAME):
        h.update(path.read_bytes())
    h.update(" ".join(flags).encode())
    out = build.BUILD_DIR / "variants" / f"lib{NAME}-ptxas-O3-{h.hexdigest()[:12]}.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        subprocess.run([build.nvcc_path(), *flags, "-o", str(out), str(build.CSRC / f"{NAME}.cu")],
                       capture_output=True, text=True, timeout=600, check=True)
    return out


def library_paths(build) -> dict:
    """{"shipped": the library ``build.load`` loads, "O3": the -O3 build}."""
    build.build_all((NAME,))
    return {"shipped": build.library_path(NAME), "O3": build_o3(build)}


def libraries(build, paths: dict) -> dict:
    """The libraries at ``paths``, loaded and declared."""
    libs = {key: ctypes.CDLL(str(path)) for key, path in paths.items()}
    for lib in libs.values():
        build._declare(NAME, lib)
    return libs


def use(rs, build, lib) -> None:
    """Make ``rwkv6_scan_bwd`` launch ``lib``."""
    rs.load = lambda name: lib if name == NAME else build.load(name)


def inputs(torch, shape, dtype, seed):
    """Random operands at the scan's magnitudes (as phase 12b of
    ``chip_smoke.py`` draws them), made on the host and moved to the card."""
    B, T, H, Dh = shape
    g = torch.Generator().manual_seed(seed)
    r, k, v, do = (torch.randn(B, T, H, Dh, generator=g) for _ in range(4))
    logw = -torch.exp(-1.0 + torch.tanh(torch.randn(B, T, H, Dh, generator=g)))
    u = 0.5 * torch.randn(H, Dh, generator=g)
    s0 = torch.randn(B, H, Dh, Dh, generator=g)
    return tuple(a.to(dtype).cuda() for a in (r, k, v)) + tuple(
        a.cuda() for a in (logw, u, s0, do))


def check(torch, rs, args) -> dict:
    """Two calls of the kernel against the plain version on ``args``."""
    got = rs.rwkv6_scan_bwd(*args, chunk=CHUNK)
    again = rs.rwkv6_scan_bwd(*args, chunk=CHUNK)
    want = rs.rwkv6_scan_bwd_ref(*args, chunk=CHUNK)
    torch.cuda.synchronize()
    bf16 = args[0].dtype == torch.bfloat16
    of_largest, ok = {}, True
    for name, g, w in zip(OUTPUTS, got, want):
        scale = w.double().abs().max().item()
        err = (g.double() - w.double()).abs().max().item()
        of_largest[name] = err / scale if scale else err
        ok = ok and emulate.within(name, err, scale, bf16)
    return {"finite": all(bool(torch.isfinite(g).all()) for g in got),
            "bit_identical": all(torch.equal(a, b) for a, b in zip(got, again)),
            "within": bool(ok), "of_largest": of_largest}


def times(torch, rs, build, libs) -> dict:
    """Milliseconds a call at the training shape in bfloat16 on the forward's
    saved states, each build the mean of two readings taken in turns."""
    args = inputs(torch, TRAIN, torch.bfloat16, 1)
    r, k, v, logw, u, s0, do = args
    B, T, H, Dh = TRAIN
    _, s_fin, states = rs._launch(r, k, v, logw, u, s0, CHUNK, B, H, T, Dh, 0)
    readings = {key: [] for key in libs}
    for key in ("shipped", "O3", "O3", "shipped"):
        use(rs, build, libs[key])
        readings[key].append(chip_smoke.cuda_ms(
            torch, lambda: rs.rwkv6_scan_bwd(*args, chunk=CHUNK, saved=(states, s_fin))))
    return {key: {"ms": sum(v) / len(v), "readings": v} for key, v in readings.items()}


def run_group(cmd, timeout: float):
    """Run ``cmd`` in its own process group and return (output, return code);
    at ``timeout`` seconds the whole group is killed."""
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        return proc.communicate(timeout=timeout)[0], proc.returncode
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        return proc.communicate()[0], f"killed after {timeout} s"


def build_harness(build) -> Path:
    """``tools/scan_bwd_sanitize.cu``, the launch driven with no PyTorch in
    the process, built into ``build/repro_torch/variants/``."""
    out = build.BUILD_DIR / "variants" / "scan_bwd_sanitize"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([build.nvcc_path(), "-std=c++17", "-O2", "-o", str(out),
                    str(Path(__file__).resolve().parent / "scan_bwd_sanitize.cu"), "-ldl"],
                   capture_output=True, text=True, timeout=600, check=True)
    return out


def sanitize(build, paths: dict) -> list:
    """The harness on each build (``paths``: key -> library) at the small
    bfloat16 shape, first alone, then under each of compute-sanitizer's
    tools, each run in its own process: return code, the tool's summary
    line and the output's tail. Stops at the first sanitized run that prints
    no summary (the tool did not run)."""
    exe = Path(build.nvcc_path()).parent / "compute-sanitizer"
    harness = build_harness(build)
    out = []
    for key, lib in paths.items():
        for t in (None,) + SANITIZER_TOOLS:
            cmd = [str(harness), str(lib), "1"]
            if t:
                cmd = [str(exe), "--tool", t, *cmd]
            text, rc = run_group(cmd, 180)
            summary = [ln.strip() for ln in text.splitlines() if "SUMMARY" in ln]
            out.append({"build": key, "tool": t, "rc": rc,
                        "summary": summary[-1] if summary else None,
                        "tail": text.strip().splitlines()[-25:]})
            print(f"  {'compute-sanitizer --tool ' + t if t else 'alone'} on the {key} build: "
                  f"rc {rc}; {summary[-1] if summary else 'no summary'}", flush=True)
            print("    " + "\n    ".join(out[-1]["tail"]), flush=True)
            if t and not summary:
                return out
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sanitize", action="store_true",
                    help="also run compute-sanitizer's racecheck, synccheck and initcheck")
    opts = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("scan_bwd_ptxas_check.py: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels import rwkv6_scan as rs

    paths = library_paths(build)
    libs = libraries(build, paths)
    smi = chip_smoke.device_line()
    result = {"device": smi, "torch": torch.__version__, "toolkit": build.toolkit_version(),
              "flags": {"shipped": list(build.nvcc_flags(NAME)), "O3": list(build.NVCC_FLAGS)},
              "checks": {}}
    print(smi, flush=True)
    print(f"nvcc: {result['toolkit']}; shipped flags {result['flags']['shipped']}", flush=True)
    for shape, dtype in ((SMALL, torch.bfloat16), (SMALL, torch.float32),
                         (TRAIN, torch.bfloat16)):
        args = inputs(torch, shape, dtype, 0)
        for key, lib in libs.items():
            use(rs, build, lib)
            tag = f"{key} {list(shape)} {str(dtype).removeprefix('torch.')}"
            result["checks"][tag] = c = check(torch, rs, args)
            print(f"{tag}: finite {c['finite']}, bit-identical {c['bit_identical']}, within "
                  f"the contract {c['within']}; of the largest entry "
                  + ", ".join(f"{n} {e:.3g}" for n, e in c["of_largest"].items()), flush=True)
        del args
    result["times"] = times(torch, rs, build, libs)
    t = result["times"]
    print(f"{list(TRAIN)} bf16, a call: shipped {t['shipped']['ms']:.4f} ms "
          f"{t['shipped']['readings']}, -O3 {t['O3']['ms']:.4f} ms {t['O3']['readings']}",
          flush=True)
    if opts.sanitize:
        result["sanitizer"] = sanitize(build, paths)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
