#!/usr/bin/env python3
"""Build the scan backward's CUDA source for the CPU and hold it against its
plain version.

    python3 tools/scan_bwd_emulate.py [--tsan] [--defer-cp] [--cases 0,3]

``src/repro_torch/kernels/csrc/rwkv6_scan_bwd.cu`` is compiled by g++ with
the stand-ins under ``tools/cuda_emu/`` for the CUDA runtime, bfloat16 and
``tf32_mma.cuh`` (a thread per CUDA thread, barriers for ``__syncthreads``,
the mma fragments exchanged across the warp; see those files), then run on
small shapes against ``rwkv6_scan_bwd_ref`` within the kernel's contract:
5e-6 of each gradient's largest entry, dlogw 2e-5, one more bf16 ulp for
bf16 dr/dk/dv. Every output starts as NaN, so an entry the kernel does not
write shows. This checks the source's indexing, barriers and arithmetic
without a card; it says nothing about what ``nvcc``/``ptxas`` make of it.

``--tsan`` builds with ThreadSanitizer and runs the cases in a child
process with its runtime preloaded: a data race between the emulated
threads (two threads touching one shared-memory word with no barrier
between them, one of them writing) is reported. ``--defer-cp`` makes each
``cp.async`` copy only when its group is waited for (``tools/cuda_emu/
tf32_mma.cuh``), so a read of a tile before its wait and barrier sees NaN.
Exits non-zero on a mismatch or a reported race. The library is built into
``build/scan_bwd_emulate/`` at the root of the checkout.
"""
from __future__ import annotations

import argparse
import ctypes
import math
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
EMU = Path(__file__).resolve().parent / "cuda_emu"
OUT = ROOT / "build" / "scan_bwd_emulate"
OUTPUTS = ("dr", "dk", "dv", "dlogw", "du", "dstate")
# (B, T, H, Dh, C, bf16, d_final, strong decays): the training layout at a
# ragged T, one chunk, C = 16 and 32, the element-load path (Dh = 20), logw
# down to -20.
CASES = ((1, 130, 2, 64, 64, True, True, False), (1, 130, 1, 64, 64, False, True, False),
         (2, 45, 1, 20, 16, False, True, False), (1, 50, 1, 64, 64, True, False, False),
         (1, 77, 1, 64, 32, True, True, False), (1, 140, 1, 16, 64, False, True, True))


def translate(source: str) -> str:
    """The CUDA source as C++ for the stand-ins: dynamic shared memory from
    the emulated block, ``<<<...>>>`` launches as ``emu_launch`` calls."""
    source = source.replace("extern __shared__ __align__(16) unsigned char smem_raw[];",
                            "unsigned char* smem_raw = emu_smem;")
    return re.sub(r"(\w+(?:<\w+>)?)<<<(.*?)>>>\((.*?)\);", r"emu_launch(\1, \2, \3);", source,
                  flags=re.S)


def build_library(tsan: bool = False, defer_cp: bool = False) -> Path:
    """Compile the translated source with g++ into ``OUT``; its headers are
    copied beside it, ``tf32_mma.cuh`` from ``tools/cuda_emu``."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    tag = ("tsan" if tsan else "plain") + ("-defer" if defer_cp else "")
    out_dir = OUT / tag
    out_dir.mkdir(parents=True, exist_ok=True)
    source, *headers = build.source_files("rwkv6_scan_bwd")
    (out_dir / "kernel.cpp").write_text(translate(source.read_text()))
    for h in headers:
        shutil.copy(EMU / h.name if (EMU / h.name).is_file() else h, out_dir / h.name)
    lib = out_dir / "libscan_bwd_emu.so"
    cmd = ["g++", "-std=c++20", "-O1", "-shared", "-fPIC", f"-I{EMU}", f"-I{out_dir}", "-o",
           str(lib), str(out_dir / "kernel.cpp"), "-lpthread"]
    if tsan:
        cmd[2:2] = ["-g", "-fsanitize=thread"]
    if defer_cp:
        cmd.insert(2, "-DEMU_CP_DEFER")
    subprocess.run(cmd, capture_output=True, text=True, timeout=900, check=True)
    return lib


def load(path: Path):
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    lib = ctypes.CDLL(str(path))
    build._declare("rwkv6_scan_bwd", lib)
    return lib


def within(name: str, err: float, scale: float, bf16: bool) -> bool:
    """``err`` inside the kernel's contract for gradient ``name`` whose
    largest entry is ``scale``: 5e-6 of it (dlogw 2e-5), one more bf16 ulp
    for bf16 dr/dk/dv. False for a NaN error."""
    allow = (2e-5 if name == "dlogw" else 5e-6) * scale
    if bf16 and name in ("dr", "dk", "dv"):
        allow += math.ldexp(1.0, math.frexp(scale)[1] - 8)
    return err <= allow


def run_case(lib, B, T, H, Dh, C, bf16, d_final, strong, seed=0) -> dict:
    """One launch on random operands at the scan's magnitudes, against
    ``rwkv6_scan_bwd_ref``: each gradient's error over its largest entry and
    whether it is within the contract."""
    import torch
    from repro_torch.kernels import rwkv6_scan as rs
    g = torch.Generator().manual_seed(seed)
    dtype = torch.bfloat16 if bf16 else torch.float32
    r, k, v, do = (torch.randn(B, T, H, Dh, generator=g) for _ in range(4))
    r, k, v = (a.to(dtype) for a in (r, k, v))
    x = torch.randn(B, T, H, Dh, generator=g)
    logw = -20.0 * torch.rand(B, T, H, Dh, generator=g) if strong else -torch.exp(-1.0 + torch.tanh(x))
    u = torch.randn(H, Dh, generator=g)
    s0 = torch.randn(B, H, Dh, Dh, generator=g)
    dfin = torch.randn(B, H, Dh, Dh, generator=g) if d_final else None
    C = min(C, T)
    nc = -(-T // C)
    # The forward's chunk-start states and final state, as its plain version forms them.
    (_, k_, v_, lw_), _ = rs._to_chunks((r, k, v, logw), C)
    subs, lc, _, tot = rs._anchors(lw_, rs.SUB_CHUNK)
    starts, s_fin = rs._chunk_starts(k_, v_, lc, tot, subs, s0)
    states = starts.permute(2, 0, 1, 3, 4).reshape(nc, B * H, Dh, Dh).contiguous()
    s_fin = s_fin.contiguous()
    got = [torch.full_like(a, float("nan")) for a in (r, r, r, logw, u, s0)]
    grads = torch.empty_like(states)
    log_decay = torch.empty(nc * B * H * Dh)
    du_part = torch.empty_like(log_decay)
    tensors = (r, k, v, logw, u, do, dfin, states, s_fin, *got, grads, log_decay, du_part)
    err = lib.rwkv6_scan_bwd_launch(
        *(None if a is None else a.data_ptr() for a in tensors),
        B, H, T, Dh, C, T * H * Dh, H * Dh, Dh, int(bf16), None)
    assert err == 0, f"rwkv6_scan_bwd_launch returned {err}"
    want = rs.rwkv6_scan_bwd_ref(r, k, v, logw, u, s0, do, dfin, chunk=C)
    out = {}
    for name, a, w in zip(OUTPUTS, got, want):
        scale = w.double().abs().max().item()
        e = (a.double() - w.double()).abs().max().item()
        out[name] = {"of_largest": e / scale, "within": within(name, e, scale, bf16)}
    return out


def run_cases(lib, cases=CASES) -> bool:
    """Every case through ``run_case``, a line each; True if all are within
    the contract."""
    ok = True
    for case in cases:
        res = run_case(lib, *case)
        ok = ok and all(v["within"] for v in res.values())
        print(f"{list(case[:4])} C={case[4]} {'bf16' if case[5] else 'float32'}"
              f"{' dS_final' if case[6] else ''}{' logw to -20' if case[7] else ''}: " + ", ".join(
                  f"{n} {v['of_largest']:.2e}{'' if v['within'] else ' OUTSIDE'}"
                  for n, v in res.items()), flush=True)
    return ok


def tsan_runtime() -> str | None:
    """ThreadSanitizer's runtime library of the host's g++, or None."""
    try:
        path = subprocess.run(["g++", "-print-file-name=libtsan.so"], capture_output=True,
                              text=True, timeout=60, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None
    return path if os.path.isabs(path) and os.path.exists(path) else None


def run_under_tsan(defer_cp: bool, cases: str = "") -> tuple[bool, int, str]:
    """Build with ThreadSanitizer and run the cases (``cases``: indices into
    ``CASES``, comma-separated; empty for all) in a child process with its
    runtime preloaded: (all within the contract, races reported, the
    child's output)."""
    runtime = tsan_runtime()
    if runtime is None:
        raise RuntimeError("g++ has no ThreadSanitizer runtime (libtsan.so)")
    lib = build_library(tsan=True, defer_cp=defer_cp)
    env = dict(os.environ, LD_PRELOAD=runtime, OMP_NUM_THREADS="1",
               TSAN_OPTIONS="halt_on_error=0 history_size=2")
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--child", str(lib),
                           "--cases", cases], capture_output=True, text=True, env=env,
                          timeout=1800)
    text = proc.stdout + proc.stderr
    return proc.returncode == 0, text.count("WARNING: ThreadSanitizer"), text


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tsan", action="store_true", help="build and run under ThreadSanitizer")
    ap.add_argument("--defer-cp", action="store_true",
                    help="make each cp.async copy only when its group is waited for")
    ap.add_argument("--cases", default="",
                    help="indices into CASES, comma-separated (default: all)")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    opts = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    cases = [CASES[int(i)] for i in opts.cases.split(",")] if opts.cases else CASES
    if opts.child:
        return 0 if run_cases(load(Path(opts.child)), cases) else 1
    if opts.tsan:
        ok, races, text = run_under_tsan(opts.defer_cp, opts.cases)
        print(text, end="")
        print(f"ThreadSanitizer: {races} race(s) reported; cases "
              f"{'within the contract' if ok else 'FAILED'}")
        return 0 if ok and races == 0 else 1
    return 0 if run_cases(load(build_library(defer_cp=opts.defer_cp)), cases) else 1


if __name__ == "__main__":
    sys.exit(main())
