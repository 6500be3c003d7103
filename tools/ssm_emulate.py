#!/usr/bin/env python3
"""Build the selective scan's CUDA sources for the CPU and hold them against
their plain versions.

    python3 tools/ssm_emulate.py [--tsan] [--defer-cp]

``src/repro_torch/kernels/csrc/ssm_scan.cu`` (the forward) and
``ssm_scan_bwd.cu`` (the backward) are compiled by g++ with the stand-ins
under ``tools/cuda_emu/`` for the CUDA runtime, bfloat16, the ``cp.async``
helpers of ``tf32_mma.cuh`` and ``ssm_exp2.cuh`` (2^x by the C library
where the card uses its special-function unit). A thread runs per CUDA
thread, barriers stand for ``__syncthreads`` and shuffles go through a
per-warp array (``tools/cuda_emu/cuda_runtime.h``). Each case runs on random
operands at hymba's magnitudes against ``selective_scan_ref`` /
``selective_scan_bwd_ref`` within the card's bounds: the forward's y and
final state within 1e-5 of their largest entries, its chunk-start states
within 1e-5 of the largest |h| of the plain loop's h at those tokens; each
gradient within 1e-5 of its largest entry, and the sums over channels or
tokens (dB, dC, dlog_a, dd_skip) within 1e-5 of the largest sum of their
terms' magnitudes. Every output starts as NaN, so an entry the kernel does
not write shows. This checks the sources' indexing, barriers and
arithmetic without a card; it says nothing about what nvcc/ptxas make of
them.

``--defer-cp`` makes each ``cp.async`` copy only when its group is waited
for, so a read of a stage before its wait and barrier sees the 0xff fill
(NaN). ``--tsan`` builds with ThreadSanitizer and runs the cases in a child
process with its runtime preloaded: a data race between the emulated
threads is reported. Exits non-zero on a mismatch or a reported race. The
libraries are built into ``build/ssm_emulate/`` at the root of the checkout.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
import chip_smoke as cs  # noqa: E402  (ssm_bwd_scales: the sums' scales)

EMU = Path(__file__).resolve().parent / "cuda_emu"
OUT = ROOT / "build" / "ssm_emulate"
SOURCES = ("ssm_scan", "ssm_scan_bwd")
BOUND = 1e-5
# Forward (B, T, Di, S, bf16, dt shift): one token; Di not a whole number of
# 16-byte pieces (the plain-load ring); two chunks and a ragged last group;
# S = 5; weak decays over three chunks; a partial block of chains.
FWD_CASES = ((1, 1, 8, 16, True, 0.0), (2, 37, 37, 16, False, 0.0), (2, 70, 16, 16, True, 0.0),
             (3, 50, 33, 5, False, 0.0), (1, 150, 24, 16, False, -4.0),
             (2, 129, 40, 16, True, 0.0))
# Backward (B, T, Di, S, bf16, d_final, dt shift): three chunks of 64 tokens
# with a ragged last one over two chain groups (one partial) in bf16; the
# plain-load tiles (Di 37); S = 5 in one whole chunk; strong decays; weak
# decays over four chunks; two chunks of one group through the 16-byte
# copies (the race check's). Then the carries' structure: one token; one
# whole chunk (no fold step); 65 tokens (a chunk of one token after a whole
# one) over a partial group; eleven chunks of one group at weak decays (the
# longest fold, the carry crossing every chunk); S = 5 at strong decays in
# bf16 (every chunk's decay product 2^(a sum dt) underflows to 0).
BWD_CASES = ((1, 130, 40, 16, True, True, 0.0), (2, 45, 37, 16, False, True, 0.0),
             (1, 64, 32, 5, False, False, 0.0), (2, 100, 16, 16, False, True, 3.0),
             (1, 200, 8, 16, True, False, -4.0), (1, 70, 16, 16, False, True, 0.0),
             (1, 1, 8, 16, True, True, 0.0), (1, 64, 32, 16, False, True, 0.0),
             (1, 65, 40, 16, True, True, 0.0), (1, 650, 32, 16, False, True, -4.0),
             (2, 150, 24, 5, True, True, 3.0))


def translate(source: str) -> str:
    """The CUDA source as C++ for the stand-ins: dynamic shared memory from
    the emulated block, ``<<<...>>>`` launches as ``emu_launch`` calls."""
    source = source.replace("extern __shared__ __align__(16) unsigned char smem_raw[];",
                            "unsigned char* smem_raw = emu_smem;")
    return re.sub(r"(\w+(?:<[\w, ]+>)?)<<<(.*?)>>>\((.*?)\);", r"emu_launch(\1, \2, \3);",
                  source, flags=re.S)


def build_library(name: str, tsan: bool = False, defer_cp: bool = False) -> Path:
    """Compile the translated ``csrc/<name>.cu`` with g++ into ``OUT``; its
    headers are copied beside it, each from ``tools/cuda_emu`` where a
    stand-in exists there."""
    from repro_torch.kernels import build
    tag = ("tsan" if tsan else "plain") + ("-defer" if defer_cp else "")
    out_dir = OUT / tag / name
    out_dir.mkdir(parents=True, exist_ok=True)
    source, *headers = build.source_files(name)
    (out_dir / "kernel.cpp").write_text(translate(source.read_text()))
    for h in headers:
        shutil.copy(EMU / h.name if (EMU / h.name).is_file() else h, out_dir / h.name)
    lib = out_dir / f"lib{name}_emu.so"
    cmd = ["g++", "-std=c++20", "-O1", "-shared", "-fPIC", f"-I{EMU}", f"-I{out_dir}", "-o",
           str(lib), str(out_dir / "kernel.cpp"), "-lpthread"]
    if tsan:
        cmd[2:2] = ["-g", "-fsanitize=thread"]
    if defer_cp:
        cmd.insert(2, "-DEMU_CP_DEFER")
    subprocess.run(cmd, capture_output=True, text=True, timeout=900, check=True)
    return lib


def load(path: Path, name: str):
    from repro_torch.kernels import build
    lib = ctypes.CDLL(str(path))
    build._declare(name, lib)
    return lib


def build_all(tsan: bool = False, defer_cp: bool = False) -> dict:
    """{name: loaded library} for both sources."""
    return {n: load(build_library(n, tsan, defer_cp), n) for n in SOURCES}


def operands(B, T, Di, S, bf16, shift, seed=0):
    """Operands as hymba's gates make them (u = silu(.), dt = softplus(.),
    log_a the init's log(1..S) plus noise, d_skip near 1, a nonzero state),
    float32 but u."""
    import torch
    import torch.nn.functional as F
    g = torch.Generator().manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=g)

    u = F.silu(randn(B, T, Di)).to(torch.bfloat16 if bf16 else torch.float32)
    dt = F.softplus(randn(B, T, Di) + shift)
    Bm, Cm = randn(B, T, S), randn(B, T, S)
    log_a = torch.log(torch.linspace(1.0, S, S))[None] + 0.2 * randn(Di, S)
    d_skip = 1.0 + 0.1 * randn(Di)
    s0 = 0.5 * randn(B, Di, S)
    return u, dt, Bm, Cm, log_a, d_skip, s0


def chunk_states_ref(u, dt, Bm, log_a, s0, chunk):
    """h at the start of every chunk of ``chunk`` tokens, [B, ceil(T /
    chunk), Di, S], by the plain loop's arithmetic (chunk 0: s0)."""
    import torch
    A = -torch.exp(log_a)
    h, out = s0.clone(), []
    for t in range(u.shape[1]):
        if t % chunk == 0:
            out.append(h)
        drive = (dt[:, t] * u[:, t].float())[:, :, None] * Bm[:, t, None]
        h = torch.exp(dt[:, t, :, None] * A) * h + drive
    return torch.stack(out, 1).contiguous()


def _nan(*shape, dtype=None):
    import torch
    return torch.full(shape, float("nan"), dtype=dtype or torch.float32)


def run_forward(lib, B, T, Di, S, bf16, shift, seed=0) -> dict:
    """One forward launch with states against the plain loop: each output's
    error over its bound's scale."""
    import torch
    from repro_torch.kernels import ssm_scan as ss
    args = operands(B, T, Di, S, bf16, shift, seed)
    nc = -(-T // ss.CHUNK)
    y, s_out, states = _nan(B, T, Di), _nan(B, Di, S), _nan(B, nc, Di, S)
    err = lib.selective_scan_states_launch(*(a.data_ptr() for a in args), y.data_ptr(),
                                           s_out.data_ptr(), states.data_ptr(), B, T, Di, S,
                                           int(bf16), None)
    assert err == 0, f"selective_scan_states_launch returned {err}"
    assert lib.selective_scan_chunk() == ss.CHUNK
    wy, ws = ss.selective_scan_ref(*args)
    wst = chunk_states_ref(args[0], args[1], args[2], args[4], args[6], ss.CHUNK)
    out = {}
    for name, got, want in (("y", y, wy), ("state", s_out, ws), ("states", states, wst)):
        scale = want.abs().max().item()
        out[name] = torch.nan_to_num((got - want).abs(), nan=float("inf")).max().item() / scale
    return out


def run_backward(lib, flib, B, T, Di, S, bf16, d_final, shift, seed=0) -> dict:
    """One backward launch on the emulated forward's states against the plain
    backward: each gradient's error over its bound's scale (its largest
    entry; a sum's largest sum of magnitudes)."""
    import torch
    from repro_torch.kernels import ssm_scan as ss
    args = operands(B, T, Di, S, bf16, shift, seed)
    g = torch.Generator().manual_seed(seed + 1)
    dy = torch.randn(B, T, Di, generator=g)
    dfin = torch.randn(B, Di, S, generator=g) if d_final else None
    nc = -(-T // ss.CHUNK)
    states, y, s_out = _nan(B, nc, Di, S), _nan(B, T, Di), _nan(B, Di, S)
    assert flib.selective_scan_states_launch(*(a.data_ptr() for a in args), y.data_ptr(),
                                             s_out.data_ptr(), states.data_ptr(), B, T, Di, S,
                                             int(bf16), None) == 0
    u = args[0]
    got = [_nan(B, T, Di, dtype=u.dtype), _nan(B, T, Di), _nan(B, T, S), _nan(B, T, S),
           _nan(Di, S), _nan(Di), _nan(B, Di, S)]
    # Scratch starts as NaN too: a partial read before it is written shows.
    scratch = [t.fill_(float("nan")) for t in ss.bwd_scratch(lib, B, T, Di, S, "cpu")]
    ptr = [a.data_ptr() for a in args[:6]] + [
        dy.data_ptr(), None if dfin is None else dfin.data_ptr(), states.data_ptr()]
    assert lib.selective_scan_bwd_state_interval() == ss.CHUNK
    err = lib.selective_scan_bwd_launch(*ptr, *(a.data_ptr() for a in got),
                                        *(a.data_ptr() for a in scratch), B, T, Di, S,
                                        int(bf16), None)
    assert err == 0, f"selective_scan_bwd_launch returned {err}"
    want = ss.selective_scan_bwd_ref(*args, dy, dfin)
    scales = cs.ssm_bwd_scales(ss, args, dy, dfin)
    out = {}
    for name, a, w in zip(cs.SSM_GRADS, got, want):
        scale = scales.get(name, w.float().abs().max().item())
        diff = torch.nan_to_num((a.float() - w.float()).abs(), nan=float("inf")).max().item()
        if name == "du" and bf16:   # one bf16 rounding of the output beside float32's
            diff = max(0.0, diff - 2.0 ** -7 * w.float().abs().max().item())
        out[name] = diff / scale
    return out


def run_cases(libs) -> bool:
    ok = True
    for case in FWD_CASES:
        res = run_forward(libs["ssm_scan"], *case)
        ok = ok and all(v <= BOUND for v in res.values())
        print(f"forward {list(case)}: " + ", ".join(
            f"{n} {v:.2e}{'' if v <= BOUND else ' OUTSIDE'}" for n, v in res.items()), flush=True)
    for case in BWD_CASES:
        res = run_backward(libs["ssm_scan_bwd"], libs["ssm_scan"], *case)
        ok = ok and all(v <= BOUND for v in res.values())
        print(f"backward {list(case)}: " + ", ".join(
            f"{n} {v:.2e}{'' if v <= BOUND else ' OUTSIDE'}" for n, v in res.items()), flush=True)
    return ok


def tsan_runtime() -> str | None:
    """ThreadSanitizer's runtime library of the host's g++, or None."""
    try:
        path = subprocess.run(["g++", "-print-file-name=libtsan.so"], capture_output=True,
                              text=True, timeout=60, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None
    return path if os.path.isabs(path) and os.path.exists(path) else None


def run_under_tsan(defer_cp: bool, fwd: str = "", bwd: str = "") -> tuple[bool, int, str]:
    """Build with ThreadSanitizer and run the cases (``fwd``/``bwd``: indices
    into the case lists, comma-separated; empty for all) in a child process
    with its runtime preloaded: (all within bounds, races reported, the
    child's output)."""
    runtime = tsan_runtime()
    if runtime is None:
        raise RuntimeError("g++ has no ThreadSanitizer runtime (libtsan.so)")
    for name in SOURCES:
        build_library(name, tsan=True, defer_cp=defer_cp)
    env = dict(os.environ, LD_PRELOAD=runtime, OMP_NUM_THREADS="1",
               TSAN_OPTIONS="halt_on_error=0 history_size=2")
    cmd = [sys.executable, str(Path(__file__).resolve()), "--child",
           "tsan" + ("-defer" if defer_cp else ""), "--fwd", fwd, "--bwd", bwd]
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env, timeout=1800)
    text = proc.stdout + proc.stderr
    return proc.returncode == 0, text.count("WARNING: ThreadSanitizer"), text


def main() -> int:
    global FWD_CASES, BWD_CASES
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tsan", action="store_true", help="build and run under ThreadSanitizer")
    ap.add_argument("--defer-cp", action="store_true",
                    help="make each cp.async copy only when its group is waited for")
    ap.add_argument("--fwd", default="", help="forward cases to run (indices, comma-separated)")
    ap.add_argument("--bwd", default="", help="backward cases to run (indices, comma-separated)")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    opts = ap.parse_args()
    if opts.fwd:
        FWD_CASES = tuple(FWD_CASES[int(i)] for i in opts.fwd.split(","))
    if opts.bwd:
        BWD_CASES = tuple(BWD_CASES[int(i)] for i in opts.bwd.split(","))
    if opts.child:
        libs = {n: load(OUT / opts.child / n / f"lib{n}_emu.so", n) for n in SOURCES}
        return 0 if run_cases(libs) else 1
    if opts.tsan:
        ok, races, text = run_under_tsan(opts.defer_cp, opts.fwd, opts.bwd)
        print(text, end="")
        print(f"ThreadSanitizer: {races} race(s) reported; cases "
              f"{'within bounds' if ok else 'FAILED'}")
        return 0 if ok and races == 0 else 1
    return 0 if run_cases(build_all(defer_cp=opts.defer_cp)) else 1


if __name__ == "__main__":
    sys.exit(main())
