#!/usr/bin/env python3
"""Build variants of the selective scan's backward kernel on one NVIDIA card,
hold each against the plain backward and time them in turns.

    python3 tools/ssm_scan_bwd_variants.py [--source NAME=PATH ...]

Run from the root of a checkout on a host with a CUDA card and the CUDA
toolkit. It builds, side by side (one nvcc each, all started together):

* ``shipped``: ``src/repro_torch/kernels/csrc/ssm_scan_bwd.cu`` as the port
  builds it (a carry pass and a fold over chunks of 64 tokens, then blocks
  of (chunk, 32 chains), four threads a chain, four states a thread, h
  recomputed 16 tokens at a time in registers);
* ``minblocks3``, ``chains64``: the same source with the chunk kernel's
  launch bounds at 3 resident blocks an SM (up to 168 registers), or 64
  chains a block (8 warps, 2 resident an SM; half the dB/dC partials);
* each ``--source NAME=PATH``: another ``ssm_scan_bwd.cu`` with the same
  ``selective_scan_bwd_launch`` entry point, such as the first design's
  (``git show 5b5dfe8:src/repro_torch/kernels/csrc/ssm_scan_bwd.cu``). A
  source that does not export ``selective_scan_bwd_state_interval`` is
  taken to read the forward's states every 64 tokens, as the first design
  does: it gets every fourth of the shipped forward's 16-token states (the
  same h, bit for bit).

Every build is held against ``selective_scan_bwd_ref`` within
``chip_smoke.py``'s phase 12d bounds (each gradient within 1e-5 of its
largest entry, the sums within 1e-5 of the largest sum of their terms'
magnitudes, a bf16 du one bf16 ulp more) at hymba-1.5b's training shape (u
[1, 2048, 3200], S = 16) in bf16 without a final-state gradient and in
float32 with one, and at three of 12d's ragged shapes; whether its outputs
equal the shipped kernel's bit for bit is recorded. Each build is then
timed at the training shape (u bf16) twice in turns (every build forward,
then in reverse), from a CUDA graph of calls over operand sets that
together move four times the L2 cache (``chip_smoke.graph_ms``,
``cold_copies``), with its registers and spills (``ptxas -v``) and SASS
counts. The forward with its states kept every 16 tokens (the shipped
``csrc/ssm_scan.cu``) and every 64 (the same source at ``kChunk = 64``) is
timed the same way beside its call without states. It prints the card's
name and power limit first, writes everything to
``chiprun_out/ssm_scan_bwd_variants.json`` and prints one JSON object as
its last line. Exits 1 if a build is outside the bounds or spills.
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

NAME = "ssm_scan_bwd"
VARIANTS = {
    "shipped": [],
    "minblocks3": [("constexpr int kMinBlocks = 4;", "constexpr int kMinBlocks = 3;")],
    "chains64": [("constexpr int kChains = 32;", "constexpr int kChains = 64;"),
                 ("constexpr int kMinBlocks = 4;", "constexpr int kMinBlocks = 2;")],
}
# The forward at the first design's state interval, for its time with states.
FWD_EDIT = ("constexpr int kChunk = 16;", "constexpr int kChunk = 64;")
TRAINING = (cs.LM_TRAIN_BATCH, cs.LM_TRAIN_SEQ, cs.HYMBA_DI, cs.HYMBA_S)
RAGGED = (cs.SSM_BWD_RAGGED[0], cs.SSM_BWD_RAGGED[1], cs.SSM_BWD_RAGGED[6])
P, I32 = ctypes.c_void_p, ctypes.c_int


def edited(src: str, edits, name: str, path: str) -> str:
    for old, new in edits:
        if old not in src:
            raise RuntimeError(f"variant {name}: {old!r} is not in {path}")
        src = src.replace(old, new)
    return src


def build_libraries(build, others: dict) -> tuple[dict, dict]:
    """Every backward library and the forward at a 64-token state interval,
    built side by side; returns ({name: path}, {name: nvcc output})."""
    out_dir = build.BUILD_DIR / "ssm_bwd_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = (build.CSRC / f"{NAME}.cu").read_text()
    sources = {name: (Path(path), NAME) for name, path in others.items()}
    for name, edits in VARIANTS.items():
        cu = out_dir / f"{NAME}-{name}.cu"
        cu.write_text(edited(src, edits, name, f"csrc/{NAME}.cu"))
        sources[name] = (cu, NAME)
    fwd = out_dir / "ssm_scan-chunk64.cu"
    fwd.write_text(edited((build.CSRC / "ssm_scan.cu").read_text(), [FWD_EDIT], "chunk64",
                          "csrc/ssm_scan.cu"))
    sources["fwd_chunk64"] = (fwd, "ssm_scan")
    procs, paths = {}, {}
    for name, (cu, lib) in sources.items():
        paths[name] = out_dir / f"lib{lib}-{name}.so"
        procs[name] = subprocess.Popen(
            [build.nvcc_path(), *build.nvcc_flags(lib), f"-I{build.CSRC}", "-o",
             str(paths[name]), str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    logs = {}
    for name, proc in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{logs[name]}")
    return paths, logs


def open_backward(path: Path) -> tuple[ctypes.CDLL, int]:
    """The library and the interval of the forward states it reads."""
    from repro_torch.kernels import build

    lib = ctypes.CDLL(str(path))
    if hasattr(lib, "selective_scan_bwd_scratch_floats"):
        build._declare(NAME, lib)      # the shipped interface, its queries included
        return lib, lib.selective_scan_bwd_state_interval()
    lib.selective_scan_bwd_launch.argtypes = [P] * 19 + [I32] * 5 + [P]
    lib.selective_scan_bwd_launch.restype = I32
    if not hasattr(lib, "selective_scan_bwd_state_interval"):
        return lib, 64
    lib.selective_scan_bwd_state_interval.restype = I32
    return lib, lib.selective_scan_bwd_state_interval()


def backward_call(torch, ss, name, lib, args, dy, dfin, states):
    """A launch of ``lib`` on its own outputs and scratch; returns them."""
    from repro_torch.kernels.build import load

    u = args[0]
    B, T, Di = u.shape
    S = args[2].shape[-1]
    outs = [torch.empty_like(u), torch.empty_like(args[1]), torch.empty_like(args[2]),
            torch.empty_like(args[3]), torch.empty_like(args[4]), torch.empty_like(args[5]),
            torch.empty_like(args[6])]
    # A library without the size query (the first design's) takes the
    # shipped library's sizes: its dB/dC partials are the same size, its
    # other two buffers smaller.
    sizes = lib if hasattr(lib, "selective_scan_bwd_scratch_floats") else load(NAME)
    scratch = ss.bwd_scratch(sizes, B, T, Di, S, u.device)

    def call():
        err = lib.selective_scan_bwd_launch(
            *(a.data_ptr() for a in args[:6]), dy.data_ptr(),
            None if dfin is None else dfin.data_ptr(), states.data_ptr(),
            *(o.data_ptr() for o in outs), *(s.data_ptr() for s in scratch), B, T, Di, S,
            int(u.dtype == torch.bfloat16), torch.cuda.current_stream().cuda_stream)
        cs.require(err == 0, f"{name}: CUDA error {err} at launch")
        return outs

    return call


def states_every(states16, interval: int):
    return states16 if interval == 16 else states16[:, ::interval // 16].contiguous()


def sass_ops(path: Path, build) -> dict:
    """Counts of a few instructions in the library, and the opcode counts of
    the chunk kernel's bf16 16-byte-copy instance (its sweep is unrolled a
    sub-chunk at a time, so they are about its instructions a 16 tokens)."""
    sass = cs.sass_text(path, build)
    out = {op: sum(1 for line in sass.splitlines() if op in line)
           for op in ("MUFU.EX2", "LDGSTS", "SHFL", "BAR.SYNC")}
    hist, inside = {}, False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = "ssm_bwd_chunk_kernel" in line and "nv_bfloat16" in line and (
                "Lb1E" in line or "bfloat16, true" in line)
        elif inside and "/*" in line and ";" in line:
            text = line.split("*/", 1)[-1].strip()
            words = text.split()
            if words and words[0].startswith("@"):
                words = words[1:]
            if words:
                op = words[0].split(".")[0]
                hist[op] = hist.get(op, 0) + 1
    out["chunk_kernel_opcodes"] = dict(sorted(hist.items(), key=lambda kv: -kv[1]))
    out["chunk_kernel_instructions"] = sum(hist.values())
    return out


def source_arg(text: str) -> tuple[str, Path]:
    name, _, path = text.partition("=")
    if not name or not path or name in VARIANTS or name == "fwd_chunk64":
        raise argparse.ArgumentTypeError(f"want NAME=PATH with a new NAME, got {text!r}")
    return name, Path(path)


def time_forward(torch, ss, gen, fwd64) -> dict:
    """The forward at the training shape, u bf16, from graphs over cold
    operand sets: without states, with states every 16 tokens (shipped)
    and every 64 (``fwd64``, the same source at kChunk = 64), in turns."""
    B, T, Di, S = TRAINING
    args = cs.scan_inputs(torch, gen, B, T, Di, S, torch.bfloat16)
    nbytes = sum(a.numel() * a.element_size() for a in args) + B * T * Di * 4
    sets = cs.cold_copies(torch, args, nbytes)
    lib = ctypes.CDLL(str(fwd64))
    lib.selective_scan_states_launch.argtypes = [P] * 10 + [I32] * 5 + [P]
    lib.selective_scan_states_launch.restype = I32

    def chunk64(a):
        y = torch.empty((B, T, Di), dtype=torch.float32, device="cuda")
        s_out = torch.empty((B, Di, S), dtype=torch.float32, device="cuda")
        st = torch.empty((B, -(-T // 64), Di, S), dtype=torch.float32, device="cuda")

        def call():
            err = lib.selective_scan_states_launch(
                *(t.data_ptr() for t in a), y.data_ptr(), s_out.data_ptr(), st.data_ptr(), B, T,
                Di, S, 1, torch.cuda.current_stream().cuda_stream)
            cs.require(err == 0, f"forward at kChunk 64: CUDA error {err} at launch")
            return y

        return call

    calls = {"no_states": [lambda a=a: ss.selective_scan(*a) for a in sets],
             "states16": [lambda a=a: ss.selective_scan(*a, keep_states=True) for a in sets],
             "states64": [chunk64(a) for a in sets]}
    y16, _, st16 = ss.selective_scan(*args, keep_states=True)
    y64 = calls["states64"][0]()
    torch.cuda.synchronize()
    cs.require(torch.equal(y16, y64), "the forward's y differs between state intervals")
    out = {name: [] for name in calls}
    for sweep in (list(calls), list(calls)[::-1]):
        for name in sweep:
            out[name].append(cs.graph_ms(torch, calls[name], iters=40, replays=3))
    res = {name: {"ms": sum(v) / len(v), "ms_readings": v} for name, v in out.items()}
    res["cold_sets"] = len(sets)
    res["states16_bytes"] = st16.numel() * 4
    res["states64_bytes"] = B * -(-T // 64) * Di * S * 4
    cs.log(f"forward [{B},{T},{Di}] S {S}, u bf16 (graphs over {len(sets)} sets): " + ", ".join(
        f"{n} {r['ms']:.4f} ms {r['ms_readings']}" for n, r in res.items() if n in calls))
    return res


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", type=source_arg, action="append", default=[],
                    help="another ssm_scan_bwd.cu to build, check and time as NAME")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("ssm_scan_bwd_variants.py: no CUDA device is available", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    from repro_torch.kernels import ssm_scan as ss

    smi = cs.device_line()
    cs.log(smi)
    cs.log(f"toolkit: {build.toolkit_version()}; L2 {cs.l2_bytes(torch)} bytes")
    paths, logs = build_libraries(build, dict(opts.source))
    fwd64 = paths.pop("fwd_chunk64")
    libs = {name: open_backward(path) for name, path in paths.items()}
    result = {"device": smi, "builds": {}, "shapes": {}, "ok": True}
    for name, path in paths.items():
        entries = cs.ptxas_entries(logs[name])
        spill = any(not ("0 bytes spill stores" in sp and "0 bytes spill loads" in sp)
                    for _, _, sp in entries)
        result["builds"][name] = {"ptxas": [f"{e}: {r}; {sp}" for e, r, sp in entries],
                                  "spills": spill, "sass": sass_ops(path, build),
                                  "state_interval": libs[name][1]}
        result["ok"] = result["ok"] and not spill
        cs.log(f"{name}: states every {libs[name][1]} tokens; {result['builds'][name]['ptxas']}; "
               f"SASS {result['builds'][name]['sass']}")
    gen = torch.Generator(device="cuda").manual_seed(129)
    shapes = [("training", TRAINING, torch.bfloat16, False, 0.0),
              ("training/f32/d_final", TRAINING, torch.float32, True, 0.0)]
    shapes += [(f"ragged {B}x{T}x{Di} S{S} shift {sh}", (B, T, Di, S), torch.float32, df, sh)
               for B, T, Di, S, sh, df in RAGGED]
    for tag, (B, T, Di, S), udtype, d_final, shift in shapes:
        args = cs.scan_inputs(torch, gen, B, T, Di, S, udtype, shift)
        dy = torch.randn(B, T, Di, generator=gen, device="cuda")
        dfin = torch.randn(B, Di, S, generator=gen, device="cuda") if d_final else None
        _, _, st16 = ss.selective_scan(*args, keep_states=True)
        want = ss.selective_scan_bwd_ref(*args, dy, dfin)
        scales = cs.ssm_bwd_scales(ss, args, dy, dfin)
        outs = {}
        for name, (lib, interval) in libs.items():
            outs[name] = [o.clone() for o in backward_call(
                torch, ss, name, lib, args, dy, dfin, states_every(st16, interval))()]
        torch.cuda.synchronize()
        entry = {}
        for name, got in outs.items():
            errs = cs.ssm_bwd_errors(torch, got, want, scales, udtype)
            worst = max(e["of_scale"] for e in errs.values())
            same = all(torch.equal(a, b) for a, b in zip(got, outs["shipped"]))
            entry[name] = {"worst_of_scale": worst, "same_bits_as_shipped": same,
                           "of_scale": {n: e["of_scale"] for n, e in errs.items()}}
            result["ok"] = result["ok"] and worst <= 1e-5
        result["shapes"][tag] = entry
        cs.log(f"{tag}: " + ", ".join(
            f"{n} {e['worst_of_scale']:.3g}{'' if e['worst_of_scale'] <= 1e-5 else ' OUTSIDE'}"
            f"{' (bits of shipped)' if e['same_bits_as_shipped'] else ''}"
            for n, e in entry.items()))
        del args, dy, dfin, st16, want, outs
    B, T, Di, S = TRAINING
    args = cs.scan_inputs(torch, gen, B, T, Di, S, torch.bfloat16)
    dy = torch.randn(B, T, Di, generator=gen, device="cuda")
    _, _, st16 = ss.selective_scan(*args, keep_states=True)
    sets = cs.cold_copies(torch, (*args, dy, st16), 280e6)
    calls = {name: [backward_call(torch, ss, name, lib, st[:7], st[7], None,
                                  states_every(st[8], interval)) for st in sets]
             for name, (lib, interval) in libs.items()}
    times = {name: [] for name in libs}
    order = list(libs)
    for sweep in (order, order[::-1]):
        for name in sweep:
            times[name].append(cs.graph_ms(torch, calls[name], iters=40, replays=3))
    for name, t in times.items():
        b = result["builds"][name]
        b["training_ms_readings"] = t
        b["training_ms"] = sum(t) / len(t)
        cs.log(f"{name}: training {b['training_ms']:.4f} ms {t} (device time from CUDA graphs "
               f"over {len(sets)} operand sets)")
    result["cold_sets"] = len(sets)
    del args, dy, st16, sets, calls
    torch.cuda.empty_cache()
    result["forward"] = time_forward(torch, ss, gen, fwd64)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "ssm_scan_bwd_variants.json").write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
