#!/usr/bin/env python3
"""Time variants of the moe dispatch and combine kernels on one NVIDIA card.

    python3 tools/moe_variants.py [--source NAME=PATH ...]

Run from the root of a checkout on a host with a CUDA card and the CUDA
toolkit. It builds, side by side (one nvcc each, all started together):

* ``shipped``: ``src/repro_torch/kernels/csrc/moe_dispatch.cu`` as the port
  builds it;
* ``plain_stores``: the same source with the gather's output stored with
  the default cache policy, not streaming (evict-first);
* each ``--source NAME=PATH``: another ``moe_dispatch.cu`` with the same C
  entry points, such as the parent commit's unpacked by ``git archive``.

At granite-moe-1b-a400m's training, prefill and decode shapes in bf16
(``chip_smoke.MOE_SHAPES``) it holds every library's dispatch, scaled
gather and combine (with and without weights) against the shipped
kernel's outputs bit for bit (the shipped kernel is held against the plain
versions by ``chip_smoke.moe_errors`` first). Then it times each library's
dispatch, scaled gather and combine, beside ``index_select`` and
``embedding_bag`` (``chip_smoke.moe_library``), twice in turns (every
library forward, then in reverse), each from a CUDA graph of calls over
operand sets that together move four times the L2 cache
(``chip_smoke.graph_ms``, ``chip_smoke.cold_copies``): no host work
between the launches, and every call's operands in HBM. At the training
and prefill shapes it also times each library's dispatch followed by the
two expert products that read its output (``models/moe.py::experts``:
``bmm`` by ``wg`` and ``wi``, d_ff 512), and the two products alone on the
dispatch's outputs: where the dispatch leaves its output in L2, the
products that follow read it from there. It reports each launch's grid and
warps an SM (``moe_launch_plan``; for a library without it, one warp a row
in blocks of 8 and the blocks that its ptxas register counts let fit on an
SM), and from ``cuobjdump -sass`` how many 128-bit global loads each
combine and gather kernel issues before its first FFMA (combine) or global
store (gather). It prints the card's name and power limit first, writes
everything to ``chiprun_out/moe_variants.json`` and prints one JSON object
with every time as its last line.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
import chip_smoke as cs  # noqa: E402  (the card harness: cuda_ms, moe_case, moe_errors, ...)

NAME = "moe_dispatch"
VARIANTS = {
    "shipped": [],
    "plain_stores": [("__stcs(p, v); }", "*p = v; }")],
}
D_FF = 512  # granite-moe-1b-a400m's experts' width
P, I64, I32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int


def build_libraries(build, others: dict) -> tuple[dict, dict]:
    """Every library, built side by side; returns ({name: path}, {name:
    nvcc output})."""
    paths = {}
    src = (build.CSRC / f"{NAME}.cu").read_text()
    out_dir = build.BUILD_DIR / "moe_variants"
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
    procs = {}
    for name, cu in sources.items():
        paths[name] = out_dir / f"lib{NAME}-{name}.so"
        procs[name] = subprocess.Popen(
            [build.nvcc_path(), *build.nvcc_flags(NAME), "-o", str(paths[name]), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    logs = {}
    for name, proc in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{logs[name]}")
    return paths, logs


def open_library(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for fn in (lib.moe_gather_launch, lib.moe_combine_launch):
        fn.argtypes = [P] * 4 + [I64, I32, I32, I32, P]
        fn.restype = I32
    if hasattr(lib, "moe_launch_plan"):
        lib.moe_launch_plan.argtypes = [I32, I64, I32, I32, I32, I32, P]
        lib.moe_launch_plan.restype = I32
    return lib


def launchers(torch, name, lib, r, ops) -> dict:
    """{"gather", "gather_scaled", "combine", "combine_unit"}: a launch of
    each on one operand set ``ops`` = (x, y, dout, w, gather's output,
    combine's output), returning the output (checked for errors)."""
    x, y, dout, w, g_out, c_out = ops
    S, D = x.shape
    k, rows = r.gate_idx.shape[1], r.slot.numel()

    def stream():  # the current one: a graph captures on its own stream
        return torch.cuda.current_stream().cuda_stream

    def check(err, what):
        cs.require(err == 0, f"{name} {what}: CUDA error {err} at launch")

    def gather(src, scale):
        check(lib.moe_gather_launch(src.data_ptr(), r.slot.data_ptr(),
                                    None if scale is None else scale.data_ptr(),
                                    g_out.data_ptr(), rows, D, k, 1, stream()), "gather")
        return g_out

    def combine(wt):
        check(lib.moe_combine_launch(y.data_ptr(), r.row.data_ptr(),
                                     None if wt is None else wt.data_ptr(), c_out.data_ptr(), S,
                                     D, k, 1, stream()), "combine")
        return c_out

    return {"gather": lambda: gather(x, None), "gather_scaled": lambda: gather(dout, w),
            "combine": lambda: combine(w), "combine_unit": lambda: combine(None)}


def old_plan(regs: int, rows: int, sms: int) -> dict:
    """The first design's launch: one warp a row in blocks of 8, as many
    blocks on an SM as 256 threads of `regs` registers allow (registers are
    given out 256 a warp)."""
    per_block = 8 * -(-regs * 32 // 256) * 256
    fit = min(8, 65536 // per_block)
    blocks = -(-rows // 8)
    return {"blocks": blocks, "blocks_per_sm": fit, "sms": sms, "per": 1, "tasks": rows,
            "warps_per_sm": blocks * 8 / sms,
            "resident_warps_per_sm": min(blocks, fit * sms) * 8 / sms}


def loads_before(sass: str) -> dict:
    """For each moe gather or combine kernel in a library's SASS: the
    128-bit global loads before its first FFMA (combine) or global store
    (gather), and in all."""
    out = {}
    for chunk in sass.split("Function : ")[1:]:
        name, body = chunk.split("\n", 1)
        name = name.strip()
        if shutil.which("c++filt"):
            name = subprocess.run(["c++filt", name], capture_output=True, text=True).stdout.strip()
        kind = "combine" if "moe_combine" in name else "gather" if "moe_gather" in name else None
        if kind is None:
            continue
        stop = "FFMA" if kind == "combine" else "STG"
        before, seen_stop = 0, False
        total = 0
        for line in body.splitlines():
            ins = re.search(r"\*/\s+(@!?P\d+\s+)?([A-Z0-9_.]+)", line)
            if not ins:
                continue
            op = ins.group(2)
            if op.startswith("LDG") and ".128" in op:
                total += 1
                before += not seen_stop
            if op.startswith(stop):
                seen_stop = True
        out[name] = {f"ldg128_before_first_{stop.lower()}": before, "ldg128": total}
    return out


def source_arg(text: str) -> tuple[str, Path]:
    name, _, path = text.partition("=")
    if not name or not path or name in VARIANTS:
        raise argparse.ArgumentTypeError(f"want NAME=PATH with a new NAME, got {text!r}")
    return name, Path(path)


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", type=source_arg, action="append", default=[],
                    help="another moe_dispatch.cu to build and time as NAME")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("moe_variants.py: no CUDA device is available", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    from repro_torch.kernels import moe_dispatch as md

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = cs.device_line()
    cs.log(smi)
    cs.log(f"toolkit: {build.toolkit_version()}; L2 {cs.l2_bytes(torch)} bytes")
    paths, logs = build_libraries(build, dict(args.source))
    result = {"device": smi, "libraries": {}, "shapes": {}}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    regs = {}
    for name, path in paths.items():
        entries = cs.ptxas_entries(logs.get(name, ""))
        for entry, reg, spill in entries:
            cs.log(f"  {name}: {entry}: {reg}; {spill}")
            m = re.search(r"(\d+) registers", reg)
            if m:
                regs.setdefault(name, {})[entry] = int(m.group(1))
        sass = loads_before(cs.sass_text(path, build))
        for fn, counts in sass.items():
            cs.log(f"  {name}: {fn}: {counts}")
        result["libraries"][name] = {"ptxas": [list(e) for e in entries], "sass": sass}
    libs = {name: open_library(path) for name, path in paths.items()}
    gen = torch.Generator(device="cuda").manual_seed(127)
    for shape, (S, k, E, C, D) in cs.MOE_SHAPES.items():
        r, x, y, dout, w = cs.moe_case(torch, md, gen, S, k, E, C, D, torch.bfloat16)
        if shape == "training":
            errs = cs.moe_errors(torch, md, r, x, y, dout, w)
            cs.log(f"shipped kernels at the training shape against the plain versions: {errs}")
        nbytes = cs.moe_bytes(r, D, 2)
        sets = [(*op, torch.empty((E, C, D), dtype=x.dtype, device=x.device),
                 torch.empty_like(x))
                for op in cs.cold_copies(torch, (x, y, dout, w), min(nbytes.values()))]
        calls = {name: [launchers(torch, name, lib, r, op) for op in sets]
                 for name, lib in libs.items()}
        want = {op: fn().clone() for op, fn in calls["shipped"][0].items()}
        entry = {"shape": [S, k, E, C, D], "kept": int(r.keep.sum()), "cold_sets": len(sets),
                 "plans": {}, "bytes": nbytes, "ms": {}}
        for name, per_set in calls.items():
            for op, fn in per_set[0].items():
                got = fn()
                torch.cuda.synchronize()
                cs.require(torch.equal(got, want[op]),
                           f"{name} {op} at the {shape} shape differs from the shipped kernel")
            if hasattr(libs[name], "moe_launch_plan"):
                for kernel, rows in (("gather", E * C), ("gather_scaled", E * C),
                                     ("combine", S)):
                    out = (ctypes.c_int * 4)()
                    kid = md._PLAN_KERNELS[kernel]
                    cs.require(libs[name].moe_launch_plan(kid, rows, D, k, 1, 1, out) == 0,
                               f"{name}: moe_launch_plan failed")
                    blocks, fit, n_sm, per = out
                    entry["plans"][f"{name}/{kernel}"] = {
                        "blocks": blocks, "blocks_per_sm": fit, "sms": n_sm, "per": per,
                        "warps_per_sm": blocks * 8 / n_sm}
            else:
                for kernel, rows in (("gather", E * C), ("combine", S)):
                    reg = next((v for e, v in regs.get(name, {}).items()
                                if f"moe_{kernel}_kernel<__nv_bfloat16, true" in e), None)
                    if reg is not None:
                        entry["plans"][f"{name}/{kernel}"] = old_plan(reg, rows, sms)
        for key, plan in entry["plans"].items():
            cs.log(f"  {shape}: {key}: {plan}")
        timed = {f"{name}/{op}": [ops[op] for ops in per_set]
                 for name, per_set in calls.items()
                 for op in ("gather", "gather_scaled", "combine")}
        library = [cs.moe_library(torch, r, op[0], op[1], op[3]) for op in sets]
        for op in library[0]:
            timed[f"library/{op.removeprefix('moe_')}"] = [lib[op] for lib in library]
        if shape != "decode":
            gen_w = torch.Generator(device="cuda").manual_seed(128)
            wg, wi = (torch.randn(E, D, D_FF, generator=gen_w, device="cuda").to(x.dtype)
                      for _ in range(2))

            def products(o):
                return torch.bmm(o, wg), torch.bmm(o, wi)

            timed["products"] = [lambda o=op[4]: products(o) for op in sets]
            for name, per_set in calls.items():
                timed[f"{name}/gather+products"] = [
                    lambda g=ops["gather"]: products(g()) for ops in per_set]
        readings = {key: [] for key in timed}
        order = list(timed)
        for sweep in (order, order[::-1]):
            for key in sweep:
                readings[key].append(cs.graph_ms(torch, timed[key]))
        for key, vals in readings.items():
            op = key.split("/")[-1]
            mean = sum(vals) / 2
            item = {"ms": mean, "readings": vals}
            if op in ("gather", "gather_scaled", "combine"):
                bound = nbytes["moe_gather_scaled" if op == "gather_scaled"
                               else f"moe_{op}"] / cs.HBM_BYTES_PER_S * 1e3
                item.update(bound_ms=bound, bound_share=bound / mean)
            entry["ms"][key] = item
            cs.log(f"{shape} {key}: {mean:.4f} ms {vals}"
                   + (f", bound {item['bound_ms']:.4f} ms (share {item['bound_share']:.3f})"
                      if "bound_ms" in item else ""))
        result["shapes"][shape] = entry
        del r, x, y, dout, w, calls, want, timed, sets, library
        torch.cuda.empty_cache()
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "moe_variants.json").write_text(json.dumps(result, indent=1))
    print(json.dumps({"device": smi, "ms": {shape: {k: round(v["ms"], 5)
                                                    for k, v in e["ms"].items()}
                                            for shape, e in result["shapes"].items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
