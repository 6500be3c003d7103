"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Every source under ``kernels/csrc/`` is a plain-C-interface shared library
(no PyTorch headers, so a build takes seconds). It is compiled at first use
for ``sm_90a`` into ``build/repro_torch/`` at the root of the checkout,
under a name that carries a hash of the source, the ``csrc/*.cuh`` headers
it includes and the flags, so an edited source or header is rebuilt and a
stale library is never loaded. Nothing here runs at import time: the
CPU-only test host has no ``nvcc`` and imports every module.

``build_all()`` starts one ``nvcc`` per source, all at once, and waits for
them; ``load(name)`` returns the loaded library (building it if needed).
A failed build raises -- there is no fallback.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("mtgc_update", "quantize", "flash_attention", "flash_attention_bwd", "rwkv6_scan",
           "rwkv6_scan_bwd", "ssm_scan", "ssm_scan_bwd", "moe_dispatch")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# Flags of single libraries, after NVCC_FLAGS. The element-wise kernels
# (mtgc_update, quantize) are bit-exact against their plain versions: every
# rounding is explicit in their sources, and nvcc must not contract any
# remaining a * b + c into an FMA. The attention and scan kernels reorder
# their sums anyway and write their FMAs out. ptxas of CUDA 12.9 at its
# default -O3, and at -O2, compiles the scan backward's C' pass
# (rwkv6_bwd_chunk_out_kernel) into code whose outputs come out NaN and
# differ from call to call, where the same PTX through ptxas -O1 matches the
# plain version to float32 rounding; the cause is not isolated.
# tools/scan_bwd_ptxas_check.py builds and runs that library without the
# flag beside this one, with the toolkit's version and both times.
EXTRA_FLAGS = {
    "mtgc_update": ("-fmad=false",),
    "quantize": ("-fmad=false",),
    "rwkv6_scan_bwd": ("-Xptxas", "-O1"),
}


def nvcc_flags(name: str) -> tuple:
    """The flags ``csrc/<name>.cu`` is compiled with."""
    return NVCC_FLAGS + EXTRA_FLAGS.get(name, ())


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else ``/usr/local/cuda/bin/nvcc``. Raises when none exists."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError(
        "nvcc not found (checked $CUDA_HOME/bin, PATH, /usr/local/cuda/bin): "
        "the port's CUDA kernels cannot be built on this host")


def toolkit_version() -> str:
    """The last line of ``nvcc --version`` (the compiler's release and
    build), for logs that tie a library to the toolkit that built it."""
    out = subprocess.run([nvcc_path(), "--version"], capture_output=True, text=True,
                         timeout=60, check=True).stdout
    return out.strip().splitlines()[-1]


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+\.cuh)"', re.M)


def source_files(name: str) -> list:
    """``csrc/<name>.cu`` and every ``csrc`` header it includes, directly
    or through another header, in the order they are first reached."""
    files, todo = [], [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in files:
            continue
        files.append(path)
        todo += [CSRC / inc.decode() for inc in _INCLUDE.findall(path.read_bytes())]
    return files


def library_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` lives: its tag hashes
    the source, its headers and the flags."""
    h = hashlib.sha256()
    for path in source_files(name):
        h.update(path.read_bytes())
    h.update(" ".join(nvcc_flags(name)).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_all(names=SOURCES) -> dict:
    """Compile every named source that has no up-to-date library, one
    ``nvcc`` process per source, all started together. Returns
    ``{"seconds": wall time, "log": {name: nvcc output}}`` (empty log for a
    library that was already built). Raises if any build fails."""
    t0 = time.perf_counter()
    log, procs = {}, {}
    for name in names:
        out = library_path(name)
        if out.exists():
            log[name] = ""
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *nvcc_flags(name), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"nvcc failed on csrc/{name}.cu (exit {proc.returncode}):\n"
                          f"{log[name]}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return {"seconds": time.perf_counter() - t0, "log": log}


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    build_all((name,))
    lib = ctypes.CDLL(str(library_path(name)))
    _declare(name, lib)
    return lib


def _declare(name: str, lib: ctypes.CDLL) -> None:
    """argtypes/restype of every exported function: pointers and the
    stream as ``c_void_p`` (a bare Python int would be cut to 32 bits)."""
    p, i64, f32, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_float, ctypes.c_int
    if name == "mtgc_update":
        lib.mtgc_update_flat_launch.argtypes = [
            p, p, p, p, p, p, i64, i64, i64, f32, f32, i32, i32, p]
        lib.mtgc_update_flat_launch.restype = i32
        lib.mtgc_update_leaf_launch.argtypes = [
            p, p, p, p, p, i64, f32, f32, i32, i32, p]
        lib.mtgc_update_leaf_launch.restype = i32
    elif name == "quantize":
        lib.int8_roundtrip_launch.argtypes = [p, p, p, p, i64, i64, i32, p]
        lib.int8_roundtrip_launch.restype = i32
        lib.topk_mask_launch.argtypes = [p, p, p, i64, i64, i32, p]
        lib.topk_mask_launch.restype = i32
    elif name == "flash_attention":
        lib.flash_attention_launch.argtypes = [p] * 6 + [i32] * 9 + [f32, i32, p]
        lib.flash_attention_launch.restype = i32
        lib.flash_attention_smem_bytes.argtypes = [i32]
        lib.flash_attention_smem_bytes.restype = i32
    elif name == "flash_attention_bwd":
        lib.flash_attention_bwd_launch.argtypes = [p] * 13 + [i32] * 9 + [f32, i32, p]
        lib.flash_attention_bwd_launch.restype = i32
        lib.flash_attention_bwd_smem_bytes.argtypes = [i32, i32]
        lib.flash_attention_bwd_smem_bytes.restype = i32
        lib.flash_attention_bwd_dvec_floats.argtypes = [i32, i32]
        lib.flash_attention_bwd_dvec_floats.restype = i32
    elif name == "rwkv6_scan":
        lib.rwkv6_scan_launch.argtypes = [p] * 10 + [i32] * 5 + [i64] * 4 + [i32, p]
        lib.rwkv6_scan_launch.restype = i32
        lib.rwkv6_scan_smem_bytes.argtypes = [i32]
        lib.rwkv6_scan_smem_bytes.restype = i32
    elif name == "rwkv6_scan_bwd":
        lib.rwkv6_scan_bwd_launch.argtypes = [p] * 18 + [i32] * 5 + [i64] * 3 + [i32, p]
        lib.rwkv6_scan_bwd_launch.restype = i32
        lib.rwkv6_scan_bwd_smem_bytes.argtypes = [i32, i32]
        lib.rwkv6_scan_bwd_smem_bytes.restype = i32
        lib.rwkv6_scan_bwd_blocks_per_sm.argtypes = [i32, i32]
        lib.rwkv6_scan_bwd_blocks_per_sm.restype = i32
    elif name == "ssm_scan":
        lib.selective_scan_launch.argtypes = [p] * 9 + [i32] * 5 + [p]
        lib.selective_scan_launch.restype = i32
        lib.selective_scan_states_launch.argtypes = [p] * 10 + [i32] * 5 + [p]
        lib.selective_scan_states_launch.restype = i32
        lib.selective_scan_chunk.argtypes = []
        lib.selective_scan_chunk.restype = i32
    elif name == "ssm_scan_bwd":
        lib.selective_scan_bwd_launch.argtypes = [p] * 19 + [i32] * 5 + [p]
        lib.selective_scan_bwd_launch.restype = i32
        lib.selective_scan_bwd_smem_bytes.argtypes = [i32, i32]
        lib.selective_scan_bwd_smem_bytes.restype = i32
        lib.selective_scan_bwd_blocks_per_sm.argtypes = [i32, i32]
        lib.selective_scan_bwd_blocks_per_sm.restype = i32
        lib.selective_scan_bwd_state_interval.argtypes = []
        lib.selective_scan_bwd_state_interval.restype = i32
        for fn in (lib.selective_scan_bwd_scratch_floats, lib.selective_scan_bwd_grid):
            fn.argtypes, fn.restype = [i32] * 5, i64
        lib.selective_scan_bwd_exp2_count.argtypes = [i32] * 4
        lib.selective_scan_bwd_exp2_count.restype = i64
    elif name == "moe_dispatch":
        for fn in (lib.moe_gather_launch, lib.moe_combine_launch, lib.moe_gate_grad_launch):
            fn.argtypes = [p] * 4 + [i64, i32, i32, i32, p]
            fn.restype = i32
        lib.moe_launch_plan.argtypes = [i32, i64, i32, i32, i32, i32, p]
        lib.moe_launch_plan.restype = i32
