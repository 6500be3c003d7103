"""The scan backward's CUDA source (``csrc/rwkv6_scan_bwd.cu``), built for the
CPU by g++ with the stand-ins under ``tools/cuda_emu/`` (a thread per CUDA
thread, barriers for ``__syncthreads``, the mma fragments exchanged across
the warp), held against ``rwkv6_scan_bwd_ref`` within the kernel's
contract, and run under ThreadSanitizer, which must report no race between
the emulated threads (``tools/scan_bwd_emulate.py``). This checks the
source's indexing, barriers and arithmetic without a card, not what the
CUDA compiler makes of it."""
import shutil
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
import scan_bwd_emulate as emu  # noqa: E402

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="needs g++ to build the CUDA source for the CPU")


def _case_id(case):
    B, T, H, Dh, C, bf16, d_final, strong = case
    return (f"{B}x{T}x{H}x{Dh}-C{C}-{'bf16' if bf16 else 'f32'}"
            f"{'-dfinal' if d_final else ''}{'-strong' if strong else ''}")


@pytest.fixture(scope="module")
def lib():
    # Each cp.async copy is made when its group is waited for: a tile read
    # before its wait and barrier reads the NaN fill.
    return emu.load(emu.build_library(defer_cp=True))


@pytest.mark.parametrize("case", emu.CASES, ids=_case_id)
def test_emulated_kernel_matches_plain(lib, case):
    res = emu.run_case(lib, *case)
    outside = {n: v["of_largest"] for n, v in res.items() if not v["within"]}
    assert not outside, f"outside the contract (error over the largest entry): {outside}"


@pytest.mark.parametrize("defer_cp", [False, True], ids=["copy-at-once", "copy-at-wait"])
def test_emulated_kernel_has_no_race(defer_cp):
    if emu.tsan_runtime() is None:
        pytest.skip("g++ has no ThreadSanitizer runtime")
    # One ragged chunk in bf16 through the 16-byte copies: the barriers are
    # the same for every shape, and a larger case takes minutes here.
    ok, races, text = emu.run_under_tsan(defer_cp, cases="3")
    assert races == 0, f"ThreadSanitizer reported {races} race(s):\n{text[-6000:]}"
    assert ok, text[-3000:]
