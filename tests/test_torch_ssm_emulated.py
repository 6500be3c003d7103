"""The selective scan's CUDA sources (``csrc/ssm_scan.cu``, the forward, and
``csrc/ssm_scan_bwd.cu``, the backward), built for the CPU by g++ with the
stand-ins under ``tools/cuda_emu/`` (a thread per CUDA thread, barriers for
``__syncthreads``, shuffles through a per-warp array, each ``cp.async`` copy
made when its group is waited for, 2^x from the C library), held against
``selective_scan_ref`` and ``selective_scan_bwd_ref`` within the card's
bounds (``tools/ssm_emulate.py``: 1e-5 of each output's largest entry, the
chunk-start states against the plain loop's h at those tokens, the sums
over channels or tokens within 1e-5 of their largest sum of the terms'
magnitudes), and run under ThreadSanitizer, which must report no race
between the emulated threads. This checks the sources' indexing, staging,
barriers and arithmetic without a card, not what the CUDA compiler makes
of them: on the card the forward is held bit for bit against its first
design, which the stand-in's 2^x cannot show."""
import shutil
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
import ssm_emulate as emu  # noqa: E402

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="needs g++ to build the CUDA source for the CPU")


@pytest.fixture(scope="module")
def libs():
    # A stage or tile read before its wait and barrier reads the NaN fill.
    return emu.build_all(defer_cp=True)


def _fwd_id(case):
    B, T, Di, S, bf16, shift = case
    return f"{B}x{T}x{Di}-S{S}-{'bf16' if bf16 else 'f32'}{f'-shift{shift:g}' if shift else ''}"


def _bwd_id(case):
    B, T, Di, S, bf16, d_final, shift = case
    return (f"{B}x{T}x{Di}-S{S}-{'bf16' if bf16 else 'f32'}{'-dfinal' if d_final else ''}"
            f"{f'-shift{shift:g}' if shift else ''}")


@pytest.mark.parametrize("case", emu.FWD_CASES, ids=_fwd_id)
def test_emulated_forward_matches_plain(libs, case):
    res = emu.run_forward(libs["ssm_scan"], *case)
    outside = {n: v for n, v in res.items() if not v <= emu.BOUND}
    assert not outside, f"outside the bound (error over the scale): {outside}"


@pytest.mark.parametrize("case", emu.BWD_CASES, ids=_bwd_id)
def test_emulated_backward_matches_plain(libs, case):
    res = emu.run_backward(libs["ssm_scan_bwd"], libs["ssm_scan"], *case)
    outside = {n: v for n, v in res.items() if not v <= emu.BOUND}
    assert not outside, f"outside the bound (error over the scale): {outside}"


@pytest.mark.parametrize("defer_cp", [False, True], ids=["copy-at-once", "copy-at-wait"])
def test_emulated_kernels_have_no_race(defer_cp):
    if emu.tsan_runtime() is None:
        pytest.skip("g++ has no ThreadSanitizer runtime")
    # The forward's two chunks in bf16 and the backward's two chunks of one
    # block, both through the 16-byte copies: the barriers are the same for
    # every shape, and a larger case takes minutes here.
    ok, races, text = emu.run_under_tsan(defer_cp, fwd="2", bwd="5")
    assert races == 0, f"ThreadSanitizer reported {races} race(s):\n{text[-6000:]}"
    assert ok, text[-3000:]
