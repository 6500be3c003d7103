"""The moe dispatch kernels' CUDA source (``csrc/moe_dispatch.cu``), built
for the CPU by g++ with the stand-ins under ``tools/cuda_emu/`` (a thread
per CUDA thread, the blocks one after another, a barrier for
``__syncwarp``, shuffles through a per-warp array), and held against the
plain versions in ``kernels/moe_dispatch.py``: ``moe_gather`` bit for bit
(with and without a scale), ``moe_combine`` (with and without weights) and
``moe_gate_grad`` within their float32 sums' rounding and one rounding of
the output. The cases reach the 16-byte vector path and the scalar one,
drops, k = 8 (the combine's templated case) beside k = 1, 2, 3, 6, 10 and
12 (its generic one, which loads a token's rows in predicated groups of 4:
6 and 10 end on a partial group after full ones, 12 takes three full ones),
rows of more than one pass of the gather's 4 loads a lane, decode's shape,
and both regimes of the combine's split: the stand-in device has 2 SMs and
one block a kernel on each (16 warps), so a token's D goes to more than
one warp in the cases of fewer than 16 tokens and to one warp in the
others. A block's statically sized ``__shared__`` arrays become ``static``
arrays, one per kernel instance: the emulated blocks run one after another,
so each block's threads share them as on the card. This checks the
source's indexing, staging and arithmetic without a card, not what the
CUDA compiler makes of it."""
import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import moe_dispatch as md  # noqa: E402

EMU = Path(__file__).resolve().parents[1] / "tools" / "cuda_emu"


def translate(source: str) -> str:
    """The source as C++ for the stand-ins: static shared arrays, and the
    ``<<<...>>>`` launches as ``emu_launch`` calls."""
    source = source.replace("__shared__ ", "static ")
    return re.sub(r"(\w+(?:<[\w, ]+>)?)<<<(.*?)>>>\((.*?)\);", r"emu_launch(\1, \2, \3);",
                  source, flags=re.S)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the CUDA source for the CPU")
    out = tmp_path_factory.mktemp("moe_emu")
    (out / "kernel.cpp").write_text(translate((build.CSRC / "moe_dispatch.cu").read_text()))
    so = out / "libmoe_emu.so"
    subprocess.run(["g++", "-std=c++20", "-O1", "-shared", "-fPIC", f"-I{EMU}", "-o", str(so),
                    str(out / "kernel.cpp"), "-lpthread"], capture_output=True, text=True,
                   timeout=600, check=True)
    handle = ctypes.CDLL(str(so))
    build._declare("moe_dispatch", handle)
    return handle


def _case(S, k, E, C, D, dtype, seed):
    gen = torch.Generator().manual_seed(seed)
    idx = torch.rand(S, E, generator=gen).argsort(-1)[:, :k]
    flat = torch.nn.functional.one_hot(idx, E).reshape(S * k, E)
    pos = ((torch.cumsum(flat, 0) - 1) * flat).sum(-1).reshape(S, k)
    r = md.make_routing(idx, pos, pos < C, E, C)

    def randn(*shape):
        return torch.randn(*shape, generator=gen).to(dtype)

    w = torch.softmax(torch.randn(S, k, generator=gen), -1).to(dtype)
    return r, randn(S, D), randn(E, C, D), randn(S, D), w


def _ulps(t, dtype):
    bits = 7 if dtype == torch.bfloat16 else 23
    return torch.exp2(torch.floor(torch.log2(t.float().abs().clamp_min(2.0 ** -126))) - bits)


CASES = [
    (20, 3, 5, 6, 64),     # drops; vectors (16 bytes: 4 float32 or 8 bf16)
    (13, 2, 4, 13, 36),    # dropless; float32 vectors, bf16 scalar
    (9, 1, 3, 2, 10),      # k = 1, drops, scalar; fewer tasks than the grid's warps
    (300, 8, 32, 40, 256),  # k = 8, drops; every loop over tasks runs several times
    (4, 8, 32, 4, 1024),   # decode's shape: dropless, a token's D over 4 warps
    (37, 8, 16, 12, 100),  # k = 8, drops; float32 vectors, bf16 scalar
    (20, 12, 16, 20, 64),  # k = 12: three full load groups of the combine
    (24, 6, 16, 12, 64),   # k = 6: a full load group, then a partial one
    (30, 10, 16, 24, 1100),  # k = 10: two full groups, then a partial one; rows of 3-9 passes
]


def _plan(lib, kernel, rows, D, k, dtype):
    """(blocks, warps a row, warp tasks) of one launch."""
    out = (ctypes.c_int * 4)()
    vec = int(D % (16 // dtype.itemsize) == 0)
    assert lib.moe_launch_plan(kernel, rows, D, k, int(dtype == torch.bfloat16), vec, out) == 0
    per = out[3]
    return out[0], per, rows * per


@pytest.mark.parametrize("S,k,E,C,D", CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_emulated_kernels_match_plain(lib, S, k, E, C, D, dtype):
    r, x, y, dout, w = _case(S, k, E, C, D, dtype, S + D)
    bf = int(dtype == torch.bfloat16)
    got = torch.empty(E, C, D, dtype=dtype)
    for src, scale in ((x, None), (dout, w)):
        assert lib.moe_gather_launch(src.data_ptr(), r.slot.data_ptr(), md._ptr(scale),
                                     got.data_ptr(), E * C, D, k, bf, None) == 0
        assert torch.equal(got, md.moe_gather_ref(src, r, scale))
    yabs = y.float().abs()
    out = torch.empty(S, D, dtype=dtype)
    for weights in (w, None):
        assert lib.moe_combine_launch(y.data_ptr(), r.row.data_ptr(), md._ptr(weights),
                                      out.data_ptr(), S, D, k, bf, None) == 0
        want = md.moe_combine_ref(y, r, weights)
        mag = md.moe_combine_ref(yabs, r, None if weights is None else weights.float().abs())
        assert ((out.float() - want.float()).abs()
                <= k * 2.0 ** -23 * mag + _ulps(want, dtype)).all()
    dg = torch.empty(S, k, dtype=dtype)
    assert lib.moe_gate_grad_launch(dout.data_ptr(), y.data_ptr(), r.row.data_ptr(),
                                    dg.data_ptr(), S, D, k, bf, None) == 0
    want = md.moe_gate_grad_ref(dout, y, r)
    mag = md.moe_gate_grad_ref(dout.float().abs(), yabs, r)
    assert ((dg.float() - want.float()).abs() <= D * 2.0 ** -23 * mag + _ulps(want, dtype)).all()
    assert (dg[~r.keep] == 0).all()


def test_emulated_launch_refuses_what_the_kernels_do_not_take(lib):
    r, x, _, _, _ = _case(4, 2, 3, 4, 8, torch.float32, 0)
    out = torch.empty(3, 4, 8)
    assert lib.moe_gather_launch(x.data_ptr(), r.slot.data_ptr(), None, out.data_ptr(), 12, 8,
                                 33, 0, None) == -1          # k past 32
    assert lib.moe_gather_launch(x.data_ptr(), r.slot.data_ptr(), None, out.data_ptr(), 12, 0,
                                 2, 0, None) == -1           # no width


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_emulated_cases_reach_both_grid_regimes(lib, dtype):
    """The grids as the stand-in device sizes them (2 SMs, one block each,
    so 16 warps fit): the gather one warp a slot row in blocks of 8; the
    combine one warp a task, a token's D split over ``parts`` warps,
    doubled while a part keeps at least one 32-lane chunk and the tasks
    are fewer than the warps that fit; among the cases, tokens split over
    several warps and tokens on one."""
    parts = []
    for S, k, E, C, D in CASES:
        for kernel in (0, 1):
            assert _plan(lib, kernel, E * C, D, k, dtype) == (-(-E * C // 8), 1, E * C)
        grid, per, tasks = _plan(lib, 2, S, D, k, dtype)
        n = 16 // dtype.itemsize
        chunks = -(-(D // n if D % n == 0 else D) // 32)
        want = 1
        while want * 2 <= chunks and S * want < 16:
            want *= 2
        assert (grid, per, tasks) == (-(-S * want // 8), want, S * want)
        parts.append(per)
    assert max(parts) > 1 and min(parts) == 1, parts
