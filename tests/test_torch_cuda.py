"""The port on a CUDA card: the hand-written kernels against their plain
PyTorch versions (the element-wise kernels bit-exact in float32 and
bfloat16; the attention and RWKV kernels, which reorder sums, within
float32 rounding), small rounds of the engine on the card against the same
rounds on the CPU (also through the legacy ``make_global_round``), the
ResNet's stride-2 SAME convolution on the card against the CPU, reduced LM serving on the card against the CPU (the
audio and vlm families with their frames and patches, and their loss,
every gradient, prefill and decode), the
RWKV scan's backward kernel against its plain version and the float64
definition of its gradients, the hybrid family's selective scan
against its plain sequential loop and its backward against the plain
reverse loop, and the moe family's dispatch, combine
and gate-gradient kernels against their one-hot einsum forms.

Every test here needs a card and skips without one. The module imports no
JAX, so it runs on a GPU host that has only PyTorch:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py
"""
import math

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch import api, convert  # noqa: E402
from repro_torch.core.engine import RoundDraws  # noqa: E402
from repro_torch.core.participation import ParticipationMasks  # noqa: E402
from repro_torch.kernels import mtgc_update as mu  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import moe_dispatch as md  # noqa: E402
from repro_torch.kernels import quantize as qz  # noqa: E402
from repro_torch.kernels import rwkv6_scan as rs  # noqa: E402
from repro_torch.kernels import ssm_scan as ss  # noqa: E402
from repro_torch.models import small  # noqa: E402


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("G,K,N,masked", [(2, 2, 300, False), (3, 1, 1, True),
                                          (1, 4, 128 * 9 + 5, True), (10, 10, 4099, True)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flat_kernel_matches_plain(cuda, G, K, N, masked, dtype):
    gen = torch.Generator(device=cuda).manual_seed(G + K + N)
    x, g, z = (torch.randn(G, K, N, generator=gen, device=cuda).to(dtype) for _ in range(3))
    y = torch.randn(G, N, generator=gen, device=cuda).to(dtype)
    mask = ((torch.rand(G, K, generator=gen, device=cuda) < 0.5).float()
            if masked else None)
    before = mu.mtgc_update_flat.launches
    got = mu.mtgc_update_flat(x, g, z, y, mask, lr=0.07, g_scale=0.5)
    torch.cuda.synchronize()
    assert mu.mtgc_update_flat.launches == before + 1
    assert torch.equal(got, mu.mtgc_update_flat_ref(x, g, z, y, mask, 0.07, 0.5))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flat_kernel_in_place(cuda, masked, dtype):
    """``out=x``, the sharded trainer's fused step: the kernel writes the
    update over x and gives the out-of-place result bit for bit; frozen
    replicas keep their bits."""
    gen = torch.Generator(device=cuda).manual_seed(9)
    x, g, z = (torch.randn(3, 2, 5003, generator=gen, device=cuda).to(dtype) for _ in range(3))
    y = torch.randn(3, 5003, generator=gen, device=cuda).to(dtype)
    mask = torch.tensor([[1.0, 0.0], [1.0, 1.0], [0.0, 1.0]], device=cuda) if masked else None
    want = mu.mtgc_update_flat_ref(x, g, z, y, mask, 0.07, 0.5)
    assert mu.mtgc_update_flat(x, g, z, y, mask, lr=0.07, g_scale=0.5, out=x) is x
    torch.cuda.synchronize()
    assert torch.equal(x, want)


def test_flat_kernel_mixed_storage(cuda):
    """float32 params with bfloat16 corrections (the reference's narrow z/y
    option): the sum still runs in float32."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    x, g = (torch.randn(2, 3, 777, generator=gen, device=cuda) for _ in range(2))
    z = torch.randn(2, 3, 777, generator=gen, device=cuda).to(torch.bfloat16)
    y = torch.randn(2, 777, generator=gen, device=cuda).to(torch.bfloat16)
    got = mu.mtgc_update_flat(x, g, z, y, lr=0.1)
    assert torch.equal(got, mu.mtgc_update_flat_ref(x, g, z, y, None, 0.1))


@pytest.mark.parametrize("shape", [(5,), (1000,), (33, 129), (10, 10, 5, 5, 3, 32)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_leaf_kernel_matches_plain(cuda, shape, dtype):
    gen = torch.Generator(device=cuda).manual_seed(len(shape))
    a = [torch.randn(shape, generator=gen, device=cuda).to(dtype) for _ in range(4)]
    before = mu.mtgc_update.launches
    got = mu.mtgc_update(*a, lr=0.1)
    torch.cuda.synchronize()
    assert mu.mtgc_update.launches == before + 1
    assert torch.equal(got, mu.mtgc_update_ref(*a, 0.1))


def test_flat_kernel_nan_rows(cuda):
    x, g, z = (torch.randn(2, 3, 300, device=cuda) for _ in range(3))
    y = torch.randn(2, 300, device=cuda)
    g[0, 1] = float("nan")
    z[0, 1] = float("inf")
    g[1, 2] = float("nan")
    mask = torch.ones(2, 3, device=cuda)
    mask[0, 1] = 0.0
    got = mu.mtgc_update_flat(x, g, z, y, mask, lr=0.07)
    torch.cuda.synchronize()
    assert torch.equal(got[0, 1], x[0, 1])
    assert torch.isnan(got[1, 2]).all()


def test_wrapper_rejects_bad_operands(cuda):
    x = torch.randn(2, 3, 10, device=cuda)
    y = torch.randn(2, 10, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        mu.mtgc_update_flat(x.transpose(0, 1).contiguous().transpose(0, 1), x, x, y, lr=0.1)
    with pytest.raises(ValueError, match="shape"):
        mu.mtgc_update_flat(x, x, x, y[:, :5], lr=0.1)
    with pytest.raises(TypeError, match="dtype"):
        mu.mtgc_update(x.double(), x.double(), x.double(), x.double(), lr=0.1)
    with pytest.raises(ValueError, match="expected cuda"):
        mu.mtgc_update(x, x.cpu(), x, x, lr=0.1)


def _same_bits(got, want):
    """Bit-exact, NaN for NaN: the NaN positions agree, and every other
    entry has the same bits (so -0.0 and +0.0 differ)."""
    if got.dtype != want.dtype or got.shape != want.shape:
        return False
    nan = torch.isnan(got)
    if not torch.equal(nan, torch.isnan(want)):
        return False
    ints = torch.int16 if got.dtype == torch.bfloat16 else torch.int32
    return torch.equal(got[~nan].view(ints), want[~nan].view(ints))


def _int8_operands(gen, dev, R, N, dtype):
    u = (torch.randn(R, N, generator=gen, device=dev) * 3.0).to(dtype)
    noise = torch.rand(R, N, generator=gen, device=dev)
    amax = u.abs().float().amax(dim=1)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    return u, noise, scale


@pytest.mark.parametrize("R,N", [(1, 1), (3, 7), (2, 128), (4, 1000), (1, 8195),
                                 (10, 1024 * 5 + 2)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_kernel_matches_plain(cuda, R, N, dtype):
    gen = torch.Generator(device=cuda).manual_seed(R * 10 + N)
    u, noise, scale = _int8_operands(gen, cuda, R, N, dtype)
    before = qz.int8_roundtrip.launches
    got = qz.int8_roundtrip(u, scale, noise)
    torch.cuda.synchronize()
    assert qz.int8_roundtrip.launches == before + 1
    assert _same_bits(got, qz.int8_roundtrip_ref(u, scale, noise))


def test_int8_kernel_special_rows(cuda):
    """A zero row (scale 1), +-Inf (clipped to +-127 * scale) and NaN
    (stays NaN through the clip) agree with the plain version."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    u, noise, scale = _int8_operands(gen, cuda, 4, 3001, torch.float32)
    u[0] = 0.0
    scale[0] = 1.0
    u[1, ::7] = float("inf")
    u[1, 3::7] = -float("inf")
    u[2, ::5] = float("nan")
    scale[3] = float("inf")
    got = qz.int8_roundtrip(u, scale, noise)
    want = qz.int8_roundtrip_ref(u, scale, noise)
    torch.cuda.synchronize()
    assert _same_bits(got, want)
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    assert bool(torch.isnan(got[2, ::5]).all())
    assert bool((got[1, ::7] == 127.0 * scale[1]).all())


@pytest.mark.parametrize("R,N", [(1, 1), (3, 7), (2, 128), (4, 1000), (10, 1024 * 5 + 2)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_topk_kernel_matches_plain(cuda, R, N, dtype):
    gen = torch.Generator(device=cuda).manual_seed(R * 10 + N + 1)
    # Quarter steps: many entries tie in magnitude, at the threshold too.
    u = ((torch.randn(R, N, generator=gen, device=cuda) * 4).round() / 4).to(dtype)
    k = max(1, N // 10)
    thresh = torch.topk(u.abs(), k, dim=1).values[:, -1]
    before = qz.topk_mask.launches
    got = qz.topk_mask(u, thresh)
    torch.cuda.synchronize()
    assert qz.topk_mask.launches == before + 1
    assert _same_bits(got, qz.topk_mask_ref(u, thresh))
    assert int((got != 0).sum()) >= min(k * R, int((u != 0).sum()))


def test_topk_kernel_special_rows(cuda):
    u = torch.randn(4, 777, device=cuda)
    u[0] = 0.0
    u[1, ::4] = float("nan")
    u[2, ::9] = float("inf")
    u[3, 5] = -0.0
    thresh = torch.tensor([0.0, 0.5, 1.0, 0.0], device=cuda)
    got = qz.topk_mask(u, thresh)
    want = qz.topk_mask_ref(u, thresh)
    torch.cuda.synchronize()
    assert _same_bits(got, want)
    assert not bool(torch.isnan(got).any())


def test_quantize_wrappers_reject_bad_operands(cuda):
    u = torch.randn(3, 10, device=cuda)
    with pytest.raises(ValueError, match="shape"):
        qz.int8_roundtrip(u, torch.ones(3, device=cuda), torch.rand(3, 9, device=cuda))
    with pytest.raises(TypeError, match="dtype"):
        qz.int8_roundtrip(u, torch.ones(3, device=cuda, dtype=torch.float64),
                          torch.rand(3, 10, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        qz.topk_mask(u.t().contiguous().t(), torch.ones(10, device=cuda))
    with pytest.raises(ValueError, match="expected cuda"):
        qz.topk_mask(u, torch.ones(3))


@pytest.mark.parametrize("layout", ["flat", "tree"])
def test_fused_round_on_card_matches_cpu(cuda, layout):
    """One fused mtgc round of a small CNN on the card (CUDA kernels) and on
    the CPU (their plain versions) from the same params and batches. The
    convolutions sum in another order on the two devices: rtol 1e-4."""
    init, apply = small.cnn(10, (8, 8, 1))
    p0 = init(torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(0)
    b = {"x": torch.from_numpy(rng.normal(size=(2, 2, 2, 3, 4, 8, 8, 1)).astype(np.float32)),
         "y": torch.from_numpy(rng.integers(0, 10, size=(2, 2, 2, 3, 4)).astype(np.int32))}
    spec = api.ExperimentSpec(levels=(2, 3), schedule=api.RoundSchedule(2, 2),
                              fusion="fused", state_layout=layout)
    outs = []
    mu.reset_launch_counts()
    for dev in ("cuda", "cpu"):
        eng = api.build(spec, small.make_loss(apply), device=dev)
        state, metrics = eng.round_fn(eng.init(p0), {k: v.to(dev) for k, v in b.items()})
        outs.append((convert.to_numpy(state), convert.to_numpy(metrics)))
    launches = (mu.mtgc_update_flat.launches if layout == "flat" else mu.mtgc_update.launches)
    assert launches == 2 * 2 * (1 if layout == "flat" else 8)
    # z and y are difference quotients of the params (z = dx / (H * lr),
    # y = dx / (H * E * lr)), so their atol is the params' carried through.
    atol = {"z": 1e-5 / (2 * 0.1), "y": 1e-5 / (2 * 2 * 0.1)}
    for name in ("params", "z", "y", "dyn"):
        _close(outs[0][0][name], outs[1][0][name], atol.get(name, 1e-5), name)
    _close(outs[0][1], outs[1][1], 1e-5, "metrics")


def test_make_global_round_on_card_matches_cpu(cuda):
    """The legacy constructor's round, flat + fused, from ``hfl_init`` on
    each device: one reduced CNN round through the CUDA kernel on the card
    (E * H launches) against the plain version on the CPU, at rtol 1e-4.
    At lr 0.01, path (a)'s: at 0.1 this CNN on unnormalised inputs is in
    its unstable early regime (ROADMAP queue 3 item 3), where four steps
    grew the convolutions' reordering to 2.8e-3 on 2% of the params (an
    H100 run of this test at lr 0.1)."""
    import warnings

    from repro_torch import core

    init, apply = small.cnn(10, (8, 8, 1))
    p0 = init(torch.Generator().manual_seed(1), device="cpu")
    rng = np.random.default_rng(1)
    b = {"x": torch.from_numpy(rng.normal(size=(2, 2, 2, 3, 4, 8, 8, 1)).astype(np.float32)),
         "y": torch.from_numpy(rng.integers(0, 10, size=(2, 2, 2, 3, 4)).astype(np.int32))}
    lr = 0.01
    cfg = core.HFLConfig(num_groups=2, clients_per_group=3, local_steps=2, group_rounds=2,
                         lr=lr, use_fused_update=True)
    outs = []
    mu.reset_launch_counts()
    for dev in ("cuda", "cpu"):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            rf = core.make_global_round(small.make_loss(apply), cfg, device=dev)
        state, metrics = rf(core.hfl_init(p0, cfg, device=dev),
                            {k: v.to(dev) for k, v in b.items()})
        outs.append((convert.to_numpy(state), convert.to_numpy(metrics)))
    assert mu.mtgc_update_flat.launches == 2 * 2 and mu.mtgc_update.launches == 0
    atol = {"z": 1e-5 / (2 * lr), "y": 1e-5 / (2 * 2 * lr)}
    for name in ("params", "z", "y", "dyn"):
        _close(outs[0][0][name], outs[1][0][name], atol.get(name, 1e-5), name)
    _close(outs[0][1], outs[1][1], 1e-5, "metrics")


@pytest.mark.parametrize("hw", [(8, 8), (7, 6)])
def test_resnet_gn_stride2_conv_on_card_matches_cpu(cuda, hw):
    """``resnet_gn``'s SAME convolution at stride 2 (an even size pads only
    the bottom and right) and the whole forward, card against CPU."""
    from repro_torch.models.small import _apply_conv

    gen = torch.Generator().manual_seed(2)
    x = torch.randn((2, 4) + hw, generator=gen)
    p = {"w": torch.randn(3, 3, 4, 5, generator=gen), "b": torch.randn(5, generator=gen)}
    want = _apply_conv(p, x, 2)
    got = _apply_conv({k: v.to(cuda) for k, v in p.items()}, x.to(cuda), 2).cpu()
    assert tuple(got.shape) == (2, 5, (hw[0] + 1) // 2, (hw[1] + 1) // 2)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
    init, apply = small.resnet_gn(10, hw + (3,))
    params = init(torch.Generator().manual_seed(3), device="cpu")
    xs = torch.randn((4,) + hw + (3,), generator=gen)
    want = apply(params, xs)
    got = apply(convert.params_from_numpy(convert.to_numpy(params), cuda), xs.to(cuda)).cpu()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-4 * float(want.abs().max()))


def _close(got, want, atol, tag):
    if isinstance(want, dict):
        for k in want:
            _close(got[k], want[k], atol, f"{tag}.{k}")
    else:
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=atol, err_msg=tag)


def _quad_loss(p, b):
    r = b["a"] * p["w"] - b["b"]
    return 0.5 * torch.sum(r * r) + 0.5 * torch.sum((b["c"] * p["v"] - b["e"]) ** 2)


@pytest.mark.parametrize("layout", ["flat", "tree"])
@pytest.mark.parametrize("plan", [("int8_stochastic", "int8_stochastic"), ("topk", "bf16")])
def test_compressed_partial_round_on_card_matches_cpu(cuda, layout, plan):
    """A compressed round at C = 0.5 with injected masks and noise on the
    card (int8_roundtrip / topk_mask kernels, masked flat kernel) and on the
    CPU (their plain versions). The quadratic model computes element-wise,
    so the devices agree in every operation but the group means' sums."""
    rng = np.random.default_rng(1)
    p0 = {"w": torch.zeros(200), "v": torch.zeros(30)}
    b = {k: torch.from_numpy((rng.normal(size=(2, 2, 2, 3, n)) + off).astype(np.float32))
         for k, n, off in (("a", 200, 1.0), ("b", 200, 0.0), ("c", 30, 1.0), ("e", 30, 0.0))}
    leaves = [(0, 230)] if layout == "flat" else [(0, 30), (30, 230)]  # v, w
    noise = rng.random((3, 6, 230)).astype(np.float32)
    draws = RoundDraws(
        masks=ParticipationMasks(torch.ones(2), torch.tensor([[1.0, 0.0, 1.0], [0.0, 1.0, 1.0]])),
        client_noise=[[torch.from_numpy(noise[e, :, a:z].copy()) for a, z in leaves]
                      for e in range(2)],
        group_noise=[torch.from_numpy(noise[2, :2, a:z].copy()) for a, z in leaves])
    spec = api.ExperimentSpec(levels=(2, 3), schedule=api.RoundSchedule(2, 2), fusion="fused",
                              state_layout=layout, client_participation=0.5,
                              compression=api.CompressionPlan(*plan, topk_frac=0.2))
    outs = []
    ops.reset_launch_counts()
    for dev in ("cuda", "cpu"):
        eng = api.build(spec, _quad_loss, device=dev)
        state, metrics = eng.round_fn(eng.init(p0), {k: v.to(dev) for k, v in b.items()},
                                      draws=draws)
        outs.append((convert.to_numpy(state), convert.to_numpy(metrics)))
    n_leaves = len(leaves)
    if plan[0] == "int8_stochastic":
        assert qz.int8_roundtrip.launches == (2 + 1) * n_leaves
    else:
        assert qz.topk_mask.launches == 2 * n_leaves
    assert (mu.mtgc_update_flat.launches if layout == "flat" else mu.mtgc_update.launches) == (
        2 * 2 * n_leaves)
    for name in ("params", "z", "y", "efc", "efg"):
        _close(outs[0][0][name], outs[1][0][name], 1e-6, name)
    _close(outs[0][1], outs[1][1], 1e-6, "metrics")


@pytest.mark.parametrize("backend", ["simulator", "sharded"])
@pytest.mark.parametrize("policy", ["delay_compensated", "discount"])
def test_async_flat_fused_round_on_card_matches_cpu(cuda, policy, backend):
    """Two async windows (group_rounds (2, 1, 2), flat + fused, C = 0.5 with
    injected masks) on the card and on the CPU: every fused step hands the
    masked kernel ``em x cmask``, the straggler's idle iteration keeps its
    bits, and params, z, y, snap and glob agree within float32 rounding of
    the masked means (quadratic model, element-wise)."""
    rng = np.random.default_rng(2)
    G, K, H = 3, 2, 2
    A = (1,) if backend == "sharded" else ()
    p0 = {"w": torch.zeros(200), "v": torch.zeros(30)}
    b = {k: torch.from_numpy((rng.normal(size=(2, H) + A + (G, K, n)) + off)
                             .astype(np.float32))
         for k, n, off in (("a", 200, 1.0), ("b", 200, 0.0), ("c", 30, 1.0), ("e", 30, 0.0))}
    draws = RoundDraws(masks=ParticipationMasks(
        torch.ones(G), torch.tensor([[1.0, 0.0], [1.0, 1.0], [0.0, 1.0]])))
    spec = api.ExperimentSpec(
        levels=(G, K), backend=backend, fusion="fused", state_layout="flat", lr=0.05,
        client_participation=0.5, staleness=policy,
        schedule=api.RoundSchedule((2, 1, 2), H, microbatches=1 if A else None))
    outs = []
    for dev in ("cuda", "cpu"):
        eng = api.build(spec, _quad_loss, device=dev)
        state = eng.init(p0)
        calls = []
        real = ops.mtgc_update_flat

        def spy(x, g, z, y, mask=None, **kw):
            before = x[1].clone()
            out = real(x, g, z, y, mask, **kw)
            calls.append((mask.cpu(), torch.equal(out[1], before)))
            return out

        ops.mtgc_update_flat = spy
        mu.reset_launch_counts()
        try:
            for _ in range(2):
                state, metrics = eng.round_fn(state, {k: v.to(dev) for k, v in b.items()},
                                              draws=draws)
        finally:
            ops.mtgc_update_flat = real
        if dev == "cuda":
            assert mu.mtgc_update_flat.launches == 2 * 2 * H
        for e, (mask, kept) in enumerate(calls):
            want = draws.masks.client.clone()
            if (e // H) % 2 == 1:
                want[1] = 0.0
            assert torch.equal(mask, want) and (kept or (e // H) % 2 == 0)
        outs.append((convert.to_numpy(state), convert.to_numpy(metrics)))
    for name in ("params", "z", "y", "snap", "glob"):
        if name in outs[1][0]:
            _close(outs[0][0][name], outs[1][0][name], 1e-5 if name != "z" else 1e-4, name)
    _close(outs[0][1], outs[1][1], 1e-5, "metrics")


# ---------------------------------------------------------------- LM kernels
# Tolerances: 5e-5 abs for attention and rtol/atol 1e-4 for the scan in
# float32 (as tests/test_kernels.py holds the Pallas kernels against their
# oracles: both reorder sums and exponentials). A bfloat16 attention output
# is held against the plain version computed in float32 on the same inputs:
# within half a bfloat16 ulp (its own rounding, 2^-8 relative) plus 5e-5.


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,S,H,Kv,Dh,causal,win,off", [
    (1, 128, 128, 4, 4, 64, True, 0, 0),
    (2, 300, 333, 8, 2, 128, True, 0, 0),     # the prefill's ragged cache
    (2, 128, 128, 4, 2, 64, True, 0, 0),      # GQA
    (1, 256, 256, 2, 1, 32, True, 64, 0),     # MQA + window
    (1, 128, 256, 4, 4, 64, False, 0, 0),     # bidirectional
    (2, 256, 256, 8, 2, 128, True, 100, 0),   # window not tile-aligned
    (1, 37, 37, 4, 2, 32, True, 0, 0),        # ragged T = S
    (2, 20, 53, 4, 1, 32, True, 0, 0),        # prefill into a longer cache
    (1, 24, 70, 6, 3, 64, True, 0, 30),       # q_offset > 0
    (2, 33, 81, 4, 4, 128, True, 9, 40),      # window + q_offset + ragged S
    (1, 100, 170, 5, 5, 32, False, 0, 7),     # bidirectional with an offset
])
def test_flash_kernel_matches_plain(cuda, B, T, S, H, Kv, Dh, causal, win, off, dtype):
    """float32 runs on the CUDA cores, bfloat16 on the tensor cores."""
    gen = torch.Generator(device=cuda).manual_seed(T + S + off)
    q = torch.randn(B, T, H, Dh, generator=gen, device=cuda).to(dtype)
    k = torch.randn(B, S, Kv, Dh, generator=gen, device=cuda).to(dtype)
    v = torch.randn(B, S, Kv, Dh, generator=gen, device=cuda).to(dtype)
    before = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, causal=causal, window=win, q_offset=off)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    # The plain version in float32 on the same (bf16-exact) inputs.
    want = fa.flash_attention_ref(q.float(), k.float(), v.float(), causal=causal, window=win,
                                  q_offset=off, block=64)
    assert got.dtype == dtype
    excess = (got.float() - want).abs()
    if dtype == torch.bfloat16:
        excess -= 2.0 ** -8 * want.abs()          # the output's rounding to bf16
    assert excess.max().item() < 5e-5


@pytest.mark.parametrize("B,T,S,H,Kv,Dh,causal,win,off", [
    (1, 300, 333, 40, 8, 128, True, 0, 0),     # qwen3's 40/8 heads, ragged T and S
    (2, 200, 457, 40, 8, 128, True, 0, 257),   # two q tiles, q_offset > 0
    (1, 513, 700, 10, 2, 128, True, 0, 187),   # five q tiles, q_offset > 0
    (1, 384, 384, 8, 2, 64, True, 200, 0),     # a window crossing 128-key tiles
    (1, 260, 300, 4, 2, 32, True, 150, 40),    # Dh 32, window + offset
    (2, 129, 129, 6, 3, 64, False, 0, 0),      # bidirectional, one row past a tile
])
def test_flash_wgmma_kernel_matches_plain(cuda, B, T, S, H, Kv, Dh, causal, win, off):
    """The bf16 wgmma/TMA kernel against the plain version in float32 on
    the same inputs: half a bf16 ulp + 5e-5."""
    gen = torch.Generator(device=cuda).manual_seed(T + S + off + Dh)
    q = torch.randn(B, T, H, Dh, generator=gen, device=cuda).bfloat16()
    k = torch.randn(B, S, Kv, Dh, generator=gen, device=cuda).bfloat16()
    v = torch.randn(B, S, Kv, Dh, generator=gen, device=cuda).bfloat16()
    before = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, causal=causal, window=win, q_offset=off)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    want = fa.flash_attention_ref(q.float(), k.float(), v.float(), causal=causal, window=win,
                                  q_offset=off, block=64)
    excess = (got.float() - want).abs() - 2.0 ** -8 * want.abs()
    assert excess.max().item() < 5e-5


def test_flash_wrapper_rejects_bad_operands(cuda):
    q = torch.randn(1, 8, 4, 32, device=cuda)
    k = torch.randn(1, 8, 2, 32, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k, k)
    with pytest.raises(TypeError, match="dtype"):
        fa.flash_attention(q, k.double(), k.double())
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(q[..., :16].contiguous(), k[..., :16].contiguous(),
                           k[..., :16].contiguous())
    with pytest.raises(ValueError, match="divide"):
        fa.flash_attention(q, torch.randn(1, 8, 3, 32, device=cuda),
                           torch.randn(1, 8, 3, 32, device=cuda))
    with pytest.raises(ValueError, match="expected cuda"):
        fa.flash_attention(q, k.cpu(), k)
    with pytest.raises(ValueError, match="no live key"):
        fa.flash_attention(q, k, k, window=2, q_offset=20)


@pytest.mark.parametrize("B,H,T,Dh,C", [(1, 2, 32, 16, 8), (2, 3, 64, 32, 16),
                                        (1, 1, 128, 64, 64), (2, 2, 64, 64, 32),
                                        (2, 3, 45, 64, 16), (1, 2, 7, 32, 64),
                                        (2, 3, 45, 20, 16)])   # Dh % 8 != 0: element loads
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scan_kernel_matches_plain(cuda, B, H, T, Dh, C, dtype):
    """The Pallas signature [BH, T, Dh], ragged T included (padded inside
    the kernel as the model pads)."""
    gen = torch.Generator(device=cuda).manual_seed(B + H + T + Dh + C)
    r, k, v = (torch.randn(B * H, T, Dh, generator=gen, device=cuda).to(dtype)
               for _ in range(3))
    logw = -torch.randn(B * H, T, Dh, generator=gen, device=cuda).abs()
    u = torch.randn(B * H, Dh, generator=gen, device=cuda)
    s0 = torch.randn(B * H, Dh, Dh, generator=gen, device=cuda)
    before = rs.rwkv6_scan.launches
    got_o, got_s = rs.rwkv6_scan(r, k, v, logw, u, s0, chunk=C)
    torch.cuda.synchronize()
    assert rs.rwkv6_scan.launches == before + 3        # three kernels a call
    want_o, want_s = rs.rwkv6_scan_ref(r, k, v, logw, u, s0, chunk=C)
    torch.testing.assert_close(got_o, want_o, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got_s, want_s, rtol=1e-4, atol=1e-4)


def test_scan_kernel_model_layout(cuda):
    """The model's [B, T, H, Dh] layout (bf16 r/k/v, f32 logw, u per head)
    read in place, at a ragged T."""
    B, T, H, Dh = 2, 77, 4, 64
    gen = torch.Generator(device=cuda).manual_seed(3)
    r, k, v = (torch.randn(B, T, H, Dh, generator=gen, device=cuda).bfloat16()
               for _ in range(3))
    logw = -torch.exp(-1.0 + torch.tanh(torch.randn(B, T, H, Dh, generator=gen, device=cuda)))
    u = 0.1 * torch.randn(H, Dh, generator=gen, device=cuda)
    s0 = torch.randn(B, H, Dh, Dh, generator=gen, device=cuda)
    got_o, got_s = rs.rwkv6_scan_bthd(r, k, v, logw, u, s0, chunk=64)
    want_o, want_s = rs.rwkv6_chunked_ref(r, k, v, logw, u, s0, chunk=64)
    torch.testing.assert_close(got_o, want_o, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got_s, want_s, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("T", [64, 64 * 9 + 13])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scan_kernel_many_heads(cuda, T, dtype):
    """B * H = 160 > 132 SMs' worth of (b, h) blocks; T of exactly one
    chunk and of many chunks with a ragged end; the model's decays, held
    against the plain version."""
    B, H, Dh = 4, 40, 64
    gen = torch.Generator(device=cuda).manual_seed(T)
    r, k, v = (torch.randn(B, T, H, Dh, generator=gen, device=cuda).to(dtype) for _ in range(3))
    logw = -torch.exp(-1.0 + torch.tanh(torch.randn(B, T, H, Dh, generator=gen, device=cuda)))
    u = 0.1 * torch.randn(H, Dh, generator=gen, device=cuda)
    s0 = 0.1 * torch.randn(B, H, Dh, Dh, generator=gen, device=cuda)
    got_o, got_s = rs.rwkv6_scan_bthd(r, k, v, logw, u, s0, chunk=64)
    want_o, want_s = rs.rwkv6_chunked_ref(r, k, v, logw, u, s0, chunk=64)
    torch.testing.assert_close(got_o, want_o, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got_s, want_s, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("T", [64, 64 * 9 + 13])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scan_kernel_strong_decays(cuda, T, dtype):
    """logw <= -5 (down to -20), B * H = 160: held against
    ``rwkv6_chunk_parallel_ref``, the kernel's arithmetic in PyTorch, which
    the CPU tests hold against the sequential oracle at these decays. The
    plain version's chunk-wide sums lose more than the tolerance here
    (``test_torch_lm_kernels.py::test_chunk_form_cancellation_at_strong_decays``)."""
    B, H, Dh = 4, 40, 64
    gen = torch.Generator(device=cuda).manual_seed(T + 1)
    r, k, v = (torch.randn(B, T, H, Dh, generator=gen, device=cuda).to(dtype) for _ in range(3))
    logw = -5.0 - 15.0 * torch.rand(B, T, H, Dh, generator=gen, device=cuda)
    u = 0.1 * torch.randn(H, Dh, generator=gen, device=cuda)
    s0 = torch.randn(B, H, Dh, Dh, generator=gen, device=cuda)
    got_o, got_s = rs.rwkv6_scan_bthd(r, k, v, logw, u, s0, chunk=64)
    want_o, want_s = rs.rwkv6_chunk_parallel_ref(r, k, v, logw, u, s0, chunk=64)
    assert torch.isfinite(got_o).all() and torch.isfinite(got_s).all()
    torch.testing.assert_close(got_o, want_o, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got_s, want_s, rtol=1e-4, atol=1e-4)


def _bwd_inputs(gen, B, T, H, Dh, dtype, cuda, strong=False, d_final=True):
    r, k, v, do = (torch.randn(B, T, H, Dh, generator=gen, device=cuda) for _ in range(4))
    r, k, v = (a.to(dtype) for a in (r, k, v))
    x = torch.randn(B, T, H, Dh, generator=gen, device=cuda)
    logw = (-20.0 * torch.rand(B, T, H, Dh, generator=gen, device=cuda) if strong
            else -torch.exp(-1.0 + torch.tanh(x)))
    u = torch.randn(H, Dh, generator=gen, device=cuda)
    s0 = torch.randn(B, H, Dh, Dh, generator=gen, device=cuda)
    dfin = torch.randn(B, H, Dh, Dh, generator=gen, device=cuda) if d_final else None
    return r, k, v, logw, u, s0, do, dfin


def _assert_bwd_close(got, want, dtype, ulps=1.0):
    """Each gradient within 5e-6 of its largest entry (dlogw 2e-5: its
    per-chunk suffix sums cancel; tests/test_torch_ssm_train.py), plus, for
    bf16 dr/dk/dv, ``ulps`` bf16 ulps of the largest entry (each side rounds
    its own float32 value: one ulp between two roundings, half against an
    exact value)."""
    for i, (g, w) in enumerate(zip(got, want)):
        scale = w.double().abs().max().item()
        allow = (2e-5 if i == 3 else 5e-6) * scale
        if dtype == torch.bfloat16 and i < 3:
            allow += ulps * math.ldexp(1.0, math.frexp(scale)[1] - 8)
        err = (g.double() - w.double()).abs().max().item()
        assert err <= allow, (i, err, allow, scale)


@pytest.mark.parametrize("B,T,H,Dh,C,d_final", [(2, 37, 2, 8, 16, True),
                                                (1, 2048, 32, 64, 64, False),
                                                (2, 45, 3, 20, 16, True),   # element loads
                                                (1, 130, 2, 64, 64, True),
                                                (2, 7, 1, 32, 64, False),
                                                (3, 130, 45, 64, 64, True),
                                                (2, 50, 3, 64, 64, False),
                                                (1, 64, 2, 64, 64, True),
                                                (1, 77, 4, 64, 16, True),
                                                (2, 77, 3, 64, 32, False)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scan_bwd_kernel_matches_plain(cuda, B, T, H, Dh, C, d_final, dtype):
    """``csrc/rwkv6_scan_bwd.cu`` on the forward kernel's saved chunk
    states against ``rwkv6_scan_bwd_ref``: the training shape
    [1, 2048, 32, 64], ragged T, Dh % 8 != 0, a nonzero final-state
    gradient; 405 chunk blocks (B = 3, H = 45, T = 130: two full chunks and
    a ragged one a head, past any multiple of two blocks on each of 132
    SMs); a single chunk (T < C, T = C); C = 16 and C = 32 at Dh = 64 with a
    ragged T (one and two sub-chunks a chunk). Four launches a call; a
    second call gives the same bits."""
    gen = torch.Generator(device=cuda).manual_seed(B + T + H + Dh + C)
    r, k, v, logw, u, s0, do, dfin = _bwd_inputs(gen, B, T, H, Dh, dtype, cuda, d_final=d_final)
    _, s_fin, states = rs._launch(r, k, v, logw, u, s0, C, B, H, T, Dh, 0)
    before = rs.rwkv6_scan_bwd.launches
    got = rs.rwkv6_scan_bwd(r, k, v, logw, u, s0, do, dfin, chunk=C, saved=(states, s_fin))
    again = rs.rwkv6_scan_bwd(r, k, v, logw, u, s0, do, dfin, chunk=C, saved=(states, s_fin))
    torch.cuda.synchronize()
    assert rs.rwkv6_scan_bwd.launches == before + 8
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = rs.rwkv6_scan_bwd_ref(r, k, v, logw, u, s0, do, dfin, chunk=C)
    assert [g.dtype for g in got] == [w.dtype for w in want]
    _assert_bwd_close(got, want, dtype)


def _bwd_oracle(r, k, v, logw, u, s0, do, d_final):
    """The gradients' definition token by token in float64 (see
    tests/test_torch_ssm_train.py::_oracle)."""
    r, k, v, logw, u, s0, do, G = (a.double().cpu() for a in (r, k, v, logw, u, s0, do, d_final))
    B, T, H, Dh = r.shape
    out = [torch.zeros_like(r) for _ in range(4)] + [torch.zeros_like(u), torch.zeros_like(s0)]
    for b in range(B):
        for h in range(H):
            S, before = s0[b, h].clone(), []
            for t in range(T):
                before.append(S)
                S = torch.exp(logw[b, t, h])[:, None] * S + torch.outer(k[b, t, h], v[b, t, h])
            g = G[b, h].clone()
            for t in reversed(range(T)):
                rt, kt, vt, dt_ = r[b, t, h], k[b, t, h], v[b, t, h], do[b, t, h]
                wt, vd = torch.exp(logw[b, t, h]), vt @ dt_
                out[0][b, t, h] = before[t] @ dt_ + u[h] * kt * vd
                out[1][b, t, h] = g @ vt + u[h] * rt * vd
                out[2][b, t, h] = g.T @ kt + (rt @ (u[h] * kt)) * dt_
                out[3][b, t, h] = wt * (before[t] * g).sum(1)
                out[4][h] += rt * kt * vd
                g = torch.outer(rt, dt_) + wt[:, None] * g
            out[5][b, h] = g
    return out


def test_scan_bwd_kernel_strong_decays(cuda):
    """logw down to -20 against the float64 definition: every exponent of
    the kernel is <= 0, and it holds the oracle as its plain version does."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    args = _bwd_inputs(gen, 1, 140, 2, 16, torch.float32, cuda, strong=True)
    got = rs.rwkv6_scan_bwd(*args, chunk=64)
    torch.cuda.synchronize()
    assert all(bool(torch.isfinite(g).all()) for g in got)
    _assert_bwd_close([g.cpu() for g in got], _bwd_oracle(*args), torch.float32, 0.5)


def test_scan_function_on_card_matches_cpu(cuda):
    """``RWKV6Scan`` on the card (the scan kernel, its saved states, the
    backward kernel) against the same Function on the CPU (the plain
    versions), bf16 r/k/v, the final state used."""
    gen = torch.Generator(device=cuda).manual_seed(12)
    r, k, v, logw, u, s0, do, dfin = _bwd_inputs(gen, 2, 100, 4, 64, torch.bfloat16, cuda)
    grads = {}
    for dev in (cuda, torch.device("cpu")):
        ins = [t.to(dev).clone().requires_grad_() for t in (r, k, v, logw, u, s0)]
        o, s = rs.RWKV6Scan.apply(*ins, 64)
        loss = (o * do.to(dev)).sum() + (s * dfin.to(dev)).sum()
        grads[dev.type] = [g.cpu() for g in torch.autograd.grad(loss, ins)]
    _assert_bwd_close(grads["cuda"], grads["cpu"], torch.bfloat16)


def test_reduced_rwkv6_sharded_round_on_card_matches_cpu(cuda):
    """Reduced rwkv6 (float32, remat, chunk 64) through one sharded round
    (2 x 2, A = 2, T = 1100: 17 full chunks and a ragged one) on the card
    against the CPU, at the reduced glm4-9b round's tolerances; the scan
    launches three kernels forward twice a layer (remat) and the backward
    four, on every replica and microbatch."""
    from repro_torch.configs import get_arch
    from repro_torch.models.transformer import build_model

    bundle = build_model(get_arch("rwkv6-1.6b").reduced(remat=True, rwkv_chunk=64))
    params = bundle.init(0, device="cpu")
    rs_ = np.random.default_rng(6)
    batch = {k: torch.from_numpy(rs_.integers(0, 256, (1, 1, 2, 2, 2, 1, 1100)).astype(np.int32))
             for k in ("tokens", "targets")}
    outs = {}
    for dev in (cuda, torch.device("cpu")):
        spec = api.ExperimentSpec(levels=(2, 2), backend="sharded", lr=0.05, fusion="fused",
                                  state_layout="tree", schedule=api.RoundSchedule(
                                      group_rounds=1, local_steps=1, microbatches=2))
        eng = api.build(spec, bundle.loss, device=dev)
        ops.reset_launch_counts()
        st, met = eng.round_fn(eng.init(convert.params_from_numpy(convert.to_numpy(params), dev)),
                               {k: v.to(dev) for k, v in batch.items()})
        if dev.type == "cuda":
            torch.cuda.synchronize()
            passes = 2 * 4 * 2          # layers x replicas x microbatches
            assert rs.rwkv6_scan.launches == 3 * 2 * passes
            assert rs.rwkv6_scan_bwd.launches == 4 * passes
        outs[dev.type] = (convert.to_numpy(st), met.loss.cpu().numpy())
    np.testing.assert_allclose(outs["cuda"][1], outs["cpu"][1], rtol=1e-5)
    for name, atol in (("params", 1e-5), ("z", 1e-4), ("y", 1e-4)):
        card, cpu = _leaves(outs["cuda"][0][name]), _leaves(outs["cpu"][0][name])
        for (path, g), (_, c) in zip(card, cpu):
            np.testing.assert_allclose(g, c, rtol=1e-4, atol=atol, err_msg=f"{name}{path}")


def test_scan_wrapper_rejects_bad_operands(cuda):
    r = torch.randn(2, 8, 16, device=cuda)
    u = torch.randn(2, 16, device=cuda)
    s = torch.randn(2, 16, 16, device=cuda)
    with pytest.raises(TypeError, match="dtype"):
        rs.rwkv6_scan(r, r, r, r.bfloat16(), u, s)
    with pytest.raises(ValueError, match="shape"):
        rs.rwkv6_scan(r, r[:, :4].contiguous(), r, r, u, s)
    with pytest.raises(ValueError, match="contiguous"):
        rs.rwkv6_scan(r, r, r.transpose(0, 1).contiguous().transpose(0, 1), r, u, s)
    with pytest.raises(ValueError, match="head dim"):
        big = torch.randn(1, 4, 80, device=cuda)
        rs.rwkv6_scan(big, big, big, big, torch.randn(1, 80, device=cuda),
                      torch.randn(1, 80, 80, device=cuda))
    with pytest.raises(ValueError, match="expected cuda"):
        rs.rwkv6_scan(r, r, r, r, u.cpu(), s)


# Kernel launches of one reduced prefill and 7 decode steps: a flash launch
# a layer (gemma3 at 7 layers, one of them global), rwkv6_scan three a layer,
# hymba's selective scan one a layer beside its attention, all in the
# prefill; granite's moe dispatch and combine once a layer in the prefill
# and in each decode step (2 x 8). whisper's encoder and cross-attention are
# plain products (the reference's "naive" attention): its flash launches are
# the decoder's self-attention in the prefill, as are internvl2's (the
# prompt after its patches).
SERVE_LAUNCHES = {
    "qwen3-14b": {"flash_attention": 2}, "rwkv6-1.6b": {"rwkv6_scan": 6},
    "qwen2.5-32b": {"flash_attention": 2}, "gemma3-27b": {"flash_attention": 7},
    "hymba-1.5b": {"flash_attention": 2, "selective_scan": 2},
    "granite-moe-1b-a400m": {"flash_attention": 2, "moe_gather": 16, "moe_combine": 16},
    "whisper-medium": {"flash_attention": 2}, "internvl2-26b": {"flash_attention": 2},
}


def _modality_stub(cfg, B, seed):
    """The frames (audio) or patches (vlm) a request of ``cfg`` brings, as
    float32 CPU tensors from a numpy seed; none for the other families."""
    rng = np.random.default_rng(seed)
    if cfg.arch_type == "audio":
        return {"frames": torch.from_numpy(rng.normal(
            size=(B, cfg.encoder_frames, cfg.d_model)).astype(np.float32))}
    if cfg.arch_type == "vlm":
        return {"patches": torch.from_numpy(rng.normal(
            size=(B, cfg.vision_tokens, cfg.vision_dim)).astype(np.float32))}
    return {}


@pytest.mark.parametrize("arch", list(SERVE_LAUNCHES))
def test_reduced_serve_on_card_matches_cpu(cuda, arch):
    """Reduced float32 models from the same params: prefill logits on the
    card (kernels) and on the CPU (plain versions) agree within rtol 1e-4 /
    atol 1e-4, and 8 greedy tokens are equal. 21 prompt tokens exceed the
    reduced window (16) of gemma3 and hymba; whisper's requests bring frames
    (encoded once) and internvl2's patches."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import generate
    from repro_torch.models.transformer import build_model

    over = dict(num_layers=7) if arch == "gemma3-27b" else {}
    bundle = build_model(get_arch(arch).reduced(**over))
    params = bundle.init(0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (2, 21)).astype(np.int32))
    stub = _modality_stub(bundle.cfg, 2, 1)
    ops.reset_launch_counts()
    card = generate(bundle, convert.params_from_numpy(convert.to_numpy(params), cuda),
                    toks.to(cuda), 8, **{k: v.to(cuda) for k, v in stub.items()})
    cpu = generate(bundle, params, toks, 8, **stub)
    counters = {"flash_attention": fa.flash_attention, "rwkv6_scan": rs.rwkv6_scan,
                "selective_scan": ss.selective_scan, "moe_gather": md.moe_gather,
                "moe_combine": md.moe_combine, "moe_gate_grad": md.moe_gate_grad}
    assert {k: f.launches for k, f in counters.items()} == {
        k: SERVE_LAUNCHES[arch].get(k, 0) for k in counters}
    torch.testing.assert_close(card.prefill_logits.cpu(), cpu.prefill_logits,
                               rtol=1e-4, atol=1e-4)
    assert torch.equal(card.tokens.cpu(), cpu.tokens)


@pytest.mark.parametrize("arch", ["whisper-medium", "internvl2-26b"])
def test_reduced_audio_vlm_loss_on_card_matches_cpu(cuda, arch):
    """The reduced whisper and internvl2 (float32, remat) from the same
    params, with frames or patches, at 1100 text tokens (the decoder's
    self-attention takes the flash kernels, forward twice a layer under
    remat and backward once): the loss within rtol 1e-5 and every gradient
    within rtol 1e-4 / atol 1e-5 of the CPU's; the encoder's or the
    projector's gradients nonzero."""
    from repro_torch.configs import get_arch
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.models.transformer import build_model

    bundle = build_model(get_arch(arch).reduced(remat=True, attn_block=128))
    params = bundle.init(0, device="cpu")
    rs_ = np.random.default_rng(2)
    batch = {k: torch.from_numpy(rs_.integers(0, 256, (1, 1100)).astype(np.int32))
             for k in ("tokens", "targets")}
    batch.update(_modality_stub(bundle.cfg, 1, 3))
    out = []
    for dev in (cuda, torch.device("cpu")):
        p = tree_map(lambda t: t.to(dev).requires_grad_(),
                     convert.params_from_numpy(convert.to_numpy(params), dev))
        ops.reset_launch_counts()
        loss = bundle.loss(p, {k: v.to(dev) for k, v in batch.items()})
        grads = torch.autograd.grad(loss, tree_leaves(p))
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert fa.flash_attention.launches == 2 * 2
            assert fa.flash_attention_bwd.launches == 3 * 2
        out.append((loss.item(), [g.cpu() for g in grads]))
    (card_loss, card), (cpu_loss, cpu) = out
    np.testing.assert_allclose(card_loss, cpu_loss, rtol=1e-5)
    stub_keys = ("encoder", "enc_pos") if arch == "whisper-medium" else ("projector",)
    paths = [path for path, _ in _leaves(convert.to_numpy(params))]
    for path, g, c in zip(paths, card, cpu):
        torch.testing.assert_close(g, c, rtol=1e-4, atol=1e-5, msg=path)
        if path.split("/")[1] in stub_keys:
            assert c.abs().max().item() > 0, path


@pytest.mark.parametrize("arch", ["whisper-medium", "internvl2-26b"])
def test_reduced_audio_vlm_decode_on_card_matches_cpu(cuda, arch):
    """Prefill and 4 decode steps of the reduced model on the card against
    the CPU: logits within rtol/atol 1e-4 after each call, whisper's
    decode steps cross-attending to the encoder's output passed as
    ``memory``, internvl2's decoding after its patches' positions."""
    from repro_torch.configs import get_arch
    from repro_torch.models.transformer import build_model

    bundle = build_model(get_arch(arch).reduced())
    cfg = bundle.cfg
    params = bundle.init(4, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(4).integers(0, 256, (2, 13)).astype(np.int32))
    stub = _modality_stub(cfg, 2, 5)
    P = cfg.vision_tokens if "patches" in stub else 0
    logits = []
    for dev in (cuda, torch.device("cpu")):
        p = convert.params_from_numpy(convert.to_numpy(params), dev)
        extra, pre = {}, {"tokens": toks.to(dev)}
        if "frames" in stub:
            extra["memory"] = bundle.memory(p, {"frames": stub["frames"].to(dev)})
        if "patches" in stub:
            pre["patches"] = stub["patches"].to(dev)
        with torch.no_grad():
            cache = bundle.init_cache(2, P + 17, device=dev)
            lg, cache = bundle.prefill(p, {**pre, **extra}, cache)
            seq = [lg.cpu()]
            for i in range(4):
                lg, cache = bundle.decode_step(p, {"token": toks[:, i:i + 1].to(dev),
                                                   "index": P + 13 + i, **extra}, cache)
                seq.append(lg.cpu())
        logits.append(seq)
    for i, (g, c) in enumerate(zip(*logits)):
        torch.testing.assert_close(g, c, rtol=1e-4, atol=1e-4, msg=f"call {i}")


# ------------------------------------------------ attention backward (training)
# The backward kernel runs float32 on the CUDA cores and bfloat16 on the
# tensor cores, where P and dS go in as bf16 high and low parts (about 16
# bits). Against the plain version in float32 on the same inputs both agree
# to float32 rounding (1e-5 of the gradient's largest entry), plus half a
# bf16 ulp (2^-8 relative, the outputs' own rounding) in bfloat16.
# The forward's row statistics agree to 1e-5 (the bf16 kernel's m is in
# base-2 units and converted; its exponentials are ex2.approx).

BWD_CASES = [
    (1, 256, 256, 32, 2, 128, True, 0, 0),     # glm4-9b's 16:1 GQA
    (2, 300, 333, 10, 2, 64, True, 0, 0),      # 5:1 GQA, ragged T and S
    (1, 130, 130, 4, 4, 32, True, 0, 0),       # ragged T = S, Dh 32
    (1, 256, 256, 8, 2, 64, True, 100, 0),     # a window not tile-aligned
    (2, 33, 81, 4, 4, 128, True, 9, 40),       # window + q_offset + ragged S
    (1, 100, 170, 5, 5, 32, False, 0, 7),      # bidirectional with an offset
]


def _attn_inputs(cuda, B, T, S, H, Kv, Dh, dtype, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    q = torch.randn(B, T, H, Dh, generator=gen, device=cuda).to(dtype)
    k = torch.randn(B, S, Kv, Dh, generator=gen, device=cuda).to(dtype)
    v = torch.randn(B, S, Kv, Dh, generator=gen, device=cuda).to(dtype)
    do = torch.randn(B, T, H, Dh, generator=gen, device=cuda).to(dtype)
    return q, k, v, do


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,S,H,Kv,Dh,causal,win,off", BWD_CASES)
def test_flash_statistics_match_plain(cuda, B, T, S, H, Kv, Dh, causal, win, off, dtype):
    q, k, v, _ = _attn_inputs(cuda, B, T, S, H, Kv, Dh, dtype, T + S + Dh)
    kw = dict(causal=causal, window=win, q_offset=off)
    o, m, l = fa.flash_attention(q, k, v, return_stats=True, **kw)
    o2 = fa.flash_attention(q, k, v, **kw)
    _, wm, wl = fa.flash_attention_ref(q.float(), k.float(), v.float(), block=64,
                                       return_stats=True, **kw)
    torch.cuda.synchronize()
    assert torch.equal(o, o2)                      # the statistics change nothing else
    assert m.shape == l.shape == (B, H, T) and m.dtype == l.dtype == torch.float32
    assert (m - wm).abs().max().item() <= 1e-5
    assert ((l - wl).abs() / wl).max().item() <= 1e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,S,H,Kv,Dh,causal,win,off", BWD_CASES)
def test_flash_bwd_kernel_matches_plain(cuda, B, T, S, H, Kv, Dh, causal, win, off, dtype):
    q, k, v, do = _attn_inputs(cuda, B, T, S, H, Kv, Dh, dtype, T + S + off)
    kw = dict(causal=causal, window=win, q_offset=off)
    o, m, l = fa.flash_attention(q, k, v, return_stats=True, **kw)
    before = fa.flash_attention_bwd.launches
    got = fa.flash_attention_bwd(q, k, v, o, do, m, l, **kw)
    torch.cuda.synchronize()
    assert fa.flash_attention_bwd.launches == before + 3     # three kernels a call
    want = fa.flash_attention_bwd_ref(q.float(), k.float(), v.float(), o.float(), do.float(),
                                      m, l, block=64, **kw)
    for g, w, ref in zip(got, want, (q, k, v)):
        assert g.dtype == dtype and g.shape == ref.shape
        excess = (g.float() - w).abs()
        if dtype == torch.bfloat16:
            excess -= 2.0 ** -8 * w.abs()
        assert excess.max().item() <= 1e-5 * w.abs().max().item()


@pytest.mark.parametrize("B,T,S,H,Kv,Dh,causal,win,off", BWD_CASES)
def test_flash_bwd_bf16_is_deterministic(cuda, B, T, S, H, Kv, Dh, causal, win, off):
    """No atomics: two bf16 backward calls on the same inputs give the same
    bits in dq, dk and dv."""
    q, k, v, do = _attn_inputs(cuda, B, T, S, H, Kv, Dh, torch.bfloat16, T + S + Dh + 1)
    kw = dict(causal=causal, window=win, q_offset=off)
    o, m, l = fa.flash_attention(q, k, v, return_stats=True, **kw)
    first = fa.flash_attention_bwd(q, k, v, o, do, m, l, **kw)
    second = fa.flash_attention_bwd(q, k, v, o, do, m, l, **kw)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_flash_function_on_card_matches_cpu(cuda):
    """The autograd Function: forward and backward kernels on the card
    against the plain versions on the CPU, float32."""
    gen = torch.Generator().manual_seed(3)
    cpu = [torch.randn(s, generator=gen) for s in ((2, 150, 6, 64), (2, 150, 2, 64),
                                                   (2, 150, 2, 64), (2, 150, 6, 64))]
    outs = {}
    for dev in (cuda, torch.device("cpu")):
        q, k, v = (a.to(dev).requires_grad_() for a in cpu[:3])
        o = fa.FlashAttention.apply(q, k, v, True, 40, 0, 64)
        o.backward(cpu[3].to(dev))
        outs[dev.type] = [t.detach().cpu() for t in (o, q.grad, k.grad, v.grad)]
    for a, b in zip(outs["cuda"], outs["cpu"]):
        assert (a - b).abs().max().item() < 5e-5


def test_flash_bwd_wrapper_rejects_bad_operands(cuda):
    q, k, v, do = _attn_inputs(cuda, 1, 8, 8, 4, 2, 32, torch.float32, 0)
    o, m, l = fa.flash_attention(q, k, v, return_stats=True)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention_bwd(q, k, v, o, do.transpose(1, 2).contiguous().transpose(1, 2), m, l)
    with pytest.raises(TypeError, match="dtype"):
        fa.flash_attention_bwd(q, k, v, o, do, m.double(), l)
    with pytest.raises(ValueError, match="shape"):
        fa.flash_attention_bwd(q, k, v, o, do, m[:, :, :4].contiguous(), l)
    with pytest.raises(ValueError, match="no live key"):
        fa.flash_attention_bwd(q, k, v, o, do, m, l, window=2, q_offset=20)


@pytest.mark.parametrize("layout,cdt", [("tree", None), ("flat", None), ("tree", "bfloat16")])
def test_fused_sharded_step_bitexact_against_unfused(cuda, layout, cdt):
    """The sharded round's fused step (``mtgc_update_flat`` with g_scale =
    1/A, one launch per leaf or buffer) against the unfused tree step on the
    card, from the same params and batches: params, z and y bit for bit (an
    element-wise loss, so both compute the same gradients). The unfused
    step's order of operations is the kernel's, (g/A + z) + y in float32
    (bf16 corrections widened); the unfused flat step folds z + y first, as
    the reference does, and is held at rtol 1e-5 on the CPU instead."""
    from repro_torch.core.packer import as_tree
    from repro_torch.kernels import mtgc_update as mu

    def loss(p, b):
        return 0.5 * torch.sum((b["a"] * p["w"] - b["b"]) ** 2) + torch.sum(b["a"] * p["v"])

    gen = torch.Generator().manual_seed(9)
    b = {k: torch.randn((2, 2, 2, 2, 3, 50), generator=gen).to(cuda) for k in ("a", "b")}
    states = {}
    for fusion, lay in (("fused", layout), ("none", "tree")):
        spec = api.ExperimentSpec(levels=(2, 3), backend="sharded", lr=0.05, fusion=fusion,
                                  state_layout=lay, correction_dtype=cdt,
                                  schedule=api.RoundSchedule(group_rounds=2, local_steps=2,
                                                             microbatches=2))
        eng = api.build(spec, loss, device=cuda)
        st = eng.init({"w": torch.linspace(-1, 1, 50), "v": torch.ones(50)})
        before = mu.mtgc_update_flat.launches
        for _ in range(2):
            st, _ = eng.round_fn(st, b)
        n_launch = 2 if lay == "tree" else 1        # leaves w, v; or one float32 buffer
        assert mu.mtgc_update_flat.launches - before == (
            2 * 2 * 2 * n_launch if fusion == "fused" else 0)
        states[fusion] = {name: convert.to_numpy(as_tree(getattr(st, name)))
                          for name in ("params", "z", "y")}
    for name in ("params", "z", "y"):
        for leaf in states["none"][name]:
            np.testing.assert_array_equal(states["fused"][name][leaf],
                                          states["none"][name][leaf], err_msg=f"{name}/{leaf}")


@pytest.mark.parametrize("dim", [0, 1])
def test_piecewise_mean_on_card(cuda, monkeypatch, dim):
    """The sharded round's piecewise group/global mean on the card equals
    ``torch.mean`` bit for bit (bf16, many pieces, a strided input for the
    global mean)."""
    from repro_torch.launch import train

    monkeypatch.setattr(train, "_CHUNK", 256)
    gen = torch.Generator(device=cuda).manual_seed(dim)
    x = torch.randn((2, 3, 33, 65), generator=gen, device=cuda).to(torch.bfloat16)
    src = x if dim == 1 else x[:, 0]
    assert torch.equal(train._mean(src, dim), torch.mean(src, dim=dim))


def test_reduced_lm_sharded_round_on_card_matches_cpu(cuda):
    """Reduced glm4-9b (float32, remat) through one sharded round (2 x 2,
    A = 2, T = 1100: the flash kernels forward and backward) on the card
    against the CPU: losses within rtol 1e-5, params within rtol 1e-4 /
    atol 1e-5 and z/y within rtol 1e-4 / atol 1e-4 (their quotient; ROADMAP
    queue 3 item 2). The flash kernels launch on every layer of every
    replica and microbatch (twice forward under remat)."""
    _reduced_round_on_card_matches_cpu(cuda, "glm4-9b", {
        fa.flash_attention: 2 * 2 * 4 * 2, fa.flash_attention_bwd: 3 * 2 * 4 * 2})


def test_reduced_hybrid_sharded_round_on_card_matches_cpu(cuda):
    """The same round of the reduced hymba-1.5b (windowed attention at 16
    and the selective SSM, 1100 tokens a microbatch): on each of the 16
    layer passes the flash forward and the selective scan launch twice
    (remat), the attention backward's three kernels and the scan backward's
    four once."""
    _reduced_round_on_card_matches_cpu(cuda, "hymba-1.5b", {
        fa.flash_attention: 2 * 16, fa.flash_attention_bwd: 3 * 16,
        ss.selective_scan: 2 * 16, ss.selective_scan_bwd: ss.BWD_LAUNCHES * 16})


def test_reduced_moe_sharded_round_on_card_matches_cpu(cuda):
    """The same round of the reduced granite-moe-1b-a400m (4 experts, top 2,
    1100 tokens a microbatch routed with capacity 687): the moe dispatch and
    combine launch twice forward and once backward on each of the 16 layer
    passes, the gate gradient once."""
    _reduced_round_on_card_matches_cpu(cuda, "granite-moe-1b-a400m", {
        fa.flash_attention: 2 * 16, fa.flash_attention_bwd: 3 * 16, md.moe_gather: 3 * 16,
        md.moe_combine: 3 * 16, md.moe_gate_grad: 16})


def _reduced_round_on_card_matches_cpu(cuda, arch, launches):
    from repro_torch.configs import get_arch
    from repro_torch.models.transformer import build_model

    bundle = build_model(get_arch(arch).reduced(remat=True, attn_block=128))
    params = bundle.init(0, device="cpu")
    rs_ = np.random.default_rng(4)
    batch = {k: torch.from_numpy(rs_.integers(0, 256, (1, 1, 2, 2, 2, 1, 1100)).astype(np.int32))
             for k in ("tokens", "targets")}
    outs = {}
    for dev in (cuda, torch.device("cpu")):
        spec = api.ExperimentSpec(levels=(2, 2), backend="sharded", lr=0.05, fusion="fused",
                                  state_layout="tree", schedule=api.RoundSchedule(
                                      group_rounds=1, local_steps=1, microbatches=2))
        eng = api.build(spec, bundle.loss, device=dev)
        ops.reset_launch_counts()
        st, met = eng.round_fn(eng.init(convert.params_from_numpy(convert.to_numpy(params), dev)),
                               {k: v.to(dev) for k, v in batch.items()})
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert {f.__name__: f.launches for f in launches} == {
                f.__name__: n for f, n in launches.items()}
        outs[dev.type] = (convert.to_numpy(st), met.loss.cpu().numpy())
    np.testing.assert_allclose(outs["cuda"][1], outs["cpu"][1], rtol=1e-5)
    for name, atol in (("params", 1e-5), ("z", 1e-4), ("y", 1e-4)):
        card, cpu = _leaves(outs["cuda"][0][name]), _leaves(outs["cpu"][0][name])
        assert [p for p, _ in card] == [p for p, _ in cpu]
        for (path, g), (_, c) in zip(card, cpu):
            np.testing.assert_allclose(g, c, rtol=1e-4, atol=atol, err_msg=f"{name}{path}")


def _leaves(tree, prefix=""):
    """(path, array) of a nested dict of arrays, keys in sorted order."""
    if isinstance(tree, dict):
        return [pa for k in sorted(tree) for pa in _leaves(tree[k], f"{prefix}/{k}")]
    return [(prefix, tree)]


def _quad_problem(rs_, G, K, E, H, n=(200, 30)):
    """Two-leaf element-wise quadratic loss and [E, H, 1, G, K, n] batches:
    both devices compute it in one order, so a one-ulp difference cannot
    move an int8 step or a top-k entry."""
    def loss(p, bt):
        r = bt["a"] * p["w"] - bt["b"]
        return 0.5 * torch.sum(r * r) + 0.5 * torch.sum((bt["c"] * p["v"] - bt["e"]) ** 2)

    b = {k: torch.from_numpy((rs_.normal(size=(E, H, 1, G, K, m)) + off).astype(np.float32))
         for k, m, off in (("a", n[0], 1.0), ("b", n[0], 0.0), ("c", n[1], 1.0),
                           ("e", n[1], 0.0))}
    return loss, {"w": torch.zeros(n[0]), "v": torch.zeros(n[1])}, b


SHARDED_PLANS = {"int8-none": ("int8_stochastic", "none"), "none-topk": ("none", "topk"),
                 "int8-int8": ("int8_stochastic", "int8_stochastic")}


@pytest.mark.parametrize("participation", [1.0, 0.5])
@pytest.mark.parametrize("plan", sorted(SHARDED_PLANS))
@pytest.mark.parametrize("layout", ["flat", "tree"])
def test_compressed_sharded_round_on_card_matches_cpu(cuda, layout, plan, participation):
    """A compressed sharded round (fused: the quantize kernels on the card,
    their plain versions on the CPU), masks and noise injected: params, z,
    y and both residuals within rtol 1e-5 / atol 1e-6 of the CPU's, and the
    kernels launched once per block (pieces of the whole row here)."""
    G, K, E, H = 2, 3, 2, 2
    rs_ = np.random.default_rng(5)
    loss, p0, b = _quad_problem(rs_, G, K, E, H)
    rows = {"flat": [230], "tree": [30, 200]}[layout]          # leaves v, w
    masks = (ParticipationMasks(torch.ones(G), torch.tensor([[1.0, 0.0, 1.0], [0.0, 1.0, 1.0]]))
             if participation < 1 else None)
    draws = RoundDraws(
        masks=masks,
        client_noise=[[torch.from_numpy(rs_.random((G * K, m)).astype(np.float32)) for m in rows]
                      for _ in range(E)],
        group_noise=[torch.from_numpy(rs_.random((G, m)).astype(np.float32)) for m in rows])
    cm, gm = SHARDED_PLANS[plan]
    outs = {}
    for dev in (cuda, torch.device("cpu")):
        spec = api.ExperimentSpec(levels=(G, K), backend="sharded", state_layout=layout,
                                  fusion="fused", client_participation=participation,
                                  schedule=api.RoundSchedule(E, H),
                                  compression=api.CompressionPlan(cm, gm, topk_frac=0.2))
        eng = api.build(spec, loss, device=dev)
        ops.reset_launch_counts()
        st, _ = eng.round_fn(eng.init(p0), {k: v.to(dev) for k, v in b.items()}, draws=draws)
        if dev.type == "cuda":
            torch.cuda.synchronize()
            n = len(rows)
            want = {"int8_roundtrip": E * G * n * (cm == "int8_stochastic")
                    + n * (gm == "int8_stochastic"), "topk_mask": n * (gm == "topk")}
            assert {k: getattr(qz, k).launches for k in want} == want
        outs[dev.type] = convert.to_numpy(st)
    for name in ("params", "z", "y", "efc", "efg"):
        assert (name in outs["cuda"]) == (name in outs["cpu"]), name
        for key, cpu in outs["cpu"].get(name, {}).items():
            np.testing.assert_allclose(outs["cuda"][name][key], cpu, rtol=1e-5, atol=1e-6,
                                       err_msg=f"{name}/{key}")


@pytest.mark.parametrize("layout", ["flat", "tree"])
def test_piecewise_sharded_round_on_card(cuda, monkeypatch, layout):
    """On the card, the sharded round with every row cut into pieces of 16
    elements gives the bits of the round with one piece a row (a mask with
    a frozen replica and an empty group, int8 on the client link, top-k on
    the group link, noise injected)."""
    from repro_torch.launch import train

    G, K, E, H = 2, 3, 2, 2
    rs_ = np.random.default_rng(6)
    loss, p0, b = _quad_problem(rs_, G, K, E, H)
    rows = {"flat": [230], "tree": [30, 200]}[layout]
    draws = RoundDraws(
        masks=ParticipationMasks(torch.ones(G), torch.tensor([[1.0, 0.0, 1.0], [0.0, 0.0, 0.0]])),
        client_noise=[[torch.from_numpy(rs_.random((G * K, m)).astype(np.float32)) for m in rows]
                      for _ in range(E)])
    spec = api.ExperimentSpec(levels=(G, K), backend="sharded", state_layout=layout,
                              fusion="fused", client_participation=0.5,
                              schedule=api.RoundSchedule(E, H),
                              compression=api.CompressionPlan("int8_stochastic", "topk",
                                                              topk_frac=0.2))
    outs = []
    for chunk in (1 << 26, 16):
        monkeypatch.setattr(train, "_CHUNK", chunk)
        eng = api.build(spec, loss, device=cuda)
        st, _ = eng.round_fn(eng.init(p0), {k: v.to(cuda) for k, v in b.items()}, draws=draws)
        outs.append(convert.to_numpy(st))
    for name in ("params", "z", "y", "efc", "efg"):
        for key, want in outs[0][name].items():
            np.testing.assert_array_equal(outs[1][name][key], want, err_msg=f"{name}/{key}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_piecewise_threshold_on_card(cuda, monkeypatch, dtype):
    """The piecewise top-k threshold on the card equals ``torch.topk``'s on
    the whole row, bit for bit: ties, +-Inf, NaN and zero rows, k from 1
    past a piece to the whole row."""
    from repro_torch.core import compression as cmp

    monkeypatch.setattr(cmp, "_CHUNK", 64)
    gen = torch.Generator(device=cuda).manual_seed(7)
    u = torch.randn((5, 1000), generator=gen, device=cuda)
    u[0] = torch.round(u[0] * 2) / 2
    u[1, ::9] = float("inf")
    u[1, 1::9] = -float("inf")
    u[2, ::3] = float("nan")
    u[3] = 0.0
    u = u.to(dtype)
    for frac in (0.001, 0.01, 0.1, 0.5, 1.0):
        k = max(1, min(1000, int(np.ceil(frac * 1000))))
        want = torch.topk(u.abs(), k, dim=1).values[:, -1]
        got = cmp.row_params("topk", (u[:, sl] for sl in cmp.row_pieces(1000)), 1000, frac)
        assert torch.equal(torch.isnan(got), torch.isnan(want)), frac
        ok = ~torch.isnan(want)
        assert torch.equal(got[ok], want[ok]), frac


# ---------------------------------------------------- faults and defense


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_masked_flat_kernel_under_crash_masks_and_nan(cuda, dtype):
    """The masked fused update as fault injection drives it: a crash mask
    freezing replicas whose g and z hold NaN and Inf (their bits kept), and
    active replicas with non-finite operands (undefended corruption) --
    against the plain version with NaN positions compared, not NaN payload
    bits, and every other element bit for bit."""
    from repro_torch.core.faults import FaultPlan, fault_masks

    G, K, N = 10, 10, 4099
    gen = torch.Generator(device=cuda).manual_seed(41)
    x, g, z = (torch.randn(G, K, N, generator=gen, device=cuda).to(dtype) for _ in range(3))
    y = torch.randn(G, N, generator=gen, device=cuda).to(dtype)
    fm = fault_masks(gen, FaultPlan(crash_rate=0.3), G, K)
    assert 0 < fm.crash.sum() < G * K
    cmask = 1.0 - fm.crash
    crashed = fm.crash != 0
    g[crashed] = float("nan")
    z[crashed] = float("inf")
    live = (~crashed).nonzero()[:3]
    g[live[0, 0], live[0, 1], ::7] = float("nan")
    z[live[1, 0], live[1, 1], 5] = -float("inf")
    x[live[2, 0], live[2, 1], :17] = float("nan")
    y[live[0, 0], 100:110] = float("inf")
    got = mu.mtgc_update_flat(x, g, z, y, cmask, lr=0.05, g_scale=0.5)
    torch.cuda.synchronize()
    want = mu.mtgc_update_flat_ref(x, g, z, y, cmask, 0.05, 0.5)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    ints = torch.int32 if dtype == torch.float32 else torch.int16
    ok = ~torch.isnan(want)
    assert torch.equal(got.view(ints)[ok], want.view(ints)[ok])
    assert torch.equal(got[crashed].view(ints), x[crashed].view(ints))
    assert torch.isnan(got[live[0, 0], live[0, 1], ::7]).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_screen_and_clip_on_card_matches_cpu(cuda, dtype):
    """``screen_and_clip`` and ``corrupt_uploads`` on the card against the
    CPU: the same survivors, the clip within float32 rounding (the norm's
    summation order differs), clean uploads and NaN positions exact."""
    from repro_torch.core import faults as flt

    rs_ = np.random.default_rng(42)
    xs = {"a": rs_.normal(size=(3, 4, 300)).astype(np.float32),
          "b": rs_.normal(size=(3, 4, 20, 7)).astype(np.float32)}
    xe = {k: v + rs_.normal(size=v.shape).astype(np.float32) for k, v in xs.items()}
    bad = torch.tensor([[1.0, 0, 0, 0], [0, 1, 0, 1], [0, 0, 0, 0]])
    outs = {}
    for dev in (cuda, torch.device("cpu")):
        s = {k: torch.from_numpy(v).to(dev, dtype) for k, v in xs.items()}
        e = {k: torch.from_numpy(v).to(dev, dtype) for k, v in xe.items()}
        res = []
        for kind, dp in (("nan", dict()), ("explode", dict(screen_norm=100.0, clip_norm=20.0)),
                         ("inf", dict(screen_nonfinite=False, clip_norm=5.0))):
            up = flt.corrupt_uploads(s, e, bad.to(dev),
                                     flt.FaultPlan(corrupt_rate=0.5, corrupt_kind=kind,
                                                   explode_factor=30.0))
            x_up, ok = flt.screen_and_clip(s, up, flt.DefensePlan(**dp))
            res.append(({k: v.float().cpu() for k, v in up.items()},
                        {k: v.float().cpu() for k, v in x_up.items()}, ok.cpu()))
        outs[dev.type] = res
    for (up_g, xu_g, ok_g), (up_c, xu_c, ok_c) in zip(outs["cuda"], outs["cpu"]):
        assert torch.equal(ok_g, ok_c)
        for k in up_c:
            assert torch.equal(torch.isnan(up_g[k]), torch.isnan(up_c[k]))
            assert torch.equal(torch.nan_to_num(up_g[k]), torch.nan_to_num(up_c[k]))
            assert torch.equal(torch.isnan(xu_g[k]), torch.isnan(xu_c[k]))
            rtol = 1e-5 if dtype == torch.float32 else 2.0 ** -7
            torch.testing.assert_close(torch.nan_to_num(xu_g[k]), torch.nan_to_num(xu_c[k]),
                                       rtol=rtol, atol=1e-5, equal_nan=True)


@pytest.mark.parametrize("backend,layout", [("simulator", "flat"), ("simulator", "tree"),
                                            ("sharded", "flat"), ("sharded", "tree")])
def test_faulty_round_on_card_matches_cpu(cuda, backend, layout):
    """A fused round under crashes, timeouts and exploded uploads with the
    screen and the clip, masks injected, on the card against the CPU: every
    state field within rtol 1e-5 / atol 1e-6 (z, y: the atol carried), the
    same screened count."""
    from repro_torch.core.faults import DefensePlan, FaultMasks, FaultPlan

    G, K, E, H = 2, 3, 2, 2
    rs_ = np.random.default_rng(43)
    loss, p0, b = _quad_problem(rs_, G, K, E, H)
    if backend == "simulator":
        b = {k: v[:, :, 0] for k, v in b.items()}
    fm = FaultMasks(torch.tensor([[0.0, 1.0, 0.0], [0.0, 0.0, 0.0]]), torch.tensor([0.0, 1.0]),
                    torch.tensor([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]]))
    outs = {}
    for dev in (cuda, torch.device("cpu")):
        spec = api.ExperimentSpec(levels=(G, K), backend=backend, state_layout=layout,
                                  fusion="fused", lr=0.05, schedule=api.RoundSchedule(E, H),
                                  faults=FaultPlan(crash_rate=0.1, timeout_rate=0.1,
                                                   corrupt_rate=0.1, corrupt_kind="explode",
                                                   explode_factor=50.0),
                                  defense=DefensePlan(screen_norm=40.0, clip_norm=4.0))
        eng = api.build(spec, loss, device=dev)
        st, m = eng.round_fn(eng.init(p0), {k: v.to(dev) for k, v in b.items()},
                             draws=RoundDraws(faults=fm))
        outs[dev.type] = (convert.to_numpy(st), float(m.screened))
    assert outs["cuda"][1] == outs["cpu"][1] > 0
    for name, atol in (("params", 1e-6), ("z", 1e-5), ("y", 5e-6)):
        for key, cpu in outs["cpu"][0][name].items():
            np.testing.assert_allclose(outs["cuda"][0][name][key], cpu, rtol=1e-5, atol=atol,
                                       err_msg=f"{name}/{key}")


def _quad_data(G, K, E, H, dev, n=(200, 30), seed=44):
    """Packed [G, K, S, H, n] quadratic-loss shards on ``dev`` and the loss."""
    from repro_torch.core.driver import PackedBatches

    rs_ = np.random.default_rng(seed)
    loss, p0, _ = _quad_problem(rs_, G, K, E, H, n)
    arrays = {k: torch.from_numpy((rs_.normal(size=(G, K, 4, H, m)) + off).astype(np.float32))
              .to(dev) for k, m, off in (("a", n[0], 1.0), ("b", n[0], 0.0),
                                          ("c", n[1], 1.0), ("e", n[1], 0.0))}
    return loss, p0, PackedBatches(arrays, torch.Generator().manual_seed(1), E, H)


@pytest.mark.parametrize("layout", ["flat", "tree"])
def test_population_install_extract_through_page_locked_memory(cuda, layout):
    """A cohort gathered into page-locked buffers, installed into the card's
    state in place (no new tensor) and extracted back gives the staged bits;
    a bfloat16 tree leaf crosses as its 16-bit pattern."""
    from repro_torch.core.population import CohortBuffers, PopulationStore

    G, K, P = 2, 3, 7
    p0 = {"w": torch.zeros(200), "v": torch.zeros(30, dtype=torch.bfloat16)}
    spec = api.ExperimentSpec(levels=(G, K), state_layout=layout, population=P)
    state = api.build(spec, lambda p, b: None, device=cuda).init(p0)
    store = PopulationStore.from_state(state, P)
    rng = np.random.default_rng(5)
    for key, buf in store.data["z"].items():
        buf[...] = (rng.normal(size=buf.shape).astype(np.float32).view(np.uint32) >> 16
                    ).astype(np.uint16) if key == "bfloat16" else rng.normal(size=buf.shape)
    def ptrs(z):
        return [t.data_ptr() for t in (z.bufs if layout == "flat" else z).values()]

    before = ptrs(state.z)
    bufs = CohortBuffers(store, K, pin=True)
    assert all(t.is_pinned() for t in bufs.tensors["z"].values())
    idx = np.array([[6, 1, 3], [0, 5, 2]])
    staged = {f: {k: a.copy() for k, a in v.items()}
              for f, v in store.gather(idx, out=bufs).items()}
    state = store.install(state, bufs)
    assert ptrs(state.z) == before
    out = CohortBuffers(store, K, pin=True)
    host = store.extract(state, out=out)
    for key, arr in host["z"].items():
        np.testing.assert_array_equal(arr, staged["z"][key], err_msg=key)


def test_population_overlap_matches_sequential_on_card(cuda):
    """The overlapped gather/scatter loop (page-locked buffers, queued
    copies) against the sequential one on the card: state and store bit for
    bit, at P = 5 over K = 4 with chunk 1 (consecutive cohorts share
    clients)."""
    from repro_torch.core.population import run_population_rounds

    G, K, E, H, P = 2, 4, 2, 2, 5
    runs = []
    for overlap in (True, False):
        loss, p0, data = _quad_data(G, K, E, H, cuda)
        spec = api.ExperimentSpec(levels=(G, K), fusion="fused", lr=0.05, population=P,
                                  schedule=api.RoundSchedule(E, H))
        eng = api.build(spec, loss, device=cuda)
        state = eng.init(p0)
        store = eng.init_population(state, torch.Generator().manual_seed(5))
        state, _, hz = run_population_rounds(eng.round_fn, state, store, data, 6, chunk=1,
                                             overlap=overlap)
        runs.append((convert.to_numpy(state), store))
    for f in ("params", "z", "y"):
        for k in runs[0][0][f]:
            np.testing.assert_array_equal(runs[0][0][f][k], runs[1][0][f][k], err_msg=f)
    for k, buf in runs[0][1].data["z"].items():
        np.testing.assert_array_equal(buf, runs[1][1].data["z"][k])


def test_checkpoint_of_a_card_state_restores_onto_the_card(cuda, tmp_path):
    """A card state (partial participation: a CUDA generator) saved and
    restored into a card ``like``: every tensor back on the card bit for
    bit, the generator's state equal, and one more round from each equal."""
    from repro_torch.checkpoint import restore, save
    from repro_torch.core.driver import select_round

    G, K, E, H = 2, 3, 2, 2
    loss, p0, data = _quad_data(G, K, E, H, cuda)
    spec = api.ExperimentSpec(levels=(G, K), fusion="fused", lr=0.05, client_participation=0.5,
                              schedule=api.RoundSchedule(E, H))
    eng = api.build(spec, loss, device=cuda)
    state, _ = api.fit(eng, data, 2, params=p0, rng=torch.Generator(device=cuda).manual_seed(3))
    save(str(tmp_path), 2, state)
    got = restore(str(tmp_path), 2, eng.init(p0))
    assert got.rng.device.type == cuda.type
    assert torch.equal(got.rng.get_state(), state.rng.get_state())
    for f in ("params", "z", "y", "dyn"):
        for k, t in getattr(got, f).bufs.items():
            assert t.device.type == cuda.type and torch.equal(t, getattr(state, f).bufs[k]), f
    sid = torch.zeros((E, G, K), dtype=torch.int64)
    a = eng.round_fn(state, select_round(data, sid))[0]
    b = eng.round_fn(got, select_round(data, sid))[0]
    for f in ("params", "z", "y"):
        assert torch.equal(getattr(a, f).bufs["float32"], getattr(b, f).bufs["float32"]), f


@pytest.mark.parametrize("layout", ["tree", "flat"])
@pytest.mark.parametrize("participation", [None, (1.0, 0.5, 0.5)], ids=["full", "partial"])
def test_multilevel_round_on_card_matches_cpu(cuda, layout, participation):
    """One round of the multilevel backend (a small CNN on a 2 x 2 x 3
    tree, periods (4, 2, 1)) on the card against the same round on the
    CPU, masks injected: params and every nu within rtol 1e-4 (the
    convolutions sum in another order on each device)."""
    from repro_torch.core.packer import as_tree

    init, apply = small.cnn(10, (8, 8, 1))
    p = init(torch.Generator().manual_seed(3), device="cpu")
    dims = (2, 2, 3)
    spec = api.ExperimentSpec(levels=dims, backend="multilevel", lr=0.05, state_layout=layout,
                              schedule=api.RoundSchedule(periods=(4, 2, 1)),
                              level_participation=participation)
    rng = np.random.default_rng(3)
    b = {"x": torch.from_numpy(rng.normal(size=(4, 1) + dims + (4, 8, 8, 1)).astype(np.float32)),
         "y": torch.from_numpy(rng.integers(0, 10, size=(4, 1) + dims + (4,)).astype(np.int32))}
    masks = None
    if participation is not None:
        masks = [torch.ones(2), torch.tensor([1.0, 0.0]).repeat(2, 1),
                 torch.tensor([[[1.0, 0.0, 1.0], [0.0, 1.0, 1.0]]]).repeat(2, 1, 1)]
    outs = []
    for dev in (cuda, "cpu"):
        eng = api.build(spec, small.make_loss(apply), device=dev)
        st, met = eng.round_fn(eng.init(p), {k: v.to(dev) for k, v in b.items()}, draws=masks)
        assert bool(torch.isfinite(met.loss).all())
        outs.append([convert.to_numpy(as_tree(t)) for t in (st.params, *st.nus)])
    for got, want in zip(*outs):
        for name in want:
            for leaf in want[name]:
                np.testing.assert_allclose(got[name][leaf], want[name][leaf], rtol=1e-4,
                                           atol=1e-5, err_msg=f"{name}/{leaf}")


# ------------------------------------------------ selective scan (hybrid serving)
# The kernel runs the plain version's sequential recurrence with an FMA for
# h and the approximate unit's 2^x (about 2^-22 relative) for the decays;
# both are float32 throughout, so they agree to float32 rounding: within
# 1e-5 of max|y| for y and of max|h| for the state.


def _scan_inputs(cuda, B, T, Di, S, udtype, seed, dt_shift=0.0):
    gen = torch.Generator(device=cuda).manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=cuda)

    u = torch.nn.functional.silu(randn(B, T, Di)).to(udtype)
    dt = torch.nn.functional.softplus(randn(B, T, Di) + dt_shift)
    Bm, Cm = randn(B, T, S), randn(B, T, S)
    log_a = torch.log(torch.linspace(1.0, S, S, device=cuda))[None] + 0.2 * randn(Di, S)
    d_skip = 1.0 + 0.1 * randn(Di)
    s0 = randn(B, Di, S)
    return u, dt, Bm, Cm, log_a, d_skip, s0


def _assert_scan_close(got, want):
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        assert (g - w).abs().max().item() <= 1e-5 * w.abs().max().item()


@pytest.mark.parametrize("B,T,Di,S,dt_shift", [
    (1, 1, 8, 16, 0.0),          # one token
    (2, 37, 37, 16, 0.0),        # Di not a multiple of a block's 32 chains
    (2, 64, 96, 16, -6.0),       # weak decays: a memory of hundreds of tokens
    (1, 2049, 40, 16, -3.0),     # T past the reference's chunk of 2048
    (3, 50, 33, 5, 0.0),         # S < 16: the scalar loads
    (4, 300, 3200, 16, 0.0),     # hymba's Di
])
@pytest.mark.parametrize("udtype", [torch.float32, torch.bfloat16])
def test_selective_scan_kernel_matches_plain(cuda, B, T, Di, S, dt_shift, udtype):
    args = _scan_inputs(cuda, B, T, Di, S, udtype, B + T + Di + S, dt_shift)
    before = ss.selective_scan.launches
    got = ss.selective_scan(*args)
    torch.cuda.synchronize()
    assert ss.selective_scan.launches == before + 1
    _assert_scan_close(got, ss.selective_scan_ref(*args))
    again = ss.selective_scan(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, again))      # bit-identical


@pytest.mark.parametrize("B,T,Di,S,dt_shift", [
    (1, 2048, 3200, 16, 0.0),    # hymba's training shape: one microbatch
    (2, 130, 40, 16, -3.0),      # three chunks, the last ragged; a partial block
    (3, 50, 33, 5, 0.0),         # S < 16: the plain-load ring
])
@pytest.mark.parametrize("udtype", [torch.float32, torch.bfloat16])
def test_selective_scan_chunk_states(cuda, B, T, Di, S, dt_shift, udtype):
    """The forward with its chunk-start states (training): y and the final
    state as without them, bit for bit; each chunk's state within 1e-5 of
    max|h| of the plain loop's h at that token (chunk 0: the initial state
    itself)."""
    args = _scan_inputs(cuda, B, T, Di, S, udtype, B + T + Di, dt_shift)
    before = ss.selective_scan.launches
    y, s_out, states = ss.selective_scan(*args, keep_states=True)
    assert ss.selective_scan.launches == before + 1
    assert all(torch.equal(a, b) for a, b in zip((y, s_out), ss.selective_scan(*args)))
    nc = -(-T // ss.CHUNK)
    assert tuple(states.shape) == (B, nc, Di, S)
    assert torch.equal(states[:, 0], args[-1])
    u, dt, Bm, _, log_a, _, h = args
    A = -torch.exp(log_a)
    for t in range(T):           # the plain loop's recurrence, h kept at chunk starts
        if t and t % ss.CHUNK == 0:
            got = states[:, t // ss.CHUNK]
            assert (got - h).abs().max().item() <= 1e-5 * h.abs().max().item(), t
        h = torch.exp(dt[:, t, :, None] * A) * h + (dt[:, t] * u[:, t].float())[:, :, None] \
            * Bm[:, t, None]


# The backward kernel against its plain version (a float32 reverse loop on
# the card): each gradient within 1e-5 of its largest entry; dB and dC (sums
# over Di), dlog_a and dd_skip (over (b, t)) within 1e-5 of the largest sum
# of their terms' magnitudes (tests/test_torch_hybrid_train.py), taken from
# the plain backward on the operands' absolute values. A bf16 du adds one
# bf16 ulp of its largest entry (each side rounds once from float32).
def _bwd_scales(args, dy, dfin):
    ab = [a.float().abs() for a in args[:4]] + [args[4], args[5].abs(), args[6].abs()]
    mags = ss.selective_scan_bwd_ref(*ab, dy.abs(), None if dfin is None else dfin.abs())
    return {"dB": mags[2].max().item(), "dC": mags[3].max().item(),
            "dlog_a": mags[4].abs().max().item(), "dd_skip": mags[5].max().item()}


def _assert_ssm_bwd_close(got, want, scales, udtype):
    names = ("du", "ddt", "dB", "dC", "dlog_a", "dd_skip", "dstate0")
    for name, g, w in zip(names, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        top = w.float().abs().max().item()
        allow = 1e-5 * scales.get(name, top)
        if name == "du" and udtype == torch.bfloat16:
            allow += 2.0 ** (math.floor(math.log2(top)) - 7)
        assert (g.float() - w.float()).abs().max().item() <= allow, name


@pytest.mark.parametrize("B,T,Di,S,dt_shift,d_final", [
    (1, 2048, 3200, 16, 0.0, False),  # hymba's training shape, as the model calls it
    (2, 130, 40, 16, 0.0, True),      # ragged last chunk, a partial block of chains
    (3, 50, 33, 5, 0.0, True),        # S < 16, Di not 16-byte pieces: plain loads
    (2, 300, 64, 16, 3.0, True),      # strong decays: every chunk's decay product is 0
    (1, 700, 96, 16, -4.0, False),    # weak decays: a memory of about a hundred tokens
    (1, 1, 40, 16, 0.0, True),        # one token: one chunk, no fold step
    (1, 64, 32, 16, 0.0, True),       # one whole chunk of 64 tokens
    (1, 4096, 64, 16, -2.0, False),   # 64 chunks: the fold's longest carry at this size
])
@pytest.mark.parametrize("udtype", [torch.float32, torch.bfloat16])
def test_selective_scan_bwd_kernel_matches_plain(cuda, B, T, Di, S, dt_shift, d_final, udtype):
    args = _scan_inputs(cuda, B, T, Di, S, udtype, B + T + Di + S, dt_shift)
    gen = torch.Generator(device=cuda).manual_seed(T)
    dy = torch.randn(B, T, Di, generator=gen, device=cuda)
    dfin = torch.randn(B, Di, S, generator=gen, device=cuda) if d_final else None
    _, _, states = ss.selective_scan(*args, keep_states=True)
    before = ss.selective_scan_bwd.launches
    got = ss.selective_scan_bwd(*args, dy, dfin, states=states)
    torch.cuda.synchronize()
    assert ss.selective_scan_bwd.launches == before + ss.BWD_LAUNCHES
    _assert_ssm_bwd_close(got, ss.selective_scan_bwd_ref(*args, dy, dfin),
                          _bwd_scales(args, dy, dfin), udtype)
    again = ss.selective_scan_bwd(*args, dy, dfin)        # states from its own forward
    assert all(torch.equal(a, b) for a, b in zip(got, again))      # bit-identical


def test_selective_scan_function_on_card_matches_cpu(cuda):
    """``SelectiveScan`` on the card (both kernels) against the same Function
    on the CPU (both plain versions), u in bf16, the final state's gradient
    absent (as in training) and present."""
    args = _scan_inputs(cuda, 2, 150, 48, 16, torch.bfloat16, 5)
    gen = torch.Generator(device=cuda).manual_seed(6)
    dy = torch.randn(2, 150, 48, generator=gen, device=cuda)
    dfin = torch.randn(2, 48, 16, generator=gen, device=cuda)
    for with_final in (False, True):
        grads = {}
        for dev in (cuda, torch.device("cpu")):
            ins = [a.to(dev).clone().requires_grad_() for a in args]
            y, s = ss.SelectiveScan.apply(*ins)
            loss = (y * dy.to(dev)).sum() + ((s * dfin.to(dev)).sum() if with_final else 0)
            grads[dev.type] = [g.cpu() for g in torch.autograd.grad(loss, ins)]
        _assert_ssm_bwd_close(grads["cuda"], grads["cpu"], _bwd_scales(
            [a.cpu() for a in args], dy.cpu(), dfin.cpu() if with_final else None),
            torch.bfloat16)


def test_selective_scan_model_call_on_card_matches_cpu(cuda):
    """``ssm_parallel`` and ``ssm_step`` with the same float32 params on the
    card (the kernel) and on the CPU (the plain loop)."""
    from repro_torch.models import ssm as S_

    p = S_.init_ssm(torch.Generator().manual_seed(0), 32, 48, 16, torch.float32, "cpu")
    pc = convert.params_from_numpy(convert.to_numpy(p), cuda)
    x = torch.randn(2, 45, 32, generator=torch.Generator().manual_seed(1))
    s0 = torch.randn(2, 48, 16, generator=torch.Generator().manual_seed(2))
    oc, sc = S_.ssm_parallel(pc, x.to(cuda), s0.to(cuda))
    o, s = S_.ssm_parallel(p, x, s0)
    torch.testing.assert_close(oc.cpu(), o, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(sc.cpu(), s, rtol=1e-4, atol=1e-4)
    oc, sc = S_.ssm_step(pc, x[:, 0].to(cuda), sc)
    o, s = S_.ssm_step(p, x[:, 0], s)
    torch.testing.assert_close(oc.cpu(), o, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(sc.cpu(), s, rtol=1e-4, atol=1e-4)


def test_selective_scan_wrapper_rejects_bad_operands(cuda):
    u, dt, Bm, Cm, log_a, d_skip, s0 = _scan_inputs(cuda, 2, 8, 12, 16, torch.float32, 0)
    with pytest.raises(TypeError, match="dtype"):
        ss.selective_scan(u, dt.bfloat16(), Bm, Cm, log_a, d_skip, s0)
    with pytest.raises(TypeError, match="dtype"):
        ss.selective_scan(u.half(), dt, Bm, Cm, log_a, d_skip, s0)
    with pytest.raises(ValueError, match="contiguous"):
        ss.selective_scan(u, dt.transpose(0, 1).contiguous().transpose(0, 1), Bm, Cm, log_a,
                          d_skip, s0)
    with pytest.raises(ValueError, match="shape"):            # C's S is not B's
        ss.selective_scan(u, dt, Bm, Cm[..., :8].contiguous(), log_a, d_skip, s0)
    with pytest.raises(ValueError, match="shape"):            # log_a's S is not B's
        ss.selective_scan(u, dt, Bm, Cm, log_a[:, :8].contiguous(), d_skip, s0)
    with pytest.raises(ValueError, match="state size"):
        big = torch.zeros(2, 8, 17, device=cuda)
        ss.selective_scan(u, dt, big, big, torch.zeros(12, 17, device=cuda), d_skip,
                          torch.zeros(2, 12, 17, device=cuda))
    with pytest.raises(ValueError, match="expected cuda"):
        ss.selective_scan(u, dt, Bm, Cm, log_a.cpu(), d_skip, s0)


# ------------------------------------------------------------------ moe


def _moe_case(cuda, S, k, E, C, D, dtype, seed):
    """Random routing of S tokens to k distinct experts of E with the
    reference's positions (later tokens dropped past C), and operands."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    idx = torch.rand(S, E, generator=gen, device=cuda).argsort(-1)[:, :k]
    flat = torch.nn.functional.one_hot(idx, E).reshape(S * k, E)
    pos = ((torch.cumsum(flat, 0) - 1) * flat).sum(-1).reshape(S, k)
    r = md.make_routing(idx, pos, pos < C, E, C)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=cuda).to(dtype)

    w = torch.softmax(torch.randn(S, k, generator=gen, device=cuda), -1).to(dtype)
    return r, randn(S, D), randn(E, C, D), randn(S, D), w


def _ulps_of(want, dtype):
    """One rounding step of ``dtype`` at each |want| (float32: 2^-23 rel)."""
    bits = 7 if dtype == torch.bfloat16 else 23
    mag = want.float().abs().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(mag)) - bits)


@pytest.mark.parametrize("S,k,E,C,D", [
    (2048, 8, 32, 640, 1024),     # granite's training shape (capacity 1.25)
    (8192, 8, 32, 2560, 1024),    # granite's serving prefill (4 x 2048 tokens, capacity 2560)
    (4, 8, 32, 4, 1024),          # granite's decode step (4 tokens, dropless)
    (300, 8, 32, 40, 1024),       # heavy drops, empty experts unlikely
    (50, 2, 4, 50, 128),          # dropless (C = S), the reduced config
    (37, 3, 5, 9, 100),           # D not a multiple of 8: the scalar path
    (17, 1, 3, 4, 36),            # k = 1, float32 vectors but not bf16 ones
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_kernels_match_plain(cuda, S, k, E, C, D, dtype):
    """Dispatch bit for bit against the one-hot einsum; the scaled gather
    (one product a slot) within one rounding; combine (k terms summed in
    float32 in j order, the plain version over (e, c)) and the gate gradient
    (a float32 dot over D) within a few float32 roundings of the sum's
    magnitude, plus one rounding to bf16; two calls of each bit for bit."""
    r, x, y, dout, w = _moe_case(cuda, S, k, E, C, D, dtype, S + k + D)
    counts = (md.moe_gather.launches, md.moe_combine.launches, md.moe_gate_grad.launches)
    disp = md.moe_gather(x, r)
    scaled = md.moe_gather(dout, r, w)
    comb = md.moe_combine(y, r, w)
    unit = md.moe_combine(y, r)
    dg = md.moe_gate_grad(dout, y, r)
    torch.cuda.synchronize()
    assert (md.moe_gather.launches, md.moe_combine.launches, md.moe_gate_grad.launches) == (
        counts[0] + 2, counts[1] + 2, counts[2] + 1)
    assert torch.equal(disp, md.moe_gather_ref(x, r))
    want = md.moe_gather_ref(dout, r, w)
    assert ((scaled.float() - want.float()).abs() <= _ulps_of(want, dtype)).all()
    # Sums: |error| <= (terms) float32 roundings of the sum of magnitudes,
    # then the output's own rounding.
    yabs = y.float().abs()
    for got, want, weights in ((comb, md.moe_combine_ref(y, r, w), w),
                               (unit, md.moe_combine_ref(y, r), None)):
        mag = md.moe_combine_ref(yabs, r, None if weights is None else weights.float().abs())
        bound = k * 2.0 ** -23 * mag + _ulps_of(want, dtype)
        assert ((got.float() - want.float()).abs() <= bound).all()
    want = md.moe_gate_grad_ref(dout, y, r)
    mag = md.moe_gate_grad_ref(dout.float().abs(), yabs, r)
    assert ((dg.float() - want.float()).abs() <= D * 2.0 ** -23 * mag
            + _ulps_of(want, dtype)).all()
    assert (dg[~r.keep] == 0).all()
    for fn in (lambda: md.moe_gather(x, r), lambda: md.moe_gather(dout, r, w),
               lambda: md.moe_combine(y, r, w), lambda: md.moe_gate_grad(dout, y, r)):
        assert torch.equal(fn(), fn())


def test_moe_block_on_card_matches_cpu(cuda):
    """``moe_block`` forward and backward (float32, capacity drops, the
    chunked branch) on the card (the kernels) against the CPU (the plain
    versions), from the same params and inputs."""
    from repro_torch.models import moe as M

    p = M.init_moe(torch.Generator().manual_seed(0), 64, 96, 8, torch.float32, "cpu")
    x = torch.randn(2, 48, 64, generator=torch.Generator().manual_seed(1))
    outs = []
    for dev in ("cpu", cuda):
        pd = convert.params_from_numpy(convert.to_numpy(p), dev)
        leaves = [pd["router"]["w"], pd["wi"], pd["wg"], pd["wo"]]
        xd = x.to(dev).requires_grad_(True)
        for t in leaves:
            t.requires_grad_(True)
        out, aux = M.moe_block(pd, xd, num_experts=8, top_k=3, chunk_tokens=32)
        loss = (out * out).sum() + aux
        grads = torch.autograd.grad(loss, [xd] + leaves)
        outs.append([out.detach(), aux.detach()] + [g.detach() for g in grads])
    for c, g in zip(*outs):
        torch.testing.assert_close(g.cpu(), c, rtol=1e-4, atol=1e-5)


def test_moe_wrappers_reject_bad_operands(cuda):
    r, x, y, dout, w = _moe_case(cuda, 20, 2, 4, 8, 64, torch.float32, 0)
    with pytest.raises(TypeError, match="dtype"):
        md.moe_gather(x, r, w.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        md.moe_gather(x.t().contiguous().t(), r)
    with pytest.raises(ValueError, match="shape"):
        md.moe_combine(y[:, :4].contiguous(), r)
    with pytest.raises(ValueError, match="expected cuda"):
        md.moe_combine(y, r._replace(row=r.row.cpu()))
    with pytest.raises(ValueError, match="top_k"):
        big = _moe_case(cuda, 4, 33, 40, 4, 64, torch.float32, 1)[0]
        md.moe_gate_grad(dout[:4].contiguous(), torch.zeros(40, 4, 64, device=cuda), big)


@pytest.mark.parametrize("layout,part", [("flat", "full"), ("tree", "partial")])
def test_one_rank_nccl_mesh_matches_one_card(cuda, tmp_path, layout, part):
    """The sharded round on a (1, 1, 1, 1) mesh of one NCCL rank is the
    single-card round, bit for bit (quadratic problem, fused, 2 rounds)."""
    import datetime

    import torch.distributed as dist

    from repro_torch.launch.mesh import smoke_mesh

    G, K, E, H, A, D = 2, 2, 2, 2, 2, 6
    rng = np.random.default_rng(3)
    shape = (E, H, A, G, K, D)
    batches = {"a": torch.from_numpy(rng.normal(size=shape).astype(np.float32) + 2).cuda(),
               "b": torch.from_numpy(rng.normal(size=shape).astype(np.float32)).cuda()}

    def loss(p, b):
        r = b["a"] * p["w"] - b["b"]
        return 0.5 * torch.sum(r * r)

    kw = {} if part == "full" else dict(client_participation=0.5, participation_mode="fixed")
    spec = api.ExperimentSpec(levels=(G, K), backend="sharded", lr=0.05, fusion="fused",
                              state_layout=layout, schedule=api.RoundSchedule(
                                  group_rounds=E, local_steps=H, microbatches=A), **kw)
    masks = [ParticipationMasks(torch.ones(G), torch.tensor([[1.0, 0.0], [0.0, 1.0]])),
             ParticipationMasks(torch.ones(G), torch.tensor([[0.0, 1.0], [1.0, 0.0]]))]

    def run(mesh):
        eng = api.build(spec, loss, mesh=mesh)
        st = eng.init({"w": torch.zeros(D, device="cuda")})
        ms = []
        for r in range(2):
            st, m = eng.round_fn(st, batches,
                                 draws=None if part == "full" else RoundDraws(masks=masks[r]))
            ms.append(m)
        return st, ms

    st1, m1 = run(None)
    dist.init_process_group("nccl", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
                            world_size=1, timeout=datetime.timedelta(seconds=60))
    try:
        mesh = smoke_mesh((1, 1, 1, 1), ("group", "client", "fsdp", "model"))
        assert dist.get_backend(mesh.get_group("client")) == "nccl"
        st2, m2 = run(mesh)
    finally:
        dist.destroy_process_group()
    for f in ("params", "z", "y"):
        a, b = getattr(st1, f), getattr(st2, f)
        a, b = (a.to_tree(), b.to_tree()) if hasattr(a, "to_tree") else (a, b)
        assert torch.equal(a["w"], b["w"]), f
    for x, y in zip(m1, m2):
        for f in x._fields:
            assert torch.equal(getattr(x, f), getattr(y, f)), f


# ---------------------------------------------------------------- the auditor


def _audit_cases(fast_only):
    from repro_torch.analysis import specs

    return specs.audit_cases(fast_only=fast_only)


@pytest.mark.parametrize("case", _audit_cases(True), ids=lambda c: c.name)
def test_audit_fast_matrix_on_card(cuda, case):
    """Every fast case's chunk on the card: every invariant clean with the
    host-sync watch on (the known sites of the sharded round notes, nothing
    else), the kernel launches three ways -- the wrappers' ``calls``, their
    ``launches`` and ``torch.profiler``'s kernels -- equal to the case's
    ``expected_by_wrapper``, wrapper by wrapper, and the counted work equal
    to the CPU's stamp (the count does not depend on the route)."""
    from repro_torch.analysis import budgets, invariants, specs

    engine = case.build_engine(device="cuda")
    lc = engine.lower_chunk(specs.abstract_data(engine), params=specs.abstract_params())
    found = invariants.run_invariants(case, lc)
    assert [str(f) for f in found if f.severity == "error"] == []
    assert lc.syncs is not None
    want = case.expected_by_wrapper
    assert invariants.nonzero_counts(lc.calls) == invariants.nonzero_counts(lc.launches) == want
    assert invariants.nonzero_counts(lc.profiled) == want
    assert sum(want.values()) == case.expected_calls
    drift = budgets.check_route({case.name: budgets.measure(lc)})
    assert [str(f) for f in drift] == []


def test_audit_cli_on_card(cuda, tmp_path):
    from repro_torch.launch import audit

    rc = audit.main(["--fast", "--device", "cuda", "--strict-budgets", "-q",
                     "--report", str(tmp_path / "r.json")])
    assert rc == 0
