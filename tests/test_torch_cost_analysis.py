"""The dispatch-level cost counter (repro_torch.launch.cost_analysis) and
the kernels' cost formulas, against the reference's HLO walker
(src/repro/launch/hlo_analysis.py) and PERF.md's kernel table.

* Loop-free products: a matmul and a batched matmul count what
  ``hlo_analysis.analyze`` counts in the jitted function's HLO; a
  convolution what XLA's own ``cost_analysis`` counts (the HLO walker
  counts a convolution as ``2 * prod(result)``, without its contraction).
* Eager rounds have no trip counts: a simulator round's products are
  ``E * H`` times one local step's, and ``torch.func.vmap`` over K clients
  counts K times one client's.
* A CPU run, a meta run and (on the card) a kernel run count the same
  work: reduced glm4-9b and hymba-1.5b sharded rounds count alike on
  ``meta`` and on CPU tensors, and a hand kernel's plain route is counted
  once, by its ``cost(...)``; a copy between devices is a transfer, not
  device traffic.
* Each kernel's ``cost(...)`` at the kernel table's shapes reproduces the
  table's bound column to its printed digits.
"""
import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from torch.func import grad, vmap  # noqa: E402

from repro.launch import hlo_analysis as H  # noqa: E402
from repro_torch import api as tapi  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.configs.shapes import param_specs  # noqa: E402
from repro_torch.core.device import MetaFactories  # noqa: E402
from repro_torch.kernels import accounting  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import moe_dispatch as md  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import rwkv6_scan as rs  # noqa: E402
from repro_torch.kernels import ssm_scan as ss  # noqa: E402
from repro_torch.launch.cost_analysis import CostCounter  # noqa: E402
from repro_torch.models import small as tsmall  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

def analyze(fn, *args):
    with CostCounter() as cc:
        fn(*args)
    return None, cc.costs


PRODUCTS = ("aten.mm", "aten.addmm", "aten.bmm", "aten.baddbmm", "aten.convolution",
            "aten.convolution_backward")


def _products(costs) -> float:
    return sum(v["flops"] for k, v in costs.by_op.items() if k in PRODUCTS)


# ----------------------------------------------------- loop-free products


def _hlo_flops(fn, *shapes):
    sds = [jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes]
    compiled = jax.jit(fn).lower(*sds).compile()
    return H.analyze(compiled.as_text()).flops, H.xla_cost_dict(compiled)["flops"]


@pytest.mark.parametrize("shapes", [((128, 64), (64, 256)), ((3, 16, 8), (3, 8, 32))],
                         ids=["matmul", "batched"])
def test_products_match_hlo_analysis(shapes):
    want, _ = _hlo_flops(lambda a, b: a @ b, *shapes)
    a, b = (torch.randn(s) for s in shapes)
    _, costs = analyze(torch.matmul, a, b)
    assert costs.flops == want
    _, meta = analyze(torch.matmul, *(t.to("meta") for t in (a, b)))
    assert meta.flops == want and meta.bytes == costs.bytes == 4 * (a.numel() + b.numel() + (
        want / 2 / shapes[0][-1]))


def test_convolution_matches_xla_cost_analysis():
    def conv(x, w):
        return jax.lax.conv_general_dilated(x, w, (1, 1), "VALID",
                                            dimension_numbers=("NCHW", "OIHW", "NCHW"))

    walker, xla = _hlo_flops(conv, (2, 3, 8, 8), (4, 3, 3, 3))
    x, w = torch.randn(2, 3, 8, 8), torch.randn(4, 3, 3, 3)
    _, costs = analyze(torch.nn.functional.conv2d, x, w)
    out = 2 * 4 * 6 * 6
    assert costs.flops == xla == 2 * out * 3 * 3 * 3
    assert walker == 2 * out          # the HLO walker leaves the contraction out


def test_elementwise_and_reductions_follow_hlo_rules():
    x = torch.randn(32, 16)
    with CostCounter() as cc:
        y = torch.exp(x) * 2.0
        s = y.sum()
        z = y.clone().view(-1)
    assert cc.costs.by_op["aten.exp"]["flops"] == x.numel()
    assert cc.costs.by_op["aten.mul"]["flops"] == x.numel()
    assert cc.costs.by_op["aten.sum"]["flops"] == x.numel()
    assert cc.costs.by_op["aten.clone"] == {"flops": 0.0, "bytes": 2 * 4 * x.numel()}
    assert "aten.view" not in cc.costs.by_op or cc.costs.by_op["aten.view"]["bytes"] == 0
    assert float(s) == float(z.sum())


def test_copies_between_devices_are_transfers_not_bytes():
    """A copy from one device to another (the host's constants sent to the
    card; here to ``meta``) counts in ``transfer_bytes`` and not in
    ``bytes``, which a CPU run, making no such copy, then counts alike; a
    copy within a device stays in ``bytes``."""
    periods = torch.tensor([2, 1], dtype=torch.int32)
    with CostCounter() as cc:
        on = periods.to("meta")
        dst = torch.empty(2, dtype=torch.int32, device="meta")
        dst.copy_(periods)
        within = periods.to(torch.int64)
    assert cc.costs.transfer_bytes == 2 * 8
    assert cc.costs.by_op["aten._to_copy"]["bytes"] == 8 + 16       # the cast alone
    assert cc.costs.by_op["aten.copy_"]["bytes"] == 0
    assert cc.costs.bytes == 8 + 16
    assert on.device.type == "meta" and within.dtype == torch.int64


# ------------------------------------------------------- rounds and vmap


def test_vmap_counts_k_times_one_client():
    init, apply = tsmall.mlp(10, 16, hidden=32)
    p = init(torch.Generator().manual_seed(0), device="cpu")
    loss = tsmall.make_loss(apply)
    x, y = torch.randn(5, 4, 16), torch.randint(0, 10, (5, 4))
    with CostCounter() as one:
        grad(loss)(p, {"x": x[0], "y": y[0]})
    with CostCounter() as five:
        vmap(grad(loss), in_dims=(None, 0))(p, {"x": x, "y": y})
    assert _products(five.costs) == 5 * _products(one.costs) > 0
    assert five.costs.flops == pytest.approx(5 * one.costs.flops, rel=0.02)


def test_simulator_round_products_scale_with_e_times_h():
    init, apply = tsmall.mlp(10, 16, hidden=32)
    p = init(torch.Generator().manual_seed(0), device="cpu")
    loss = tsmall.make_loss(apply)
    out = {}
    for E, Hs in ((1, 1), (2, 3)):
        spec = tapi.ExperimentSpec(levels=(2, 3), schedule=tapi.RoundSchedule(
            group_rounds=E, local_steps=Hs), state_layout="flat", fusion="fused")
        eng = tapi.build(spec, loss, device="cpu")
        rng = np.random.default_rng(0)
        b = {"x": torch.from_numpy(rng.normal(size=(E, Hs, 2, 3, 4, 16)).astype(np.float32)),
             "y": torch.from_numpy(rng.integers(0, 10, size=(E, Hs, 2, 3, 4)))}
        state = eng.init(p)
        with CostCounter() as cc:
            eng.round_fn(state, b)
        out[E * Hs] = cc.costs
    assert _products(out[6]) == 6 * _products(out[1]) > 0
    assert out[6].kernels["mtgc_update_flat"]["calls"] == 6
    assert out[6].kernels["mtgc_update_flat"]["flops"] == 6 * out[1].kernels[
        "mtgc_update_flat"]["flops"]


# ---------------------------------------------------------- meta vs CPU


# Sequence lengths: glm4-9b past 1024 tokens takes the flash path; hymba's
# selective scan runs at any length (its attention is the plain one below).
ROUND_T = {"glm4-9b": 1040, "hymba-1.5b": 64}


def _reduced_round(arch: str, meta: bool):
    cfg = tconfigs.get_arch(arch).reduced(attn_block=512)
    bundle = TT.build_model(cfg)
    G, K, T = 1, 2, ROUND_T[arch]
    spec = tapi.ExperimentSpec(levels=(G, K), schedule=tapi.RoundSchedule(
        group_rounds=1, local_steps=1, microbatches=1), backend="sharded",
        state_layout="tree", lr=0.01)
    eng = tapi.build(spec, bundle.loss, device="cpu")
    rng = np.random.default_rng(0)
    shape = (1, 1, 1, G, K, 1, T)
    toks = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, size=shape).astype(np.int32))
            for k in ("tokens", "targets")}
    if meta:
        state = eng.abstract_state(param_specs(cfg, bundle))
        toks = {k: v.to("meta") for k, v in toks.items()}
    else:
        state = eng.init(bundle.init(0, device="cpu"))
    with CostCounter() as cc:
        eng.round_fn(state, toks)
    return cc.costs


@pytest.mark.parametrize("arch", ["glm4-9b", "hymba-1.5b"])
def test_meta_round_counts_what_the_cpu_round_counts(arch):
    cpu, meta = _reduced_round(arch, False), _reduced_round(arch, True)
    assert meta.flops == cpu.flops > 0
    assert meta.bytes == cpu.bytes
    assert meta.kernels == cpu.kernels
    assert meta.by_scope == cpu.by_scope
    assert {"attn", "mlp", "xent", "embed", "group_agg", "global_agg"} <= set(cpu.by_scope)
    if arch == "hymba-1.5b":
        assert cpu.kernels["selective_scan"]["calls"] == cpu.kernels["selective_scan_bwd"][
            "calls"] > 0 and cpu.by_scope["ssm"]["flops"] > 0
    else:
        assert cpu.kernels["flash_attention"]["calls"] == cpu.kernels["flash_attention_bwd"][
            "calls"] == 4                          # 2 layers x 2 clients


# ------------------------------------------------ hand kernels, once each


def test_plain_routes_are_counted_once_by_their_cost():
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 24, 4, 32, generator=g, requires_grad=True)
    k = torch.randn(1, 24, 2, 32, generator=g, requires_grad=True)
    v = torch.randn(1, 24, 2, 32, generator=g, requires_grad=True)
    with CostCounter() as cc:
        o = fa.FlashAttention.apply(q, k, v, True, 0, 0, 8)
        o.sum().backward()
    fwd = fa.flash_attention_cost(q, k, v, return_stats=True)
    m = torch.empty(1, 4, 24)
    bwd = fa.flash_attention_bwd_cost(q, k, v, o, o, m, m)
    c = cc.costs
    assert c.kernels["flash_attention"] == {"calls": 1, "flops": fwd[0], "bytes": fwd[1]}
    assert c.kernels["flash_attention_bwd"] == {"calls": 1, "flops": bwd[0], "bytes": bwd[1]}
    assert c.flops == fwd[0] + bwd[0] + o.numel()          # + the sum
    assert "aten.bmm" not in c.by_op and c.by_scope["attn"]["flops"] == fwd[0] + bwd[0]


def test_calls_count_every_route_and_launches_only_the_card():
    ops.reset_launch_counts()
    x = torch.randn(2, 3, 5)
    y = torch.randn(2, 5)
    for t in (x, x.to("meta")):
        ops.mtgc_update_flat(t, t, t, y.to(t.device), lr=0.1)
    assert ops.calls()["mtgc_update_flat"] == 2 and ops.launches()["mtgc_update_flat"] == 0
    u, dt = torch.randn(1, 8, 4), torch.rand(1, 8, 4)
    args = (u, dt, torch.randn(1, 8, 2), torch.randn(1, 8, 2), torch.randn(4, 2),
            torch.randn(4), torch.zeros(1, 4, 2))
    ss.SelectiveScan.apply(*args)
    assert ops.calls()["selective_scan"] == 1
    r = torch.randn(1, 8, 2, 4)
    rs.RWKV6Scan.apply(r, r, r, -r.abs(), torch.randn(2, 4), torch.zeros(1, 2, 4, 4), 4)
    assert ops.calls()["rwkv6_scan"] == 1 and sum(ops.launches().values()) == 0
    ops.reset_launch_counts()
    assert sum(ops.calls().values()) == 0


def test_collectives_counted_and_not_made_on_meta():
    from repro_torch.sharding.state import MeshAxes

    ax = MeshAxes.__new__(MeshAxes)
    ax.pg = {"group": object(), "client": None}          # a group dim of size > 1
    t = torch.empty(1000, device="meta")
    with CostCounter() as cc:
        ax.sum_(t, "client", "group")
    assert cc.costs.collective_bytes == 4000 == cc.costs.per_collective["all-reduce"]


def test_no_cost_formed_without_a_listener():
    def boom(*a, **k):
        raise AssertionError("cost formed with nobody listening")

    seen = accounting.kernel_call(ops.mtgc_update, lambda: 1, boom, "f32")
    assert seen == 1


# ------------------------------------------------- the kernel table's bounds


HBM, F32, BF16 = 3.35e12, 67e12, 989e12
N = 2_156_490


def _bound_ms(cost, peak) -> float:
    flops, nbytes = cost
    return max(nbytes / HBM, flops / peak) * 1e3


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _routing(S, k, E, C):
    i = _meta(S, k, dtype=torch.int64)
    return md.Routing(i, i, _meta(S, k, dtype=torch.bool), E, C, _meta(S, k, dtype=torch.int32),
                      _meta(E * C, dtype=torch.int32))


def _cnn_leaves():
    with MetaFactories():
        p = tsmall.cnn(10, (32, 32, 3))[0](torch.Generator(), device="cpu")
    from repro_torch.core.tree import tree_leaves
    return [t.shape for t in tree_leaves(p)]


def _table():
    bf, x = torch.bfloat16, _meta(10, 10, N)
    q, kv = _meta(4, 2048, 40, 128, dtype=bf), _meta(4, 2080, 8, 128, dtype=bf)
    u4 = _meta(4, 2048, 3200, dtype=bf)
    u1 = _meta(1, 2048, 3200, dtype=bf)

    def scan_args(u):
        B, T, Di = u.shape
        return (u, _meta(B, T, Di), _meta(B, T, 16), _meta(B, T, 16), _meta(Di, 16), _meta(Di),
                _meta(B, Di, 16))

    r4 = _meta(4, 2048, 32, 64, dtype=bf)
    r1 = _meta(1, 2048, 32, 64, dtype=bf)

    def rw(r):
        B, T, Hh, Dh = r.shape
        return r, r, r, _meta(*r.shape), _meta(Hh, Dh), _meta(B, Hh, Dh, Dh)

    qb, kb = _meta(1, 2048, 32, 128, dtype=bf), _meta(1, 2048, 2, 128, dtype=bf)
    st = _meta(1, 32, 2048)
    mt = {"train": (_meta(2048, 1024, dtype=bf), _routing(2048, 8, 32, 640)),
          "prefill": (_meta(8192, 1024, dtype=bf), _routing(8192, 8, 32, 2560))}

    def y_of(name):
        src, r = mt[name]
        return _meta(r.num_experts, r.capacity, 1024, dtype=bf)

    def w_of(name):
        return _meta(*mt[name][1].gate_idx.shape, dtype=bf)

    leaf = [_meta(10, 10, *s) for s in _cnn_leaves()]
    return [
        ("mtgc_update_flat", ops.mtgc_update_flat.cost(x, x, x, _meta(10, N)), F32, "1.0557"),
        ("mtgc_update (8 leaves)", tuple(map(sum, zip(*(ops.mtgc_update.cost(a, a, a, a)
                                                         for a in leaf)))), F32, "1.2875"),
        ("int8_roundtrip", ops.int8_roundtrip.cost(_meta(100, N), _meta(100), _meta(100, N)),
         F32, "0.7725"),
        ("topk_mask", ops.topk_mask.cost(_meta(100, N), _meta(100)), F32, "0.5150"),
        ("flash_attention", ops.flash_attention.cost(q, kv, kv), BF16, "0.1738"),
        ("flash_attention window", ops.flash_attention.cost(
            _meta(4, 2048, 32, 128, dtype=bf), _meta(4, 2080, 16, 128, dtype=bf),
            _meta(4, 2080, 16, 128, dtype=bf), window=1024), BF16, "0.1043"),
        ("flash_attention window, hymba", ops.flash_attention.cost(
            _meta(4, 2048, 25, 64, dtype=bf), _meta(4, 2080, 5, 64, dtype=bf),
            _meta(4, 2080, 5, 64, dtype=bf), window=1024), BF16, "0.0407"),
        ("selective_scan", ops.selective_scan.cost(*scan_args(u4)), F32, "0.0791"),
        ("selective_scan training", ops.selective_scan.cost(*scan_args(u1)), F32, "0.0198"),
        ("selective_scan_bwd", ops.WRAPPERS["selective_scan_bwd"].cost(
            *scan_args(u1), _meta(1, 2048, 3200)), F32, "0.0317"),
        ("rwkv6_scan", ops.rwkv6_scan.cost(*rw(r4), chunk=64), BF16, "0.0714"),
        ("flash_attention_bwd", ops.flash_attention_bwd.cost(qb, kb, kb, qb, qb, st, st),
         BF16, "0.0869"),
        ("rwkv6_scan_bwd", ops.WRAPPERS["rwkv6_scan_bwd"].cost(*rw(r1), _meta(*r1.shape),
                                                               chunk=64), BF16, "0.0354"),
        ("moe_gather", ops.moe_gather.cost(*mt["train"]), F32, "0.0138"),
        ("moe_gather prefill", ops.moe_gather.cost(*mt["prefill"]), F32, "0.0552"),
        ("moe_combine", ops.moe_combine.cost(y_of("train"), mt["train"][1], w_of("train")),
         F32, "0.0113"),
        ("moe_combine prefill", ops.moe_combine.cost(y_of("prefill"), mt["prefill"][1],
                                                     w_of("prefill")), F32, "0.0452"),
        ("moe_gate_grad", ops.moe_gate_grad.cost(mt["train"][0], y_of("train"),
                                                 mt["train"][1]), F32, "0.0113"),
    ]


def test_kernel_costs_reproduce_the_kernel_tables_bounds():
    rows = _table()
    got = {name: f"{_bound_ms(cost, peak):.4f}" for name, cost, peak, _ in rows}
    assert got == {name: want for name, _, _, want in rows}
    assert len(_cnn_leaves()) == 8


def test_every_wrapper_has_a_cost_and_kernel_names():
    assert set(ops.WRAPPERS) == set(ops.KERNEL_NAMES)
    for name, w in ops.WRAPPERS.items():
        assert callable(w.cost) and w.calls >= 0 and w.launches >= 0, name
    assert ops.wrapper_of_kernel("void (anonymous namespace)::flat_kernel<float, float>(...)"
                                 ) == "mtgc_update_flat"
    assert ops.wrapper_of_kernel("flash_bwd_dkdv_wgmma_kernel") == "flash_attention_bwd"
    assert ops.wrapper_of_kernel("void at::native::vectorized_elementwise_kernel<4>") is None
