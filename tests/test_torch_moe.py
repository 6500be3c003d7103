"""The moe family of the port (``repro_torch.models.moe``, the moe branch of
``models/transformer.py`` and ``kernels/moe_dispatch.py``) against the JAX
package on the CPU, at the reduced granite-moe-1b-a400m (2 layers, d 128,
4 experts, top 2, float32). Params come from the reference's ``init`` and
cross through ``repro_torch.convert``; inputs come from numpy seeds.

* ``moe_block`` against ``repro.models.moe.moe_block``: outputs and aux,
  and the routing (``gate_idx``, ``keep``) exactly against the reference's
  own lines (``src/repro/models/moe.py:68-83``) -- dropless, capacity drops
  under a router skewed toward one expert, the chunked branch, and an
  all-zero router whose probabilities all tie;
* the plain ``moe_gather`` / ``moe_combine`` / ``moe_gate_grad`` against
  the reference's one-hot einsums and their ``jax.vjp``, and the autograd
  ``MoEDispatch`` / ``MoECombine`` against torch autograd of the one-hot
  form;
* forward, prefill (one of 2 x 2100 tokens, past serving's dropless limit
  of 4096) and decode, ``loss`` and every gradient (one case chunked in
  training, 2 x 3072 tokens), remat on == off, and the serve and train
  CLIs;
* bf16: the block against the reference on the same inputs, its
  departure shown to be SiLU's rounding (ROADMAP queue 3 item 18).

Tolerances, float32: dispatch is exact (a copy; the einsum's one nonzero
term a slot). Outputs, aux, logits, loss and gradients at rtol 1e-4 / atol
1e-5, the LM tests' bound: the products, the softmax and the combine's
k-term sum (j order here, (e, c) order in the reference's einsum) reorder
float32 sums. The routing is compared exactly; a routing difference would
have to be a near tie of two probabilities, and the test says so with the
gap when it finds one.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro.models.transformer import build_model as jbuild  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core.tree import tree_leaves  # noqa: E402
from repro_torch.kernels import moe_dispatch as md  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402
from repro_torch.models.transformer import build_model as tbuild  # noqa: E402

ARCH = "granite-moe-1b-a400m"
RTOL, ATOL = 1e-4, 1e-5
D, F_, E, K = 128, 256, 4, 2          # the reduced config's widths


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """One intra-op thread: the suite runs files in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _tokens(seed, B, T, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, (B, T)).astype(np.int32)


def _close(got, want, rtol=RTOL, atol=ATOL, tag=""):
    np.testing.assert_allclose(convert.to_numpy(got), np.asarray(want, np.float32),
                               rtol=rtol, atol=atol, err_msg=tag)


def _moe_params(seed, router=None):
    """The reference's ``init_moe`` (router replaced when given), as numpy."""
    p = _np(JM.init_moe(jax.random.PRNGKey(seed), D, F_, E, jnp.float32))
    if router is not None:
        p["router"]["w"] = router.astype(np.float32)
    return p


def _jax_route(p, xf, capacity):
    """The reference's routing lines (``src/repro/models/moe.py:68-83``)."""
    S = xf.shape[0]
    logits = JL.linear(p["router"], xf).astype(jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    gate_vals, gate_idx = jax.lax.top_k(probs, K)
    onehot = jax.nn.one_hot(gate_idx, E, dtype=jnp.int32).reshape(S * K, E)
    pos = ((jnp.cumsum(onehot, axis=0) - 1) * onehot).sum(-1).reshape(S, K)
    return np.asarray(probs), np.asarray(gate_idx), np.asarray(pos), np.asarray(pos < capacity)


def _same_routing(tprobs, tr, jprobs, jidx, jpos, jkeep, tag):
    got = tr.gate_idx.numpy()
    if not np.array_equal(got, jidx):
        s = np.argwhere((got != jidx).any(1))[:, 0]
        gaps = [float(abs(tprobs[i, got[i]] - tprobs[i, jidx[i]]).max()) for i in s[:4]]
        raise AssertionError(f"{tag}: {len(s)} tokens route to other experts (first {s[:4]}; "
                             f"probability gaps {gaps}: a near tie in float32 would be "
                             f"within 1e-7)")
    np.testing.assert_array_equal(tr.pos.numpy(), jpos, err_msg=tag)
    np.testing.assert_array_equal(tr.keep.numpy(), jkeep, err_msg=tag)
    _close(tprobs, jprobs, rtol=1e-6, atol=1e-7, tag=f"{tag} probs")


def _x(seed, B, T, shift=0.0):
    return (np.random.default_rng(seed).normal(size=(B, T, D)) + shift).astype(np.float32)


# (case, B, T, router, x shift, block kwargs)
CASES = {
    "dropless": (2, 9, None, 0.0, dict(dropless=True)),
    "capacity": (2, 40, None, 0.0, {}),
    "skewed_drops": (2, 40, "skew", 3.0, {}),
    "chunked": (2, 32, None, 0.0, dict(chunk_tokens=16)),
    "chunked_serving_vmap": (1, 48, "skew", 3.0, dict(chunk_tokens=16, sequential=False)),
    "zero_router_ties": (2, 40, "zero", 0.0, {}),
}


def _router(kind):
    if kind == "zero":
        return np.zeros((D, E), np.float32)
    if kind == "skew":
        # x is shifted by +3 in every coordinate, so expert 0's logit sum(x) /
        # 10 is about 38 over the others': every token's first choice.
        w = np.random.default_rng(3).normal(size=(D, E)) * 0.05
        w[:, 0] = 0.1
        return w
    return None


@pytest.mark.parametrize("case", sorted(CASES))
def test_moe_block_matches_reference(case):
    B, T, router, shift, kw = CASES[case]
    p = _moe_params(11, _router(router))
    x = _x(12, B, T, shift)
    want, want_aux = JM.moe_block(jax.tree.map(jnp.asarray, p), jnp.asarray(x), num_experts=E,
                                  top_k=K, **kw)
    tp = convert.params_from_numpy(p, "cpu")
    got, got_aux = TM.moe_block(tp, torch.from_numpy(x), num_experts=E, top_k=K, **kw)
    _close(got, want, tag=f"{case} out")
    np.testing.assert_allclose(got_aux.item(), float(want_aux), rtol=1e-5, err_msg=case)
    # The routing of each chunk (the whole input when it is not chunked).
    S = B * T
    chunk = kw.get("chunk_tokens", S) if S > kw.get("chunk_tokens", 4096) else S
    dropped = 0
    for c0 in range(0, S, chunk):
        xf = x.reshape(S, D)[c0:c0 + chunk]
        cap = TM.capacity_of(chunk, num_experts=E, top_k=K, dropless=kw.get("dropless", False))
        jprobs, jidx, jpos, jkeep = _jax_route(jax.tree.map(jnp.asarray, p), jnp.asarray(xf),
                                               cap)
        tprobs, _, tr = TM.route(tp, torch.from_numpy(xf), num_experts=E, top_k=K, capacity=cap)
        _same_routing(tprobs.numpy(), tr, jprobs, jidx, jpos, jkeep, case)
        dropped += int((~tr.keep).sum())
    if case in ("skewed_drops", "zero_router_ties", "chunked_serving_vmap"):
        assert dropped > 0, f"{case}: the router drops no choice"
    if case == "dropless":
        assert dropped == 0
    if case == "zero_router_ties":
        assert (tr.gate_idx.numpy() == np.arange(K)).all()


def test_capacity_is_the_reference_formula():
    for S, cf, dropless in ((8192, 1.25, False), (2048, 1.25, False), (3, 1.25, False),
                            (7, 1.0, False), (4096, 1.25, True)):
        want = S if dropless else min(S, max(int(cf * S * 8 / 32), 4))
        assert TM.capacity_of(S, num_experts=32, top_k=8, capacity_factor=cf,
                              dropless=dropless) == want
    assert TM.capacity_of(8192, num_experts=32, top_k=8) == 2560


@pytest.mark.parametrize("row", [[0.1, 0.3, 0.3, 0.3, 0.0, 0.3], [0.25] * 4, [0.0] * 32,
                                 [1.0, 2.0, 2.0, 0.5, 2.0, 1.0, 1.0, 0.0]])
def test_top_k_breaks_ties_as_jax(row):
    """jax.lax.top_k puts the lower index first among equal values;
    torch.topk does not ([0.1, 0.3, 0.3, 0.3, 0.0, 0.3], k = 3: JAX [1, 2,
    3], torch.topk [3, 5, 2] on this host)."""
    a = np.asarray([row, row[::-1]], np.float32)
    k = min(3, len(row))
    jv, ji = jax.lax.top_k(jnp.asarray(a), k)
    tv, ti = TM.sorted_top_k(torch.from_numpy(a), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


# ------------------------------------------------------ dispatch and combine


def _routing_case(seed, S, capacity, skew=False):
    """A Routing from the port's ``route`` on random tokens, and the tokens."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(S, D)) + (3.0 if skew else 0.0)).astype(np.float32)
    p = convert.params_from_numpy(_moe_params(seed, _router("skew") if skew else None), "cpu")
    _, gate, r = TM.route(p, torch.from_numpy(x), num_experts=E, top_k=K, capacity=capacity)
    return torch.from_numpy(x), gate.detach(), r


def _jax_disp(r, dtype=jnp.float32):
    """The reference's dispatch tensor (``src/repro/models/moe.py:86-91``)."""
    gi, pos, keep = (jnp.asarray(t.numpy()) for t in (r.gate_idx, r.pos, r.keep))
    return (jax.nn.one_hot(gi, r.num_experts, dtype=dtype)[..., None]
            * jax.nn.one_hot(pos, r.capacity, dtype=dtype)[..., None, :]
            * keep[..., None, None].astype(dtype))


@pytest.mark.parametrize("S,capacity,skew", [(24, 24, False), (40, 25, False), (40, 10, True)])
def test_plain_dispatch_and_combine_match_reference_einsums(S, capacity, skew):
    x, gate, r = _routing_case(S + capacity, S, capacity, skew)
    if skew:
        assert not bool(r.keep.all())
    disp = _jax_disp(r)
    jx, jg = jnp.asarray(x.numpy()), jnp.asarray(gate.numpy())
    # Dispatch: exact.
    want_in = jnp.einsum("sec,sd->ecd", disp.sum(1), jx)
    np.testing.assert_array_equal(md.moe_gather_ref(x, r).numpy(), np.asarray(want_in))
    # Combine, and its vjp: the gather with the gates as the scale for the
    # experts' rows, the gate gradient for the weights.
    y = np.random.default_rng(S).normal(size=(E, capacity, D)).astype(np.float32)
    dout = np.random.default_rng(S + 1).normal(size=(S, D)).astype(np.float32)

    def jcombine(yy, gg):
        return jnp.einsum("sec,ecd->sd", (disp * gg[..., None, None]).sum(1), yy)

    want, vjp = jax.vjp(jcombine, jnp.asarray(y), jg)
    dy, dg = vjp(jnp.asarray(dout))
    ty = torch.from_numpy(y)
    _close(md.moe_combine_ref(ty, r, gate), want, tag="combine")
    _close(md.moe_gather_ref(torch.from_numpy(dout), r, gate), dy, tag="gather with scale")
    _close(md.moe_gate_grad_ref(torch.from_numpy(dout), ty, r), dg, tag="gate grad")
    # The dispatch's vjp for the tokens: the combine with unit weights.
    _, dvjp = jax.vjp(lambda xx: jnp.einsum("sec,sd->ecd", disp.sum(1), xx), jx)
    (dx,) = dvjp(jnp.asarray(y))
    _close(md.moe_combine_ref(ty, r), dx, tag="combine with unit weights")
    # Dropped choices get no gate gradient, empty slots no row.
    assert (md.moe_gate_grad_ref(torch.from_numpy(dout), ty, r)[~r.keep] == 0).all()
    filled = torch.zeros(E * capacity, dtype=torch.bool)
    filled[r.row[r.keep].long()] = True
    assert (md.moe_gather_ref(x, r).reshape(E * capacity, D)[~filled] == 0).all()
    assert int(filled.sum()) == int(r.keep.sum())


def test_routing_maps_invert_each_other():
    _, _, r = _routing_case(5, 40, 10, skew=True)
    row, slot, k = r.row.reshape(-1), r.slot, K
    kept = torch.nonzero(row >= 0)[:, 0]
    assert torch.equal(slot[row[kept].long()], kept.to(torch.int32))
    held = torch.nonzero(slot >= 0)[:, 0]
    assert torch.equal(row[slot[held].long()], held.to(torch.int32))
    assert int((row >= 0).sum()) == int((slot >= 0).sum())
    assert torch.equal((r.gate_idx * r.capacity + r.pos)[r.keep], r.row[r.keep].long())
    assert k == r.gate_idx.shape[1]


def test_autograd_matches_the_one_hot_form():
    """MoEDispatch / MoECombine's backward (the plain kernels on the CPU)
    against torch autograd of the one-hot einsums."""
    x, gate, r = _routing_case(7, 40, 12, skew=True)
    y = torch.from_numpy(np.random.default_rng(8).normal(size=(E, 12, D)).astype(np.float32))
    dout = torch.from_numpy(np.random.default_rng(9).normal(size=(40, D)).astype(np.float32))
    dexp = torch.from_numpy(np.random.default_rng(10).normal(size=(E, 12, D)).astype(np.float32))
    disp = torch.from_numpy(np.asarray(_jax_disp(r)))

    def grads(fn, *ins):
        ins = [t.clone().requires_grad_(True) for t in ins]
        out = fn(*ins)
        return out, torch.autograd.grad(out, ins, dout if out.shape == dout.shape else dexp)

    got, (gx,) = grads(lambda a: md.MoEDispatch.apply(a, r), x)
    want, (wx,) = grads(lambda a: torch.einsum("sec,sd->ecd", disp.sum(1), a), x)
    assert torch.equal(got, want)
    _close(gx, wx.numpy(), tag="dispatch dx")
    got, (gy, gg) = grads(lambda a, g: md.MoECombine.apply(a, g, r), y, gate)
    want, (wy, wg) = grads(lambda a, g: torch.einsum(
        "sec,ecd->sd", (disp * g[..., None, None]).sum(1), a), y, gate)
    _close(got, want.detach().numpy(), tag="combine")
    _close(gy, wy.numpy(), tag="combine dy")
    _close(gg, wg.numpy(), tag="combine dgate")


def test_wrappers_refuse_other_devices():
    x, gate, r = _routing_case(4, 8, 8)
    meta = x.to("meta")
    for call in (lambda: md.moe_gather(meta, r), lambda: md.moe_combine(meta.reshape(1, 8, D), r),
                 lambda: md.moe_gate_grad(meta, meta, r)):
        with pytest.raises(ValueError, match="cpu or cuda"):
            call()


# ------------------------------------------------------------------ model


def _pair(seed=0, **over):
    jb = jbuild(jget_arch(ARCH).reduced(**over))
    jp = jb.init(jax.random.PRNGKey(seed))
    return jb, jp, tbuild(get_arch(ARCH).reduced(**over)), convert.params_from_numpy(_np(jp),
                                                                                     "cpu")


def test_config_and_params_cross_unchanged():
    import dataclasses
    assert dataclasses.asdict(get_arch(ARCH)) == dataclasses.asdict(jget_arch(ARCH))
    cfg = get_arch(ARCH)
    assert (cfg.arch_type, cfg.num_layers, cfg.d_model, cfg.num_experts, cfg.top_k) == (
        "moe", 24, 1024, 32, 8)
    jb, jp, tb, tp = _pair()
    moe = tp["layers"]["moe"]
    assert "mlp" not in tp["layers"]
    assert tuple(moe["wi"].shape) == (2, E, D, F_) and tuple(moe["wo"].shape) == (2, E, F_, D)
    assert tuple(moe["router"]["w"].shape) == (2, D, E)
    for name in ("wi", "wg", "wo"):
        np.testing.assert_array_equal(moe[name].numpy(), np.asarray(jp["layers"]["moe"][name]))
    got = tb.init(0, device="cpu")["layers"]["moe"]
    assert {k: tuple(v.shape) for k, v in got.items() if k != "router"} == {
        k: tuple(v.shape) for k, v in moe.items() if k != "router"}


@pytest.mark.parametrize("B,T", [(2, 21), (2, 2100)])
def test_forward_and_prefill_match_reference(B, T):
    """2 x 2100 = 4200 tokens: past serving's dropless limit of 4096, so the
    prefill and forward route with capacity (drops) in both packages."""
    jb, jp, tb, tp = _pair(seed=1)
    toks = _tokens(1, B, T)
    if T < 100:
        _close(tb.forward(tp, {"tokens": torch.from_numpy(toks)}),
               jb.forward(jp, {"tokens": jnp.asarray(toks)}), tag="forward")
    jl, jc = jb.prefill(jp, {"tokens": jnp.asarray(toks)}, jb.init_cache(B, T + 2))
    tl, tc = tb.prefill(tp, {"tokens": torch.from_numpy(toks)}, tb.init_cache(B, T + 2,
                                                                             device="cpu"))
    _close(tl, jl, tag="prefill logits")
    for k in ("k", "v"):
        _close(tc[k], jc[k], atol=1e-4, tag=f"prefill cache {k}")
    tok = _tokens(2, B, 1)
    jl, _ = jb.decode_step(jp, {"token": jnp.asarray(tok), "index": jnp.asarray(T, jnp.int32)},
                           jc)
    tl, _ = tb.decode_step(tp, {"token": torch.from_numpy(tok), "index": T}, tc)
    _close(tl, jl, tag="decode logits")


def _grads(tb, tp, batch):
    leaves = tree_leaves(tp)
    for t in leaves:
        t.requires_grad_(True)
    loss = tb.loss(tp, batch)
    return loss.detach(), torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("B,T,zero_router", [(1, 1088, False), (2, 3072, True)])
def test_loss_and_every_gradient_match_reference(B, T, zero_router):
    """``ce + 0.01 * aux`` and every gradient leaf against
    ``jax.value_and_grad(bundle.loss)``, under remat, at T > 1024 (the
    attention's blocked path). 2 x 3072 = 6144 tokens chunk in training
    (three chunks of 2048, the first divisor of S under 4096), and with an
    all-zero router every token ties and picks experts 0 and 1, so each
    chunk drops 768 of its 2048 choices of each: the gradients of ties and
    drops."""
    jb, jp, tb, tp = _pair(attn_block=128, remat=True)
    if zero_router:
        w = jp["layers"]["moe"]["router"]["w"]
        jp["layers"]["moe"]["router"]["w"] = jnp.zeros_like(w)
        tp["layers"]["moe"]["router"]["w"] = torch.zeros(tuple(w.shape))
    rng = np.random.default_rng(5 + B)
    batch = {k: rng.integers(0, 256, size=(B, T)).astype(np.int32)
             for k in ("tokens", "targets")}
    jl, jg = jax.value_and_grad(jb.loss)(jp, jax.tree.map(jnp.asarray, batch))
    tl, tg = _grads(tb, tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    jleaves = jax.tree.leaves(jg)
    assert len(jleaves) == len(tg)
    for i, (got, want) in enumerate(zip(tg, jleaves)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL,
                                   err_msg=f"gradient leaf {i}")


def test_loss_adds_the_aux_loss(monkeypatch):
    """The loss is the cross-entropy plus 0.01 times the layers' summed aux
    (the reference's ``ce + 0.01 * aux``), bit for bit."""
    from repro_torch.models import transformer as TT
    _, _, tb, tp = _pair()
    toks = torch.from_numpy(_tokens(6, 2, 24))
    rec = {"aux": [], "ce": []}
    block, xent = TM.moe_block, TT.chunked_xent

    def spy_block(*a, **kw):
        out = block(*a, **kw)
        rec["aux"].append(out[1])
        return out

    def spy_xent(*a, **kw):
        rec["ce"].append(xent(*a, **kw))
        return rec["ce"][-1]

    monkeypatch.setattr(TT.MOE, "moe_block", spy_block)
    monkeypatch.setattr(TT, "chunked_xent", spy_xent)
    loss = tb.loss(tp, {"tokens": toks, "targets": toks})
    assert len(rec["aux"]) == 2 and len(rec["ce"]) == 1
    assert all(float(a) > 0 for a in rec["aux"])
    assert torch.equal(loss, rec["ce"][0] + 0.01 * (rec["aux"][0] + rec["aux"][1]))


def test_remat_on_equals_off():
    """Non-reentrant checkpoint recomputes the routing, the dispatch and the
    combine alike: loss and gradients bit for bit, drops included."""
    _, _, tb_on, tp = _pair(remat=True)
    tb_off = tbuild(get_arch(ARCH).reduced(remat=False))
    rng = np.random.default_rng(6)
    batch = {k: torch.from_numpy(rng.integers(0, 256, size=(2, 40)).astype(np.int32))
             for k in ("tokens", "targets")}
    l_on, g_on = _grads(tb_on, tp, batch)
    l_off, g_off = _grads(tb_off, tp, batch)
    assert torch.equal(l_on, l_off)
    assert all(torch.equal(a, b) for a, b in zip(g_on, g_off))


def test_serve_and_train_clis(capsys):
    from repro_torch.launch import serve, train
    serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
                "--prompt-len", "9", "--gen", "3"])
    assert f"arch={ARCH} device=cpu generated (2, 3)" in capsys.readouterr().out
    train.main(["--arch", ARCH, "--smoke", "--rounds", "2", "--device", "cpu", "--seq", "32",
                "--shards", "2"])
    out = capsys.readouterr().out
    assert f"[train] arch={ARCH}" in out and "device=cpu" in out
    losses = [float(line.split()[3]) for line in out.splitlines() if line.startswith("round ")]
    assert len(losses) == 2 and all(np.isfinite(losses))


def test_bf16_block_departs_from_reference_by_silu_rounding():
    """In bfloat16 (the full-width dtype) on the same inputs and params the
    port's block routes exactly as the reference. With the reference's SiLU
    values put in place of ``F.silu``'s, every output lies within one bf16
    ulp of its own magnitude and under 0.1% differ at all (the bf16
    products' float32 sums in another order). ``F.silu`` rounds once from
    float32 where XLA's bf16 SiLU does not (about 39% of bf16 inputs differ,
    as in the dense SwiGLU); through the down projection that moves the
    outputs by up to two bf16 ulps of the largest output, and under 1% in
    rms (seen: 2 ulps and 0.48%). Two layers carry it to the logits as the
    dense archs' bf16 tests describe (ROADMAP queue 3)."""
    import torch.nn.functional as F
    bf = jnp.bfloat16
    p = _moe_params(21)
    pj = jax.tree.map(lambda a: jnp.asarray(a).astype(bf), p)

    def to_t(a):
        return torch.from_numpy(np.array(a.astype(jnp.float32))).bfloat16()

    tp = {k: ({kk: to_t(vv) for kk, vv in v.items()} if isinstance(v, dict) else to_t(v))
          for k, v in pj.items()}
    xj = jnp.asarray(_x(22, 2, 40)).astype(bf)
    xt = to_t(xj)
    want, want_aux = JM.moe_block(pj, xj, num_experts=E, top_k=K)
    want = np.asarray(want.astype(jnp.float32))
    cap = TM.capacity_of(80, num_experts=E, top_k=K)
    jprobs, jidx, jpos, jkeep = _jax_route(pj, xj.reshape(80, D), cap)
    tprobs, gate, r = TM.route(tp, xt.reshape(80, D), num_experts=E, top_k=K, capacity=cap)
    _same_routing(tprobs.numpy(), r, jprobs, jidx, jpos, jkeep, "bf16")

    def ulp(a):
        return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(a), 2.0 ** -126))) - 7)

    def rms(a):
        return float(np.sqrt(np.mean(np.square(a))))

    ein = md.moe_gather(xt.reshape(80, D), r)
    h = torch.bmm(ein, tp["wg"])
    ref_silu = to_t(jax.nn.silu(jnp.asarray(h.float().numpy()).astype(bf)))
    got = md.moe_combine(torch.bmm(ref_silu * torch.bmm(ein, tp["wi"]), tp["wo"]), r,
                         gate.to(torch.bfloat16)).float().numpy().reshape(want.shape)
    assert (np.abs(got - want) <= ulp(want)).all() and np.mean(got != want) < 1e-3
    out, got_aux = TM.moe_block(tp, xt, num_experts=E, top_k=K)
    out = out.float().numpy()
    assert np.abs(out - want).max() <= 2 * ulp(np.abs(want).max())
    assert rms(out - want) <= 0.01 * rms(want)
    assert np.mean(F.silu(h).float().numpy() != ref_silu.float().numpy()) > 0.1
    np.testing.assert_allclose(got_aux.item(), float(want_aux), rtol=1e-5)
