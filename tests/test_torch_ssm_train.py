"""Training the ssm family (rwkv6) on the port, against the JAX package and
against the recurrence's own definition, on the CPU.

* the scan's backward: ``rwkv6_scan_bwd_ref`` (the arithmetic of
  ``csrc/rwkv6_scan_bwd.cu``) against autograd through the plain forward
  ``rwkv6_chunked_ref``, all six gradients, over chunk sizes, ragged T, a
  nonzero final-state gradient and initial state; both against a float64
  sequential oracle of the gradients' definition, strong decays included
  (ROADMAP queue 3 item 7); ``RWKV6Scan`` (the autograd Function the card
  trains through) on CPU tensors against autograd, with bf16 inputs;
* the 3xTF32 split of the backward kernel's tensor-core products, replayed
  on the bits, against float64: within float32 accuracy, where one TF32
  product and a bf16 hi/lo split are not;
* the time mix against ``jax.vjp`` of the reference's ``_rwkv6_chunked``:
  every leaf, x, x_prev and the state;
* the reduced rwkv6's loss and every gradient against
  ``jax.value_and_grad`` of the reference's ``loss`` (remat on, T over
  several chunks with a ragged tail); remat on == off;
* one sharded round (2 x 2 clients, E = H = A = 2) against the reference's
  ``build(spec, bundle.loss)`` on the tree and flat layouts; a bf16
  reduced rwkv6, whose flat state has two dtype buffers (bf16 and the
  float32 ``u``/``decay_base``); the trainer's CLI.

Tolerances: the scan's gradients within 5e-6 of each gradient's largest
entry against the float64 oracle and against autograd (float32 sums in
another order; seen: 3e-7), dlogw within 2e-5 (``DLOGW_FRAC``); autograd
of the reference's chunk form within 1e-4 of the largest entry at strong
decays, where its chunk-wide sums lose about an ulp of |cum| (seen: 3e-5);
the time mix, the loss and its
gradients rtol 1e-4 / atol 1e-5 (products and norms reorder sums); the LM
round as ``test_torch_lm_train.py``'s: rtol 1e-4, atol 1e-5 on params and
that atol through 1 / (H lr) for z and 1 / (H E lr) for y (ROADMAP queue 3
item 2).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import api as japi  # noqa: E402
from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.core import driver as jdriver  # noqa: E402
from repro.data import lm as jlm  # noqa: E402
from repro.models import rwkv6 as jrwkv  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import api as tapi  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core.packer import is_flat  # noqa: E402
from repro_torch.core.tree import tree_leaves, tree_map  # noqa: E402
from repro_torch.kernels import rwkv6_scan as rs  # noqa: E402
from repro_torch.models import rwkv6 as trwkv  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

GRADS = ("dr", "dk", "dv", "dlogw", "du", "dstate")
# dlogw is a per-chunk suffix sum of (r dr')[t + 1] - (k dk')[t]: at strong
# decays the two nearly cancel token by token, leaving a dlogw far smaller
# than its terms, so its error is the terms' rounding over up to C tokens
# (seen: 5.1e-6 of the largest dlogw at logw down to -20, C = 64).
DLOGW_FRAC = 2e-5


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """One intra-op thread: the suite runs files in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# ------------------------------------------------------ the scan's backward


def _scan_case(B, T, H, Dh, decay, seed):
    """float64 numpy inputs [B, T, H, Dh] (u [H, Dh], states [B, H, Dh, Dh])
    and an output gradient do and final-state gradient."""
    rng = np.random.default_rng(seed)
    r, k, v, do, x = (rng.normal(size=(B, T, H, Dh)) for _ in range(5))
    logw = {"model": -np.exp(-1.0 + np.tanh(x)), "abs": -np.abs(x),
            "strong": -20.0 * rng.uniform(size=x.shape)}[decay]
    u = rng.normal(size=(H, Dh))
    s0, d_final = rng.normal(size=(B, H, Dh, Dh)), rng.normal(size=(B, H, Dh, Dh))
    return r, k, v, logw, u, s0, do, d_final


def _oracle(r, k, v, logw, u, s0, do, d_final):
    """The gradients' definition, token by token in float64: with G_t the
    gradient of the state after token t (G_T = d_final,
    G_{t-1} = r_t do_t^T + diag(w_t) G_t), dr_t = S_{t-1} do_t +
    (u k_t)(v_t . do_t), dk_t = G_t v_t + (u r_t)(v_t . do_t),
    dv_t = G_t^T k_t + (r_t . u k_t) do_t, dlogw_t = w_t sum_j S_{t-1} G_t,
    du = sum (r k)(v . do), dstate = G_0."""
    B, T, H, Dh = r.shape
    dr, dk, dv, dlogw = (np.zeros_like(r) for _ in range(4))
    du, dstate = np.zeros((H, Dh)), np.zeros((B, H, Dh, Dh))
    for b in range(B):
        for h in range(H):
            S, before = s0[b, h].copy(), []
            for t in range(T):
                before.append(S)
                S = np.exp(logw[b, t, h])[:, None] * S + np.outer(k[b, t, h], v[b, t, h])
            G = d_final[b, h].copy()
            for t in reversed(range(T)):
                rt, kt, vt, dot = r[b, t, h], k[b, t, h], v[b, t, h], do[b, t, h]
                wt, vd = np.exp(logw[b, t, h]), vt @ dot
                dr[b, t, h] = before[t] @ dot + u[h] * kt * vd
                dk[b, t, h] = G @ vt + u[h] * rt * vd
                dv[b, t, h] = G.T @ kt + (rt @ (u[h] * kt)) * dot
                dlogw[b, t, h] = wt * (before[t] * G).sum(1)
                du[h] += rt * kt * vd
                G = np.outer(rt, dot) + wt[:, None] * G
            dstate[b, h] = G
    return dr, dk, dv, dlogw, du, dstate


def _f32(*arrays):
    return [torch.tensor(a, dtype=torch.float32) for a in arrays]


def _autograd(r, k, v, logw, u, s0, do, d_final, C):
    """The six gradients by autograd through the plain forward."""
    ins = [t.clone().requires_grad_() for t in (r, k, v, logw, u, s0)]
    o, s = rs.rwkv6_chunked_ref(*ins, chunk=C)
    return torch.autograd.grad((o * do).sum() + (s * d_final).sum(), ins)


def _close(got, want, frac, what, names=GRADS):
    """Each gradient within ``frac`` of its largest entry; dlogw within
    ``DLOGW_FRAC`` when ``frac`` is the scan's 5e-6."""
    for name, g, w in zip(names, got, want):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        assert g.shape == w.shape, (what, name)
        f = DLOGW_FRAC if (name == "dlogw" and frac == 5e-6) else frac
        err, scale = np.abs(g - w).max(), np.abs(w).max()
        assert err <= f * scale, f"{what} {name}: {err:.3g} > {f} x {scale:.3g}"


_BWD_CASES = [(2, 37, 2, 8, 16, 8), (1, 64, 2, 16, 64, 16), (2, 45, 1, 8, 20, 16),
              (1, 7, 1, 4, 64, 16), (1, 100, 2, 6, 32, 16), (2, 24, 1, 8, 4, 16)]


@pytest.mark.parametrize("B,T,H,Dh,C,sub", _BWD_CASES)
def test_scan_bwd_ref_matches_autograd(B, T, H, Dh, C, sub):
    """Ragged T, chunks that are and are not sub-chunk multiples, T shorter
    than a chunk, a nonzero initial state and final-state gradient."""
    args = _f32(*_scan_case(B, T, H, Dh, "model", seed=T + C))
    got = rs.rwkv6_scan_bwd_ref(*args, chunk=C, sub=sub)
    want = _autograd(*args, C)
    _close([g.numpy() for g in got], [w.numpy() for w in want], 5e-6, "ref vs autograd")


@pytest.mark.parametrize("decay", ["model", "abs", "strong"])
@pytest.mark.parametrize("C", [16, 64])
def test_scan_bwd_against_sequential_oracle(decay, C):
    """Both the kernel's arithmetic and autograd of the plain chunk form
    against the float64 definition. At strong decays (logw down to -20) the
    kernel's arithmetic holds 5e-6; the chunk form's finite gradients hold
    1e-4 (its chunk-wide sums lose about an ulp of |cum|), and its dlogw is
    not finite: ``where(tri, exp(cum_ex[t] - cum[i]), 0)`` overflows above
    the diagonal, and the where keeps the inf out of the value but not out
    of the gradient (inf * 0). The reference's ``chunk_fn`` has the same
    form, so ``jax.vjp`` of it is not finite there either (ROADMAP queue 3)."""
    case = _scan_case(2, 2 * C + 9, 2, 8, decay, seed=C + len(decay))
    want = _oracle(*case)
    args = _f32(*case)
    _close([g.numpy() for g in rs.rwkv6_scan_bwd_ref(*args, chunk=C)], want, 5e-6,
           f"ref ({decay})")
    auto = [g.numpy() for g in _autograd(*args, C)]
    if decay == "strong":
        assert not np.isfinite(auto[3]).all()
        _close(auto[:3] + auto[4:], want[:3] + want[4:], 1e-4, "autograd (strong)",
               names=GRADS[:3] + GRADS[4:])
    else:
        _close(auto, want, 5e-6, f"autograd ({decay})")


def _tf32_rna(x):
    """x (float32) rounded to TF32 as ``cvt.rna.tf32.f32`` does, on the
    bits: 10 mantissa bits, to nearest, ties away from zero."""
    b = x.contiguous().view(torch.int32)
    mag = ((b & 0x7FFFFFFF) + 0x1000) & 0x7FFFE000
    return ((b & -0x80000000) | mag).view(torch.float32)


def _split_product(a, b, how):
    """a @ b in float32 the way a kernel on the tensor cores would take it:
    ``tf32x3`` the backward kernel's split (csrc/tf32_mma.cuh: hi = tf32(x),
    lo = tf32(x - hi), a_lo b_hi + a_hi b_lo + a_hi b_hi), ``tf32`` one
    TF32 product, ``bf16x3`` the same three products of a bf16 hi/lo split
    (the attention backward's, csrc/flash_attention_bwd.cu)."""
    if how == "tf32":
        return _tf32_rna(a) @ _tf32_rna(b)
    rnd = _tf32_rna if how == "tf32x3" else (lambda x: x.bfloat16().float())
    ah, bh = rnd(a), rnd(b)
    al, bl = rnd(a - ah), rnd(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def test_3xtf32_split_holds_float32_accuracy():
    """Why the scan backward's products split as they do: [64, 64] x
    [64, 64] products at the scan's magnitudes (do against a chunk state,
    decay-scaled r against do, decay-scaled k against a state), float32
    sums, against float64. The 3xTF32 split stays within 1e-6 of the
    largest entry (as a float32 product does); one TF32 product and the bf16
    hi/lo split miss the kernel's 5e-6 contract."""
    worst = {}
    for seed in range(8):
        rng = np.random.default_rng(seed)
        r, k, v, do, x = _f32(*(rng.normal(size=(1, 192, 2, 64)) for _ in range(5)))
        logw = -torch.exp(-1.0 + torch.tanh(x))
        _, S = rs.rwkv6_chunked_ref(r, k, v, logw, torch.zeros(2, 64),
                                    torch.zeros(1, 2, 64, 64), chunk=64)
        cum = torch.cumsum(logw[0, :64, 0], 0)
        rx = r[0, :64, 0] * torch.exp(cum - logw[0, :64, 0])
        kq = k[0, :64, 0] * torch.exp(cum[-1] - cum)
        d_o = do[0, :64, 0]
        for a, b in ((d_o, S[0, 0].T), (rx.T, d_o), (kq, S[0, 1]), (d_o, S[0, 1].T)):
            a, b = a.contiguous(), b.contiguous()
            want = a.double() @ b.double()
            for how in ("tf32x3", "tf32", "bf16x3"):
                err = ((_split_product(a, b, how).double() - want).abs().max()
                       / want.abs().max()).item()
                worst[how] = max(worst.get(how, 0.0), err)
    assert worst["tf32x3"] < 1e-6, worst
    assert worst["tf32"] > 5e-6 and worst["bf16x3"] > 5e-6, worst


def test_chunk_form_gradient_overflows_when_decays_grow():
    """The reference's time mix (and the port's plain version, the same
    form) loses its decay gradients once ``decay_base`` has grown to 1.0:
    within a chunk of 64 the masked ``exp(cum_ex[t] - cum[i])`` overflows
    above the diagonal (ROADMAP queue 3 item 15). At the initial -1.0 both
    are finite (their agreement: ``test_time_mix_matches_reference_vjp``)."""
    import jax.random as jr
    D, Hn, C, T = 64, 2, 64, 128
    p = jrwkv.init_rwkv6(jr.PRNGKey(0), D, Hn, jnp.float32)
    x = np.random.default_rng(0).normal(size=(1, T, D)).astype(np.float32)
    xp, st = np.zeros((1, D), np.float32), np.zeros((1, Hn, D // Hn, D // Hn), np.float32)
    for base, finite in ((-1.0, True), (1.0, False)):
        q = dict(p, decay_base=jnp.full((D,), base))
        jg = jax.grad(lambda q_: jrwkv._rwkv6_chunked(q_, jnp.asarray(x), jnp.asarray(xp),
                                                       jnp.asarray(st), n_heads=Hn,
                                                       chunk=C)[0].sum())(q)
        tp = convert.params_from_numpy(_np(q), "cpu")
        tp["decay_base"].requires_grad_(True)
        out = trwkv.rwkv6_chunked(tp, torch.tensor(x), torch.tensor(xp), torch.tensor(st),
                                  n_heads=Hn, chunk=C)[0].sum()
        tg = torch.autograd.grad(out, tp["decay_base"])[0].numpy()
        for g in (np.asarray(jg["decay_base"]), tg):
            assert bool(np.isfinite(g).all()) == finite, base


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scan_function_matches_autograd(dtype):
    """``RWKV6Scan`` on CPU tensors (the plain forward and
    ``rwkv6_scan_bwd_ref``): the model's layout, gradients in each input's
    dtype, the final state unused (its gradient None) and used."""
    r, k, v, logw, u, s0, do, d_final = _f32(*_scan_case(2, 45, 2, 8, "model", seed=3))
    r, k, v = (a.to(dtype) for a in (r, k, v))
    for use_state in (False, True):
        ins = [t.clone().requires_grad_() for t in (r, k, v, logw, u, s0)]
        o, s = rs.RWKV6Scan.apply(*ins, 16)
        loss = (o * do).sum() + ((s * d_final).sum() if use_state else 0.0)
        got = torch.autograd.grad(loss, ins)
        ref_ins = [t.clone().requires_grad_() for t in (r, k, v, logw, u, s0)]
        o2, s2 = rs.rwkv6_chunked_ref(*ref_ins, chunk=16)
        want = torch.autograd.grad((o2 * do).sum() + ((s2 * d_final).sum() if use_state
                                                      else 0.0), ref_ins)
        assert torch.equal(o, o2) and torch.equal(s, s2)
        for g, w, x in zip(got, want, ins):
            assert g.dtype == x.dtype
        # bf16 gradients: each rounds its own float32 value, which the two
        # backward forms give to float32 rounding.
        frac = 5e-6 if dtype == torch.float32 else 2 ** -8
        _close([g.float().numpy() for g in got], [w.float().numpy() for w in want], frac,
               f"RWKV6Scan {dtype} state={use_state}")


def test_scan_bwd_wrapper_takes_the_plain_version_on_cpu():
    args = _f32(*_scan_case(1, 20, 1, 8, "model", seed=4))
    before = rs.rwkv6_scan_bwd.launches
    got = rs.rwkv6_scan_bwd(*args[:7], None, chunk=8)
    want = rs.rwkv6_scan_bwd_ref(*args[:7], None, chunk=8)
    assert rs.rwkv6_scan_bwd.launches == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    rs.rwkv6_scan_bwd.launches = 3
    rs.reset_launch_counts()
    assert rs.rwkv6_scan_bwd.launches == 0 and rs.rwkv6_scan.launches == 0


# ------------------------------------------------------------ the time mix


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _paths(tree[k], f"{prefix}/{k}")
        return out
    return [(prefix, tree)]


@pytest.mark.parametrize("T,C", [(29, 8), (64, 16)])
def test_time_mix_matches_reference_vjp(T, C):
    """Every leaf of the time mix, x, x_prev and the state, against
    ``jax.vjp`` of the reference's ``_rwkv6_chunked`` (the out, last x and
    state cotangents all nonzero)."""
    import jax.random as jr
    D, Hn = 32, 4
    p = jrwkv.init_rwkv6(jr.PRNGKey(1), D, Hn, jnp.float32)
    rng = np.random.default_rng(T)
    x, xp = rng.normal(size=(2, T, D)), rng.normal(size=(2, D))
    st = rng.normal(size=(2, Hn, D // Hn, D // Hn))
    cot = [rng.normal(size=(2, T, D)), rng.normal(size=(2, D)),
           rng.normal(size=(2, Hn, D // Hn, D // Hn))]
    x, xp, st, *cot = (a.astype(np.float32) for a in (x, xp, st, *cot))

    def jfn(p_, x_, xp_, st_):
        return jrwkv._rwkv6_chunked(p_, x_, xp_, st_, n_heads=Hn, chunk=C)

    _, vjp = jax.vjp(jfn, p, jnp.asarray(x), jnp.asarray(xp), jnp.asarray(st))
    jp, jx, jxp, jst = vjp(tuple(jnp.asarray(c) for c in cot))
    tp = convert.params_from_numpy(_np(p), "cpu")
    names, leaves = zip(*_paths(tp))
    ins = [torch.tensor(a).requires_grad_() for a in (x, xp, st)]
    for t in leaves:
        t.requires_grad_(True)
    out = trwkv.rwkv6_chunked(tp, *ins, n_heads=Hn, chunk=C)
    loss = sum((o * torch.tensor(c)).sum() for o, c in zip(out, cot))
    grads = torch.autograd.grad(loss, list(leaves) + ins)
    want = [np.asarray(w) for _, w in _paths(jp)] + [np.asarray(a) for a in (jx, jxp, jst)]
    names = list(names) + ["x", "x_prev", "state"]
    for name, g, w in zip(names, grads, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-5, err_msg=name)


# ------------------------------------------------------------- LM loss


def _pair(**over):
    jcfg = jget_arch("rwkv6-1.6b").reduced(**over)
    jb = JT.build_model(jcfg)
    jp = jb.init(jax.random.PRNGKey(0))
    tb = TT.build_model(tconfigs.get_arch("rwkv6-1.6b").reduced(**over))
    return jb, jp, tb, convert.params_from_numpy(_np(jp), "cpu")


def _grads(tb, tp, batch):
    leaves = tree_leaves(tp)
    for t in leaves:
        t.requires_grad_(True)
    loss = tb.loss(tp, batch)
    return loss.detach(), torch.autograd.grad(loss, leaves)


def test_loss_and_every_gradient_match_reference():
    """Remat on, chunk 16, T = 200: twelve full chunks and a ragged tail."""
    jb, jp, tb, tp = _pair(remat=True, rwkv_chunk=16)
    rng = np.random.default_rng(11)
    batch = {k: rng.integers(0, 256, size=(2, 200)).astype(np.int32)
             for k in ("tokens", "targets")}
    jl, jg = jax.value_and_grad(jb.loss)(jp, jax.tree.map(jnp.asarray, batch))
    tl, tg = _grads(tb, tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    jleaves = jax.tree.leaves(jg)
    assert len(jleaves) == len(tg)
    for i, (got, want) in enumerate(zip(tg, jleaves)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5,
                                   err_msg=f"gradient leaf {i}")


def test_remat_on_equals_off():
    _, _, tb_on, tp = _pair(remat=True, rwkv_chunk=8)
    tb_off = TT.build_model(tconfigs.get_arch("rwkv6-1.6b").reduced(remat=False, rwkv_chunk=8))
    rng = np.random.default_rng(12)
    batch = {k: torch.from_numpy(rng.integers(0, 256, size=(2, 37)).astype(np.int32))
             for k in ("tokens", "targets")}
    l_on, g_on = _grads(tb_on, tp, batch)
    l_off, g_off = _grads(tb_off, tp, batch)
    assert torch.equal(l_on, l_off)
    for a, b in zip(g_on, g_off):
        assert torch.equal(a, b)


# ------------------------------------------------------------- one LM round


def _select(pk, sid, G, K):
    """The reference's on-device round selection with fixed shard ids."""
    E, H, A = pk.group_rounds, pk.local_steps, pk.microbatches
    P = G * K

    def gather(leaf):
        flat = leaf.reshape((P,) + leaf.shape[2:])
        sel = flat[jnp.arange(P)[None, :], sid.reshape(E, P)]
        sel = jnp.moveaxis(sel, 2, 1)
        sel = sel.reshape(sel.shape[:2] + (G, K) + sel.shape[3:])
        return sel.reshape((E, H, A) + sel.shape[2:])

    return jax.tree.map(gather, pk.arrays)


def _round_batch(G, K, E, H, A, seq, seed):
    rng = np.random.default_rng(seed)
    toks, _ = jlm.make_lm_tokens(rng, 256, 20_000)
    pk = jdriver.pack_lm_shards(toks, num_groups=G, clients_per_group=K, group_rounds=E,
                                local_steps=H, batch_size=1, seq_len=seq, shards=2,
                                microbatches=A, rng=np.random.default_rng(seed + 1),
                                key=jax.random.PRNGKey(0))
    sid = jax.random.randint(jax.random.PRNGKey(1), (E, G, K), 0, 2)
    return _select(pk, sid, G, K)


@pytest.mark.parametrize("layout", ["tree", "flat"])
def test_sharded_lm_round_matches_reference(layout):
    """Reduced rwkv6 (float32, remat, chunk 16), 2 x 2 clients,
    E = H = A = 2, seq 40 (two full chunks and a ragged one), fused: one
    round through both packages' build/round_fn from the same params and
    batches."""
    G, K, E, H, A, lr = 2, 2, 2, 2, 2, 0.05
    jb, jp, tb, tp = _pair(remat=True, rwkv_chunk=16)
    jbatch = _round_batch(G, K, E, H, A, 40, seed=21)
    kw = dict(levels=(G, K), backend="sharded", lr=lr, state_layout=layout, fusion="fused")
    jspec = japi.ExperimentSpec(schedule=japi.RoundSchedule(
        group_rounds=E, local_steps=H, microbatches=A), fused_mode="interpret", **kw)
    tspec = tapi.ExperimentSpec(schedule=tapi.RoundSchedule(
        group_rounds=E, local_steps=H, microbatches=A), **kw)
    jeng, teng = japi.build(jspec, jb.loss), tapi.build(tspec, tb.loss, device="cpu")
    js, jm = jeng.round_fn(jeng.init(jp), jbatch)
    ts, tm = teng.round_fn(teng.init(tp), {k: torch.from_numpy(np.asarray(v))
                                          for k, v in jbatch.items()})
    np.testing.assert_allclose(tm.loss.numpy(), np.asarray(jm.loss), rtol=1e-5)
    assert np.isfinite(tm.loss.numpy()).all()
    for name, atol in (("params", 1e-5), ("z", 1e-5 / (H * lr)), ("y", 1e-5 / (H * E * lr))):
        got, want = getattr(ts, name), getattr(js, name)
        if layout == "flat":
            got, want = got.to_tree(), want.to_tree()
        got, want = convert.to_numpy(got), _np(want)
        for (path, g), w in zip(_paths(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=atol, err_msg=f"{name}/{path}")


def _bf16_round(layout, fusion, tb, params, batch):
    spec = tapi.ExperimentSpec(levels=(2, 2), backend="sharded", lr=0.05, state_layout=layout,
                               fusion=fusion, schedule=tapi.RoundSchedule(
                                   group_rounds=2, local_steps=2, microbatches=2))
    eng = tapi.build(spec, tb.loss, device="cpu")
    state = eng.init(tree_map(torch.clone, params))
    state, met = eng.round_fn(state, batch)
    fields = {name: getattr(state, name) for name in ("params", "z", "y")}
    if is_flat(state.params):
        assert sorted(state.params.bufs) == ["bfloat16", "float32"]
        fields = {name: f.to_tree() for name, f in fields.items()}
    return fields, met


def test_bf16_two_buffer_flat_state():
    """A reduced rwkv6 in bf16: its ``u`` and ``decay_base`` stay float32, so
    the flat state packs two buffers per field (bf16 and float32, the latter
    L * (H * Dh + D) elements a replica) and every walk over the buffers --
    the fused step (one launch per buffer on the card), the column pieces,
    the z/y updates, the norms -- sees both. Flat + fused equals tree +
    fused bit for bit (the same element-wise arithmetic per buffer as per
    leaf). Fused equals unfused bit for bit in float32 on the tree layout,
    where both evaluate ((g / A + z) + y) in one order; in bf16 the unfused
    step rounds after each operation and the fused one once, so the two are
    different roundings and are not compared."""
    tb = TT.build_model(tconfigs.get_arch("rwkv6-1.6b").reduced(
        remat=True, rwkv_chunk=16, param_dtype="bfloat16", compute_dtype="bfloat16"))
    params = tb.init(0, device="cpu")
    cfg = tb.cfg
    n32 = sum(t.numel() for t in tree_leaves(params) if t.dtype == torch.float32)
    assert n32 == cfg.num_layers * (cfg.d_model + cfg.d_model)
    batch = {k: torch.from_numpy(np.asarray(v))
             for k, v in _round_batch(2, 2, 2, 2, 2, 40, seed=31).items()}
    flat, m_flat = _bf16_round("flat", "fused", tb, params, batch)
    tree, m_tree = _bf16_round("tree", "fused", tb, params, batch)
    assert torch.equal(m_flat.loss, m_tree.loss)
    assert np.isfinite(m_flat.loss.numpy()).all()
    for name in ("params", "z", "y"):
        for (path, a), (_, b) in zip(_paths(flat[name]), _paths(tree[name])):
            assert a.dtype == b.dtype and torch.equal(a, b), f"flat vs tree {name}{path}"
    tb32 = TT.build_model(tconfigs.get_arch("rwkv6-1.6b").reduced(remat=True, rwkv_chunk=16))
    p32 = tb32.init(0, device="cpu")
    fused32, _ = _bf16_round("tree", "fused", tb32, p32, batch)
    unfused32, _ = _bf16_round("tree", "none", tb32, p32, batch)
    for name in ("params", "z", "y"):
        for (path, a), (_, b) in zip(_paths(fused32[name]), _paths(unfused32[name])):
            assert torch.equal(a, b), f"float32 fused vs unfused {name}{path}"


def test_two_buffer_flat_round_in_pieces(monkeypatch):
    """The bf16 two-buffer flat round worked in column pieces of 1000
    (``train._CHUNK`` patched: the bf16 buffer's 493,952 columns in 494
    pieces, the float32 buffer's 512 in one) gives the one-piece round's
    state bit for bit: every walk over a buffer -- means, z/y updates,
    dissemination -- covers both buffers whole."""
    from repro_torch.launch import train
    tb = TT.build_model(tconfigs.get_arch("rwkv6-1.6b").reduced(
        remat=True, rwkv_chunk=16, param_dtype="bfloat16", compute_dtype="bfloat16"))
    params = tb.init(0, device="cpu")
    batch = {k: torch.from_numpy(np.asarray(v))
             for k, v in _round_batch(2, 2, 2, 2, 2, 40, seed=32).items()}
    whole, m_whole = _bf16_round("flat", "fused", tb, params, batch)
    monkeypatch.setattr(train, "_CHUNK", 1000)
    pieces, m_pieces = _bf16_round("flat", "fused", tb, params, batch)
    assert torch.equal(m_whole.loss, m_pieces.loss)
    for name in ("params", "z", "y"):
        for (path, a), (_, b) in zip(_paths(whole[name]), _paths(pieces[name])):
            assert torch.equal(a, b), f"{name}{path}"


def test_train_cli_smoke(capsys):
    from repro_torch.launch import train
    train.main(["--arch", "rwkv6-1.6b", "--smoke", "--rounds", "2", "--device", "cpu",
                "--seq", "32", "--shards", "2", "--state-layout", "flat"])
    out = capsys.readouterr().out
    assert "[train] arch=rwkv6-1.6b" in out and "device=cpu" in out
    losses = [float(line.split()[3]) for line in out.splitlines() if line.startswith("round ")]
    assert len(losses) == 2 and all(np.isfinite(losses))
