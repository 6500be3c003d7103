"""Training the hybrid family (hymba) on the port, against the JAX package and
against the selective scan's own definition, on the CPU.

* the scan's backward: ``selective_scan_bwd_ref`` (the arithmetic of
  ``csrc/ssm_scan_bwd.cu``) against torch autograd through the plain
  forward ``selective_scan_ref``, and both against a float64 reverse
  recurrence of the gradients' definition, over ragged T, Di not a multiple
  of a block's 32 chains, S = 5 and 16, one token, nonzero initial states,
  a final state's gradient, strong and weak decays;
* ``SelectiveScan`` (the autograd Function the card trains through) on CPU
  tensors against ``jax.vjp`` of the reference's scan (its gates' decay and
  drive and its chunked ``associative_scan``, copied from
  ``repro.models.ssm.ssm_parallel``), u in float32 and in bfloat16, with and
  without the final state's gradient; ``ssm_parallel`` under autograd
  against ``jax.vjp`` of the reference's;
* the reduced hymba's loss and every gradient against
  ``jax.value_and_grad`` of the reference's ``loss``
  (``test_torch_lm_train.py::test_loss_and_every_gradient_match_reference``
  takes hymba at T = 1088, the windowed flash path); remat on == off;
* one sharded round (2 x 2 clients, E = H = A = 2) against the reference's
  ``build(spec, bundle.loss)`` on the tree and flat layouts; the trainer's
  CLI.

Tolerances (ROADMAP queue 3 item 17). The scan's gradients: within 1e-5 of
each gradient's largest entry, against autograd and against float64 (float32
sums of the same terms in another order; seen: under 3e-7); a gradient that
sums over channels or tokens (dB, dC over Di; dlog_a, dd_skip over (b, t))
within 1e-5 of the largest sum of its terms' magnitudes, since its terms
cancel and its rounding follows their size, not the sum's. Against the
reference's associative scan rtol 1e-4 with an atol of 1e-5 of the largest
entry (the scan multiplies decays in a tree; the SSM's magnitudes run to
about 50 where the LM's stay near 4), the sums' atol again from their terms'
magnitudes. The loss and its gradients, the LM round: as
``test_torch_lm_train.py`` holds them (rtol 1e-4 / atol 1e-5; z and y's atol
through 1 / (H lr) and 1 / (H E lr), ROADMAP queue 3 item 2).
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
from repro.models import ssm as JS  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import api as tapi  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core.tree import tree_leaves  # noqa: E402
from repro_torch.kernels import ssm_scan as ss  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

GRADS = ("du", "ddt", "dB", "dC", "dlog_a", "dd_skip", "dstate0")
SUMS = ("dB", "dC", "dlog_a", "dd_skip")
FRAC = 1e-5


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


def _case(B, T, Di, S, d_final, shift, seed):
    """Operands as hymba's gates make them (float32 numpy), a nonzero state,
    the cotangents dy and (optionally) d_final."""
    rng = np.random.default_rng(seed)

    def normal(*shape):
        return rng.normal(size=shape).astype(np.float32)

    x = normal(B, T, Di)
    u = (x / (1.0 + np.exp(-x))).astype(np.float32)
    dt = np.log1p(np.exp(normal(B, T, Di) + shift)).astype(np.float32)
    Bm, Cm = normal(B, T, S), normal(B, T, S)
    log_a = (np.log(np.linspace(1.0, S, S, dtype=np.float32))[None]
             + 0.2 * normal(Di, S)).astype(np.float32)
    d_skip = (1.0 + 0.1 * normal(Di)).astype(np.float32)
    s0 = 0.5 * normal(B, Di, S)
    dy = normal(B, T, Di)
    dfin = normal(B, Di, S) if d_final else None
    return (u, dt, Bm, Cm, log_a, d_skip, s0), dy, dfin


def _oracle(args, dy, dfin):
    """The gradients' definition in float64, a reverse recurrence token by
    token: (grads by name, each summed gradient's sum of its terms'
    magnitudes)."""
    u, dt, Bm, Cm, log_a, d_skip, s0 = (np.asarray(a, np.float64) for a in args)
    dy = np.asarray(dy, np.float64)
    A = -np.exp(log_a)
    hs = [s0]
    for t in range(u.shape[1]):
        hs.append(np.exp(dt[:, t, :, None] * A) * hs[-1]
                  + (dt[:, t] * u[:, t])[:, :, None] * Bm[:, t, None])
    g_next = np.zeros_like(s0) if dfin is None else np.asarray(dfin, np.float64)
    out = {n: np.zeros(a.shape) for n, a in zip(GRADS, (u, dt, Bm, Cm, log_a, d_skip, s0))}
    mag = {n: np.zeros_like(out[n]) for n in SUMS}
    for t in range(u.shape[1] - 1, -1, -1):
        dec = np.exp(dt[:, t, :, None] * A)
        g = Cm[:, t, None] * dy[:, t, :, None] + g_next
        dtu = dt[:, t] * u[:, t]
        out["du"][:, t] = (g * Bm[:, t, None]).sum(-1) * dt[:, t] + d_skip * dy[:, t]
        out["ddt"][:, t] = (g * (A * dec * hs[t] + u[:, t, :, None] * Bm[:, t, None])).sum(-1)
        out["dB"][:, t] = np.einsum("bds,bd->bs", g, dtu)
        out["dC"][:, t] = np.einsum("bd,bds->bs", dy[:, t], hs[t + 1])
        term = g * dec * hs[t] * dt[:, t, :, None] * A
        out["dlog_a"] += term.sum(0)
        mag["dB"][:, t] = np.einsum("bds,bd->bs", np.abs(g), np.abs(dtu))
        mag["dC"][:, t] = np.einsum("bd,bds->bs", np.abs(dy[:, t]), np.abs(hs[t + 1]))
        mag["dlog_a"] += np.abs(term).sum(0)
        g_next = dec * g
    out["dd_skip"] = (dy * u).sum((0, 1))
    mag["dd_skip"] = np.abs(dy * u).sum((0, 1))
    out["dstate0"] = g_next
    return out, mag


def _scale(name, want, mag):
    return float(np.max(mag[name] if name in SUMS else np.abs(want)))


def _close_grads(got, want, mag, what, rtol=0.0):
    """Each gradient within FRAC of its scale (plus ``rtol`` of each entry)."""
    for name, g, w in zip(GRADS, got, want):
        g = np.asarray(g.detach().float().numpy() if torch.is_tensor(g) else g, np.float64)
        w = np.asarray(w.detach().float().numpy() if torch.is_tensor(w) else w, np.float64)
        assert g.shape == w.shape, f"{what} {name} shape"
        np.testing.assert_allclose(g, w, rtol=rtol, atol=FRAC * _scale(name, w, mag),
                                   err_msg=f"{what} {name}")


_BWD_CASES = [
    (2, 37, 37, 16, True, 0.0),     # ragged T, Di not a multiple of 32
    (1, 70, 40, 5, False, 0.0),     # S = 5, no final-state gradient
    (2, 50, 24, 16, True, 3.0),     # strong decays (dt ~ softplus(N(3, 1)))
    (1, 130, 16, 16, True, -4.0),   # weak decays: a memory of about a hundred tokens
    (2, 1, 8, 5, True, 0.0),        # one token
]


@pytest.mark.parametrize("B,T,Di,S,d_final,shift", _BWD_CASES)
def test_scan_bwd_ref_matches_autograd_and_float64(B, T, Di, S, d_final, shift):
    args, dy, dfin = _case(B, T, Di, S, d_final, shift, B + T + Di + S)
    want, mag = _oracle(args, dy, dfin)
    targs = [torch.from_numpy(a) for a in args]
    tdy = torch.from_numpy(dy)
    tdf = None if dfin is None else torch.from_numpy(dfin)
    got = ss.selective_scan_bwd_ref(*targs, tdy, tdf)
    assert got[0].dtype == torch.float32 and all(g.dtype == torch.float32 for g in got)
    _close_grads(got, [want[n] for n in GRADS], mag, "plain backward vs float64")
    leaves = [a.clone().requires_grad_() for a in targs]
    y, s_fin = ss.selective_scan_ref(*leaves)
    total = (y * tdy).sum() + (0 if tdf is None else (s_fin * tdf).sum())
    auto = torch.autograd.grad(total, leaves)
    _close_grads(auto, [want[n] for n in GRADS], mag, "autograd vs float64")
    _close_grads(got, auto, mag, "plain backward vs autograd")


def test_scan_bwd_wrapper_takes_the_plain_version_on_cpu():
    args, dy, dfin = _case(1, 9, 6, 4, True, 0.0, 1)
    targs = [torch.from_numpy(a) for a in args]
    before = ss.selective_scan_bwd.launches
    got = ss.selective_scan_bwd(*targs, torch.from_numpy(dy), torch.from_numpy(dfin))
    assert ss.selective_scan_bwd.launches == before
    for g, w in zip(got, ss.selective_scan_bwd_ref(*targs, torch.from_numpy(dy),
                                                   torch.from_numpy(dfin))):
        assert torch.equal(g, w)
    meta = torch.zeros(1, 2, 4, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        ss.selective_scan_bwd(meta, meta, meta, meta, meta, meta, meta, meta)
    with pytest.raises(ValueError, match="keep_states"):
        ss.selective_scan(*targs, keep_states=True)


def _jax_scan(u, dt, Bm, Cm, log_a, d_skip, state, chunk):
    """The reference's scan on the gates' outputs: ``repro.models.ssm``'s
    ``_gates`` from u and dt on, and ``ssm_parallel``'s chunked
    ``associative_scan`` before ``wout``, copied."""
    A = -jnp.exp(log_a)
    decay = jnp.exp(dt[..., None] * A[None, None])
    drive = (dt * u.astype(jnp.float32))[..., None] * Bm[:, :, None, :]
    B, T = u.shape[:2]
    C = min(chunk, T)
    pad = (-T) % C
    if pad:
        u = jnp.pad(u, ((0, 0), (0, pad), (0, 0)))
        decay = jnp.pad(decay, ((0, 0), (0, pad), (0, 0), (0, 0)), constant_values=1.0)
        drive = jnp.pad(drive, ((0, 0), (0, pad), (0, 0), (0, 0)))
        Cm = jnp.pad(Cm, ((0, 0), (0, pad), (0, 0)))
    nc = (T + pad) // C
    Di = decay.shape[-2]

    def resh(a):
        return a.reshape(B, nc, C, *a.shape[2:]).transpose(1, 0, *range(2, a.ndim + 1))

    def chunk_fn(st, inp):
        dec, drv, cm, uu = inp
        drv = drv.at[:, 0].add(dec[:, 0] * st)
        _, h = jax.lax.associative_scan(JS._combine, (dec, drv), axis=1)
        y = jnp.einsum("btds,bts->btd", h, cm) + d_skip * uu.astype(jnp.float32)
        return h[:, -1], y

    state, ys = jax.lax.scan(chunk_fn, state, tuple(map(resh, (decay, drive, Cm, u))))
    return ys.transpose(1, 0, 2, 3).reshape(B, T + pad, Di)[:, :T], state


@pytest.mark.parametrize("udtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,chunk,d_final", [(37, 2048, True), (21, 8, False), (50, 16, True)])
def test_scan_function_matches_reference_vjp(udtype, T, chunk, d_final):
    """``SelectiveScan`` on CPU tensors against ``jax.vjp`` of the reference's
    scan: y, the final state and all seven gradients; T ragged, above the
    reference's chunk and padded, or one chunk; u in float32 or bfloat16
    (du then in bfloat16, rounded once). The float64 oracle's magnitudes set
    the sums' atol."""
    B, Di, S = 2, 24, 16
    args, dy, dfin = _case(B, T, Di, S, d_final, 0.0, T + chunk)
    jdt = jnp.float32 if udtype == "float32" else jnp.bfloat16
    ju = jnp.asarray(args[0], jdt)
    u_np = np.asarray(ju.astype(jnp.float32))         # u as both packages see it
    _, mag = _oracle((u_np,) + args[1:], dy, dfin)
    jargs = (ju,) + tuple(jnp.asarray(a) for a in args[1:])
    (jy, js), vjp = jax.vjp(lambda *a: _jax_scan(*a, chunk=chunk), *jargs)
    jgrads = vjp((jnp.asarray(dy), jnp.zeros_like(js) if dfin is None else jnp.asarray(dfin)))
    tu = convert.tensor_from_numpy(np.asarray(ju), "cpu")
    leaves = [tu.requires_grad_()] + [torch.from_numpy(a).requires_grad_() for a in args[1:]]
    before = (ss.selective_scan.launches, ss.selective_scan_bwd.launches)
    y, s_fin = ss.SelectiveScan.apply(*leaves)
    cot = [torch.from_numpy(dy)]
    outs = [y]
    if dfin is not None:                     # else the final state's gradient is None
        outs.append(s_fin)
        cot.append(torch.from_numpy(dfin))
    tgrads = torch.autograd.grad(outs, leaves, cot)
    assert (ss.selective_scan.launches, ss.selective_scan_bwd.launches) == before
    top = float(np.max(np.abs(np.asarray(jy))))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), rtol=1e-4, atol=FRAC * top)
    np.testing.assert_allclose(s_fin.detach().numpy(), np.asarray(js), rtol=1e-4,
                               atol=FRAC * float(np.max(np.abs(np.asarray(js)))))
    assert tgrads[0].dtype == getattr(torch, udtype)
    want = [np.asarray(jnp.asarray(g, jnp.float32)) for g in jgrads]
    if udtype == "bfloat16":
        # du is rounded to bf16 once by each side, from float32 values that
        # differ by float32 rounding: one bf16 ulp of the largest entry apart.
        du, dw = tgrads[0].float().numpy(), want[0]
        np.testing.assert_allclose(du, dw, rtol=0,
                                   atol=2.0 ** (np.floor(np.log2(np.max(np.abs(dw)))) - 7))
        tgrads, want, names = tgrads[1:], want[1:], GRADS[1:]
    else:
        names = GRADS
    for name, g, w in zip(names, tgrads, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=FRAC * _scale(name, w, mag),
                                   err_msg=name)


def test_ssm_parallel_gradients_match_reference_vjp():
    """``ssm_parallel`` under autograd (``SelectiveScan``) against ``jax.vjp``
    of the reference's: every leaf, x and the state, T above the chunk."""
    D, Di, S, T, chunk = 32, 48, 16, 21, 8
    jp = JS.init_ssm(jax.random.PRNGKey(4), D, Di, S, jnp.float32)
    rng = np.random.default_rng(4)
    jp["wdt"]["b"] = jnp.asarray(rng.normal(size=(Di,)) * 0.5, jnp.float32)
    jp["log_a"] = jp["log_a"] + jnp.asarray(0.2 * rng.normal(size=(Di, S)), jnp.float32)
    x = rng.normal(size=(2, T, D)).astype(np.float32)
    s0 = rng.normal(size=(2, Di, S)).astype(np.float32)
    do = rng.normal(size=(2, T, D)).astype(np.float32)
    ds = rng.normal(size=(2, Di, S)).astype(np.float32)
    (jo, js), vjp = jax.vjp(lambda p, x, s: JS.ssm_parallel(p, x, s, chunk=chunk), jp,
                            jnp.asarray(x), jnp.asarray(s0))
    jg = vjp((jnp.asarray(do), jnp.asarray(ds)))
    tp = convert.params_from_numpy(_np(jp), "cpu")
    leaves = tree_leaves(tp)
    tx, ts = torch.from_numpy(x).requires_grad_(), torch.from_numpy(s0).requires_grad_()
    for t in leaves:
        t.requires_grad_(True)
    to, tst = TS.ssm_parallel(tp, tx, ts, chunk=chunk)
    grads = torch.autograd.grad([to, tst], leaves + [tx, ts],
                                [torch.from_numpy(do), torch.from_numpy(ds)])
    np.testing.assert_allclose(to.detach().numpy(), np.asarray(jo), rtol=1e-4, atol=1e-5)
    jleaves = jax.tree.leaves(jg[0]) + [jg[1], jg[2]]
    assert len(jleaves) == len(grads)
    for i, (g, w) in enumerate(zip(grads, jleaves)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=FRAC * float(np.max(np.abs(w))),
                                   err_msg=f"gradient {i}")


# ------------------------------------------------------------- LM loss


def _pair(**over):
    jcfg = jget_arch("hymba-1.5b").reduced(**over)
    jb = JT.build_model(jcfg)
    jp = jb.init(jax.random.PRNGKey(0))
    tb = TT.build_model(tconfigs.get_arch("hymba-1.5b").reduced(**over))
    return jb, jp, tb, convert.params_from_numpy(_np(jp), "cpu")


def _grads(tb, tp, batch):
    leaves = tree_leaves(tp)
    for t in leaves:
        t.requires_grad_(True)
    loss = tb.loss(tp, batch)
    return loss.detach(), torch.autograd.grad(loss, leaves)


def test_loss_and_every_gradient_match_reference_short():
    """T = 40 (the naive attention, windowed at the reduced 16), remat on."""
    jb, jp, tb, tp = _pair(remat=True)
    rng = np.random.default_rng(13)
    batch = {k: rng.integers(0, 256, size=(2, 40)).astype(np.int32)
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
    _, _, tb_on, tp = _pair(remat=True)
    tb_off = TT.build_model(tconfigs.get_arch("hymba-1.5b").reduced(remat=False))
    rng = np.random.default_rng(14)
    batch = {k: torch.from_numpy(rng.integers(0, 256, size=(2, 37)).astype(np.int32))
             for k in ("tokens", "targets")}
    l_on, g_on = _grads(tb_on, tp, batch)
    l_off, g_off = _grads(tb_off, tp, batch)
    assert torch.equal(l_on, l_off)
    for a, b in zip(g_on, g_off):
        assert torch.equal(a, b)


# ------------------------------------------------------------- one LM round


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _paths(tree[k], f"{prefix}/{k}")
        return out
    return [(prefix, tree)]


def _round_batch(G, K, E, H, A, seq, seed):
    rng = np.random.default_rng(seed)
    toks, _ = jlm.make_lm_tokens(rng, 256, 20_000)
    pk = jdriver.pack_lm_shards(toks, num_groups=G, clients_per_group=K, group_rounds=E,
                                local_steps=H, batch_size=1, seq_len=seq, shards=2,
                                microbatches=A, rng=np.random.default_rng(seed + 1),
                                key=jax.random.PRNGKey(0))
    sid = jax.random.randint(jax.random.PRNGKey(1), (E, G, K), 0, 2)
    P = G * K

    def gather(leaf):
        flat = leaf.reshape((P,) + leaf.shape[2:])
        sel = flat[jnp.arange(P)[None, :], sid.reshape(E, P)]
        sel = jnp.moveaxis(sel, 2, 1)
        sel = sel.reshape(sel.shape[:2] + (G, K) + sel.shape[3:])
        return sel.reshape((E, H, A) + sel.shape[2:])

    return jax.tree.map(gather, pk.arrays)


@pytest.mark.parametrize("layout", ["tree", "flat"])
def test_sharded_lm_round_matches_reference(layout):
    """Reduced hymba (float32, remat), 2 x 2 clients, E = H = A = 2, seq 40
    (past the reduced window of 16), fused: one round through both packages'
    build/round_fn from the same params and batches."""
    G, K, E, H, A, lr = 2, 2, 2, 2, 2, 0.05
    jb, jp, tb, tp = _pair(remat=True)
    jbatch = _round_batch(G, K, E, H, A, 40, seed=41)
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


def test_train_cli_smoke(capsys):
    from repro_torch.launch import train
    train.main(["--arch", "hymba-1.5b", "--smoke", "--rounds", "2", "--device", "cpu",
                "--seq", "32", "--shards", "2", "--state-layout", "tree"])
    out = capsys.readouterr().out
    assert "[train] arch=hymba-1.5b" in out and "device=cpu" in out
    losses = [float(line.split()[3]) for line in out.splitlines() if line.startswith("round ")]
    assert len(losses) == 2 and all(np.isfinite(losses))
