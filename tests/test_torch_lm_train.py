"""LM training on the port against the JAX package, on the CPU.

* the attention backward's plain version (``flash_attention_bwd_ref``) and
  the differentiable ``FlashAttention`` against ``jax.vjp`` of the model's
  ``flash_jnp.blocked_attention_flash`` (the reference's custom VJP), with
  the forward's row statistics against ``flash_jnp._fwd``'s;
* ``chunked_xent``, and the reduced glm4-9b, qwen3-14b, rwkv6-1.6b,
  qwen2.5-32b (the QKV biases' gradients), gemma3-27b (7 layers: six
  windowed, one global, so the windows run in the backward; tied
  embeddings) and hymba-1.5b (windowed attention and the selective SSM)
  ``loss`` with every gradient leaf against
  ``jax.value_and_grad(bundle.loss)`` at T > 1024 (the blocked attention
  path); remat on == off (rwkv6's training: ``test_torch_ssm_train.py``;
  hymba's: ``test_torch_hybrid_train.py``);
* ``make_lm_tokens``/``lm_batches``/``pack_lm_shards`` draw for draw;
* one full sharded LM round (reduced glm4-9b, 2 x 2 clients, E = H = A = 2)
  against the reference's ``build(spec, bundle.loss)``, and the trainer's
  CLI.

Tolerances, float32 throughout: attention gradients 5e-5 abs (as the
forward is held, tests/test_torch_lm_kernels.py), with dk/dv summed over
the q heads of a kv head in another order than the transpose of JAX's
``_expand_kv``; loss and gradients rtol 1e-4 / atol 1e-5 (the products and
the softmax reorder sums; seen: 2e-6 relative); the LM round rtol 1e-4 /
atol 1e-5 on params and their atol through 1 / (H lr) for z and 1 /
(H E lr) for y (ROADMAP queue 3 item 2).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import api as japi  # noqa: E402
from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.core import driver as jdriver  # noqa: E402
from repro.data import lm as jlm  # noqa: E402
from repro.models import flash_jnp  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import api as tapi  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import driver as tdriver  # noqa: E402
from repro_torch.core.tree import tree_leaves  # noqa: E402
from repro_torch.data import lm as tlm  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """One intra-op thread: the suite runs files in parallel workers, and
    PyTorch's default of one thread per core would crowd out the other
    workers' (timing-sensitive) tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# ------------------------------------------------------ attention backward


@pytest.mark.parametrize("B,T,H,Kv,Dh,win,block", [
    (1, 64, 32, 2, 32, 0, 16),      # glm4's 16:1 GQA
    (2, 45, 10, 2, 32, 0, 16),      # 5:1 GQA, ragged T (not a block multiple)
    (1, 70, 4, 2, 64, 9, 32),       # sliding window, ragged
    (1, 37, 4, 4, 32, 0, 64),       # one block, no GQA
])
def test_attention_backward_matches_reference_vjp(B, T, H, Kv, Dh, win, block):
    rng = np.random.default_rng(B * 100 + T + H + win)
    q = rng.normal(size=(B, T, H, Dh)).astype(np.float32)
    k = rng.normal(size=(B, T, Kv, Dh)).astype(np.float32)
    v = rng.normal(size=(B, T, Kv, Dh)).astype(np.float32)
    do = rng.normal(size=(B, T, H, Dh)).astype(np.float32)

    def jfn(q, k, v):
        return flash_jnp.blocked_attention_flash(
            q, JL._expand_kv(k, H), JL._expand_kv(v, H), causal=True, window=win,
            block=block)

    jo, vjp = jax.vjp(jfn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jdq, jdk, jdv = vjp(jnp.asarray(do))
    _, (jm, jl) = flash_jnp._fwd(jnp.asarray(q), JL._expand_kv(jnp.asarray(k), H),
                                 JL._expand_kv(jnp.asarray(v), H), win, True, 0, block)

    o, m, l = fa.flash_attention_ref(_t(q), _t(k), _t(v), window=win, block=block,
                                     return_stats=True)
    np.testing.assert_allclose(m.numpy(), np.asarray(jm), rtol=1e-6, atol=5e-6)
    np.testing.assert_allclose(l.numpy(), np.asarray(jl), rtol=1e-5)
    dq, dk, dv = fa.flash_attention_bwd_ref(_t(q), _t(k), _t(v), o, _t(do), m, l,
                                            window=win, block=block)
    for got, want in ((o, jo), (dq, jdq), (dk, jdk), (dv, jdv)):
        assert got.shape == want.shape
        assert float(np.max(np.abs(got.numpy() - np.asarray(want)))) < 5e-5

    # The autograd Function (the wrapper's plain versions on CPU tensors).
    tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    before = (fa.flash_attention.launches, fa.flash_attention_bwd.launches)
    out = fa.FlashAttention.apply(tq, tk, tv, True, win, 0, block)
    out.backward(_t(do))
    assert (fa.flash_attention.launches, fa.flash_attention_bwd.launches) == before
    for got, want in ((out, jo), (tq.grad, jdq), (tk.grad, jdk), (tv.grad, jdv)):
        assert float(np.max(np.abs(got.detach().numpy() - np.asarray(want)))) < 5e-5


def test_chunked_xent_matches_reference():
    rng = np.random.default_rng(3)
    w = rng.normal(size=(16, 50)).astype(np.float32)
    for T in (1024, 100, 192):           # chunks of 512, all T (gcd < 64), 64
        h = rng.normal(size=(2, T, 16)).astype(np.float32)
        tg = rng.integers(0, 50, size=(2, T)).astype(np.int32)
        want = JT.chunked_xent(lambda x: x @ jnp.asarray(w), jnp.asarray(h), jnp.asarray(tg))
        got = TT.chunked_xent(lambda x: x @ _t(w), _t(h), torch.from_numpy(tg))
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


# ------------------------------------------------------------- LM loss


def _pair(arch, **over):
    jcfg = jget_arch(arch).reduced(**over)
    jb = JT.build_model(jcfg)
    jp = jb.init(jax.random.PRNGKey(0))
    tb = TT.build_model(tconfigs.get_arch(arch).reduced(**over))
    return jb, jp, tb, convert.params_from_numpy(_np(jp), "cpu")


def _grads(tb, tp, batch):
    leaves = tree_leaves(tp)
    for t in leaves:
        t.requires_grad_(True)
    loss = tb.loss(tp, batch)
    return loss.detach(), torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("arch", ["glm4-9b", "qwen3-14b", "rwkv6-1.6b", "qwen2.5-32b",
                                  "gemma3-27b", "hymba-1.5b"])
def test_loss_and_every_gradient_match_reference(arch):
    """T = 1088 > 1024: every attention layer takes the blocked (flash)
    path, forward and backward, under remat as in the full configs; the
    rwkv6 layers run the chunked scan (272 chunks of the reduced config's
    4 tokens); gemma3's windowed layers (window 16) and its global one;
    hymba's windowed attention (window 16) beside its selective SSM, whose
    backward is ``SelectiveScan``'s."""
    over = dict(num_layers=7) if arch == "gemma3-27b" else {}
    jb, jp, tb, tp = _pair(arch, attn_block=128, remat=True, **over)
    rng = np.random.default_rng(5)
    batch = {k: rng.integers(0, 256, size=(1, 1088)).astype(np.int32)
             for k in ("tokens", "targets")}
    jl, jg = jax.value_and_grad(jb.loss)(jp, jax.tree.map(jnp.asarray, batch))
    tl, tg = _grads(tb, tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    jleaves = jax.tree.leaves(jg)
    assert len(jleaves) == len(tg)
    for i, (got, want) in enumerate(zip(tg, jleaves)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5,
                                   err_msg=f"{arch} gradient leaf {i}")


def test_remat_on_equals_off():
    _, _, tb_on, tp = _pair("glm4-9b", remat=True)
    tb_off = TT.build_model(tconfigs.get_arch("glm4-9b").reduced(remat=False))
    rng = np.random.default_rng(6)
    batch = {k: torch.from_numpy(rng.integers(0, 256, size=(2, 40)).astype(np.int32))
             for k in ("tokens", "targets")}
    l_on, g_on = _grads(tb_on, tp, batch)
    l_off, g_off = _grads(tb_off, tp, batch)
    assert torch.equal(l_on, l_off)
    for a, b in zip(g_on, g_off):
        assert torch.equal(a, b)


# ------------------------------------------------------------- data


def test_lm_tokens_and_packing_match_reference():
    toks_j, doms_j = jlm.make_lm_tokens(np.random.default_rng(1), 300, 9000)
    toks_t, doms_t = tlm.make_lm_tokens(np.random.default_rng(1), 300, 9000)
    np.testing.assert_array_equal(toks_t, toks_j)
    np.testing.assert_array_equal(doms_t, doms_j)
    bj = jlm.lm_batches(toks_j, np.random.default_rng(2), (2, 3), 16)
    bt = tlm.lm_batches(toks_t, np.random.default_rng(2), (2, 3), 16)
    for k in bj:
        np.testing.assert_array_equal(bt[k], bj[k])
    streams = [[toks_j[i * 1000:(i + 1) * 1000] for i in range(g * 2, g * 2 + 2)]
               for g in range(2)]
    for tokens in (toks_j, streams):
        kw = dict(num_groups=2, clients_per_group=2, group_rounds=2, local_steps=3,
                  batch_size=2, seq_len=12, shards=4, microbatches=2)
        pj = jdriver.pack_lm_shards(tokens, rng=np.random.default_rng(7),
                                    key=jax.random.PRNGKey(0), **kw)
        pt = tdriver.pack_lm_shards(tokens, rng=np.random.default_rng(7), device="cpu", **kw)
        assert pt.microbatches == 2 and tuple(pt.arrays["tokens"].shape) == (2, 2, 4, 6, 2, 12)
        for k in ("tokens", "targets"):
            np.testing.assert_array_equal(pt.arrays[k].numpy(), np.asarray(pj.arrays[k]))
        # One round's selection from the same shard ids: [E, H, A, G, K, B, T].
        sid = np.asarray(jax.random.randint(jax.random.PRNGKey(9), (2, 2, 2), 0, 4))
        sel = tdriver.select_round(pt, torch.from_numpy(sid))
        assert tuple(sel["tokens"].shape) == (2, 3, 2, 2, 2, 2, 12)
        flat = pt.arrays["tokens"].reshape(4, 4, 6, 2, 12)
        for e in range(2):
            for g in range(2):
                for k in range(2):
                    blk = flat[g * 2 + k, sid[e, g, k]].reshape(3, 2, 2, 12)
                    assert torch.equal(sel["tokens"][e, :, :, g, k], blk)


# ------------------------------------------------------------- one LM round


def test_sharded_lm_round_matches_reference():
    """Reduced glm4-9b (float32, remat), 2 x 2 clients, E = H = A = 2, seq
    64, tree + fused: one round through both packages' build/round_fn from
    the same params and batches."""
    G, K, E, H, A, lr = 2, 2, 2, 2, 2, 0.05
    jb, jp, tb, tp = _pair("glm4-9b", remat=True)
    rng = np.random.default_rng(8)
    toks, _ = jlm.make_lm_tokens(rng, 256, 20_000)
    pk = jdriver.pack_lm_shards(toks, num_groups=G, clients_per_group=K, group_rounds=E,
                                local_steps=H, batch_size=1, seq_len=64, shards=2,
                                microbatches=A, rng=np.random.default_rng(9),
                                key=jax.random.PRNGKey(0))
    sid = jax.random.randint(jax.random.PRNGKey(1), (E, G, K), 0, 2)
    kw = dict(levels=(G, K), backend="sharded", lr=lr, state_layout="tree", fusion="fused")
    jspec = japi.ExperimentSpec(schedule=japi.RoundSchedule(
        group_rounds=E, local_steps=H, microbatches=A), fused_mode="interpret", **kw)
    tspec = tapi.ExperimentSpec(schedule=tapi.RoundSchedule(
        group_rounds=E, local_steps=H, microbatches=A), **kw)
    jeng, teng = japi.build(jspec, jb.loss), tapi.build(tspec, tb.loss, device="cpu")
    jbatch = jax.tree.map(lambda a: a, _select(pk, sid))
    js, jm = jeng.round_fn(jeng.init(jp), jbatch)
    ts, tm = teng.round_fn(teng.init(tp), {k: torch.from_numpy(np.asarray(v))
                                          for k, v in jbatch.items()})
    np.testing.assert_allclose(tm.loss.numpy(), np.asarray(jm.loss), rtol=1e-5)
    assert np.isfinite(tm.loss.numpy()).all()
    for name, atol in (("params", 1e-5), ("z", 1e-5 / (H * lr)), ("y", 1e-5 / (H * E * lr))):
        got, want = convert.to_numpy(getattr(ts, name)), _np(getattr(js, name))
        for (path, g), w in zip(_paths(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=atol, err_msg=f"{name}/{path}")


def _select(pk, sid):
    """The reference's on-device round selection with fixed shard ids."""
    E, H, A = pk.group_rounds, pk.local_steps, pk.microbatches
    P = 4

    def gather(leaf):
        flat = leaf.reshape((P,) + leaf.shape[2:])
        sel = flat[jnp.arange(P)[None, :], sid.reshape(E, P)]
        sel = jnp.moveaxis(sel, 2, 1)
        sel = sel.reshape(sel.shape[:2] + (2, 2) + sel.shape[3:])
        return sel.reshape((E, H, A) + sel.shape[2:])

    return jax.tree.map(gather, pk.arrays)


def _paths(tree, prefix=""):
    """(path, leaf) of a nested dict in sorted key order (jax.tree's)."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _paths(tree[k], f"{prefix}/{k}")
        return out
    return [(prefix, tree)]


def test_train_cli_smoke(capsys):
    from repro_torch.launch import train
    train.main(["--arch", "glm4-9b", "--smoke", "--rounds", "2", "--device", "cpu",
                "--seq", "32", "--shards", "2"])
    out = capsys.readouterr().out
    assert "[train] arch=glm4-9b" in out and "device=cpu" in out
    losses = [float(line.split()[3]) for line in out.splitlines() if line.startswith("round ")]
    assert len(losses) == 2 and all(np.isfinite(losses))


def test_train_cli_flags_are_the_reference_table():
    import argparse

    from repro.core import api as jcore
    assert ([(r.field, r.flag, r.choices, r.nargs, r.optional) for r in tapi.CLI_FLAGS]
            == [(r.field, r.flag, r.choices, r.nargs, r.optional) for r in jcore.CLI_FLAGS])
    ap = argparse.ArgumentParser()
    tapi.add_spec_args(ap, defaults=tapi.ExperimentSpec(backend="sharded"),
                       exclude=("backend",))
    args = ap.parse_args(["--levels", "2", "3", "--E", "3", "--fault-crash", "0.1"])
    spec = tapi.spec_from_args(args, defaults=tapi.ExperimentSpec(backend="sharded"),
                               microbatches=2)
    assert spec.levels == (2, 3) and spec.schedule.group_rounds == 3
    assert spec.schedule.microbatches == 2 and spec.faults == tapi.FaultPlan(crash_rate=0.1)
    assert spec.validate() is spec
    assert dataclasses.replace(spec, faults=None).validate() is not None
