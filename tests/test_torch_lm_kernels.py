"""The LM kernels' plain versions against the JAX package: the port's
``flash_attention`` and ``rwkv6_scan`` on CPU tensors (their plain
PyTorch versions) against ``repro.kernels.ref`` and the Pallas kernels in
interpret mode, over the sweeps of ``tests/test_kernels.py`` plus the
cases the model path adds (``q_offset``, ragged T and S, ragged T through
the model's chunked RWKV path). The CUDA kernels themselves are held
against these plain versions on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).

Tolerances: float32 throughout, 5e-5 abs for attention (as
``test_kernels.py`` holds the Pallas kernel) and rtol/atol 1e-4 for the
scan (likewise): both reorder sums and exponentials against the oracles.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref  # noqa: E402
from repro.kernels.flash_attention import flash_attention as pallas_flash  # noqa: E402
from repro.kernels.rwkv6_scan import rwkv6_scan as pallas_scan  # noqa: E402
from repro.models import rwkv6 as jrwkv  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import rwkv6_scan as rs  # noqa: E402
from repro_torch.models import rwkv6 as trwkv  # noqa: E402


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


# --------------------------------------------------------- flash attention


@pytest.mark.parametrize("B,T,S,H,Kv,Dh,causal,win", [
    (1, 128, 128, 4, 4, 64, True, 0),
    (2, 128, 128, 4, 2, 64, True, 0),       # GQA
    (1, 256, 256, 2, 1, 32, True, 64),      # MQA + sliding window
    (1, 128, 256, 4, 4, 64, False, 0),      # cross/bidirectional
    (2, 256, 256, 8, 2, 128, True, 100),    # window not block-aligned
    (1, 64, 64, 25, 5, 32, True, 16),       # hymba's 25/5 heads
])
def test_flash_plain_matches_ref_and_pallas(B, T, S, H, Kv, Dh, causal, win):
    rng = np.random.default_rng(B * 1000 + T + S + H + Dh + win)
    q = rng.normal(size=(B, T, H, Dh)).astype(np.float32)
    k = rng.normal(size=(B, S, Kv, Dh)).astype(np.float32)
    v = rng.normal(size=(B, S, Kv, Dh)).astype(np.float32)
    before = fa.flash_attention.launches
    got = fa.flash_attention(_t(q), _t(k), _t(v), causal=causal, window=win, block=64)
    assert fa.flash_attention.launches == before      # a CPU tensor launches nothing
    want = np.asarray(ref.flash_attention_ref(q, k, v, causal=causal, window=win))
    pal = np.asarray(pallas_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  causal=causal, window=win, block_q=64, block_k=64,
                                  interpret=True))
    assert float(np.max(np.abs(got.numpy() - want))) < 5e-5
    assert float(np.max(np.abs(got.numpy() - pal))) < 5e-5


@pytest.mark.parametrize("B,T,S,H,Kv,Dh,causal,win,off,block", [
    (1, 37, 37, 4, 2, 32, True, 0, 0, 16),     # ragged T = S
    (2, 20, 53, 4, 1, 32, True, 0, 0, 16),     # prefill into a longer cache
    (1, 24, 70, 6, 3, 64, True, 0, 30, 16),    # q_offset > 0 (a later chunk)
    (1, 50, 50, 4, 2, 32, True, 13, 0, 16),    # window not a block multiple
    (2, 33, 81, 4, 4, 32, True, 9, 40, 32),    # window + q_offset + ragged S
    (1, 19, 45, 2, 2, 32, False, 0, 0, 16),    # bidirectional, ragged
    (1, 16, 40, 4, 2, 32, True, 0, 0, 512),    # one block larger than S
])
def test_flash_plain_offsets_and_ragged(B, T, S, H, Kv, Dh, causal, win, off, block):
    """Shapes the Pallas kernel asserts on: held against the oracle only."""
    rng = np.random.default_rng(T * 31 + S + off)
    q = rng.normal(size=(B, T, H, Dh)).astype(np.float32)
    k = rng.normal(size=(B, S, Kv, Dh)).astype(np.float32)
    v = rng.normal(size=(B, S, Kv, Dh)).astype(np.float32)
    got = fa.flash_attention(_t(q), _t(k), _t(v), causal=causal, window=win, q_offset=off,
                             block=block)
    want = np.asarray(ref.flash_attention_ref(q, k, v, causal=causal, window=win,
                                              q_offset=off))
    assert float(np.max(np.abs(got.numpy() - want))) < 5e-5


def test_flash_plain_matches_flash_jnp():
    """The plain version is the port of the model's jnp twin: same block
    size, same padded-cache prefill (future slots zero)."""
    from repro.models.flash_jnp import blocked_attention_flash
    rng = np.random.default_rng(5)
    q = rng.normal(size=(2, 24, 4, 32)).astype(np.float32)
    k = rng.normal(size=(2, 30, 4, 32)).astype(np.float32)
    v = rng.normal(size=(2, 30, 4, 32)).astype(np.float32)
    k[:, 24:] = 0.0
    v[:, 24:] = 0.0
    want = np.asarray(blocked_attention_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                              window=7, q_offset=0, block=16))
    got = fa.flash_attention(_t(q), _t(k), _t(v), window=7, block=16).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_flash_plain_bf16():
    rng = np.random.default_rng(9)
    q, k, v = (rng.normal(size=s).astype(np.float32)
               for s in ((1, 128, 4, 64), (1, 128, 2, 64), (1, 128, 2, 64)))
    qb, kb, vb = (convert.tensor_from_numpy(jnp.asarray(a, jnp.bfloat16), "cpu")
                  for a in (q, k, v))
    got = fa.flash_attention(qb, kb, vb, block=64)
    want = ref.flash_attention_ref(jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
                                   jnp.asarray(v, jnp.bfloat16))
    err = float(np.max(np.abs(got.float().numpy() - np.asarray(want, np.float32))))
    assert got.dtype == torch.bfloat16 and err < 3e-2, err


def test_flash_rejects_other_devices():
    q = torch.zeros(1, 4, 2, 32, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        fa.flash_attention(q, q, q)


# -------------------------------------------------------------- rwkv scan


def _scan_inputs(rng, B, H, T, Dh):
    r, k, v = (rng.normal(size=(B, H, T, Dh)).astype(np.float32) for _ in range(3))
    logw = -np.abs(rng.normal(size=(B, H, T, Dh))).astype(np.float32)
    u = rng.normal(size=(H, Dh)).astype(np.float32)
    s0 = rng.normal(size=(B, H, Dh, Dh)).astype(np.float32)
    return r, k, v, logw, u, s0


@pytest.mark.parametrize("B,H,T,Dh,C", [
    (1, 2, 32, 16, 8), (2, 3, 64, 32, 16), (1, 1, 128, 64, 64),
    (2, 2, 64, 64, 32),
])
def test_scan_plain_matches_ref_and_pallas(B, H, T, Dh, C):
    rng = np.random.default_rng(B + H * 10 + T + Dh + C)
    r, k, v, logw, u, s0 = _scan_inputs(rng, B, H, T, Dh)
    want_o, want_s = ref.rwkv6_scan_ref(*(jnp.asarray(a) for a in (r, k, v, logw, u, s0)))

    def flat(a):
        return a.reshape(B * H, T, Dh)

    u_b = np.broadcast_to(u[None], (B, H, Dh)).reshape(B * H, Dh)
    args = (flat(r), flat(k), flat(v), flat(logw), u_b, s0.reshape(B * H, Dh, Dh))
    pal_o, pal_s = pallas_scan(*(jnp.asarray(a) for a in args), chunk=C, interpret=True)
    before = rs.rwkv6_scan.launches
    got_o, got_s = rs.rwkv6_scan(*(_t(a) for a in args), chunk=C)
    assert rs.rwkv6_scan.launches == before
    assert got_o.dtype == torch.float32 and got_s.dtype == torch.float32
    for want, got in ((want_o, got_o), (want_s, got_s)):
        np.testing.assert_allclose(got.numpy().reshape(np.shape(want)), np.asarray(want),
                                   rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(pal_o), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(pal_s), rtol=1e-4, atol=1e-4)


def test_scan_state_carry_composes():
    """scan(T) == scan(T/2) then scan(T/2) with the carried state."""
    B, H, T, Dh, C = 1, 2, 64, 16, 8
    rng = np.random.default_rng(3)
    r, k, v = (_t(rng.normal(size=(B * H, T, Dh))) for _ in range(3))
    logw = -_t(rng.normal(size=(B * H, T, Dh))).abs()
    u = _t(rng.normal(size=(B * H, Dh)))
    S0 = torch.zeros(B * H, Dh, Dh)
    o_full, s_full = rs.rwkv6_scan(r, k, v, logw, u, S0, chunk=C)
    h = T // 2
    o1, s1 = rs.rwkv6_scan(r[:, :h], k[:, :h], v[:, :h], logw[:, :h], u, S0, chunk=C)
    o2, s2 = rs.rwkv6_scan(r[:, h:], k[:, h:], v[:, h:], logw[:, h:], u, s1, chunk=C)
    np.testing.assert_allclose(torch.cat([o1, o2], 1).numpy(), o_full.numpy(),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(s2.numpy(), s_full.numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("T,C", [(13, 4), (7, 8), (30, 8)])
def test_scan_ragged_t_matches_sequential_ref(T, C):
    """A T that is not a multiple of the chunk (padded with k = 0, logw = 0)
    against the sequential oracle, in the model's [B, T, H, Dh] layout."""
    B, H, Dh = 2, 3, 16
    rng = np.random.default_rng(T + C)
    r, k, v, logw, u, s0 = _scan_inputs(rng, B, H, T, Dh)
    want_o, want_s = ref.rwkv6_scan_ref(*(jnp.asarray(a) for a in (r, k, v, logw, u, s0)))

    def bthd(a):
        return _t(a.transpose(0, 2, 1, 3).copy())

    got_o, got_s = rs.rwkv6_scan_bthd(bthd(r), bthd(k), bthd(v), bthd(logw), _t(u), _t(s0),
                                      chunk=C)
    np.testing.assert_allclose(got_o.numpy().transpose(0, 2, 1, 3), np.asarray(want_o),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("T", [32, 29])
def test_model_rwkv_path_matches_kernel(T):
    """The model's chunked path (port and reference) and the Pallas kernel
    agree; T = 29 is ragged and goes through the model's padding."""
    import jax.random as jr
    D, Hn, C = 64, 4, 8
    p = jrwkv.init_rwkv6(jr.PRNGKey(0), D, Hn, jnp.float32)
    rng = np.random.default_rng(T)
    x = rng.normal(size=(2, T, D)).astype(np.float32)
    xp = np.zeros((2, D), np.float32)
    st = rng.normal(size=(2, Hn, D // Hn, D // Hn)).astype(np.float32)
    out_j, last_j, st_j = jrwkv.rwkv6_chunked(p, jnp.asarray(x), jnp.asarray(xp),
                                               jnp.asarray(st), n_heads=Hn, chunk=C)
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, p), "cpu")
    out_t, last_t, st_t = trwkv.rwkv6_chunked(tp, _t(x), _t(xp), _t(st), n_heads=Hn, chunk=C)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(st_t.numpy(), np.asarray(st_j), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(last_t.numpy(), np.asarray(last_j))
    if T % C == 0:
        r, k, v, logw, _ = jrwkv._proj(p, jnp.asarray(x), jnp.asarray(xp), Hn)

        def tr(a):
            return a.transpose(0, 2, 1, 3).reshape(2 * Hn, T, D // Hn)

        u_b = jnp.broadcast_to(p["u"][None], (2, Hn, D // Hn)).reshape(2 * Hn, -1)
        _, s_kern = pallas_scan(tr(r), tr(k), tr(v), tr(logw), u_b,
                                jnp.asarray(st).reshape(2 * Hn, D // Hn, D // Hn),
                                chunk=C, interpret=True)
        np.testing.assert_allclose(st_t.numpy().reshape(2 * Hn, D // Hn, D // Hn),
                                   np.asarray(s_kern), rtol=1e-4, atol=1e-4)


# ------------------------------------- the kernel's chunk-parallel arithmetic
#
# ``rwkv6_chunk_parallel_ref`` repeats csrc/rwkv6_scan.cu's three passes and
# anchored sub-chunk decays in PyTorch. Held at rtol/atol 1e-4 (the scan's
# tolerance) against the sequential oracle for every decay, from the
# model's -exp(-1 + tanh(.)) to logw down to -20, where exp(-cum) would
# overflow; and against the Pallas kernel and the plain version for the
# decays where those two hold the oracle's tolerance themselves.


def _decays(rng, kind, shape):
    x = rng.normal(size=shape)
    if kind == "model":
        return -np.exp(-1.0 + np.tanh(x))
    if kind == "abs":
        return -np.abs(x)
    return -20.0 * rng.uniform(size=shape)        # strong: logw in (-20, 0]


def _scan_case(T, decay, seed, B=2, H=2, Dh=32):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(B, H, T, Dh)).astype(np.float32) for _ in range(3))
    logw = _decays(rng, decay, (B, H, T, Dh)).astype(np.float32)
    u = rng.normal(size=(H, Dh)).astype(np.float32)
    s0 = rng.normal(size=(B, H, Dh, Dh)).astype(np.float32)
    return r, k, v, logw, u, s0


def _bthd(a):
    return _t(a.transpose(0, 2, 1, 3).copy())


def _parallel(args, C, sub):
    r, k, v, logw, u, s0 = args
    o, s = rs.rwkv6_chunk_parallel_ref(_bthd(r), _bthd(k), _bthd(v), _bthd(logw), _t(u), _t(s0),
                                       chunk=C, sub=sub)
    return o.numpy().transpose(0, 2, 1, 3), s.numpy()


def _pallas_padded(args, C):
    """The Pallas kernel in interpret mode on inputs padded to a chunk
    multiple with the model's padding (k = v = r = 0, logw = 0)."""
    r, k, v, logw, u, s0 = args
    B, H, T, Dh = r.shape
    Tp = -(-T // C) * C

    def flat(a):
        return jnp.asarray(np.pad(a, ((0, 0), (0, 0), (0, Tp - T), (0, 0))).reshape(B * H, Tp, Dh))

    u_b = np.broadcast_to(u[None], (B, H, Dh)).reshape(B * H, Dh)
    o, s = pallas_scan(flat(r), flat(k), flat(v), flat(logw), jnp.asarray(u_b),
                       jnp.asarray(s0.reshape(B * H, Dh, Dh)), chunk=C, interpret=True)
    return np.asarray(o).reshape(B, H, Tp, Dh)[:, :, :T], np.asarray(s).reshape(s0.shape)


_PARALLEL_CASES = [(C, sub, decay, 2 * C + 5) for C in (16, 64) for sub in (8, 16)
                   for decay in ("model", "abs", "strong")]
_PARALLEL_CASES += [(20, 16, "strong", 45),   # sub-chunks that do not divide the chunk
                    (20, 8, "model", 45),
                    (64, 16, "strong", 7)]    # T shorter than a chunk: C = T = 7


@pytest.mark.parametrize("C,sub,decay,T", _PARALLEL_CASES)
def test_scan_chunk_parallel_matches_sequential_ref(C, sub, decay, T):
    args = _scan_case(T, decay, seed=C * 7 + sub + T)
    want_o, want_s = ref.rwkv6_scan_ref(*(jnp.asarray(a) for a in args))
    got_o, got_s = _parallel(args, C, sub)
    np.testing.assert_allclose(got_o, np.asarray(want_o), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got_s, np.asarray(want_s), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("C,sub,decay", [(C, sub, decay) for C in (16, 64) for sub in (8, 16)
                                         for decay in ("model", "abs")])
def test_scan_chunk_parallel_matches_pallas_and_plain(C, sub, decay):
    T = 2 * C + 5
    args = _scan_case(T, decay, seed=C + sub * 3)
    got_o, got_s = _parallel(args, C, sub)
    pal_o, pal_s = _pallas_padded(args, C)
    np.testing.assert_allclose(got_o, pal_o, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got_s, pal_s, rtol=1e-4, atol=1e-4)
    r, k, v, logw, u, s0 = args
    plain_o, plain_s = rs.rwkv6_chunked_ref(_bthd(r), _bthd(k), _bthd(v), _bthd(logw), _t(u),
                                            _t(s0), chunk=C)
    np.testing.assert_allclose(got_o, plain_o.numpy().transpose(0, 2, 1, 3), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got_s, plain_s.numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("sub", [8, 16])
def test_chunk_form_cancellation_at_strong_decays(sub):
    """Why the strong decays are held against the sequential oracle alone:
    the reference's chunk form (Pallas kernel, and the plain version that
    ports it) takes exp(cum_ex[t] - cum[i]) from chunk-wide sums of logw,
    whose float32 rounding (about one ulp of |cum|, up to 1280 here) reaches
    the exponent; it is off the oracle by more than the scan's tolerance.
    The chunk-parallel form sums from each sub-chunk's start and stays
    within it."""
    C, T = 64, 133
    args = _scan_case(T, "strong", seed=11 + sub)
    want_o = np.asarray(ref.rwkv6_scan_ref(*(jnp.asarray(a) for a in args))[0])

    def excess(got):  # how far beyond rtol/atol 1e-4
        return float(np.max(np.abs(got - want_o) - 1e-4 * np.abs(want_o)))

    r, k, v, logw, u, s0 = args
    plain_o = rs.rwkv6_chunked_ref(_bthd(r), _bthd(k), _bthd(v), _bthd(logw), _t(u), _t(s0),
                                   chunk=C)[0].numpy().transpose(0, 2, 1, 3)
    assert excess(_parallel(args, C, sub)[0]) < 1e-4
    assert excess(_pallas_padded(args, C)[0]) > 1e-4
    assert excess(plain_o) > 1e-4


def test_ops_exports_and_resets_the_lm_kernels():
    assert ops.flash_attention is fa.flash_attention
    assert ops.rwkv6_scan is rs.rwkv6_scan and ops.rwkv6_scan_bthd is rs.rwkv6_scan_bthd
    fa.flash_attention.launches = 3
    rs.rwkv6_scan.launches = 2
    ops.reset_launch_counts()
    assert fa.flash_attention.launches == 0 and rs.rwkv6_scan.launches == 0
