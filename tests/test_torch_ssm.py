"""The hybrid family's selective SSM (``repro_torch.models.ssm`` and
``kernels/ssm_scan.py``) against the JAX package's ``repro.models.ssm`` on
the CPU.

* ``init_ssm``: leaf names, shapes and dtypes (``log_a`` and ``d_skip``
  float32 whatever the param dtype) and the values of ``log_a``/``d_skip``;
* the gates: u, dt, B and C, and the reference's ``decay``/``drive`` formed
  from them;
* ``selective_scan_ref`` (the plain sequential loop that the wrapper runs on
  a CPU tensor) against the reference's chunked ``associative_scan``, read
  through ``ssm_parallel`` with ``wout`` the identity, over ragged T, T
  above the chunk, one token, and a nonzero state; and against a float64
  sequential oracle at weak and strong decays;
* ``ssm_parallel`` then ``ssm_step`` in float32 and bfloat16.

Tolerances. float32: rtol 1e-5 / atol 1e-5 of the largest entry for the
scan alone (both sides sum the same terms; the associative scan multiplies
decays in a tree where the loop goes token by token, a few ulps);
``ssm_parallel``/``ssm_step`` at the LM tests' rtol 1e-4 / atol 1e-5 (the
gates' products reorder sums). bfloat16: within four bf16 ulps of the
largest entry, as the LM's bf16 parity is held
(``test_torch_lm_models.py``; ROADMAP queue 3 item 5): a projection that
rounds the other way in one package moves u, dt, B or C by a bf16 ulp.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import ssm as JS  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.kernels import ssm_scan as ss  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402
from torch_devices import other_device  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """One intra-op thread: the suite runs files in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _params(seed, D, Di, S, dtype=jnp.float32, identity_out=False):
    jp = JS.init_ssm(jax.random.PRNGKey(seed), D, Di, S, dtype)
    # Nonzero dt biases and d_skip, and log_a away from its init's pattern.
    rng = np.random.default_rng(seed)
    jp["wdt"]["b"] = jnp.asarray(rng.normal(size=(Di,)) * 0.5, dtype)
    jp["d_skip"] = jnp.asarray(1.0 + 0.1 * rng.normal(size=(Di,)), jnp.float32)
    jp["log_a"] = jp["log_a"] + jnp.asarray(0.2 * rng.normal(size=(Di, S)), jnp.float32)
    if identity_out:
        assert Di == D
        jp["wout"]["w"] = jnp.eye(D, dtype=dtype)
    return jp, convert.params_from_numpy(_np(jp), "cpu")


def _close(got, want, rtol, atol_rel, tag=""):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(convert.to_numpy(got).astype(np.float32), want, rtol=rtol,
                               atol=atol_rel * float(np.max(np.abs(want))), err_msg=tag)


def _bf16_close(got, want, tag=""):
    """Within four bf16 ulps of the largest entry (module docstring)."""
    want = np.asarray(want, np.float32)
    top = float(np.max(np.abs(want)))
    np.testing.assert_allclose(convert.to_numpy(got).astype(np.float32), want, rtol=0,
                               atol=4 * 2.0 ** (np.floor(np.log2(top)) - 7), err_msg=tag)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_init_ssm_matches_reference_tree(dtype):
    jp = JS.init_ssm(jax.random.PRNGKey(0), 48, 80, 16, dtype)
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    tp = TS.init_ssm(torch.Generator().manual_seed(0), 48, 80, 16, tdt, "cpu")
    want = jax.tree_util.tree_flatten_with_path(jp)[0]
    got = jax.tree_util.tree_flatten_with_path(tp, is_leaf=torch.is_tensor)[0]
    assert [(jax.tree_util.keystr(p), tuple(a.shape), str(a.dtype).removeprefix("torch."))
            for p, a in got] == \
        [(jax.tree_util.keystr(p), a.shape, str(a.dtype)) for p, a in want]
    assert tp["log_a"].dtype == torch.float32 and tp["d_skip"].dtype == torch.float32
    np.testing.assert_allclose(tp["log_a"].numpy(), np.asarray(jp["log_a"]), rtol=1e-7)
    np.testing.assert_array_equal(tp["d_skip"].numpy(), np.asarray(jp["d_skip"]))


def test_gates_match_reference():
    jp, tp = _params(1, 32, 48, 16)
    x = np.random.default_rng(1).normal(size=(2, 9, 32)).astype(np.float32)
    ju, jdec, jdrv, jcm = JS._gates(jp, jnp.asarray(x))
    u, dt, Bm, Cm = TS._gates(tp, torch.from_numpy(x))
    A = -torch.exp(tp["log_a"])
    decay = torch.exp(dt[..., None] * A)
    drive = (dt * u)[..., None] * Bm[:, :, None, :]
    for got, want, tag in ((u, ju, "u"), (Cm, jcm, "C"), (decay, jdec, "decay"),
                           (drive, jdrv, "drive")):
        _close(got, want, 1e-5, 1e-6, tag)


def _oracle(u, dt, Bm, Cm, log_a, d_skip, s0):
    """The recurrence in float64, token by token."""
    u, dt, Bm, Cm, log_a, d_skip, s0 = (np.asarray(a, np.float64)
                                        for a in (u, dt, Bm, Cm, log_a, d_skip, s0))
    A, h, ys = -np.exp(log_a), s0.copy(), []
    for t in range(u.shape[1]):
        h = np.exp(dt[:, t, :, None] * A) * h + (dt[:, t] * u[:, t])[:, :, None] * Bm[:, t, None]
        ys.append(np.einsum("bds,bs->bd", h, Cm[:, t]) + d_skip * u[:, t])
    return np.stack(ys, 1), h


@pytest.mark.parametrize("T,chunk", [(1, 2048), (37, 2048), (21, 8), (32, 16), (50, 16)])
def test_scan_matches_reference_associative_scan(T, chunk):
    """The plain loop against the reference's chunked associative scan (T
    ragged, above the chunk and padded, a chunk multiple, one token), from
    a nonzero state: with ``wout`` the identity the reference's
    ``ssm_parallel`` returns y itself."""
    D = S = 16
    jp, tp = _params(T + chunk, D, D, S, identity_out=True)
    rng = np.random.default_rng(T)
    x = rng.normal(size=(2, T, D)).astype(np.float32)
    s0 = rng.normal(size=(2, D, S)).astype(np.float32)
    jy, js = JS.ssm_parallel(jp, jnp.asarray(x), jnp.asarray(s0), chunk=chunk)
    u, dt, Bm, Cm = TS._gates(tp, torch.from_numpy(x))
    before = ss.selective_scan.launches
    y, st = ss.selective_scan(u, dt, Bm, Cm, tp["log_a"], tp["d_skip"], torch.from_numpy(s0))
    assert ss.selective_scan.launches == before            # CPU tensors: the plain version
    assert y.dtype == st.dtype == torch.float32 and tuple(y.shape) == (2, T, D)
    _close(y, jy, 1e-5, 1e-5, "y")
    _close(st, js, 1e-5, 1e-5, "state")


@pytest.mark.parametrize("shift", [0.0, -6.0])
def test_scan_matches_float64_oracle(shift):
    """Strong decays (dt ~ softplus(N(0, 1))) and weak ones (dt ~
    softplus(N(-6, 1)), a memory of hundreds of tokens), u in float32 and
    in bfloat16, against the float64 recurrence."""
    rng = np.random.default_rng(int(-shift))
    B, T, Di, S = 2, 300, 24, 16
    dt = np.log1p(np.exp(rng.normal(size=(B, T, Di)) + shift)).astype(np.float32)
    Bm, Cm = (rng.normal(size=(B, T, S)).astype(np.float32) for _ in range(2))
    log_a = np.log(np.linspace(1.0, S, S, dtype=np.float32))[None] + np.zeros((Di, S), np.float32)
    d_skip = (1.0 + 0.1 * rng.normal(size=(Di,))).astype(np.float32)
    s0 = rng.normal(size=(B, Di, S)).astype(np.float32)
    u = torch.from_numpy(rng.normal(size=(B, T, Di)).astype(np.float32))
    for uu in (u, u.bfloat16()):
        args = [torch.from_numpy(a) for a in (dt, Bm, Cm, log_a, d_skip, s0)]
        y, st = ss.selective_scan_ref(uu, *args)
        wy, ws = _oracle(uu.float().numpy(), dt, Bm, Cm, log_a, d_skip, s0)
        _close(y, wy, 1e-5, 1e-6, f"y {uu.dtype}")
        _close(st, ws, 1e-5, 1e-6, f"state {uu.dtype}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,chunk", [(13, 2048), (21, 8)])
def test_ssm_parallel_then_step_match_reference(dtype, T, chunk):
    """``ssm_parallel`` (ragged T; T above the chunk) from a nonzero state,
    then three ``ssm_step`` calls from the state it returns."""
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    D, Di, S = 32, 48, 16
    jp, tp = _params(3, D, Di, S, jdt)
    rng = np.random.default_rng(T)
    x = jnp.asarray(rng.normal(size=(2, T, D)), jdt)
    s0 = rng.normal(size=(2, Di, S)).astype(np.float32)
    jo, js = JS.ssm_parallel(jp, x, jnp.asarray(s0), chunk=chunk)
    to, ts = TS.ssm_parallel(tp, convert.tensor_from_numpy(np.asarray(x), "cpu"),
                             torch.from_numpy(s0), chunk=chunk)
    assert to.dtype == getattr(torch, dtype) and ts.dtype == torch.float32

    def check(got, want, tag):
        if dtype == "float32":
            _close(got, want, 1e-4, 1e-5, tag)
        else:
            _bf16_close(got, want, tag)

    check(to, jo, "parallel out")
    check(ts, js, "parallel state")
    for i in range(3):
        xt = jnp.asarray(rng.normal(size=(2, D)), jdt)
        jo, js = JS.ssm_step(jp, xt, js)
        to, ts = TS.ssm_step(tp, convert.tensor_from_numpy(np.asarray(xt), "cpu"), ts)
        check(to, jo, f"step {i} out")
        check(ts, js, f"step {i} state")


def test_scan_wrapper_routes_by_device():
    """A CPU tensor takes the plain version, whatever its length (T = 0
    returns the state); a device other than cpu or cuda is refused."""
    z = torch.zeros(1, 0, 4)
    y, st = ss.selective_scan(z, z, torch.zeros(1, 0, 2), torch.zeros(1, 0, 2),
                              torch.zeros(4, 2), torch.ones(4), torch.ones(1, 4, 2))
    assert tuple(y.shape) == (1, 0, 4) and torch.equal(st, torch.ones(1, 4, 2))
    other = other_device(1, 2, 4)
    with pytest.raises(ValueError, match="cpu or cuda"):
        ss.selective_scan(other, other, other, other, other, other, other)
    y, st = ss.selective_scan(*(torch.zeros(s, device="meta") for s in (
        (1, 2, 4), (1, 2, 4), (1, 2, 3), (1, 2, 3), (4, 3), (4,), (1, 4, 3))))
    assert y.shape == (1, 2, 4) and st.shape == (1, 4, 3) and y.device.type == "meta"
