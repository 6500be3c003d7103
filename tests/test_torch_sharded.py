"""The port's sharded backend (``repro_torch.launch.train``) against the JAX
package's production round, on the CPU.

The analogues of ``tests/test_sharded_train.py`` and of
``tests/test_weighting.py::test_sharded_partial_matches_engine``: the same
params and numpy batches go through ``repro.api.build(spec)`` (the JAX
sharded round; its fused path runs the Pallas kernel in interpret mode,
as the reference's tests run it off the TPU) and
``repro_torch.api.build(spec, device="cpu")`` (the port's, whose fused path
takes the kernel's plain version on CPU tensors). Partial participation
takes the reference's masks, drawn with its key schedule
(``split(state.rng)`` then ``sample_hfl_masks``), as injected draws.

Tolerance: rtol 1e-5 / atol 1e-6 in float32, the reference's own parity
bound for this round; z and y, being difference quotients of the params,
carry the params' atol through the quotient (ROADMAP queue 3 item 2). The
port's round updates its state in place, so every run starts from a fresh
state.
"""
import dataclasses

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro import api as japi  # noqa: E402
from repro.core.participation import sample_hfl_masks as jmasks  # noqa: E402
from repro_torch import api as tapi  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core.engine import RoundDraws  # noqa: E402
from repro_torch.core.participation import ParticipationMasks  # noqa: E402
from repro_torch.launch.train import make_sharded_round, sharded_init  # noqa: E402

D = 6
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """One intra-op thread: the suite runs files in parallel workers, and
    PyTorch's default of one thread per core would crowd out the other
    workers' (timing-sensitive) tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jquad(params, batch):
    r = batch["a"] * params["w"] - batch["b"]
    return 0.5 * jnp.sum(r * r)


def tquad(params, batch):
    r = batch["a"] * params["w"] - batch["b"]
    return 0.5 * torch.sum(r * r)


def tquad_mean(params, batch):
    r = batch["a"] * params["w"] - batch["b"]
    return 0.5 * torch.mean(torch.sum(r * r, dim=-1))


def _batches(E, H, A, G, K, seed, extra=()):
    """[E, H, A, G, K, *extra, D] quadratic-loss batches (numpy)."""
    rng = np.random.default_rng(seed)
    shape = (E, H, A, G, K) + tuple(extra) + (D,)
    return {"a": rng.normal(size=shape).astype(np.float32) + 2.0,
            "b": rng.normal(size=shape).astype(np.float32)}


def _tb(batches):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batches.items()}


def _specs(levels, E, H, lr=0.05, **kw):
    sched = dict(group_rounds=E, local_steps=H)
    return (japi.ExperimentSpec(levels=levels, backend="sharded", lr=lr,
                                schedule=japi.RoundSchedule(**sched), **kw),
            tapi.ExperimentSpec(levels=levels, backend="sharded", lr=lr,
                                schedule=tapi.RoundSchedule(**sched), **kw))


def _field(x):
    """A state field of either package as {leaf name: numpy}, unpacked."""
    if hasattr(x, "to_tree"):
        x = x.to_tree()
    if isinstance(x, dict) and x and isinstance(next(iter(x.values())), torch.Tensor):
        return convert.to_numpy(x)
    return jax.tree.map(np.asarray, x)


def _assert_states(ts, js, H, E, lr, what=""):
    tol = {"params": ATOL, "z": ATOL / (H * lr), "y": ATOL / (H * E * lr)}
    for name, atol in tol.items():
        got, want = _field(getattr(ts, name)), _field(getattr(js, name))
        for leaf in want:
            np.testing.assert_allclose(got[leaf], want[leaf], rtol=RTOL, atol=atol,
                                       err_msg=f"{what}{name}/{leaf}")


@pytest.mark.parametrize("fusion", ["none", "fused"])
@pytest.mark.parametrize("layout", ["tree", "flat"])
@pytest.mark.parametrize("A", [1, 2])
def test_sharded_round_matches_reference(layout, fusion, A):
    """Three chained rounds, state and every metric against the JAX round."""
    G, K, E, H, lr = 2, 2, 2, 3, 0.05
    batches = _batches(E, H, A, G, K, seed=21 + A)
    jspec, tspec = _specs((G, K), E, H, lr, state_layout=layout, fusion=fusion,
                          fused_mode="interpret" if fusion == "fused" else None)
    tspec = dataclasses.replace(tspec, fused_mode=None)
    jeng = japi.build(dataclasses.replace(
        jspec, schedule=dataclasses.replace(jspec.schedule, microbatches=A)), jquad)
    teng = tapi.build(dataclasses.replace(
        tspec, schedule=dataclasses.replace(tspec.schedule, microbatches=A)), tquad,
        device="cpu")
    js = jeng.init({"w": jnp.zeros(D)})
    ts = teng.init({"w": torch.zeros(D)})
    jb = jax.tree.map(jnp.asarray, batches)
    for r in range(3):
        js, jm = jeng.round_fn(js, jb)
        ts, tm = teng.round_fn(ts, _tb(batches))
        _assert_states(ts, js, H, E, lr, what=f"round {r}: ")
        for f in ("loss", "grad_norm", "z_norm", "y_norm", "participation", "comm_bytes"):
            np.testing.assert_allclose(np.asarray(getattr(tm, f)), np.asarray(getattr(jm, f)),
                                       rtol=RTOL,
                                       err_msg=f"round {r}: metric {f}")


def test_grad_accumulation_is_exact():
    """A chunks of size c == one step on the full A*c batch (mean loss)."""
    G, K, E, H, lr, A, c = 2, 2, 1, 2, 0.05, 4, 3
    b = _batches(E, H, A, G, K, seed=22, extra=(c,))

    def regroup(x):
        return x.transpose(0, 1, 3, 4, 2, 5, 6).reshape(E, H, 1, G, K, A * c, D)

    rf = make_sharded_round(tquad_mean, E=E, H=H, lr=lr, device="cpu")
    st1, _ = rf(sharded_init({"w": torch.zeros(D)}, G, K, device="cpu"), _tb(b))
    st2, _ = rf(sharded_init({"w": torch.zeros(D)}, G, K, device="cpu"),
                _tb({k: regroup(v) for k, v in b.items()}))
    np.testing.assert_allclose(st1.params["w"].numpy(), st2.params["w"].numpy(),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("layout", ["tree", "flat"])
def test_fused_sharded_round_matches_unfused(layout):
    """The fused step (the kernel's plain version on the CPU, g_scale = 1/A)
    computes the unfused round, on both layouts."""
    G, K, E, H, lr, A = 2, 2, 2, 3, 0.05, 2
    b = _tb(_batches(E, H, A, G, K, seed=24))
    rf_ref = make_sharded_round(tquad, E=E, H=H, lr=lr, device="cpu")
    rf_fused = make_sharded_round(tquad, E=E, H=H, lr=lr, use_fused_update=True, device="cpu")
    st_ref = sharded_init({"w": torch.zeros(D)}, G, K, device="cpu")
    st_fused = sharded_init({"w": torch.zeros(D)}, G, K, use_flat_state=layout == "flat",
                            device="cpu")
    for _ in range(3):
        st_ref, m_ref = rf_ref(st_ref, b)
        st_fused, m_fused = rf_fused(st_fused, b)
    for name in ("params", "z", "y"):
        np.testing.assert_allclose(_field(getattr(st_fused, name))["w"],
                                   _field(getattr(st_ref, name))["w"],
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    np.testing.assert_allclose(m_fused.loss.numpy(), m_ref.loss.numpy(), rtol=1e-5)


@pytest.mark.parametrize("algorithm", ["mtgc", "hfedavg"])
def test_flat_sharded_round_matches_tree(algorithm):
    G, K, E, H, lr = 2, 3, 2, 2, 0.05
    b = _tb(_batches(E, H, 1, G, K, seed=25))
    rf = make_sharded_round(tquad, E=E, H=H, lr=lr, algorithm=algorithm, device="cpu")
    st_t = sharded_init({"w": torch.zeros(D)}, G, K, device="cpu")
    st_f = sharded_init({"w": torch.zeros(D)}, G, K, use_flat_state=True, device="cpu")
    for _ in range(3):
        st_t, m_t = rf(st_t, b)
        st_f, m_f = rf(st_f, b)
    for name in ("params", "z", "y"):
        np.testing.assert_allclose(_field(getattr(st_f, name))["w"],
                                   _field(getattr(st_t, name))["w"],
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    np.testing.assert_allclose(m_f.loss.numpy(), m_t.loss.numpy(), rtol=1e-5)


def _bf16_ulps(a, b):
    """|a - b| in bf16 ulps, for float32 arrays of bf16 values (their bf16
    bit patterns in sign-magnitude order)."""
    def ordered(x):
        bits = np.ascontiguousarray(x, np.float32).view(np.int32) >> 16
        return np.where(bits < 0, -(bits & 0x7FFF), bits)
    return np.abs(ordered(a) - ordered(b))


def _to_bf16(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(torch.bfloat16).float().numpy()


def _record_bf16_gap(record_property, tag, got, want):
    """Record, as test properties, the largest difference of two bf16
    arrays in bf16 ulps and the count of entries that differ; return the
    largest."""
    ulps = _bf16_ulps(got, want)
    record_property(f"{tag}_max_bf16_ulps", int(ulps.max()))
    record_property(f"{tag}_entries_differ", int((ulps > 0).sum()))
    return int(ulps.max())


def _check_bf16_correction_cause(record_property, js0, b, G, K, H, lr, tag):
    """Why bf16 z and y are held at one bf16 ulp, from the reference's
    state ``js0`` (bf16 corrections): one group round (E = 1) on both
    sides, and the same round from the same state with z and y widened
    (exactly) to float32. A round updates z and y once each, after the same
    local steps, so the float32 round's z and y are each side's value just
    before its bf16 rounding. Each side stores its own float32 value rounded
    to bf16, and the two float32 values agree to the float32 parity bound
    (ROADMAP queue 3 item 2: a few float32 ulps, carried through the
    quotients 1/(H lr) and 1/(H E lr)). So the stored values can differ only
    where those float32 values lie on either side of a bf16 rounding
    midpoint, by one bf16 ulp: the port's update is the reference's."""
    host = lambda t: jax.tree.map(np.asarray, t)                    # noqa: E731
    widen = lambda t: jax.tree.map(lambda a: a.astype(np.float32), t)  # noqa: E731
    b1 = {k: v[:1] for k, v in b.items()}
    vals = {}
    for cdt in ("bfloat16", None):
        jspec, tspec = _specs((G, K), 1, H, lr, state_layout="tree", correction_dtype=cdt)
        jeng, teng = japi.build(jspec, jquad), tapi.build(tspec, tquad, device="cpu")
        z, y = host(js0.z), host(js0.y)
        if cdt is None:
            z, y = widen(z), widen(y)
        js, _ = jeng.round_fn(js0._replace(z=jax.tree.map(jnp.asarray, z),
                                           y=jax.tree.map(jnp.asarray, y)),
                              jax.tree.map(jnp.asarray, b1))
        ts, _ = teng.round_fn(
            convert.sharded_state_from_numpy(host(js0.params), z, y, device="cpu"), _tb(b1))
        for name in ("z", "y"):
            vals[(cdt, name)] = (_field(getattr(ts, name))["w"].astype(np.float32),
                                 np.asarray(getattr(js, name)["w"], np.float32))
    for name, atol in (("z", ATOL / (H * lr)), ("y", ATOL / (H * lr))):
        (pb, rb), (pf, rf) = vals[("bfloat16", name)], vals[(None, name)]
        assert np.array_equal(_to_bf16(pf), pb) and np.array_equal(_to_bf16(rf), rb), name
        np.testing.assert_allclose(pf, rf, rtol=RTOL, atol=atol, err_msg=name)
        record_property(f"{tag}_{name}_float32_entries_differ", int((pf != rf).sum()))
        assert _record_bf16_gap(record_property, f"{tag}_{name}", pb, rb) <= 1, name


def test_correction_dtype_is_stored_narrow_and_rejected_for_flat(record_property):
    """bf16 z/y storage survives the round (update math in f32), matches the
    reference's bf16 round, and the flat layout rejects it."""
    G, K, E, H, lr = 2, 2, 1, 2, 0.05
    b = _batches(E, H, 1, G, K, seed=26)
    st = sharded_init({"w": torch.zeros(D)}, G, K, correction_dtype="bfloat16", device="cpu")
    assert st.z["w"].dtype == torch.bfloat16 and st.y["w"].dtype == torch.bfloat16
    rf = make_sharded_round(tquad, E=E, H=H, lr=lr, device="cpu")
    st, m = rf(st, _tb(b))
    assert st.z["w"].dtype == torch.bfloat16 and st.y["w"].dtype == torch.bfloat16
    assert np.isfinite(m.loss.numpy()).all()
    jspec, _ = _specs((G, K), E, H, lr, state_layout="tree", correction_dtype="bfloat16")
    jeng = japi.build(jspec, jquad)
    js0 = jeng.init({"w": jnp.zeros(D)})
    js, _ = jeng.round_fn(js0, jax.tree.map(jnp.asarray, b))
    # One bf16 ulp (2^-8 relative) of the stored corrections: each side
    # rounds its own float32 value, and those differ by float32 rounding
    # (_check_bf16_correction_cause shows it on this round).
    for name in ("z", "y"):
        got = _field(getattr(st, name))["w"].astype(np.float32)
        want = np.asarray(getattr(js, name)["w"], np.float32)
        np.testing.assert_allclose(got, want, rtol=2.0 ** -8, atol=1e-6, err_msg=name)
        assert _record_bf16_gap(record_property, name, got, want) <= 1, name
    np.testing.assert_allclose(st.params["w"].numpy(), np.asarray(js.params["w"]),
                               rtol=RTOL, atol=ATOL)
    _check_bf16_correction_cause(record_property, js0, b, G, K, H, lr, "cause")
    with pytest.raises(ValueError, match="tree layout"):
        sharded_init({"w": torch.zeros(D)}, G, K, use_flat_state=True,
                     correction_dtype=torch.bfloat16, device="cpu")


def test_fused_sharded_rejected_for_hfedavg():
    with pytest.raises(ValueError, match="mtgc only"):
        make_sharded_round(tquad, E=1, H=1, lr=0.1, algorithm="hfedavg",
                           use_fused_update=True, device="cpu")


def test_hfedavg_mode_drops_corrections():
    G, K, E, H = 2, 2, 2, 2
    rf = make_sharded_round(tquad, E=E, H=H, lr=0.05, algorithm="hfedavg", device="cpu")
    st, _ = rf(sharded_init({"w": torch.zeros(D)}, G, K, device="cpu"),
               _tb(_batches(E, H, 1, G, K, seed=23)))
    assert not st.z["w"].any() and not st.y["w"].any()


def _reference_masks(key, rounds, G, K, cp, gp, mode):
    """The reference round's masks: ``mkey, rng = split(rng)`` per round."""
    out = []
    for _ in range(rounds):
        mkey, key = jax.random.split(key)
        m = jmasks(mkey, G, K, cp, gp, mode)
        out.append(ParticipationMasks(torch.from_numpy(np.asarray(m.group)),
                                      torch.from_numpy(np.asarray(m.client))))
    return out


@pytest.mark.parametrize("weighting", ["none", "inverse_prob"])
@pytest.mark.parametrize("layout", ["tree", "flat"])
@pytest.mark.parametrize("fusion", ["none", "fused"])
def test_sharded_partial_matches_reference(weighting, layout, fusion):
    """Partial participation (Bernoulli clients and groups), four rounds,
    the reference's masks injected: state and metrics against the JAX
    sharded round."""
    G, K, E, H, lr, rounds = 2, 3, 2, 2, 0.05, 4
    kw = dict(client_participation=0.5, group_participation=0.75,
              participation_mode="uniform", participation_weighting=weighting)
    b = _batches(E, H, 1, G, K, seed=21)
    jspec, tspec = _specs((G, K), E, H, lr, state_layout=layout, fusion=fusion, **kw)
    if fusion == "fused":
        jspec = dataclasses.replace(jspec, fused_mode="interpret")
    jeng, teng = japi.build(jspec, jquad), tapi.build(tspec, tquad, device="cpu")
    key = jax.random.PRNGKey(3)
    js = jeng.init({"w": jnp.zeros(D)}, key)
    ts = teng.init({"w": torch.zeros(D)})
    jb = jax.tree.map(jnp.asarray, b)
    for r, masks in enumerate(_reference_masks(key, rounds, G, K, 0.5, 0.75, "uniform")):
        js, jm = jeng.round_fn(js, jb)
        ts, tm = teng.round_fn(ts, _tb(b), draws=RoundDraws(masks=masks))
        _assert_states(ts, js, H, E, lr, what=f"round {r}: ")
        for f in ("loss", "participation", "comm_bytes"):
            np.testing.assert_allclose(np.asarray(getattr(tm, f)), np.asarray(getattr(jm, f)),
                                       rtol=RTOL, err_msg=f"round {r}: metric {f}")


def test_sharded_matches_simulator_at_one_microbatch():
    """At A = 1 the port's production round is the port's simulator round
    (mtgc, tree and flat), state for state."""
    G, K, E, H, lr = 2, 3, 2, 2, 0.05
    b = _batches(E, H, 1, G, K, seed=27)
    for layout in ("tree", "flat"):
        sim = tapi.build(tapi.ExperimentSpec(
            levels=(G, K), lr=lr, state_layout=layout,
            schedule=tapi.RoundSchedule(group_rounds=E, local_steps=H)), tquad, device="cpu")
        shd = tapi.build(tapi.ExperimentSpec(
            levels=(G, K), lr=lr, state_layout=layout, backend="sharded",
            schedule=tapi.RoundSchedule(group_rounds=E, local_steps=H, microbatches=1)),
            tquad, device="cpu")
        s1, s2 = sim.init({"w": torch.zeros(D)}), shd.init({"w": torch.zeros(D)})
        for _ in range(2):
            s1, m1 = sim.round_fn(s1, {k: v[:, :, 0] for k, v in _tb(b).items()})
            s2, m2 = shd.round_fn(s2, _tb(b))
        for name in ("params", "z", "y"):
            np.testing.assert_allclose(_field(getattr(s2, name))["w"],
                                       _field(getattr(s1, name))["w"],
                                       rtol=RTOL, atol=ATOL, err_msg=f"{layout}/{name}")
        np.testing.assert_allclose(m2.loss.numpy(), m1.loss.numpy(), rtol=RTOL)


@pytest.mark.parametrize("layout,cdt", [("tree", "bfloat16"), ("flat", None)])
def test_rounds_continue_from_a_reference_state(record_property, layout, cdt):
    """``convert.sharded_state_from_numpy`` starts the port from the
    reference's state after one of its rounds (narrow corrections cross bit
    for bit); the next round agrees."""
    G, K, E, H, lr = 2, 2, 2, 2, 0.05
    b = _batches(E, H, 1, G, K, seed=28)
    jspec, tspec = _specs((G, K), E, H, lr, state_layout=layout, correction_dtype=cdt)
    jeng, teng = japi.build(jspec, jquad), tapi.build(tspec, tquad, device="cpu")
    jb = jax.tree.map(jnp.asarray, b)
    js, _ = jeng.round_fn(jeng.init({"w": jnp.linspace(-1.0, 1.0, D)}), jb)

    def host(f):
        return ({k: np.asarray(v) for k, v in f.bufs.items()} if hasattr(f, "bufs")
                else jax.tree.map(np.asarray, f))

    ts = convert.sharded_state_from_numpy(
        host(js.params), host(js.z), host(js.y), device="cpu",
        template={"w": np.zeros(D, np.float32)} if layout == "flat" else None)
    if cdt is not None:
        assert ts.z["w"].dtype == torch.bfloat16
        np.testing.assert_array_equal(ts.z["w"].float().numpy(),
                                      np.asarray(js.z["w"], np.float32))
    js1 = js
    js, _ = jeng.round_fn(js, jb)
    ts, _ = teng.round_fn(ts, _tb(b))
    if cdt is None:
        _assert_states(ts, js, H, E, lr)
    else:
        # One bf16 ulp of the stored corrections, for the reason that
        # _check_bf16_correction_cause shows from the reference's state.
        for name in ("z", "y"):
            got = _field(getattr(ts, name))["w"].astype(np.float32)
            want = np.asarray(getattr(js, name)["w"], np.float32)
            np.testing.assert_allclose(got, want, rtol=2.0 ** -8, atol=1e-6, err_msg=name)
            assert _record_bf16_gap(record_property, name, got, want) <= 1, name
        _check_bf16_correction_cause(record_property, js1, b, G, K, H, lr, "cause")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dim", [0, 1])
def test_piecewise_mean_equals_torch_mean(monkeypatch, dtype, dim):
    """The round's group and global means, taken in pieces of the trailing
    elements (so a narrow state never gets a float32 buffer of the whole
    output), equal ``torch.mean`` bit for bit: on a [G, K, ...] leaf over
    axis 1, and over axis 0 of its strided ``[:, 0]`` view (the global
    mean's input). Small pieces force many of them."""
    from repro_torch.launch import train

    monkeypatch.setattr(train, "_CHUNK", 64)
    gen = torch.Generator().manual_seed(dim)
    x = torch.randn((3, 4, 7, 11), generator=gen).to(dtype)
    src = x if dim == 1 else x[:, 0]
    assert torch.equal(train._mean(src, dim), torch.mean(src, dim=dim))
