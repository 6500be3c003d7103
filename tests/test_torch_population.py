"""The port's virtual client populations (``repro_torch.core.population``)
against the JAX package's (``repro.core.population``), on the CPU: one case
for each test of ``tests/test_population.py``.

JAX's cohort draws (``split(state.rng)`` per chunk, then
``draw_cohort``'s per-group ``choice``) and its shard draws cannot be
replayed in PyTorch, so the parity cases compute them with JAX
(:func:`reference_cohorts`, ``test_torch_driver.reference_shard_ids``) and
inject them into the port's ``run_population_rounds(cohorts=,
shard_ids=)``. Tolerance against the reference: rtol 1e-5 / atol 1e-6 in
float32, z's atol carried through its difference quotient 1 / (H lr)
(ROADMAP queue 3 item 2). Port against port (the degenerate ``P == K``
cases, overlapped against sequential, the stateless contract): bit for
bit. The sharded round updates its state in place, so every run starts
from a fresh state.
"""
from typing import Any, NamedTuple

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro import api as japi  # noqa: E402
from repro.core import PackedBatches as JPackedBatches  # noqa: E402
from repro.core.packer import FlatBuffers as JFlatBuffers  # noqa: E402
from repro.core.population import PopulationStore as JStore  # noqa: E402
from repro.core.population import run_population_rounds as jrun  # noqa: E402
from repro_torch import api as tapi  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core.driver import PackedBatches, select_round  # noqa: E402
from repro_torch.core.packer import FlatBuffers, is_flat, make_packer  # noqa: E402
from repro_torch.core.population import (  # noqa: E402
    PopulationStore,
    draw_cohort,
    population_fields,
    run_population_rounds,
)
from test_torch_driver import reference_shard_ids  # noqa: E402

G, K, E, H, D, S = 2, 3, 2, 2, 6, 4
LR = 0.05
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """One intra-op thread: the suite runs files in parallel workers."""
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


def _arrays(K_=K, microbatches=None, seed=0):
    rng = np.random.default_rng(seed)
    shape = (G, K_, S, H * (microbatches or 1), D)
    return {"a": rng.normal(size=shape).astype(np.float32) + 2.0,
            "b": rng.normal(size=shape).astype(np.float32)}


def tdata(K_=K, microbatches=None, seed=0, gen_seed=1):
    arrays = {k: torch.from_numpy(v) for k, v in _arrays(K_, microbatches, seed).items()}
    return PackedBatches(arrays, torch.Generator().manual_seed(gen_seed), E, H, microbatches)


def jdata(K_=K, microbatches=None, seed=0, key=1):
    arrays = {k: jnp.asarray(v) for k, v in _arrays(K_, microbatches, seed).items()}
    return JPackedBatches(arrays, jax.random.PRNGKey(key), E, H, microbatches)


def _spec_kw(population=None, *, algorithm="mtgc", layout="flat", backend="simulator",
             levels=(G, K), **kw):
    mb = 1 if backend == "sharded" else None
    return dict(levels=levels, algorithm=algorithm, lr=LR, state_layout=layout,
                backend=backend, population=population, microbatches=mb, **kw)


def tbuild(population=None, **kw):
    kw = _spec_kw(population, **kw)
    sched = tapi.RoundSchedule(group_rounds=E, local_steps=H, microbatches=kw.pop("microbatches"))
    return tapi.build(tapi.ExperimentSpec(schedule=sched, **kw), tquad, device="cpu")


def jbuild(population=None, **kw):
    kw = _spec_kw(population, **kw)
    sched = japi.RoundSchedule(group_rounds=E, local_steps=H, microbatches=kw.pop("microbatches"))
    return japi.build(japi.ExperimentSpec(schedule=sched, **kw), jquad)


def reference_cohorts(rng, num_draws, P, K_=K):
    """``[num_draws, G, K]`` cohorts exactly as the reference draws them
    (``ckey, rng = split(rng)``, then ``draw_cohort(ckey, ...)``)."""
    from repro.core.population import draw_cohort as jdraw

    out = []
    for _ in range(num_draws):
        ckey, rng = jax.random.split(rng)
        out.append(jdraw(ckey, G, P, K_))
    return np.stack(out)


def _fields(state):
    return {f: v for f, v in convert.to_numpy(state).items() if f in ("params", "z", "y", "dyn")}


def assert_states_equal(a, b, tag):
    fa, fb = convert.to_numpy(a), convert.to_numpy(b)
    assert fa.keys() == fb.keys(), tag

    def walk(x, y, t):
        if isinstance(x, dict):
            assert x.keys() == y.keys(), t
            for k in x:
                walk(x[k], y[k], f"{t}.{k}")
        else:
            np.testing.assert_array_equal(x, y, err_msg=t)

    walk(fa, fb, tag)


def assert_stores_equal(a: PopulationStore, b: PopulationStore, tag):
    assert a.fields == b.fields, tag
    for f in a.fields:
        for key in a.data[f]:
            np.testing.assert_array_equal(a.data[f][key], b.data[f][key], err_msg=f"{tag}[{f}]")


def _jnumpy(value):
    """A reference state field as nested numpy (FlatBuffers by dtype key)."""
    if isinstance(value, JFlatBuffers):
        return {k: np.asarray(v) for k, v in value.bufs.items()}
    return jax.tree.map(np.asarray, value)


def assert_matches_reference(tstate, jstate, tag):
    atol = {"z": ATOL / (H * LR), "y": ATOL / (H * E * LR), "dyn": ATOL / (H * LR)}
    got = _fields(tstate)
    for f, want in got.items():
        ref = _jnumpy(getattr(jstate, f))

        def walk(x, y, t):
            if isinstance(x, dict):
                for k in x:
                    walk(x[k], y[k], f"{t}.{k}")
            else:
                np.testing.assert_allclose(x, np.asarray(y, np.float32), rtol=RTOL,
                                           atol=atol.get(f, ATOL), err_msg=t)

        walk(want, ref, f"{tag}.{f}")


# ---------------------------------------------------------------- degenerate


@pytest.mark.parametrize("algorithm,layout,backend", [
    (a, lay, b) for a in ("mtgc", "hfedavg", "feddyn") for lay in ("tree", "flat")
    for b in ("simulator", "sharded") if not (b == "sharded" and a == "feddyn")])
def test_degenerate_bitexact_vs_materialized(algorithm, layout, backend):
    """population == cohort == K: the port's cohort path gives the port's
    materialized states and metrics bit for bit, and the store holds exactly
    the final corrections, identity-mapped (feddyn is simulator-only, the
    reference's table)."""
    mb = 1 if backend == "sharded" else None
    kw = dict(algorithm=algorithm, layout=layout, backend=backend)
    base, virt = tbuild(**kw), tbuild(K, cohort_size=K, **kw)
    p = {"w": torch.ones(D)}
    s0, hz0 = tapi.fit(base, tdata(microbatches=mb), 4, params=p, chunk=2)
    s1, hz1 = tapi.fit(virt, tdata(microbatches=mb), 4, params=p, chunk=2)
    assert hz0.population is None and isinstance(hz1.population, PopulationStore)
    assert_states_equal(s0, s1, f"{algorithm}/{layout}/{backend} state")
    for name, a, b in zip(hz0.metrics._fields, hz0.metrics, hz1.metrics):
        np.testing.assert_array_equal(a, b, err_msg=f"metrics.{name}")
    store = hz1.population
    assert store.fields == tuple(f for f in virt.population_fields
                                 if getattr(s1, f, None) is not None)
    for f in store.fields:
        value = getattr(s1, f)
        flat = value if is_flat(value) else store.packers[f].flatten(value)
        for key, buf in flat.bufs.items():
            np.testing.assert_array_equal(store.data[f][key], buf.numpy(),
                                          err_msg=f"store[{f}][{key}]")


@pytest.mark.parametrize("participation", [{"client_participation": 0.5},
                                           {"group_participation": 0.5},
                                           {"client_participation": 0.5,
                                            "group_participation": 0.5}])
def test_degenerate_bitexact_partial_participation(participation):
    """Partial in-round participation is legal at P == K and stays exact."""
    p = {"w": torch.ones(D)}
    s0, _ = tapi.fit(tbuild(**participation), tdata(), 4, params=p,
                     rng=torch.Generator().manual_seed(3), chunk=2)
    s1, hz = tapi.fit(tbuild(K, **participation), tdata(), 4, params=p,
                      rng=torch.Generator().manual_seed(3), chunk=2)
    assert_states_equal(s0, s1, f"partial {participation} state")
    assert isinstance(hz.population, PopulationStore)


# --------------------------------------------------------------- reference


@pytest.mark.parametrize("overlap", [True, False])
def test_population_rounds_match_reference(overlap):
    """P = 7 over K = 3, three chunks of 2: the port's
    ``run_population_rounds`` against the reference's, the reference's
    cohorts and shard ids injected, state and store at rtol 1e-5; a client
    drawn in chunk 0 that sits out chunk 1 keeps its row bit for bit."""
    P, T, chunk = 7, 6, 2
    jeng = jbuild(P)
    jstate = jeng.init({"w": jnp.ones(D)}, jax.random.PRNGKey(11))
    cohorts = reference_cohorts(jstate.rng, T // chunk, P)
    jstore = jeng.init_population(jstate)
    jout, _, jhz = jrun(jeng.round_fn, jstate, jstore, jdata(), T, chunk=chunk, overlap=overlap)
    sids = reference_shard_ids(jax.random.PRNGKey(1), T, E, G, K, S)

    def port(T_):
        eng = tbuild(P)
        state = eng.init({"w": torch.ones(D)})
        store = eng.init_population(state)
        out, _, hz = run_population_rounds(eng.round_fn, state, store, tdata(), T_, chunk=chunk,
                                           overlap=overlap, cohorts=cohorts[:T_ // chunk],
                                           shard_ids=sids[:T_])
        assert hz.population is store
        return out, store

    out, store = port(T)
    assert_matches_reference(out, jout, "state")
    want = convert.store_from_reference(jhz.population)
    for key, buf in store.data["z"].items():
        np.testing.assert_allclose(buf, want.data["z"][key], rtol=RTOL, atol=ATOL / (H * LR),
                                   err_msg=f"store[{key}]")
    # Persistence across absence, port against port.
    _, one = port(chunk)
    _, two = port(2 * chunk)
    checked = 0
    for g in range(G):
        for c in set(cohorts[0, g].tolist()) - set(cohorts[1, g].tolist()):
            np.testing.assert_array_equal(two.data["z"]["float32"][g, c],
                                          one.data["z"]["float32"][g, c],
                                          err_msg=f"client ({g},{c}) lost its correction")
            checked += 1
    assert checked > 0
    # Clients never drawn keep their zero rows.
    drawn = np.zeros((G, P), bool)
    for c in cohorts:
        drawn[np.arange(G)[:, None], c] = True
    assert not store.data["z"]["float32"][~drawn].any()


def test_overlap_matches_sequential_with_shared_clients():
    """P = 5 over K = 4, chunk 1: consecutive cohorts share clients, so the
    overlapped pre-gather goes stale and ``refresh`` patches it; bit for
    bit the sequential order, state and store."""
    P, T = 5, 6
    runs = {}
    for overlap in (True, False):
        eng = tbuild(P, levels=(G, 4))
        state = eng.init({"w": torch.ones(D)})
        store = eng.init_population(state, torch.Generator().manual_seed(5))
        out, _, _ = run_population_rounds(eng.round_fn, state, store, tdata(4), T, chunk=1,
                                          overlap=overlap)
        runs[overlap] = (out, store)
    assert_states_equal(runs[True][0], runs[False][0], "overlap state")
    assert_stores_equal(runs[True][1], runs[False][1], "overlap store")
    gen = torch.Generator().manual_seed(5)
    draws = [draw_cohort(gen, G, P, 4) for _ in range(T)]
    assert any(np.isin(a[g], b[g]).any() for a, b in zip(draws, draws[1:]) for g in range(G))
    assert runs[True][1].seconds["refresh"] > 0.0


# ----------------------------------------------------------------- stateless


def test_stateless_zeroes_corrections_each_round():
    """client_state='stateless' is zeroing z before every round by hand
    (port against port, bit for bit), and matches the reference's stateless
    round (rtol 1e-5)."""
    base, stateless = tbuild(), tbuild(K, client_state="stateless")
    jless = jbuild(K, client_state="stateless")
    p = {"w": torch.ones(D)}
    s_base, s_less = base.init(p), stateless.init(p)
    j_less = jless.init({"w": jnp.ones(D)})
    data = tdata()
    for r in range(3):
        sid = torch.randint(0, S, (E, G, K), generator=torch.Generator().manual_seed(100 + r))
        batches = select_round(data, sid)
        zeroed = s_base._replace(z=FlatBuffers({k: torch.zeros_like(v) for k, v in
                                                s_base.z.bufs.items()}, s_base.z.packer))
        s_base = base.round_fn(zeroed, batches)[0]
        s_less = stateless.round_fn(s_less, batches)[0]
        assert_states_equal(s_base, s_less, f"stateless round {r}")
        j_less = jless.round_fn(j_less, {k: jnp.asarray(v.numpy()) for k, v in batches.items()})[0]
        assert_matches_reference(s_less, j_less, f"reference stateless round {r}")


def test_stateless_fit_has_no_store():
    engine = tbuild(K, client_state="stateless")
    _, hz = tapi.fit(engine, tdata(), 3, params={"w": torch.ones(D)})
    assert hz.population is None
    with pytest.raises(ValueError, match="no store"):
        engine.init_population(engine.init({"w": torch.ones(D)}))


# ---------------------------------------------------------------- validation


@pytest.mark.parametrize("kw, match", [
    (dict(client_state="ephemeral"), "unknown client_state"),
    (dict(cohort_size=K), "set population too"),
    (dict(client_state="stateless"), "virtual-population contract"),
    (dict(population=0), "must be >= 1"),
    (dict(population=2 * K, levels=(G, K, 2), backend="multilevel"), "two-level"),
    (dict(population=2 * K, backend="multilevel"), "multilevel backend"),
    (dict(population=2 * K, cohort_size=K + 1), "must equal levels"),
    (dict(population=K - 1), "sampled without replacement"),
    (dict(population=2 * K, client_participation=0.5), "participation mechanism"),
    (dict(population=2 * K, group_participation=0.5), "participation mechanism"),
], ids=["client-state", "cohort-alone", "stateless-alone", "zero", "three-level", "multilevel",
        "cohort-mismatch", "too-small", "client-participation", "group-participation"])
def test_validate_rejects_contradictions(kw, match):
    """The reference's rejections (its test's cases and patterns), with the
    reference's own messages (the three-level spec fails the multilevel
    schedule check, "... only define the two-level schedule", before the
    population rules, in both packages)."""
    base = dict(levels=(G, K), algorithm="mtgc", lr=LR)
    with pytest.raises(ValueError, match=match) as want:
        japi.ExperimentSpec(schedule=japi.RoundSchedule(group_rounds=E, local_steps=H),
                            **{**base, **kw}).validate()
    with pytest.raises(ValueError, match=match) as got:
        tapi.ExperimentSpec(schedule=tapi.RoundSchedule(group_rounds=E, local_steps=H),
                            **{**base, **kw}).validate()
    assert str(got.value) == str(want.value)


def test_validate_accepts_virtual_combinations():
    for kw in (dict(population=100), dict(population=K), dict(population=100, cohort_size=K),
               dict(population=100, client_state="stateless")):
        spec = tapi.ExperimentSpec(levels=(G, K), algorithm="mtgc", lr=LR,
                                   schedule=tapi.RoundSchedule(group_rounds=E, local_steps=H),
                                   **kw)
        spec.validate()
        assert spec.virtual_population == (kw["population"] > K)


# ---------------------------------------------------------------- checkpoint


def test_checkpoint_roundtrip_and_continuation(tmp_path):
    """{"state", "population"} survives save -> restore bit for bit (the
    store's cohort generator too), and a restored pair continues a horizon
    bit for bit as the original does."""
    from repro_torch.checkpoint import restore, save

    P, T1, T2 = 7, 2, 4
    engine = tbuild(P)
    p = {"w": torch.ones(D)}
    state = engine.init(p, torch.Generator().manual_seed(11))
    store = engine.init_population(state, torch.Generator().manual_seed(11))
    state, data, _ = run_population_rounds(engine.round_fn, state, store, tdata(), T1, chunk=1)

    save(str(tmp_path), T1, {"state": state, "population": store})
    like_state = engine.init(p, torch.Generator().manual_seed(0))
    like = {"state": like_state, "population": engine.init_population(like_state)}
    restored = restore(str(tmp_path), T1, like)

    assert_states_equal(restored["state"], state, "restored state")
    rs = restored["population"]
    assert isinstance(rs, PopulationStore) and rs is not like["population"]
    assert torch.equal(rs.generator.get_state(), store.generator.get_state())
    for key, buf in store.data["z"].items():
        assert isinstance(rs.data["z"][key], np.ndarray) and rs.data["z"][key].flags.writeable
    assert_stores_equal(rs, store, "restored store")

    gen = torch.Generator().manual_seed(0)
    gen.set_state(data.generator.get_state())
    data_b = PackedBatches(data.arrays, gen, E, H)
    out_a, _, _ = run_population_rounds(engine.round_fn, state, store, data, T2, chunk=2)
    out_b, _, _ = run_population_rounds(engine.round_fn, restored["state"], rs, data_b, T2,
                                        chunk=2)
    assert_states_equal(out_a, out_b, "continuation")
    assert_stores_equal(store, rs, "continued store")


# --------------------------------------------------------- packer edge cases


class FakeState(NamedTuple):
    z: Any
    rng: Any = None


EDGE_SHAPES = {"scalar": ((), "float32"), "empty": ((0,), "float32"), "ints": ((3,), "int32"),
               "half": ((2, 2), "bfloat16"), "w": ((4,), "float32")}


def _edge(seed=0):
    """The same edge-case flat buffers for both packages ([G, K, N] per dtype)."""
    jtemplate = {k: jnp.zeros(s, getattr(jnp, d)) for k, (s, d) in EDGE_SHAPES.items()}
    ttemplate = {k: torch.zeros(s, dtype=getattr(torch, d)) for k, (s, d) in EDGE_SHAPES.items()}
    from repro.core.packer import make_packer as jmake

    jp, tp = jmake(jtemplate), make_packer(ttemplate)
    assert tp.buffer_sizes == jp.buffer_sizes
    rng = np.random.default_rng(seed)
    jbufs, tbufs = {}, {}
    for key, n in jp.buffer_sizes:
        raw = rng.normal(size=(G, K, n)) * 10
        jbufs[key] = jnp.asarray(raw.astype(np.float32).astype(getattr(jnp, key)))
        tbufs[key] = convert.tensor_from_numpy(np.asarray(jbufs[key]), "cpu")
    return JFlatBuffers(jbufs, jp), FlatBuffers(tbufs, tp)


@pytest.mark.parametrize("layout", ["flat", "tree"])
def test_store_edge_case_leaves_roundtrip(layout):
    """Scalar, zero-size, int32 and bfloat16 leaves gather, install,
    extract and scatter bit for bit in both layouts; untouched rows never
    move; the port's store equals the reference's after the same steps."""
    P = 9
    jflat, tflat = _edge()
    state = FakeState(z=tflat if layout == "flat" else tflat.to_tree())
    jstate = FakeState(z=jflat if layout == "flat" else jflat.to_tree())
    store = PopulationStore.from_state(state, P, ("z", "dyn"))
    jstore = JStore.from_state(jstate, P, ("z", "dyn"))
    assert store.fields == ("z",)
    assert store.data["z"]["bfloat16"].dtype == np.uint16
    assert store.state_bytes() == sum(b.nbytes for b in store.data["z"].values())
    assert store.device_bytes(K) == sum(b.numel() * b.element_size() for b in tflat.bufs.values())
    assert store.size_report(K) == jstore.size_report(K)

    before = {key: buf.copy() for key, buf in store.data["z"].items()}
    idx = np.stack([np.array([8, 3, 5]), np.array([0, 7, 4])])
    installed = store.install(state, store.gather(idx))
    assert installed is state
    host = store.extract(installed)
    perturbed = {"z": {key: arr + np.ones_like(arr) for key, arr in host["z"].items()}}
    store.scatter(idx, perturbed)
    jhost = jstore.extract(jstore.install(jstate, jstore.gather(idx)))
    jstore.scatter(idx, {"z": {k: a + np.ones_like(a) for k, a in jhost["z"].items()}})
    mask = np.zeros((G, P), bool)
    mask[np.arange(G)[:, None], idx] = True
    for key, buf in store.data["z"].items():
        np.testing.assert_array_equal(buf[np.arange(G)[:, None], idx], perturbed["z"][key],
                                      err_msg=f"scattered rows [{key}]")
        np.testing.assert_array_equal(buf[~mask], before[key][~mask],
                                      err_msg=f"untouched rows [{key}]")
    jbits = {k: np.asarray(v).view(np.uint16) if v.dtype.name == "bfloat16" else np.asarray(v)
             for k, v in jstore.data["z"].items()}
    for key, buf in convert.store_to_reference_data(store)["z"].items():
        if key == "bfloat16":
            # The reference adds one in bfloat16, the port adds one to the
            # bits: compare the rows the scatter did not touch.
            np.testing.assert_array_equal(buf[~mask], jbits[key][~mask], err_msg=key)
        else:
            np.testing.assert_array_equal(buf, jbits[key], err_msg=key)
    back = store.extract(store.install(state, store.gather(idx)))
    for key in back["z"]:
        np.testing.assert_array_equal(back["z"][key], perturbed["z"][key],
                                      err_msg=f"roundtrip [{key}]")


def test_store_layout_matches_reference():
    """From the same state, the port's store has the reference's segment
    table, fields and rows; it crosses both ways through ``convert``."""
    jeng, teng = jbuild(10, algorithm="feddyn"), tbuild(10, algorithm="feddyn")
    jstate = jeng.init({"w": jnp.arange(D, dtype=jnp.float32)})
    tstate = teng.init({"w": torch.arange(D, dtype=torch.float32)})
    jstore, tstore = jeng.init_population(jstate), teng.init_population(tstate)
    assert tstore.fields == jstore.fields == ("z", "dyn")
    back = convert.store_from_reference(jstore)
    for f in tstore.fields:
        assert back.packers[f] == tstore.packers[f]
        assert tstore.packers[f].buffer_sizes == jstore.packers[f].buffer_sizes
    assert_stores_equal(back, tstore, "crossed store")
    data = convert.store_to_reference_data(tstore)
    for f in jstore.fields:
        for key, buf in jstore.data[f].items():
            np.testing.assert_array_equal(data[f][key], buf)


def test_draw_cohort_shape_and_distinctness():
    idx = draw_cohort(torch.Generator().manual_seed(0), G, 50, K)
    assert idx.shape == (G, K) and idx.dtype == np.int64
    for g in range(G):
        assert len(set(idx[g].tolist())) == K
        assert idx[g].min() >= 0 and idx[g].max() < 50
    np.testing.assert_array_equal(idx, draw_cohort(torch.Generator().manual_seed(0), G, 50, K))


def test_population_fields_per_algorithm():
    from repro.core.population import population_fields as jfields

    for algo in tapi.ALGORITHMS:
        assert population_fields(algo) == jfields(algo)
    assert population_fields("feddyn") == ("z", "dyn")


# ----------------------------------------------------- memory claim (small)


def test_memory_claim_from_segment_table():
    """Device bytes constant in P and equal to the cohort buffers; host bytes
    exactly linear in P; both equal to the reference's."""
    engine = tbuild(K)
    state = engine.init({"w": torch.ones(D)})
    jstate = jbuild(K).init({"w": jnp.ones(D)})
    populations = (K, 10 * K, 100 * K)
    stores = [PopulationStore.from_state(state, P) for P in populations]
    device = [s.device_bytes(K) for s in stores]
    assert len(set(device)) == 1
    assert device[0] == sum(b.numel() * b.element_size() for b in state.z.bufs.values())
    host = [s.state_bytes() for s in stores]
    slopes = {(host[i + 1] - host[i]) / (populations[i + 1] - populations[i])
              for i in range(len(host) - 1)}
    assert len(slopes) == 1 and slopes.pop() > 0
    for s, P in zip(stores, populations):
        assert s.state_bytes() == sum(b.nbytes for bufs in s.data.values() for b in bufs.values())
        report = s.size_report(K)
        assert report == JStore.from_state(jstate, P).size_report(K)


# ------------------------------------------------------------- fit routing


def test_fit_virtual_tree_layout_end_to_end():
    """Virtual mode with the tree layout: fit creates the store, returns it
    on Horizon.population, and a second fit continues from it."""
    P = 12
    engine = tbuild(P, cohort_size=K, layout="tree")
    state, hz = tapi.fit(engine, tdata(), 4, params={"w": torch.ones(D)}, chunk=2)
    store = hz.population
    assert isinstance(store, PopulationStore)
    assert store.population == P and not store.flat["z"]
    touched = {key: np.any(buf != 0, axis=-1).sum() for key, buf in store.data["z"].items()}
    assert all(v > 0 for v in touched.values())
    gen_before = store.generator.get_state().clone()
    state2, hz2 = tapi.fit(engine, hz.data, 4, state=state, population_store=store, chunk=2)
    assert hz2.population is store
    assert not torch.equal(gen_before, store.generator.get_state())
    assert np.isfinite(hz2.metrics.loss).all()


def test_fit_rejects_guard_and_autosave_with_a_population(tmp_path):
    engine = tbuild(2 * K)
    for kw in (dict(guard=True), dict(checkpoint_every=1, checkpoint_path=str(tmp_path))):
        with pytest.raises(ValueError, match="materialized-path features"):
            tapi.fit(engine, tdata(), 2, params={"w": torch.ones(D)}, **kw)


def test_cli_population_on_reduced_glm4(capsys):
    """The trainer CLI builds a real population spec on the CPU and prints
    the reference's store-size line."""
    from repro_torch.launch import train

    state, hz = train.main(["--arch", "glm4-9b", "--smoke", "--rounds", "2", "--seq", "16",
                            "--batch", "1", "--population", "4", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "population=4/group cohort=2 store=" in out and "MB host" in out
    assert isinstance(hz.population, PopulationStore) and hz.population.population == 4
    assert np.isfinite(hz.metrics.loss).all()
