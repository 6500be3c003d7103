"""The port's checkpoints (``repro_torch.checkpoint``): one case for each
test of ``tests/test_checkpoint.py`` (port against port), and the on-disk
format against the JAX package's (``repro.checkpoint``):

* a reference checkpoint restores into the port bit for bit (flat and
  tree, simulator and sharded, bfloat16 leaves included; the reference's
  JAX key reseeds the port's generator from its two words);
* an rng-free port checkpoint restores in the reference (a port
  generator's state has no shape the reference's key accepts, so the
  states of this direction carry no generator);
* the two packages' saves of corresponding states have the same npz keys;
* a ``{"state", "population"}`` pair crosses.

The sharded round updates its state in place, so every run starts from a
fresh state.
"""
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro import checkpoint as jckpt  # noqa: E402
from repro_torch import api as tapi  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.checkpoint import latest_step, restore, save  # noqa: E402
from repro_torch.core.config import HFLConfig  # noqa: E402
from repro_torch.core.driver import PackedBatches, select_round  # noqa: E402
from repro_torch.core.engine import hfl_init  # noqa: E402
from repro_torch.core.population import PopulationStore  # noqa: E402
from test_torch_population import (  # noqa: E402
    D,
    E,
    G,
    K,
    S,
    assert_states_equal,
    jbuild,
    jdata,
    tbuild,
    tdata,
)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """One intra-op thread: the suite runs files in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def one_round(engine, state, microbatches=None):
    sid = torch.randint(0, S, (E, G, K), generator=torch.Generator().manual_seed(7))
    return engine.round_fn(state, select_round(tdata(microbatches=microbatches), sid))[0]


def _keys(path):
    with np.load(path) as f:
        return list(f.files)


@pytest.mark.parametrize("layout", ["tree", "flat"])
def test_flat_hfl_state_roundtrip_bitexact(layout, tmp_path):
    """A simulator state under partial participation (its generator drives
    the masks) survives save -> restore, and one more round from the
    restored state is bit-identical, masks included."""
    engine = tbuild(layout=layout, client_participation=0.5)
    state = engine.init({"w": torch.ones(D)}, torch.Generator().manual_seed(3))
    state = one_round(engine, state)

    save(str(tmp_path), 1, state)
    assert latest_step(str(tmp_path)) == 1
    like = engine.init({"w": torch.zeros(D)}, torch.Generator().manual_seed(0))
    restored = restore(str(tmp_path), 1, like)
    assert_states_equal(restored, state, f"{layout}/roundtrip")
    assert torch.equal(restored.rng.get_state(), state.rng.get_state())
    assert restored.rng is not like.rng
    assert_states_equal(one_round(engine, restored), one_round(engine, state),
                        f"{layout}/one-round")


@pytest.mark.parametrize("layout", ["tree", "flat"])
def test_sharded_state_rng_roundtrip_bitexact(layout, tmp_path):
    engine = tbuild(layout=layout, backend="sharded", client_participation=0.5,
                    group_participation=0.75)
    state = engine.init({"w": torch.ones(D)}, torch.Generator().manual_seed(11))
    state = one_round(engine, state, microbatches=1)

    save(str(tmp_path), 5, state)
    like = engine.init({"w": torch.zeros(D)}, torch.Generator().manual_seed(0))
    restored = restore(str(tmp_path), 5, like)
    assert_states_equal(restored, state, f"sharded/{layout}")
    assert torch.equal(restored.rng.get_state(), state.rng.get_state())
    # The round works in place: run each from its own copy.
    again = restore(str(tmp_path), 5, like)
    assert_states_equal(one_round(engine, restored, microbatches=1),
                        one_round(engine, again, microbatches=1), f"sharded/{layout}/one-round")


def test_sharded_none_rng_survives(tmp_path):
    engine = tbuild(layout="tree", backend="sharded")
    state = engine.init({"w": torch.ones(D)})
    assert state.rng is None
    save(str(tmp_path), 2, state)
    restored = restore(str(tmp_path), 2, state)
    assert restored.rng is None
    assert_states_equal(restored, state, "sharded/none-rng")


def test_restore_structure_mismatch_raises(tmp_path):
    for flat in (True, False):
        cfg = HFLConfig(num_groups=G, clients_per_group=K, use_flat_state=flat)
        state = hfl_init({"w": torch.ones(D)}, cfg, device="cpu")
        save(str(tmp_path), 1, state)
        other = hfl_init({"w": torch.ones(D), "v": torch.ones(2)}, cfg, device="cpu")
        with pytest.raises(ValueError, match="has shape" if flat else "has no leaf"):
            restore(str(tmp_path), 1, other)   # a longer buffer / a leaf the file lacks
        wide = hfl_init({"w": torch.ones(D + 1)}, cfg, device="cpu")
        with pytest.raises(ValueError, match="has shape"):
            restore(str(tmp_path), 1, wide)


def test_fit_autosave_and_resume_bitexact(tmp_path):
    """fit(checkpoint_every=, checkpoint_path=) saves at chunk boundaries;
    fit(resume=True) restores the latest checkpoint and runs only the
    remaining rounds, bit for bit the uninterrupted run."""
    engine = tbuild(client_participation=0.5)
    data = tdata()
    p = {"w": torch.ones(D)}

    sA, hA = tapi.fit(engine, data, 6, params=p, rng=torch.Generator().manual_seed(3),
                      checkpoint_every=2, checkpoint_path=str(tmp_path))
    assert latest_step(str(tmp_path)) == 6
    assert sorted(q.name for q in tmp_path.glob("*.npz")) == [
        "ckpt_00000002.npz", "ckpt_00000004.npz", "ckpt_00000006.npz"]
    assert "['data_rng']" in _keys(tmp_path / "ckpt_00000002.npz")

    # A crash after round 4: drop the final checkpoint, resume.
    for q in tmp_path.glob("*0006*"):
        q.unlink()
    sB, hB = tapi.fit(engine, tdata(gen_seed=99), 6, params=p,
                      rng=torch.Generator().manual_seed(3), checkpoint_every=2,
                      checkpoint_path=str(tmp_path), resume=True)
    assert_states_equal(sA, sB, "resume")
    assert torch.equal(sA.rng.get_state(), sB.rng.get_state())
    assert len(hB.metrics.loss) == 2
    np.testing.assert_array_equal(hB.metrics.loss, hA.metrics.loss[4:])
    assert latest_step(str(tmp_path)) == 6

    with pytest.raises(ValueError, match="nothing left"):
        tapi.fit(engine, data, 4, params=p, rng=torch.Generator().manual_seed(3),
                 checkpoint_every=2, checkpoint_path=str(tmp_path), resume=True)


def test_fit_checkpoint_needs_path():
    with pytest.raises(ValueError, match="checkpoint_path"):
        tapi.fit(tbuild(), tdata(), 2, params={"w": torch.ones(D)}, checkpoint_every=2)


# ------------------------------------------------------------ cross-package


CROSS = [("simulator", "flat", {}), ("simulator", "tree", {}), ("sharded", "flat", {}),
         ("sharded", "tree", {}), ("sharded", "tree", {"correction_dtype": "bfloat16"})]
CROSS_IDS = ["sim-flat", "sim-tree", "sharded-flat", "sharded-tree", "sharded-tree-bf16"]


def _pair(backend, layout, extra, **kw):
    """The reference's and the port's engine for one spec."""
    return (jbuild(backend=backend, layout=layout, **extra, **kw),
            tbuild(backend=backend, layout=layout, **extra, **kw))


def _jround(jeng, jstate, backend):
    from repro.core import select_round as jselect

    mb = 1 if backend == "sharded" else None
    return jeng.round_fn(jstate, jselect(jdata(microbatches=mb), jax.random.PRNGKey(7)))[0]


@pytest.mark.parametrize("backend,layout,extra", CROSS, ids=CROSS_IDS)
def test_reference_checkpoint_restores_into_port(backend, layout, extra, tmp_path):
    """A reference save (after one round, so z and y are nonzero) restores
    into the port's state bit for bit; a bfloat16 z/y comes back from its
    16-bit pattern. The reference's JAX key reseeds the port's generator
    from its two words."""
    jeng, teng = _pair(backend, layout, extra)
    jstate = _jround(jeng, jeng.init({"w": jnp.ones(D)}, jax.random.PRNGKey(5)), backend)
    jckpt.save(str(tmp_path), 3, jstate)
    like = teng.init({"w": torch.zeros(D)}, torch.Generator().manual_seed(0)
                     if jstate.rng is not None else None)
    got = restore(str(tmp_path), 3, like)
    for f in ("params", "z", "y", "dyn"):
        if getattr(jstate, f, None) is None:
            continue
        want = getattr(jstate, f)
        want = (want.bufs if hasattr(want, "bufs") else want)
        have = getattr(got, f)
        have = have.bufs if hasattr(have, "bufs") else have
        for k in want:
            w, t = np.asarray(want[k]), have[k]
            if w.dtype.name == "bfloat16":
                assert t.dtype == torch.bfloat16
                np.testing.assert_array_equal(t.view(torch.int16).numpy(), w.view(np.int16))
            else:
                np.testing.assert_array_equal(t.numpy(), w, err_msg=f"{f}.{k}")
    if jstate.rng is not None:
        w0, w1 = (int(v) for v in np.asarray(jstate.rng))
        want_gen = torch.Generator().manual_seed((w0 << 32) | w1)
        assert torch.equal(got.rng.get_state(), want_gen.get_state())
    if getattr(jstate, "round", None) is not None and backend == "simulator":
        assert int(got.round) == int(jstate.round)


@pytest.mark.parametrize("layout", ["flat", "tree"])
def test_port_checkpoint_restores_in_reference(layout, tmp_path):
    """An rng-free port state (the sharded backend at full participation)
    restores in the reference bit for bit."""
    jeng, teng = _pair("sharded", layout, {})
    tstate = one_round(teng, teng.init({"w": torch.ones(D)}), microbatches=1)
    save(str(tmp_path), 4, tstate)
    got = jckpt.restore(str(tmp_path), 4, jeng.init({"w": jnp.zeros(D)}))
    want = convert.to_numpy(tstate)
    for f in ("params", "z", "y"):
        leaf = getattr(got, f)
        leaf = {k: np.asarray(v) for k, v in leaf.bufs.items()} if hasattr(leaf, "bufs") \
            else jax.tree.map(np.asarray, leaf)
        for k in want[f]:
            np.testing.assert_array_equal(leaf[k], want[f][k], err_msg=f"{f}.{k}")


def test_reference_cannot_restore_its_own_bf16_leaves(tmp_path):
    """The fault the port works around (ROADMAP queue 3): ``np.savez``
    writes a bfloat16 leaf as raw ``V2`` bytes and the reference's
    ``astype(bfloat16)`` has no cast for them; the port reads the same file."""
    jeng, teng = _pair("sharded", "tree", {"correction_dtype": "bfloat16"})
    jstate = jeng.init({"w": jnp.ones(D)})
    jckpt.save(str(tmp_path), 1, jstate)
    with pytest.raises(ValueError, match="cast"):
        jckpt.restore(str(tmp_path), 1, jstate)
    got = restore(str(tmp_path), 1, teng.init({"w": torch.zeros(D)}))
    assert got.z["w"].dtype == torch.bfloat16


@pytest.mark.parametrize("backend,layout,extra", CROSS, ids=CROSS_IDS)
def test_npz_keys_equal_reference(backend, layout, extra, tmp_path):
    """The two packages' saves of corresponding states hold the same npz
    keys, in the same order (a state with a generator where the
    reference's has a key: partial participation on the simulator)."""
    kw = {"client_participation": 0.5} if backend == "simulator" else {}
    jeng, teng = _pair(backend, layout, extra, **kw)
    sim = backend == "simulator"
    jstate = jeng.init({"w": jnp.ones(D)}, jax.random.PRNGKey(0) if sim else None)
    tstate = teng.init({"w": torch.ones(D)}, torch.Generator().manual_seed(0) if sim else None)
    jpath = jckpt.save(str(tmp_path / "j"), 0, {"state": jstate, "data_rng": jax.random.PRNGKey(1)})
    tpath = save(str(tmp_path / "t"), 0, {"state": tstate, "data_rng": torch.Generator()})
    assert _keys(tpath) == _keys(jpath)
    assert "['state']||.params||['float32']" in _keys(tpath) or layout == "tree"


@pytest.mark.parametrize("layout", ["flat", "tree"])
def test_population_pair_crosses(layout, tmp_path):
    """A reference ``{"state", "population"}`` save restores into the port
    (store rows bit for bit, the generator reseeded); the port's save has
    the reference's keys plus the store's cohort generator, which the
    reference's restore ignores."""
    P = 7
    jeng, teng = jbuild(P, layout=layout), tbuild(P, layout=layout)
    jstate = _jround(jeng, jeng.init({"w": jnp.ones(D)}, jax.random.PRNGKey(2)), "simulator")
    jstore = jeng.init_population(jstate)
    jstore.scatter(np.array([[4, 5, 6], [6, 0, 3]]), jstore.extract(jstate))
    jpath = jckpt.save(str(tmp_path / "j"), 1, {"state": jstate, "population": jstore})
    assert "['population']||['z.float32']" in _keys(jpath)

    tstate = teng.init({"w": torch.zeros(D)})
    like = {"state": tstate, "population": teng.init_population(tstate)}
    got = restore(str(tmp_path / "j"), 1, like)
    store = got["population"]
    assert isinstance(store, PopulationStore)
    np.testing.assert_array_equal(store.data["z"]["float32"],
                                  np.asarray(jstore.data["z"]["float32"]))
    assert torch.equal(store.generator.get_state(), like["population"].generator.get_state())

    tpath = save(str(tmp_path / "t"), 1, got)
    tkeys = _keys(tpath)
    assert "['population']||['rng']" in tkeys
    assert [k for k in tkeys if k != "['population']||['rng']"] == _keys(jpath)
    # The reference reads only its like's leaves: the store alone (a port
    # state's generator has no shape the reference's key accepts).
    back = jckpt.restore(str(tmp_path / "t"), 1, {"population": jstore})
    np.testing.assert_array_equal(np.asarray(back["population"].data["z"]["float32"]),
                                  np.asarray(jstore.data["z"]["float32"]))


# ------------------------------------------------------------ multilevel

ML_DIMS, ML_PERIODS = (2, 2, 3), (8, 4, 2)


def _ml_spec(api, layout, **kw):
    return api.ExperimentSpec(levels=ML_DIMS, backend="multilevel", lr=0.05,
                              schedule=api.RoundSchedule(periods=ML_PERIODS),
                              state_layout=layout, **kw)


def _ml_batches(seed=0):
    rng = np.random.default_rng(seed)
    lead = (ML_PERIODS[0] // ML_PERIODS[-1], ML_PERIODS[-1]) + ML_DIMS + (D,)
    return {"a": (rng.normal(size=lead) + 2.0).astype(np.float32),
            "b": rng.normal(size=lead).astype(np.float32)}


def assert_ml_equal(a, b, tag):
    """params and every nu of two multilevel states, bit for bit."""
    for m, (x, y) in enumerate(zip([a.params, *a.nus], [b.params, *b.nus])):
        x, y = convert.to_numpy(x), convert.to_numpy(y)
        assert x.keys() == y.keys(), tag
        for k in x:
            np.testing.assert_array_equal(x[k], y[k], err_msg=f"{tag}: leaf {m}/{k}")


@pytest.mark.parametrize("layout", ["tree", "flat"])
def test_multilevel_state_roundtrip_bitexact(layout, tmp_path):
    """A multilevel state under partial participation (its generator draws
    the level masks) survives save -> restore, under the reference's key
    paths (``.nus||[m]||...``), and one more round from the restored state
    is bit-identical."""
    from test_torch_population import tquad

    engine = tapi.build(_ml_spec(tapi, layout, level_participation=(1.0, 0.5, 0.5)), tquad,
                        device="cpu")
    b = {k: torch.from_numpy(v) for k, v in _ml_batches().items()}
    state = engine.round_fn(engine.init({"w": torch.ones(D)}, torch.Generator().manual_seed(3)),
                            b)[0]
    path = save(str(tmp_path), 1, state)
    leaf = "['float32']" if layout == "flat" else "['w']"
    assert _keys(path) == [".params||" + leaf] + [f".nus||[{m}]||{leaf}" for m in range(3)] + [
        ".rng"]
    like = engine.init({"w": torch.zeros(D)}, torch.Generator().manual_seed(0))
    restored = restore(str(tmp_path), 1, like)
    assert_ml_equal(restored, state, f"{layout}/roundtrip")
    assert torch.equal(restored.rng.get_state(), state.rng.get_state())
    assert_ml_equal(engine.round_fn(restored, b)[0], engine.round_fn(state, b)[0],
                    f"{layout}/one-round")


@pytest.mark.parametrize("layout", ["tree", "flat"])
def test_reference_multilevel_checkpoint_restores_into_port(layout, tmp_path):
    """A reference multilevel save (after one round, so nu_1 is nonzero; the
    round's last aggregation re-initializes the deeper nus) restores into
    the port's state bit for bit, with the same npz keys as the port's own
    save; the reference's JAX key reseeds the generator."""
    from test_mtgc_engine import quad_loss as jquad
    from test_torch_population import tquad

    from repro import api as japi
    from repro.core.packer import as_tree as jas_tree

    jeng = japi.build(_ml_spec(japi, layout), jquad)
    teng = tapi.build(_ml_spec(tapi, layout), tquad, device="cpu")
    jstate = jeng.round_fn(jeng.init({"w": jnp.ones(D)}, jax.random.PRNGKey(5)),
                           {k: jnp.asarray(v) for k, v in _ml_batches(1).items()})[0]
    jpath = jckpt.save(str(tmp_path / "j"), 3, jstate)
    got = restore(str(tmp_path / "j"), 3, teng.init({"w": torch.zeros(D)}))
    for t, j in zip([got.params, *got.nus], [jstate.params, *jstate.nus]):
        t = convert.to_numpy(t)
        j = {k: np.asarray(v) for k, v in (j.bufs if hasattr(j, "bufs") else j).items()}
        assert t.keys() == j.keys()
        for k in j:
            np.testing.assert_array_equal(t[k], j[k])
    assert np.abs(np.asarray(jas_tree(jstate.nus[0])["w"])).max() > 0
    w0, w1 = (int(v) for v in np.asarray(jstate.rng))
    assert torch.equal(got.rng.get_state(),
                       torch.Generator().manual_seed((w0 << 32) | w1).get_state())
    assert _keys(save(str(tmp_path / "t"), 3, got)) == _keys(jpath)


def test_multilevel_fit_resume_bitexact(tmp_path):
    """``fit(checkpoint_every=2)`` on the multilevel engine, then
    ``resume=True`` after the last checkpoint is lost: bit for bit the
    uninterrupted run."""
    from test_torch_population import tquad

    engine = tapi.build(_ml_spec(tapi, "flat", level_participation=(1.0, 0.5, 0.5)), tquad,
                        device="cpu")
    rng = np.random.default_rng(4)
    shape = ML_DIMS + (3, ML_PERIODS[-1], D)
    arrays = {"a": torch.from_numpy((rng.normal(size=shape) + 2.0).astype(np.float32)),
              "b": torch.from_numpy(rng.normal(size=shape).astype(np.float32))}

    def packed(seed):
        return PackedBatches(arrays, torch.Generator().manual_seed(seed),
                             ML_PERIODS[0] // ML_PERIODS[-1], ML_PERIODS[-1], topo_ndim=3)

    p = {"w": torch.ones(D)}
    sA, hA = tapi.fit(engine, packed(1), 6, params=p, rng=torch.Generator().manual_seed(3),
                      checkpoint_every=2, checkpoint_path=str(tmp_path))
    assert latest_step(str(tmp_path)) == 6
    for q in tmp_path.glob("*0006*"):
        q.unlink()
    sB, hB = tapi.fit(engine, packed(99), 6, params=p, rng=torch.Generator().manual_seed(3),
                      checkpoint_every=2, checkpoint_path=str(tmp_path), resume=True)
    assert_ml_equal(sA, sB, "resume")
    assert torch.equal(sA.rng.get_state(), sB.rng.get_state())
    np.testing.assert_array_equal(hB.metrics.loss, hA.metrics.loss[4:])
