"""The port's horizon driver against the reference's (core/driver.py).

Shard selection is the one random draw of a full-participation run, and
PyTorch cannot reproduce ``jax.random``'s bits, so these tests compute the
reference's shard ids from its key stream (``key, rng = split(rng)`` per
round, then ``randint(key, (E, G, K), 0, S)``, core/driver.py) and hand
the same ids to the port's ``fit``. Packing draws with numpy's generator
in both packages, so the packed arrays are identical.
"""
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro import api as japi  # noqa: E402
from repro.data.partition import partition as jpartition  # noqa: E402
from repro.data.synthetic import make_classification as jmake  # noqa: E402
from repro.models import small as jsmall  # noqa: E402
from repro_torch import api as tapi  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core.driver import draw_shard_ids, select_round  # noqa: E402
from repro_torch.data import make_classification, partition, train_test_split  # noqa: E402
from repro_torch.models import small as tsmall  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """One intra-op thread: the suite runs files in parallel workers, and
    PyTorch's default of one thread per core would crowd out the other
    workers' (timing-sensitive) tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

RTOL, ATOL = 1e-5, 1e-6


def reference_shard_ids(key, T, E, G, K, S):
    """[T, E, G, K] shard ids exactly as the reference driver draws them."""
    out = []
    for _ in range(T):
        sub, key = jax.random.split(key)
        out.append(np.asarray(jax.random.randint(sub, (E, G, K), 0, S)))
    return np.stack(out)


def _dataset(G, K, samples, dim, seed=0, alpha=0.1):
    rng = np.random.default_rng(seed)
    ds = make_classification(rng, num_samples=samples, num_classes=10, dim=dim)
    train, test = train_test_split(ds, rng)
    idx = partition(train.y, G, K, mode="both_noniid", alpha=alpha, seed=seed)
    return train, test, idx


def test_data_copies_match_reference():
    rng_t, rng_j = np.random.default_rng(5), np.random.default_rng(5)
    a = make_classification(rng_t, num_samples=300, dim=12, image_shape=(2, 2, 3))
    b = jmake(rng_j, num_samples=300, dim=12, image_shape=(2, 2, 3))
    np.testing.assert_array_equal(a.x, b.x)
    np.testing.assert_array_equal(a.y, b.y)
    for mode in ("group_iid", "client_iid", "both_noniid", "label_shift"):
        pt = partition(a.y, 3, 2, mode=mode, alpha=0.5, seed=1)
        pj = jpartition(b.y, 3, 2, mode=mode, alpha=0.5, seed=1)
        for gt, gj in zip(pt, pj):
            for ct, cj in zip(gt, gj):
                np.testing.assert_array_equal(ct, cj)


def test_pack_client_shards_matches_reference():
    G, K, E, H = 2, 3, 2, 2
    train, _, idx = _dataset(G, K, 600, 8)
    arrays = {"x": train.x, "y": train.y}
    jspec = japi.ExperimentSpec(levels=(G, K),
                                schedule=japi.RoundSchedule(group_rounds=E, local_steps=H))
    tspec = tapi.ExperimentSpec(levels=(G, K),
                                schedule=tapi.RoundSchedule(group_rounds=E, local_steps=H))
    jdata = japi.build(jspec, lambda p, b: 0.0).pack_arrays(
        arrays, idx, batch_size=4, shards=5, rng=np.random.default_rng(1),
        key=jax.random.PRNGKey(1))
    tdata = tapi.build(tspec, lambda p, b: None, device="cpu").pack_arrays(
        arrays, idx, batch_size=4, shards=5, rng=np.random.default_rng(1))
    for name in arrays:
        np.testing.assert_array_equal(tdata.arrays[name].numpy(),
                                      np.asarray(jdata.arrays[name]))
    # select_round gathers the same batches from the same shard ids.
    from repro.core.driver import select_round as jselect
    key = jax.random.PRNGKey(9)
    sid = np.asarray(jax.random.randint(key, (E, G, K), 0, 5))
    jb = jselect(jdata, key)
    tb = select_round(tdata, torch.from_numpy(sid.copy()))
    for name in arrays:
        assert tuple(tb[name].shape) == (E, H, G, K, 4) + arrays[name].shape[1:]
        np.testing.assert_array_equal(tb[name].numpy(), np.asarray(jb[name]))
    ids = draw_shard_ids(tdata)
    assert tuple(ids.shape) == (E, G, K) and int(ids.max()) < 5


def _fit_pair(algo, G, K, E, H, rounds, eval_every, *, samples, dim, hidden, batch,
              shards, chunk=None):
    """Run the reference's and the port's fit on the same data, params and
    shard ids; return both horizons."""
    train, test, idx = _dataset(G, K, samples, dim)
    jinit, japply = jsmall.mlp(10, dim, hidden=hidden)
    _, tapply = tsmall.mlp(10, dim, hidden=hidden)
    p0 = jinit(jax.random.PRNGKey(0))
    kw = dict(levels=(G, K), algorithm=algo, lr=0.1)
    jeng = japi.build(japi.ExperimentSpec(
        schedule=japi.RoundSchedule(group_rounds=E, local_steps=H), **kw),
        jsmall.make_loss(japply))
    teng = tapi.build(tapi.ExperimentSpec(
        schedule=tapi.RoundSchedule(group_rounds=E, local_steps=H), **kw),
        tsmall.make_loss(tapply), device="cpu")
    arrays = {"x": train.x, "y": train.y}
    jdata = jeng.pack_arrays(arrays, idx, batch_size=batch, shards=shards,
                             rng=np.random.default_rng(1), key=jax.random.PRNGKey(1))
    tdata = teng.pack_arrays(arrays, idx, batch_size=batch, shards=shards,
                             rng=np.random.default_rng(1))
    jacc = jsmall.jit_accuracy(japply, jnp.asarray(test.x), jnp.asarray(test.y))
    tacc = tsmall.make_accuracy(tapply, torch.from_numpy(test.x), torch.from_numpy(test.y))
    _, jhz = japi.fit(jeng, jdata, rounds, params=p0, eval_every=eval_every,
                      eval_fn=lambda prev, st: {"acc": jacc(jeng.global_model(st))})
    sid = reference_shard_ids(jax.random.PRNGKey(1), rounds, E, G, K, shards)
    _, thz = tapi.fit(teng, tdata, rounds,
                      params=convert.params_from_numpy(jax.tree.map(np.asarray, p0), "cpu"),
                      eval_every=eval_every, chunk=chunk, shard_ids=sid,
                      eval_fn=lambda prev, st: {"acc": tacc(teng.global_model(st))})
    return jhz, thz, len(test.y)


def test_fit_matches_reference_horizon():
    """3 rounds, eval every 2: metrics, eval rounds and evals match."""
    jhz, thz, n_test = _fit_pair("mtgc", 2, 3, 2, 2, 3, 2, samples=800, dim=16, hidden=32,
                                 batch=4, shards=4, chunk=2)
    np.testing.assert_array_equal(thz.eval_rounds, jhz.eval_rounds)
    assert list(thz.eval_rounds) == [2, 3]
    for f in jhz.metrics._fields:
        np.testing.assert_allclose(getattr(thz.metrics, f), np.asarray(getattr(jhz.metrics, f)),
                                   rtol=RTOL, atol=ATOL, err_msg=f)
    # Accuracy is a count: allow one test sample to flip on a near tie.
    np.testing.assert_allclose(thz.evals["acc"], np.asarray(jhz.evals["acc"]),
                               atol=1.0 / n_test + 1e-7)


def test_chunked_run_equals_unchunked():
    """Chunking only changes when metrics reach the host: the generator
    draws the same shard ids, so chunked and unchunked runs agree bit for
    bit (torch against torch)."""
    G, K, E, H = 2, 2, 2, 2
    train, test, idx = _dataset(G, K, 400, 8)
    init, apply = tsmall.mlp(10, 8, hidden=16)
    spec = tapi.ExperimentSpec(levels=(G, K),
                               schedule=tapi.RoundSchedule(group_rounds=E, local_steps=H))
    eng = tapi.build(spec, tsmall.make_loss(apply), device="cpu")
    acc = tsmall.make_accuracy(apply, torch.from_numpy(test.x), torch.from_numpy(test.y))
    p0 = init(torch.Generator().manual_seed(0), device="cpu")
    outs = []
    for chunk in (None, 2, 1):
        data = eng.pack_arrays({"x": train.x, "y": train.y}, idx, batch_size=4, shards=3,
                               rng=np.random.default_rng(2),
                               generator=torch.Generator().manual_seed(3))
        state, hz = tapi.fit(eng, data, 5, params=p0, chunk=chunk, eval_every=2,
                             eval_fn=lambda prev, st: {"acc": acc(eng.global_model(st))})
        outs.append((convert.to_numpy(state), hz))
    for state, hz in outs[1:]:
        np.testing.assert_array_equal(hz.eval_rounds, outs[0][1].eval_rounds)
        for f in hz.metrics._fields:
            np.testing.assert_array_equal(getattr(hz.metrics, f),
                                          getattr(outs[0][1].metrics, f))
        np.testing.assert_array_equal(hz.evals["acc"], outs[0][1].evals["acc"])
        np.testing.assert_array_equal(state["params"]["float32"],
                                      outs[0][0]["params"]["float32"])
    assert list(outs[0][1].eval_rounds) == [2, 4, 5]
    assert outs[0][1].metrics.loss.shape == (5, E, H)


# The quickstart's own setting (examples/quickstart.py): 15 rounds of the
# port track the reference's MTGC and HFedAvg loss trajectories. Over 300
# local steps the float32 rounding of the two frameworks drifts apart, so
# the per-round mean loss is held at rtol 1e-3 and the test accuracy at
# each eval within 1% of the test set.
TRAJ_RTOL = 1e-3


@pytest.mark.parametrize("algo", ["mtgc", "hfedavg"])
def test_quickstart_trajectory_tracks_reference(algo):
    jhz, thz, n_test = _fit_pair(algo, 4, 5, 4, 5, 15, 5, samples=6000, dim=32, hidden=64,
                                 batch=32, shards=8)
    np.testing.assert_array_equal(thz.eval_rounds, jhz.eval_rounds)
    np.testing.assert_allclose(thz.metrics.loss.mean(axis=(1, 2)),
                               np.asarray(jhz.metrics.loss).mean(axis=(1, 2)),
                               rtol=TRAJ_RTOL)
    np.testing.assert_allclose(thz.evals["acc"], np.asarray(jhz.evals["acc"]), atol=0.01)


# The full-width CIFAR-10 CNN (N = 2,156,490) on CIFAR-shaped synthetic
# images, cut to one group of two clients and one group round of five
# local steps. In both packages the first steps' loss spikes (to the
# thousands at lr 0.1, to tens at lr 0.01) before it falls back: the port
# must track the reference through the spike. Held at rtol 1e-4, the
# CNN's bound (XLA and PyTorch sum convolutions in another order).
# ``pytest -s`` prints both trajectories.
@pytest.mark.parametrize("lr", [0.1, 0.01])
def test_cifar_cnn_loss_spike_tracks_reference(lr):
    G, K, E, H, batch, shards = 1, 2, 1, 5, 50, 4
    image = (32, 32, 3)
    rng = np.random.default_rng(0)
    ds = make_classification(rng, num_samples=4000, num_classes=10, dim=3072,
                             image_shape=image)
    train, _ = train_test_split(ds, rng)
    idx = partition(train.y, G, K, mode="group_iid", alpha=0.1, seed=0)
    jinit, japply = jsmall.cnn(10, image)
    _, tapply = tsmall.cnn(10, image)
    p0 = jinit(jax.random.PRNGKey(0))
    kw = dict(levels=(G, K), algorithm="mtgc", fusion="fused", lr=lr)
    jeng = japi.build(japi.ExperimentSpec(schedule=japi.RoundSchedule(E, H), **kw),
                      jsmall.make_loss(japply))
    teng = tapi.build(tapi.ExperimentSpec(schedule=tapi.RoundSchedule(E, H), **kw),
                      tsmall.make_loss(tapply), device="cpu")
    arrays = {"x": train.x, "y": train.y}
    jdata = jeng.pack_arrays(arrays, idx, batch_size=batch, shards=shards,
                             rng=np.random.default_rng(1), key=jax.random.PRNGKey(1))
    tdata = teng.pack_arrays(arrays, idx, batch_size=batch, shards=shards,
                             rng=np.random.default_rng(1))
    _, jhz = japi.fit(jeng, jdata, 1, params=p0)
    sid = reference_shard_ids(jax.random.PRNGKey(1), 1, E, G, K, shards)
    _, thz = tapi.fit(teng, tdata, 1,
                      params=convert.params_from_numpy(jax.tree.map(np.asarray, p0), "cpu"),
                      shard_ids=sid)
    jloss = np.asarray(jhz.metrics.loss).reshape(-1)
    tloss = thz.metrics.loss.reshape(-1)
    print(f"lr {lr}: reference loss per step {jloss.tolist()}")
    print(f"lr {lr}: port loss per step      {tloss.tolist()}")
    np.testing.assert_allclose(tloss, jloss, rtol=1e-4)
