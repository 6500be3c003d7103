"""The port's ExperimentSpec: the reference's field list, the reference's
rejections with its messages (partial participation, compressed uploads,
faults, defense, async group rounds, virtual populations and the multilevel
backend are accepted where the reference accepts them), and no quiet CPU
run on a host without CUDA."""
import dataclasses

import pytest

pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro import api as japi  # noqa: E402
from repro_torch import api as tapi  # noqa: E402
from repro_torch.core.config import HFLConfig  # noqa: E402
from repro_torch.core.engine import _build_global_round, hfl_init  # noqa: E402
from repro_torch.models import small as tsmall  # noqa: E402


def test_field_list_equals_reference():
    assert ([f.name for f in dataclasses.fields(tapi.ExperimentSpec)]
            == [f.name for f in dataclasses.fields(japi.ExperimentSpec)])
    assert ([f.name for f in dataclasses.fields(tapi.RoundSchedule)]
            == [f.name for f in dataclasses.fields(japi.RoundSchedule)])
    from repro.core.config import HFLConfig as JHFLConfig
    assert ([(f.name, f.default) for f in dataclasses.fields(HFLConfig)]
            == [(f.name, f.default) for f in dataclasses.fields(JHFLConfig)])


@pytest.mark.parametrize("kwargs", [
    # The three specs that named the multilevel-backend slice before it was
    # ported (levels (2, 2)).
    {"group_participation": 0.5, "defense": tapi.DefensePlan(), "backend": "multilevel"},
    {"backend": "multilevel"},
    {"level_participation": (1.0, 1.0)},
    # M-level specs the reference accepts.
    {"levels": (2, 2, 3), "backend": "multilevel",
     "schedule": tapi.RoundSchedule(periods=(8, 4, 2))},
    {"levels": (2, 2, 3), "backend": "multilevel", "state_layout": "tree",
     "schedule": tapi.RoundSchedule(periods=(8, 4, 2)), "level_participation": (1.0, 0.8, 0.6),
     "participation_weighting": "inverse_prob"},
    {"levels": (2, 2), "backend": "multilevel",
     "schedule": tapi.RoundSchedule(group_rounds=2, local_steps=4, periods=(8, 4))},
    # M-level periods rejections.
    {"levels": (2, 2, 3), "backend": "multilevel"},
    {"levels": (2, 2, 3), "backend": "multilevel", "schedule": tapi.RoundSchedule(periods=(8, 4))},
    {"levels": (2, 2, 3), "backend": "multilevel",
     "schedule": tapi.RoundSchedule(periods=(8, 3, 2))},
    {"levels": (2, 2), "backend": "multilevel",
     "schedule": tapi.RoundSchedule(group_rounds=5, local_steps=2, periods=(8, 4))},
    {"levels": (2, 2), "backend": "multilevel",
     "schedule": tapi.RoundSchedule(group_rounds=(2, 1), periods=(8, 4))},
    {"schedule": tapi.RoundSchedule(periods=(4, 2, 1))},
    {"levels": (2, 2, 3), "schedule": tapi.RoundSchedule(periods=(8, 4, 2))},
    # level_participation rejections.
    {"levels": (2, 2, 3), "backend": "multilevel", "level_participation": (0.5, 0.5),
     "schedule": tapi.RoundSchedule(periods=(8, 4, 2))},
    {"levels": (2, 2, 3), "backend": "multilevel", "level_participation": (0.5, 0.0, 1.0),
     "schedule": tapi.RoundSchedule(periods=(8, 4, 2))},
    {"levels": (2, 2, 3), "level_participation": (0.5, 0.5, 0.5)},
    # What the multilevel backend does not do.
    {"backend": "multilevel", "algorithm": "hfedavg"},
    {"backend": "multilevel", "fusion": "fused"},
    {"backend": "multilevel", "compression": tapi.CompressionPlan("int8_stochastic")},
    {"backend": "multilevel", "faults": tapi.FaultPlan(crash_rate=0.1)},
    {"backend": "multilevel", "population": 4},
    {"backend": "multilevel", "schedule": tapi.RoundSchedule(group_rounds=(2, 1)),
     "staleness": "naive"},
    {"backend": "multilevel", "correction_init": "gradient"},
], ids=["defense-partial", "multilevel", "level-participation-simulator", "three-level",
        "three-level-partial", "two-level-periods", "three-level-no-periods",
        "periods-length", "periods-nest", "periods-conflict", "periods-async",
        "periods-simulator", "three-level-simulator", "level-participation-length",
        "level-participation-range", "level-participation-three-level-simulator",
        "hfedavg", "fused", "compressed", "faults", "population", "async", "gradient-init"])
def test_multilevel_specs_match_reference(kwargs):
    """A multilevel spec the reference accepts builds on the port and runs a
    round; one it rejects raises the reference's own message."""
    import numpy as np

    jspec = japi.ExperimentSpec(**_reference_kwargs(kwargs))
    tspec = tapi.ExperimentSpec(**kwargs)
    try:
        jspec.validate()
    except ValueError as err:
        with pytest.raises(ValueError) as got:
            tapi.build(tspec, _quad, device="cpu")
        assert str(got.value) == str(err)
        return
    eng = tapi.build(tspec, _quad, device="cpu")
    assert type(eng).__name__ == type(japi.build(jspec, _quad)).__name__
    assert tspec.full_participation == jspec.full_participation
    if tspec.backend != "multilevel":
        return
    assert tspec.participation_by_level() == jspec.participation_by_level()
    assert tspec.schedule.level_periods(len(tspec.levels)) == jspec.schedule.level_periods(
        len(jspec.levels))
    E, H = eng._pack_rounds, eng._pack_steps
    rng = np.random.default_rng(0)
    b = {k: torch.from_numpy(rng.normal(size=(E, H) + tspec.levels + (5,)).astype(np.float32))
         for k in ("a", "b")}
    state, met = eng.round_fn(eng.init({"w": torch.zeros(5)}), b)
    assert tuple(met.loss.shape) == (E * H,) and bool(torch.isfinite(met.loss).all())
    assert len(state.nus) == len(tspec.levels)


def test_api_all_snapshot():
    """The port's ``api.__all__``: the reference's names less those of its
    JAX-only surface (``Engine``, ``GuardReport``, ``LoweredChunk``,
    ``run_population_rounds``), the multilevel engine and its metrics
    included (tests/test_api_surface.py's snapshot)."""
    from test_api_surface import EXPECTED_ALL

    jax_only = {"Engine", "GuardReport", "LoweredChunk", "run_population_rounds"}
    assert tapi.__all__ == [n for n in EXPECTED_ALL if n not in jax_only]
    assert {"MultiLevelEngine", "MultiLevelMetrics"} <= set(tapi.__all__)
    for name in tapi.__all__:
        assert getattr(tapi, name) is not None, name


def _reference_kwargs(kwargs):
    """The reference's spec keywords for the port's: its own plan and
    schedule classes."""
    from repro.core.faults import DefensePlan, FaultPlan

    classes = {"schedule": japi.RoundSchedule, "faults": FaultPlan, "defense": DefensePlan,
               "compression": japi.CompressionPlan}
    return {k: classes[k](**dataclasses.asdict(v)) if k in classes else v
            for k, v in kwargs.items()}


@pytest.mark.parametrize("kwargs", [
    # The population specs that named the virtual-population slice before it
    # was ported, and two more the reference accepts.
    {"client_participation": 0.5, "faults": tapi.FaultPlan(crash_rate=0.1), "population": 4},
    {"defense": tapi.DefensePlan(), "client_state": "stateless"},
    {"population": 4},
    {"population": 4, "staleness": "discount",
     "schedule": tapi.RoundSchedule(group_rounds=(2, 1))},
    {"client_state": "stateless"},
    {"backend": "sharded", "compression": tapi.CompressionPlan("int8_stochastic"),
     "population": 4},
    {"backend": "sharded", "population": 4, "cohort_size": 2,
     "schedule": tapi.RoundSchedule(microbatches=1)},
    {"population": 6, "client_state": "stateless", "faults": tapi.FaultPlan(crash_rate=0.1)},
], ids=["faults-partial", "stateless-defense", "population", "population-async", "stateless",
        "sharded-compressed", "sharded-population", "stateless-faults"])
def test_population_specs_match_reference(kwargs):
    """A population spec the reference accepts builds on the port (its store
    too, for a stateful one); one it rejects raises the reference's own
    message."""
    jspec = japi.ExperimentSpec(levels=(2, 2), **_reference_kwargs(kwargs))
    tspec = tapi.ExperimentSpec(levels=(2, 2), **kwargs)
    try:
        jspec.validate()
    except ValueError as err:
        with pytest.raises(ValueError) as got:
            tapi.build(tspec, _quad, device="cpu")
        assert str(got.value) == str(err)
        return
    eng = tapi.build(tspec, _quad, device="cpu")
    assert tspec.virtual_population == jspec.virtual_population
    state = eng.init({"w": torch.zeros(5)})
    if tspec.client_state == "stateful":
        assert eng.init_population(state).population == tspec.population


def _quad(params, batch):
    mod = torch if isinstance(params["w"], torch.Tensor) else jnp
    r = batch["a"] * params["w"] - batch["b"]
    return 0.5 * mod.sum(r * r)


@pytest.mark.parametrize("kwargs", [
    # The async specs that named the async-rounds slice before it was ported.
    {"faults": tapi.FaultPlan(timeout_rate=0.2), "staleness": "discount",
     "schedule": tapi.RoundSchedule(group_rounds=(2, 1))},
    {"staleness": "discount", "schedule": tapi.RoundSchedule(group_rounds=(2, 1))},
    {"schedule": tapi.RoundSchedule(group_rounds=(2, 1))},
    {"backend": "sharded", "faults": tapi.FaultPlan(timeout_rate=0.2), "staleness": "discount",
     "schedule": tapi.RoundSchedule(group_rounds=(2, 1), microbatches=2)},
    {"backend": "sharded", "staleness": "discount",
     "schedule": tapi.RoundSchedule(group_rounds=(2, 1), microbatches=2)},
], ids=["sim-timeout-discount", "sim-discount", "sim-sync-tuple", "sharded-timeout-discount",
        "sharded-discount"])
def test_async_specs_build_and_match_reference(kwargs):
    """An async spec builds on the CPU and its first round matches the
    reference engine's, the reference's fault masks injected (params, z, y
    at rtol 1e-5; the realized-download mask and the window counter
    exactly)."""
    import jax
    import numpy as np
    from test_torch_faults import _tplan, reference_draws

    from repro_torch import convert
    from repro_torch.core.packer import as_tree
    from repro.core import as_tree as jas_tree

    jkw = dict(kwargs)
    jkw["schedule"] = japi.RoundSchedule(**dataclasses.asdict(kwargs["schedule"]))
    if "faults" in jkw:
        from repro.core.faults import FaultPlan
        jkw["faults"] = FaultPlan(**dataclasses.asdict(kwargs["faults"]))
    jspec = japi.ExperimentSpec(levels=(2, 2), lr=0.05, **jkw)
    tspec = tapi.ExperimentSpec(levels=(2, 2), lr=0.05, **kwargs)
    assert tspec.validate().staleness_plan() is not None
    assert _tplan(jspec.faults) == tspec.faults
    jeng, teng = japi.build(jspec, _quad), tapi.build(tspec, _quad, device="cpu")
    jst = jeng.init({"w": jnp.zeros(5)}, rng=jax.random.PRNGKey(4))
    tst = teng.init({"w": torch.zeros(5)})
    A = tspec.schedule.microbatches
    rng = np.random.default_rng(4)
    lead = (2, 5) + ((A,) if A else ()) + (2, 2, 5)
    b = {"a": (rng.normal(size=lead) + 2.0).astype(np.float32),
         "b": rng.normal(size=lead).astype(np.float32)}
    draws = reference_draws(jst.rng, jspec.to_hfl_config(), jspec.faults, None, [])
    jst, _ = jeng.round_fn(jst, jax.tree.map(jnp.asarray, b))
    tst, _ = teng.round_fn(tst, {k: torch.from_numpy(v) for k, v in b.items()}, draws=draws)
    for f in ("params", "z", "y"):
        np.testing.assert_allclose(convert.to_numpy(as_tree(getattr(tst, f)))["w"],
                                   np.asarray(jas_tree(getattr(jst, f))["w"]), rtol=1e-5,
                                   atol=1e-5, err_msg=f)
    for f in ("round", "dl"):
        want = getattr(jst, f)
        assert (getattr(tst, f) is None) == (want is None), f
        if want is not None:
            np.testing.assert_array_equal(getattr(tst, f).numpy(), np.asarray(want))


@pytest.mark.parametrize("kwargs,match", [
    ({"algorithm": "sgd"}, "unknown algorithm"),
    ({"fusion": "fused", "algorithm": "hfedavg"}, "mtgc only"),
    ({"state_layout": "dense"}, "unknown state_layout"),
    ({"correction_init": "random"}, "correction_init"),
    ({"client_participation": 0.0}, "client_participation"),
    ({"participation_mode": "poisson", "client_participation": 0.5}, "participation_mode"),
    ({"compression": tapi.CompressionPlan("int8_stochastic"),
      "correction_init": "gradient"}, "correction_init='zero'"),
    ({"compression": tapi.CompressionPlan(group_mode="topk"), "server_lr": 0.5},
     "server_lr=1.0"),
    ({"compression": tapi.CompressionPlan(topk_frac=0.0)}, "topk_frac"),
    pytest.param({"levels": (2, 2, 2)}, "3-level topologies need backend='multilevel'",
                 id="kwargs9-two-level"),
    ({"schedule": tapi.RoundSchedule(local_steps=0)}, "local_steps"),
    # Compression under an async schedule: the reference's own message.
    ({"compression": tapi.CompressionPlan("int8_stochastic"), "staleness": "discount",
      "schedule": tapi.RoundSchedule(group_rounds=(2, 1))},
     "compressed uploads under an async schedule are not supported yet"),
    # The reference's rejections of contradictory async specs
    # (tests/test_async_rounds.py::test_contradictory_async_specs_raise).
    ({"staleness": "discount"}, "no-op with uniform group_rounds"),
    ({"staleness": "naive", "schedule": tapi.RoundSchedule(group_rounds=(2, 2))}, "no-op"),
    ({"max_staleness": 2}, "max_staleness bounds async reporting"),
    ({"schedule": tapi.RoundSchedule(group_rounds=(2, 1)), "max_staleness": 2},
     "max_staleness bounds async reporting"),
    ({"schedule": tapi.RoundSchedule(group_rounds=(2, 1)), "staleness": "naive",
      "max_staleness": 0}, "max_staleness must be None or >= 1"),
    ({"schedule": tapi.RoundSchedule(group_rounds=(2, 1)), "staleness": "stale_ok"},
     "unknown staleness policy"),
    ({"schedule": tapi.RoundSchedule(group_rounds=(2, 1)), "staleness": "naive",
      "correction_init": "gradient"}, "async group rounds require correction_init='zero'"),
    ({"schedule": tapi.RoundSchedule(group_rounds=(2, 1)), "staleness": "naive",
      "server_lr": 0.5}, "async group rounds require server_lr=1.0"),
    ({"schedule": tapi.RoundSchedule(group_rounds=(2, 1, 1))}, "one entry per group"),
    # The reference's rejections of a compressed spec, on the sharded backend.
    ({"backend": "sharded", "compression": tapi.CompressionPlan("int8_stochastic"),
      "correction_init": "gradient"}, "correction_init"),
    ({"backend": "sharded", "compression": tapi.CompressionPlan(group_mode="topk"),
      "server_lr": 0.5}, "server_lr"),
    ({"backend": "sharded", "compression": tapi.CompressionPlan(client_mode="fp4")},
     "unknown client_mode"),
    ({"backend": "sharded", "compression": tapi.CompressionPlan(topk_frac=0.0)},
     "topk_frac"),
    pytest.param({"backend": "sharded", "levels": (2, 2, 2),
                  "compression": tapi.CompressionPlan("int8_stochastic")},
                 "3-level topologies need backend='multilevel', got 'sharded'",
                 id="kwargs25-two-level"),
])
def test_invalid_specs_raise(kwargs, match):
    with pytest.raises(ValueError, match=match):
        tapi.ExperimentSpec(**kwargs).validate()


@pytest.mark.parametrize("layout", ["flat", "tree"])
@pytest.mark.parametrize("modes", [("bf16", "none"), ("int8_stochastic", "none"),
                                   ("topk", "none"), ("none", "bf16"),
                                   ("none", "int8_stochastic"), ("none", "topk")])
def test_sharded_compression_validates_and_builds(modes, layout):
    """A compressed sharded spec validates, builds, carries the residuals
    its plan feeds back (and a generator for a stochastic plan), and runs a
    round on the CPU for every mode on either link."""
    plan = tapi.CompressionPlan(*modes, topk_frac=0.2)
    spec = tapi.ExperimentSpec(levels=(2, 2), backend="sharded", state_layout=layout,
                               schedule=tapi.RoundSchedule(1, 1), compression=plan)
    assert spec.validate() is spec
    eng = tapi.build(spec, lambda p, b: 0.5 * torch.sum((b["a"] * p["w"] - 1.0) ** 2),
                     device="cpu")
    state = eng.init({"w": torch.zeros(6)})
    assert (state.efc is not None, state.efg is not None) == (plan.ef_client, plan.ef_group)
    assert (state.rng is not None) == plan.stochastic
    batch = {"a": torch.arange(24, dtype=torch.float32).reshape(1, 1, 1, 2, 2, 6) / 10 + 1}
    state, m = eng.round_fn(state, batch)
    assert torch.isfinite(m.loss).all() and m.comm_bytes.item() > 0


def test_round_builder_rejects_later_slice_plans():
    """Async plans build, with the reference's rejections of a plan that
    does not fit the config, of compression under an async plan and of the
    gradient init or a server lr under one; faults, defense, compression
    and partial participation build, with the reference's rejections of a
    fault plan, a defense or compression under the gradient init or a
    server lr, and of a fault rate outside [0, 1)."""
    from repro_torch.core.staleness import StalenessPlan

    cfg = HFLConfig()
    plan = StalenessPlan((2, 1), "discount")
    assert callable(_build_global_round(lambda p, b: None, cfg, plan=plan))
    for bad, match in ((StalenessPlan((2, 1, 1), "naive"), "covers 3 groups"),
                       (StalenessPlan((3, 1), "naive"), "padded loop length")):
        with pytest.raises(ValueError, match=match):
            _build_global_round(lambda p, b: None, cfg, plan=bad)
    with pytest.raises(ValueError, match="async schedule"):
        _build_global_round(lambda p, b: None, cfg, plan=plan,
                            compression=tapi.CompressionPlan("bf16"))
    for kw, match in (({"correction_init": "gradient"}, "correction_init='zero'"),
                      ({"server_lr": 0.5}, "server_lr=1.0")):
        with pytest.raises(ValueError, match=match):
            _build_global_round(lambda p, b: None, HFLConfig(**kw), plan=plan)
    for kw in ({"faults": tapi.FaultPlan(crash_rate=0.1)}, {"defense": tapi.DefensePlan()}):
        assert callable(_build_global_round(lambda p, b: None, cfg, **kw))
        with pytest.raises(ValueError, match="correction_init='zero'"):
            _build_global_round(lambda p, b: None, HFLConfig(correction_init="gradient"), **kw)
        with pytest.raises(ValueError, match="server_lr=1.0"):
            _build_global_round(lambda p, b: None, HFLConfig(server_lr=0.5), **kw)
    with pytest.raises(ValueError, match="crash_rate"):
        _build_global_round(lambda p, b: None, cfg, faults=tapi.FaultPlan(crash_rate=1.0))
    plan = tapi.CompressionPlan("int8_stochastic", "topk")
    assert callable(_build_global_round(lambda p, b: None, cfg, compression=plan))
    assert callable(_build_global_round(lambda p, b: None,
                                        HFLConfig(client_participation=0.5,
                                                  group_participation=0.5),
                                        compression=plan))
    with pytest.raises(ValueError, match="correction_init='zero'"):
        _build_global_round(lambda p, b: None, HFLConfig(correction_init="gradient"),
                            compression=plan)
    with pytest.raises(ValueError, match="server_lr=1.0"):
        _build_global_round(lambda p, b: None, HFLConfig(server_lr=0.5), compression=plan)
    with pytest.raises(ValueError, match="unknown client_mode"):
        _build_global_round(lambda p, b: None, cfg,
                            compression=tapi.CompressionPlan("int4"))
    # A disabled plan is the uncompressed round (nothing to validate).
    assert callable(_build_global_round(lambda p, b: None, HFLConfig(server_lr=0.5),
                                        compression=tapi.CompressionPlan()))


def test_hfl_config_round_trip():
    spec = tapi.ExperimentSpec(levels=(3, 4), algorithm="fedprox", prox_mu=0.1,
                               state_layout="tree")
    assert tapi.ExperimentSpec.from_hfl_config(spec.to_hfl_config()) == spec


def test_uniform_tuple_schedule_is_accepted():
    spec = tapi.ExperimentSpec(levels=(2, 2), schedule=tapi.RoundSchedule(group_rounds=(3, 3)))
    assert spec.validate().to_hfl_config().group_rounds == 3


def test_default_device_is_cuda_and_never_a_quiet_cpu_run():
    """Without ``device=``, build and hfl_init ask for the CUDA card; on a
    host without one they raise instead of running on the CPU."""
    init, apply = tsmall.mlp(10, 4, hidden=8)
    p = init(torch.Generator().manual_seed(0), device="cpu")
    spec = tapi.ExperimentSpec(levels=(2, 2))
    if torch.cuda.is_available():
        assert tapi.build(spec, tsmall.make_loss(apply)).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tapi.build(spec, tsmall.make_loss(apply))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        hfl_init(p, HFLConfig())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tapi.build(spec, tsmall.make_loss(apply), device="cuda")
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        tapi.build(spec, tsmall.make_loss(apply), device="meta")
    assert tapi.build(spec, tsmall.make_loss(apply), device="cpu").device.type == "cpu"


@pytest.mark.parametrize("factory", ["mlp", "deep_mlp", "cnn"])
def test_small_init_defaults_to_the_card(factory):
    """A small model's ``init(gen)`` puts the params on the CUDA card and
    raises on a host without one; ``device="cpu"`` draws the same weights
    from the same seed."""
    args = {"mlp": (10, 4), "deep_mlp": (10, 4), "cnn": (10, (8, 8, 1))}[factory]
    init, _ = getattr(tsmall, factory)(*args)
    cpu = init(torch.Generator().manual_seed(0), device="cpu")
    assert all(t.device.type == "cpu" for t in cpu["out"].values())
    if torch.cuda.is_available():
        card = init(torch.Generator().manual_seed(0))
        assert card["out"]["w"].device.type == "cuda"
        assert torch.equal(card["out"]["w"].cpu(), cpu["out"]["w"])
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init(torch.Generator().manual_seed(0))


def test_wire_bytes_match_reference_and_compression_waits():
    """The wire model equals the reference's, uncompressed and under every
    compression mode and plan."""
    import jax
    import numpy as np

    from repro.core import compression as jcmp
    from repro_torch import convert
    from repro_torch.core import compression as tcmp
    stacked = {"a": np.zeros((2, 3, 4, 5), np.float32), "b": np.zeros((2, 3, 7), np.float32)}
    jsizes = jcmp.model_leaf_sizes(jax.tree.map(np.asarray, stacked))
    tstacked = convert.params_from_numpy(stacked, "cpu")
    assert tcmp.model_leaf_sizes(tstacked) == jsizes
    assert tcmp.upload_bytes(jsizes) == jcmp.upload_bytes(jsizes, "none")
    want = float(jcmp.round_comm_bytes(stacked, None, 2 * 2 * 3, 2))
    assert tcmp.round_comm_bytes(tstacked, None, 2 * 2 * 3, 2).item() == want
    for mode in ("bf16", "int8_stochastic", "topk"):
        for frac in (0.01, 0.3, 1.0):
            assert tcmp.upload_bytes(jsizes, mode, frac) == jcmp.upload_bytes(jsizes, mode, frac)
    jplan = japi.CompressionPlan("int8_stochastic", "topk", topk_frac=0.2)
    tplan = tapi.CompressionPlan("int8_stochastic", "topk", topk_frac=0.2)
    want = float(jcmp.round_comm_bytes(stacked, jplan, 7, 2))
    assert tcmp.round_comm_bytes(tstacked, tplan, torch.tensor(7.0), 2).item() == want
    with pytest.raises(ValueError, match="unknown compression mode"):
        tcmp.upload_bytes(jsizes, "int4")
