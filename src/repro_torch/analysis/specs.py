"""The representative spec matrix the auditor records (port of
``src/repro/analysis/specs.py``).

One :class:`AuditCase` per load-bearing corner of the configuration space
-- algorithms x {tree, flat} x {simulator, sharded, multilevel} x {sync,
async} x {faults, population} -- under the reference's 17 names, ``fast``
flags and ``ExperimentSpec`` fields, built through the port's ``build``.
Each is tiny (``DIM`` 6, every topology axis >= 2), because the auditor
runs one driver chunk of each (``Engine.lower_chunk``): on the CPU in
milliseconds, or on the card.

One stated departure: the reference pins ``fused_mode="interpret"`` on its
two fused sharded cases so that the Pallas kernels lower off-TPU. The
port's sharded round takes only None or ``"auto"`` (ROADMAP queue 3 item
8(e)), so those cases take ``"auto"``: on the CPU the wrappers' plain
route, on the card the kernels. Either way every call goes through the
wrappers, which is what the fusion check counts.

``abstract_params`` and ``abstract_data`` give ``meta`` tensors in the
engine's layout, which ``lower_chunk`` draws on its device.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.api import (
    CompressionPlan,
    DefensePlan,
    ExperimentSpec,
    FaultPlan,
    PackedBatches,
    RoundSchedule,
    build,
)

# Tiny but non-degenerate: every topology axis >= 2 so a transposed or
# dropped axis cannot run the same program by coincidence.
DIM = 6
BATCH = 2
SHARDS = 3
CHUNK = 2

# Upload modes that run a hand kernel (bf16 is a cast).
KERNEL_LINKS = ("int8_stochastic", "topk")
LINK_WRAPPERS = {"int8_stochastic": "int8_roundtrip", "topk": "topk_mask"}


def quad_loss(params, batch):
    """0.5 * ||a * w - b||^2 -- the conformance-suite loss; one dense
    param leaf keeps per-leaf kernel counts and cost budgets readable."""
    r = batch["a"] * params["w"] - batch["b"]
    return 0.5 * torch.sum(r * r)


def abstract_params(dim: int = DIM):
    return {"w": torch.empty((dim,), dtype=torch.float32, device="meta")}


def abstract_data(engine, *, dim: int = DIM, batch: int = BATCH,
                  shards: int = SHARDS) -> PackedBatches:
    """``meta`` :class:`PackedBatches` in this engine's driver layout.

    Leaves are ``[*levels, S, steps, B, D]`` with ``steps = local_steps *
    microbatches`` -- exactly what the engine's ``pack_arrays`` would
    upload, minus the upload; the generator is a CPU one (``lower_chunk``
    makes one on its device)."""
    spec = engine.spec
    steps = engine._pack_steps * (engine._pack_microbatches or 1)
    shape = tuple(spec.levels) + (shards, steps, batch, dim)

    def leaf():
        return torch.empty(shape, dtype=torch.float32, device="meta")

    return PackedBatches({"a": leaf(), "b": leaf()}, torch.Generator(), engine._pack_rounds,
                         engine._pack_steps, engine._pack_microbatches,
                         topo_ndim=len(spec.levels))


@dataclasses.dataclass(frozen=True)
class AuditCase:
    """One audited configuration.

    name: stable identifier -- the key into ``analysis/budgets.json``.
    spec: the :class:`ExperimentSpec` built through ``build``.
    fast: included in the blocking ``audit --fast`` subset.
    """

    name: str
    spec: ExperimentSpec
    fast: bool = True

    @property
    def expected_by_wrapper(self) -> dict[str, int]:
        """The kernel-route calls one chunk of ``CHUNK`` rounds makes, by
        wrapper (``kernels/ops.py::WRAPPERS``; wrappers it never calls are
        left out), from the spec alone.

        The reference's sites (its ``fused_leaves``): one update per
        correction buffer (quad_loss is one float32 leaf: one flat buffer,
        one tree leaf) and one round trip per kernel-backed compressed link
        (``int8_stochastic``, ``topk``; ``bf16`` is a cast). Each runs as
        often as its round phase does: the update once every local step of
        every group round (``E * H`` a round, E the padded group rounds),
        the client link once every group round (``E``; on the sharded
        backend once for each of the G groups, whose K uploads it sends as
        one block), the group link once a round. Times ``CHUNK`` rounds
        (DIM 6 is one column piece). The update is ``mtgc_update`` on the
        simulator's tree layout (once a leaf) and ``mtgc_update_flat``
        elsewhere (the sharded tree layout takes it once a leaf); a link
        takes ``int8_roundtrip`` or ``topk_mask`` by its mode. An unfused
        spec makes none: its updates and round trips take the plain
        versions directly.
        """
        spec = self.spec
        if spec.fusion != "fused":
            return {}
        E, H = spec.schedule.max_group_rounds, spec.schedule.local_steps
        tree_leaf = spec.state_layout == "tree" and spec.backend != "sharded"
        out = {"mtgc_update" if tree_leaf else "mtgc_update_flat": E * H}
        comp = spec.compression
        if comp is not None:
            groups = spec.levels[0] if spec.backend == "sharded" else 1
            for mode, n in ((comp.client_mode, E * groups), (comp.group_mode, 1)):
                if mode in KERNEL_LINKS:
                    w = LINK_WRAPPERS[mode]
                    out[w] = out.get(w, 0) + n
        return {w: n * CHUNK for w, n in out.items()}

    @property
    def expected_calls(self) -> int:
        """The kernel-route calls over every wrapper
        (:attr:`expected_by_wrapper`, summed)."""
        return sum(self.expected_by_wrapper.values())

    def build_engine(self, loss_fn=quad_loss, device="cpu"):
        return build(self.spec, loss_fn, device=device)


def _spec(**kw) -> ExperimentSpec:
    kw.setdefault("levels", (2, 3))
    kw.setdefault("schedule", RoundSchedule(group_rounds=2, local_steps=2))
    return ExperimentSpec(**kw).validate()


def audit_cases(fast_only: bool = False) -> list[AuditCase]:
    """The audited matrix; ``fast_only`` selects the blocking subset."""
    cases = [
        # -- simulator backend: both layouts, fused and reference paths.
        AuditCase("sim_mtgc_tree", _spec(
            algorithm="mtgc", state_layout="tree")),
        AuditCase("sim_mtgc_flat_fused", _spec(
            algorithm="mtgc", state_layout="flat", fusion="fused")),
        AuditCase("sim_hfedavg_flat", _spec(
            algorithm="hfedavg", state_layout="flat")),
        # -- sharded production round: fused flat ("auto": the kernel on the
        #    card, its plain version on the CPU) and the narrow-correction
        #    tree path.
        AuditCase("sharded_mtgc_flat_fused", _spec(
            algorithm="mtgc", backend="sharded", state_layout="flat",
            fusion="fused", fused_mode="auto",
            schedule=RoundSchedule(group_rounds=2, local_steps=2,
                                   microbatches=2))),
        AuditCase("sharded_mtgc_tree_bf16", _spec(
            algorithm="mtgc", backend="sharded", state_layout="tree",
            correction_dtype="bfloat16",
            schedule=RoundSchedule(group_rounds=2, local_steps=2,
                                   microbatches=2))),
        # -- M-level recursion (Appendix E), 3-level client-edge-cloud.
        AuditCase("multilevel_mtgc_3level", _spec(
            algorithm="mtgc", backend="multilevel", levels=(2, 2, 2),
            state_layout="tree",
            schedule=RoundSchedule(periods=(4, 2, 1)))),
        # -- async group rounds: padded straggler loop + staleness merge.
        AuditCase("sim_async_discount_flat", _spec(
            algorithm="mtgc", state_layout="flat", staleness="discount",
            schedule=RoundSchedule(group_rounds=(2, 1), local_steps=2))),
        # -- fault injection + screened aggregation + HT weighting.
        AuditCase("sim_faults_defended_flat", _spec(
            algorithm="mtgc", state_layout="flat",
            client_participation=0.7,
            participation_weighting="inverse_prob",
            faults=FaultPlan(crash_rate=0.1, timeout_rate=0.1,
                             corrupt_rate=0.1, corrupt_kind="explode"),
            defense=DefensePlan(screen_nonfinite=True, screen_norm=10.0))),
        # -- compressed uploads: kernel-backed quantize/top-k round trips
        #    at both links ride the fused dispatch, plus the modeled
        #    comm-budget shrink gate.
        AuditCase("sim_compressed_int8_flat", _spec(
            algorithm="mtgc", state_layout="flat", fusion="fused",
            compression=CompressionPlan(client_mode="int8_stochastic",
                                        group_mode="int8_stochastic"))),
        AuditCase("sharded_compressed_topk_tree", _spec(
            algorithm="mtgc", backend="sharded", state_layout="tree",
            fusion="fused", fused_mode="auto",
            compression=CompressionPlan(client_mode="topk",
                                        group_mode="bf16", topk_frac=0.1),
            schedule=RoundSchedule(group_rounds=2, local_steps=2,
                                   microbatches=2)), fast=False),
        # -- virtual population: cohort-shaped buffers + stateless wrap.
        AuditCase("sim_population_flat", _spec(
            algorithm="mtgc", state_layout="flat", population=8,
            cohort_size=3)),
        AuditCase("sim_stateless_flat", _spec(
            algorithm="mtgc", state_layout="flat", population=8,
            client_state="stateless")),
        # -- full-matrix extras (cheap, but redundant for the blocking
        #    gate): remaining simulator algorithms.
        AuditCase("sim_local_corr_tree", _spec(
            algorithm="local_corr", state_layout="tree"), fast=False),
        AuditCase("sim_group_corr_flat", _spec(
            algorithm="group_corr", state_layout="flat"), fast=False),
        AuditCase("sim_fedprox_flat", _spec(
            algorithm="fedprox", state_layout="flat", prox_mu=0.1),
            fast=False),
        AuditCase("sim_feddyn_flat", _spec(
            algorithm="feddyn", state_layout="flat", feddyn_alpha=0.1),
            fast=False),
        AuditCase("sharded_hfedavg_flat", _spec(
            algorithm="hfedavg", backend="sharded", state_layout="flat",
            schedule=RoundSchedule(group_rounds=2, local_steps=2,
                                   microbatches=2)), fast=False),
    ]
    if fast_only:
        cases = [c for c in cases if c.fast]
    names = [c.name for c in cases]
    assert len(names) == len(set(names)), "duplicate audit case names"
    return cases


def case_by_name(name: str) -> AuditCase:
    for c in audit_cases():
        if c.name == name:
            return c
    raise KeyError(f"unknown audit case {name!r} "
                   f"(see `python -m repro_torch.launch.audit --list`)")
