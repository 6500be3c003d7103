"""The port's auditor (repro_torch.analysis + repro_torch.launch.audit)
against the reference's (tests/test_audit.py).

The matrix is the reference's, case for case; every invariant is clean on
every case on the CPU; and every check can FAIL: each planted fault (a
sharded round that returns a clone of its state, a driver that keeps the
old state alive, a float64 cast, a z widened to float32 under bfloat16
corrections, an expected call count off by one or on the wrong wrapper, a
link mode that does not shrink, an unlisted host sync, a count that
depends on the route) trips its check, and the clean path does not. The kernel calls one chunk makes equal the reference's
``pallas_call`` sites times the trips its spec gives.
"""
import dataclasses
import json
import sys
import time
import weakref

import numpy as np
import pytest

pytest.importorskip("torch")

import torch  # noqa: E402
from torch.overrides import TorchFunctionMode  # noqa: E402

from repro.analysis import invariants as rinv  # noqa: E402
from repro.analysis import specs as rspecs  # noqa: E402
from repro_torch import api as tapi  # noqa: E402
from repro_torch.analysis import budgets, invariants, specs  # noqa: E402
from repro_torch.launch import audit  # noqa: E402

CASES = specs.audit_cases()
# The two fused sharded cases: "interpret" in the reference, "auto" here.
FUSED_MODE_DEPARTURE = {"sharded_mtgc_flat_fused", "sharded_compressed_topk_tree"}


def _lower(case, **kw):
    engine = case.build_engine()
    return engine, engine.lower_chunk(specs.abstract_data(engine),
                                      params=specs.abstract_params(), **kw)


def _plain(obj):
    """A spec's fields as plain values (nested plans as dicts)."""
    return {f.name: (dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v)
            for f in dataclasses.fields(obj) for v in (getattr(obj, f.name),)}


# ------------------------------------------------------------- the matrix


def test_matrix_matches_reference():
    ref = rspecs.audit_cases()
    assert [c.name for c in CASES] == [c.name for c in ref]
    assert [c.fast for c in CASES] == [c.fast for c in ref]
    assert [c.name for c in specs.audit_cases(fast_only=True)] == [
        c.name for c in rspecs.audit_cases(fast_only=True)]
    for mine, theirs in zip(CASES, ref):
        got, want = _plain(mine.spec), _plain(theirs.spec)
        if mine.name in FUSED_MODE_DEPARTURE:
            assert (got.pop("fused_mode"), want.pop("fused_mode")) == ("auto", "interpret")
        assert got == want, mine.name
    assert specs.case_by_name("sim_mtgc_tree").spec.backend == "simulator"
    with pytest.raises(KeyError, match="unknown audit case"):
        specs.case_by_name("nope")


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.name)
def test_every_invariant_clean_on_cpu(case):
    """Every check clean, and no copy of host data to the device in the
    chunk's rounds: constants are filled on the device (``torch.full``),
    host arrays go over without waiting (``non_blocking``). The card's audit
    found such copies in ``round_comm_bytes``, the fault payload and screen,
    the async cadence and the async plan's constants (ROADMAP queue 3 item
    26); on that code 16 of the 17 cases copy."""
    with _HostUploads() as watch:
        engine, lc = _lower(case)
    assert watch.sites == []
    found = invariants.run_invariants(case, lc) + invariants.check_retrace(case.name)
    assert [str(f) for f in found if f.severity == "error"] == []
    assert sum(lc.calls.values()) == case.expected_calls
    assert lc.costs.flops > 0 and lc.costs.bytes > 0
    assert {f.check for f in found} >= {"host-sync", "retrace"}   # the CPU's notes
    # The checked-in budget of the case holds, strictly (whatever the stamp).
    drift = budgets.check({case.name: budgets.measure(lc)}, strict=True, complete=False)
    assert [str(f) for f in drift] == []


def _sites_times_trips(jaxpr, mult=1) -> int:
    """pallas_call sites of a reference jaxpr, each times its enclosing
    scans' lengths (a cond counts its busiest branch)."""
    total = 0
    for eqn in jaxpr.eqns:
        name = eqn.primitive.name
        if name == "pallas_call":
            total += mult
            continue
        subs = list(rinv._sub_jaxprs(eqn))
        if not subs:
            continue
        if name == "scan":
            total += sum(_sites_times_trips(s, mult * eqn.params["length"]) for s in subs)
        elif name == "cond":
            total += max(_sites_times_trips(s, mult) for s in subs)
        elif name == "while":
            assert sum(_sites_times_trips(s) for s in subs) == 0, "a kernel in a while loop"
        else:
            total += sum(_sites_times_trips(s, mult) for s in subs)
    return total


@pytest.mark.parametrize("case", specs.audit_cases(fast_only=True), ids=lambda c: c.name)
def test_kernel_calls_equal_reference_sites_times_trips(case):
    ref = rspecs.case_by_name(case.name)
    eng = ref.build_engine()
    rlc = eng.lower_chunk(rspecs.abstract_data(eng), params=rspecs.abstract_params(),
                          compile=False)
    want = _sites_times_trips(rlc.jaxpr)
    assert rinv.count_primitive(rlc.jaxpr, "pallas_call") == ref.fused_leaves
    _, lc = _lower(case)
    assert sum(lc.calls.values()) == want == case.expected_calls


# ---------------------------------------------------------- the front door


def test_abstract_state_is_meta_and_lower_chunk_complete():
    case = specs.case_by_name("sim_mtgc_flat_fused")
    engine = case.build_engine()
    assert isinstance(engine, tapi.Engine)
    state = engine.abstract_state(specs.abstract_params())
    tensors = [t for t in _leaves(state)]
    assert tensors and all(t.device.type == "meta" for t in tensors)
    lc = engine.lower_chunk(specs.abstract_data(engine), params=specs.abstract_params())
    assert isinstance(lc, tapi.LoweredChunk) and lc.ops and lc.donate
    assert [(t.dtype, t.shape) for t in _leaves(lc.state)] == [
        (t.dtype, t.shape) for t in _leaves(lc.out_state)]
    assert all(t.device.type == "meta" for t in _leaves(lc.state))
    assert lc.calls["mtgc_update_flat"] == case.expected_calls
    # A sharded state with a generator: the generator stays a generator.
    sharded = specs.case_by_name("sharded_mtgc_flat_fused").build_engine()
    st = sharded.abstract_state({"w": torch.zeros(6)})
    assert all(t.device.type == "meta" for t in _leaves(st))


def _leaves(state):
    from repro_torch.core.driver import _state_tensors

    return _state_tensors(state)


# ------------------------------------------------------------- donation


def test_donation_trips_on_a_cloned_sharded_state():
    case = specs.case_by_name("sharded_mtgc_flat_fused")
    engine, lc = _lower(case)
    assert invariants.check_donation("c", lc) == []
    inner = engine.round_fn

    def cloning(state, batches, draws=None):
        state, met = inner(state, batches, draws=draws)
        from repro_torch.core.tree import tree_map
        return state._replace(params=tree_map(torch.clone, state.params)), met

    engine.round_fn = cloning
    bad = engine.lower_chunk(specs.abstract_data(engine), params=specs.abstract_params())
    found = invariants.check_donation("c", bad)
    assert found and found[0].severity == "error" and "did not stay in place" in found[0].message
    assert "1/3" in found[0].message
    undonated = engine.lower_chunk(specs.abstract_data(engine), params=specs.abstract_params(),
                                   donate=False)
    assert [f.severity for f in invariants.check_donation("c", undonated)] == ["note"]


def test_donation_trips_on_a_driver_that_keeps_the_old_state():
    case = specs.case_by_name("sim_mtgc_flat_fused")
    engine, lc = _lower(case)
    assert invariants.check_donation("c", lc) == []
    kept, inner = [], engine.round_fn

    def keeping(state, batches, draws=None):
        kept.append(state)
        return inner(state, batches) if draws is None else inner(state, batches, draws=draws)

    engine.round_fn = keeping
    bad = engine.lower_chunk(specs.abstract_data(engine), params=specs.abstract_params())
    found = invariants.check_donation("c", bad)
    assert found and "outlived the chunk" in found[0].message
    kept.clear()


# --------------------------------------------------------- f64 / dtypes


def test_f64_check_trips_on_a_float64_cast():
    case = specs.case_by_name("sim_mtgc_tree")
    _, lc = _lower(case)
    assert invariants.check_no_f64("c", lc) == []

    def wide_loss(params, batch):
        r = batch["a"].double() * params["w"] - batch["b"]
        return (0.5 * torch.sum(r * r)).float()

    engine = case.build_engine(loss_fn=wide_loss)
    bad = engine.lower_chunk(specs.abstract_data(engine), params=specs.abstract_params())
    found = invariants.check_no_f64("c", bad)
    assert found and all(f.severity == "error" for f in found)
    assert "float64" in found[0].message and "aten." in found[0].message


def test_correction_dtype_honored_and_tripped():
    case = specs.case_by_name("sharded_mtgc_tree_bf16")
    _, lc = _lower(case)
    assert invariants.check_correction_dtype("c", lc, case.spec) == []
    wide = {k: torch.empty(v.shape, dtype=torch.float32, device="meta")
            for k, v in lc.state.z.items()}
    bad = lc._replace(state=lc.state._replace(z=wide))
    found = invariants.check_correction_dtype("c", bad, case.spec)
    assert found and "float32" in found[0].message and "input" in found[0].message
    out_wide = lc._replace(out_state=lc.out_state._replace(
        z={k: v.float() for k, v in lc.out_state.z.items()}))
    assert "output" in invariants.check_correction_dtype("c", out_wide, case.spec)[0].message


# --------------------------------------------------------------- fusion


def test_fusion_contract_both_directions():
    unfused = specs.case_by_name("sim_mtgc_tree")
    _, lc = _lower(unfused)
    assert unfused.expected_by_wrapper == {}
    assert invariants.check_fusion("c", lc, {}) == []
    trip = invariants.check_fusion("c", lc, {"mtgc_update": 1})
    assert trip and "expected 1" in trip[0].message
    fused = specs.case_by_name("sim_compressed_int8_flat")
    _, lc_f = _lower(fused)
    want = fused.expected_by_wrapper
    assert want == {"mtgc_update_flat": 8, "int8_roundtrip": 6} and fused.expected_calls == 14
    assert invariants.check_fusion("f", lc_f, want) == []
    for off in (dict(want, int8_roundtrip=5), dict(want, int8_roundtrip=7), {}):
        found = invariants.check_fusion("f", lc_f, off)
        assert found and f"expected {sum(off.values())}" in found[0].message
    # The same number of calls on the wrong wrappers trips too: the tree
    # layout's per-leaf update in place of the flat one, a top-k round trip
    # in place of int8's.
    for wrong in ({"mtgc_update": 8, "int8_roundtrip": 6},
                  {"mtgc_update_flat": 8, "topk_mask": 6}):
        found = invariants.check_fusion("f", lc_f, wrong)
        assert found and "expected 14" in found[0].message


def test_expected_calls_by_wrapper_follow_the_spec():
    """Each fused case's calls by wrapper, from the spec alone: the update's
    wrapper by backend and layout, a link's by its mode."""
    got = {c.name: c.expected_by_wrapper for c in CASES if c.expected_calls}
    assert got == {
        "sim_mtgc_flat_fused": {"mtgc_update_flat": 8},
        "sharded_mtgc_flat_fused": {"mtgc_update_flat": 8},
        "sim_compressed_int8_flat": {"mtgc_update_flat": 8, "int8_roundtrip": 6},
        "sharded_compressed_topk_tree": {"mtgc_update_flat": 8, "topk_mask": 8},
    }
    tree = dataclasses.replace(specs.case_by_name("sim_mtgc_tree"), spec=dataclasses.replace(
        specs.case_by_name("sim_mtgc_tree").spec, fusion="fused"))
    assert tree.expected_by_wrapper == {"mtgc_update": 8}
    _, lc = _lower(tree)
    assert invariants.nonzero_counts(lc.calls) == {"mtgc_update": 8}
    assert invariants.check_fusion("t", lc, tree.expected_by_wrapper) == []


def test_fusion_on_the_card_holds_launches_and_profiler_counts():
    """On a CUDA chunk the check also holds the kernels' launches and the
    profiler's count, wrapper by wrapper (here a recorded chunk with its
    device stated)."""
    _, lc = _lower(specs.case_by_name("sim_mtgc_flat_fused"))
    card = lc._replace(device=torch.device("cuda"), launches=dict(lc.calls),
                       profiled=dict(lc.calls))
    want = {"mtgc_update_flat": 8}
    assert invariants.check_fusion("c", card, want) == []
    short = dict(lc.calls, mtgc_update_flat=7)
    found = invariants.check_fusion("c", card._replace(launches=short), want)
    assert "launched 7" in found[0].message
    found = invariants.check_fusion("c", card._replace(profiled=short), want)
    assert found and "torch.profiler saw 7" in found[0].message
    swapped = dict(lc.calls, mtgc_update_flat=0, mtgc_update=8)
    found = invariants.check_fusion("c", card._replace(profiled=swapped), want)
    assert found and "torch.profiler saw 8" in found[0].message
    found = invariants.check_fusion("c", card._replace(launches=swapped), want)
    assert found and "launched 8" in found[0].message
    assert invariants.check_fusion("c", card._replace(profiled=None), want)[0].severity == "note"


# ------------------------------------------------------------ host sync


def test_host_sync_known_sites_note_and_unlisted_error():
    _, lc = _lower(specs.case_by_name("sim_mtgc_tree"))
    assert [f.severity for f in invariants.check_host_sync("c", lc)] == ["note"]
    known = ("launch/train.py", 574, "round_fn",
             "host = torch.cat(host).cpu().numpy() != 0 if host else None")
    stray = ("core/engine.py", 10, "round_fn", "x = t.item()")
    found = invariants.check_host_sync("c", lc._replace(syncs=[known, known]))
    assert [f.severity for f in found] == ["note"] and "x2" in found[0].message
    found = invariants.check_host_sync("c", lc._replace(syncs=[known, stray, None]))
    assert sorted(f.severity for f in found) == ["error", "error", "note"]
    assert any("core/engine.py:10" in f.message for f in found)
    assert invariants.check_host_sync("c", lc._replace(syncs=[])) == []
    # Known by file, function and text, wherever the line moves to; the
    # same text in another function is not.
    moved = ("launch/train.py", 9999) + known[2:]
    assert [f.severity for f in invariants.check_host_sync("c", lc._replace(syncs=[moved]))] \
        == ["note"]
    elsewhere = known[:2] + ("make_sharded_round",) + known[3:]
    assert [f.severity for f in invariants.check_host_sync(
        "c", lc._replace(syncs=[elsewhere]))] == ["error"]


def test_known_syncs_sit_on_host_copies_of_the_sharded_round():
    """Each listed text of launch/train.py copies to the host (or compares
    on it) and stands, once, in the function the table names."""
    import ast
    from pathlib import Path

    import repro_torch

    path = Path(repro_torch.__file__).parent / "launch" / "train.py"
    src = path.read_text()
    lines = src.splitlines()
    funcs = [n for n in ast.walk(ast.parse(src))
             if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
    for (file, func, text), what in invariants.KNOWN_SYNCS.items():
        assert file == "launch/train.py"
        assert ".cpu()" in text or "torch.equal" in text, (text, what)
        hits = [i for i, line in enumerate(lines, 1) if text in line]
        assert len(hits) == 1, (text, hits)
        inner = max((n for n in funcs if n.lineno <= hits[0] <= n.end_lineno),
                    key=lambda n: n.lineno)
        assert inner.name == func, (text, inner.name, func)


def test_sync_site_names_the_function_around_a_generator_and_its_text():
    """``_port_frame`` gives a frame's file under the port, line, innermost
    named function (a generator expression's is the function around it)
    and source text: the keys the known table matches on."""
    import linecache

    from repro_torch.core import driver

    fake = "/nowhere/repro_torch/launch/train.py"
    src = ("def agree(t3, g, ks):\n"
           "    return all(torch.equal(t3[g, k], t3[g, ks[0]]) for k in ks[1:])\n")
    sites = []

    class _Torch:
        @staticmethod
        def equal(a, b):
            sites.append(driver._port_frame(sys._getframe(1)))
            return True

    linecache.cache[fake] = (len(src), None, src.splitlines(True), fake)
    try:
        ns = {"torch": _Torch}
        exec(compile(src, fake, "exec"), ns)
        assert ns["agree"](np.zeros((1, 2)), 0, [0, 1])
    finally:
        linecache.cache.pop(fake, None)
    assert sites == [("launch/train.py", 2, "agree",
                      "return all(torch.equal(t3[g, k], t3[g, ks[0]]) for k in ks[1:])")]
    assert invariants.known_sync(sites[0]) == \
        "the phase-start model's agreement test (torch.equal)"


def test_retrace_is_a_note():
    assert [f.severity for f in invariants.check_retrace("c")] == ["note"]


# ------------------------------------------------------------ comm model


def test_comm_model_trips_on_a_link_that_does_not_shrink():
    case = specs.case_by_name("sim_compressed_int8_flat")
    model, found = audit._check_comm_model(case, specs.abstract_params())
    assert found == [] and model["client_upload_bytes"] < model["uncompressed_upload_bytes"]
    bf16 = dataclasses.replace(case, spec=dataclasses.replace(
        case.spec, compression=tapi.CompressionPlan(client_mode="bf16", group_mode="none")))
    params = {"w": torch.empty(6, dtype=torch.bfloat16, device="meta")}
    _, found = audit._check_comm_model(bf16, params)
    assert found and found[0].check == "comm-budget" and "not smaller" in found[0].message


# --------------------------------------------------------------- budgets


def test_budget_doubled_E_trips_flops(tmp_path):
    case = specs.case_by_name("sim_mtgc_tree")
    _, lc = _lower(case)
    ref = budgets.measure(lc)
    doc = budgets.save({case.name: ref}, tmp_path / "budgets.json")
    assert budgets.check({case.name: ref}, doc, strict=True) == []
    doubled = dataclasses.replace(case.spec, schedule=dataclasses.replace(
        case.spec.schedule, group_rounds=2 * case.spec.schedule.group_rounds)).validate()
    eng2 = tapi.build(doubled, specs.quad_loss, device="cpu")
    lc2 = eng2.lower_chunk(specs.abstract_data(eng2), params=specs.abstract_params())
    drifted = budgets.measure(lc2)
    assert drifted["flops"] > 1.5 * ref["flops"]
    found = budgets.check({case.name: drifted}, doc, strict=True)
    assert any(f.check == "budget" and "flops drifted" in f.message for f in found)


def test_budget_env_mismatch_degrades_to_notes():
    doc = {"torch": "0.0.0", "device": "nonesuch", "rtol": 0.2,
           "specs": {"c": {"flops": 1.0, "bytes": 1.0, "collective_bytes": 0.0}}}
    got = {"c": {"flops": 100.0, "bytes": 100.0, "collective_bytes": 0.0}}
    found = budgets.check(got, doc)
    assert found and all(f.severity == "note" for f in found)
    assert any(f.severity == "error" for f in budgets.check(got, doc, strict=True))


def test_budget_route_check_holds_the_stamp_exactly():
    """A count from another route is held to the stamp to ROUTE_RTOL, as an
    error whatever the stamp: 128 bytes more in a case's 766 MB-sized count
    pass the 20% drift band but not this check."""
    case = specs.case_by_name("sim_async_discount_flat")
    _, lc = _lower(case)
    got = {case.name: budgets.measure(lc)}
    assert budgets.check_route(got) == []
    off = {case.name: dict(got[case.name], bytes=got[case.name]["bytes"] + 128)}
    assert budgets.check(off, strict=True, complete=False) == []
    found = budgets.check_route(off)
    assert [f.severity for f in found] == ["error"] and "depends on the route" in found[0].message
    assert [f.check for f in budgets.check_route({"nonesuch": got[case.name]})] == \
        ["budget-route"]


def test_checked_in_budgets_cover_the_full_matrix():
    doc = budgets.load()
    assert doc, "analysis/budgets.json missing"
    assert set(doc["specs"]) == {c.name for c in CASES}
    assert doc["device"] in ("cpu", "cuda") and doc["rtol"] == budgets.DEFAULT_RTOL


# ------------------------------------------------------------------- CLI


def test_audit_cli_single_case_and_report(tmp_path):
    report_path = tmp_path / "report.json"
    rc = audit.main(["--cases", "sim_mtgc_flat_fused", "-q", "--report", str(report_path)])
    assert rc == 0
    report = json.loads(report_path.read_text())
    assert report["ok"] and report["cases"] == ["sim_mtgc_flat_fused"]
    assert set(report) >= {"mode", "cases", "programs", "lint", "errors", "notes", "elapsed_s",
                           "ok", "torch", "device"}
    prog = report["programs"]["sim_mtgc_flat_fused"]
    assert prog["kernel_calls"] == prog["expected_calls"] == 8
    assert prog["kept"] == [] and prog["flops"] > 0 and report["device"] == "cpu"


def test_audit_cli_update_roundtrip(tmp_path):
    path = tmp_path / "budgets.json"
    assert audit.main(["--cases", "sim_mtgc_tree", "-q", "--update",
                       "--budget-file", str(path)]) == 0
    assert json.loads(path.read_text())["torch"] == torch.__version__
    assert audit.main(["--cases", "sim_mtgc_tree", "-q", "--strict-budgets",
                       "--budget-file", str(path)]) == 0


def test_audit_cli_fast_and_full_exit_zero(tmp_path):
    t0 = time.time()
    assert audit.main(["--fast", "-q", "--report", str(tmp_path / "fast.json")]) == 0
    report = json.loads((tmp_path / "fast.json").read_text())
    assert report["mode"] == "fast" and len(report["cases"]) == 11 and report["errors"] == []
    assert report["lint"]["files"] > 50 and time.time() - t0 < 60


def test_audit_cli_fails_on_an_error(tmp_path, monkeypatch):
    monkeypatch.setattr(specs.AuditCase, "expected_by_wrapper",
                        property(lambda self: {"mtgc_update": 99}))
    assert audit.main(["--cases", "sim_mtgc_tree", "-q"]) == 1


def test_audit_cli_list(capsys):
    assert audit.main(["--list"]) == 0
    out = capsys.readouterr().out
    assert "sharded_compressed_topk_tree" in out and "expected_calls=16" in out


# ------------------------------------------------- host uploads in a round


class _HostUploads(TorchFunctionMode):
    """The copies of host data to a named device a round makes: a tensor
    made from Python or numpy data with a ``device`` (``torch.tensor``,
    ``torch.as_tensor``), or a blocking ``.to(device)`` of a tensor made by
    ``torch.from_numpy``. On the card each is a copy from pageable memory
    that waits for the card's queue (``set_sync_debug_mode`` reports them);
    on the CPU this sees the same calls."""

    def __init__(self):
        super().__init__()
        self.sites, self._host = [], {}          # id -> weakref of from_numpy's tensors

    def __enter__(self):
        # torch.from_numpy takes no tensor, so no mode sees it: wrap it.
        self._from_numpy = torch.from_numpy

        def from_numpy(a):
            t = self._from_numpy(a)
            self._host[id(t)] = weakref.ref(t)
            return t

        torch.from_numpy = from_numpy
        return super().__enter__()

    def __exit__(self, *exc):
        torch.from_numpy = self._from_numpy
        return super().__exit__(*exc)

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        caller = sys._getframe(1)
        where = f"{caller.f_code.co_filename.rsplit('/repro_torch/', 1)[-1]}:{caller.f_lineno}"
        if (func in (torch.tensor, torch.as_tensor) and not isinstance(args[0], torch.Tensor)
              and kwargs.get("device") is not None):
            self.sites.append(where)
        elif (func is torch.Tensor.to and id(args[0]) in self._host
              and self._host[id(args[0])]() is args[0]
              and not kwargs.get("non_blocking")
              and (kwargs.get("device") is not None
                   or any(isinstance(a, (torch.device, str)) for a in args[1:]))):
            self.sites.append(where)
        return out


def test_host_upload_watch_trips():
    with _HostUploads() as watch:
        torch.tensor([1, 2], device="cpu")
        torch.from_numpy(np.zeros(3)).to("cpu")
        torch.from_numpy(np.zeros(3)).to("cpu", non_blocking=True)
        torch.full((), 2.0, device="cpu")
    assert len(watch.sites) == 2
