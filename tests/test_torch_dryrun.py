"""The port's dry run on ``meta`` (repro_torch.launch.dryrun) against the
reference's (src/repro/launch/dryrun.py).

* ``n_params`` and ``n_active`` equal the reference's ``_active_params``
  over ``jax.eval_shape(bundle.init, ...)`` for all 10 archs at full width.
* ``tokens`` and ``model_flops`` of ``train_4k``, ``prefill_32k`` and
  ``decode_32k`` equal the reference's ``build_case`` formulas, taken from
  ``repro.configs.shapes.train_specs`` and ``SHAPES`` without a mesh.
* A serve step at full width and a training round at full width (one
  layer, the plan's batch folded into fewer microbatches) run on ``meta``:
  every record field, the state's bytes, the kernels' calls, the roofline
  terms on the H100's spec-sheet figures; ``long_500k`` skips full
  attention as the reference does; the CLI writes its records.
"""
import ast
import json
from pathlib import Path

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.configs import get_plan as jget_plan  # noqa: E402
from repro.configs.shapes import SHAPES as JSHAPES  # noqa: E402
from repro.configs.shapes import train_specs as jtrain_specs  # noqa: E402
from repro.models.transformer import build_model as jbuild  # noqa: E402
from repro_torch.configs import ARCH_IDS  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402


def _reference_function(name: str):
    """A function of src/repro/launch/dryrun.py, taken from its source: the
    module itself must not be imported here, as importing it sets XLA_FLAGS
    to 512 host devices for the whole process (and every child it starts)."""
    path = Path(__file__).resolve().parents[1] / "src" / "repro" / "launch" / "dryrun.py"
    tree = ast.parse(path.read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == name)
    namespace: dict = {}
    exec(compile(ast.Module([fn], []), str(path), "exec"), namespace)
    return namespace[name]


jactive = _reference_function("_active_params")


def _reference_tokens(arch: str, shape: str) -> tuple[int, int]:
    """(tokens, flops_mult) by the reference's build_case formulas."""
    s = JSHAPES[shape]
    if s["kind"] == "train":
        lead = jtrain_specs(jget_arch(arch), jget_plan(arch))["tokens"].shape
        tokens = 1
        for d in lead[:-1]:
            tokens *= d
        return tokens * s["seq_len"], 6
    return s["global_batch"] * (s["seq_len"] if s["kind"] == "prefill" else 1), 2


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_params_tokens_and_model_flops_match_reference(arch):
    cfg = jget_arch(arch)
    sds = jax.eval_shape(jbuild(cfg).init, jax.random.PRNGKey(0))
    want = jactive(sds, cfg.num_experts, cfg.top_k)
    for shape in ("train_4k", "prefill_32k", "decode_32k"):
        _, meta = dryrun.build_case(arch, shape)
        assert (meta["n_params"], meta["n_active"]) == want
        tokens, mult = _reference_tokens(arch, shape)
        assert (meta["tokens"], meta["flops_mult"]) == (tokens, mult), shape
        assert meta["flops_mult"] * meta["n_active"] * meta["tokens"] == mult * want[1] * tokens
        assert meta["per_device"] == dryrun.PER_DEVICE_WAITS


def test_serve_step_at_full_width_on_meta():
    rec = dryrun.run_case("glm4-9b", "decode_32k", verbose=False)
    assert rec["status"] == "ok", rec.get("error")
    keys = {"n_params", "n_active", "tokens", "flops_mult", "model_flops", "flops", "bytes",
            "collectives", "by_scope", "useful_flops_ratio", "state_bytes", "peak_bytes",
            "terms", "dominant", "per_device", "hardware"}
    assert keys <= set(rec)
    cfg = jget_arch("glm4-9b")
    cache = 2 * cfg.num_layers * 128 * 32768 * cfg.num_kv_heads * cfg.d_head * 2   # bf16 K, V
    assert rec["state_bytes"] == cache
    assert rec["peak_bytes"] >= rec["input_bytes"] >= cache + 2 * rec["n_params"]
    assert rec["flops"] > rec["model_flops"] > 0 and rec["collective_bytes"] == 0
    assert {"attn", "mlp"} <= set(rec["by_scope"])
    t = rec["terms"]
    assert t["memory_s"] == rec["bytes"] / dryrun.HBM_BW and rec["dominant"] == "memory_s"
    assert t["compute_s"] == pytest.approx(
        rec["flops_by_kind"]["bf16"] / 989e12 + rec["flops_by_kind"]["f32"] / 67e12)
    assert rec["hardware"]["card"].startswith("H100 SXM")


def test_training_round_at_full_width_on_meta():
    """One full-width layer, the plan's per-client batch in one microbatch
    of 32 and one local step: G x K = 8 client passes, each under remat."""
    over = {"num_layers": 1, "dryrun_E": 1, "dryrun_H": 1, "microbatch": 8}
    rec = dryrun.run_case("glm4-9b", "train_4k", overrides=over, verbose=False)
    assert rec["status"] == "ok", rec.get("error")
    assert rec["batch_lead"] == [1, 1, 1, 4, 2, 32]
    assert rec["tokens"] == 8 * 32 * 4096
    k = rec["kernels"]
    assert k["flash_attention"]["calls"] == 16 and k["flash_attention_bwd"]["calls"] == 8
    G, K = 4, 2
    n_bytes = 2 * rec["n_params"]                                  # bf16 params
    assert rec["state_bytes"] == (2 * G * K + G) * n_bytes         # params, z, y
    # The embedding table's params count in the model's 6 N D but do no
    # products (a lookup), so one layer counts above its 6 N D.
    assert 1.0 < rec["useful_flops_ratio"] < 2.0
    assert {"attn", "mlp", "xent", "embed", "group_agg", "global_agg"} <= set(rec["by_scope"])


def test_long_context_skips_full_attention():
    assert dryrun.run_case("glm4-9b", "long_500k", verbose=False)["status"] == "skip"
    rec = dryrun.run_case("rwkv6-1.6b", "long_500k", verbose=False)
    assert rec["status"] == "ok" and rec["tokens"] == 1


def test_cli_writes_records(tmp_path, capsys):
    rc = dryrun.main(["--arch", "rwkv6-1.6b", "--shape", "prefill_32k", "--shape", "long_500k",
                      "--out", str(tmp_path), "--tag", "t"])
    assert rc == 0
    recs = {s: json.loads((tmp_path / f"rwkv6-1.6b__{s}__t.json").read_text())
            for s in ("prefill_32k", "long_500k")}
    assert all(r["status"] == "ok" for r in recs.values())
    assert recs["prefill_32k"]["kernels"]["rwkv6_scan"]["calls"] == 24   # one a layer
    assert "ok=2 skip=0 error=0" in capsys.readouterr().out
