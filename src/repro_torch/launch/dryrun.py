"""Dry run at full width on ``meta``: ``python -m repro_torch.launch.dryrun``
(port of ``src/repro/launch/dryrun.py``).

For each (arch x shape) of ``configs/shapes.py::SHAPES`` this driver

1. builds the inputs on the ``meta`` device -- nothing is allocated: the
   parameters from ``configs/shapes.py::param_specs`` at full width and
   full depth, the batches from ``train_specs`` or ``serve_specs``, and the
   round state from the sharded engine's init (``Engine.abstract_state``);
2. runs one ``make_sharded_round`` round at the plan's ``dryrun_E`` /
   ``dryrun_H`` (the sharded engine's round, tree layout), or one prefill
   or decode step (``launch/serve.py::make_serve_step``), under the cost
   counter (``launch/cost_analysis.py``) with its live-bytes tracker; a
   decode step reads its cache position as a host integer, so it decodes at
   the last position of the shape's cache;
3. writes the reference's record where its fields have a meaning here:
   ``n_params``, ``n_active`` (the reference's ``_active_params`` rule),
   ``tokens``, ``flops_mult``, ``model_flops``, the counted ``flops``,
   ``bytes``, ``collectives`` and ``by_scope``, ``useful_flops_ratio``, the
   state's bytes and a peak from the tracker, and the three roofline terms
   on one H100 SXM -- 989 TFLOP/s bf16 dense (tensor cores), 67 TFLOP/s
   float32, 3.35 TB/s HBM3, NVLink 450 GB/s each way -- figures of the
   card's spec sheet, not measurements.

The record counts the whole program, on one device. Per-device figures
exist only over the mesh axes the port runs, ``group`` and ``client``;
every plan has an ``fsdp`` or ``model`` factor above 1 (and serving runs
over the physical ``model`` axis), so each record says ``"per_device":
"waits for ROADMAP queue 1 item 1"`` rather than dividing by a partition
the port does not run. ``SkipShape`` is a skip and any other exception an
error, as in the reference.

Usage::

    python -m repro_torch.launch.dryrun --arch glm4-9b --shape train_4k
    python -m repro_torch.launch.dryrun --all --out build/dryrun --tag x
"""
from __future__ import annotations

import argparse
import json
import time
import traceback
from pathlib import Path

# One H100 SXM, from its spec sheet (the target card; nothing here runs on it).
PEAK_BF16_FLOPS = 989e12      # dense, tensor cores
PEAK_F32_FLOPS = 67e12        # CUDA cores
HBM_BW = 3.35e12              # bytes/s
LINK_BW = 450e9               # NVLink bytes/s each way
HARDWARE = {"card": "H100 SXM (spec sheet)", "bf16_flops_per_s": PEAK_BF16_FLOPS,
            "f32_flops_per_s": PEAK_F32_FLOPS, "hbm_bytes_per_s": HBM_BW,
            "link_bytes_per_s": LINK_BW}
PER_DEVICE_WAITS = "waits for ROADMAP queue 1 item 1"
DRYRUN_LR = 0.01


def _active_params(params, num_experts: int, top_k: int) -> tuple[int, int]:
    """(total, active) param counts; MoE experts scale by top_k/num_experts
    (the reference's rule: a 4-d leaf under a ``moe`` key)."""
    from repro_torch.core.packer import tree_paths

    total = active = 0
    for path, leaf in tree_paths(params):
        names = [str(p) for p in path]
        n = leaf.numel()
        total += n
        if num_experts and "moe" in names and leaf.dim() == 4:
            active += n * top_k // num_experts
        else:
            active += n
    return total, active


def _nbytes(tree) -> int:
    """Bytes of every tensor of a state, a tree or a dict of trees."""
    from repro_torch.core.driver import _state_tensors

    return sum(t.numel() * t.element_size() for t in _state_tensors(tree))


def train_engine(bundle, cfg, plan, batch):
    """The sharded engine of the dry-run round: the batch's (G, K) and A,
    the plan's E and H, tree layout, unfused (``make_sharded_round``'s
    round)."""
    from repro_torch.core.api import ExperimentSpec, RoundSchedule, build

    E, H, A, G, K = (int(s) for s in batch["tokens"].shape[:5])
    spec = ExperimentSpec(levels=(G, K), schedule=RoundSchedule(group_rounds=E, local_steps=H,
                                                                microbatches=A),
                          algorithm="mtgc", lr=DRYRUN_LR, backend="sharded",
                          state_layout="tree")
    return build(spec, bundle.loss, device="cpu")


def build_case(arch_id: str, shape_id: str, *, overrides=None):
    """``(run, meta)``: ``run()`` makes the case's call on ``meta`` inputs
    and returns ``(inputs bytes, state bytes)``; ``meta`` the record's
    static fields."""
    import dataclasses

    import torch

    from repro_torch.configs import get_arch, get_plan
    from repro_torch.configs.shapes import SHAPES, param_specs, serve_specs, train_specs
    from repro_torch.launch.serve import make_serve_step
    from repro_torch.models.transformer import build_model

    cfg, plan = get_arch(arch_id), get_plan(arch_id)
    if overrides:
        cfg_over = {k: v for k, v in overrides.items() if hasattr(cfg, k)}
        plan_over = {k: v for k, v in overrides.items() if hasattr(plan, k)}
        if cfg_over:
            cfg = dataclasses.replace(cfg, **cfg_over)
        if plan_over:
            plan = dataclasses.replace(plan, **plan_over)
    bundle = build_model(cfg)
    kind = SHAPES[shape_id]["kind"]
    params = param_specs(cfg, bundle)
    n_total, n_active = _active_params(params, cfg.num_experts, cfg.top_k)
    G, K, F, M = plan.train_factors
    meta = dict(kind=kind, n_params=n_total, n_active=n_active,
                logical_mesh=dict(group=G, client=K, fsdp=F, model=M),
                per_device=PER_DEVICE_WAITS if (F > 1 or M > 1 or kind != "train") else None)

    if kind == "train":
        batch = train_specs(cfg, plan)
        lead = batch["tokens"].shape                  # [E, H, A, G, K, chunk, T_text]
        tokens = 1
        for s in lead[:-1]:
            tokens *= int(s)
        tokens *= SHAPES[shape_id]["seq_len"]         # every position, stub tokens included
        engine = train_engine(bundle, cfg, plan, batch)
        meta.update(tokens=int(tokens), flops_mult=6, dryrun_E=plan.dryrun_E,
                    dryrun_H=plan.dryrun_H, batch_lead=[int(s) for s in lead[:-1]])

        def run():
            state = engine.abstract_state(params)
            held = _nbytes(state) + _nbytes(batch)
            engine.round_fn(state, batch)
            return held, _nbytes(state)

        return run, meta

    io = serve_specs(cfg, shape_id)
    B = SHAPES[shape_id]["global_batch"]
    seq = SHAPES[shape_id]["seq_len"]
    meta.update(tokens=int(B * (seq if kind == "prefill" else 1)), flops_mult=2)
    step = make_serve_step(bundle, kind)
    batch = dict(io["batch"])
    if kind == "decode":
        # The decode step reads its position on the host: the last one.
        batch["index"] = torch.tensor(seq - 1, dtype=torch.int32)

    def run():
        held = _nbytes(params) + _nbytes(batch) + _nbytes(io["cache"])
        with torch.no_grad():
            step(params, batch, io["cache"])
        return held, _nbytes(io["cache"])

    return run, meta


def run_case(arch_id: str, shape_id: str, overrides=None, verbose: bool = True) -> dict:
    from repro_torch.configs.shapes import SkipShape
    from repro_torch.launch.cost_analysis import CostCounter, roofline

    rec: dict = dict(arch=arch_id, shape=shape_id, mesh="one device (whole program)",
                     overrides=overrides or {})
    t0 = time.time()
    try:
        run, meta = build_case(arch_id, shape_id, overrides=overrides)
        rec.update(meta)
        with CostCounter(track_live=True) as cc:
            held, state_bytes = run()
        c = cc.costs
        terms = roofline(c, bf16_flops_per_s=PEAK_BF16_FLOPS, f32_flops_per_s=PEAK_F32_FLOPS,
                         hbm_bytes_per_s=HBM_BW, link_bytes_per_s=LINK_BW)
        model_flops = meta["flops_mult"] * meta["n_active"] * meta["tokens"]
        rec.update(
            status="ok",
            flops=c.flops,
            flops_by_kind=dict(c.by_kind),
            bytes=c.bytes,
            collective_bytes=c.collective_bytes,
            collectives={k: v for k, v in c.per_collective.items()},
            by_scope=c.by_scope,
            top_flops=[[v, k] for v, k in c.top_flops],
            top_bytes=[[v, k] for v, k in c.top_bytes],
            kernels=c.kernels,
            state_bytes=state_bytes,
            input_bytes=held,
            peak_bytes=held + cc.peak_bytes,
            terms=terms,
            dominant=max(terms, key=terms.get),
            model_flops=float(model_flops),
            useful_flops_ratio=model_flops / c.flops if c.flops else 0.0,
            hardware=HARDWARE,
            notes=["the whole program on one device: no collective runs (the mesh's "
                   "all-reduces are counted where a mesh runs)"] + list(c.notes),
            seconds=time.time() - t0,
        )
        if verbose:
            print(f"  n_params={rec['n_params']:,} n_active={rec['n_active']:,} "
                  f"tokens={rec['tokens']:,}")
            print(f"  flops={c.flops:.4e} (bf16 {c.by_kind['bf16']:.3e}) bytes={c.bytes:.4e} "
                  f"state={state_bytes:.4e} peak={rec['peak_bytes']:.4e}")
            print("  terms(s): " + " ".join(f"{k}={v:.4f}" for k, v in terms.items())
                  + f"  dominant={rec['dominant']}")
            print(f"  useful-FLOPs ratio = {rec['useful_flops_ratio']:.3f}  "
                  f"({rec['seconds']:.1f} s)")
    except SkipShape as e:
        rec.update(status="skip", reason=str(e), seconds=time.time() - t0)
        if verbose:
            print(f"  SKIP: {e}")
    except Exception as e:  # a failure here is a bug in the port
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-4000:], seconds=time.time() - t0)
        if verbose:
            print(f"  ERROR: {type(e).__name__}: {e}")
    return rec


def _parse_override(kv: str):
    k, v = kv.split("=", 1)
    for cast in (int, float):
        try:
            return k, cast(v)
        except ValueError:
            pass
    return k, v


def main(argv: list[str] | None = None) -> int:
    from repro_torch.configs import ARCH_IDS, SHAPE_IDS

    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", action="append", default=None)
    ap.add_argument("--shape", action="append", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--override", action="append", default=[],
                    help="cfg/plan override key=value (numbers parsed)")
    args = ap.parse_args(argv)

    archs = list(ARCH_IDS) if (args.all or not args.arch) else args.arch
    shapes = list(SHAPE_IDS) if (args.all or not args.shape) else args.shape
    overrides = dict(_parse_override(kv) for kv in args.override) or None
    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    counts = {"ok": 0, "skip": 0, "error": 0}
    t0 = time.time()
    for a in archs:
        for s in shapes:
            print(f"[dryrun:{args.tag}] {a} x {s}", flush=True)
            rec = run_case(a, s, overrides=overrides)
            (outdir / f"{a}__{s}__{args.tag}.json").write_text(json.dumps(rec, indent=1))
            counts[rec["status"]] += 1
    print(f"[dryrun:{args.tag}] ok={counts['ok']} skip={counts['skip']} "
          f"error={counts['error']} ({time.time() - t0:.1f} s)")
    return 1 if counts["error"] else 0


if __name__ == "__main__":
    raise SystemExit(main())
