#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout on a host with a CUDA card and the CUDA
toolkit. It builds the port's kernels from ``src/repro_torch/kernels/csrc``
(into ``build/repro_torch/``), holds each kernel against its plain PyTorch
version at the main path's shapes, times it, and then drives the training
main path at full width -- the paper's CIFAR-10 CNN (McMahan et al.:
conv5x5x32, pool, conv5x5x64, pool, fc512, fc10; N = 2,156,490 float32
parameters) over 10 groups x 10 clients at batch 50, on synthetic data of
CIFAR-10's 32x32x3 shape. Depth is cut: E = 2 group rounds of H = 5 local
steps, 2 global rounds on the flat path. The learning rate is 0.01: at 0.1
the loss of this CNN on the synthetic images spikes into the thousands and
then settles at chance (ln 10) in both packages
(``tests/test_torch_driver.py::test_cifar_cnn_loss_spike_tracks_reference``).

Phases (any failure raises, so the script exits non-zero and prints no
final line):
 1. device line (``nvidia-smi`` name and power limit) and kernel build;
 2. kernels against their plain versions on the card: bit-exact in
    float32 at [10, 10, 2156490] (unmasked and masked) and on every CNN
    leaf shape; bfloat16 within one bfloat16 ulp; a ragged N; NaN rows;
    then kernel, plain and bound times;
 3. main path, flat layout + fused step: build -> pack_arrays -> fit for 2
    rounds with an eval; ``mtgc_update_flat`` must launch E * H * rounds
    times; then one more round timed, and one traced with
    ``torch.profiler`` (device busy share; device time by stream, and by
    kernel as a share of the busy time);
 4. tree layout + fused step, one round; ``mtgc_update`` must launch
    E * H * 8 (leaves) times;
 5. fused against unfused, one round from the same state and batches;
 6. the port on the card against the port on the CPU (the kernels' plain
    versions) on a small input;
 7. a JSON line per kernel, then ``{"ok": true, "device": {...}}`` last.

TF32 is switched off (``torch.backends.cudnn.allow_tf32`` and
``torch.backends.cuda.matmul.allow_tf32``) for the whole run, so every
float32 convolution and product runs in full float32 as the comparisons
assume. The script needs one card.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12        # H100 SXM data sheet, float32 outside tensor cores
FLOPS_PER_ELEMENT = 5          # g*gs, +z, +y, lr*d, x-...
E, H, ROUNDS, GROUPS, CLIENTS, BATCH = 2, 5, 2, 10, 10, 50
IMAGE = (32, 32, 3)
LR = 0.01


def log(*args):
    print(*args, flush=True)


def device_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, iters=20, warmup=3) -> float:
    """Mean milliseconds per call over ``iters`` calls, timed with CUDA
    events after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def timed(torch, kernel, plain) -> dict:
    """Kernel and plain times in turns (kernel, plain, plain, kernel); each
    is the mean of its two readings, and the spread of the kernel's two is
    kept beside it."""
    k1 = cuda_ms(torch, kernel)
    p1 = cuda_ms(torch, plain)
    p2 = cuda_ms(torch, plain)
    k2 = cuda_ms(torch, kernel)
    return {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2, "ms_readings": [k1, k2],
            "plain_ms_readings": [p1, p2]}


def bound_ms(nbytes: int, elements: int) -> tuple[float, str]:
    """Least time for the work: bytes over HBM rate vs flops over the
    float32 peak, whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = FLOPS_PER_ELEMENT * elements / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def phase_kernels(torch, mu, N, leaf_shapes):
    """Phase 2: correctness at the main path's shapes, then times."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    G, K = GROUPS, CLIENTS

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    errs = {"flat": 0.0, "leaf": 0.0}
    for masked in (False, True):
        x, g, z = (randn(G, K, N) for _ in range(3))
        y = randn(G, N)
        m = (torch.rand(G, K, generator=gen, device=dev) < 0.5).float() if masked else None
        got = mu.mtgc_update_flat(x, g, z, y, m, lr=0.1, g_scale=1.0)
        torch.cuda.synchronize()
        want = mu.mtgc_update_flat_ref(x, g, z, y, m, 0.1, 1.0)
        err = (got - want).abs().max().item()
        errs["flat"] = max(errs["flat"], err)
        log(f"flat f32 [{G},{K},{N}] masked={masked}: bit-exact={torch.equal(got, want)} "
            f"max_abs_err={err}")
        require(torch.equal(got, want), "mtgc_update_flat is not bit-exact in float32")
        if masked:
            frozen = m == 0
            require(torch.equal(got[frozen], x[frozen]), "a frozen row changed")
        del x, g, z, y, got, want

    # bfloat16: within one bfloat16 ulp of the plain version (2^-8 relative).
    x, g, z = (randn(G, K, N, dtype=torch.bfloat16) for _ in range(3))
    y = randn(G, N, dtype=torch.bfloat16)
    m = (torch.rand(G, K, generator=gen, device=dev) < 0.5).float()
    got = mu.mtgc_update_flat(x, g, z, y, m, lr=0.1).float()
    want = mu.mtgc_update_flat_ref(x, g, z, y, m, 0.1).float()
    excess = ((got - want).abs() - 2.0 ** -8 * want.abs()).max().item()
    log(f"flat bf16 [{G},{K},{N}] masked: max_abs_err={(got - want).abs().max().item()} "
        f"bit-exact={torch.equal(got, want)}")
    require(excess <= 0.0, "mtgc_update_flat bf16 is more than one ulp off")
    del x, g, z, y, got, want

    # Ragged N (not a multiple of the block tile, nor of 4) and NaN rows.
    x, g, z = (randn(3, 2, 1001) for _ in range(3))
    y = randn(3, 1001)
    g[0, 1] = float("nan")
    z[0, 1] = float("inf")
    g[2, 0] = float("nan")
    m = torch.ones(3, 2, device=dev)
    m[0, 1] = 0.0
    got = mu.mtgc_update_flat(x, g, z, y, m, lr=0.07, g_scale=0.5)
    want = mu.mtgc_update_flat_ref(x, g, z, y, m, 0.07, 0.5)
    torch.cuda.synchronize()
    require(torch.equal(got[0, 1], x[0, 1]), "a frozen NaN row changed")
    require(bool(torch.isnan(got[2, 0]).all()), "an active NaN row did not propagate")
    require(torch.equal(torch.nan_to_num(got), torch.nan_to_num(want)),
            "ragged/NaN case differs from the plain version")
    log("flat f32 ragged N=1001 with NaN rows: ok")

    for shape in leaf_shapes:
        a = [randn(*shape) for _ in range(4)]
        got = mu.mtgc_update(*a, lr=0.1)
        torch.cuda.synchronize()
        want = mu.mtgc_update_ref(*a, 0.1)
        errs["leaf"] = max(errs["leaf"], (got - want).abs().max().item())
        require(torch.equal(got, want), f"mtgc_update is not bit-exact on leaf {shape}")
    log(f"leaf f32 on {len(leaf_shapes)} CNN leaf shapes: bit-exact")

    # Times at the main path's shapes. Each flat launch moves ~3.5 GB,
    # far beyond the 50 MB L2, so every launch finds its operands cold.
    x, g, z = (randn(G, K, N) for _ in range(3))
    y = randn(G, N)
    flat = timed(torch, lambda: mu.mtgc_update_flat(x, g, z, y, None, lr=0.1),
                 lambda: mu.mtgc_update_flat_ref(x, g, z, y, None, 0.1))
    nbytes = sum(t.numel() * t.element_size() for t in (x, g, z, y)) + x.numel() * 4
    flat["bound_ms"], flat["bound_by"] = bound_ms(nbytes, x.numel())
    flat["bytes"] = nbytes
    del x, g, z, y
    leaves = [[randn(*s) for _ in range(4)] for s in leaf_shapes]

    def step(fn):
        return lambda: [fn(*a) for a in leaves]

    leaf = timed(torch, step(lambda *a: mu.mtgc_update(*a, lr=0.1)),
                 step(lambda *a: mu.mtgc_update_ref(*a, 0.1)))
    nbytes = sum(5 * a[0].numel() * 4 for a in leaves)
    leaf["bound_ms"], leaf["bound_by"] = bound_ms(nbytes, sum(a[0].numel() for a in leaves))
    leaf["bytes"] = nbytes
    del leaves
    torch.cuda.empty_cache()
    for name, t in (("mtgc_update_flat", flat), ("mtgc_update (8 leaves)", leaf)):
        log(f"{name}: kernel {t['ms']:.4f} ms {t['ms_readings']}, plain "
            f"{t['plain_ms']:.4f} ms {t['plain_ms_readings']}, "
            f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}, {t['bytes']} bytes)")
    return errs, flat, leaf


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def device_time(events) -> dict:
    """Device time in a Chrome trace's events (``ts``/``dur`` in us).

    Kernels, copies and fills are read with their stream; an event whose
    correlation id (one per launch) was seen already is dropped and
    counted. ``busy`` is the union of all intervals. Where intervals
    overlap -- on one stream too, since a Hopper kernel may start before
    its predecessor ends -- each instant of busy time is split evenly
    between the events running then, so the per-name ``attributed`` times
    sum to ``busy``; ``summed`` keeps the plain sum of durations."""
    spans, seen, dropped = [], set(), 0
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        args = e.get("args", {})
        corr = args.get("correlation")
        if corr is not None:
            if (e["cat"], corr) in seen:
                dropped += 1
                continue
            seen.add((e["cat"], corr))
        spans.append((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"],
                      args.get("stream", -1)))
    by_name: dict[str, dict] = {}
    by_stream: dict[int, dict] = {}
    marks = []
    for i, (start, end, name, stream) in enumerate(spans):
        n = by_name.setdefault(name, {"summed": 0.0, "attributed": 0.0, "count": 0})
        n["summed"] += end - start
        n["count"] += 1
        st = by_stream.setdefault(stream, {"summed": 0.0, "count": 0, "spans": []})
        st["summed"] += end - start
        st["count"] += 1
        st["spans"].append((start, end))
        marks += [(start, 1, i), (end, 0, i)]
    marks.sort()
    busy, active, last = 0.0, set(), None
    for t, is_start, i in marks:
        if active and t > last:
            busy += t - last
            for j in active:
                by_name[spans[j][2]]["attributed"] += (t - last) / len(active)
        last = t
        (active.add if is_start else active.discard)(i)
    for st in by_stream.values():
        st["union"] = _union(st.pop("spans"))
    return {"busy": busy, "dropped": dropped, "by_name": by_name, "by_stream": by_stream}


def _union(spans) -> float:
    total, cur_start, cur_end = 0.0, None, None
    for start, end in sorted(spans):
        if cur_end is None or start > cur_end:
            if cur_end is not None:
                total += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    return total if cur_end is None else total + cur_end - cur_start


def profile_round(torch, run) -> dict:
    """Trace one call of ``run`` with ``torch.profiler``; return the wall
    time and ``device_time`` of its Chrome trace (written to a temporary
    directory and removed), or {} when the trace holds no device time."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "round.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    dev = device_time(events)
    if not dev["by_name"]:
        return {}
    return {"wall_us": wall_us, **dev}


def finite_metrics(np, hz) -> None:
    for f in hz.metrics._fields:
        v = np.asarray(getattr(hz.metrics, f))
        require(np.isfinite(v).all(), f"metric {f} is not finite: {v}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device is available", file=sys.stderr)
        return 2
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch").is_dir():
        print("chip_smoke.py: run it from a checkout (src/repro_torch not found)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    import numpy as np

    from repro_torch import api, convert
    from repro_torch.core.driver import select_round
    from repro_torch.core.packer import make_packer
    from repro_torch.data import make_classification, partition, train_test_split
    from repro_torch.kernels import build
    from repro_torch.kernels import mtgc_update as mu
    from repro_torch.models import small

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t_start = time.perf_counter()

    # --- 1. device and build ------------------------------------------
    smi = device_line()
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    built = build.build_all()
    log(f"kernel build: {built['seconds']:.2f} s")
    for name, text in built["log"].items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    init, apply = small.cnn(10, IMAGE)
    p0 = init(torch.Generator().manual_seed(0), device="cuda")
    packer = make_packer(p0)
    N = packer.num_params
    require(N == 2_156_490, f"the CIFAR-10 CNN has {N} params, expected 2,156,490")
    leaf_shapes = [(GROUPS, CLIENTS) + s.shape for s in packer.segments]

    # --- 2. kernels ---------------------------------------------------
    errs, flat_t, leaf_t = phase_kernels(torch, mu, N, leaf_shapes)

    # --- 3. main path: flat + fused -----------------------------------
    rng = np.random.default_rng(0)
    ds = make_classification(rng, num_samples=20000, num_classes=10,
                             dim=math.prod(IMAGE), image_shape=IMAGE)
    train, test = train_test_split(ds, rng)
    # Group i.i.d., client non-i.i.d. with Dirichlet(0.1) (paper Sec. 5.1).
    idx = partition(train.y, GROUPS, CLIENTS, mode="group_iid", alpha=0.1, seed=0)
    loss_fn = small.make_loss(apply)
    acc = small.make_accuracy(apply, torch.from_numpy(test.x).cuda(),
                              torch.from_numpy(test.y).cuda())
    schedule = api.RoundSchedule(group_rounds=E, local_steps=H)
    spec = api.ExperimentSpec(levels=(GROUPS, CLIENTS), schedule=schedule,
                              algorithm="mtgc", fusion="fused", lr=LR)
    engine = api.build(spec, loss_fn)
    require(engine.device.type == "cuda", "the engine is not on the card")
    t0 = time.perf_counter()
    data = engine.pack_arrays({"x": train.x, "y": train.y}, idx, batch_size=BATCH,
                              shards=4, rng=np.random.default_rng(1),
                              generator=torch.Generator().manual_seed(1))
    torch.cuda.synchronize()
    log(f"packed {tuple(data.arrays['x'].shape)} in {time.perf_counter() - t0:.2f} s")

    def eval_fn(prev, st):
        return {"acc": acc(engine.global_model(st))}

    torch.cuda.reset_peak_memory_stats()
    mu.reset_launch_counts()
    t0 = time.perf_counter()
    state, hz = api.fit(engine, data, ROUNDS, params=p0, eval_every=ROUNDS, eval_fn=eval_fn)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    flat_launches, leaf_in_flat = mu.mtgc_update_flat.launches, mu.mtgc_update.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    require(flat_launches == E * H * ROUNDS,
            f"mtgc_update_flat launched {flat_launches} times, expected {E * H * ROUNDS}")
    require(leaf_in_flat == 0, "the flat path launched the per-leaf kernel")
    finite_metrics(np, hz)
    require(hz.metrics.loss.shape == (ROUNDS, E, H), f"loss shape {hz.metrics.loss.shape}")
    x_fin = state.params.bufs["float32"]
    require(tuple(x_fin.shape) == (GROUPS, CLIENTS, N) and bool(torch.isfinite(x_fin).all()),
            "final params are not finite [G, K, N]")
    t0 = time.perf_counter()
    state, hz1 = api.fit(engine, data, 1, state=state)
    torch.cuda.synchronize()
    steady_ms = (time.perf_counter() - t0) * 1e3
    finite_metrics(np, hz1)
    log(f"flat+fused: fit {ROUNDS} rounds in {fit_s:.3f} s (first round includes warm-up); "
        f"one more round {steady_ms:.1f} ms; peak memory {peak_gb:.2f} GB; "
        f"mtgc_update_flat launches {flat_launches}")
    log(f"  loss per step {np.round(hz.metrics.loss.reshape(-1), 4).tolist()}")
    trace = profile_round(torch, lambda: api.fit(engine, data, 1, state=state))
    if trace:
        busy = trace["busy"]
        summed = sum(n["summed"] for n in trace["by_name"].values())
        log(f"profiled round: wall {trace['wall_us'] / 1e3:.1f} ms, device busy "
            f"{busy / 1e3:.1f} ms (busy share {busy / trace['wall_us']:.3f}); summed "
            f"durations {summed / 1e3:.1f} ms in {len(trace['by_name'])} kernels; "
            f"{trace['dropped']} events with a repeated correlation id dropped")
        for sid, st in sorted(trace["by_stream"].items()):
            log(f"  stream {sid}: {st['count']} events, summed {st['summed'] / 1e3:.1f} ms, "
                f"busy {st['union'] / 1e3:.1f} ms")
        top = sorted(trace["by_name"].items(), key=lambda kv: -kv[1]["attributed"])[:12]
        for name, n in top:
            log(f"  {n['attributed'] / 1e3:9.3f} ms {100 * n['attributed'] / busy:5.1f}% "
                f"of busy (summed {n['summed'] / 1e3:.3f} ms) x{n['count']:<4d} {name[:90]}")
    else:
        log("profiled round: the trace holds no device time (not measured)")
    log(f"  eval rounds {hz.eval_rounds.tolist()} acc {hz.evals['acc'].tolist()}; "
        f"z_norm {hz.metrics.z_norm.tolist()} y_norm {hz.metrics.y_norm.tolist()} "
        f"comm_bytes {hz.metrics.comm_bytes.tolist()}")

    # --- 4. tree + fused, one round -------------------------------------
    tree_spec = api.ExperimentSpec(levels=(GROUPS, CLIENTS), schedule=schedule,
                                   algorithm="mtgc", fusion="fused", lr=LR,
                                   state_layout="tree")
    tree_engine = api.build(tree_spec, loss_fn)
    tree_state = tree_engine.init(p0)
    torch.cuda.synchronize()
    mu.reset_launch_counts()
    t0 = time.perf_counter()
    tree_state, hz_t = api.fit(tree_engine, data, 1, state=tree_state)
    torch.cuda.synchronize()
    tree_ms = (time.perf_counter() - t0) * 1e3
    leaf_launches, flat_in_tree = mu.mtgc_update.launches, mu.mtgc_update_flat.launches
    n_leaves = len(packer.segments)
    require(leaf_launches == E * H * n_leaves,
            f"mtgc_update launched {leaf_launches} times, expected {E * H * n_leaves}")
    require(flat_in_tree == 0, "the tree path launched the flat kernel")
    finite_metrics(np, hz_t)
    log(f"tree+fused: one round {tree_ms:.1f} ms (first tree round); mtgc_update launches "
        f"{leaf_launches}; loss {np.round(hz_t.metrics.loss.reshape(-1), 4).tolist()}")
    del tree_state, tree_engine

    # --- 5. fused against unfused, same state and batches --------------
    unfused = api.build(api.ExperimentSpec(levels=(GROUPS, CLIENTS), schedule=schedule,
                                           algorithm="mtgc", lr=LR), loss_fn)
    sid = torch.randint(0, data.num_shards, (E, GROUPS, CLIENTS),
                        generator=torch.Generator().manual_seed(7))
    batches = select_round(data, sid)
    torch.backends.cudnn.deterministic = True
    s_f, m_f = engine.round_fn(state, batches)
    s_u, m_u = unfused.round_fn(state, batches)
    torch.cuda.synchronize()
    torch.backends.cudnn.deterministic = False
    xf, xu = s_f.params.bufs["float32"][0, 0], s_u.params.bufs["float32"][0, 0]
    diff = (xf - xu).abs().max().item()
    scale = xu.abs().max().item()
    loss_diff = (m_f.loss - m_u.loss).abs().max().item()
    log(f"fused vs unfused (deterministic cuDNN): max |dx| {diff} (max |x| {scale}), "
        f"max |dloss| {loss_diff}")
    require(diff <= 1e-5 * scale, "fused and unfused rounds disagree beyond 1e-5 relative")
    del s_f, s_u, batches, state, data

    # --- 6. card against CPU on a small input ---------------------------
    small_init, small_apply = small.cnn(10, (8, 8, 1))
    ps = small_init(torch.Generator().manual_seed(3))
    rs = np.random.default_rng(3)
    b = {"x": torch.from_numpy(rs.normal(size=(2, 2, 2, 3, 4, 8, 8, 1)).astype(np.float32)),
         "y": torch.from_numpy(rs.integers(0, 10, size=(2, 2, 2, 3, 4)).astype(np.int32))}
    worst = 0.0
    for layout in ("flat", "tree"):
        sp = api.ExperimentSpec(levels=(2, 3), schedule=api.RoundSchedule(2, 2),
                                fusion="fused", state_layout=layout)
        outs = []
        for dev in ("cuda", "cpu"):
            eng = api.build(sp, small.make_loss(small_apply), device=dev)
            st, met = eng.round_fn(eng.init(ps), {k: v.to(dev) for k, v in b.items()})
            outs.append(convert.to_numpy(eng.global_model(st)))
        for name in outs[1]:
            for leaf in outs[1][name]:
                gpu, cpu = outs[0][name][leaf], outs[1][name][leaf]
                err = float(np.max(np.abs(gpu - cpu) / (1e-5 + np.abs(cpu))))
                worst = max(worst, err)
                require(np.allclose(gpu, cpu, rtol=1e-4, atol=1e-5),
                        f"{layout}: {name}/{leaf} differs between card and CPU")
    log(f"card vs CPU on cnn(8x8x1), G=2 K=3 E=2 H=2: agree within rtol 1e-4 "
        f"(worst {worst:.2e})")

    # --- 7. results ------------------------------------------------------
    kernels = [
        {"name": "mtgc_update_flat", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/mtgc_update.cu",
         "replaces": "src/repro/kernels/mtgc_update.py:94",
         "launches": flat_launches, "max_abs_err": errs["flat"],
         "ms": flat_t["ms"], "plain_ms": flat_t["plain_ms"], "bound_ms": flat_t["bound_ms"],
         "bound_by": flat_t["bound_by"], "library_ms": None,
         "shape": f"x/g/z [{GROUPS},{CLIENTS},{N}] f32, y [{GROUPS},{N}], no mask"},
        {"name": "mtgc_update", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/mtgc_update.cu",
         "replaces": "src/repro/kernels/mtgc_update.py:52",
         "launches": leaf_launches, "max_abs_err": errs["leaf"],
         "ms": leaf_t["ms"], "plain_ms": leaf_t["plain_ms"], "bound_ms": leaf_t["bound_ms"],
         "bound_by": leaf_t["bound_by"], "library_ms": None,
         "shape": f"one local step: {n_leaves} CNN leaves [{GROUPS},{CLIENTS},...] f32"},
    ]
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
