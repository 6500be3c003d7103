"""One rank of the mesh tests (``tests/test_torch_mesh.py``): the port's
sharded round on ``torch.distributed`` gloo meshes of CPU processes.

    python tests/torch_mesh_worker.py --rank R --world 4 --out DIR

Every rank builds the same meshes -- (group, client) = (2, 2), (2, 1),
(1, 2) and (1, 1), with ``fsdp`` and ``model`` dims of size 1, over the
first ranks -- and runs every case on each mesh it belongs to: the
quadratic problem and a reduced glm4-9b at G = K = 2, E = H = A = 2, from
the same start and batches, with the participation masks of
``DIR/masks.npz`` injected. The rank at the mesh's origin writes the
gathered state and the metrics of each case to ``DIR/<case>@<mesh>.pt``.
The process group's store is a ``FileStore`` in ``DIR``; its collectives
and the join time out after 60 s. It imports no JAX: the test module
draws the masks and runs the reference.
"""
from __future__ import annotations

import argparse
import datetime
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch

G = K = 2
E = H = A = 2
LR = 0.05
ROUNDS = 2
D = 6
SEQ = 32
MESH_NAMES = ("group", "client", "fsdp", "model")
MESHES = {"2x2": (2, 2), "2x1": (2, 1), "1x2": (1, 2), "1x1": (1, 1)}
PARTICIPATION = {"full": {},
                 "partial": dict(client_participation=0.5, group_participation=0.75,
                                 participation_mode="uniform"),
                 "ht": dict(client_participation=0.5, group_participation=0.75,
                            participation_mode="uniform",
                            participation_weighting="inverse_prob")}
# (algorithm, layout, fusion): the sharded backend's combinations.
ROUND_KINDS = (("mtgc", "tree", "none"), ("mtgc", "tree", "fused"), ("mtgc", "flat", "none"),
               ("mtgc", "flat", "fused"), ("hfedavg", "tree", "none"),
               ("hfedavg", "flat", "none"))
QUAD_CASES = tuple(f"quad-{a}-{lay}-{fu}-{p}" for a, lay, fu in ROUND_KINDS
                   for p in PARTICIPATION)
LM_CASES = ("lm-mtgc-flat-fused-partial", "lm-mtgc-tree-none-full", "lm-hfedavg-tree-none-partial")


def parse(case: str) -> dict:
    problem, alg, layout, fusion, part = case.split("-")
    return dict(problem=problem, algorithm=alg, layout=layout, fusion=fusion, part=part)


def quad_loss(params, batch):
    r = batch["a"] * params["w"] - batch["b"]
    return 0.5 * torch.sum(r * r)


def quad_batches(seed: int = 21) -> dict:
    """[E, H, A, G, K, D] quadratic-loss batches (numpy)."""
    rng = np.random.default_rng(seed)
    shape = (E, H, A, G, K, D)
    return {"a": rng.normal(size=shape).astype(np.float32) + 2.0,
            "b": rng.normal(size=shape).astype(np.float32)}


def lm_cfg():
    from repro_torch.configs import get_arch

    return get_arch("glm4-9b").reduced()


def lm_batches(seed: int = 5) -> dict:
    """[E, H, A, G, K, 1, SEQ] token batches (numpy) of the reduced glm4."""
    rng = np.random.default_rng(seed)
    shape = (E, H, A, G, K, 1, SEQ)
    v = lm_cfg().vocab_size
    return {"tokens": rng.integers(0, v, size=shape, dtype=np.int32),
            "targets": rng.integers(0, v, size=shape, dtype=np.int32)}


def problem(name: str):
    """(loss_fn, initial params, numpy batches) of a case's problem."""
    if name == "quad":
        return quad_loss, {"w": torch.zeros(D)}, quad_batches()
    from repro_torch.models.transformer import build_model

    bundle = build_model(lm_cfg())
    return bundle.loss, bundle.init(0, device="cpu"), lm_batches()


def spec_of(case: str):
    from repro_torch import api

    c = parse(case)
    return api.ExperimentSpec(
        levels=(G, K), backend="sharded", lr=LR, algorithm=c["algorithm"],
        state_layout=c["layout"], fusion=c["fusion"],
        schedule=api.RoundSchedule(group_rounds=E, local_steps=H, microbatches=A),
        **PARTICIPATION[c["part"]])


def run_case(case: str, masks: dict | None, mesh=None):
    """ROUNDS rounds of ``case`` from the same start and batches, on one
    device (``mesh=None``) or on ``mesh``: (state, [metrics per round],
    the engine's global model)."""
    from repro_torch import api
    from repro_torch.core.engine import RoundDraws
    from repro_torch.core.participation import ParticipationMasks

    loss_fn, params, batches = problem(parse(case)["problem"])
    engine = api.build(spec_of(case), loss_fn, device="cpu", mesh=mesh)
    state = engine.init(params)
    tb = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batches.items()}
    metrics = []
    for r in range(ROUNDS):
        draws = None
        if parse(case)["part"] != "full":
            draws = RoundDraws(masks=ParticipationMasks(
                torch.tensor(masks[f"group{r}"]), torch.tensor(masks[f"client{r}"])))
        state, m = engine.round_fn(state, tb, draws=draws)
        metrics.append({f: getattr(m, f).detach().clone() for f in m._fields})
    return state, metrics, engine.global_model(state)


def to_host(state, metrics, model) -> dict:
    """The state's (params, z, y) and the global model as nested dicts of
    numpy arrays, and the metrics stacked over the rounds."""
    from repro_torch import convert

    out = {"global": convert.to_numpy(model)}
    for name in ("params", "z", "y"):
        t = getattr(state, name)
        t = t.to_tree() if hasattr(t, "to_tree") else t
        out[name] = convert.to_numpy(t)
    out["metrics"] = {f: np.stack([m[f].numpy() for m in metrics]) for f in metrics[0]}
    return out


def roundtrip(mesh, path: Path) -> None:
    """A whole state of distinct entries (tree and flat, with an error-
    feedback residual of each link) through ``shard_state`` and
    ``gather_state``: the rank at the origin writes whether each came back
    bit for bit, and each rank's block of params checked against its rows."""
    from repro_torch.core import tree as tu
    from repro_torch.launch.train import sharded_init
    from repro_torch.sharding.state import MeshAxes, gather_state, shard_state

    ok = {}
    for layout in ("tree", "flat"):
        whole = sharded_init({"a": torch.zeros(3, 2), "b": torch.zeros(5)}, G, K,
                             use_flat_state=layout == "flat", ef_client=True, ef_group=True,
                             device="cpu")
        whole = whole._replace(**{f: _numbered(getattr(whole, f), i) for i, f in
                                  enumerate(("params", "z", "y", "efc", "efg"))})
        block = shard_state(whole, mesh)
        gs, ks = MeshAxes(mesh).block(G, K)
        ok[f"{layout}/block"] = all(
            torch.equal(b, w[gs, ks]) for b, w in zip(tu.tree_leaves(block.params),
                                                    tu.tree_leaves(whole.params)))
        back = gather_state(block, mesh)
        for f in ("params", "z", "y", "efc", "efg"):
            ok[f"{layout}/{f}"] = all(
                torch.equal(a, b) for a, b in zip(tu.tree_leaves(getattr(back, f)),
                                                  tu.tree_leaves(getattr(whole, f))))
    if not any(mesh.get_coordinate()):
        torch.save(ok, path)


def _numbered(field, salt: int):
    """``field`` with every entry distinct: leaf j's entries count up from
    1000 * (10 * salt + j)."""
    from repro_torch.core import tree as tu

    leaves = iter(range(100))
    return tu.tree_map(lambda t: (torch.arange(t.numel(), dtype=torch.float32)
                                  + 1000.0 * (10 * salt + next(leaves))).reshape(t.shape)
                       .to(t.dtype), field)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    import torch.distributed as dist

    from repro_torch.launch.mesh import smoke_mesh
    from repro_torch.sharding.state import gather_state

    torch.set_num_threads(1)
    out = Path(args.out)
    t0 = time.perf_counter()
    dist.init_process_group("gloo", store=dist.FileStore(str(out / "store"), args.world),
                            rank=args.rank, world_size=args.world,
                            timeout=datetime.timedelta(seconds=60))
    try:
        masks = dict(np.load(out / "masks.npz"))
        meshes = {name: smoke_mesh((g, c, 1, 1), MESH_NAMES, device_type="cpu")
                  for name, (g, c) in MESHES.items()}
        for case in QUAD_CASES + LM_CASES:
            for name, mesh in meshes.items():
                coord = mesh.get_coordinate()
                if coord is None:
                    continue
                state, metrics, model = run_case(case, masks, mesh)
                whole = gather_state(state, mesh)
                if not any(coord):
                    torch.save(to_host(whole, metrics, model), out / f"{case}@{name}.pt")
        roundtrip(meshes["2x2"], out / "roundtrip@2x2.pt")
        dist.barrier()
    except Exception:
        traceback.print_exc()
        return 1
    finally:
        dist.destroy_process_group()
    print(f"rank {args.rank}: {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
