"""Dirichlet non-i.i.d. partitioning (paper Sec. 5.1 protocol), per-round
host batch sampling and heterogeneity diagnostics.

A copy of ``partition``, ``sample_round_batches`` and ``partition_stats``
from ``src/repro/data/partition.py`` (numpy only), draw for draw, so both
packages split and sample a dataset identically from the same seed.
Settings:
  'group_iid'     -- group i.i.d. & client non-i.i.d.
  'client_iid'    -- group non-i.i.d. & client i.i.d.
  'both_noniid'   -- Dirichlet over groups, then Dirichlet over clients.
  'label_shift'   -- App. C: 3 classes per group, 2 per client.

Returns index arrays so the same dataset array is shared by all clients.
"""
from __future__ import annotations

import numpy as np


def _dirichlet_split(rng, labels, num_parts, alpha, idx_pool):
    """Split ``idx_pool`` into ``num_parts`` label-skewed parts (Dirichlet).

    Standard protocol [Acar et al. 2021]: for each class, split its samples
    among parts with proportions ~ Dir(alpha).
    """
    parts = [[] for _ in range(num_parts)]
    for c in np.unique(labels[idx_pool]):
        idx_c = idx_pool[labels[idx_pool] == c]
        rng.shuffle(idx_c)
        props = rng.dirichlet(alpha * np.ones(num_parts))
        cuts = (np.cumsum(props) * len(idx_c)).astype(int)[:-1]
        for p, chunk in enumerate(np.split(idx_c, cuts)):
            parts[p].extend(chunk.tolist())
    return [np.asarray(sorted(p), dtype=np.int64) for p in parts]


def _uniform_split(rng, num_parts, idx_pool):
    idx = idx_pool.copy()
    rng.shuffle(idx)
    return [np.asarray(sorted(c), dtype=np.int64) for c in np.array_split(idx, num_parts)]


def partition(
    labels: np.ndarray,
    num_groups: int,
    clients_per_group: int,
    mode: str = "both_noniid",
    alpha: float = 0.1,
    seed: int = 0,
    min_per_client: int = 8,
) -> list[list[np.ndarray]]:
    """Returns indices[g][k] = sample indices of client k in group g."""
    rng = np.random.default_rng(seed)
    all_idx = np.arange(len(labels))

    for _attempt in range(50):
        if mode == "group_iid":
            groups = _uniform_split(rng, num_groups, all_idx)
            out = [_dirichlet_split(rng, labels, clients_per_group, alpha, g) for g in groups]
        elif mode == "client_iid":
            groups = _dirichlet_split(rng, labels, num_groups, alpha, all_idx)
            out = [_uniform_split(rng, clients_per_group, g) for g in groups]
        elif mode == "both_noniid":
            groups = _dirichlet_split(rng, labels, num_groups, alpha, all_idx)
            out = [_dirichlet_split(rng, labels, clients_per_group, alpha, g) for g in groups]
        elif mode == "label_shift":
            out = _label_shift(rng, labels, num_groups, clients_per_group)
        else:
            raise ValueError(f"unknown partition mode {mode!r}")
        if min(len(c) for g in out for c in g) >= min_per_client:
            return out
    raise RuntimeError("could not build a partition with enough samples/client")


def _label_shift(rng, labels, num_groups, clients_per_group,
                 classes_per_group=3, classes_per_client=2):
    """App. C label shift: assign 3 of C classes per group, 2 per client."""
    classes = np.unique(labels)
    out = []
    for _g in range(num_groups):
        gcls = rng.choice(classes, size=classes_per_group, replace=False)
        gidx = np.where(np.isin(labels, gcls))[0]
        clients = []
        for _k in range(clients_per_group):
            kcls = rng.choice(gcls, size=classes_per_client, replace=False)
            kidx = gidx[np.isin(labels[gidx], kcls)]
            # subsample so clients don't all share every sample
            take = max(len(kidx) // clients_per_group, 8)
            clients.append(np.sort(rng.choice(kidx, size=min(take, len(kidx)), replace=False)))
        out.append(clients)
    return out


def sample_round_batches(
    data_x: np.ndarray,
    data_y: np.ndarray,
    indices: list[list[np.ndarray]],
    rng: np.random.Generator,
    group_rounds: int,
    local_steps: int,
    batch_size: int,
    client_mask: np.ndarray | None = None,
):
    """Sample one global round of batches on the host: numpy arrays
    ``[E, H, G, K, b, ...]`` (the caller moves them to the device).

    ``client_mask`` ([G, K] 0/1, e.g. ``round_masks``' client mask, on the
    host) skips inactive clients: no draw is made for them and their slots
    stay zero (the engine freezes them anyway).
    """
    G, K = len(indices), len(indices[0])
    E, H, B = group_rounds, local_steps, batch_size
    bx = np.zeros((E, H, G, K, B) + data_x.shape[1:], data_x.dtype)
    by = np.zeros((E, H, G, K, B) + data_y.shape[1:], data_y.dtype)
    for g in range(G):
        for k in range(K):
            if client_mask is not None and not client_mask[g][k]:
                continue
            sel = rng.choice(indices[g][k], size=(E, H, B), replace=True)
            bx[:, :, g, k] = data_x[sel]
            by[:, :, g, k] = data_y[sel]
    return {"x": bx, "y": by}


def partition_stats(labels: np.ndarray, indices) -> dict:
    """Heterogeneity diagnostics: the mean total-variation distance of each
    group's label distribution from the global one, and of each client's
    from its group's."""
    num_classes = int(labels.max()) + 1
    gdist = []
    for group in indices:
        gi = np.concatenate(group)
        gdist.append(np.bincount(labels[gi], minlength=num_classes) / len(gi))
    gdist = np.stack(gdist)
    global_dist = gdist.mean(0)
    inter = float(np.abs(gdist - global_dist).sum(-1).mean())  # total variation
    intra = []
    for g, group in enumerate(indices):
        cd = np.stack([np.bincount(labels[c], minlength=num_classes) / max(len(c), 1)
                       for c in group])
        intra.append(np.abs(cd - gdist[g]).sum(-1).mean())
    return {"inter_group_tv": inter, "intra_group_tv": float(np.mean(intra))}
