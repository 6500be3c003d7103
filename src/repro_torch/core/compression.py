"""Wire-byte accounting of one global round (port of the uncompressed part
of ``src/repro/core/compression.py``).

Every engine reports the modeled per-round upload bytes (``comm_bytes``)
whether or not uploads are compressed. This slice ports the uncompressed
wire model only; the compressors (bf16, stochastic int8, top-k) and their
error-feedback residuals belong to the compressed-uploads slice of the
port, and asking for them raises.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.packer import dtype_key, key_dtype
from repro_torch.core.tree import tree_leaves

COMPRESSED_SLICE = "the compressed-uploads slice of the port"


def model_leaf_sizes(params, lead_ndim: int = 2) -> tuple[tuple[int, str], ...]:
    """One model's leaf geometry from a stacked state tree:
    ``((elements, dtype_name), ...)`` with the ``lead_ndim`` replica axes
    stripped."""
    out = []
    for leaf in tree_leaves(params):
        shape = tuple(leaf.shape)
        n = math.prod(shape[lead_ndim:]) if len(shape) > lead_ndim else 1
        out.append((n, dtype_key(leaf.dtype)))
    return tuple(out)


def upload_bytes(leaf_sizes, mode: str = "none") -> float:
    """Modeled wire bytes of ONE upload (one client or one group)."""
    if mode != "none":
        raise ValueError(f"compression mode {mode!r} needs {COMPRESSED_SLICE}")
    return float(sum(n * key_dtype(name).itemsize for n, name in leaf_sizes))


def round_comm_bytes(params, plan, n_client_uploads, n_group_uploads,
                     lead_ndim: int = 2) -> torch.Tensor:
    """Total modeled upload bytes of one global round (f32 scalar on the
    params' device), uncompressed: ``n_client * bytes(model) + n_group *
    bytes(model)``, computed in float32 as the reference computes it."""
    if plan is not None:
        raise ValueError(f"a CompressionPlan needs {COMPRESSED_SLICE}")
    sizes = model_leaf_sizes(params, lead_ndim)
    device = tree_leaves(params)[0].device
    b = upload_bytes(sizes)
    nc = torch.as_tensor(n_client_uploads, dtype=torch.float32, device=device)
    ng = torch.as_tensor(n_group_uploads, dtype=torch.float32, device=device)
    return nc * b + ng * b
