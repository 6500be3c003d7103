"""The kernels the engine calls (port of ``src/repro/kernels/ops.py``).

The reference's ``ops`` resolves a ``mode`` per backend. Here the wrappers
in ``kernels/mtgc_update.py``, ``kernels/quantize.py``,
``kernels/flash_attention.py``, ``kernels/rwkv6_scan.py``,
``kernels/ssm_scan.py`` and ``kernels/moe_dispatch.py`` choose by the
tensors' device alone: a CPU tensor takes the plain version, a CUDA tensor
launches the kernel, a ``meta`` tensor gets its outputs' shapes.
:data:`WRAPPERS` names every wrapper (each with ``launches``, ``calls`` and
``cost``), :data:`KERNEL_NAMES` the ``__global__`` functions each one
launches (how ``torch.profiler``'s CUDA activity is attributed to it).
``FlashAttention`` is the differentiable attention (forward and backward
kernels) that the model's training path calls; ``MoEDispatch`` and
``MoECombine`` are the moe family's differentiable dispatch and combine.
"""
from __future__ import annotations

import re

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import moe_dispatch as _md
from repro_torch.kernels import mtgc_update as _mu
from repro_torch.kernels import quantize as _qz
from repro_torch.kernels import rwkv6_scan as _rw
from repro_torch.kernels import ssm_scan as _ss
from repro_torch.kernels.flash_attention import (
    FlashAttention,
    flash_attention,
    flash_attention_bwd,
)
from repro_torch.kernels.moe_dispatch import (
    MoECombine,
    MoEDispatch,
    moe_combine,
    moe_gate_grad,
    moe_gather,
)
from repro_torch.kernels.mtgc_update import mtgc_update, mtgc_update_flat
from repro_torch.kernels.quantize import int8_roundtrip, topk_mask
from repro_torch.kernels.rwkv6_scan import rwkv6_scan, rwkv6_scan_bthd
from repro_torch.kernels.ssm_scan import selective_scan

__all__ = ["FlashAttention", "KERNEL_NAMES", "MoECombine", "MoEDispatch", "WRAPPERS",
           "calls", "flash_attention", "flash_attention_bwd", "int8_roundtrip", "launches",
           "moe_combine", "moe_gate_grad", "moe_gather", "mtgc_update", "mtgc_update_flat",
           "reset_launch_counts", "rwkv6_scan", "rwkv6_scan_bthd", "selective_scan",
           "topk_mask"]

_MODULES = (_mu, _qz, _fa, _rw, _ss, _md)

# Every wrapper, by name: the counters of ``rwkv6_scan`` also count
# ``rwkv6_scan_bthd`` and ``RWKV6Scan``'s forward.
WRAPPERS = {w.__name__: w for m in _MODULES for w in m.WRAPPERS}

# The ``__global__`` functions each wrapper launches (csrc/*.cu), in launch
# order; a profiler's kernel name contains one of them.
KERNEL_NAMES = {
    "mtgc_update_flat": ("flat_kernel",),
    "mtgc_update": ("leaf_kernel",),
    "int8_roundtrip": ("int8_kernel",),
    "topk_mask": ("topk_kernel",),
    "flash_attention": ("flash_fwd_kernel", "flash_fwd_wgmma_kernel"),
    "flash_attention_bwd": ("flash_bwd_dq_kernel", "flash_bwd_dq_wgmma_kernel",
                            "flash_bwd_dkdv_kernel", "flash_bwd_dkdv_wgmma_kernel",
                            "flash_bwd_reduce_kernel"),
    "rwkv6_scan": ("rwkv6_chunk_state_kernel", "rwkv6_state_scan_kernel",
                   "rwkv6_chunk_out_kernel"),
    "rwkv6_scan_bwd": ("rwkv6_bwd_chunk_grad_kernel", "rwkv6_bwd_state_scan_kernel",
                       "rwkv6_bwd_chunk_out_kernel", "rwkv6_bwd_du_kernel"),
    "selective_scan": ("selective_scan_kernel",),
    "selective_scan_bwd": ("ssm_bwd_carry_kernel", "ssm_bwd_fold_kernel",
                           "ssm_bwd_chunk_kernel", "ssm_bwd_reduce_kernel"),
    "moe_gather": ("moe_gather_kernel",),
    "moe_combine": ("moe_combine_kernel",),
    "moe_gate_grad": ("moe_gate_grad_kernel",),
}

_KERNEL_RE = re.compile(r"(?<![A-Za-z0-9_])(" + "|".join(
    n for names in KERNEL_NAMES.values() for n in names) + r")(?![A-Za-z0-9_])")
_OWNER = {n: w for w, names in KERNEL_NAMES.items() for n in names}


def wrapper_of_kernel(name: str) -> str | None:
    """The wrapper whose kernel a profiler's kernel ``name`` is, else None."""
    m = _KERNEL_RE.search(name)
    return None if m is None else _OWNER[m.group(1)]


def launches() -> dict:
    """Every wrapper's ``launches`` counter, by name."""
    return {n: w.launches for n, w in WRAPPERS.items()}


def calls() -> dict:
    """Every wrapper's ``calls`` counter, by name."""
    return {n: w.calls for n, w in WRAPPERS.items()}


def reset_launch_counts() -> None:
    """Set every wrapper's ``launches`` and ``calls`` counters to 0."""
    for m in _MODULES:
        m.reset_launch_counts()
