"""The kernels the engine calls (port of ``src/repro/kernels/ops.py``).

The reference's ``ops`` resolves a ``mode`` per backend. Here the wrappers
in ``kernels/mtgc_update.py``, ``kernels/quantize.py``,
``kernels/flash_attention.py``, ``kernels/rwkv6_scan.py``,
``kernels/ssm_scan.py`` and ``kernels/moe_dispatch.py`` choose by the
tensors' device alone: a CPU tensor takes the plain version, a CUDA tensor
launches the kernel.
``FlashAttention`` is the differentiable attention (forward and backward
kernels) that the model's training path calls; ``MoEDispatch`` and
``MoECombine`` are the moe family's differentiable dispatch and combine.
"""
from __future__ import annotations

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

__all__ = ["FlashAttention", "MoECombine", "MoEDispatch", "flash_attention",
           "flash_attention_bwd", "int8_roundtrip", "moe_combine", "moe_gate_grad", "moe_gather",
           "mtgc_update", "mtgc_update_flat", "reset_launch_counts", "rwkv6_scan",
           "rwkv6_scan_bthd", "selective_scan", "topk_mask"]


def reset_launch_counts() -> None:
    """Set every wrapper's ``launches`` counter to 0."""
    _mu.reset_launch_counts()
    _qz.reset_launch_counts()
    _fa.reset_launch_counts()
    _rw.reset_launch_counts()
    _ss.reset_launch_counts()
    _md.reset_launch_counts()
