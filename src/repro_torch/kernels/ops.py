"""The kernels the engine calls (port of ``src/repro/kernels/ops.py``).

The reference's ``ops`` resolves a ``mode`` per backend. Here the wrappers
in ``kernels/mtgc_update.py`` and ``kernels/quantize.py`` choose by the
tensors' device alone: a CPU tensor takes the plain version, a CUDA tensor
launches the kernel.
"""
from __future__ import annotations

from repro_torch.kernels import mtgc_update as _mu
from repro_torch.kernels import quantize as _qz
from repro_torch.kernels.mtgc_update import mtgc_update, mtgc_update_flat
from repro_torch.kernels.quantize import int8_roundtrip, topk_mask

__all__ = ["int8_roundtrip", "mtgc_update", "mtgc_update_flat", "reset_launch_counts",
           "topk_mask"]


def reset_launch_counts() -> None:
    """Set every wrapper's ``launches`` counter to 0."""
    _mu.reset_launch_counts()
    _qz.reset_launch_counts()
