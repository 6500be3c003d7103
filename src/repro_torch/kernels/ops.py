"""The kernels the engine calls (port of ``src/repro/kernels/ops.py``).

The reference's ``ops`` resolves a ``mode`` per backend. Here the wrappers
in ``kernels/mtgc_update.py`` choose by the tensors' device alone: a CPU
tensor takes the plain version, a CUDA tensor launches the kernel.
"""
from __future__ import annotations

from repro_torch.kernels.mtgc_update import mtgc_update, mtgc_update_flat

__all__ = ["mtgc_update", "mtgc_update_flat"]
