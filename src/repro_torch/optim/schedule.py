"""Learning-rate schedules as ``step -> lr`` callables returning float32
0-d tensors, computed in float32 as the reference's are (port of
``src/repro/optim/schedule.py``). ``step`` is an int or a tensor."""
from __future__ import annotations

import math

import torch

_F32 = torch.float32


def constant(lr: float):
    return lambda step: torch.tensor(lr, dtype=_F32)


def cosine(lr: float, total_steps: int, final_frac: float = 0.1):
    """From ``lr`` down to ``final_frac * lr`` over ``total_steps``, then
    flat."""
    def fn(step):
        frac = torch.clamp(torch.as_tensor(step) / max(total_steps, 1), 0.0, 1.0).to(_F32)
        mult = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * frac))
        return (lr * mult).to(_F32)

    return fn


def linear_warmup_cosine(lr: float, warmup: int, total_steps: int, final_frac: float = 0.1):
    """Linear warmup to ``lr`` over ``warmup`` steps, then :func:`cosine`
    over the remaining ``total_steps - warmup``."""
    cos = cosine(lr, max(total_steps - warmup, 1), final_frac)

    def fn(step):
        step = torch.as_tensor(step)
        wu = (lr * (step + 1) / max(warmup, 1)).to(_F32)
        return torch.where(step < warmup, wu, cos(step - warmup))

    return fn
