"""Where the port runs: the GPU unless the caller asks for the CPU; and
copies of its random generators."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card; a host without one raises rather than
    running quietly on the CPU. Pass ``device="cpu"`` to run the plain
    PyTorch versions of the kernels on the CPU (as the tests do)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available: the port runs on the GPU by "
                "default; pass device='cpu' to run it on the CPU")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} was requested but CUDA is not available")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"the port runs on 'cuda' or 'cpu', got {dev}")
    return dev


def clone_generator(gen: torch.Generator) -> torch.Generator:
    """A new generator on ``gen``'s device in ``gen``'s current state: it
    draws what ``gen`` would draw next, and drawing from it leaves ``gen``
    as it is."""
    out = torch.Generator(device=gen.device)
    out.set_state(gen.get_state())
    return out
