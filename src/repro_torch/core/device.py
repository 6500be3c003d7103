"""Where the port runs: the GPU unless the caller asks for the CPU; copies
of its random generators; and :class:`MetaFactories`, under which code that
builds tensors builds them on the ``meta`` device (shapes and dtypes, no
storage)."""
from __future__ import annotations

import torch
from torch.overrides import TorchFunctionMode


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


class MetaFactories(TorchFunctionMode):
    """Every tensor factory call makes its tensor on the ``meta`` device and
    draws nothing (a random factory's ``generator`` is dropped), and a move
    to a device (``Tensor.to``, ``.cuda()``, ``.cpu()``) stays on ``meta``
    (a dtype change still applies). Run an ``init`` under it to get its
    tensors' shapes and dtypes without allocating them
    (``configs.shapes.param_specs``, ``Engine.abstract_state``)."""

    _FACTORIES = frozenset((torch.randn, torch.rand, torch.randint, torch.normal,
                            torch.zeros, torch.ones, torch.empty, torch.full, torch.arange,
                            torch.linspace, torch.eye, torch.tensor, torch.as_tensor,
                            torch.randperm))
    _MOVES = frozenset((torch.Tensor.to, torch.Tensor.cuda, torch.Tensor.cpu))

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        if func in self._FACTORIES:
            kwargs.pop("generator", None)
            kwargs["device"] = "meta"
        elif func in self._MOVES:
            t = args[0]
            dtype = kwargs.get("dtype")
            for a in args[1:]:
                if isinstance(a, torch.dtype):
                    dtype = a
                elif isinstance(a, torch.Tensor):
                    dtype = a.dtype
            if t.device.type == "meta" and dtype in (None, t.dtype):
                return t
            return torch.empty(t.shape, dtype=dtype or t.dtype, device="meta")
        return func(*args, **kwargs)
