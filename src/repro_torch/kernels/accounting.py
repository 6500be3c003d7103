"""Call counting and cost accounting of the hand-kernel wrappers.

Every wrapper (``mtgc_update_flat``, ``flash_attention``, ...) runs its
body through :func:`kernel_call`. That adds one to the wrapper's ``calls``
counter on every route (CPU, CUDA or meta; ``launches`` still goes up only
where a CUDA kernel is launched), and, while a listener is installed (the
cost counter of ``launch/cost_analysis.py``, the recorder of
``core/driver.py::trace_chunk``), reports the call with the work of the
wrapper's ``cost(...)``: its FLOPs, its bytes (each input read once, each
output written once) and the peak its FLOPs are held to ("bf16" for the
tensor cores, "f32" for the CUDA cores). The ops the plain version
dispatches inside a call are the kernel's own work: :func:`inside_kernel`
is true while they run, and the cost counter does not count them again.
So a CPU run, a meta run and a card run count the same work.

No cost is formed while nothing listens, so an ordinary run pays one
counter increment a call.
"""
from __future__ import annotations

import contextlib
from typing import Callable

_listeners: list = []
_depth = 0


def inside_kernel() -> bool:
    """Whether a wrapper's body is running (its ops are the kernel's)."""
    return _depth > 0


@contextlib.contextmanager
def listen(listener):
    """Report every outermost wrapper call to ``listener.on_kernel(name,
    flops, nbytes, kind, outputs)``, and every collective of the mesh to
    ``listener.on_collective(kind, nbytes)``, while the context is open."""
    _listeners.append(listener)
    try:
        yield listener
    finally:
        _listeners.remove(listener)


def kernel_call(wrapper, body: Callable, cost: Callable, kind: str, *args, **kwargs):
    """One call of ``wrapper``: count it, run ``body()`` as the kernel's
    work and return what it returns (a CPU tensor made contiguous, as the
    kernels' outputs are); an outermost call is reported to the listeners
    with ``cost(*args, **kwargs)`` and its outputs."""
    global _depth
    wrapper.calls += 1
    report = _depth == 0 and bool(_listeners)
    if report:
        flops, nb = cost(*args, **kwargs)
    _depth += 1
    try:
        out = _kernel_layout(body())
    finally:
        _depth -= 1
    if report:
        for lst in list(_listeners):
            lst.on_kernel(wrapper.__name__, float(flops), float(nb), kind, out)
    return out


def _kernel_layout(out):
    """The plain route's outputs in the kernels' layout (contiguous), so
    that what a caller does with them costs the same on every route."""
    import torch

    if isinstance(out, torch.Tensor):
        return out.contiguous() if out.device.type == "cpu" else out
    if isinstance(out, tuple) and not hasattr(out, "_fields"):
        return tuple(_kernel_layout(t) for t in out)
    return out


def collective(kind: str, t) -> None:
    """Report a collective of ``kind`` ("all-reduce", ...) over ``t``."""
    for lst in list(_listeners):
        lst.on_collective(kind, float(t.numel() * t.element_size()))


def nbytes(*tensors) -> int:
    """Bytes of the given tensors (None counts nothing)."""
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def peak_kind(dtype) -> str:
    """The peak a kernel's products on ``dtype`` operands are held to:
    bfloat16 on the tensor cores, anything else on the CUDA cores."""
    import torch

    return "bf16" if dtype == torch.bfloat16 else "f32"
