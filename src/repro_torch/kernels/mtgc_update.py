"""Fused MTGC local update ``x <- x - lr * (g * g_scale + z + y)`` (Alg. 1 line 7).

Port of ``src/repro/kernels/mtgc_update.py`` (the two Pallas kernels) and of
their oracles in ``src/repro/kernels/ref.py``. The kernels are hand-written
CUDA for Hopper (``csrc/mtgc_update.cu``; the note at its top says what
bounds them and what the design does about it); the plain PyTorch versions
live beside them in this module.

Dispatch is by the device of the tensors and nothing else: a CPU tensor
takes the plain version, a CUDA tensor launches the kernel (building it on
first use), a ``meta`` tensor gets an output of the right shape and dtype
and nothing computed, and any other device raises. There is no fallback
from the kernel to the plain version. Each wrapper carries an integer
``launches`` counter that goes up by one exactly where its kernel is
launched, and a ``calls`` counter that goes up on every route
(``kernels/accounting.py``). ``mtgc_update_flat_cost`` and
``mtgc_update_cost`` give the work a call's bound counts: (FLOPs, bytes).

Arithmetic: the correction sum runs in float32 whatever the storage type
(``((g * g_scale + z) + y)``, then ``x - lr * d``), and the result is
stored in ``x.dtype``. ``lr`` and ``g_scale`` act as float32 scalars, as
JAX's weakly typed Python floats do. The plain version computes each
operation on its own (no fused ``sub(..., alpha=)``), and the kernel rounds
each operation on its own, so the two agree bit for bit in float32.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.accounting import kernel_call, nbytes
from repro_torch.kernels.build import load

_DTYPES = (torch.float32, torch.bfloat16)


def mtgc_update_ref(x, g, z, y, lr, g_scale=1.0):
    """x <- x - lr * (g * g_scale + z + y), correction sum in f32 (any shape)."""
    d = g.to(torch.float32) * g_scale
    d = d + z.to(torch.float32)
    d = d + y.to(torch.float32)
    return (x.to(torch.float32) - lr * d).to(x.dtype)


def mtgc_update_flat_ref(x, g, z, y, mask=None, lr=0.1, g_scale=1.0):
    """Flat-layout update: x/g/z [G, K, N], y [G, N], mask [G, K] or None.

    The masked branch keeps frozen replicas' exact bits (``where``, never a
    multiply by the mask), so NaN/Inf in a frozen row's g or z cannot leak.
    """
    d = g.to(torch.float32) * g_scale
    d = d + z.to(torch.float32)
    d = d + y.to(torch.float32)[:, None]
    x_new = (x.to(torch.float32) - lr * d).to(x.dtype)
    if mask is None:
        return x_new
    return torch.where(mask[..., None] != 0, x_new, x)


def _check(name: str, t: torch.Tensor, device: torch.device, dtypes, shape=None):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {t.dtype}; the kernel takes {dtypes}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_types(x, g, z, y):
    if g.dtype != x.dtype:
        raise TypeError(f"g ({g.dtype}) must have x's dtype ({x.dtype})")
    if y.dtype != z.dtype:
        raise TypeError(f"y ({y.dtype}) must have z's dtype ({z.dtype})")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def _overlaps(a: torch.Tensor, b: torch.Tensor) -> bool:
    a0, b0 = a.data_ptr(), b.data_ptr()
    return a0 < b0 + b.numel() * b.element_size() and b0 < a0 + a.numel() * a.element_size()


FLOPS_PER_ELEMENT = 5         # g * g_scale, + z, + y, lr * d, x - ...


def mtgc_update_flat_cost(x, g, z, y, mask=None, **_):
    """(FLOPs, bytes) of one ``mtgc_update_flat`` call: x, g, z, y (and the
    mask) read once, the result written once; five operations an element."""
    return FLOPS_PER_ELEMENT * x.numel(), nbytes(x, g, z, y, mask) + nbytes(x)


def mtgc_update_cost(x, g, z, y, **_):
    """(FLOPs, bytes) of one ``mtgc_update`` call (as the flat one's)."""
    return FLOPS_PER_ELEMENT * x.numel(), nbytes(x, g, z, y) + nbytes(x)


def mtgc_update_flat(x, g, z, y, mask=None, *, lr: float, g_scale: float = 1.0, out=None):
    """Whole-model fused update over flat buffers (replaces the Pallas
    ``mtgc_update_flat``, src/repro/kernels/mtgc_update.py:94).

    x, g, z: [G, K, N]; y: [G, N], read as row ``i // K`` for replica i and
    never copied per client; mask: optional [G, K] 0/1 participation gate --
    frozen replicas keep their exact bits. Returns the updated [G, K, N]
    buffer: ``out`` when given (``out=x`` updates x in place, as the
    reference's donated state does), else a new one.
    """
    return kernel_call(mtgc_update_flat, lambda: _update_flat(x, g, z, y, mask, lr, g_scale, out),
                       mtgc_update_flat_cost, "f32", x, g, z, y, mask)


def _update_flat(x, g, z, y, mask, lr, g_scale, out):
    if out is not None:
        _check("out", out, x.device, (x.dtype,), x.shape)
        if out.data_ptr() != x.data_ptr() and any(_overlaps(out, t) for t in (x, g, z, y)):
            raise ValueError("out must be x itself or overlap none of the operands")
    if x.device.type == "cpu":
        res = mtgc_update_flat_ref(x, g, z, y, mask, lr, g_scale)
        return res if out is None else out.copy_(res)
    if x.device.type == "meta":
        return torch.empty_like(x) if out is None else out
    if x.device.type != "cuda":
        raise ValueError(f"mtgc_update_flat runs on cpu or cuda (or meta, shapes only), got {x.device}")
    if x.dim() != 3:
        raise ValueError(f"x must be [G, K, N], got shape {tuple(x.shape)}")
    G, K, N = x.shape
    _check("x", x, x.device, _DTYPES)
    _check("g", g, x.device, _DTYPES, x.shape)
    _check("z", z, x.device, _DTYPES, x.shape)
    _check("y", y, x.device, _DTYPES, (G, N))
    _check_types(x, g, z, y)
    if mask is not None:
        _check("mask", mask, x.device, (torch.float32,), (G, K))
    if out is None:
        out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    lib = load("mtgc_update")
    err = lib.mtgc_update_flat_launch(
        x.data_ptr(), g.data_ptr(), z.data_ptr(), y.data_ptr(),
        None if mask is None else mask.data_ptr(), out.data_ptr(),
        G * K, K, N, float(lr), float(g_scale),
        int(x.dtype == torch.bfloat16), int(z.dtype == torch.bfloat16),
        _stream(x.device))
    _raise_on(err, "mtgc_update_flat")
    mtgc_update_flat.launches += 1
    return out


def mtgc_update(x, g, z, y, *, lr: float, g_scale: float = 1.0):
    """Fused update over four equal-shape tensors (one model leaf; replaces
    the Pallas ``mtgc_update``, src/repro/kernels/mtgc_update.py:52).
    Returns a new tensor shaped like ``x``."""
    return kernel_call(mtgc_update, lambda: _update_leaf(x, g, z, y, lr, g_scale),
                       mtgc_update_cost, "f32", x, g, z, y)


def _update_leaf(x, g, z, y, lr, g_scale):
    if x.device.type == "cpu":
        return mtgc_update_ref(x, g, z, y, lr, g_scale)
    if x.device.type == "meta":
        return torch.empty_like(x)
    if x.device.type != "cuda":
        raise ValueError(f"mtgc_update runs on cpu or cuda (or meta, shapes only), got {x.device}")
    _check("x", x, x.device, _DTYPES)
    for name, t in (("g", g), ("z", z), ("y", y)):
        _check(name, t, x.device, _DTYPES, x.shape)
    _check_types(x, g, z, y)
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    lib = load("mtgc_update")
    err = lib.mtgc_update_leaf_launch(
        x.data_ptr(), g.data_ptr(), z.data_ptr(), y.data_ptr(), out.data_ptr(),
        x.numel(), float(lr), float(g_scale),
        int(x.dtype == torch.bfloat16), int(z.dtype == torch.bfloat16),
        _stream(x.device))
    _raise_on(err, "mtgc_update")
    mtgc_update.launches += 1
    return out


mtgc_update_flat.cost = mtgc_update_flat_cost
mtgc_update.cost = mtgc_update_cost
WRAPPERS = (mtgc_update_flat, mtgc_update)


def reset_launch_counts() -> None:
    """Set both wrappers' ``launches`` and ``calls`` counters to 0."""
    for w in WRAPPERS:
        w.launches = w.calls = 0


reset_launch_counts()
