"""Top-k token dispatch and combine of the moe family.

The reference (``src/repro/models/moe.py:86-99``; jnp, no Pallas call)
builds the dispatch tensor ``disp [S, k, E, C]`` -- the product of each
choice's expert one-hot, its capacity-position one-hot and its ``keep``
flag -- and contracts it with the tokens (``sec,sd->ecd``) and with the
experts' outputs (``sec,ecd->sd``, ``disp`` weighted by the gates). That is
quadratic in the tokens. The function is a permutation: a token's k experts
are distinct, so each (expert, slot) holds at most one (token, choice).
Three hand-written CUDA kernels for Hopper (``csrc/moe_dispatch.cu``; the
note at its top says what bounds them and what the design does about it)
compute it directly:

* :func:`moe_gather`: ``out[e, c] = scale[s, j] * src[s]`` for the choice
  (s, j) that holds slot (e, c), 0 for an empty slot; no scale is 1 (the
  dispatch, bit for bit the one-hot einsum). With the gates as the scale it
  is the combine's backward for the experts' outputs.
* :func:`moe_combine`: ``out[s] = sum_j keep[s, j] * w[s, j] *
  y[e_j, pos_j]``, summed in float32 in the order j = 0 .. k - 1 and
  rounded once (the reference's einsum sums over (e, c) instead); no w is
  1 (the dispatch's backward for the tokens).
* :func:`moe_gate_grad`: ``dg[s, j] = keep[s, j] * <dout[s], y[e_j, pos_j]>``,
  the combine's backward for its weights, reduced over D in float32.

The routing (which expert, which slot, kept or dropped) is the reference's
and is computed in PyTorch by ``models/moe.py::route``; :func:`make_routing`
adds the two index maps the kernels read. The plain versions beside each
wrapper are the reference's one-hot einsum form, one choice j at a time (the
sum over j of ``disp`` has one nonzero term per (s, e, c), so it is the
same). They build ``[S, E, C]`` one-hots: the CPU tests use them, and the
card's main path never does.

Dispatch is by device: a CPU tensor takes the plain version, a CUDA tensor
launches the kernel (building it on first use), a ``meta`` tensor gets its
output's shape, any other device raises. Each wrapper's ``launches``
counts its kernel's launches, one a call, and its ``calls`` its calls on
every route; ``moe_gather_cost``, ``moe_combine_cost`` and
``moe_gate_grad_cost`` give a call's (FLOPs, bytes) at its routing. :class:`MoEDispatch`
and :class:`MoECombine` are the differentiable forms the model calls; their
backward passes are the same kernels, and they recompute alike under
non-reentrant ``torch.utils.checkpoint`` (the routing is deterministic and
every kernel sums in a fixed order).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.accounting import kernel_call
from repro_torch.kernels.build import load
from repro_torch.kernels.mtgc_update import _check, _raise_on, _stream

MAX_K = 32                     # csrc/moe_dispatch.cu kMaxK
WARPS = 8                      # csrc/moe_dispatch.cu kWarps: warps a block
_DTYPES = (torch.float32, torch.bfloat16)
_I32 = (torch.int32,)


class Routing(NamedTuple):
    gate_idx: torch.Tensor     # [S, k] int64: each choice's expert
    pos: torch.Tensor          # [S, k] int64: its position in the expert's buffer
    keep: torch.Tensor         # [S, k] bool: pos < capacity
    num_experts: int
    capacity: int
    row: torch.Tensor          # [S, k] int32: e * C + pos of a kept choice, else -1
    slot: torch.Tensor         # [E * C] int32: s * k + j of the choice in the slot, else -1


def make_routing(gate_idx, pos, keep, num_experts: int, capacity: int) -> Routing:
    """The routing record of ``(gate_idx, pos, keep)`` with the kernels'
    index maps. The kept choices' slots are distinct, so each entry of
    ``slot`` is written once; the dropped choices all go to one spare entry
    past the end, which is cut off."""
    S, k = gate_idx.shape
    n = num_experts * capacity
    row = torch.where(keep, gate_idx * capacity + pos, -1)
    slot = torch.full((n + 1,), -1, dtype=torch.int64, device=gate_idx.device)
    slot.scatter_(0, torch.where(keep, row, n).reshape(-1),
                  torch.arange(S * k, device=gate_idx.device))
    return Routing(gate_idx, pos, keep, num_experts, capacity, row.to(torch.int32),
                   slot[:n].to(torch.int32))


# ---------------------------------------------------------------- plain versions


def _disp(r: Routing, j: int, dtype) -> torch.Tensor:
    """Choice j's slice of the reference's ``disp``: [S, E, C] in ``dtype``."""
    e = F.one_hot(r.gate_idx[:, j], r.num_experts).to(dtype)
    c = (r.pos[:, j, None] == torch.arange(r.capacity, device=r.pos.device)).to(dtype)
    return e[:, :, None] * c[:, None, :] * r.keep[:, j, None, None].to(dtype)


def _disp_sum(r: Routing, dtype, w=None) -> torch.Tensor:
    """``(disp * w[..., None, None]).sum(1)`` ([S, E, C]; w None is 1)."""
    k = r.gate_idx.shape[1]
    out = 0
    for j in range(k):
        d = _disp(r, j, dtype)
        out = out + (d if w is None else d * w[:, j, None, None].to(dtype))
    return out


def moe_gather_ref(src, r: Routing, scale=None):
    """Plain version: ``einsum("sec,sd->ecd", (disp * scale).sum(1), src)``."""
    return torch.einsum("sec,sd->ecd", _disp_sum(r, src.dtype, scale), src)


def moe_combine_ref(y, r: Routing, w=None):
    """Plain version: ``einsum("sec,ecd->sd", (disp * w).sum(1), y)``."""
    return torch.einsum("sec,ecd->sd", _disp_sum(r, y.dtype, w), y)


def moe_gate_grad_ref(dout, y, r: Routing):
    """Plain version: the transpose of the combine's weighting,
    ``sum_ec disp[s, j] * einsum("sd,ecd->sec", dout, y)``."""
    dcomb = torch.einsum("sd,ecd->sec", dout, y)
    k = r.gate_idx.shape[1]
    return torch.stack([(_disp(r, j, dout.dtype) * dcomb).sum((1, 2)) for j in range(k)], 1)


# ---------------------------------------------------------------- kernels


def _check_routing(r: Routing, S: int, dev) -> int:
    """The routing's maps on ``dev`` for S tokens; returns k."""
    k = r.gate_idx.shape[1]
    _check("row", r.row, dev, _I32, (S, k))
    _check("slot", r.slot, dev, _I32, (r.num_experts * r.capacity,))
    if not 1 <= k <= MAX_K:
        raise ValueError(f"top_k {k} is not one the kernels take (1 to {MAX_K})")
    return k


def _bf16(t: torch.Tensor) -> int:
    return int(t.dtype == torch.bfloat16)


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def kept_choices(r: Routing) -> int:
    """The kept (token, choice) pairs of a routing: counted on a CPU or
    CUDA routing (the work this data needs), the most there can be on a
    ``meta`` one (every choice, or every slot)."""
    S, k = r.gate_idx.shape
    if r.keep.device.type == "meta":
        return min(S * k, r.num_experts * r.capacity)
    return int(r.keep.sum())


def moe_gather_cost(src, r: Routing, scale=None):
    """(FLOPs, bytes) of one ``moe_gather`` call: src, the slot map (int32)
    and the scale read once, every slot row written once; a multiply an
    element of a kept row when scaled."""
    S, D = src.shape
    k, elt, n_slots = r.gate_idx.shape[1], src.element_size(), r.num_experts * r.capacity
    flops = 0 if scale is None else kept_choices(r) * D
    return flops, (S * D * elt + n_slots * 4 + (0 if scale is None else S * k * elt)
                   + n_slots * D * elt)


def moe_combine_cost(y, r: Routing, w=None):
    """(FLOPs, bytes) of one ``moe_combine`` call: the kept rows of y, the
    row map (int32) and w read once, the tokens written once; a
    multiply-add an element of a kept row."""
    S, k = r.gate_idx.shape
    D, elt, kept = y.shape[-1], y.element_size(), kept_choices(r)
    return 2 * kept * D, (kept * D * elt + S * k * 4 + (0 if w is None else S * k * elt)
                          + S * D * elt)


def moe_gate_grad_cost(dout, y, r: Routing):
    """(FLOPs, bytes) of one ``moe_gate_grad`` call: dout, the kept rows of
    y and the row map read once, dg written once; a multiply-add an element
    of a kept row."""
    S, D = dout.shape
    k, elt, kept = r.gate_idx.shape[1], dout.element_size(), kept_choices(r)
    return 2 * kept * D, S * D * elt + kept * D * elt + S * k * 4 + S * k * elt


def moe_gather(src, r: Routing, scale=None):
    """src [S, D] float32 or bfloat16 -> [E, C, D] of its dtype (see the
    module docstring); scale [S, k] of src's dtype or None. On a CUDA tensor
    all contiguous on one card."""
    return kernel_call(moe_gather, lambda: _gather(src, r, scale), moe_gather_cost, "f32", src, r,
                       scale)


def _gather(src, r, scale):
    if src.device.type == "cpu":
        return moe_gather_ref(src, r, scale)
    if src.device.type == "meta":
        return torch.empty((r.num_experts, r.capacity, src.shape[1]), dtype=src.dtype,
                           device="meta")
    if src.device.type != "cuda":
        raise ValueError(f"moe_gather runs on cpu or cuda (or meta, shapes only), got {src.device}")
    S, D = src.shape
    _check("src", src, src.device, _DTYPES)
    k = _check_routing(r, S, src.device)
    if scale is not None:
        _check("scale", scale, src.device, (src.dtype,), (S, k))
    out = torch.empty((r.num_experts, r.capacity, D), dtype=src.dtype, device=src.device)
    err = load("moe_dispatch").moe_gather_launch(
        src.data_ptr(), r.slot.data_ptr(), _ptr(scale), out.data_ptr(),
        r.num_experts * r.capacity, D, k, _bf16(src), _stream(src.device))
    _raise_on(err, "moe_gather")
    moe_gather.launches += 1
    return out


def moe_combine(y, r: Routing, w=None):
    """y [E, C, D] float32 or bfloat16 -> [S, D] of its dtype (see the
    module docstring); w [S, k] of y's dtype or None. On a CUDA tensor all
    contiguous on one card."""
    return kernel_call(moe_combine, lambda: _combine(y, r, w), moe_combine_cost, "f32", y, r, w)


def _combine(y, r, w):
    if y.device.type == "cpu":
        return moe_combine_ref(y, r, w)
    if y.device.type == "meta":
        return torch.empty((r.gate_idx.shape[0], y.shape[-1]), dtype=y.dtype, device="meta")
    if y.device.type != "cuda":
        raise ValueError(f"moe_combine runs on cpu or cuda (or meta, shapes only), got {y.device}")
    S = r.gate_idx.shape[0]
    D = y.shape[-1]
    _check("y", y, y.device, _DTYPES, (r.num_experts, r.capacity, D))
    k = _check_routing(r, S, y.device)
    if w is not None:
        _check("w", w, y.device, (y.dtype,), (S, k))
    out = torch.empty((S, D), dtype=y.dtype, device=y.device)
    err = load("moe_dispatch").moe_combine_launch(
        y.data_ptr(), r.row.data_ptr(), _ptr(w), out.data_ptr(), S, D, k, _bf16(y),
        _stream(y.device))
    _raise_on(err, "moe_combine")
    moe_combine.launches += 1
    return out


def moe_gate_grad(dout, y, r: Routing):
    """dout [S, D] and y [E, C, D] of one dtype -> dg [S, k] of that dtype
    (see the module docstring). On a CUDA tensor all contiguous on one
    card."""
    return kernel_call(moe_gate_grad, lambda: _gate_grad(dout, y, r), moe_gate_grad_cost, "f32",
                       dout, y, r)


def _gate_grad(dout, y, r):
    if dout.device.type == "cpu":
        return moe_gate_grad_ref(dout, y, r)
    if dout.device.type == "meta":
        return torch.empty(tuple(r.gate_idx.shape), dtype=dout.dtype, device="meta")
    if dout.device.type != "cuda":
        raise ValueError(f"moe_gate_grad runs on cpu or cuda (or meta, shapes only), got {dout.device}")
    S, D = dout.shape
    _check("dout", dout, dout.device, _DTYPES)
    _check("y", y, dout.device, (dout.dtype,), (r.num_experts, r.capacity, D))
    k = _check_routing(r, S, dout.device)
    dg = torch.empty((S, k), dtype=dout.dtype, device=dout.device)
    err = load("moe_dispatch").moe_gate_grad_launch(
        dout.data_ptr(), y.data_ptr(), r.row.data_ptr(), dg.data_ptr(), S, D, k, _bf16(dout),
        _stream(dout.device))
    _raise_on(err, "moe_gate_grad")
    moe_gate_grad.launches += 1
    return dg


moe_gather.cost = moe_gather_cost
moe_combine.cost = moe_combine_cost
moe_gate_grad.cost = moe_gate_grad_cost
WRAPPERS = (moe_gather, moe_combine, moe_gate_grad)

_PLAN_KERNELS = {"gather": 0, "gather_scaled": 1, "combine": 2}


def launch_plan(kernel: str, rows: int, D: int, k: int, dtype) -> dict:
    """The grid that ``moe_gather`` (``kernel`` "gather", or "gather_scaled"
    with a scale) or ``moe_combine`` ("combine") launches on the current
    card for ``rows`` slot rows or tokens of width D in ``dtype``, on the
    16-byte vector path where D allows it: ``blocks``, ``blocks_per_sm``
    (the most that fit), ``sms``, ``per`` (1 for the gather, a warp a slot
    row; the combine's warps a token), ``tasks`` (a warp each) and
    ``warps_per_sm`` (the grid's warps over the SMs). Needs the card; does
    not launch."""
    out = (ctypes.c_int * 4)()
    vec = int(D % (16 // torch.empty((), dtype=dtype).element_size()) == 0)
    err = load("moe_dispatch").moe_launch_plan(
        _PLAN_KERNELS[kernel], rows, D, k, int(dtype == torch.bfloat16), vec, out)
    _raise_on(err, "moe_launch_plan")
    blocks, per_sm, sms, per = out
    tasks = rows * per
    return {"blocks": blocks, "blocks_per_sm": per_sm, "sms": sms, "per": per, "tasks": tasks,
            "warps_per_sm": blocks * WARPS / sms}


def reset_launch_counts() -> None:
    """Set every wrapper's ``launches`` and ``calls`` counters to 0."""
    for w in WRAPPERS:
        w.launches = w.calls = 0


reset_launch_counts()


# ---------------------------------------------------------------- autograd


def _saved(ctx) -> tuple:
    """(the other saved tensors, the Routing). ``ctx.saved_tensors`` is read
    once: under non-reentrant checkpoint a second read raises."""
    *rest, g, p, kp, row, slot = ctx.saved_tensors
    return rest, Routing(g, p, kp, ctx.num_experts, ctx.capacity, row, slot)


def _save(ctx, r: Routing, *tensors) -> None:
    ctx.num_experts, ctx.capacity = r.num_experts, r.capacity
    ctx.save_for_backward(*tensors, r.gate_idx, r.pos, r.keep, r.row, r.slot)


class MoEDispatch(torch.autograd.Function):
    """``moe_gather(x, r)`` (x [S, D] -> [E, C, D]); backward
    ``moe_combine(dy, r)``."""

    @staticmethod
    def forward(ctx, x, r: Routing):
        _save(ctx, r)
        return moe_gather(x, r)

    @staticmethod
    def backward(ctx, dy):
        return moe_combine(dy.contiguous(), _saved(ctx)[1]), None


class MoECombine(torch.autograd.Function):
    """``moe_combine(y, r, w)`` (y [E, C, D], w [S, k] -> [S, D]); backward
    ``moe_gather(dout, r, w)`` for y and ``moe_gate_grad(dout, y, r)`` for
    w."""

    @staticmethod
    def forward(ctx, y, w, r: Routing):
        _save(ctx, r, y, w)
        return moe_combine(y, r, w)

    @staticmethod
    def backward(ctx, dout):
        (y, w), r = _saved(ctx)
        dout = dout.contiguous()
        dy = moe_gather(dout, r, w) if ctx.needs_input_grad[0] else None
        dw = moe_gate_grad(dout, y, r) if ctx.needs_input_grad[1] else None
        return dy, dw, None
