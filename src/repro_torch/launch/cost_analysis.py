"""FLOPs, bytes and collective bytes of one eager call, counted at dispatch.

The counterpart of ``src/repro/launch/hlo_analysis.py``, which walks the
optimized HLO of a compiled program. Eager PyTorch has no program to walk:
:class:`CostCounter` is a ``TorchDispatchMode`` that sees every aten op one
call (a round, a prefill, a decode step) dispatches, on CPU, CUDA or
``meta`` tensors alike, and counts it by ``hlo_analysis._instr_flops``'s
rules:

* **FLOPs.** Products (mm, bmm, addmm, baddbmm, convolution and their
  backward ops) count ``2 * prod(result) * contracting``, by the formulas of
  ``torch.utils.flop_counter``; an element-wise op (``torch.Tag.pointwise``)
  counts ``prod(result)``, a reduction (``torch.Tag.reduction``)
  ``prod(operand)``. Products with bfloat16 or float16 operands are held to
  the tensor cores' peak, everything else to the CUDA cores' (``by_kind``).
* **Bytes.** Every op that materialises counts its operands' and its
  result's bytes; a view counts nothing, an allocation without values
  (``empty``) nothing, a copy its source and destination once each. In
  eager PyTorch every non-view op materialises: this is the port's real
  memory traffic, where XLA's would be its fusions' boundaries. A copy
  between devices (the host's constants sent to the card) goes to
  ``transfer_bytes`` instead: a CPU run makes no such copy, and ``bytes``
  stays the same on every route.
* **Hand kernels.** A wrapper of ``kernels/`` reports its own ``cost(...)``
  (``kernels/accounting.py``) and the ops its plain version dispatches
  inside it are not counted, so a CPU run, a meta run and a card run count
  the same work.
* **Collectives.** The mesh's all-reduces (``sharding/state.py``,
  ``MeshAxes.sum_``) report their bytes, bucketed by kind; on ``meta`` the
  call is not made but is counted.
* **Scopes.** Each count goes to one of the reference's buckets (``attn``,
  ``moe``, ``mlp``, ``rwkv``, ``ssm``, ``xent``, ``embed``, ``group_agg``,
  ``global_agg``; else ``other``), resolved from the Python stack through
  :data:`FUNC_BUCKETS`, the (file, function) table that mirrors
  ``hlo_analysis._FUNC_BUCKETS`` over the port's files. An op of the
  backward pass takes the bucket its autograd node was created in.

There are no trip counts: eager runs every iteration, so the count is of
the whole call, every layer, local step and microbatch included.

    with CostCounter() as cc:
        state, metrics = engine.round_fn(state, batches)
    costs = cc.costs          # Costs(flops=..., bytes=..., by_scope=...)
"""
from __future__ import annotations

import dataclasses
import sys
import weakref
from collections import defaultdict

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import accounting

BUCKETS = ("attn", "moe", "mlp", "rwkv", "ssm", "xent", "embed", "group_agg", "global_agg")

# (file suffix, function name or "" for the whole file) -> bucket; the
# innermost matching frame of the stack decides.
FUNC_BUCKETS = (
    ("models/layers.py", "naive_attention", "attn"),
    ("models/layers.py", "gqa_decode_attention", "attn"),
    ("models/layers.py", "attention_block", "attn"),
    ("models/layers.py", "apply_rope", "attn"),
    ("models/layers.py", "swiglu", "mlp"),
    ("models/layers.py", "embed", "embed"),
    ("models/layers.py", "unembed", "xent"),
    ("models/moe.py", "", "moe"),
    ("models/rwkv6.py", "", "rwkv"),
    ("models/ssm.py", "", "ssm"),
    ("models/transformer.py", "chunked_xent", "xent"),
    ("models/transformer.py", "_rwkv_cmix", "rwkv"),
    ("kernels/flash_attention.py", "", "attn"),
    ("kernels/moe_dispatch.py", "", "moe"),
    ("kernels/rwkv6_scan.py", "", "rwkv"),
    ("kernels/ssm_scan.py", "", "ssm"),
    ("launch/train.py", "aggregate_group", "group_agg"),
    ("launch/train.py", "client_mean", "group_agg"),
    ("launch/train.py", "round_fn", "global_agg"),
)

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all", "collective-permute")

# Ops that move no values: allocations without contents, and aliases that
# the schema does not mark as views.
_NO_BYTES = frozenset(("empty", "empty_strided", "empty_like", "new_empty",
                       "new_empty_strided", "_unsafe_view", "lift_fresh", "set_", "resize_",
                       "_local_scalar_dense", "detach", "alias"))
# Ops that move or fill values and compute none (HLO's copies and
# broadcasts, which ``hlo_analysis`` counts no FLOPs for either).
_NO_FLOPS = frozenset(("clone", "_to_copy", "copy_", "copy", "fill_", "zero_", "zeros_like",
                       "ones_like", "full_like", "fill", "masked_fill_", "masked_fill",
                       "index_put_", "scatter_", "slice_scatter", "select_scatter"))
_ACCOUNTED_NAMESPACES = frozenset(("c10d", "_c10d_functional", "_dtensor"))
_TENSOR_CORE = (torch.bfloat16, torch.float16)


@dataclasses.dataclass
class Costs:
    """What one call costs (``hlo_analysis.HloCosts``'s fields).

    flops / bytes / collective_bytes: the whole call's.
    transfer_bytes: the bytes copied from one device to another (not in
        ``bytes``, so that a CPU run counts what a card run does).
    per_collective: collective bytes by kind (:data:`COLLECTIVES`).
    top_flops / top_bytes: the largest contributors, ``[(amount, name)]``
        by aten op or kernel wrapper.
    by_scope: bucket -> ``{"flops", "bytes", "collective"}``.
    by_kind: FLOPs by the peak they are held to: ``"bf16"`` (tensor cores)
        or ``"f32"`` (CUDA cores).
    kernels: wrapper -> ``{"calls", "flops", "bytes"}`` of the hand kernels.
    by_op: aten op or kernel wrapper -> ``{"flops", "bytes"}``.
    notes: what the count could not see.
    """

    flops: float = 0.0
    bytes: float = 0.0
    collective_bytes: float = 0.0
    transfer_bytes: float = 0.0
    per_collective: dict = dataclasses.field(
        default_factory=lambda: {c: 0.0 for c in COLLECTIVES})
    top_flops: list = dataclasses.field(default_factory=list)
    top_bytes: list = dataclasses.field(default_factory=list)
    by_scope: dict = dataclasses.field(default_factory=dict)
    by_kind: dict = dataclasses.field(default_factory=lambda: {"bf16": 0.0, "f32": 0.0})
    kernels: dict = dataclasses.field(default_factory=dict)
    by_op: dict = dataclasses.field(default_factory=dict)
    notes: list = dataclasses.field(default_factory=list)


class OpRecord:
    """One counted op: its name, its outputs' (dtype, shape) and its scope."""

    __slots__ = ("name", "outputs", "scope")

    def __init__(self, name, outputs, scope):
        self.name, self.outputs, self.scope = name, outputs, scope


_code_buckets: dict = {}


def _code_bucket(code) -> str | None:
    b = _code_buckets.get(code, False)
    if b is False:
        fn = code.co_filename.replace("\\", "/")
        b = None
        if "/repro_torch/" in fn:
            for suffix, func, bucket in FUNC_BUCKETS:
                if fn.endswith(suffix) and (not func or code.co_name == func):
                    b = bucket
                    break
        _code_buckets[code] = b
    return b


def stack_scope(frame=None) -> str | None:
    """The bucket of the innermost frame of the stack that the table names."""
    f = frame or sys._getframe(1)
    while f is not None:
        b = _code_bucket(f.f_code)
        if b is not None:
            return b
        f = f.f_back
    return None


def _scope() -> str:
    node = torch._C._current_autograd_node()
    if node is not None:
        b = node.metadata.get("cost_scope")
        if b is not None:
            return b
    return stack_scope(sys._getframe(2)) or "other"


def _tensors(tree, out=None) -> list:
    """The tensors of an op's arguments or results (tuples, lists and dicts
    of them, nested)."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (tuple, list)):
        for t in tree:
            _tensors(t, out)
    elif isinstance(tree, dict):
        for t in tree.values():
            _tensors(t, out)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _transfer(name: str, args, out) -> int:
    """The bytes a copy (``_to_copy(src)``, ``copy_(dst, src)``) moves from
    one device to another; 0 for a copy within a device or another op."""
    if name == "_to_copy":
        src, dst = args[0], out
    elif name == "copy_":
        src, dst = args[1], args[0]
    else:
        return 0
    if not (isinstance(src, torch.Tensor) and isinstance(dst, torch.Tensor)):
        return 0
    return _nbytes(src) if src.device != dst.device else 0


class _NodeScopes(TorchFunctionMode):
    """Tags each autograd node a torch call creates with the bucket of the
    stack that made it, so that its backward ops are counted there."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if torch.is_grad_enabled():
            for t in _tensors(out):
                node = t.grad_fn
                if node is not None and "cost_scope" not in node.metadata:
                    b = stack_scope(sys._getframe(1))
                    if b is not None:
                        node.metadata["cost_scope"] = b
        return out


class CostCounter(TorchDispatchMode):
    """Counts the FLOPs, bytes and collective bytes of everything run while
    it is entered (see the module docstring); the result is :attr:`costs`.

    record_ops: keep an :class:`OpRecord` of every counted op and kernel
        call in :attr:`ops` (the auditor's f64 check reads them).
    track_live: follow the bytes of the tensors made while entered and keep
        their peak in :attr:`peak_bytes` (the dryrun's memory estimate; the
        tensors that existed before are the caller's to add).
    """

    def __init__(self, *, record_ops: bool = False, track_live: bool = False):
        super().__init__()
        self.costs = Costs()
        self.record_ops, self.track_live = record_ops, track_live
        self.ops: list[OpRecord] = []
        self.live_bytes = self.peak_bytes = 0
        self._refs: set = set()
        self._flops_by = defaultdict(float)
        self._bytes_by = defaultdict(float)
        self._scopes = _NodeScopes()
        self._listen = accounting.listen(self)

    # ------------------------------------------------------------ context
    def __enter__(self):
        self._listen.__enter__()
        self._scopes.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._scopes.__exit__(*exc)
            self._listen.__exit__(*exc)
            self._finish()

    def _finish(self) -> None:
        c = self.costs
        c.by_op = {k: {"flops": self._flops_by[k], "bytes": self._bytes_by[k]}
                   for k in self._flops_by}
        c.top_flops = sorted(((v, k) for k, v in self._flops_by.items() if v), reverse=True)[:8]
        c.top_bytes = sorted(((v, k) for k, v in self._bytes_by.items() if v), reverse=True)[:16]

    # -------------------------------------------------------------- count
    def _add(self, name: str, scope: str, flops: float, nbytes: float, kind: str) -> None:
        c = self.costs
        c.flops += flops
        c.bytes += nbytes
        c.by_kind[kind] += flops
        bucket = c.by_scope.setdefault(scope, {"flops": 0.0, "bytes": 0.0, "collective": 0.0})
        bucket["flops"] += flops
        bucket["bytes"] += nbytes
        self._flops_by[name] += flops
        self._bytes_by[name] += nbytes

    def _born(self, outs, ins) -> None:
        """Follow the bytes of new tensors (outputs that are no input)."""
        seen = {id(t) for t in ins}
        for t in outs:
            if id(t) in seen:
                continue
            n = _nbytes(t)
            self.live_bytes += n
            if self.live_bytes > self.peak_bytes:
                self.peak_bytes = self.live_bytes
            self._refs.add(weakref.ref(t, self._freer(n)))

    def _freer(self, n: int):
        def free(ref):
            self.live_bytes -= n
            self._refs.discard(ref)
        return free

    def on_kernel(self, name, flops, nbytes, kind, out) -> None:
        scope = stack_scope(sys._getframe(2)) or "other"
        node = torch._C._current_autograd_node()
        if node is not None:
            scope = node.metadata.get("cost_scope", scope)
        self._add(name, scope, flops, nbytes, kind)
        k = self.costs.kernels.setdefault(name, {"calls": 0, "flops": 0.0, "bytes": 0.0})
        k["calls"] += 1
        k["flops"] += flops
        k["bytes"] += nbytes
        outs = _tensors(out)
        if self.record_ops:
            self.ops.append(OpRecord(name, [(t.dtype, tuple(t.shape)) for t in outs], scope))
        if self.track_live:
            self._born(outs, ())

    def on_collective(self, kind, nbytes) -> None:
        c = self.costs
        c.collective_bytes += nbytes
        c.per_collective[kind] = c.per_collective.get(kind, 0.0) + nbytes
        scope = stack_scope(sys._getframe(2)) or "other"
        bucket = c.by_scope.setdefault(scope, {"flops": 0.0, "bytes": 0.0, "collective": 0.0})
        bucket["collective"] += nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if accounting.inside_kernel() or func.namespace in _ACCOUNTED_NAMESPACES:
            return out
        name = func.overloadpacket.__name__
        outs = _tensors(out)
        ins = _tensors(args)
        if kwargs:
            _tensors([v for k, v in kwargs.items() if k != "out"], ins)
        flops, kind = 0.0, "f32"
        packet = func.overloadpacket
        if packet in flop_registry:
            flops = float(flop_registry[packet](*args, **kwargs, out_val=out))
            if any(t.dtype in _TENSOR_CORE for t in ins):
                kind = "bf16"
        elif name in _NO_FLOPS:
            pass
        elif torch.Tag.pointwise in func.tags and outs:
            flops = float(outs[0].numel())
        elif torch.Tag.reduction in func.tags and ins:
            flops = float(ins[0].numel())
        if func.is_view or name in _NO_BYTES:
            nbytes = 0.0
        elif name == "copy_":
            nbytes = float(_nbytes(args[1]) + _nbytes(args[0]))
        else:
            nbytes = float(sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs))
        moved = _transfer(name, args, out)
        if moved:
            self.costs.transfer_bytes += moved
            nbytes = 0.0
        scope = _scope()
        self._add(f"aten.{name}", scope, flops, nbytes, kind)
        if self.record_ops:
            self.ops.append(OpRecord(f"aten.{name}", [(t.dtype, tuple(t.shape)) for t in outs],
                                     scope))
        if self.track_live and not func.is_view:
            self._born(outs, ins)
        return out


def roofline(costs: Costs, *, bf16_flops_per_s: float, f32_flops_per_s: float,
             hbm_bytes_per_s: float, link_bytes_per_s: float) -> dict:
    """The three roofline terms (seconds) of ``costs`` on a device of the
    given peaks: compute (each kind of FLOPs over its peak), memory (bytes
    over the memory rate) and collective (bytes over one link's rate)."""
    terms = {
        "compute_s": (costs.by_kind.get("bf16", 0.0) / bf16_flops_per_s
                      + costs.by_kind.get("f32", 0.0) / f32_flops_per_s),
        "memory_s": costs.bytes / hbm_bytes_per_s,
        "collective_s": costs.collective_bytes / link_bytes_per_s,
    }
    return terms
