"""Compressed hierarchical uploads (port of ``src/repro/core/compression.py``):
per-link quantization/sparsification plans, error-feedback residuals, and
bytes-on-the-wire accounting.

The two upload links are compression boundaries:

* **client -> group**: each active client uploads its local-phase delta
  ``x_end - x_start`` once per group round (E times per global round);
* **group -> global**: each reporting group uploads its aggregate delta
  ``xbar_g - x_start_g`` once per global round.

:class:`CompressionPlan` configures each link with one of
``none | bf16 | int8_stochastic | topk``:

* ``bf16`` -- a plain cast to bfloat16 and back (2 bytes/elem; no kernel);
* ``int8_stochastic`` -- per-row scale ``amax(|u|)/127`` and stochastic
  rounding to int8 (1 byte/elem + one f32 scale per row), unbiased;
* ``topk`` -- keep the ``ceil(topk_frac * N)`` largest-magnitude entries
  per row (8 bytes per kept entry: value + index), biased.

With ``error_feedback=True`` each link carries a residual (``efc``
``[G, K, ...]`` per client, ``efg`` ``[G, ...]`` per group): the link sends
``u = delta + residual`` and keeps ``u - Q(u)`` for the next upload.

The round trip of a row runs through the CUDA kernels of
``kernels/quantize.py`` when the engine's spec is fused (their plain
versions on CPU tensors), and through the plain versions directly when it
is not -- the reference's ``dispatch`` (``interpret``/``pallas`` against
``ref``). The threshold ``topk(|u|, k)`` and the int8 ``amax`` stay library
calls outside the kernels, as ``jax.lax.top_k`` and ``jnp.max`` are in the
reference. A row is worked through in pieces of at most ``_CHUNK``
elements (:func:`row_pieces`): its scale or threshold first
(:func:`row_params`, exact in pieces), then one round trip per column
block (:func:`roundtrip_block`), so a row of 1.65e9 elements needs no
temporary of its size; the sharded round streams its uploads through the
same two calls.

Random draws: the reference draws each leaf's noise from
``fold_in(key, leaf index)``. Here the caller passes the noise tensors
(one per leaf, ``[rows, n]``), or a ``torch.Generator`` that draws them
in leaf order, block by block.

Bytes on the wire are modeled (the int8 payload is never materialized):
:func:`upload_bytes` maps one model's leaves and a mode to the size of one
upload, :func:`round_comm_bytes` multiplies by the realized upload counts.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core.packer import dtype_key, key_dtype
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.kernels import ops as kops
from repro_torch.kernels import quantize as qz

COMPRESSION_MODES = ("none", "bf16", "int8_stochastic", "topk")

# Wire-format constants for the modeled byte accounting.
_SCALE_BYTES = 4        # one f32 scale per int8 row
_TOPK_ENTRY_BYTES = 8   # f32 value + int32 index per kept entry

# Elements per piece of an upload row: a longer row's scale or threshold and
# round trip are worked through in column blocks of at most this many
# elements a row (256 MB of float32), so no temporary as large as the row is
# formed (a flat glm4-9b row is 1.65e9 elements).
_CHUNK = 1 << 26


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


@dataclasses.dataclass(frozen=True)
class CompressionPlan:
    """Per-link upload compression config (the reference's fields).

    client_mode: compressor on the client -> group upload link.
    group_mode: compressor on the group -> global upload link.
    error_feedback: carry per-link residuals (``efc``/``efg`` state
        fields). Applies to every non-``none`` link.
    topk_frac: fraction of entries a ``topk`` link keeps per row
        (``k = ceil(topk_frac * N)``, at least 1).
    """

    client_mode: str = "none"
    group_mode: str = "none"
    error_feedback: bool = True
    topk_frac: float = 0.01

    @property
    def enabled(self) -> bool:
        return self.client_mode != "none" or self.group_mode != "none"

    @property
    def stochastic(self) -> bool:
        """True when either link draws rounding noise from the state rng."""
        return "int8_stochastic" in (self.client_mode, self.group_mode)

    @property
    def ef_client(self) -> bool:
        return self.error_feedback and self.client_mode != "none"

    @property
    def ef_group(self) -> bool:
        return self.error_feedback and self.group_mode != "none"

    def validate(self) -> "CompressionPlan":
        for name in ("client_mode", "group_mode"):
            mode = getattr(self, name)
            _require(mode in COMPRESSION_MODES,
                     f"unknown {name} {mode!r} (choose from {COMPRESSION_MODES})")
        _require(0.0 < self.topk_frac <= 1.0,
                 f"topk_frac must be in (0, 1], got {self.topk_frac}")
        return self


def _rows(leaf: torch.Tensor, lead_ndim: int) -> tuple[int, int]:
    rows = math.prod(leaf.shape[:lead_ndim])
    n = math.prod(leaf.shape[lead_ndim:]) if leaf.dim() > lead_ndim else 1
    return rows, n


def row_pieces(n: int) -> list[slice]:
    """The contiguous pieces of a row of ``n`` elements, at most ``_CHUNK``
    each, in order."""
    return [slice(s, min(s + _CHUNK, n)) for s in range(0, n, _CHUNK)]


def row_params(mode: str, blocks, n: int, frac: float = 0.01):
    """Each row's round-trip parameter from its pieces: ``blocks`` yields the
    ``[R, L]`` column blocks of ``R`` upload rows of ``n`` elements in order
    (the pieces of :func:`row_pieces`). Returns ``[R]``: the int8 scale
    ``amax(|u|) / 127`` (1 for a zero row), or the top-k threshold, the
    row's k-th largest magnitude; None for ``bf16``.

    Both are exact in pieces: the max of the pieces' maxima is the row's
    max, and every one of the row's k largest magnitudes lies among its
    piece's k largest, so the k-th largest of the running union of the
    pieces' top k is bit for bit ``torch.topk(|u|, k).values[:, -1]`` of the
    whole row (ties, +-Inf and NaN in topk's own order). A row of one piece
    takes exactly the whole-row calls."""
    if mode == "bf16":
        return None
    if mode == "int8_stochastic":
        amax = None
        for b in blocks:
            # |u| and max are exact in u's dtype: the widening can follow.
            m = torch.amax(torch.abs(b), dim=1).to(torch.float32)
            amax = m if amax is None else torch.maximum(amax, m)
        return torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    if mode == "topk":
        k = max(1, min(n, math.ceil(frac * n)))
        best = None
        for b in blocks:
            c = torch.topk(torch.abs(b), min(k, b.shape[1]), dim=1).values
            if best is not None:
                c = torch.cat([best, c], dim=1)
                c = torch.topk(c, min(k, c.shape[1]), dim=1).values
            best = c
        return best[:, -1]
    raise ValueError(f"unknown compression mode {mode!r}")


def roundtrip_block(u: torch.Tensor, mode: str, param, noise, fused: bool) -> torch.Tensor:
    """Quantize + dequantize one ``[R, L]`` block of upload rows with the
    rows' ``param`` (:func:`row_params`) and, for int8, the block's U[0, 1)
    ``noise`` (``[R, L]``). ``fused`` picks the CUDA kernels' wrappers (one
    launch for the block) over the plain versions."""
    if mode == "bf16":
        return u.to(torch.bfloat16).to(u.dtype)
    if mode == "int8_stochastic":
        fn = kops.int8_roundtrip if fused else qz.int8_roundtrip_ref
        return fn(u.contiguous(), param, noise.to(torch.float32).contiguous())
    if mode == "topk":
        fn = kops.topk_mask if fused else qz.topk_mask_ref
        return fn(u.contiguous(), param)
    raise ValueError(f"unknown compression mode {mode!r}")


def _leaf_roundtrip(leaf, lead_ndim: int, mode: str, frac: float, noise, generator,
                    fused: bool):
    """Quantize + dequantize one [*lead, ...] leaf, row = one upload, in
    column blocks of at most ``_CHUNK`` elements a row (one block for a
    short row: the whole-row calls, and one ``[rows, n]`` noise draw)."""
    rows, n = _rows(leaf, lead_ndim)
    u = leaf.reshape(rows, n)
    pieces = row_pieces(n)
    param = row_params(mode, (u[:, sl] for sl in pieces), n, frac)
    if noise is not None:
        noise = noise.reshape(rows, n)
    out = None
    for sl in pieces:
        nz = None
        if mode == "int8_stochastic":
            nz = (noise[:, sl] if noise is not None else
                  torch.rand((rows, sl.stop - sl.start), generator=generator,
                             dtype=torch.float32, device=leaf.device))
        deq = roundtrip_block(u[:, sl], mode, param, nz, fused)
        if len(pieces) == 1:
            return deq.reshape(leaf.shape)
        if out is None:
            out = torch.empty_like(u)
        out[:, sl] = deq
    return out.reshape(leaf.shape)


def roundtrip(delta, *, mode: str, lead_ndim: int, frac: float = 0.01, noise=None,
              generator: torch.Generator | None = None, fused: bool = False):
    """Quantize + dequantize every leaf of an upload-delta tree.

    ``lead_ndim`` leading axes index independent uploads (2 for the
    [G, K, ...] client link, 1 for the [G, ...] group link); each upload
    row gets its own scale/threshold. On the flat layout a row is a whole
    model; on the tree layout there is one row per leaf. ``int8_stochastic``
    needs its noise: ``noise`` (one ``[rows, n]`` tensor per leaf, in leaf
    order), or a ``generator`` that draws it leaf by leaf, one ``[rows, L]``
    block per column block of :func:`row_pieces` (one ``[rows, n]`` draw a
    leaf for rows of at most ``_CHUNK`` elements). ``fused`` picks the CUDA
    kernels' wrappers over the plain versions.
    """
    if mode == "none":
        return delta
    if mode == "int8_stochastic" and noise is None and generator is None:
        raise ValueError("int8_stochastic needs its noise: one [rows, n] tensor per leaf, "
                         "or a generator")
    leaves = tree_leaves(delta)
    if noise is not None and len(noise) != len(leaves):
        raise ValueError(f"{len(noise)} noise tensors for {len(leaves)} leaves")
    it = iter(noise if noise is not None else [None] * len(leaves))
    # tree_map visits the leaves in tree_leaves' order, the noise's order.
    return tree_map(lambda leaf: _leaf_roundtrip(leaf, lead_ndim, mode, frac, next(it),
                                                 generator, fused), delta)


def model_leaf_sizes(params, lead_ndim: int = 2) -> tuple[tuple[int, str], ...]:
    """One model's leaf geometry from a stacked state tree:
    ``((elements, dtype_name), ...)`` with the ``lead_ndim`` replica axes
    stripped."""
    out = []
    for leaf in tree_leaves(params):
        shape = tuple(leaf.shape)
        n = math.prod(shape[lead_ndim:]) if len(shape) > lead_ndim else 1
        out.append((n, dtype_key(leaf.dtype)))
    return tuple(out)


def upload_bytes(leaf_sizes, mode: str = "none", topk_frac: float = 0.01) -> float:
    """Modeled wire bytes of ONE upload (one client or one group) under
    ``mode``, from :func:`model_leaf_sizes` geometry."""
    total = 0
    for n, name in leaf_sizes:
        if mode == "none":
            total += n * key_dtype(name).itemsize
        elif mode == "bf16":
            total += 2 * n
        elif mode == "int8_stochastic":
            total += n + _SCALE_BYTES
        elif mode == "topk":
            total += _TOPK_ENTRY_BYTES * max(1, min(n, math.ceil(topk_frac * n)))
        else:
            raise ValueError(f"unknown compression mode {mode!r}")
    return float(total)


def round_comm_bytes(params, plan, n_client_uploads, n_group_uploads,
                     lead_ndim: int = 2) -> torch.Tensor:
    """Total modeled upload bytes of one global round (f32 scalar on the
    params' device), computed in float32 as the reference computes it.

    ``n_client_uploads`` / ``n_group_uploads`` are the realized upload
    counts across the round (tensors or Python numbers): every active
    client counts, unsampled clients and empty groups count zero.
    """
    sizes = model_leaf_sizes(params, lead_ndim)
    device = tree_leaves(params)[0].device
    on = plan is not None and plan.enabled
    cmode = plan.client_mode if on else "none"
    gmode = plan.group_mode if on else "none"
    frac = plan.topk_frac if on else 0.01
    cb = upload_bytes(sizes, cmode, frac)
    gb = upload_bytes(sizes, gmode, frac)
    nc = torch.as_tensor(n_client_uploads, dtype=torch.float32, device=device)
    ng = torch.as_tensor(n_group_uploads, dtype=torch.float32, device=device)
    return nc * cb + ng * gb
