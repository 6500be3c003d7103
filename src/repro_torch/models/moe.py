"""Mixture-of-Experts block (top-k routing, granite's top-8 of 32).

Port of ``src/repro/models/moe.py``. The routing follows the reference line
by line: router logits cast to float32, softmax, the top k with their gates
normalised by ``max(sum, 1e-9)`` before any drop; a capacity of
``min(S, max(int(capacity_factor * S * top_k / num_experts), 4))`` slots an
expert (S when dropless); each choice's position in its expert's buffer from
a cumulative sum over the ``(s, j)``-flattened one-hot, so later tokens are
the ones dropped. The top k is a stable descending sort: among equal
probabilities the lower expert comes first, as ``jax.lax.top_k`` puts it
(``torch.topk`` does not). The experts' SwiGLU runs as batched products over
``[E, C, D]`` buffers.

Dispatch and combine go through ``kernels/moe_dispatch.py`` (hand-written
CUDA on the card; the reference's one-hot einsums on the CPU), where the
reference contracts a ``[S, k, E, C]`` one-hot tensor; the sum of a token's
k weighted expert rows runs in the order j = 0 .. k - 1 (the reference's
einsum sums over (e, c)). Long inputs are routed in chunks, as the reference
routes them (capacity budgeted per chunk); the chunks run one after another
whether ``sequential`` (the reference's ``lax.map``) or not (its ``vmap``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.moe_dispatch import MoECombine, MoEDispatch, make_routing
from repro_torch.models import layers as L


def init_moe(gen, d_model, d_ff, num_experts, dtype, device) -> dict:
    def ew(n_in, n_out):
        return L._norm_init(gen, (num_experts, n_in, n_out), dtype, device, fan_in=n_in)

    return {
        "router": L.init_linear(gen, d_model, num_experts, dtype, device),
        "wi": ew(d_model, d_ff),
        "wg": ew(d_model, d_ff),
        "wo": ew(d_ff, d_model),
    }


def capacity_of(S: int, *, num_experts: int, top_k: int, capacity_factor: float = 1.25,
                dropless: bool = False) -> int:
    """Slots an expert for S tokens (Python floats, as the reference)."""
    if dropless:
        return S
    return min(S, max(int(capacity_factor * S * top_k / num_experts), 4))


def sorted_top_k(probs, k: int):
    """(values, indices) of the k largest entries of each row, largest
    first, the lower index first among equal values (``jax.lax.top_k``'s
    order): a stable descending sort."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(p, xf, *, num_experts, top_k, capacity):
    """xf [S, D] -> (probs [S, E] float32, gates [S, k] float32, Routing)."""
    S = xf.shape[0]
    logits = L.linear(p["router"], xf).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    gate, gate_idx = sorted_top_k(probs, top_k)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    # Each choice's position: the count of earlier (s, j) choices of its
    # expert, a cumulative sum over the flattened one-hot. It runs along
    # the contiguous last dim of an [E, S * k] one-hot: PyTorch's scan along
    # the outer dim of [S * k, E] (the reference's layout) took 3.1 ms a
    # call at S = 2048 on the card, two thirds of a training round's device
    # time.
    flat = F.one_hot(gate_idx.reshape(-1), num_experts).t().contiguous()
    pos = torch.cumsum(flat, dim=1).gather(0, gate_idx.reshape(1, -1)).reshape(S, top_k) - 1
    r = make_routing(gate_idx, pos, pos < capacity, num_experts, capacity)
    return probs, gate, r


def experts(p, expert_in):
    """The experts' SwiGLU on their buffers: [E, C, D] -> [E, C, D]."""
    h = F.silu(torch.bmm(expert_in, p["wg"])) * torch.bmm(expert_in, p["wi"])
    return torch.bmm(h, p["wo"])


def moe_block(p, x, *, num_experts, top_k, capacity_factor=1.25, dropless=False,
              chunk_tokens=4096, sequential=True):
    """x [B, T, D] -> (out [B, T, D], aux loss: a float32 scalar).

    ``dropless=True`` sets the capacity to S (no token is dropped), as the
    serve paths do for modest token counts."""
    B, T, D = x.shape
    S = B * T
    chunk = S
    for cand in (chunk_tokens, chunk_tokens // 2, chunk_tokens // 4):
        if S > chunk_tokens and S % cand == 0:
            chunk = cand
            break
    if chunk < S:
        outs, auxes = [], []
        for xc in x.reshape(S // chunk, 1, chunk, D).unbind(0):
            o, a = moe_block(p, xc, num_experts=num_experts, top_k=top_k,
                             capacity_factor=capacity_factor, dropless=dropless,
                             chunk_tokens=chunk_tokens, sequential=sequential)
            outs.append(o)
            auxes.append(a)
        return torch.stack(outs).reshape(B, T, D), torch.stack(auxes).mean()
    xf = x.reshape(S, D)
    cap = capacity_of(S, num_experts=num_experts, top_k=top_k,
                      capacity_factor=capacity_factor, dropless=dropless)
    probs, gate, r = route(p, xf, num_experts=num_experts, top_k=top_k, capacity=cap)
    expert_out = experts(p, MoEDispatch.apply(xf, r))
    # The gates are rounded to x's dtype before they weight the rows, as the
    # reference multiplies disp by gate_vals.astype(x.dtype).
    out = MoECombine.apply(expert_out, gate.to(xf.dtype), r)
    # Load-balance auxiliary loss (Switch eq. 4), top-1 token fractions.
    frac_tokens = F.one_hot(r.gate_idx[:, 0], num_experts).to(torch.float32).mean(0)
    aux = num_experts * torch.sum(frac_tokens * probs.mean(0))
    return out.reshape(B, T, D), aux

