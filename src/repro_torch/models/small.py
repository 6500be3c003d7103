"""The paper's small models (Sec. 5.1) as functional PyTorch.

Port of ``src/repro/models/small.py``: ``mlp``, ``deep_mlp``, ``cnn``,
``resnet_gn`` (GroupNorm in place of BatchNorm, CIFAR-100) and ``lstm``
(char-level, Shakespeare). Each factory returns
``(init(generator, device=None) -> params, apply(params, x) -> logits)``;
``init`` puts the params on the CUDA card unless given ``device="cpu"`` (and
raises on a host without a card); it draws the weights from the caller's
CPU generator first, so a seed gives the same weights on both devices. Params
are nested dicts with the reference's leaf names and shapes, so weights
initialized by the JAX package load unchanged (``repro_torch.convert``).
The functions are plain tensor code, so the engine can ``torch.func.vmap``
them over the ``[G, K]`` client axes with per-client weights.

Layouts follow the reference: the CNN and the ResNet take NHWC images and
keep HWIO convolution weights; ``apply`` permutes to PyTorch's NCHW / OIHW
around the convolutions and back to NHWC before the CNN's flatten, so
``f1``'s rows see features in the reference's order. Convolutions pad as
XLA's ``padding="SAME"`` does, at any stride.
"""
from __future__ import annotations

import math
from typing import Callable, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.device import resolve_device
from repro_torch.core.tree import tree_leaves

Init = Callable[..., dict]
Apply = Callable[[dict, torch.Tensor], torch.Tensor]


def _normal(gen: torch.Generator, shape, scale: float, device) -> torch.Tensor:
    w = torch.randn(shape, generator=gen, dtype=torch.float32) * scale
    return w.to(device)


def _dense(gen, n_in, n_out, device, scale=None):
    scale = scale if scale is not None else (2.0 / n_in) ** 0.5
    return {"w": _normal(gen, (n_in, n_out), scale, device),
            "b": torch.zeros((n_out,), dtype=torch.float32, device=device)}


def _conv(gen, kh, kw, cin, cout, device):
    scale = (2.0 / (kh * kw * cin)) ** 0.5
    return {"w": _normal(gen, (kh, kw, cin, cout), scale, device),
            "b": torch.zeros((cout,), dtype=torch.float32, device=device)}


def _linear(p, x):
    return x @ p["w"] + p["b"]


def mlp(num_classes: int, input_dim: int, hidden: int = 200) -> Tuple[Init, Apply]:
    """2 hidden ReLU layers + linear head (EMNIST-L / Fashion-MNIST)."""

    def init(gen: torch.Generator, device=None):
        device = resolve_device(device)
        return {
            "l1": _dense(gen, input_dim, hidden, device),
            "l2": _dense(gen, hidden, hidden, device),
            "out": _dense(gen, hidden, num_classes, device),
        }

    def apply(p, x):
        x = x.reshape(x.shape[0], -1)
        x = torch.relu(_linear(p["l1"], x))
        x = torch.relu(_linear(p["l2"], x))
        return _linear(p["out"], x)

    return init, apply


def deep_mlp(num_classes: int, input_dim: int, hidden: int = 32,
             depth: int = 48) -> Tuple[Init, Apply]:
    """Deep, narrow MLP: ``depth`` hidden layers of ``hidden`` units (the
    leaf-rich stress model for the round engines)."""

    def init(gen: torch.Generator, device=None):
        device = resolve_device(device)
        p = {"in": _dense(gen, input_dim, hidden, device)}
        for i in range(depth):
            p[f"h{i:03d}"] = _dense(gen, hidden, hidden, device)
        p["out"] = _dense(gen, hidden, num_classes, device)
        return p

    def apply(p, x):
        x = x.reshape(x.shape[0], -1)
        x = torch.relu(_linear(p["in"], x))
        for i in range(depth):
            x = torch.relu(_linear(p[f"h{i:03d}"], x))
        return _linear(p["out"], x)

    return init, apply


def _same_pads(n: int, k: int, stride: int) -> tuple[int, int]:
    """XLA's SAME padding of one spatial axis: ``ceil(n / stride)`` outputs,
    the odd pixel of the total on the far side."""
    total = max((-(-n // stride) - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def _apply_conv(p, x, stride: int = 1):
    """SAME convolution at ``stride``, NCHW activations, HWIO weight leaf.

    At stride 2 on an even size SAME pads ``(0, 1)``: only the bottom and
    right. ``F.conv2d``'s ``padding`` pads both sides alike, so an uneven
    pad goes through ``F.pad`` first."""
    kh, kw = p["w"].shape[:2]
    (top, bottom), (left, right) = (_same_pads(n, k, stride)
                                    for n, k in zip(x.shape[-2:], (kh, kw)))
    w = p["w"].permute(3, 2, 0, 1)
    if top == bottom and left == right:
        return F.conv2d(x, w, p["b"], stride, padding=(top, left))
    return F.conv2d(F.pad(x, (left, right, top, bottom)), w, p["b"], stride)


def cnn(num_classes: int, image_shape=(8, 8, 1)) -> Tuple[Init, Apply]:
    """McMahan-style CNN: conv5x32 - pool - conv5x64 - pool - fc512 - fc."""
    h, w, c = image_shape

    def init(gen: torch.Generator, device=None):
        device = resolve_device(device)
        flat = (h // 4) * (w // 4) * 64
        return {
            "c1": _conv(gen, 5, 5, c, 32, device),
            "c2": _conv(gen, 5, 5, 32, 64, device),
            "f1": _dense(gen, flat, 512, device),
            "out": _dense(gen, 512, num_classes, device),
        }

    def apply(p, x):
        x = x.reshape(x.shape[0], h, w, c).permute(0, 3, 1, 2)   # NHWC -> NCHW
        x = F.max_pool2d(torch.relu(_apply_conv(p["c1"], x)), 2, 2)
        x = F.max_pool2d(torch.relu(_apply_conv(p["c2"], x)), 2, 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)         # back to NHWC order
        x = torch.relu(_linear(p["f1"], x))
        return _linear(p["out"], x)

    return init, apply


def _groupnorm(p, x, groups: int):
    """GroupNorm over ``min(groups, c)`` groups of consecutive channels of
    NCHW ``x``: the biased variance, eps 1e-5 inside the rsqrt."""
    n, c, h, w = x.shape
    g = min(groups, c)
    xg = x.reshape(n, g, c // g, h, w)
    mu = xg.mean(dim=(2, 3, 4), keepdim=True)
    var = ((xg - mu) ** 2).mean(dim=(2, 3, 4), keepdim=True)
    xg = (xg - mu) * torch.rsqrt(var + 1e-5)
    return xg.reshape(n, c, h, w) * p["scale"][:, None, None] + p["bias"][:, None, None]


def _gn_params(c, device):
    return {"scale": torch.ones((c,), dtype=torch.float32, device=device),
            "bias": torch.zeros((c,), dtype=torch.float32, device=device)}


def resnet_gn(
    num_classes: int,
    image_shape=(8, 8, 3),
    widths=(16, 32, 64),
    blocks_per_stage: int = 2,
    gn_groups: int = 8,
) -> Tuple[Init, Apply]:
    """ResNet with GroupNorm (the paper's CIFAR-100 model modulo width and
    depth): a 3x3 stem, ``blocks_per_stage`` basic blocks a stage, the first
    block of every stage after the first at stride 2 (a 1x1 projection on
    its shortcut where the width changes, else a ``[::2, ::2]``
    subsample), a global mean pool and a linear head."""
    h, w, c = image_shape

    def init(gen: torch.Generator, device=None):
        device = resolve_device(device)
        p = {"stem": _conv(gen, 3, 3, c, widths[0], device),
             "stem_gn": _gn_params(widths[0], device)}
        cin = widths[0]
        for s, width in enumerate(widths):
            for b in range(blocks_per_stage):
                blk = {"c1": _conv(gen, 3, 3, cin, width, device),
                       "gn1": _gn_params(width, device),
                       "c2": _conv(gen, 3, 3, width, width, device),
                       "gn2": _gn_params(width, device)}
                if cin != width:
                    blk["proj"] = _conv(gen, 1, 1, cin, width, device)
                p[f"s{s}b{b}"] = blk
                cin = width
        p["out"] = _dense(gen, cin, num_classes, device)
        return p

    def apply(p, x):
        x = x.reshape(x.shape[0], h, w, c).permute(0, 3, 1, 2)   # NHWC -> NCHW
        x = torch.relu(_groupnorm(p["stem_gn"], _apply_conv(p["stem"], x), gn_groups))
        for s in range(len(widths)):
            for b in range(blocks_per_stage):
                blk = p[f"s{s}b{b}"]
                stride = 2 if (b == 0 and s > 0) else 1
                y = torch.relu(_groupnorm(blk["gn1"], _apply_conv(blk["c1"], x, stride),
                                          gn_groups))
                y = _groupnorm(blk["gn2"], _apply_conv(blk["c2"], y), gn_groups)
                if "proj" in blk:
                    sc = _apply_conv(blk["proj"], x, stride)
                else:
                    sc = x[:, :, ::stride, ::stride]
                x = torch.relu(y + sc)
        return _linear(p["out"], x.mean(dim=(2, 3)))

    return init, apply


def lstm(vocab: int, hidden: int = 128, embed: int = 32) -> Tuple[Init, Apply]:
    """Char-LSTM for next-token prediction (the paper's Shakespeare model):
    ``apply(p, tokens [B, T]) -> logits [B, T, vocab]``, gates split i, f,
    g, o with +1 on the forget gate, h and c starting at zero."""

    def init(gen: torch.Generator, device=None):
        device = resolve_device(device)
        return {
            "emb": _normal(gen, (vocab, embed), 0.02, device),
            "wx": _dense(gen, embed, 4 * hidden, device),
            "wh": _dense(gen, hidden, 4 * hidden, device, scale=(1.0 / hidden) ** 0.5),
            "out": _dense(gen, hidden, vocab, device),
        }

    def apply(p, x):
        e = F.embedding(x.long(), p["emb"])            # [B, T, E]
        # A float32 carry (the reference's), float64 with float64 params.
        h = torch.zeros((x.shape[0], p["wh"]["w"].shape[0]), device=e.device,
                        dtype=torch.promote_types(torch.float32, e.dtype))
        c = torch.zeros_like(h)
        hs = []
        for t in range(x.shape[1]):
            gates = (e[:, t] @ p["wx"]["w"] + p["wx"]["b"] + h @ p["wh"]["w"]
                     + p["wh"]["b"])
            i, f, g, o = gates.chunk(4, dim=-1)
            c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            hs.append(h)
        return _linear(p["out"], torch.stack(hs, dim=1))   # [B, T, vocab]

    return init, apply


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, labels.long()[..., None]).mean()


def make_loss(apply: Apply) -> Callable[[dict, dict], torch.Tensor]:
    """Standard classification / next-token loss over ``{'x', 'y'}``
    batches (the mean over every label)."""

    def loss(params, batch):
        return softmax_xent(apply(params, batch["x"]), batch["y"])

    return loss


def make_accuracy(apply: Apply, x: torch.Tensor, y: torch.Tensor):
    """``params -> scalar tensor`` accuracy over the full ``(x, y)`` set in
    one forward pass (the counterpart of the reference's ``jit_accuracy``);
    the result stays on the device, so an eval inside a horizon does not
    synchronize."""

    def acc(params) -> torch.Tensor:
        with torch.no_grad():
            pred = torch.argmax(apply(params, x), dim=-1)
            return torch.mean((pred == y).to(torch.float32))

    return acc


def accuracy(apply: Apply, params, x, y, batch: int = 512) -> float:
    """Streaming eval accuracy over ``(x, y)`` (tensors or numpy arrays) in
    batches of ``batch``, each moved to the params' device: a Python float,
    the share of labels the argmax hits."""
    dev = tree_leaves(params)[0].device
    correct = 0
    with torch.no_grad():
        for i in range(0, x.shape[0], batch):
            pred = torch.argmax(apply(params, torch.as_tensor(x[i:i + batch]).to(dev)), dim=-1)
            correct += int((pred == torch.as_tensor(y[i:i + batch]).to(dev)).sum())
    return correct / math.prod(y.shape)
