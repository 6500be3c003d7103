"""The paper's small models (Sec. 5.1) as functional PyTorch.

Port of ``src/repro/models/small.py`` (``mlp``, ``deep_mlp``, ``cnn``;
``resnet_gn`` and ``lstm`` belong to a later slice). Each factory returns
``(init(generator, device=None) -> params, apply(params, x) -> logits)``;
``init`` puts the params on the CUDA card unless given ``device="cpu"`` (and
raises on a host without a card); it draws the weights from the caller's
CPU generator first, so a seed gives the same weights on both devices. Params
are nested dicts with the reference's leaf names and shapes, so weights
initialized by the JAX package load unchanged (``repro_torch.convert``).
The functions are plain tensor code, so the engine can ``torch.func.vmap``
them over the ``[G, K]`` client axes with per-client weights.

Layouts follow the reference: the CNN takes NHWC images and keeps HWIO
convolution weights; ``apply`` permutes to PyTorch's NCHW / OIHW around
each convolution and back to NHWC before the flatten, so ``f1``'s rows see
features in the reference's order.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.device import resolve_device

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


def _apply_conv(p, x):
    """SAME 5x5 (or any odd k) stride-1 convolution, NCHW activations,
    HWIO weight leaf."""
    k = p["w"].shape[0]
    return F.conv2d(x, p["w"].permute(3, 2, 0, 1), p["b"], padding=k // 2)


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


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, labels.long()[..., None]).mean()


def make_loss(apply: Apply) -> Callable[[dict, dict], torch.Tensor]:
    """Standard classification loss over ``{'x', 'y'}`` batches."""

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
