"""Synthetic classification data standing in for CIFAR-10 and friends.

A copy of ``make_classification`` and ``train_test_split`` from
``src/repro/data/synthetic.py`` (numpy only): the port imports nothing of
the JAX package, and the same numpy generator gives both packages the same
arrays. Class prototypes form a Gaussian mixture; ``image_shape=(H, W, C)``
reshapes features into NHWC images so the CNN runs real convolutions.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np


class Dataset(NamedTuple):
    x: np.ndarray        # [n, ...] features (float32) or tokens (int32)
    y: np.ndarray        # [n] int labels (classification) or next-tokens
    num_classes: int


def make_classification(
    rng: np.random.Generator,
    num_samples: int = 20000,
    num_classes: int = 10,
    dim: int = 64,
    noise: float = 1.0,
    image_shape: tuple | None = None,
) -> Dataset:
    """Gaussian mixture classification data.

    ``image_shape=(H, W, C)`` reshapes features into images (H*W*C == dim).
    """
    protos = rng.normal(size=(num_classes, dim)).astype(np.float32)
    protos *= 2.0 / np.sqrt(dim) ** 0.5
    y = rng.integers(0, num_classes, size=(num_samples,))
    x = protos[y] + noise * rng.normal(size=(num_samples, dim)).astype(np.float32)
    x = x.astype(np.float32)
    if image_shape is not None:
        h, w, c = image_shape
        if h * w * c != dim:
            raise ValueError(f"image_shape {image_shape} does not hold dim={dim}")
        x = x.reshape(num_samples, h, w, c)
    return Dataset(x=x, y=y.astype(np.int32), num_classes=num_classes)


def train_test_split(ds: Dataset, rng: np.random.Generator, test_frac: float = 0.2):
    n = ds.x.shape[0]
    perm = rng.permutation(n)
    k = int(n * (1 - test_frac))
    tr, te = perm[:k], perm[k:]
    return (
        Dataset(ds.x[tr], ds.y[tr], ds.num_classes),
        Dataset(ds.x[te], ds.y[te], ds.num_classes),
    )
