"""Synthetic data standing in for CIFAR-10, EMNIST and Shakespeare.

A copy of ``src/repro/data/synthetic.py`` (numpy only): the port imports
nothing of the JAX package, and the same numpy generator gives both
packages the same arrays.

* ``make_classification``: a Gaussian mixture over class prototypes;
  ``image_shape=(H, W, C)`` reshapes features into NHWC images so the CNN
  and the ResNet run real convolutions.
* ``make_feature_shift``: App. C's feature shift, a per-group rotation.
* ``make_language``: an order-1 Markov token stream per latent style
  (Shakespeare's characters), styles standing in for labels.
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


def make_feature_shift(ds: Dataset, rotations: np.ndarray, assignment: np.ndarray) -> Dataset:
    """Paper App. C feature shift: rotate the first two feature coordinates
    of each sample by its group's angle (a cheap proxy for image rotation).
    ``rotations[g]`` in degrees, ``assignment[n]`` = group of sample n."""
    x = ds.x.reshape(ds.x.shape[0], -1).copy()
    for g in np.unique(assignment):
        theta = np.deg2rad(rotations[g])
        c, s = np.cos(theta), np.sin(theta)
        sel = assignment == g
        x0, x1 = x[sel, 0].copy(), x[sel, 1].copy()
        x[sel, 0] = c * x0 - s * x1
        x[sel, 1] = s * x0 + c * x1
    return Dataset(x=x.reshape(ds.x.shape), y=ds.y, num_classes=ds.num_classes)


def make_language(
    rng: np.random.Generator,
    num_styles: int = 10,
    vocab: int = 64,
    samples_per_style: int = 300,
    seq_len: int = 80,
) -> tuple[Dataset, np.ndarray]:
    """Markov "Shakespeare": per-style sparse transition matrices -> token
    sequences, drawn token by token.

    Returns (dataset of [n, seq_len] int32 sequences with next-token targets
    [n, seq_len], style_of_sample[n]); styles play the role of labels for
    partitioning.
    """
    n_all = num_styles * samples_per_style
    x = np.zeros((n_all, seq_len), np.int32)
    styles = np.zeros((n_all,), np.int32)
    for s in range(num_styles):
        trans = rng.dirichlet(0.1 * np.ones(vocab), size=vocab).astype(np.float64)
        for i in range(samples_per_style):
            n = s * samples_per_style + i
            styles[n] = s
            tok = rng.integers(0, vocab)
            for t in range(seq_len):
                x[n, t] = tok
                tok = rng.choice(vocab, p=trans[tok])
    y = np.roll(x, -1, axis=1)       # next-token targets; the last repeats
    y[:, -1] = x[:, -1]
    return Dataset(x=x, y=y, num_classes=vocab), styles


def train_test_split(ds: Dataset, rng: np.random.Generator, test_frac: float = 0.2):
    n = ds.x.shape[0]
    perm = rng.permutation(n)
    k = int(n * (1 - test_frac))
    tr, te = perm[:k], perm[k:]
    return (
        Dataset(ds.x[tr], ds.y[tr], ds.num_classes),
        Dataset(ds.x[te], ds.y[te], ds.num_classes),
    )
