"""Token-stream pipeline for LM training (numpy copy of ``src/repro/data/lm.py``,
draw for draw).

Generates a deterministic pseudo-corpus (a mixture of per-domain unigram
generators) and samples fixed-length training sequences from it. Domains
play the role of data heterogeneity for hierarchical training.
"""
from __future__ import annotations

import numpy as np


def make_lm_tokens(
    rng: np.random.Generator,
    vocab: int,
    num_tokens: int,
    num_domains: int = 8,
) -> tuple[np.ndarray, np.ndarray]:
    """Returns (tokens[num_tokens] int32, domain_of_token[num_tokens])."""
    protos = rng.dirichlet(0.05 * np.ones(vocab), size=num_domains)
    toks = np.zeros(num_tokens, np.int32)
    doms = np.zeros(num_tokens, np.int32)
    chunk = 2048
    pos = 0
    while pos < num_tokens:
        d = rng.integers(0, num_domains)
        n = min(chunk, num_tokens - pos)
        toks[pos : pos + n] = rng.choice(vocab, size=n, p=protos[d])
        doms[pos : pos + n] = d
        pos += n
    return toks, doms


def lm_batches(
    tokens: np.ndarray,
    rng: np.random.Generator,
    shape: tuple,
    seq_len: int,
):
    """Sample next-token-prediction batches: dict(tokens, targets) of shape
    ``shape + (seq_len,)``, e.g. shape (E, H, G, K, B)."""
    n_seq = int(np.prod(shape))
    starts = rng.integers(0, len(tokens) - seq_len - 1, size=n_seq)
    x = np.stack([tokens[s : s + seq_len] for s in starts]).reshape(shape + (seq_len,))
    y = np.stack([tokens[s + 1 : s + seq_len + 1] for s in starts]).reshape(shape + (seq_len,))
    return {"tokens": x.astype(np.int32), "targets": y.astype(np.int32)}
