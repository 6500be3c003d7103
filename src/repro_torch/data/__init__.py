"""Synthetic datasets, the paper's Dirichlet partitioner, host batch
sampling and the LM token stream (numpy copies of ``repro.data``)."""
from repro_torch.data.lm import lm_batches, make_lm_tokens
from repro_torch.data.partition import partition, partition_stats, sample_round_batches
from repro_torch.data.synthetic import (
    Dataset,
    make_classification,
    make_feature_shift,
    make_language,
    train_test_split,
)

__all__ = [
    "Dataset",
    "make_classification",
    "make_feature_shift",
    "make_language",
    "train_test_split",
    "partition",
    "partition_stats",
    "sample_round_batches",
    "make_lm_tokens",
    "lm_batches",
]
