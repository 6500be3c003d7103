"""Synthetic datasets, the paper's Dirichlet partitioner and the LM token
stream (numpy copies)."""
from repro_torch.data.lm import lm_batches, make_lm_tokens
from repro_torch.data.partition import partition
from repro_torch.data.synthetic import Dataset, make_classification, train_test_split

__all__ = ["Dataset", "lm_batches", "make_classification", "make_lm_tokens", "partition",
           "train_test_split"]
