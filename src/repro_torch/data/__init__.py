"""Synthetic datasets and the paper's Dirichlet partitioner (numpy copies)."""
from repro_torch.data.partition import partition
from repro_torch.data.synthetic import Dataset, make_classification, train_test_split

__all__ = ["Dataset", "make_classification", "partition", "train_test_split"]
