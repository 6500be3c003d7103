"""The paper's small models as functional PyTorch."""
