"""repro_torch.optim -- minimal functional optimizers and learning-rate
schedules (port of ``repro.optim``; the paper uses plain SGD)."""
from repro_torch.optim.optimizers import Optimizer, adamw, sgd
from repro_torch.optim.schedule import constant, cosine, linear_warmup_cosine

__all__ = ["Optimizer", "sgd", "adamw", "constant", "cosine", "linear_warmup_cosine"]
