"""repro_torch.checkpoint -- step-tagged checkpoints in the reference's format."""
from repro_torch.checkpoint.checkpoint import latest_step, restore, save

__all__ = ["save", "restore", "latest_step"]
