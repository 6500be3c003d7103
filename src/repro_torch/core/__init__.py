"""repro_torch.core -- the MTGC round engine, its state layouts and driver.

The M-level entry points the reference's ``repro.core`` exports (and
``benchmarks/fig11_three_level.py`` imports) are re-exported here.
"""
from repro_torch.core.multilevel import (
    MultiLevelState,
    make_multilevel_round,
    multilevel_global_model,
    multilevel_init,
)

__all__ = [
    "MultiLevelState",
    "make_multilevel_round",
    "multilevel_global_model",
    "multilevel_init",
]
