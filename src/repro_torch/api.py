"""``repro_torch.api`` -- the port's experiment surface (see
:mod:`repro_torch.core.api`)::

    from repro_torch import api
    engine = api.build(api.ExperimentSpec(levels=(4, 5)), loss_fn)
    state, horizon = api.fit(engine, data, T=30, params=params)
"""
from repro_torch.core.api import *  # noqa: F401,F403
from repro_torch.core.api import __all__  # noqa: F401
