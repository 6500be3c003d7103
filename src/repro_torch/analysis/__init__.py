"""The port's static auditor (port of ``src/repro/analysis``): the audited
spec matrix (``specs``), the invariants of a recorded driver chunk
(``invariants``), the generator lint (``keys``) and the cost budgets
(``budgets``, ``budgets.json``); ``python -m repro_torch.launch.audit``
runs them."""
