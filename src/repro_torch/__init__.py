"""PyTorch/CUDA port of the MTGC hierarchical-FL system (``src/repro``).

The port mirrors the JAX package's layout (``core/``, ``kernels/``,
``models/``, ``data/``, ``api.py``) and imports nothing of it. Entry points
run on the CUDA card unless the caller passes ``device="cpu"``.
"""
