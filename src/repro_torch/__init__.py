"""PyTorch / CUDA port of the CHAMP system (``repro``), for an NVIDIA H100.

Mirrors ``repro``'s module tree.  It imports ``torch`` and numpy and never
``jax`` or ``repro``; the JAX package is the reference it is held against in
the tests.
"""
