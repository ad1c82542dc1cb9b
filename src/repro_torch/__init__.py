"""PyTorch/CUDA port of the ``repro`` package (CPrune), for one NVIDIA H100.

Mirrors the JAX package's module names; imports ``torch`` and never
``jax`` or anything of ``repro``. Entry points run on the card
(``device="cuda"``) unless the caller asks for ``device="cpu"``, which
runs every kernel's plain PyTorch version.
"""
