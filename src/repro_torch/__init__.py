"""PyTorch/CUDA port of the ``repro`` package.

Mirrors ``repro``'s module names one to one; imports ``torch`` and never
``jax`` or ``repro``. Entry points run on the CUDA device unless the caller
passes ``device="cpu"``.
"""
