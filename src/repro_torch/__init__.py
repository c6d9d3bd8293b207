"""PyTorch/CUDA port of the first-layer-precompute serving stack.

A second package beside the JAX reference (``repro``): it imports ``torch``
and numpy, never ``jax`` and nothing of ``repro``. Entry points take an
explicit ``device`` (default ``'cuda'``); on a CUDA device every ported TPU
kernel runs as a hand-written Hopper kernel (``kernels/``, sources in
``csrc/``), on a CPU device the kernels' plain PyTorch versions run instead.
"""
