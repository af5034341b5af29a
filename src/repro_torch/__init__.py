"""PyTorch port of the repro serving stack for NVIDIA Hopper.

The JAX package (``repro``) is the reference; this package mirrors its
layout (``configs``, ``kernels/<op>``, ``models``, ``serving``,
``launch``) and imports nothing from it. Entry points run on CUDA unless
the caller passes ``device="cpu"``, where every kernel op runs its plain
PyTorch version.
"""
