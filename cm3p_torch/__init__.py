"""CM3P in PyTorch for NVIDIA Hopper: the port of the JAX package.

Imports torch and never JAX; kernels live in ``csrc/`` and build with nvcc
on first use. See ``inference.py`` for the entry points.
"""
