"""CHAMB-GA in PyTorch: the island-model NSGA-II GA of ``repro`` (the JAX
reference package), ported to PyTorch and CUDA for NVIDIA Hopper.

``src/repro_torch/<path>`` is the port of ``src/repro/<path>`` and keeps its
public names. The package imports torch and numpy, never jax and nothing of
``repro``. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; they raise when no GPU is present and CPU was not asked
for.

Importing this package imports nothing heavy: submodules import torch, and
the CUDA kernels are compiled and loaded at their first launch.
"""
