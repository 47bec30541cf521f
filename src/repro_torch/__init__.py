"""MATCHA in PyTorch for NVIDIA Hopper.

The compiler half (graph IR, tiling CP, scheduler, deployment sessions,
plan analyzer, serving engine) is framework-free and kept as copies of the
JAX package's modules; the numeric runtime (``core/runtime.py``) is
written in torch, and its GEMMs and RMSNorm run through hand-written CUDA
kernels (``kernels/``, sources in ``csrc/``).  This package imports
nothing of JAX or of the JAX package.
"""
