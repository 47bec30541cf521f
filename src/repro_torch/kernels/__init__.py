"""Hand-written Hopper kernels of the port, each beside its plain torch
version (``ref.py``).  A wrapper launches its CUDA kernel for CUDA tensors
and runs the plain version for CPU tensors; sources live in ``csrc/`` and
are built by :mod:`repro_torch.kernels._build` on first use."""
