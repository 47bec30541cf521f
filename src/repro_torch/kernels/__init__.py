"""Hand-written Hopper kernels of the port, each beside its plain torch
version (``ref.py``).  A wrapper launches its CUDA kernel for CUDA tensors
and runs the plain version for CPU tensors; sources live in ``csrc/`` and
are built by :mod:`repro_torch.kernels._build` on first use.

Training: RMSNorm and flash attention have backward kernels of their own
(``csrc/rmsnorm_bwd.cu``, ``csrc/flash_attention_bwd.cu``), reached
through a ``torch.autograd.Function`` where grad is enabled and an operand
requires grad.  The GEMM, WKV6, RG-LRU and grouped-matmul wrappers have
none yet and raise in that case on CUDA tensors
(:func:`~repro_torch.kernels._build.refuse_grad`); their plain versions
differentiate on CPU tensors."""
