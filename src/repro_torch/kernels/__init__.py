"""Hand-written Hopper kernels of the port, each beside its plain torch
version (``ref.py``).  A wrapper launches its CUDA kernel for CUDA tensors
and runs the plain version for CPU tensors; sources live in ``csrc/`` and
are built by :mod:`repro_torch.kernels._build` on first use.

Training: RMSNorm, flash attention, WKV6 and the RG-LRU scan have backward
kernels of their own (``csrc/{rmsnorm,flash_attention,wkv6,rglru_scan}_bwd.cu``)
and the grouped matmul runs its forward kernels on the transposed
products, each reached through a ``torch.autograd.Function`` where grad
is enabled and an operand requires grad.  The GEMM wrapper has none and
raises in that case on CUDA tensors
(:func:`~repro_torch.kernels._build.refuse_grad`); its plain version
differentiates on CPU tensors."""
