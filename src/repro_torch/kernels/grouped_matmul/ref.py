"""Plain torch version of the grouped (per-expert) matmul kernel."""

import torch


def grouped_matmul_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (E, C, D) expert-dispatched tokens; w: (E, D, F) -> (E, C, F)."""
    return torch.einsum("ecd,edf->ecf", x.float(), w.float()).to(x.dtype)
