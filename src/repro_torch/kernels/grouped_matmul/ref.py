"""Plain torch versions of the grouped (per-expert) matmul kernel and of
its backward."""

from typing import Tuple

import torch


def grouped_matmul_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (E, C, D) expert-dispatched tokens; w: (E, D, F) -> (E, C, F)."""
    return torch.einsum("ecd,edf->ecf", x.float(), w.float()).to(x.dtype)


def grouped_matmul_bwd_ref(x: torch.Tensor, w: torch.Tensor,
                           dy: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The gradients of :func:`grouped_matmul_ref` for the output gradient
    dy (E, C, F): dx[e] = dy[e] w[e]^T in x's dtype and dw[e] = x[e]^T dy[e]
    in w's, fp32 accumulation."""
    dyf = dy.float()
    dx = torch.einsum("ecf,edf->ecd", dyf, w.float()).to(x.dtype)
    dw = torch.einsum("ecd,ecf->edf", x.float(), dyf).to(w.dtype)
    return dx, dw
