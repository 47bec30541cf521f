"""Plain torch version of the fused RMSNorm kernel."""

from typing import Optional

import torch


def rmsnorm_ref(x: torch.Tensor, g: Optional[torch.Tensor] = None,
                eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    y = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    if g is not None:
        y = y * g.float()
    return y.to(x.dtype)
