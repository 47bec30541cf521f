"""Plain torch versions of the fused RMSNorm kernel and of its backward."""

from typing import Optional, Tuple

import torch


def rmsnorm_ref(x: torch.Tensor, g: Optional[torch.Tensor] = None,
                eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    y = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    if g is not None:
        y = y * g.float()
    return y.to(x.dtype)


def rmsnorm_bwd_ref(x: torch.Tensor, g: Optional[torch.Tensor],
                    dy: torch.Tensor, eps: float = 1e-6
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The gradients (dx, dg) of :func:`rmsnorm_ref` at ``x``, ``g`` for the
    output gradient ``dy``, in fp32 math: with r = rsqrt(mean(x^2) + eps),
    dx = r (dy g) - x r^3 mean(dy g x) per row and dg = sum over rows of
    dy x r; dx in x's dtype, dg in g's (None without a gain)."""
    xf = x.float()
    dyf = dy.float()
    r = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    dyg = dyf if g is None else dyf * g.float()
    dx = r * dyg - xf * r ** 3 * (dyg * xf).mean(dim=-1, keepdim=True)
    dg = None
    if g is not None:
        dg = (dyf * xf * r).reshape(-1, x.shape[-1]).sum(0).to(g.dtype)
    return dx.to(x.dtype), dg
