"""Plain torch version of the RG-LRU scan kernel: the diagonal linear
recurrence of Griffin / RecurrentGemma, ``h_t = a_t * h_{t-1} + b_t``
(elementwise, per channel), a loop over time in fp32."""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def rglru_ref(a: torch.Tensor, b: torch.Tensor,
              h0: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """a, b: (B,T,D) -> (h (B,T,D) in a's dtype, h_T (B,D) in fp32)."""
    B, T, D = a.shape
    af, bf = a.float(), b.float()
    h = (torch.zeros((B, D), dtype=torch.float32, device=a.device)
         if h0 is None else h0.float())
    hs = []
    for t in range(T):
        h = af[:, t] * h + bf[:, t]
        hs.append(h)
    out = (torch.stack(hs, 1) if hs else
           torch.zeros((B, 0, D), dtype=torch.float32, device=a.device))
    return out.to(a.dtype), h
