"""Plain torch version of the RG-LRU scan kernel: the diagonal linear
recurrence of Griffin / RecurrentGemma, ``h_t = a_t * h_{t-1} + b_t``
(elementwise, per channel), a loop over time in fp32; and its backward,
:func:`rglru_bwd_ref`."""

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


def rglru_bwd_ref(a: torch.Tensor, b: torch.Tensor,
                  dh: Optional[torch.Tensor] = None,
                  dh_last: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The gradients (da, db) of :func:`rglru_ref` (zero initial state) for
    the output gradients dh (B,T,D) and dh_last (B,D) of h_T, each None for
    zeros; fp32 math, h_{t-1} in fp32 as the forward computes it.  The
    reverse scan g_t = dh_t + a_{t+1} g_{t+1} (the last step's g adds
    dh_last) gives da_t = g_t h_{t-1} and db_t = g_t, in a's dtype."""
    B, T, D = a.shape
    af, bf = a.float(), b.float()
    h = torch.zeros((B, D), dtype=torch.float32, device=a.device)
    before = []
    for t in range(T):
        before.append(h)
        h = af[:, t] * h + bf[:, t]
    dhf = torch.zeros_like(af) if dh is None else dh.float()
    carry = (torch.zeros_like(h) if dh_last is None else dh_last.float())
    da, db = torch.zeros_like(af), torch.zeros_like(af)
    for t in reversed(range(T)):
        g = dhf[:, t] + carry
        db[:, t] = g
        da[:, t] = g * before[t]
        carry = af[:, t] * g
    return da.to(a.dtype), db.to(a.dtype)
