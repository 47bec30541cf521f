"""Plain torch version of the WKV6 (RWKV6 / Finch) recurrence kernel.

Per head with head width D, the state S in R^{DxD} (key x value):

    y_t[j]   = sum_i r_t[i] * ( S_{t-1}[i,j] + u[i] * k_t[i] * v_t[j] )
    S_t[i,:] = w_t[i] * S_{t-1}[i,:] + k_t[i] * v_t[:]

with the data-dependent per-channel decay w_t in (0,1) and the per-head
bonus u: the exact recurrence, a loop over time in fp32.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def wkv6_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             w: torch.Tensor, u: torch.Tensor,
             state: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r,k,v,w: (B,T,H,D); u: (H,D).  Returns (y (B,T,H,D) in r's dtype,
    S (B,H,D,D) in fp32)."""
    B, T, H, D = r.shape
    rf, kf, vf, wf = (x.float() for x in (r, k, v, w))
    uf = u.float()
    S = (torch.zeros((B, H, D, D), dtype=torch.float32, device=r.device)
         if state is None else state.float())
    ys = []
    for t in range(T):
        rt, kt, vt, wt = rf[:, t], kf[:, t], vf[:, t], wf[:, t]
        kv = kt[..., :, None] * vt[..., None, :]             # (B,H,D,D)
        ys.append(torch.einsum("bhi,bhij->bhj", rt, S)
                  + torch.einsum("bhi,bhi,bhj->bhj", rt, uf[None] * kt, vt))
        S = wt[..., :, None] * S + kv
    y = (torch.stack(ys, 1) if ys else
         torch.zeros((B, 0, H, D), dtype=torch.float32, device=r.device))
    return y.to(r.dtype), S
