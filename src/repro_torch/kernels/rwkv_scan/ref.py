"""Plain torch version of the WKV6 (RWKV6 / Finch) recurrence kernel.

Per head with head width D, the state S in R^{DxD} (key x value):

    y_t[j]   = sum_i r_t[i] * ( S_{t-1}[i,j] + u[i] * k_t[i] * v_t[j] )
    S_t[i,:] = w_t[i] * S_{t-1}[i,:] + k_t[i] * v_t[:]

with the data-dependent per-channel decay w_t in (0,1) and the per-head
bonus u: the exact recurrence, a loop over time in fp32; and its
backward, :func:`wkv6_bwd_ref`.
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


def wkv6_bwd_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 w: torch.Tensor, u: torch.Tensor,
                 dy: Optional[torch.Tensor] = None,
                 ds: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, ...]:
    """The gradients (dr, dk, dv, dw, du) of :func:`wkv6_ref` (zero initial
    state) for the output gradients dy (B,T,H,D) and ds (B,H,D,D) of the
    final state, each None for zeros; fp32 math.  With G_t = dL/dS_t
    (G_{T-1} = ds) and S_{t-1} the state before step t:

        G_{t-1}  = diag(w_t) G_t + r_t^T dy_t
        dr_t[i]  = sum_j dy_t[j] (S_{t-1}[i,j] + u[i] k_t[i] v_t[j])
        dk_t[i]  = sum_j G_t[i,j] v_t[j] + u[i] r_t[i] (v_t . dy_t)
        dv_t[j]  = sum_i G_t[i,j] k_t[i] + (sum_i r_t[i] u[i] k_t[i]) dy_t[j]
        dw_t[i]  = sum_j G_t[i,j] S_{t-1}[i,j]
        du[i]    = sum_{b,t} r_t[i] k_t[i] (v_t . dy_t)

    The states S_{t-1} are kept from a forward pass, never rebuilt by
    dividing by w_t.  dr, dk, dv, dw in r's dtype, du in u's."""
    B, T, H, D = r.shape
    rf, kf, vf, wf = (x.float() for x in (r, k, v, w))
    uf = u.float()
    dyf = (torch.zeros_like(rf) if dy is None else dy.float())
    S = torch.zeros((B, H, D, D), dtype=torch.float32, device=r.device)
    before = []
    for t in range(T):
        before.append(S)
        S = wf[:, t, ..., None] * S + kf[:, t, ..., None] * vf[:, t, :, None, :]
    G = (torch.zeros_like(S) if ds is None else ds.float().clone())
    grads = [torch.zeros_like(rf) for _ in range(4)]
    dr, dk, dv, dw = grads
    du = torch.zeros((H, D), dtype=torch.float32, device=r.device)
    for t in reversed(range(T)):
        rt, kt, vt, wt, dyt = (x[:, t] for x in (rf, kf, vf, wf, dyf))
        vdy = (vt * dyt).sum(-1, keepdim=True)               # (B,H,1)
        dr[:, t] = (torch.einsum("bhij,bhj->bhi", before[t], dyt)
                    + uf * kt * vdy)
        dk[:, t] = torch.einsum("bhij,bhj->bhi", G, vt) + uf * rt * vdy
        dv[:, t] = (torch.einsum("bhij,bhi->bhj", G, kt)
                    + (rt * uf * kt).sum(-1, keepdim=True) * dyt)
        dw[:, t] = (G * before[t]).sum(-1)
        du += (rt * kt * vdy).sum(0)
        G = wt[..., None] * G + rt[..., None] * dyt[..., None, :]
    return (*(g.to(r.dtype) for g in grads), du.to(u.dtype))
