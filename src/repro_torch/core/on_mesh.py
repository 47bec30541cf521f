"""The kernels on a device mesh: each kernel's call on DTensors, through
``local_map``.

The kernels' wrappers read ``data_ptr()``, so no DTensor may reach them.
Each function here takes the model's operands; on plain tensors it calls
the wrapper as it is (the one-device path does not change), and on
DTensors it enters the wrapper through
``torch.distributed.tensor.experimental.local_map``: the operands are
first redistributed to a layout the kernel can run on each rank's shards
alone, mesh dim by mesh dim (a Partial operand is reduced; a dim the
kernel reads whole, such as the sequence, is gathered), the wrapper runs
on the local shards, and the outputs come back as DTensors.  The
gradient of an operand that a mesh dim does not shard while it shards
another operand (RMSNorm's gain over data-sharded rows, a replicated KV
head, a replicated expert weight over data-sharded tokens) is
``Partial`` on that dim: each rank's backward adds its own part.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention import flash_attention as _fa
from repro_torch.kernels.grouped_matmul import grouped_matmul as _gmm
from repro_torch.kernels.rglru_scan import rglru_scan as _rglru
from repro_torch.kernels.rmsnorm import rmsnorm as _rms
from repro_torch.kernels.rwkv_scan import rwkv_scan as _wkv


def on_mesh(x) -> bool:
    """Whether ``x`` is a DTensor (a plain tensor answers at once: this
    runs before every kernel call of the one-device path)."""
    if type(x) is torch.Tensor:
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _shard_dim(p, ndim: int) -> Optional[int]:
    """The tensor dim a Shard placement splits (non-negative), else None."""
    if p.is_shard():
        return p.dim % ndim
    return None


class _DenseGrad(torch.autograd.Function):
    """The identity, whose backward hands on its gradient contiguous.  A
    kernel's plain version can give a gradient as a strided view of a
    larger result; leaving ``local_map`` as a DTensor's local shard, such a
    view breaks the ``view`` that DTensor takes a reshape's backward for
    (it judges contiguity by the global tensor)."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def _dense_grads(fn):
    def local(*args):
        return fn(*(_DenseGrad.apply(a) if isinstance(a, torch.Tensor)
                    and a.requires_grad else a for a in args))
    return local


def _call(fn, args, in_pl, out_pl, grad_pl):
    """``fn`` on the local shards of ``args`` laid out as ``in_pl`` (one
    placement tuple an argument, None for a non-tensor), its outputs
    wrapped as ``out_pl``; the gradients of the inputs come back as
    ``grad_pl``."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import local_map
    mesh = next(a.device_mesh for a in args if isinstance(a, DTensor))
    moved = []
    for a, p in zip(args, in_pl):
        if p is not None and isinstance(a, DTensor) \
                and tuple(a.placements) != tuple(p):
            a = a.redistribute(mesh, p)
        elif p is not None and not isinstance(a, DTensor):
            a = DTensor.from_local(a, mesh, p, run_check=False)
        moved.append(a)
    # one output's placements go as a list, several outputs' as a tuple
    if out_pl and not isinstance(out_pl[0], (tuple, list)):
        out_pl = list(out_pl)
    return local_map(_dense_grads(fn), out_placements=out_pl,
                     in_placements=tuple(in_pl),
                     in_grad_placements=tuple(grad_pl),
                     device_mesh=mesh)(*moved)


def rmsnorm(x, g=None, eps: float = 1e-6):
    """K2: rows may be sharded on any dim but the last, which is read
    whole."""
    if not on_mesh(x):
        return _rms.rmsnorm(x, g, eps)
    from torch.distributed.tensor import Partial, Replicate
    nd = x.dim()
    px, pg = [], []
    for p in x.placements:
        d = _shard_dim(p, nd)
        keep = d is not None and d != nd - 1
        px.append(p if keep else Replicate())
        pg.append(Partial() if keep else Replicate())
    px, rep = tuple(px), tuple(Replicate() for _ in px)
    if g is None:
        return _call(lambda xl: _rms.rmsnorm(xl, None, eps), (x,), (px,),
                     px, (px,))
    return _call(lambda xl, gl: _rms.rmsnorm(xl, gl, eps), (x, g),
                 (px, rep), px, (px, tuple(pg)))


def flash_attention(q, k, v, causal: bool = True,
                    window: Optional[int] = None):
    """K3: q (B,S,H,Dh), k/v (B,S,KV,Dh) sharded on the batch and on the
    heads (the model axis under head-TP); the sequence and Dh are read
    whole.  Where a mesh dim shards q's heads and the KV heads do not
    divide over it (KV < model_par, as head-TP allows), k and v stay
    replicated there and each rank reads the KV heads of its own query
    heads."""
    if not on_mesh(q):
        return _fa.flash_attention(q, k, v, causal=causal, window=window)
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = q.device_mesh
    H, KV = q.shape[2], k.shape[2]
    pq, pkv, gkv = [], [], []
    sliced = None                        # (mesh dim, its size)
    for j, p in enumerate(q.placements):
        n = mesh.size(j)
        d = _shard_dim(p, 4)
        if d == 0:
            pq.append(Shard(0)), pkv.append(Shard(0)), gkv.append(Shard(0))
        elif d == 2 and KV % n == 0:
            pq.append(Shard(2)), pkv.append(Shard(2)), gkv.append(Shard(2))
        elif d == 2 and H % n == 0 and sliced is None:
            pq.append(Shard(2)), pkv.append(Replicate())
            gkv.append(Partial())
            sliced = (j, n)
        else:
            pq.append(Replicate()), pkv.append(Replicate())
            gkv.append(Replicate())
    pq, pkv, gkv = tuple(pq), tuple(pkv), tuple(gkv)
    rank = mesh.get_local_rank(sliced[0]) if sliced else 0

    def local(ql, kl, vl):
        if sliced is not None:
            group = H // KV                      # query heads a KV head
            h0 = rank * ql.shape[2]
            kv0 = h0 // group
            kv1 = (h0 + ql.shape[2] - 1) // group + 1
            if kv1 - kv0 > 1 and (h0 % group or ql.shape[2]
                                  != (kv1 - kv0) * group):
                raise ValueError(f"{H} query heads over {sliced[1]} ranks "
                                 f"do not align with {KV} KV heads")
            kl, vl = kl[:, :, kv0:kv1], vl[:, :, kv0:kv1]
        return _fa.flash_attention(ql, kl, vl, causal=causal, window=window)

    return _call(local, (q, k, v), (pq, pkv, pkv), pq, (pq, gkv, gkv))


def grouped_matmul(x, w):
    """K6: x (E,C,D) @ w (E,D,F) per expert.  A mesh dim shards the
    experts of both (expert-parallel), or x's rows, or w's columns (its
    output's), or the contraction of both (the output Partial: the
    F-sharded down projection under expert_ffn_tp)."""
    if not on_mesh(x):
        return _gmm.grouped_matmul(x, w)
    from torch.distributed.tensor import Partial, Replicate, Shard
    px, pw, po, gx, gw = [], [], [], [], []
    for a, b in zip(x.placements, w.placements):
        dx, dw = _shard_dim(a, 3), _shard_dim(b, 3)
        if dx == 0 or dw == 0:                    # experts
            cols = (Shard(0),) * 5
        elif dw == 2:                             # w's columns
            cols = (Replicate(), Shard(2), Shard(2), Partial(), Shard(2))
        elif dw == 1 or dx == 2:                  # the contraction
            cols = (Shard(2), Shard(1), Partial(), Shard(2), Shard(1))
        elif dx == 1:                             # x's rows
            cols = (Shard(1), Replicate(), Shard(1), Shard(1), Partial())
        else:
            cols = (Replicate(),) * 5
        for acc, c in zip((px, pw, po, gx, gw), cols):
            acc.append(c)
    return _call(_gmm.grouped_matmul, (x, w), (tuple(px), tuple(pw)),
                 tuple(po), (tuple(gx), tuple(gw)))


def wkv6(r, k, v, w, u):
    """K4: r/k/v/w (B,T,H,D) sharded on the batch or the heads, u (H,D)
    split with the heads; T and D read whole.  Returns (y, final state
    (B,H,D,D))."""
    if not on_mesh(r):
        return _wkv.wkv6(r, k, v, w, u)
    from torch.distributed.tensor import Partial, Replicate, Shard
    pin, pu, gu, ps = [], [], [], []
    for p in r.placements:
        d = _shard_dim(p, 4)
        if d == 0:
            cols = (Shard(0), Replicate(), Partial(), Shard(0))
        elif d == 2:
            cols = (Shard(2), Shard(0), Shard(0), Shard(1))
        else:
            cols = (Replicate(), Replicate(), Replicate(), Replicate())
        for acc, c in zip((pin, pu, gu, ps), cols):
            acc.append(c)
    pin, pu, gu = tuple(pin), tuple(pu), tuple(gu)
    return _call(_wkv.wkv6, (r, k, v, w, u), (pin,) * 4 + (pu,),
                 (pin, tuple(ps)), (pin,) * 4 + (gu,))


def rglru(a, b):
    """K5: a/b (B,T,D) sharded on the batch or the channels; T read
    whole.  Returns (h, h_T (B,D))."""
    if not on_mesh(a):
        return _rglru.rglru(a, b)
    from torch.distributed.tensor import Replicate, Shard
    pin, plast = [], []
    for p in a.placements:
        d = _shard_dim(p, 3)
        if d == 0:
            pin.append(Shard(0)), plast.append(Shard(0))
        elif d == 2:
            pin.append(Shard(2)), plast.append(Shard(1))
        else:
            pin.append(Replicate()), plast.append(Replicate())
    pin = tuple(pin)
    return _call(_rglru.rglru, (a, b), (pin, pin), (pin, tuple(plast)),
                 (pin, pin))


def rowwise(fn, *args, outputs: int = 1):
    """``fn(*args)`` where ``fn`` computes each batch row (dim 0 of every
    operand and of its ``outputs`` results) from that row alone.  On
    DTensors every operand is laid out like the first one's rows (sharded
    on dim 0 where it is, replicated elsewhere) and ``fn`` runs on each
    rank's rows."""
    if not on_mesh(args[0]):
        return fn(*args)
    from torch.distributed.tensor import Replicate, Shard
    rows = tuple(Shard(0) if _shard_dim(p, args[0].dim()) == 0
                 else Replicate() for p in args[0].placements)
    return _call(fn, args, (rows,) * len(args),
                 rows if outputs == 1 else (rows,) * outputs,
                 (rows,) * len(args))


def cache_write(caches, idx, news, scatter: bool = False) -> None:
    """``cache[b, idx[b]] = new[b]`` for every batch row b and each
    (cache, new) of ``caches`` and ``news``, in place: a cache (B,S,KV,Dh),
    idx (B,) slots, a new (B,KV,Dh).  On plain tensors one scatter of the
    written slots a cache.  On a mesh each rank writes the rows and slots
    its shard of a cache holds (batch over the data axes, slots over
    ``model`` where the plan shards the sequence), as the JAX package
    writes a sharded cache: with ``scatter`` a scatter of the written slot
    (a row whose slot lies in another rank's shard writes its own value
    back), else a select over the whole shard."""
    if not on_mesh(caches[0]):
        b_idx = torch.arange(caches[0].shape[0], device=caches[0].device)
        slot = idx.long()
        for cache, new in zip(caches, news):
            cache[b_idx, slot] = new
        return
    from torch.distributed.tensor import Replicate, Shard
    cache = caches[0]
    mesh = cache.device_mesh
    pn, prow, s0 = [], [], 0
    for j, p in enumerate(cache.placements):
        d = _shard_dim(p, 4)
        pn.append(Shard(0) if d == 0 else Shard(1) if d == 2
                  else Replicate())
        prow.append(Shard(0) if d == 0 else Replicate())
        if d == 1:                 # torch.chunk's split of the slots
            s0 += mesh.get_local_rank(j) * -(-cache.shape[1]
                                             // mesh.size(j))
    idx_l = idx.redistribute(mesh, prow).to_local().long() - s0
    rows = cache.to_local().shape[1]
    b_idx = torch.arange(idx_l.shape[0], device=idx_l.device)
    mine = (idx_l >= 0) & (idx_l < rows)
    slot = torch.clamp(idx_l, 0, max(rows - 1, 0))
    sel = (torch.arange(rows, device=idx_l.device)[None, :]
           == idx_l[:, None])[:, :, None, None]
    for cache, new in zip(caches, news):
        local = cache.to_local()
        new_l = new.redistribute(mesh, pn).to_local()
        if scatter:
            local[b_idx, slot] = torch.where(mine[:, None, None], new_l,
                                             local[b_idx, slot])
        else:
            local.copy_(torch.where(sel, new_l[:, None], local))


def split_dim(t, dim: int, sizes):
    """``t`` with dim ``dim`` reshaped into ``sizes``.  On a mesh whose dim
    shards that dim into pieces the first of ``sizes`` does not divide
    into (40 heads over 16 ranks), that mesh dim is gathered first: a
    DTensor cannot split an unevenly sharded dim."""
    nd = t.dim()
    dim %= nd
    shape = (*t.shape[:dim], *sizes, *t.shape[dim + 1:])
    if not on_mesh(t):
        return t.reshape(shape)
    from torch.distributed.tensor import Replicate
    mesh = t.device_mesh
    want = [Replicate() if _shard_dim(p, nd) == dim
            and sizes[0] % mesh.size(j) else p
            for j, p in enumerate(t.placements)]
    if want != list(t.placements):
        t = t.redistribute(mesh, want)
    return t.reshape(shape)


def embed(table, ids):
    """``table[ids]``: the rows (..., D) of a (V, D) table at integer
    ``ids`` (...).  On a mesh the ids keep their layout; a mesh dim that
    shards the table's vocab (vocab-parallel) reads each id on the rank
    that holds its row, the others adding zeros (the output Partial
    there), and the table's gradient is Partial on the dims that shard
    the ids."""
    if not on_mesh(table):
        return table[ids.long()]
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh, nd = table.device_mesh, ids.dim()
    pt, pi, po, gt = [], [], [], []
    vocab = None                          # (mesh dim, rows a rank)
    at = (ids.placements if on_mesh(ids)
          else (Replicate(),) * mesh.ndim)
    for j, (a, b) in enumerate(zip(table.placements, at)):
        if _shard_dim(a, 2) == 0 and vocab is None:
            vocab = (j, -(-table.shape[0] // mesh.size(j)))
            cols = (Shard(0), Replicate(), Partial(), Shard(0))
        elif _shard_dim(b, nd) is not None:
            d = _shard_dim(b, nd)
            cols = (Replicate(), Shard(d), Shard(d), Partial())
        else:
            cols = (Replicate(),) * 4
        for acc, c in zip((pt, pi, po, gt), cols):
            acc.append(c)
    start = mesh.get_local_rank(vocab[0]) * vocab[1] if vocab else 0

    def local(t, i):
        i = i.long()
        if vocab is None:
            return t[i]
        mine = (i >= start) & (i < start + t.shape[0])
        rows = t[torch.where(mine, i - start, torch.zeros_like(i))]
        return rows * mine[..., None].to(rows.dtype)

    return _call(local, (table, ids), (tuple(pt), tuple(pi)), tuple(po),
                 (tuple(gt), tuple(pi)))


def replicate_dims(t, dims):
    """``t`` with no mesh dim sharding any of its dims ``dims`` (those
    gathered); the identity on a plain tensor.  Before an einsum whose
    batch dims it flattens: a DTensor flattens two dims into one only if
    no dim but the first is sharded."""
    if not on_mesh(t):
        return t
    from torch.distributed.tensor import Replicate
    nd = t.dim()
    dims = {d % nd for d in dims}
    want = [Replicate() if _shard_dim(p, nd) in dims else p
            for p in t.placements]
    if want == list(t.placements):
        return t
    return t.redistribute(t.device_mesh, want)


def vocab_stats(lf, ids):
    """(max, sum of exp(lf - max), lf at ids) over the last (vocab) dim
    of fp32 logits ``lf`` (..., V), for integer ``ids`` (...); the max
    carries no gradient.  On a mesh each rank reduces its own shard of
    the logits and DTensor adds (or maxes) the shards' partial results:
    vocab-sharded logits stay sharded, and their gradient comes back in
    their own layout."""
    if not on_mesh(lf):
        m = torch.amax(lf, dim=-1).detach()
        se = torch.sum(torch.exp(lf - m[..., None]), dim=-1)
        return m, se, torch.gather(lf, -1, ids[..., None])[..., 0]
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh, nd = lf.device_mesh, lf.dim()
    pl, pi, pmax, psum = [], [], [], []
    vocab = None                          # (mesh dim, columns a rank)
    for j, p in enumerate(lf.placements):
        d = _shard_dim(p, nd)
        if d == nd - 1 and vocab is None:
            vocab = (j, -(-lf.shape[-1] // mesh.size(j)))
            cols = (Shard(d), Replicate(), Partial("max"), Partial())
        elif d is not None and d < nd - 1:
            cols = (Shard(d),) * 4
        else:
            cols = (Replicate(),) * 4
        for acc, c in zip((pl, pi, pmax, psum), cols):
            acc.append(c)
    pl, pi, pmax, psum = map(tuple, (pl, pi, pmax, psum))
    start = mesh.get_local_rank(vocab[0]) * vocab[1] if vocab else 0
    with torch.no_grad():
        m = _call(lambda l: torch.amax(l, dim=-1), (lf.detach(),), (pl,),
                  pmax, (pl,))
    m = m.redistribute(mesh, pi)

    def local(l, mm, i):
        se = torch.sum(torch.exp(l - mm[..., None]), dim=-1)
        cols = torch.arange(start, start + l.shape[-1], device=l.device)
        picked = torch.sum(torch.where(cols == i[..., None], l,
                                       torch.zeros_like(l)), dim=-1)
        return se, picked

    se, picked = _call(local, (lf, m, ids), (pl, pi, pi), (psum, psum),
                       (pl, pi, pi))
    return m, se, picked


class _GradAsForward(torch.autograd.Function):
    """The identity on a DTensor, whose backward lays its gradient out as
    the forward tensor was (replicated where that was Partial: the
    gradient of a sum is the same on every rank).  DTensor picks each
    op's backward layout by its own cost model, and for a one-row-a-rank
    batch it shards a projection's output gradient over the sequence,
    where its product with the saved input then fails to propagate; held
    to the forward's layout, the backward products are the forward's
    transposes."""

    @staticmethod
    def forward(ctx, x):
        from torch.distributed.tensor import Replicate
        ctx.mesh = x.device_mesh
        ctx.want = tuple(Replicate() if p.is_partial() else p
                         for p in x.placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) != ctx.want:
            g = g.redistribute(ctx.mesh, ctx.want)
        return g


def grad_as_forward(x):
    """``x``, its gradient held to its own layout on a mesh
    (:class:`_GradAsForward`); the identity on a plain tensor and where
    no gradient flows."""
    if on_mesh(x) and x.requires_grad and torch.is_grad_enabled():
        return _GradAsForward.apply(x)
    return x
