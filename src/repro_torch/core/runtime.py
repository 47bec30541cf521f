"""Numeric execution of compiled plans in PyTorch (the asynchronous
runtime, §3.3).

Two executors:

* :func:`execute_graph` — direct whole-graph evaluation (the oracle).
* :func:`execute_plan` — tile-by-tile execution of an :class:`ExecutionPlan`:
  every supernode computes exactly its tile segment of the fused chain
  (including conv halos and the slice/concat helper semantics), and the
  segments are stitched back into the full tensors, mirroring what the
  generated multi-device binary does on the SoC.

``execute_plan(plan) ≈ execute_graph(graph)`` (allclose) is the correctness
contract of the whole compiler.

Everything here runs in float32 regardless of the deployment dtype: the
numerics validate *plan structure* (tiling, halos, segment stitching), not
reduced-precision kernels.  TF32 is switched off for cuDNN and cuBLAS, and
cuDNN runs deterministic algorithms without autotuning, so the 1e-4
contract and the bitwise multi-tenant invariance hold on the card too.

The layouts are the JAX package's: activations NHWC, conv weights HWIO.
``dense`` / ``matmul`` / ``batch_matmul`` run through the hand-written GEMM
kernel and ``rmsnorm`` through the fused RMSNorm kernel (their plain torch
versions on CPU tensors); convolutions and pooling are torch's.  Tensors
stay on whatever device the caller put the inputs and parameters on.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.ir import Graph, Op, tile_axis
from repro_torch.core.rewrite import Supernode, TiledGraph
from repro_torch.core.schedule import ExecutionPlan
from repro_torch.kernels.matmul.matmul import matmul as _matmul
from repro_torch.kernels.rmsnorm.rmsnorm import rmsnorm as _rmsnorm

Arrays = Dict[str, torch.Tensor]

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cudnn.benchmark = False
torch.backends.cudnn.deterministic = True


# ---------------------------------------------------------------------------
# Parameter / input initialization
# ---------------------------------------------------------------------------


def init_params(g: Graph, seed: int = 0, device="cuda") -> Arrays:
    rng = np.random.default_rng(seed)
    out: Arrays = {}
    for name, t in g.tensors.items():
        if t.kind == "param":
            fan_in = int(np.prod(t.shape[:-1])) or 1
            scale = 1.0 / math.sqrt(fan_in)
            out[name] = torch.from_numpy(
                rng.normal(0.0, scale, size=t.shape).astype(np.float32)
            ).to(device)
    return out


def init_inputs(g: Graph, seed: int = 1, device="cuda") -> Arrays:
    rng = np.random.default_rng(seed)
    return {n: torch.from_numpy(rng.normal(0.0, 1.0, size=g.tensors[n].shape)
                                .astype(np.float32)).to(device)
            for n in g.inputs}


# ---------------------------------------------------------------------------
# Full-op semantics
# ---------------------------------------------------------------------------


def _conv_pads(h: int, kh: int, stride: int, padding: str) -> Tuple[int, int]:
    if padding != "same":
        return 0, 0
    out = math.ceil(h / stride)
    total = max((out - 1) * stride + kh - h, 0)
    return total // 2, total - total // 2


def _pad_nhwc(x: torch.Tensor, kh: int, kw: int, stride: int,
              padding: str, value: float = 0.0) -> torch.Tensor:
    """Explicit (possibly asymmetric) ``same`` padding; the op that
    follows runs VALID, as XLA's does."""
    if padding != "same":
        return x
    _, h, w, _ = x.shape
    pt, pb = _conv_pads(h, kh, stride, padding)
    pl_, pr = _conv_pads(w, kw, stride, padding)
    return F.pad(x, (0, 0, pl_, pr, pt, pb), value=value)


def _conv_nhwc(x: torch.Tensor, w: torch.Tensor, stride: int,
               depthwise: bool) -> torch.Tensor:
    """VALID conv of an NHWC input with an HWIO weight; a depthwise
    weight (kh, kw, 1, C*mult) becomes OIHW with ``groups=C``."""
    kh, kw = w.shape[0], w.shape[1]
    groups = 1
    if depthwise:
        groups = x.shape[-1]
        w = w.reshape(kh, kw, 1, -1)
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                 stride=stride, groups=groups)
    return y.permute(0, 2, 3, 1)


def _pool_nhwc(x: torch.Tensor, ot: str, k: int, s: int,
               pad: str) -> torch.Tensor:
    """``reduce_window`` pooling: ``same`` pads max pooling with -inf and
    average pooling with zeros, and the average divides by ``k*k``."""
    is_max = ot == "max_pool2d"
    xp = _pad_nhwc(x, k, k, s, pad.lower(),
                   value=-math.inf if is_max else 0.0)
    xc = xp.permute(0, 3, 1, 2)
    # padding is explicit above, so avg_pool2d's divisor is always k*k
    y = F.max_pool2d(xc, k, s) if is_max else F.avg_pool2d(xc, k, s)
    return y.permute(0, 2, 3, 1)


def run_op(g: Graph, op: Op, ins: Sequence[torch.Tensor]) -> torch.Tensor:
    a = op.attrs
    ot = op.op_type
    if ot in ("conv2d", "dwconv2d"):
        x, w = ins[0], ins[1]
        stride = a.get("stride", 1)
        padding = a.get("padding", "same")
        kh, kw = w.shape[0], w.shape[1]
        xp = _pad_nhwc(x, kh, kw, stride, padding)
        return _conv_nhwc(xp, w, stride, ot == "dwconv2d")
    if ot in ("dense", "matmul", "batch_matmul"):
        return _matmul(ins[0], ins[1])
    if ot == "add":
        return ins[0] + ins[1]
    if ot == "sub":
        return ins[0] - ins[1]
    if ot == "mul":
        return ins[0] * ins[1]
    if ot == "bias_add":
        return ins[0] + ins[1]
    if ot == "relu":
        return torch.clamp_min(ins[0], 0.0)
    if ot == "relu6":
        return torch.clamp(ins[0], 0.0, 6.0)
    if ot == "gelu":
        return F.gelu(ins[0], approximate="none")
    if ot == "sigmoid":
        return torch.sigmoid(ins[0])
    if ot == "tanh":
        return torch.tanh(ins[0])
    if ot == "erf":
        return torch.erf(ins[0])
    if ot == "softmax":
        return torch.softmax(ins[0], dim=-1)
    if ot == "layernorm":
        x = ins[0]
        mu = x.mean(dim=-1, keepdim=True)
        var = x.var(dim=-1, keepdim=True, correction=0)    # biased, as jnp
        y = (x - mu) / torch.sqrt(var + 1e-5)
        if len(ins) >= 3:
            y = y * ins[1] + ins[2]
        return y
    if ot == "rmsnorm":
        return _rmsnorm(ins[0], ins[1] if len(ins) >= 2 else None, eps=1e-6)
    if ot in ("avg_pool2d", "max_pool2d"):
        k = a["pool_size"]
        return _pool_nhwc(ins[0], ot, k, a.get("stride", k),
                          a.get("padding", "valid"))
    if ot == "global_avg_pool":
        return ins[0].mean(dim=(1, 2))
    if ot == "reshape":
        return ins[0].reshape(tuple(g.tensors[op.output].shape))
    if ot == "flatten":
        n = ins[0].shape[0]
        return ins[0].reshape(n, -1)
    if ot == "transpose":
        return ins[0].permute(*a["perm"])
    if ot == "slice":
        idx = [slice(None)] * ins[0].ndim
        idx[a["axis"]] = slice(a["begin"], a["end"])
        return ins[0][tuple(idx)]
    if ot == "concat":
        return torch.cat(list(ins), dim=a["axis"])
    if ot == "pad":
        pads = [(0, 0)] * ins[0].ndim
        for ax, (lo, hi) in a["paddings"].items():
            pads[int(ax)] = (lo, hi)
        # F.pad lists (lo, hi) pairs from the last axis backwards
        return F.pad(ins[0], [p for lo_hi in reversed(pads) for p in lo_hi])
    if ot == "identity":
        return ins[0]
    raise NotImplementedError(ot)


def execute_graph(g: Graph, inputs: Arrays, params: Arrays) -> Arrays:
    """Direct whole-graph evaluation (the numeric oracle)."""
    env: Arrays = {**inputs, **params}
    for op in g.topo_ops():
        env[op.output] = run_op(g, op, [env[t] for t in op.inputs])
    return {t: env[t] for t in g.outputs}


# ---------------------------------------------------------------------------
# Tiled execution
# ---------------------------------------------------------------------------


def _coord_range(g: Graph, op: Op, lo: int, hi: int, T: int,
                 ax: int) -> Tuple[int, int]:
    extent = g.tensors[op.output].shape[ax]
    assert extent % T == 0, (op.name, extent, T)
    step = extent // T
    return lo * step, hi * step


def _slice_axis(x: torch.Tensor, ax: int, c0: int, c1: int) -> torch.Tensor:
    idx = [slice(None)] * x.ndim
    idx[ax] = slice(c0, c1)
    return x[tuple(idx)]


def _conv_row_tile(g: Graph, op: Op, ins: Sequence[torch.Tensor],
                   r0: int, r1: int) -> torch.Tensor:
    """Rows [r0, r1) of a conv2d / dwconv2d / pool output, computed from an
    input slice with halo — the slice helper semantics of §3.1."""
    a = op.attrs
    ot = op.op_type
    x = ins[0]
    if ot in ("conv2d", "dwconv2d"):
        w = ins[1]
        kh, kw = w.shape[0], w.shape[1]
        stride = a.get("stride", 1)
        padding = a.get("padding", "same")
        xp = _pad_nhwc(x, kh, kw, stride, padding)
        i0 = r0 * stride
        i1 = (r1 - 1) * stride + kh
        xs = xp[:, i0:i1, :, :]
        return _conv_nhwc(xs, w, stride, ot == "dwconv2d")
    if ot in ("avg_pool2d", "max_pool2d"):
        k = a["pool_size"]
        s = a.get("stride", k)
        i0, i1 = r0 * s, (r1 - 1) * s + k
        xs = x[:, i0:i1, :, :]
        sub = Op(op.name + ":t", ot, op.inputs, op.output,
                 {**a, "padding": "valid"})
        return run_op(g, sub, [xs])
    raise NotImplementedError(ot)


def run_supernode(g: Graph, sn: Supernode,
                  env: Arrays) -> Dict[str, torch.Tensor]:
    """Computes this supernode's tile segment for every op of its chain.
    Returns {output tensor name: tile tensor} (to be stitched by the
    caller).  Reads full input tensors from ``env`` (slice helpers are
    applied here)."""
    lo, hi, T = sn.tile_lo, sn.tile_hi, sn.T
    results: Dict[str, torch.Tensor] = {}
    prev_tile: Optional[torch.Tensor] = None
    prev_out: Optional[str] = None
    for name in sn.op_names:
        op = g.ops[name]
        ax = tile_axis(g, op)
        full = (lo, hi) == (0, T)
        ins_full = []
        for t in op.inputs:
            if t == prev_out and prev_tile is not None:
                ins_full.append(None)        # consumed as the running tile
            else:
                ins_full.append(env[t])
        if ax is None or full:
            # untiled op (or the full-range segment): plain execution
            ins = [prev_tile if v is None else v for v in ins_full]
            tile = run_op(g, op, ins)
        else:
            c0, c1 = _coord_range(g, op, lo, hi, T, ax)
            out_shape = g.tensors[op.output].shape
            if op.op_type in ("conv2d", "dwconv2d", "avg_pool2d",
                              "max_pool2d"):
                assert prev_tile is None, "conv must head its chain"
                tile = _conv_row_tile(g, op, ins_full, c0, c1)
            elif op.op_type in ("dense", "matmul", "batch_matmul"):
                assert prev_tile is None, "gemm must head its chain"
                x, w = ins_full[0], ins_full[1]
                # the weight's column slice is a strided view: the GEMM
                # kernel reads it in place, no copy
                tile = _matmul(x, _slice_axis(w, w.ndim - 1, c0, c1))
            else:
                # elementwise / normalization: slice every full input along
                # the tile axis; 1-D bias broadcasts slice on the last axis
                # only when that *is* the tile axis (neuron tiling).
                ins = []
                for v, t in zip(ins_full, op.inputs):
                    if v is None:
                        ins.append(prev_tile)
                        continue
                    ti = g.tensors[t]
                    if len(ti.shape) == len(out_shape):
                        if ti.shape[ax] == out_shape[ax]:
                            ins.append(_slice_axis(v, ax, c0, c1))
                        else:
                            ins.append(v)            # broadcast dim
                    elif (len(ti.shape) == 1
                          and ax == len(out_shape) - 1
                          and ti.shape[0] == out_shape[-1]):
                        ins.append(v[c0:c1])         # sliced bias (neuron)
                    else:
                        ins.append(v)
                tile = run_op(g, op, ins)
        results[op.output] = tile
        prev_tile, prev_out = tile, op.output
    return results


class _TenantExecutor:
    """Tile-stitching execution state for ONE model (tenant).

    Runs supernode kernels in whatever order the schedule dictates and
    stitches tile segments back into full tensors (the concat-helper
    semantics).  Segments are disjoint, so any interleaving with other
    tenants' kernels produces bitwise-identical outputs to running this
    model alone."""

    def __init__(self, tg: TiledGraph, inputs: Arrays, params: Arrays
                 ) -> None:
        self.g = tg.graph
        self.env: Arrays = {**inputs, **params}
        self.buf: Dict[str, torch.Tensor] = {}
        self.filled: Dict[str, int] = {}
        self.sn_by_name = {s.name: s for s in tg.supernodes}

    def run_kernel(self, supernode: str) -> None:
        g = self.g
        sn = self.sn_by_name[supernode]
        tiles = run_supernode(g, sn, self.env)
        for out_t, tile in tiles.items():
            op = g.producer_of(out_t)
            ax = tile_axis(g, op)
            if ax is None or sn.full:
                self.env[out_t] = tile
                continue
            if out_t not in self.buf:
                self.buf[out_t] = torch.zeros(g.tensors[out_t].shape,
                                              dtype=tile.dtype,
                                              device=tile.device)
                self.filled[out_t] = 0
            c0, _ = _coord_range(g, op, sn.tile_lo, sn.tile_hi, sn.T, ax)
            # dynamic_update_slice, done IN PLACE: the buffer is this
            # executor's private tensor until its last segment lands
            _slice_axis(self.buf[out_t], ax, c0,
                        c0 + tile.shape[ax]).copy_(tile)
            self.filled[out_t] += sn.tiles
            if self.filled[out_t] == sn.T:
                self.env[out_t] = self.buf.pop(out_t)

    def outputs(self) -> Arrays:
        missing = [t for t in self.g.outputs if t not in self.env]
        if missing:
            raise RuntimeError(f"plan did not produce outputs: {missing}")
        return {t: self.env[t] for t in self.g.outputs}


def execute_plan(plan: ExecutionPlan, inputs: Arrays, params: Arrays
                 ) -> Arrays:
    """Tile-by-tile execution following the compiled plan.

    Segments are stitched into per-tensor buffers (the concat helper);
    supernodes run in the plan's scheduled order, which respects data
    dependencies by construction (validated by ``validate_schedule``)."""
    ex = _TenantExecutor(plan.tiled, inputs, params)
    for node_name in plan.order:
        n = plan.nodes[node_name]
        if n.kind == "kernel" and n.supernode is not None:
            ex.run_kernel(n.supernode)
    return ex.outputs()


def execute_multi_plan(plan, inputs_list: Sequence[Arrays],
                       params_list: Sequence[Arrays]) -> List[Arrays]:
    """Interleaved-tenant execution of a
    :class:`repro_torch.core.schedule.MultiExecutionPlan`.

    Kernels run in global scheduled order; each dispatches into its
    tenant's private executor, so N models make progress concurrently the
    way the co-schedule interleaves them on the SoC.  Numerics are
    identical to running each model alone (asserted by
    :func:`multi_plan_matches_oracle`)."""
    execs = [_TenantExecutor(tg, inputs_list[i], params_list[i])
             for i, tg in enumerate(plan.tenants)]
    for node_name in plan.order:
        n = plan.nodes[node_name]
        if n.kind == "kernel" and n.supernode is not None:
            execs[n.tenant].run_kernel(n.supernode)
    return [ex.outputs() for ex in execs]


def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def plan_matches_oracle(plan: ExecutionPlan, seed: int = 0,
                        atol: float = 1e-4, rtol: float = 1e-4,
                        device="cuda") -> bool:
    g = plan.tiled.graph
    params = init_params(g, seed, device)
    inputs = init_inputs(g, seed + 1, device)
    want = execute_graph(g, inputs, params)
    got = execute_plan(plan, inputs, params)
    for t in g.outputs:
        np.testing.assert_allclose(_np(got[t]), _np(want[t]),
                                   atol=atol, rtol=rtol)
    return True


def multi_plan_matches_oracle(plan, seed: int = 0, atol: float = 1e-4,
                              rtol: float = 1e-4, device="cuda") -> bool:
    """Multi-tenant correctness contract: the interleaved co-scheduled
    execution matches every tenant's single-model oracle."""
    inputs_list, params_list = [], []
    for i, tg in enumerate(plan.tenants):
        params_list.append(init_params(tg.graph, seed + 2 * i, device))
        inputs_list.append(init_inputs(tg.graph, seed + 2 * i + 1, device))
    got = execute_multi_plan(plan, inputs_list, params_list)
    for i, tg in enumerate(plan.tenants):
        g = tg.graph
        want = execute_graph(g, inputs_list[i], params_list[i])
        for t in g.outputs:
            np.testing.assert_allclose(
                _np(got[i][t]), _np(want[t]), atol=atol, rtol=rtol,
                err_msg=f"tenant {i} ({g.name}) output {t}")
    return True
