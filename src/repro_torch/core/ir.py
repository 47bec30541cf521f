"""Relay-like operator-graph IR for the MATCHA pipeline.

The paper imports ONNX into TVM Relay; here we provide a lean directed-graph IR
with the same essential structure: nodes are tensors or primitive operators,
edges are data dependencies (§3.1, "G_IR = (V, E)").  Shape inference, arithmetic
op counts (``Ops_v``) and per-operator tiling metadata (``T_v``, tile axis) live
here because every later stage (pattern matching, the CP tiling optimizer, the
scheduler and the numeric executor) consumes them.

Layout conventions: activations are NHWC, conv weights are HWIO, dense weights
are (in, out).  All ops have exactly one output tensor, which keeps patterns
chain-shaped as in the paper.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# Tensors
# ---------------------------------------------------------------------------

TensorKind = str  # "input" | "param" | "intermediate" | "output"


@dataclasses.dataclass
class TensorInfo:
    name: str
    shape: Tuple[int, ...]
    dtype: str = "float32"
    kind: TensorKind = "intermediate"
    producer: Optional[str] = None  # op name that writes this tensor

    @property
    def elements(self) -> int:
        return int(np.prod(self.shape)) if self.shape else 1

    @property
    def bytes(self) -> int:
        itemsize = {"float32": 4, "float16": 2, "bfloat16": 2, "int8": 1,
                    "int32": 4}[self.dtype]
        return self.elements * itemsize


# ---------------------------------------------------------------------------
# Operators
# ---------------------------------------------------------------------------

# Op types understood by the pipeline.  "ew_*" are elementwise.
OP_TYPES = (
    "conv2d", "dwconv2d", "dense", "matmul", "batch_matmul",
    "add", "mul", "sub", "bias_add",
    "relu", "relu6", "gelu", "sigmoid", "tanh", "erf", "softmax",
    "layernorm", "rmsnorm",
    "avg_pool2d", "max_pool2d", "global_avg_pool",
    "reshape", "flatten", "transpose", "slice", "concat", "pad", "identity",
)

_ELEMENTWISE = {"add", "mul", "sub", "bias_add", "relu", "relu6", "gelu",
                "sigmoid", "tanh", "erf", "identity"}
# Approximate arithmetic ops per element for non-MAC operators.
_EW_OPS_PER_ELEM = {
    "add": 1.0, "mul": 1.0, "sub": 1.0, "bias_add": 1.0, "relu": 1.0,
    "relu6": 2.0, "gelu": 8.0, "sigmoid": 4.0, "tanh": 4.0, "erf": 8.0,
    "identity": 0.0, "softmax": 5.0, "layernorm": 8.0, "rmsnorm": 6.0,
}


@dataclasses.dataclass
class Op:
    name: str
    op_type: str
    inputs: List[str]            # tensor names (activations first, then params)
    output: str                  # tensor name
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self) -> None:
        if self.op_type not in OP_TYPES:
            raise ValueError(f"unknown op_type {self.op_type!r}")


# ---------------------------------------------------------------------------
# Graph
# ---------------------------------------------------------------------------


class Graph:
    """Operator graph with single-producer tensors (SSA-like)."""

    def __init__(self, name: str = "graph") -> None:
        self.name = name
        self.tensors: Dict[str, TensorInfo] = {}
        self.ops: Dict[str, Op] = {}
        self._order: List[str] = []          # insertion order == topo order
        self.inputs: List[str] = []
        self.outputs: List[str] = []

    # -- construction -------------------------------------------------------
    def add_input(self, name: str, shape: Sequence[int],
                  dtype: str = "float32") -> str:
        self.tensors[name] = TensorInfo(name, tuple(shape), dtype, "input")
        self.inputs.append(name)
        return name

    def add_param(self, name: str, shape: Sequence[int],
                  dtype: str = "float32") -> str:
        self.tensors[name] = TensorInfo(name, tuple(shape), dtype, "param")
        return name

    def add_op(self, op_type: str, inputs: Sequence[str], name: str = None,
               out_name: str = None, **attrs) -> str:
        """Adds an op, infers the output shape, returns the output tensor name."""
        name = name or f"{op_type}_{len(self.ops)}"
        if name in self.ops:
            raise ValueError(f"duplicate op name {name}")
        out_name = out_name or f"{name}:out"
        op = Op(name, op_type, list(inputs), out_name, dict(attrs))
        shape, dtype = infer_shape(self, op)
        self.tensors[out_name] = TensorInfo(out_name, shape, dtype,
                                            "intermediate", producer=name)
        self.ops[name] = op
        self._order.append(name)
        return out_name

    def mark_output(self, tensor: str) -> None:
        self.tensors[tensor].kind = "output"
        self.outputs.append(tensor)

    # -- queries ------------------------------------------------------------
    def topo_ops(self) -> List[Op]:
        return [self.ops[n] for n in self._order]

    def producer_of(self, tensor: str) -> Optional[Op]:
        p = self.tensors[tensor].producer
        return self.ops[p] if p else None

    def consumers_of(self, tensor: str) -> List[Op]:
        return [op for op in self.topo_ops() if tensor in op.inputs]

    def successors(self, op: Op) -> List[Op]:
        return self.consumers_of(op.output)

    def predecessors(self, op: Op) -> List[Op]:
        preds = []
        for t in op.inputs:
            p = self.producer_of(t)
            if p is not None:
                preds.append(p)
        return preds

    def param_tensors(self, op: Op) -> List[TensorInfo]:
        return [self.tensors[t] for t in op.inputs
                if self.tensors[t].kind == "param"]

    def act_inputs(self, op: Op) -> List[TensorInfo]:
        return [self.tensors[t] for t in op.inputs
                if self.tensors[t].kind != "param"]

    def total_macs(self) -> int:
        return sum(op_macs(self, op) for op in self.topo_ops())

    def total_params(self) -> int:
        return sum(t.elements for t in self.tensors.values()
                   if t.kind == "param")

    def validate(self) -> None:
        seen = set(self.inputs) | {t for t, i in self.tensors.items()
                                   if i.kind == "param"}
        for op in self.topo_ops():
            for t in op.inputs:
                if t not in self.tensors:
                    raise ValueError(f"{op.name}: unknown input {t}")
                if self.tensors[t].kind == "intermediate" and t not in seen:
                    raise ValueError(f"{op.name}: input {t} used before def")
            seen.add(op.output)
        for t in self.outputs:
            if t not in self.tensors:
                raise ValueError(f"unknown output {t}")


# ---------------------------------------------------------------------------
# Shape inference
# ---------------------------------------------------------------------------


def _conv_out_hw(h: int, w: int, kh: int, kw: int, stride: int,
                 padding: str) -> Tuple[int, int]:
    if padding == "same":
        return math.ceil(h / stride), math.ceil(w / stride)
    return (h - kh) // stride + 1, (w - kw) // stride + 1


def infer_shape(g: Graph, op: Op) -> Tuple[Tuple[int, ...], str]:
    t = [g.tensors[i] for i in op.inputs]
    a = op.attrs
    ot = op.op_type
    dtype = t[0].dtype
    if ot == "conv2d":
        n, h, w, _ = t[0].shape
        kh, kw, _, co = t[1].shape
        oh, ow = _conv_out_hw(h, w, kh, kw, a.get("stride", 1),
                              a.get("padding", "same"))
        return (n, oh, ow, co), dtype
    if ot == "dwconv2d":
        n, h, w, c = t[0].shape
        kh, kw, _, mult = t[1].shape
        oh, ow = _conv_out_hw(h, w, kh, kw, a.get("stride", 1),
                              a.get("padding", "same"))
        return (n, oh, ow, c * mult), dtype
    if ot == "dense":
        *lead, _ = t[0].shape
        return (*lead, t[1].shape[1]), dtype
    if ot in ("matmul", "batch_matmul"):
        *lead, m, _ = t[0].shape
        nn = t[1].shape[-1]
        return (*lead, m, nn), dtype
    if ot in _ELEMENTWISE or ot in ("softmax", "layernorm", "rmsnorm", "identity"):
        return t[0].shape, dtype
    if ot in ("avg_pool2d", "max_pool2d"):
        n, h, w, c = t[0].shape
        k = a["pool_size"]
        s = a.get("stride", k)
        oh, ow = _conv_out_hw(h, w, k, k, s, a.get("padding", "valid"))
        return (n, oh, ow, c), dtype
    if ot == "global_avg_pool":
        n, _, _, c = t[0].shape
        return (n, c), dtype
    if ot == "reshape":
        shp = list(a["shape"])
        if -1 in shp:
            known = int(np.prod([d for d in shp if d != -1]))
            shp[shp.index(-1)] = t[0].elements // known
        return tuple(shp), dtype
    if ot == "flatten":
        n = t[0].shape[0]
        return (n, t[0].elements // n), dtype
    if ot == "transpose":
        perm = a["perm"]
        return tuple(t[0].shape[p] for p in perm), dtype
    if ot == "slice":
        begin, end = a["begin"], a["end"]
        axis = a["axis"]
        shp = list(t[0].shape)
        shp[axis] = end - begin
        return tuple(shp), dtype
    if ot == "concat":
        axis = a["axis"]
        shp = list(t[0].shape)
        shp[axis] = sum(x.shape[axis] for x in t)
        return tuple(shp), dtype
    if ot == "pad":
        shp = list(t[0].shape)
        for ax, (lo, hi) in a["paddings"].items():
            shp[int(ax)] += lo + hi
        return tuple(shp), dtype
    raise NotImplementedError(ot)


# ---------------------------------------------------------------------------
# Arithmetic work (Ops_v of §3.1) and tiling metadata
# ---------------------------------------------------------------------------


def op_macs(g: Graph, op: Op) -> int:
    """Multiply-accumulate count (0 for non-MAC ops)."""
    out = g.tensors[op.output]
    if op.op_type == "conv2d":
        kh, kw, ci, _ = g.tensors[op.inputs[1]].shape
        return out.elements * kh * kw * ci
    if op.op_type == "dwconv2d":
        kh, kw, _, _ = g.tensors[op.inputs[1]].shape
        return out.elements * kh * kw
    if op.op_type == "dense":
        cin = g.tensors[op.inputs[1]].shape[0]
        return out.elements * cin
    if op.op_type in ("matmul", "batch_matmul"):
        k = g.tensors[op.inputs[0]].shape[-1]
        return out.elements * k
    if op.op_type in ("avg_pool2d", "max_pool2d"):
        return 0
    return 0


def op_arith(g: Graph, op: Op) -> float:
    """Total arithmetic operation count Ops_v (MACs count as 2 ops)."""
    macs = op_macs(g, op)
    if macs:
        return 2.0 * macs
    out = g.tensors[op.output]
    if op.op_type in ("avg_pool2d", "max_pool2d"):
        return out.elements * op.attrs["pool_size"] ** 2
    if op.op_type == "global_avg_pool":
        src = g.tensors[op.inputs[0]]
        return src.elements
    per = _EW_OPS_PER_ELEM.get(op.op_type, 0.0)
    return out.elements * per


# Ops whose output can be partitioned into independent tiles (paper §3.1:
# feature-map rows for convolutions, output neurons for dense layers).
_ROW_TILED = {"conv2d", "dwconv2d", "add", "mul", "sub", "bias_add", "relu",
              "relu6", "gelu", "sigmoid", "tanh", "erf", "avg_pool2d",
              "max_pool2d", "layernorm", "rmsnorm", "softmax", "identity"}
_NEURON_TILED = {"dense", "matmul", "batch_matmul"}


def tile_axis(g: Graph, op: Op) -> Optional[int]:
    """Axis of the *output* along which the op is tiled, or None.

    Elementwise operators sitting on a single-use chain behind a dense /
    matmul producer inherit the *neuron* axis so that fused chains like
    dense+bias_add+relu tile consistently (the executor computes one tile
    index range for the whole chain)."""
    out = g.tensors[op.output]
    if op.op_type in _NEURON_TILED:
        return len(out.shape) - 1          # output neurons / columns
    if op.op_type in _ROW_TILED:
        if op.op_type in _ELEMENTWISE:
            p = g.producer_of(op.inputs[0]) if op.inputs else None
            for _ in range(4):
                if p is None:
                    break
                if p.op_type in _NEURON_TILED:
                    return len(out.shape) - 1
                if p.op_type not in _ELEMENTWISE:
                    break
                p = g.producer_of(p.inputs[0]) if p.inputs else None
        if len(out.shape) == 4:
            return 1                        # feature-map rows (NHWC)
        if len(out.shape) >= 2:
            return len(out.shape) - 2       # token rows
    return None                             # not tileable (reshape, concat, ...)


def max_tiles(g: Graph, op: Op, requested: int) -> int:
    """T_v: number of equal tiles; clamps to the extent of the tile axis."""
    ax = tile_axis(g, op)
    if ax is None:
        return 1
    extent = g.tensors[op.output].shape[ax]
    t = min(requested, extent)
    # Equal tiles keep Eq. (2) linear; use the largest divisor <= requested.
    while extent % t != 0:
        t -= 1
    return max(t, 1)


def tile_halo_rows(g: Graph, op: Op) -> int:
    """Input halo (extra rows) a row-tile needs; drives slice-copy cost."""
    if op.op_type in ("conv2d", "dwconv2d"):
        kh = g.tensors[op.inputs[1]].shape[0]
        return kh - 1
    if op.op_type in ("avg_pool2d", "max_pool2d"):
        return op.attrs["pool_size"] - 1
    return 0


def needs_input_slice(g: Graph, op: Op) -> bool:
    """True when tiling this op requires materialised input slices (runtime
    overhead).  Tiling along the *last* (neuron) axis is folded into the
    offline weight layout (paper §4, AutoEncoder discussion) => free."""
    ax = tile_axis(g, op)
    if ax is None:
        return False
    return ax != len(g.tensors[op.output].shape) - 1
