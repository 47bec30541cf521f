"""Benchmark model graphs (paper §4): MLPerf-Tiny nets + microbenchmark blocks.

All graphs use FP16 tensors (the paper's deployment precision) for byte
accounting; numeric validation runs the same graphs in float32.

MLPerf-Tiny [1]:
  * ``autoencoder``  — anomaly detection: 10 dense layers, 640-128-...-8-...-640
                       (paper: 0.27 M MACs, 268 k params)
  * ``ds_cnn``       — keyword spotting: conv + 4x (dw-conv + pw-conv) + FC
                       (paper: 2.8 M MACs, 22.6 k params)
  * ``mobilenet``    — visual wake words: MobileNetV1-0.25, 96x96x3
                       (paper: 7.9 M MACs, 210 k params)
  * ``resnet``       — CIFAR-10 ResNet (MLPerf-Tiny topology; the paper calls
                       it ResNet18): 3 residual stacks 16/32/64
                       (paper: 12.8 M MACs, 78 k params)

Microbenchmark blocks (Fig. 7):
  * ``resnet50_block``  — first bottleneck of ResNet-50 (1x1-3x3-1x1 + skip)
  * ``resnext50_block`` — first ResNeXt block, split-transform-merge branches
  * ``transformer_block`` — encoder layer, hidden 128, 4 heads, MHA+FFN+LN
"""

from __future__ import annotations

from typing import Tuple

from repro_torch.core.ir import Graph

DT = "float16"


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _conv(g: Graph, x: str, cin: int, cout: int, k: int, stride: int,
          name: str, relu: bool = True, bias: bool = True,
          padding: str = "same") -> str:
    w = g.add_param(f"{name}_w", (k, k, cin, cout), DT)
    y = g.add_op("conv2d", [x, w], name=name, stride=stride, padding=padding)
    if bias:
        b = g.add_param(f"{name}_b", (cout,), DT)
        y = g.add_op("bias_add", [y, b], name=f"{name}_bias")
    if relu:
        y = g.add_op("relu", [y], name=f"{name}_relu")
    return y


def _dwconv(g: Graph, x: str, c: int, k: int, stride: int, name: str,
            relu: bool = True) -> str:
    w = g.add_param(f"{name}_w", (k, k, c, 1), DT)
    y = g.add_op("dwconv2d", [x, w], name=name, stride=stride, padding="same")
    b = g.add_param(f"{name}_b", (c,), DT)
    y = g.add_op("bias_add", [y, b], name=f"{name}_bias")
    if relu:
        y = g.add_op("relu", [y], name=f"{name}_relu")
    return y


def _dense(g: Graph, x: str, cin: int, cout: int, name: str,
           relu: bool = True, bias: bool = True) -> str:
    w = g.add_param(f"{name}_w", (cin, cout), DT)
    y = g.add_op("dense", [x, w], name=name)
    if bias:
        b = g.add_param(f"{name}_b", (cout,), DT)
        y = g.add_op("bias_add", [y, b], name=f"{name}_bias")
    if relu:
        y = g.add_op("relu", [y], name=f"{name}_relu")
    return y


# ---------------------------------------------------------------------------
# MLPerf-Tiny models
# ---------------------------------------------------------------------------


def autoencoder(batch: int = 1) -> Graph:
    g = Graph("autoencoder")
    x = g.add_input("x", (batch, 640), DT)
    h = x
    for i, width in enumerate([128, 128, 128, 128, 8, 128, 128, 128, 128]):
        h = _dense(g, h, g.tensors[h].shape[-1], width, f"fc{i}")
    h = _dense(g, h, 128, 640, "fc_out", relu=False)
    g.mark_output(h)
    g.validate()
    return g


def ds_cnn(batch: int = 1) -> Graph:
    g = Graph("ds_cnn")
    x = g.add_input("x", (batch, 49, 10, 1), DT)
    h = _conv(g, x, 1, 64, 5, 2, "conv0")          # (25, 5, 64)
    for i in range(4):
        h = _dwconv(g, h, 64, 3, 1, f"dw{i}")
        h = _conv(g, h, 64, 64, 1, 1, f"pw{i}")
    h = g.add_op("global_avg_pool", [h], name="gap")
    h = _dense(g, h, 64, 12, "fc", relu=False)
    h = g.add_op("softmax", [h], name="prob")
    g.mark_output(h)
    g.validate()
    return g


def mobilenet(batch: int = 1) -> Graph:
    """MobileNetV1 0.25x for 96x96x3 visual wake words."""
    g = Graph("mobilenet")
    x = g.add_input("x", (batch, 96, 96, 3), DT)
    h = _conv(g, x, 3, 8, 3, 2, "conv0")           # 48x48x8
    cfg = [(8, 16, 1), (16, 32, 2), (32, 32, 1), (32, 64, 2), (64, 64, 1),
           (64, 128, 2), (128, 128, 1), (128, 128, 1), (128, 128, 1),
           (128, 128, 1), (128, 128, 1), (128, 256, 2), (256, 256, 1)]
    for i, (cin, cout, s) in enumerate(cfg):
        h = _dwconv(g, h, cin, 3, s, f"dw{i}")
        h = _conv(g, h, cin, cout, 1, 1, f"pw{i}")
    h = g.add_op("global_avg_pool", [h], name="gap")
    h = _dense(g, h, 256, 2, "fc", relu=False)
    h = g.add_op("softmax", [h], name="prob")
    g.mark_output(h)
    g.validate()
    return g


def resnet(batch: int = 1) -> Graph:
    """MLPerf-Tiny CIFAR-10 ResNet (3 stacks, 16/32/64 channels)."""
    g = Graph("resnet")
    x = g.add_input("x", (batch, 32, 32, 3), DT)
    h = _conv(g, x, 3, 16, 3, 1, "conv0")

    def block(h: str, cin: int, cout: int, stride: int, name: str) -> str:
        y = _conv(g, h, cin, cout, 3, stride, f"{name}_c1")
        w2 = g.add_param(f"{name}_c2_w", (3, 3, cout, cout), DT)
        y = g.add_op("conv2d", [y, w2], name=f"{name}_c2", stride=1,
                     padding="same")
        if stride != 1 or cin != cout:
            sc = _conv(g, h, cin, cout, 1, stride, f"{name}_sc",
                       relu=False, bias=False)
        else:
            sc = h
        y = g.add_op("add", [y, sc], name=f"{name}_add")
        return g.add_op("relu", [y], name=f"{name}_out")

    h = block(h, 16, 16, 1, "b1")
    h = block(h, 16, 32, 2, "b2")
    h = block(h, 32, 64, 2, "b3")
    h = g.add_op("global_avg_pool", [h], name="gap")
    h = _dense(g, h, 64, 10, "fc", relu=False)
    h = g.add_op("softmax", [h], name="prob")
    g.mark_output(h)
    g.validate()
    return g


# ---------------------------------------------------------------------------
# Microbenchmark blocks (Fig. 7)
# ---------------------------------------------------------------------------


def resnet50_block(batch: int = 1, hw: int = 56) -> Graph:
    """First bottleneck of ResNet-50: 1x1/64 -> 3x3/64 -> 1x1/256 (+skip)."""
    g = Graph("resnet50_block")
    x = g.add_input("x", (batch, hw, hw, 64), DT)
    y = _conv(g, x, 64, 64, 1, 1, "c1")
    y = _conv(g, y, 64, 64, 3, 1, "c2")
    w3 = g.add_param("c3_w", (1, 1, 64, 256), DT)
    y = g.add_op("conv2d", [y, w3], name="c3", stride=1, padding="same")
    sc = _conv(g, x, 64, 256, 1, 1, "sc", relu=False, bias=False)
    y = g.add_op("add", [y, sc], name="res_add")
    y = g.add_op("relu", [y], name="out_relu")
    g.mark_output(y)
    g.validate()
    return g


def resnext50_block(batch: int = 1, hw: int = 56, branches: int = 8) -> Graph:
    """First ResNeXt-50 block in split-transform-merge form: ``branches``
    parallel 1x1->3x3 paths over channel slices, concat, 1x1 expand + skip.
    The multi-branch topology is what the paper exploits for graph-level
    parallelism (§1)."""
    g = Graph("resnext50_block")
    x = g.add_input("x", (batch, hw, hw, 64), DT)
    width = 128 // branches
    outs = []
    for i in range(branches):
        yi = _conv(g, x, 64, width, 1, 1, f"br{i}_c1")
        yi = _conv(g, yi, width, width, 3, 1, f"br{i}_c2")
        outs.append(yi)
    y = g.add_op("concat", outs, name="merge", axis=3)
    w3 = g.add_param("c3_w", (1, 1, 128, 256), DT)
    y = g.add_op("conv2d", [y, w3], name="c3", stride=1, padding="same")
    sc = _conv(g, x, 64, 256, 1, 1, "sc", relu=False, bias=False)
    y = g.add_op("add", [y, sc], name="res_add")
    y = g.add_op("relu", [y], name="out_relu")
    g.mark_output(y)
    g.validate()
    return g


def transformer_block(seq: int = 64, d: int = 128, heads: int = 4,
                      ffn: int = 256) -> Graph:
    """Transformer encoder layer (hidden 128): MHA + FFN + 2x layernorm."""
    g = Graph("transformer_block")
    hd = d // heads
    x = g.add_input("x", (seq, d), DT)

    def heads_of(t: str, name: str) -> str:
        r = g.add_op("reshape", [t], name=f"{name}_split",
                     shape=(seq, heads, hd))
        return g.add_op("transpose", [r], name=f"{name}_perm", perm=(1, 0, 2))

    q = heads_of(_dense(g, x, d, d, "wq", relu=False), "q")
    k = heads_of(_dense(g, x, d, d, "wk", relu=False), "k")
    v = heads_of(_dense(g, x, d, d, "wv", relu=False), "v")
    kt = g.add_op("transpose", [k], name="kT", perm=(0, 2, 1))
    scores = g.add_op("batch_matmul", [q, kt], name="qk")
    scale = g.add_param("attn_scale", (1,), DT)
    scores = g.add_op("mul", [scores, scale], name="qk_scaled")
    attn = g.add_op("softmax", [scores], name="attn")
    ctx = g.add_op("batch_matmul", [attn, v], name="ctx")
    ctx = g.add_op("transpose", [ctx], name="ctx_perm", perm=(1, 0, 2))
    ctx = g.add_op("reshape", [ctx], name="ctx_merge", shape=(seq, d))
    proj = _dense(g, ctx, d, d, "wo", relu=False)
    h = g.add_op("add", [proj, x], name="res1")
    ln1_g = g.add_param("ln1_g", (d,), DT)
    ln1_b = g.add_param("ln1_b", (d,), DT)
    h = g.add_op("layernorm", [h, ln1_g, ln1_b], name="ln1")
    f = _dense(g, h, d, ffn, "ffn1", relu=False)
    f = g.add_op("gelu", [f], name="ffn_act")
    f = _dense(g, f, ffn, d, "ffn2", relu=False)
    y = g.add_op("add", [f, h], name="res2")
    ln2_g = g.add_param("ln2_g", (d,), DT)
    ln2_b = g.add_param("ln2_b", (d,), DT)
    y = g.add_op("layernorm", [y, ln2_g, ln2_b], name="ln2")
    g.mark_output(y)
    g.validate()
    return g


MLPERF_TINY = {"autoencoder": autoencoder, "ds_cnn": ds_cnn,
               "mobilenet": mobilenet, "resnet": resnet}
BLOCKS = {"resnet50_block": resnet50_block,
          "resnext50_block": resnext50_block,
          "transformer_block": transformer_block}
ALL_MODELS = {**MLPERF_TINY, **BLOCKS}
