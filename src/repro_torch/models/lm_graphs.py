"""Sequence-parameterized IR graphs for the autoregressive LM tenants.

The JAX models in :mod:`repro.models.rwkv6` / :mod:`repro.models.rglru` /
:mod:`repro.models.transformer` are numeric reference implementations;
what the co-scheduler needs is each tenant's *compute shape* as an IR
:class:`~repro.core.ir.Graph` it can tile, arbitrate and schedule next
to the vision tenants.  These builders materialize one block of each
family at an arbitrary sequence length — the knob a
:class:`~repro.core.shapes.ShapeBucketSpec` turns: a prefill bucket
builds the graph at ``seq`` tokens, the decode bucket at ``seq == 1``.

Two properties the shape-bucketed stack relies on:

  * **Parameters are sequence-independent.**  Every parameter tensor is
    a channel-space weight (dense projections, norm scales), so the
    params initialized from the default-bucket graph execute bitwise
    against every bucket's graph — one resident weight set serves
    prefill and decode, which is exactly why decode rounds are
    DMA-light and co-schedule well against a vision tenant's bulk
    compute.
  * **Ops come from the proven subset** (dense / elementwise /
    batch_matmul / softmax / norm / reshape / transpose) that the
    tiling CP, scheduler and numeric runtime already exercise end to
    end; the recurrence of RWKV6 / RG-LRU is proxied by its
    channel-mixing cost profile (token-shift becomes a learned
    two-stream blend), not by a sequential scan the dataflow IR cannot
    express.
"""

from __future__ import annotations

from typing import Tuple

from repro_torch.core.ir import Graph
from repro_torch.core.shapes import ShapeBucketSpec, pow2_buckets

DT = "float16"


def _dense(g: Graph, x: str, cin: int, cout: int, name: str,
           bias: bool = True) -> str:
    w = g.add_param(f"{name}_w", (cin, cout), DT)
    y = g.add_op("dense", [x, w], name=name)
    if bias:
        b = g.add_param(f"{name}_b", (cout,), DT)
        y = g.add_op("bias_add", [y, b], name=f"{name}_bias")
    return y


def _time_mix(g: Graph, x: str, d: int, name: str) -> str:
    """Learned two-stream blend standing in for the token shift: the
    elementwise cost profile of ``x*mu + shift(x)*(1-mu)`` with
    sequence-independent parameters."""
    mu = g.add_param(f"{name}_mu", (d,), DT)
    nu = g.add_param(f"{name}_nu", (d,), DT)
    a = g.add_op("mul", [x, mu], name=f"{name}_a")
    b = g.add_op("mul", [x, nu], name=f"{name}_b")
    return g.add_op("add", [a, b], name=name)


def rwkv6_lm(seq: int = 64, d: int = 128, ffn: int = 256) -> Graph:
    """One RWKV6 block: token-shifted r/k/v/g projections, the WKV
    mixing stage (channel-mix proxy of the linear-attention recurrence),
    a sigmoid output gate, and the squared-ReLU channel-mix FFN."""
    g = Graph(f"rwkv6-lm@s{seq}")
    x = g.add_input("x", (seq, d), DT)
    xm = _time_mix(g, x, d, "tshift")
    r = _dense(g, xm, d, d, "wr", bias=False)
    k = _dense(g, xm, d, d, "wk", bias=False)
    v = _dense(g, xm, d, d, "wv", bias=False)
    gate = _dense(g, xm, d, d, "wg", bias=False)
    kv = g.add_op("mul", [k, v], name="kv")
    acc = _dense(g, kv, d, d, "wkv_mix", bias=False)
    rs = g.add_op("sigmoid", [r], name="r_sig")
    wkv = g.add_op("mul", [rs, acc], name="wkv")
    gs = g.add_op("sigmoid", [gate], name="g_sig")
    gated = g.add_op("mul", [wkv, gs], name="gated")
    y = _dense(g, gated, d, d, "wo", bias=False)
    h = g.add_op("add", [y, x], name="res1")
    ln_g = g.add_param("ln_g", (d,), DT)
    h = g.add_op("rmsnorm", [h, ln_g], name="ln")
    cm = _time_mix(g, h, d, "cshift")
    f = _dense(g, cm, d, ffn, "cm_k", bias=False)
    f = g.add_op("relu", [f], name="cm_relu")
    f = g.add_op("mul", [f, f], name="cm_sq")      # squared ReLU
    f = _dense(g, f, ffn, d, "cm_v", bias=False)
    rg = g.add_op("sigmoid", [_dense(g, cm, d, d, "cm_r", bias=False)],
                  name="cm_rsig")
    f = g.add_op("mul", [f, rg], name="cm_gated")
    out = g.add_op("add", [f, h], name="res2")
    g.mark_output(out)
    g.validate()
    return g


def rglru_lm(seq: int = 64, d: int = 128, ffn: int = 256) -> Graph:
    """One Griffin-style RG-LRU block: a two-tap temporal conv proxy,
    the gated recurrence (recurrence gate x input gate over the conv
    stream), a GeLU side gate, and the gated-MLP channel block."""
    g = Graph(f"rglru-lm@s{seq}")
    x = g.add_input("x", (seq, d), DT)
    c1 = _dense(g, x, d, d, "conv_a", bias=False)
    c2 = _dense(g, _time_mix(g, x, d, "conv_shift"), d, d, "conv_b",
                bias=False)
    conv = g.add_op("add", [c1, c2], name="conv")
    rg = g.add_op("sigmoid", [_dense(g, x, d, d, "rg", bias=False)],
                  name="rg_sig")
    ig = g.add_op("sigmoid", [_dense(g, x, d, d, "ig", bias=False)],
                  name="ig_sig")
    h = g.add_op("mul", [conv, ig], name="h_in")
    h = g.add_op("mul", [h, rg], name="h_rec")
    h = g.add_op("tanh", [h], name="h_act")
    side = g.add_op("gelu", [_dense(g, x, d, d, "side", bias=False)],
                    name="side_gelu")
    mixed = g.add_op("mul", [h, side], name="mix")
    y = _dense(g, mixed, d, d, "wo", bias=False)
    h1 = g.add_op("add", [y, x], name="res1")
    ln_g = g.add_param("ln_g", (d,), DT)
    h1 = g.add_op("rmsnorm", [h1, ln_g], name="ln")
    u = _dense(g, h1, d, ffn, "mlp_u", bias=False)
    gte = g.add_op("gelu", [_dense(g, h1, d, ffn, "mlp_g", bias=False)],
                   name="mlp_gelu")
    f = g.add_op("mul", [u, gte], name="mlp_mix")
    f = _dense(g, f, ffn, d, "mlp_d", bias=False)
    out = g.add_op("add", [f, h1], name="res2")
    g.mark_output(out)
    g.validate()
    return g


def transformer_lm(seq: int = 64, d: int = 128, heads: int = 4,
                   ffn: int = 256) -> Graph:
    """One decoder layer: MHA (batched QK^T / softmax / AV) + FFN with
    pre-norm residuals — the prefill-heavy tenant (attention cost grows
    quadratically with the bucket)."""
    g = Graph(f"transformer-lm@s{seq}")
    hd = d // heads
    x = g.add_input("x", (seq, d), DT)

    def heads_of(t: str, name: str) -> str:
        r = g.add_op("reshape", [t], name=f"{name}_split",
                     shape=(seq, heads, hd))
        return g.add_op("transpose", [r], name=f"{name}_perm",
                        perm=(1, 0, 2))

    q = heads_of(_dense(g, x, d, d, "wq", bias=False), "q")
    k = heads_of(_dense(g, x, d, d, "wk", bias=False), "k")
    v = heads_of(_dense(g, x, d, d, "wv", bias=False), "v")
    kt = g.add_op("transpose", [k], name="kT", perm=(0, 2, 1))
    scores = g.add_op("batch_matmul", [q, kt], name="qk")
    scale = g.add_param("attn_scale", (1,), DT)
    scores = g.add_op("mul", [scores, scale], name="qk_scaled")
    attn = g.add_op("softmax", [scores], name="attn")
    ctx = g.add_op("batch_matmul", [attn, v], name="ctx")
    ctx = g.add_op("transpose", [ctx], name="ctx_perm", perm=(1, 0, 2))
    ctx = g.add_op("reshape", [ctx], name="ctx_merge", shape=(seq, d))
    proj = _dense(g, ctx, d, d, "wo", bias=False)
    h = g.add_op("add", [proj, x], name="res1")
    ln1_g = g.add_param("ln1_g", (d,), DT)
    ln1_b = g.add_param("ln1_b", (d,), DT)
    h = g.add_op("layernorm", [h, ln1_g, ln1_b], name="ln1")
    f = _dense(g, h, d, ffn, "ffn1", bias=False)
    f = g.add_op("gelu", [f], name="ffn_act")
    f = _dense(g, f, ffn, d, "ffn2", bias=False)
    y = g.add_op("add", [f, h], name="res2")
    ln2_g = g.add_param("ln2_g", (d,), DT)
    ln2_b = g.add_param("ln2_b", (d,), DT)
    y = g.add_op("layernorm", [y, ln2_g, ln2_b], name="ln2")
    g.mark_output(y)
    g.validate()
    return g


LM_FAMILIES = {
    "rwkv6": rwkv6_lm,
    "rglru": rglru_lm,
    "transformer": transformer_lm,
}


def lm_tenant(family: str, max_seq: int = 64, min_bucket: int = 1,
              **kw) -> Tuple[Graph, ShapeBucketSpec]:
    """``(default graph, bucket spec)`` for one LM tenant: power-of-two
    buckets from ``min_bucket`` (1 = the decode bucket) to ``max_seq``,
    default at ``max_seq`` (the prefill shape the tenant registers with
    the :class:`~repro.core.deploy.CompileRequest`)."""
    if family not in LM_FAMILIES:
        raise ValueError(f"unknown LM family {family!r}; expected one of "
                         f"{sorted(LM_FAMILIES)}")
    build = LM_FAMILIES[family]

    def make_graph(seq: int) -> Graph:
        return build(seq=seq, **kw)

    spec = ShapeBucketSpec(buckets=pow2_buckets(min_bucket, max_seq),
                           make_graph=make_graph, default=max_seq)
    return make_graph(max_seq), spec
