"""The port's flash-attention wrapper on CPU tensors (its plain versions)
against the Pallas kernel in interpret mode over the sweep of
tests/test_kernels.py, the chunked form against the exact one, and the
shapes the Pallas kernel cannot take (ragged S, Dh = 80) against the JAX
package's exact reference.  Then the route a CUDA call would take, and a
model of the tensor-core kernel's rounding held to the same references;
the same for the backward (its route, and a model of the tensor-core
backward's roundings against ``jax.vjp`` of the JAX reference).  Inputs
are made with numpy from a seed and given to both packages."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.flash_attention import \
    flash_attention_pallas
from repro.kernels.flash_attention.ref import attention_ref as jax_ref
from repro_torch.kernels.flash_attention import flash_attention as tfa
from repro_torch.kernels.flash_attention.ref import (NEG_INF,
                                                     attention_chunked,
                                                     attention_mask,
                                                     attention_ref)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": 5e-5, "bfloat16": 2e-2}   # tests/test_kernels.py's

# B, S, H, KV, Dh, causal, window, dtype: tests/test_kernels.py ATTN_SWEEP
ATTN_SWEEP = [
    (2, 256, 4, 2, 64, True, None, "float32"),
    (1, 128, 8, 8, 32, True, 64, "float32"),
    (2, 128, 4, 1, 64, False, None, "float32"),
    (1, 256, 6, 2, 128, True, 96, "float32"),
    (1, 128, 4, 2, 64, True, None, "bfloat16"),
    (1, 512, 2, 2, 64, True, 128, "float32"),
]


def _qkv(seed, B, S, H, KV, Dh, dtype):
    """The same q/k/v as JAX arrays and CPU tensors of ``dtype`` (rounded
    to bf16 once, on the torch side, and carried over)."""
    rng = np.random.default_rng(seed)
    out = []
    for heads in (H, KV, KV):
        x = torch.from_numpy(
            rng.normal(size=(B, S, heads, Dh)).astype(np.float32))
        x = x.to(DTYPES[dtype][1])
        out.append((jnp.asarray(x.float().numpy()).astype(DTYPES[dtype][0]),
                    x))
    return out


def _np(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor)
                      else jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("B,S,H,KV,Dh,causal,win,dtype", ATTN_SWEEP)
def test_flash_attention_matches_pallas(B, S, H, KV, Dh, causal, win,
                                        dtype):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(0, B, S, H, KV, Dh, dtype)
    want = flash_attention_pallas(jq, jk, jv, causal=causal, window=win,
                                  block_q=64, block_k=64, interpret=True)
    before = tfa.launches
    got = tfa.flash_attention(tq, tk, tv, causal=causal, window=win)
    assert tfa.launches == before        # CPU tensors: no kernel
    assert got.dtype == DTYPES[dtype][1] and got.shape == (B, S, H, Dh)
    np.testing.assert_allclose(_np(got), _np(want), atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.parametrize("causal,win", [(True, None), (True, 64),
                                        (False, None), (False, 48)])
def test_chunked_equals_exact(causal, win):
    (_, q), (_, k), (_, v) = _qkv(1, 2, 256, 4, 2, 32, "float32")
    torch.testing.assert_close(
        attention_chunked(q, k, v, causal, win, block_k=64),
        attention_ref(q, k, v, causal, win), atol=2e-5, rtol=2e-5)


def test_long_sequence_takes_the_chunked_form():
    (_, q), (_, k), (_, v) = _qkv(2, 1, 1280, 2, 1, 8, "float32")
    torch.testing.assert_close(tfa.flash_attention(q, k, v, window=300),
                               attention_ref(q, k, v, window=300),
                               atol=2e-5, rtol=2e-5)


# shapes of the serving path the Pallas kernel does not take (it asserts
# S % block == 0): ragged prompts, hubert's Dh = 80, GQA and windows
RAGGED = [
    (1, 77, 8, 2, 16, True, None, "float32"),
    (2, 77, 4, 4, 80, False, None, "float32"),
    (1, 100, 4, 2, 64, True, 33, "float32"),
    (1, 77, 4, 1, 80, False, 20, "bfloat16"),
    (2, 50, 4, 2, 256, True, None, "bfloat16"),
    (1, 65, 2, 1, 8, True, 1, "float32"),
]


@pytest.mark.parametrize("B,S,H,KV,Dh,causal,win,dtype", RAGGED)
def test_ragged_shapes_match_jax_reference(B, S, H, KV, Dh, causal, win,
                                           dtype):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(3, B, S, H, KV, Dh, dtype)
    want = jax_ref(jq, jk, jv, causal=causal, window=win)
    got = tfa.flash_attention(tq, tk, tv, causal=causal, window=win)
    np.testing.assert_allclose(_np(got), _np(want), atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.parametrize("shapes,dtypes,err", [
    (((1, 8, 2, 24), (1, 8, 1, 24)), ("float32",) * 2, ValueError),
    (((1, 8, 3, 16), (1, 8, 2, 16)), ("float32",) * 2, ValueError),
    (((1, 8, 2, 16), (1, 9, 1, 16)), ("float32",) * 2, ValueError),
    (((1, 8, 2, 16), (1, 8, 1, 16)), ("float32", "bfloat16"), TypeError),
    (((8, 2, 16), (8, 1, 16)), ("float32",) * 2, ValueError),
])
def test_rejects_unsupported(shapes, dtypes, err):
    q = torch.zeros(shapes[0], dtype=DTYPES[dtypes[0]][1])
    k = torch.zeros(shapes[1], dtype=DTYPES[dtypes[1]][1])
    with pytest.raises(err):
        tfa.flash_attention(q, k, k)


def test_rejects_negative_window():
    q = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError):
        tfa.flash_attention(q, q, q, window=-1)


def _bf16(*shape, offset=0):
    """A bf16 tensor of ``shape`` whose data starts ``offset`` elements
    into its buffer (rows of the last axis contiguous)."""
    n = math.prod(shape)
    return torch.zeros(n + offset, dtype=torch.bfloat16)[offset:].view(shape)


@pytest.mark.parametrize("Dh", [64, 128, 256])
def test_route_takes_wgmma_for_bf16_serving_shapes(Dh):
    q, k = _bf16(1, 77, 32, Dh), _bf16(1, 77, 8, Dh)
    assert tfa.route(q, k, k) == "wgmma"
    # head slices of one fused projection: strides and offsets of 8 bf16
    qkv = _bf16(2, 100, 12, Dh)
    assert tfa.route(qkv[:, :, :8], qkv[:, :, 8:10], qkv[:, :, 10:]) \
        == "wgmma"


@pytest.mark.parametrize("what", ["fp32", "Dh 80", "Dh 12", "last stride 2",
                                  "head stride 68", "odd element offset",
                                  "k alone misaligned"])
def test_route_takes_simt_for_the_rest(what):
    q, k = _bf16(1, 64, 4, 64), _bf16(1, 64, 2, 64)
    if what == "fp32":
        q, k = q.float(), k.float()
    elif what in ("Dh 80", "Dh 12"):
        dh = int(what.split()[1])
        q, k = _bf16(1, 64, 4, dh), _bf16(1, 64, 2, dh)
    elif what == "last stride 2":
        q = _bf16(1, 64, 4, 128)[..., ::2]
    elif what == "head stride 68":
        q = _bf16(1, 64, 4, 68)[..., :64]
    elif what == "odd element offset":
        q = _bf16(1, 64, 4, 64, offset=1)
    else:
        k = _bf16(1, 64, 2, 64, offset=4)     # 8 bytes: not 16-aligned
    assert tfa.route(q, k, k) == "simt"


@pytest.mark.parametrize("device", ["meta", "cpu"])
@pytest.mark.parametrize("Dh", [64, 128, 256])
def test_route_bwd_takes_wgmma_for_bf16(Dh, device):
    """bf16 Dh 64, 128 and 256 backward on the tensor cores, whatever the
    strides and offsets (the wrapper hands the kernels aligned contiguous
    copies): internlm2-1.8b's training shape, GQA 8, a head slice of a
    fused projection, an odd element offset."""
    def bf16(*shape, offset=0):
        n = math.prod(shape)
        return torch.zeros(n + offset, dtype=torch.bfloat16,
                           device=device)[offset:].view(shape)
    q, k = bf16(4, 1024, 16, Dh), bf16(4, 1024, 8, Dh)
    assert tfa.route_bwd(q, k, k) == "wgmma"
    assert tfa.route_bwd(bf16(1, 40, 8, Dh), bf16(1, 40, 1, Dh),
                         bf16(1, 40, 1, Dh)) == "wgmma"
    qkv = bf16(2, 100, 12, Dh)
    assert tfa.route_bwd(qkv[:, :, :8], qkv[:, :, 8:10],
                         qkv[:, :, 10:]) == "wgmma"
    assert tfa.route_bwd(bf16(1, 64, 4, Dh, offset=1), bf16(1, 64, 2, Dh),
                         bf16(1, 64, 2, Dh)) == "wgmma"


@pytest.mark.parametrize("device", ["meta", "cpu"])
@pytest.mark.parametrize("what", ["fp32", "Dh 16", "Dh 32", "Dh 80", "Dh 8",
                                  "Dh 12", "Dh 96", "fp32 v"])
def test_route_bwd_takes_simt_for_the_rest(what, device):
    """fp32 (no TF32 in its contract) and every head width the tensor-core
    backward does not compile stay on the SIMT kernels."""
    dh = int(what.split()[1]) if what.startswith("Dh") else 64
    q, k, v = (torch.zeros(1, 64, heads, dh, dtype=torch.bfloat16,
                           device=device) for heads in (4, 2, 2))
    if what == "fp32":
        q, k, v = q.float(), k.float(), v.float()
    elif what == "fp32 v":
        v = v.float()
    assert tfa.route_bwd(q, k, v) == "simt"


def _wgmma_bwd_model(q, k, v, do, causal, window):
    """The tensor-core backward's roundings, in fp32 on the CPU: D from
    the forward's bf16 output, P and dS rounded to bf16 before dV = P^T dO,
    dK = scale dS^T Q and dQ = scale dS K (the kernels' register-A
    operands), the gradients rounded to bf16.  Not the kernels' order of
    sums."""
    B, S, H, Dh = q.shape
    KV = k.shape[2]
    scale = 1 / math.sqrt(Dh)
    qh = q.float().reshape(B, S, KV, H // KV, Dh)
    doh = do.float().reshape(B, S, KV, H // KV, Dh)
    out = attention_ref(q, k, v, causal=causal, window=window)
    pos = torch.arange(S)
    mask = attention_mask(pos, pos, causal, window)
    s = torch.einsum("bqkgd,bskd->bkgqs", qh, k.float()) * scale
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    lse = torch.logsumexp(s, -1, keepdim=True)
    p = torch.where(mask, torch.exp(s - lse), torch.zeros_like(s))
    d = (do.float() * out.float()).sum(-1)                  # (B, S, H)
    d = d.reshape(B, S, KV, H // KV).permute(0, 2, 3, 1)[..., None]
    dp = torch.einsum("bqkgd,bskd->bkgqs", doh, v.float())
    ds = (p * (dp - d)).bfloat16().float()
    p = p.bfloat16().float()
    dv = torch.einsum("bkgqs,bqkgd->bskd", p, doh)
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds, qh) * scale
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, k.float()) * scale
    return (dq.reshape(B, S, H, Dh).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


# B, S, H, KV, Dh, causal, window: every head width of the tensor-core
# backward, ragged S (no multiple of its 64-row tile), S below one tile,
# GQA 1, 2 and 8, windows causal and bidirectional, and window 0
WGMMA_BWD = [
    (1, 100, 4, 2, 64, True, None),
    (1, 40, 8, 1, 128, True, None),
    (1, 130, 4, 2, 128, False, 50),
    (1, 97, 2, 1, 256, True, 30),
    (1, 70, 2, 2, 64, True, 0),
]


@pytest.mark.parametrize("B,S,H,KV,Dh,causal,win", WGMMA_BWD)
def test_wgmma_bwd_rounding_within_tolerance(B, S, H, KV, Dh, causal, win):
    """P and dS in bf16 (the tensor-core backward's register operands)
    stay within the backward kernels' bf16 tolerance (2e-2 of the largest
    |gradient|) of jax.vjp of the JAX package's exact reference in fp32.
    Window 0 gives gradients of exactly 0, as the port's plain backward
    does (its forward, like the kernels, outputs 0 for a row that attends
    no key; the JAX reference's softmax spreads such a row evenly)."""
    (jq, tq), (jk, tk), (jv, tv) = _qkv(6, B, S, H, KV, Dh, "bfloat16")
    rng = np.random.default_rng(7)
    tdo = torch.from_numpy(rng.normal(size=(B, S, H, Dh)).astype(
        np.float32)).bfloat16()
    f32 = [jnp.asarray(x, jnp.float32) for x in (jq, jk, jv)]
    _, vjp = jax.vjp(lambda q, k, v: jax_ref(q, k, v, causal=causal,
                                             window=win), *f32)
    want = vjp(jnp.asarray(tdo.float().numpy()))
    got = _wgmma_bwd_model(tq, tk, tv, tdo, causal, win)
    if win == 0:
        want = tfa.attention_bwd_ref(tq, tk, tv, tdo, causal, win)
        assert all(torch.count_nonzero(w) == 0 for w in want)
    for name, a, b in zip("qkv", got, want):
        assert a.dtype == torch.bfloat16
        if win == 0:
            assert torch.count_nonzero(a) == 0, name
            continue
        b = np.asarray(b)
        err = np.abs(_np(a) - b).max() / np.abs(b).max()
        assert err <= 2e-2, f"d{name}: {err}"


def _wgmma_model(q, k, v, causal, window):
    """The tensor-core kernel's rounding, in fp32 on the CPU: the
    unnormalised probabilities p = exp(s - max) rounded to bf16 before
    P.V (the kernel's A operand), the row sums of the unrounded p, the
    output rounded to q's dtype.  Not the kernel's order of sums."""
    B, S, H, Dh = q.shape
    KV = k.shape[2]
    qh = q.float().reshape(B, S, KV, H // KV, Dh)
    s = torch.einsum("bqkgd,bskd->bkgqs", qh, k.float()) / math.sqrt(Dh)
    pos = torch.arange(S)
    mask = attention_mask(pos, pos, causal, window)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.where(mask, torch.exp(s - s.amax(-1, keepdim=True)),
                    torch.zeros_like(s))
    l = p.sum(-1, keepdim=True).clamp(min=1e-30)
    ctx = torch.einsum("bkgqs,bskd->bkgqd", p.bfloat16().float(),
                       v.float()) / l
    return ctx.permute(0, 3, 1, 2, 4).reshape(B, S, H, Dh).to(q.dtype)


# B, S, H, KV, Dh, causal, window, block: the sweep's bf16 case, then
# qwen3-8b's GQA 4:1 at Dh 128, narrowed to S 256
MODEL_VS_PALLAS = [
    (1, 128, 4, 2, 64, True, None, 64),
    (1, 256, 8, 2, 128, True, None, 128),
]


@pytest.mark.parametrize("B,S,H,KV,Dh,causal,win,block", MODEL_VS_PALLAS)
def test_wgmma_rounding_within_pallas_tolerance(B, S, H, KV, Dh, causal, win,
                                                block):
    """P in bf16 (the tensor-core P.V) stays within the reference's own
    bf16 tolerance of the Pallas kernel, which keeps P in fp32."""
    (jq, tq), (jk, tk), (jv, tv) = _qkv(4, B, S, H, KV, Dh, "bfloat16")
    want = flash_attention_pallas(jq, jk, jv, causal=causal, window=win,
                                  block_q=block, block_k=block,
                                  interpret=True)
    got = _wgmma_model(tq, tk, tv, causal, win)
    np.testing.assert_allclose(_np(got), _np(want), atol=TOL["bfloat16"],
                               rtol=TOL["bfloat16"])


def test_wgmma_rounding_within_tolerance_at_dh256_window():
    """recurrentgemma-2b's Dh 256 local attention narrowed to S 320 and a
    window of 64 (S is no multiple of the Pallas kernel's block, so the
    JAX package's exact reference holds it)."""
    (jq, tq), (jk, tk), (jv, tv) = _qkv(5, 1, 320, 4, 1, 256, "bfloat16")
    want = jax_ref(jq, jk, jv, causal=True, window=64)
    got = _wgmma_model(tq, tk, tv, True, 64)
    np.testing.assert_allclose(_np(got), _np(want), atol=TOL["bfloat16"],
                               rtol=TOL["bfloat16"])
