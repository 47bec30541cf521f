"""The port's CUDA kernels against their plain torch versions, on the card.

Marked ``gpu``: each test skips (inside the test, never at collection)
when no CUDA device is visible.  On a machine with an H100 run

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import flash_attention as fa
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.grouped_matmul import grouped_matmul as gmm
from repro_torch.kernels.grouped_matmul.ref import (grouped_matmul_bwd_ref,
                                                    grouped_matmul_ref)
from repro_torch.kernels.matmul import matmul as mm
from repro_torch.kernels.matmul.ref import matmul_ref
from repro_torch.kernels.rglru_scan import rglru_scan as scan
from repro_torch.kernels.rglru_scan.ref import rglru_bwd_ref, rglru_ref
from repro_torch.kernels.rmsnorm import rmsnorm as rms
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
from repro_torch.kernels.rwkv_scan import rwkv_scan as wkv
from repro_torch.kernels.rwkv_scan.ref import wkv6_bwd_ref, wkv6_ref

pytestmark = pytest.mark.gpu

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _randn(shape, dtype, device, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    return x.to(device=device, dtype=DTYPES[dtype])


def _close(got, want, atol, rtol):
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


# M, K, N, column offset of B inside a wider weight (None: contiguous), the
# route in fp32 and in bf16: decode (M 1) and bucket (8, 9, 16, 32, 64)
# rows of the runtime's column slices at K 2560 and 8960, the rwkv6
# tenant's decode down-projection over a whole weight (1 x 8960 x 2560,
# phase c), ragged K 33 (A rows not 16-byte aligned), offsets of 3
# columns (no route reads them in vectors) and 4 columns (16 bytes in
# fp32, 8 in bf16), two row tiles
MM_CASES = [
    (1, 2560, 48, 32, "gemv", "gemv"), (1, 8960, 4480, 0, "gemv", "gemv"),
    (1, 8960, 2560, 0, "gemv", "gemv"),
    (8, 2560, 1280, 640, "gemv", "gemv"),
    (9, 2560, 1280, 640, "tile", "tile"),
    (16, 8960, 48, 32, "tile", "tile"), (32, 2560, 64, 0, "tile", "tile"),
    (64, 2560, 1280, 640, "tile", "tile"),
    (64, 8960, 4480, None, "tile", "tile"),
    (64, 8960, 48, 4, "tile", "scalar"),
    (1, 2560, 1280, 3, "scalar", "scalar"),
    (64, 2560, 1280, 3, "scalar", "scalar"),
    (8, 33, 64, None, "gemv", "gemv"), (9, 33, 64, None, "scalar", "scalar"),
    (1, 33, 65, None, "scalar", "scalar"),
    (7, 33, 65, None, "scalar", "scalar"),
    (128, 128, 128, None, "tile", "tile"),
]


def _mm_operands(M, K, N, off, dtype, seed=0):
    a = _randn((M, K), dtype, "cuda", seed)
    if off is None:
        return a, _randn((K, N), dtype, "cuda", seed + 1)
    w = _randn((K, off + N + 16), dtype, "cuda", seed + 1)
    return a, w[:, off:off + N]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,K,N,off,r32,r16", MM_CASES)
def test_matmul_kernel_matches_plain(cuda, M, K, N, off, r32, r16, dtype):
    """Each call launches once, on the route route() names."""
    a, b = _mm_operands(M, K, N, off, dtype)
    want_route = r32 if dtype == "float32" else r16
    assert mm.route(a, b) == want_route
    before, routes = mm.launches, dict(mm.routes)
    got = mm.matmul(a, b)
    assert mm.launches == before + 1
    assert mm.routes == {**routes, want_route: routes[want_route] + 1}
    tol = 1e-4 if dtype == "float32" else 5e-2
    _close(got, matmul_ref(a, b), tol * math.sqrt(K), tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batched_matmul_kT_view(cuda, dtype):
    q = _randn((4, 64, 32), dtype, cuda, 2)
    kt = _randn((4, 64, 32), dtype, cuda, 3).transpose(1, 2)
    assert mm.route(q, kt) == "scalar"
    tol = 1e-4 if dtype == "float32" else 5e-2
    _close(mm.matmul(q, kt), matmul_ref(q, kt), tol * math.sqrt(32), tol)


# one shape per route, K split into several chunks on each, and one unsplit
@pytest.mark.parametrize("M,K,N,off,want", [
    (64, 2560, 1280, None, "tile"), (1, 8960, 4480, 0, "gemv"),
    (4, 2560, 48, 32, "gemv"), (64, 2560, 1280, 3, "scalar"),
    (64, 64, 64, None, "tile"),
])
def test_matmul_is_deterministic(cuda, M, K, N, off, want):
    """Two calls give the same bits on every route: the chunks' partial
    sums are added in chunk order, with no atomics."""
    a, b = _mm_operands(M, K, N, off, "float32", 4)
    assert mm.route(a, b) == want
    splits = mm.plan(want, M, N, K,
                     torch.cuda.get_device_properties(0)
                     .multi_processor_count)[0]
    assert (splits > 1) == (K > 64)
    before = mm.sum_launches
    got = mm.matmul(a, b)
    assert mm.sum_launches == before + (splits > 1)
    assert torch.equal(got, mm.matmul(a, b))
    _close(got, matmul_ref(a, b), 1e-4 * math.sqrt(K), 1e-4)


# width -> (fp32 route, bf16 route): rwkv6's ln_x (64), qwen3's q/k-norm
# (128), a width bf16 vectors cannot tile (100), the wide rows of olmoe
# (2048), rwkv6/recurrentgemma (2560) and qwen3 (4096), 2 and 4 vectors a
# lane on the warp route (1024 bf16, 512 fp32), the block route's 2 and 4
# vectors a thread, and past it (16400 fp32)
RMS_WIDTHS = {64: ("warp", "warp"), 96: ("warp", "warp"),
              100: ("warp", "scalar"), 128: ("warp", "warp"),
              512: ("warp", "warp"), 1024: ("block", "warp"),
              2048: ("block", "block"), 2560: ("block", "block"),
              4096: ("block", "block"), 8200: ("block", "block"),
              16400: ("scalar", "block")}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(64, 2560), (1, 2560), (3, 5, 96),
                                   (37, 64), (9, 100), (33, 128), (5, 4096),
                                   (3, 512), (4, 1024), (2, 2048), (3, 8200),
                                   (2, 16400)])
@pytest.mark.parametrize("gain", [True, False])
def test_rmsnorm_kernel_matches_plain(cuda, shape, dtype, gain):
    x = _randn(shape, dtype, cuda, 6)
    g = _randn(shape[-1:], dtype, cuda, 7) if gain else None
    want_route = RMS_WIDTHS[shape[-1]][dtype == "bfloat16"]
    assert rms.route(x, g) == want_route
    before, routes = rms.launches, dict(rms.routes)
    got = rms.rmsnorm(x, g)
    assert rms.launches == before + 1
    assert rms.routes == {**routes, want_route: routes[want_route] + 1}
    tol = 1e-5 if dtype == "float32" else 2e-2
    _close(got, rmsnorm_ref(x, g), tol, tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_misaligned_slice(cuda, dtype):
    """Rows that start 2 or 4 bytes past a 16-byte boundary take the
    scalar route."""
    x = _randn((50, 136), dtype, cuda, 12)[:, 1:129]
    g = _randn((128,), dtype, cuda, 13)
    assert rms.route(x, g) == "scalar"
    tol = 1e-5 if dtype == "float32" else 2e-2
    _close(rms.rmsnorm(x, g), rmsnorm_ref(x, g), tol, tol)


# (rows, width, dtype, route): a row's result may not depend on the rows
# around it, on each route
RMS_ROW_CASES = [(163840 // 16, 64, "bfloat16", "warp"),
                 (4000, 128, "bfloat16", "warp"),
                 (777, 512, "float32", "warp"),
                 (300, 2560, "bfloat16", "block"),
                 (129, 4096, "float32", "block"),
                 (200, 100, "bfloat16", "scalar")]


@pytest.mark.parametrize("rows,d,dtype,want", RMS_ROW_CASES)
def test_rmsnorm_row_alone_is_bitwise_equal(cuda, rows, d, dtype, want):
    """Row i of a many-row call (prefill) is bitwise the one-row call on
    that row (decode), and two many-row calls agree bitwise."""
    x = _randn((rows, d), dtype, cuda, 14)
    g = _randn((d,), dtype, cuda, 15)
    assert rms.route(x, g) == want
    assert rms.route(x[5:6], g) == want
    many = rms.rmsnorm(x, g)
    assert torch.equal(many, rms.rmsnorm(x, g))
    for i in (0, 1, rows // 2, rows - 1):
        assert torch.equal(rms.rmsnorm(x[i:i + 1], g)[0], many[i]), i
    tol = 1e-5 if dtype == "float32" else 2e-2
    _close(many, rmsnorm_ref(x, g), tol, tol)


# B, S, H, KV, Dh, causal, window: tests/test_kernels.py's sweep, then the
# serving shapes of qwen3-8b, gemma3-12b's local layers and hubert-xlarge
ATTN_CASES = [
    (2, 256, 4, 2, 64, True, None), (1, 128, 8, 8, 32, True, 64),
    (2, 128, 4, 1, 64, False, None), (1, 256, 6, 2, 128, True, 96),
    (1, 128, 4, 2, 64, True, None), (1, 512, 2, 2, 64, True, 128),
    (1, 77, 32, 8, 128, True, None), (1, 1000, 32, 8, 128, True, None),
    (2, 128, 32, 8, 128, True, None),
    (1, 2048, 16, 8, 256, True, 1024), (1, 500, 16, 16, 80, False, None),
    (2, 77, 4, 2, 8, True, None), (1, 65, 4, 4, 16, False, 7),
    (2, 40, 4, 2, 12, True, None),       # granite-moe SMOKE's head width
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,KV,Dh,causal,win", ATTN_CASES)
def test_flash_attention_kernel_matches_plain(cuda, B, S, H, KV, Dh, causal,
                                              win, dtype):
    """Each call launches once, on the route route() names: bf16 with Dh
    64, 128 or 256 on the tensor cores, the rest on the SIMT kernel."""
    q = _randn((B, S, H, Dh), dtype, cuda, 8)
    k = _randn((B, S, KV, Dh), dtype, cuda, 9)
    v = _randn((B, S, KV, Dh), dtype, cuda, 10)
    want_route = ("wgmma" if dtype == "bfloat16" and Dh in (64, 128, 256)
                  else "simt")
    assert fa.route(q, k, v) == want_route
    before, routes = fa.launches, dict(fa.routes)
    got = fa.flash_attention(q, k, v, causal=causal, window=win)
    assert fa.launches == before + 1
    assert fa.routes == {**routes, want_route: routes[want_route] + 1}
    tol = 5e-5 if dtype == "float32" else 2e-2
    _close(got, attention_ref(q, k, v, causal=causal, window=win), tol, tol)


# masks of the wgmma instances: (causal, window); the window's non-causal
# form too
FA_MASKS = {"causal": (True, None), "window": (True, 48),
            "bidirectional": (False, None), "window both ways": (False, 40)}
# S -> (GQA ratio, B): ragged edges of the 128-row query tiles and of the
# 64- and 128-key tiles, the ratios of qwen3-8b (4) and recurrentgemma-2b
# (10) and none, one and two sequences
FA_SHAPES = {1: (1, 2), 63: (4, 1), 65: (10, 2), 129: (1, 1), 1000: (4, 2)}


@pytest.mark.parametrize("S", sorted(FA_SHAPES))
@pytest.mark.parametrize("mask", sorted(FA_MASKS))
@pytest.mark.parametrize("Dh", [64, 128, 256])
def test_flash_attention_wgmma_every_instance(cuda, Dh, mask, S):
    """Each of the wgmma route's kernel instances (Dh 64, 128, 256) held
    to the plain version under every mask, at ragged S, GQA and B."""
    causal, win = FA_MASKS[mask]
    ratio, B = FA_SHAPES[S]
    KV = 2
    q = _randn((B, S, ratio * KV, Dh), "bfloat16", cuda, 27)
    k = _randn((B, S, KV, Dh), "bfloat16", cuda, 28)
    v = _randn((B, S, KV, Dh), "bfloat16", cuda, 29)
    assert fa.route(q, k, v) == "wgmma"
    before = fa.routes["wgmma"]
    got = fa.flash_attention(q, k, v, causal=causal, window=win)
    assert fa.routes["wgmma"] == before + 1
    _close(got, attention_ref(q, k, v, causal=causal, window=win), 2e-2,
           2e-2)


@pytest.mark.parametrize("Dh", [64, 128, 256])
def test_flash_attention_wgmma_one_hot_probe(cuda, Dh):
    """Query row r attends one key t(r) only (score +A^2 / sqrt(Dh) against
    0 and -A^2 for the rest), and v[s, c] = (7 s + c) mod 255 + 1, so
    each output names the (key, column) it read and must equal v[t(r), c]
    bitwise (the other keys' p, at most 2^-92, vanish in rounding beside a
    value of 1 or more): a wrong P fragment, V descriptor or swizzle shows
    as the wrong integer."""
    S, A = 128, 32.0
    s = torch.arange(S, device=cuda)
    sign = torch.where(s < 64, 1.0, -1.0)
    k = torch.zeros(1, S, 1, Dh, device=cuda)
    k[0, s, 0, s % 64] = A * sign
    t = (37 * s + 11) % S                      # a permutation of the keys
    q = torch.zeros(1, S, 1, Dh, device=cuda)
    q[0, s, 0, t % 64] = A * sign[t]
    v = ((7 * s[:, None] + torch.arange(Dh, device=cuda)) % 255 + 1).float()
    q, k, v = (x.bfloat16() for x in (q, k, v[None, :, None, :]))
    assert fa.route(q, k, v) == "wgmma"
    got = fa.flash_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    want = v[:, t]
    bad = (got != want).nonzero().tolist()
    assert not bad, (f"{len(bad)} outputs differ; first (b, row, head, "
                     f"col): got / want " + ", ".join(
                         f"{i}: {got[tuple(i)].item()} / "
                         f"{want[tuple(i)].item()}" for i in bad[:8]))


def test_flash_attention_strided_and_deterministic(cuda):
    """q/k/v as head-slices of one fused projection (strided rows)."""
    qkv = _randn((2, 100, 12, 64), "float32", cuda, 11)
    q, k, v = qkv[:, :, :8], qkv[:, :, 8:10], qkv[:, :, 10:]
    got = fa.flash_attention(q, k, v)
    assert torch.equal(got, fa.flash_attention(q, k, v))
    _close(got, attention_ref(q, k, v), 5e-5, 5e-5)


@pytest.mark.parametrize("Dh", [64, 128, 256])
def test_flash_attention_wgmma_strided_and_deterministic(cuda, Dh):
    """bf16 q/k/v as head-slices of one fused projection: the tensor maps
    read them through their strides, and two calls give the same bits."""
    qkv = _randn((2, 300, 12, Dh), "bfloat16", cuda, 30)
    q, k, v = qkv[:, :, :8], qkv[:, :, 8:10], qkv[:, :, 10:]
    assert fa.route(q, k, v) == "wgmma"
    before = fa.routes["wgmma"]
    got = fa.flash_attention(q, k, v)
    assert torch.equal(got, fa.flash_attention(q, k, v))
    assert fa.routes["wgmma"] == before + 2
    _close(got, attention_ref(q, k, v), 2e-2, 2e-2)


def test_flash_attention_wgmma_olmoe_prefill(cuda):
    """olmoe-1b-7b's 4096-token prefill: H 16 = KV 16, Dh 128, causal."""
    q = _randn((1, 4096, 16, 128), "bfloat16", cuda, 31)
    k = _randn((1, 4096, 16, 128), "bfloat16", cuda, 32)
    v = _randn((1, 4096, 16, 128), "bfloat16", cuda, 33)
    assert fa.route(q, k, v) == "wgmma"
    _close(fa.flash_attention(q, k, v), attention_ref(q, k, v), 2e-2, 2e-2)


@pytest.mark.parametrize("arch", ["qwen3-8b", "gemma3-12b", "hubert-xlarge"])
def test_transformer_on_card_matches_cpu(cuda, arch):
    """The SMOKE model in fp32 on the card against the same params on the
    CPU: forward, prefill and two decode steps."""
    from repro_torch.configs import registry
    from repro_torch.models import stacking, transformer
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(registry.get_smoke_config(arch),
                              dtype="float32")
    cpu = transformer.init(torch.Generator().manual_seed(0), cfg, "cpu")
    dev = stacking.tree_map(lambda t: t.to(cuda), cpu)
    rng = np.random.default_rng(0)
    if cfg.input_kind == "tokens":
        x = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 42)))
    else:
        x = torch.from_numpy(rng.normal(size=(2, 42, cfg.d_model))
                             .astype(np.float32))
    before = fa.launches
    got = transformer.forward(cfg, dev, x[:, :40].to(cuda))
    assert fa.launches == before + cfg.n_layers
    _close(got.cpu(), transformer.forward(cfg, cpu, x[:, :40]), 1e-4,
           1e-4)
    lg_d, c_d = transformer.prefill(cfg, dev, x[:, :40].to(cuda), 48)
    lg_c, c_c = transformer.prefill(cfg, cpu, x[:, :40], 48)
    _close(lg_d.cpu(), lg_c, 1e-4, 1e-4)
    for t in (40, 41):
        lg_d, c_d = transformer.decode_step(cfg, dev, c_d, x[:, t].to(cuda))
        lg_c, c_c = transformer.decode_step(cfg, cpu, c_c, x[:, t])
        _close(lg_d.cpu(), lg_c, 1e-4, 1e-4)


# B, T, H, D: tests/test_kernels.py's sweep, rwkv6-3b's serving shapes,
# then ragged T and the other head widths
WKV_CASES = [
    (2, 128, 2, 32), (1, 64, 4, 16), (1, 96, 1, 64),
    (1, 77, 40, 64), (1, 1000, 40, 64), (2, 128, 40, 64),
    (1, 33, 3, 128), (2, 5, 2, 16), (3, 1, 2, 32),
]
# y tolerance (the kernel and the plain version sum in other orders in
# fp32; in bf16 one rounding of y may land an ulp apart), S tolerance
WKV_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (1e-2, 1e-3)}


def _wkv_inputs(B, T, H, D, dtype, device, seed, layout="contiguous"):
    """r, k, v, w (Finch decays) and u; ``layout`` "fused" gives r/k/v/w
    as slices of one (B,T,H,4D) projection, "heads-major" as transposed
    views of (B,H,T,D) tensors."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(4, B, T, H, D)).astype(np.float32)
    x[3] = np.exp(-np.exp(x[3] * 0.5))
    u = torch.from_numpy(rng.normal(size=(H, D)).astype(np.float32) * 0.5)
    t = torch.from_numpy(x).to(device=device, dtype=DTYPES[dtype])
    if layout == "fused":
        fused = torch.cat(list(t), dim=-1)                # (B,T,H,4D)
        rkvw = [fused[..., n * D:(n + 1) * D] for n in range(4)]
    elif layout == "heads-major":
        rkvw = [a.transpose(1, 2).contiguous().transpose(1, 2) for a in t]
    else:
        rkvw = list(t)
    return (*rkvw, u.to(device=device, dtype=DTYPES[dtype]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,T,H,D", WKV_CASES)
def test_wkv6_kernel_matches_plain(cuda, B, T, H, D, dtype):
    args = _wkv_inputs(B, T, H, D, dtype, cuda, 12)
    before = wkv.launches
    y, s = wkv.wkv6(*args)
    assert wkv.launches == before + 1
    y0, s0 = wkv6_ref(*args)
    ty, ts = WKV_TOL[dtype]
    _close(y, y0, ty, ty)
    _close(s, s0, ts, ts)


@pytest.mark.parametrize("layout", ["fused", "heads-major"])
def test_wkv6_strided_and_deterministic(cuda, layout):
    """r/k/v/w read through their strides, bitwise equal across calls."""
    args = _wkv_inputs(2, 70, 5, 64, "float32", cuda, 13, layout)
    assert args[0].stride(-1) == 1 and not args[0].is_contiguous()
    y, s = wkv.wkv6(*args)
    y2, s2 = wkv.wkv6(*args)
    assert torch.equal(y, y2) and torch.equal(s, s2)
    y0, s0 = wkv6_ref(*args)
    _close(y, y0, 1e-4, 1e-4)
    _close(s, s0, 1e-4, 1e-4)


def test_wkv6_strong_decays_stay_finite(cuda):
    """Decays down to 1e-4 (where the TPU's chunked form overflows)."""
    r, k, v, _, u = _wkv_inputs(1, 256, 4, 64, "float32", cuda, 14)
    w = torch.rand(r.shape, device=cuda) * 0.05 + 1e-4
    y, s = wkv.wkv6(r, k, v, w, u)
    assert bool(torch.isfinite(y).all() and torch.isfinite(s).all())
    y0, s0 = wkv6_ref(r, k, v, w, u)
    _close(y, y0, 1e-4, 1e-4)
    _close(s, s0, 1e-4, 1e-4)


def _wkv_check(args, dtype, got=None):
    """The kernel's (y, S) on ``args`` (or ``got``) against the plain
    version at WKV_TOL, both finite."""
    y, s = wkv.wkv6(*args) if got is None else got
    assert bool(torch.isfinite(y).all() and torch.isfinite(s).all())
    y0, s0 = wkv6_ref(*args)
    ty, ts = WKV_TOL[dtype]
    _close(y, y0, ty, ty)
    _close(s, s0, ts, ts)


# every compiled instance (head width, columns per block; at D 64 the last
# block of a head is narrower), in both dtypes, over two chunks and a
# ragged tail
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D,cb", sorted(wkv.COLUMN_BLOCK.items()))
def test_wkv6_every_instance(cuda, D, cb, dtype):
    args = _wkv_inputs(2, 2 * wkv.chunk(D) + 5, 3, D, dtype, cuda, 17)
    assert wkv.plan(args[0].shape, args[0].dtype) == cb
    before = wkv.launches
    got = wkv._launch(*args[:4], args[4].float().contiguous())
    assert wkv.launches == before + 1
    _wkv_check(args, dtype, got)


# T at 1, a chunk less one, a chunk, a chunk and one, and rwkv6-3b's
# longest prompt, at the serving shape's plan and at D 128's shorter chunk
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H,D,T", [(40, 64, t) for t in (1, 31, 32, 33,
                                                        4096)]
                         + [(3, 128, t) for t in (15, 16, 17)])
def test_wkv6_chunk_edges(cuda, H, D, T, dtype):
    assert wkv.chunk(D) in (T - 1, T, T + 1) or T in (1, 4096)
    _wkv_check(_wkv_inputs(1, T, H, D, dtype, cuda, 18), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("decay", ["zero", "strong"])
def test_wkv6_extreme_decays(cuda, decay, dtype):
    """w exactly 0 (the state forgets every step) and w in [1e-4, 0.05]:
    finite and within tolerance."""
    r, k, v, _, u = _wkv_inputs(1, 100, 4, 64, dtype, cuda, 19)
    w = (torch.zeros(r.shape, device=cuda) if decay == "zero" else
         torch.rand(r.shape, device=cuda,
                    generator=torch.Generator(cuda).manual_seed(19))
         * (0.05 - 1e-4) + 1e-4).to(DTYPES[dtype])
    _wkv_check((r, k, v, w, u), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wkv6_misaligned_views(cuda, dtype):
    """r/k/v/w at an odd offset in a wider last axis: strides 16-byte
    copies cannot read take the element copies; bitwise repeatable."""
    rng = np.random.default_rng(20)
    x = torch.from_numpy(rng.normal(size=(4, 2, 45, 3, 65))
                         .astype(np.float32)).to(cuda, DTYPES[dtype])
    x[3] = torch.exp(-torch.exp(x[3].float() * 0.5)).to(DTYPES[dtype])
    r, k, v, w = (t[..., 1:] for t in x)
    assert not wkv._vec_ok(r)
    u = torch.from_numpy(rng.normal(size=(3, 64)).astype(np.float32)).to(
        cuda)
    y, s = wkv.wkv6(r, k, v, w, u)
    y2, s2 = wkv.wkv6(r, k, v, w, u)
    assert torch.equal(y, y2) and torch.equal(s, s2)
    _wkv_check((r, k, v, w, u), dtype, (y, s))


# B, T, D: tests/test_kernels.py's sweep, recurrentgemma-2b's serving
# shapes, then ragged T and D
RGLRU_CASES = [
    (2, 256, 384), (1, 128, 64), (3, 64, 96),
    (1, 77, 2560), (1, 1000, 2560), (2, 128, 2560),
    (1, 33, 50), (2, 1, 7),
]


def _rglru_inputs(B, T, D, dtype, device, seed, strided=False):
    rng = np.random.default_rng(seed)
    a = 0.98 / (1.0 + np.exp(-rng.normal(size=(B, T, D))))
    b = rng.normal(size=(B, T, D)) * 0.3
    ab = torch.from_numpy(np.concatenate([a, b], -1).astype(np.float32))
    ab = ab.to(device=device, dtype=DTYPES[dtype])
    if strided:                        # two halves of one (B,T,2D) tensor
        return ab[..., :D], ab[..., D:]
    return ab[..., :D].contiguous(), ab[..., D:].contiguous()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,T,D", RGLRU_CASES)
def test_rglru_kernel_matches_plain(cuda, B, T, D, dtype):
    """The kernel rounds the product and the sum as the plain version
    does, so the two agree to fp32 rounding (and to one bf16 rounding of
    h); h_T is fp32 in both."""
    a, b = _rglru_inputs(B, T, D, dtype, cuda, 15)
    before = scan.launches
    h, h_last = scan.rglru(a, b)
    assert scan.launches == before + 1
    h0, h_last0 = rglru_ref(a, b)
    tol = 1e-6 if dtype == "float32" else 1e-2
    _close(h, h0, tol, tol)
    _close(h_last, h_last0, 1e-6, 1e-6)


def test_rglru_strided_and_deterministic(cuda):
    a, b = _rglru_inputs(2, 300, 2560, "float32", cuda, 16, strided=True)
    assert not a.is_contiguous()
    h, h_last = scan.rglru(a, b)
    h2, h_last2 = scan.rglru(a, b)
    assert torch.equal(h, h2) and torch.equal(h_last, h_last2)
    h0, h_last0 = rglru_ref(a, b)
    _close(h, h0, 1e-6, 1e-6)
    _close(h_last, h_last0, 1e-6, 1e-6)


def _rglru_check(a, b, dtype, got):
    h, h_last = got
    h0, h_last0 = rglru_ref(a, b)
    tol = 1e-6 if dtype == "float32" else 1e-2
    _close(h, h0, tol, tol)
    _close(h_last, h_last0, 1e-6, 1e-6)


# both dtypes, T at 1, a chunk less one, a chunk, a chunk and one, and
# recurrentgemma-2b's longest prompt; D 2560 and a ragged D whose last
# strip is part-filled
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("at", ["1", "chunk-1", "chunk", "chunk+1", "4096"])
@pytest.mark.parametrize("D", [2560, 2568])
def test_rglru_every_strip_and_chunk_edge(cuda, D, at, dtype):
    n = scan.chunk(DTYPES[dtype])
    T = {"1": 1, "chunk-1": n - 1, "chunk": n, "chunk+1": n + 1,
         "4096": 4096}[at]
    a, b = _rglru_inputs(1, T, D, dtype, cuda, 21)
    before = scan.launches
    got = scan._launch(a, b)
    assert scan.launches == before + 1
    _rglru_check(a, b, dtype, got)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rglru_misaligned_views(cuda, dtype):
    """a and b at an odd offset in a wider last axis take the element
    copies; bitwise repeatable."""
    rng = np.random.default_rng(22)
    D = 300
    x = rng.normal(size=(2, 2, 150, D + 1))
    x[0] = 0.98 / (1.0 + np.exp(-x[0]))
    t = torch.from_numpy(x.astype(np.float32)).to(cuda, DTYPES[dtype])
    a, b = t[0][..., 1:], t[1][..., 1:]
    assert not scan._vec_ok(a)
    got = scan.rglru(a, b)
    again = scan.rglru(a, b)
    assert all(torch.equal(g, h) for g, h in zip(got, again))
    _rglru_check(a, b, dtype, got)


@pytest.mark.parametrize("arch", ["rwkv6-3b", "recurrentgemma-2b"])
def test_recurrent_lm_on_card_matches_cpu(cuda, arch):
    """The SMOKE model in fp32 on the card against the same params on the
    CPU: forward (each scan layer launches its kernel once), prefill past
    the local window and two decode steps."""
    from repro_torch.configs import registry
    from repro_torch.models import stacking
    from repro_torch.models.api import get_model
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(registry.get_smoke_config(arch),
                              dtype="float32")
    model = get_model(cfg)
    cpu = model.init(torch.Generator().manual_seed(0), cfg, "cpu")
    dev = stacking.tree_map(lambda t: t.to(cuda), cpu)
    x = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab,
                                                           (2, 42)))
    kinds = [cfg.layer_kind(i) for i in range(cfg.n_layers)]
    counts = (wkv.launches, scan.launches, fa.launches)
    got = model.forward(cfg, dev, x[:, :40].to(cuda))
    assert (wkv.launches - counts[0], scan.launches - counts[1],
            fa.launches - counts[2]) == (
        cfg.n_layers if cfg.family == "ssm" else 0, kinds.count("rec"),
        kinds.count("attn"))
    _close(got.cpu(), model.forward(cfg, cpu, x[:, :40]), 1e-4, 1e-4)
    lg_d, c_d = model.prefill(cfg, dev, x[:, :40].to(cuda), 48)
    lg_c, c_c = model.prefill(cfg, cpu, x[:, :40], 48)
    _close(lg_d.cpu(), lg_c, 1e-4, 1e-4)
    for t in (40, 41):
        lg_d, c_d = model.decode_step(cfg, dev, c_d, x[:, t].to(cuda))
        lg_c, c_c = model.decode_step(cfg, cpu, c_c, x[:, t])
        _close(lg_d.cpu(), lg_c, 1e-4, 1e-4)
    stacking.tree_map(lambda a, b: _close(a.cpu(), b, 1e-4, 1e-4), c_d, c_c)


# E, C, D, F: olmoe-1b-7b decode (C = 8) and prefill of 1000 tokens (gate
# and down, C = 160) and of 4096 (C = 648: three tiles of 216 rows on the
# wgmma route), granite-moe-3b-a800m at 1000 tokens, the SMOKE widths,
# then ragged C, D and F (no multiple of a tile), then the wgmma route's
# tile edges: C 16, 17, 24, 216, 217, 256 (one tile) and 257 (two), and
# ragged D 1000 and F 200 that are multiples of 8; last, the rest of
# olmoe-1b-7b's serving shapes: 48 rows (S 256, or two 128-token prompts)
# gate and down, and the down GEMM at 8, 16 and 648 rows
GMM_CASES = [
    (64, 8, 2048, 1024), (64, 160, 2048, 1024), (64, 160, 1024, 2048),
    (64, 648, 2048, 1024), (40, 256, 1536, 512), (5, 16, 48, 32),
    (5, 40, 33, 65), (40, 17, 100, 7),
    (4, 16, 256, 192), (4, 17, 256, 192), (4, 24, 256, 192),
    (4, 216, 256, 192), (4, 217, 256, 192), (4, 256, 256, 192),
    (4, 257, 256, 192), (40, 104, 1000, 200),
    (64, 48, 2048, 1024), (64, 48, 1024, 2048), (64, 8, 1024, 2048),
    (64, 16, 1024, 2048), (64, 648, 1024, 2048),
]


def _gmm_close(got, want, D, dtype):
    tol = 1e-4 if dtype == "float32" else 5e-2
    _close(got, want, tol * math.sqrt(D), tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("E,C,D,F", GMM_CASES)
def test_grouped_matmul_kernel_matches_plain(cuda, E, C, D, F, dtype):
    """Each call launches once, on the route route() names: bf16 with D
    and F multiples of 8 on the tensor cores, the rest on the SIMT
    kernel."""
    x = _randn((E, C, D), dtype, cuda, 17)
    w = _randn((E, D, F), dtype, cuda, 18)
    want_route = ("wgmma" if dtype == "bfloat16" and D % 8 == 0
                  and F % 8 == 0 else "simt")
    assert gmm.route(x, w) == want_route
    before, routes = gmm.launches, dict(gmm.routes)
    got = gmm.grouped_matmul(x, w)
    assert gmm.launches == before + 1
    assert gmm.routes == {**routes, want_route: routes[want_route] + 1}
    _gmm_close(got, grouped_matmul_ref(x, w), D, dtype)


@pytest.mark.parametrize("N", range(8, 257, 8))
def test_grouped_matmul_wgmma_every_instance(cuda, N):
    """Each of the wgmma route's 32 kernel instances (tile height N) at C
    = N: D 1088 runs 17 stages, more than twice round the deepest ring,
    and F 192 leaves the second block's second warpgroup past F."""
    E, C, D, F = 2, N, 1088, 192
    x = _randn((E, C, D), "bfloat16", cuda, 25)
    w = _randn((E, D, F), "bfloat16", cuda, 26)
    assert gmm.route(x, w) == "wgmma"
    before = gmm.routes["wgmma"]
    got = gmm.grouped_matmul(x, w)
    assert gmm.routes["wgmma"] == before + 1
    _gmm_close(got, grouped_matmul_ref(x, w), D, "bfloat16")


@pytest.mark.parametrize("layout", ["expert-strided", "transposed",
                                    "column-slice w"])
def test_grouped_matmul_strided_and_deterministic(cuda, layout):
    """x and w read through their strides (x one of two row blocks per
    expert, or a transposed view; w a column slice of a wider weight),
    bitwise equal across calls."""
    E, C, D, F = 40, 24, 96, 72
    x = _randn((E, C, D), "float32", cuda, 19)
    w = _randn((E, D, F), "float32", cuda, 20)
    if layout == "expert-strided":
        x = _randn((E, 2, C, D), "float32", cuda, 19)[:, 1]
    elif layout == "transposed":
        x = _randn((E, D, C), "float32", cuda, 19).transpose(1, 2)
    else:
        w = _randn((E, D, F + 16), "float32", cuda, 20)[:, :, 8:8 + F]
    assert not (x.is_contiguous() and w.is_contiguous())
    got = gmm.grouped_matmul(x, w)
    assert torch.equal(got, gmm.grouped_matmul(x, w))
    _gmm_close(got, grouped_matmul_ref(x.contiguous(), w.contiguous()), D,
               "float32")


@pytest.mark.parametrize("E,C,D,F", [(64, 160, 2048, 1024),
                                     (4, 257, 256, 192), (64, 8, 2048, 1024)])
def test_grouped_matmul_wgmma_is_deterministic(cuda, E, C, D, F):
    """The tensor-core route gives the same bits in two calls."""
    x = _randn((E, C, D), "bfloat16", cuda, 21)
    w = _randn((E, D, F), "bfloat16", cuda, 22)
    assert gmm.route(x, w) == "wgmma"
    got = gmm.grouped_matmul(x, w)
    assert torch.equal(got, gmm.grouped_matmul(x, w))
    _gmm_close(got, grouped_matmul_ref(x, w), D, "bfloat16")


def test_grouped_matmul_wgmma_column_slice_w(cuda):
    """bf16 w as a column slice of a wider weight, 8 columns (16 bytes)
    in: the tensor maps read it through its strides."""
    E, C, D, F = 40, 24, 96, 72
    x = _randn((E, C, D), "bfloat16", cuda, 23)
    w = _randn((E, D, F + 16), "bfloat16", cuda, 24)[:, :, 8:8 + F]
    assert not w.is_contiguous() and gmm.route(x, w) == "wgmma"
    before = gmm.routes["wgmma"]
    got = gmm.grouped_matmul(x, w)
    assert gmm.routes["wgmma"] == before + 1
    _gmm_close(got, grouped_matmul_ref(x, w.contiguous()), D, "bfloat16")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_matmul_idle_expert_gives_zeros(cuda, dtype):
    """An expert whose x rows are all zero (no token routed to it) gets an
    output of exactly 0 on both routes."""
    E, C, D, F = 8, 16, 512, 256
    x = _randn((E, C, D), dtype, cuda, 25)
    x[3] = 0
    w = _randn((E, D, F), dtype, cuda, 26)
    got = gmm.grouped_matmul(x, w)
    torch.cuda.synchronize()
    assert torch.equal(got[3], torch.zeros_like(got[3]))
    _gmm_close(got, grouped_matmul_ref(x, w), D, dtype)


def _moe_smoke(arch, dtype):
    from repro_torch.configs import registry
    from repro_torch.models import moe
    cfg = dataclasses.replace(registry.get_smoke_config(arch), dtype=dtype)
    cpu = moe.init(torch.Generator().manual_seed(0), cfg, "cpu")
    return cfg, cpu, moe


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "granite-moe-3b-a800m"])
def test_moe_on_card_matches_cpu(cuda, arch):
    """The SMOKE model in fp32 on the card against the same params on the
    CPU: forward (three grouped-matmul launches per layer), prefill and
    two decode steps, the caches too."""
    from repro_torch.models import stacking
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, cpu, moe = _moe_smoke(arch, "float32")
    dev = stacking.tree_map(lambda t: t.to(cuda), cpu)
    x = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab,
                                                           (2, 42)))
    before = gmm.launches
    got = moe.forward(cfg, dev, x[:, :40].to(cuda))
    assert gmm.launches == before + 3 * cfg.n_layers
    _close(got.cpu(), moe.forward(cfg, cpu, x[:, :40]), 1e-4, 1e-4)
    lg_d, c_d = moe.prefill(cfg, dev, x[:, :40].to(cuda), 48)
    lg_c, c_c = moe.prefill(cfg, cpu, x[:, :40], 48)
    _close(lg_d.cpu(), lg_c, 1e-4, 1e-4)
    for t in (40, 41):
        lg_d, c_d = moe.decode_step(cfg, dev, c_d, x[:, t].to(cuda))
        lg_c, c_c = moe.decode_step(cfg, cpu, c_c, x[:, t])
        _close(lg_d.cpu(), lg_c, 1e-4, 1e-4)
    stacking.tree_map(lambda a, b: _close(a.cpu(), b, 1e-4, 1e-4), c_d, c_c)


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "granite-moe-3b-a800m"])
def test_moe_prefill_is_bitwise_repeatable(cuda, arch):
    """bf16, the routing's ties and the combine included: one prefill
    gives the same bits twice."""
    from repro_torch.models import stacking
    cfg, cpu, moe = _moe_smoke(arch, "bfloat16")
    dev = stacking.tree_map(lambda t: t.to(cuda), cpu)
    x = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab,
                                                           (2, 100))).to(cuda)
    first = moe.prefill(cfg, dev, x, 104)
    again = moe.prefill(cfg, dev, x, 104)
    same = stacking.tree_map(lambda a, b: bool(torch.equal(a, b)), first,
                             again)
    assert same == stacking.tree_map(lambda _: True, first)


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "granite-moe-3b-a800m"])
def test_moe_decode_matches_forward_on_card(cuda, arch, monkeypatch):
    """With the capacity raised so nothing drops, decode after prefill
    equals forward at every step (fp32, TF32 off)."""
    from repro_torch.models import stacking
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, cpu, moe = _moe_smoke(arch, "float32")
    monkeypatch.setattr(moe, "CAPACITY_FACTOR", float(cfg.n_experts))
    dev = stacking.tree_map(lambda t: t.to(cuda), cpu)
    x = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (2, 30))).to(cuda)
    full = moe.forward(cfg, dev, x)
    _, cache = moe.prefill(cfg, dev, x[:, :10], max_seq=32)
    for t in range(10, 29):
        lg, cache = moe.decode_step(cfg, dev, cache, x[:, t])
        _close(lg, full[:, t], 1e-4, 1e-4)


def test_fleet_migration_is_bitwise_on_card(cuda):
    """tests/test_fleet.py's migration check on the card: class 'a' served
    alone on SoC0, SoC0 fails, 'a' moves next to 'b' on SoC1; the same
    inputs give the same bits there, and those of the reference plan of
    the tiling SoC1 serves (K1's fixed-order split, deterministic
    cuDNN)."""
    from repro_torch.core.runtime import execute_plan, init_inputs
    from repro_torch.fleet import (Fleet, FleetConfig, FleetRebalancer,
                                   FleetRouter, Placement)
    from repro_torch.soc.testbed import (FORCED_DMA_BW, FORCED_L2_KIB,
                                         dense_chain, two_acc_soc)
    config = FleetConfig(
        soc_factory=lambda: two_acc_soc(FORCED_L2_KIB, FORCED_DMA_BW),
        n_socs=2, capacity=2, requested_tiles=4, time_budget_s=0.25,
        joint_time_budget_s=0.4, lazy_joint_time_budget_s=0.25,
        incremental_time_budget_s=0.25, execute=True, precompile="singles")
    assert config.device == "cuda"
    fleet = Fleet(config, [dense_chain("a", [64] * 5),
                           dense_chain("b", [48] * 4)])
    fleet.apply_placement(Placement(assignment=[("a",), ("b",)],
                                    method="manual"))
    reb = FleetRebalancer(fleet, FleetRouter(fleet))
    inputs = init_inputs(fleet.cache.classes["a"], seed=123)
    params = fleet.cache.params_for("a")
    assert all(t.is_cuda for t in params.values())

    src = fleet.instances[0]
    before = mm.launches
    rid = src.engine.submit("a", inputs=dict(inputs))
    src.engine.run()
    out_before = src.engine.results[rid]
    assert mm.launches > before

    recs = reb.fail(0, at_s=1.0)
    assert [r.class_name for r in recs] == ["a"]
    dst = fleet.instances[recs[0].dst_soc]
    rid = dst.engine.submit("a", inputs=dict(inputs))
    dst.engine.run()
    out_after = dst.engine.results[rid]
    idx = dst.engine.resolve("a")
    plan = dst.mc.plan_for([idx])
    want = execute_plan(dst.mc.session.reference_plan(idx, plan.tenants[0]),
                        inputs, params)
    torch.cuda.synchronize()
    assert out_before.keys() == out_after.keys() == want.keys()
    for t in want:
        assert out_after[t].is_cuda
        assert torch.equal(out_before[t], out_after[t]), t
        assert torch.equal(out_after[t], want[t]), t


# ------------------------------------------------------- training (backward)

def _rel_err(got, want):
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and got.shape == want.shape
    scale = want.float().abs().max().clamp(min=1e-30)
    return ((got.float() - want.float()).abs().max() / scale).item()


# the backward kernels' tolerance, relative to the largest |gradient|:
# fp32 sums in other orders; bf16 rounds each output once (2^-9) and the
# forward's bf16 output enters D = rowsum(dO * O)
BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}


# shape, dtype, route, view: the training path's 4096 x 2048 (bf16, and the
# fp32 check's width), rwkv6-3b's ln_x (163840 x 64), qwen3's q-norm width
# (131072 x 128) and recurrentgemma-2b's 4096 x 2560, then every compiled
# instance of each route in both dtypes: warp G 1, 2, 4, 8, 16, 32 lanes a
# row and 2 or 4 vectors a lane; block 2, 4 and 8 vectors a thread (96 to
# 256 threads); scalar 1 to 32 columns a thread; ragged rows and ragged lane
# counts (12, 24, 25, 48, 125 vectors), most shapes in both dtypes; and
# views: rows wider apart than the width by 16 bytes (vector routes, row
# strides read), by one element, or x, dy or g one element past a 16-byte
# boundary (scalar)
RMS_BWD_CASES = [
    ((4096, 2048), "bfloat16", "block", None),
    ((163840, 64), "bfloat16", "warp", None),
    ((131072, 128), "bfloat16", "warp", None),
    ((4096, 2560), "bfloat16", "block", None),
    ((256, 2048), "float32", "block", None),
    ((4096, 2048), "float32", "block", None),
    ((37, 8), "bfloat16", "warp", None),
    ((37, 16), "bfloat16", "warp", None),
    ((40, 32), "bfloat16", "warp", None),
    ((600, 64), "bfloat16", "warp", None),
    ((3, 5, 96), "bfloat16", "warp", None),
    ((37, 128), "bfloat16", "warp", None),
    ((70, 256), "bfloat16", "warp", None),
    ((70, 384), "bfloat16", "warp", None),
    ((70, 512), "bfloat16", "warp", None),
    ((11, 1000), "bfloat16", "warp", None),
    ((9, 1024), "bfloat16", "warp", None),
    ((33, 1032), "bfloat16", "block", None),
    ((1, 2560), "bfloat16", "block", None),
    ((5, 8192), "bfloat16", "block", None),
    ((37, 4), "float32", "warp", None),
    ((37, 8), "float32", "warp", None),
    ((37, 16), "float32", "warp", None),
    ((40, 32), "float32", "warp", None),
    ((3, 5, 64), "float32", "warp", None),
    ((70, 128), "float32", "warp", None),
    ((70, 256), "float32", "warp", None),
    ((70, 384), "float32", "warp", None),
    ((9, 512), "float32", "warp", None),
    ((11, 1000), "float32", "block", None),
    ((5, 2560), "float32", "block", None),
    ((5, 8192), "float32", "block", None),
    ((37, 128), "float32", "warp", None),
    ((9, 100), "float32", "warp", None),
    ((3, 5, 96), "float32", "warp", None),
    ((600, 64), "float32", "warp", None),
    ((1, 2560), "float32", "block", None),
    ((9, 100), "bfloat16", "scalar", None),
    ((7, 300), "bfloat16", "scalar", None),
    ((7, 1002), "bfloat16", "scalar", None),
    ((5, 2002), "bfloat16", "scalar", None),
    ((5, 4002), "bfloat16", "scalar", None),
    ((3, 8190), "bfloat16", "scalar", None),
    ((9, 101), "float32", "scalar", None),
    ((7, 301), "float32", "scalar", None),
    ((7, 1001), "float32", "scalar", None),
    ((5, 2001), "float32", "scalar", None),
    ((5, 4001), "float32", "scalar", None),
    ((3, 8191), "float32", "scalar", None),
    ((600, 64), "bfloat16", "warp", "rows 16 bytes apart"),
    ((70, 2048), "bfloat16", "block", "rows 16 bytes apart"),
    ((70, 512), "float32", "warp", "rows 16 bytes apart"),
    ((600, 64), "bfloat16", "scalar", "rows one element apart"),
    ((70, 2048), "float32", "scalar", "rows one element apart"),
    ((4096, 2048), "bfloat16", "scalar", "x misaligned"),
    ((600, 128), "bfloat16", "scalar", "dy misaligned"),
    ((70, 2560), "float32", "scalar", "g misaligned"),
]


def _rms_bwd_operands(shape, dtype, view, gain, device):
    """x, g (None without a gain) and dy of a case, as ``view`` lays
    them out."""
    d = shape[-1]
    e = 16 // torch.empty(0, dtype=DTYPES[dtype]).element_size()

    def laid(t, pad, off):
        # t's values in rows ``pad`` elements wider, ``off`` elements in
        rows = t.numel() // d
        buf = torch.zeros(rows * (d + pad) + off, dtype=t.dtype,
                          device=device)
        out = buf[off:].view(rows, d + pad)[:, :d]
        out.copy_(t.reshape(rows, d))
        return out.view(t.shape) if pad == 0 else out

    x = _randn(shape, dtype, device, 31)
    g = (1 + 0.1 * _randn(shape[-1:], "float32", device, 32)).to(
        DTYPES[dtype]) if gain else None
    dy = _randn(shape, dtype, device, 33)
    if view == "rows 16 bytes apart":
        x, dy = laid(x, e, 0), laid(dy, e, 0)
    elif view == "rows one element apart":
        x, dy = laid(x, 1, 0), laid(dy, 1, 0)
    elif view == "x misaligned":
        x = laid(x, 0, 1)
    elif view == "dy misaligned":
        dy = laid(dy, 0, 1)
    elif view == "g misaligned" and gain:
        g = laid(g, 0, 1)
    return x, g, dy


@pytest.mark.parametrize("shape,dtype,route,view", RMS_BWD_CASES)
@pytest.mark.parametrize("gain", [True, False])
def test_rmsnorm_bwd_kernel_matches_plain(cuda, shape, dtype, route, view,
                                          gain):
    """dx and dg of the backward kernel against rmsnorm_bwd_ref on the
    route the case names (every compiled instance of each route among the
    cases); two launches with a gain (the rows, then dg's ordered sum), one
    without, all on that route; two calls bitwise equal."""
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_bwd_ref
    x, g, dy = _rms_bwd_operands(shape, dtype, view, gain, cuda)
    if view == "g misaligned" and not gain:
        route = "block"                   # nothing misaligned is left
    assert rms.route_bwd(x, g, dy) == route
    before, by_route = rms.bwd_launches, dict(rms.bwd_routes)
    dx, dg = rms.rmsnorm_bwd(x, g, dy)
    n = 2 if gain else 1
    assert rms.bwd_launches == before + n
    assert {r: rms.bwd_routes[r] - k for r, k in by_route.items()} == {
        r: n if r == route else 0 for r in by_route}
    want_dx, want_dg = rmsnorm_bwd_ref(x, g, dy)
    assert _rel_err(dx, want_dx) <= BWD_TOL[dtype]
    if gain:
        assert _rel_err(dg, want_dg) <= BWD_TOL[dtype]
    else:
        assert dg is None
    again = rms.rmsnorm_bwd(x, g, dy)
    assert torch.equal(dx, again[0])
    assert not gain or torch.equal(dg, again[1])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_autograd_on_card(cuda, dtype):
    """Under grad the wrapper is an autograd node: the forward kernel on
    its route, the backward kernel in backward; under no_grad, or with
    nothing that requires grad, it launches as serving does."""
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_bwd_ref
    x0 = _randn((64, 2048), dtype, cuda, 34)
    g0 = (1 + 0.1 * _randn((2048,), "float32", cuda, 35)).to(DTYPES[dtype])
    dy = _randn((64, 2048), dtype, cuda, 36)
    x, g = (t.clone().requires_grad_(True) for t in (x0, g0))
    f, b, blk = rms.launches, rms.bwd_launches, rms.routes["block"]
    bwd_blk = rms.bwd_routes["block"]
    y = rms.rmsnorm(x, g)
    assert y.grad_fn is not None
    assert (rms.launches, rms.routes["block"]) == (f + 1, blk + 1)
    assert torch.equal(y.detach(), rms.rmsnorm(x0, g0))
    dx, dg = torch.autograd.grad(y, (x, g), dy)
    assert rms.bwd_launches == b + 2
    assert rms.bwd_routes["block"] == bwd_blk + 2
    want = rmsnorm_bwd_ref(x0, g0, dy)
    assert _rel_err(dx, want[0]) <= BWD_TOL[dtype]
    assert _rel_err(dg, want[1]) <= BWD_TOL[dtype]
    with torch.no_grad():
        assert rms.rmsnorm(x, g).grad_fn is None
    assert rms.rmsnorm(x0, g0).grad_fn is None
    assert rms.bwd_launches == b + 2


# B, S, H, KV, Dh, causal, window, dtype, route: internlm2-1.8b's training
# shape, then every instance the backward compiles (Dh 16, 32, 64, 80,
# 128, 256 in both dtypes; bf16 Dh 64, 128 and 256 on the tensor-core
# route), GQA 1-8, windows, bidirectional, ragged S (not a multiple of the
# 64- or 32-row tile), S below one tile, and window 0 (no row attends a
# key: every gradient exactly 0)
FA_BWD_CASES = [
    (4, 1024, 16, 8, 128, True, None, "bfloat16", "wgmma"),
    (1, 256, 16, 8, 128, True, None, "float32", "simt"),
    (2, 333, 4, 2, 128, True, 100, "float32", "simt"),
    (1, 300, 4, 1, 64, True, None, "bfloat16", "wgmma"),
    (1, 129, 4, 2, 64, True, None, "float32", "simt"),
    (1, 130, 4, 2, 256, True, 50, "bfloat16", "wgmma"),
    (1, 97, 2, 1, 256, True, None, "float32", "simt"),
    (1, 100, 2, 2, 80, False, None, "float32", "simt"),
    (1, 70, 2, 2, 80, True, None, "bfloat16", "simt"),
    (2, 70, 4, 4, 16, False, 20, "float32", "simt"),
    (1, 50, 2, 1, 16, True, None, "bfloat16", "simt"),
    (1, 96, 8, 1, 32, True, None, "bfloat16", "simt"),
    (1, 80, 4, 2, 32, True, 30, "float32", "simt"),
    (2, 64, 3, 1, 12, True, None, "float32", "simt"),
    (1, 70, 4, 2, 12, True, 20, "bfloat16", "simt"),
    (1, 45, 2, 2, 8, False, None, "float32", "simt"),
    (2, 64, 4, 1, 8, True, None, "bfloat16", "simt"),
    (1, 65, 2, 2, 64, False, None, "bfloat16", "wgmma"),
    (2, 333, 4, 2, 128, True, 100, "bfloat16", "wgmma"),
    (1, 333, 16, 2, 64, True, 100, "bfloat16", "wgmma"),
    (1, 130, 4, 2, 128, False, 50, "bfloat16", "wgmma"),
    (1, 40, 8, 1, 128, True, None, "bfloat16", "wgmma"),
    (1, 33, 4, 2, 64, False, None, "bfloat16", "wgmma"),
    (1, 97, 2, 1, 256, True, None, "bfloat16", "wgmma"),
    (2, 190, 8, 1, 256, False, 70, "bfloat16", "wgmma"),
    (1, 50, 4, 2, 256, True, None, "bfloat16", "wgmma"),
    (1, 200, 4, 4, 128, True, 0, "bfloat16", "wgmma"),
    (1, 100, 2, 1, 64, False, 0, "bfloat16", "wgmma"),
    (1, 70, 2, 2, 256, True, 0, "bfloat16", "wgmma"),
    (1, 70, 4, 2, 128, True, 0, "float32", "simt"),
]


@pytest.mark.parametrize("B,S,H,KV,Dh,causal,win,dtype,route", FA_BWD_CASES)
def test_flash_attention_bwd_kernel_matches_plain(cuda, B, S, H, KV, Dh,
                                                  causal, win, dtype, route):
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref
    q = _randn((B, S, H, Dh), dtype, cuda, 40)
    k = _randn((B, S, KV, Dh), dtype, cuda, 41)
    v = _randn((B, S, KV, Dh), dtype, cuda, 42)
    do = _randn((B, S, H, Dh), dtype, cuda, 43)
    out = fa.flash_attention(q, k, v, causal=causal, window=win)
    assert fa.route_bwd(q, k, v) == route
    before, by_route = fa.bwd_launches, dict(fa.bwd_routes)
    got = fa.flash_attention_bwd(q, k, v, out, do, causal, win)
    assert fa.bwd_launches == before + 3
    assert {r: fa.bwd_routes[r] - n for r, n in by_route.items()} == {
        r: 3 if r == route else 0 for r in by_route}
    want = attention_bwd_ref(q, k, v, do, causal, win)
    for name, a, b in zip("qkv", got, want):
        err = _rel_err(a, b)
        assert err <= BWD_TOL[dtype], f"d{name}: {err}"
        if win == 0:
            assert torch.count_nonzero(a) == 0, f"d{name} with window 0"
    again = fa.flash_attention_bwd(q, k, v, out, do, causal, win)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_flash_attention_autograd_on_card(cuda):
    """Under grad: the forward kernel (wgmma route for bf16 Dh 128) as an
    autograd node whose backward is the three kernels (wgmma route too);
    no_grad and operands that require nothing launch as serving does.
    Last, internlm2-1.8b's training shape: three wgmma backward
    launches."""
    q0 = _randn((2, 256, 8, 128), "bfloat16", cuda, 44)
    k0 = _randn((2, 256, 2, 128), "bfloat16", cuda, 45)
    v0 = _randn((2, 256, 2, 128), "bfloat16", cuda, 46)
    do = _randn((2, 256, 8, 128), "bfloat16", cuda, 47)
    q, k, v = (t.clone().requires_grad_(True) for t in (q0, k0, v0))
    f, b, wg = fa.launches, fa.bwd_launches, fa.routes["wgmma"]
    bwg = fa.bwd_routes["wgmma"]
    out = fa.flash_attention(q, k, v)
    assert out.grad_fn is not None
    assert (fa.launches, fa.routes["wgmma"]) == (f + 1, wg + 1)
    grads = torch.autograd.grad(out, (q, k, v), do)
    assert fa.bwd_launches == b + 3 and fa.bwd_routes["wgmma"] == bwg + 3
    for a, w in zip(grads, fa.flash_attention_bwd(q0, k0, v0, out.detach(),
                                                  do)):
        assert torch.equal(a, w)
    with torch.no_grad():
        assert fa.flash_attention(q, k, v).grad_fn is None
    assert fa.flash_attention(q0, k0, v0).grad_fn is None
    assert fa.bwd_launches == b + 6
    q, k, v = (_randn(shape, "bfloat16", cuda, 48 + i).requires_grad_(True)
               for i, shape in enumerate([(4, 1024, 16, 128),
                                          (4, 1024, 8, 128),
                                          (4, 1024, 8, 128)]))
    routes = dict(fa.bwd_routes)
    out = fa.flash_attention(q, k, v)
    torch.autograd.grad(out, (q, k, v), torch.ones_like(out))
    assert {r: fa.bwd_routes[r] - n for r, n in routes.items()} == {
        "wgmma": 3, "simt": 0}


def test_kernels_without_backward_raise_under_grad(cuda):
    """K1 has no backward kernel: its CUDA wrapper refuses an operand that
    requires grad while grad is enabled, and launches under no_grad.  K4,
    K5 and K6, which have one, launch it instead of raising."""
    a = _randn((8, 64), "float32", cuda, 50).requires_grad_(True)
    b = _randn((64, 16), "float32", cuda, 51)
    with pytest.raises(RuntimeError, match="no backward kernel"):
        mm.matmul(a, b)
    with torch.no_grad():
        mm.matmul(a, b)
    r, k, v, w = (_randn((1, 16, 2, 32), "float32", cuda, 52 + i)
                  for i in range(4))
    w = torch.sigmoid(w)
    u = _randn((2, 32), "float32", cuda, 56)
    ga = torch.sigmoid(_randn((1, 16, 64), "float32", cuda, 57))
    gb = _randn((1, 16, 64), "float32", cuda, 58)
    x = _randn((2, 8, 64), "float32", cuda, 59)
    wg = _randn((2, 64, 16), "float32", cuda, 60)
    for mod, call, n in (
            (wkv, lambda: wkv.wkv6(r.requires_grad_(True), k, v, w, u)[0],
             len(wkv.BWD_STAGES)),
            (scan, lambda: scan.rglru(ga, gb.requires_grad_(True))[0], 1),
            (gmm, lambda: gmm.grouped_matmul(x, wg.requires_grad_(True)), 2)):
        before = mod.bwd_launches
        out = call()
        out.sum().backward()
        assert mod.bwd_launches == before + n
    torch.cuda.synchronize()


def test_serving_launches_unchanged_under_no_grad(cuda):
    """A bf16 prefill and decode step launch the same kernels on the same
    routes with grad enabled (no operand requires grad) and under no_grad,
    and no backward kernel."""
    from repro_torch.configs import registry
    from repro_torch.models import transformer
    cfg = dataclasses.replace(registry.get_smoke_config("qwen3-8b"),
                              head_dim=64)
    params = transformer.init(torch.Generator(device=cuda).manual_seed(0),
                              cfg, cuda)
    x = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 40))).to(cuda)

    def serve():
        mods = (rms, fa)
        before = [(m.launches, m.bwd_launches, dict(m.routes)) for m in mods]
        logits, cache = transformer.prefill(cfg, params, x, 48)
        transformer.decode_step(cfg, params, cache, logits.argmax(-1))
        return [(m.launches - n, m.bwd_launches - nb,
                 {r: m.routes[r] - c[r] for r in c})
                for m, (n, nb, c) in zip(mods, before)]

    with_grad = serve()
    with torch.no_grad():
        without = serve()
    assert with_grad == without
    assert with_grad[1][0] == cfg.n_layers and with_grad[1][2]["wgmma"] == \
        cfg.n_layers
    assert with_grad[0][1] == with_grad[1][1] == 0


def test_train_step_on_card_matches_cpu(cuda):
    """One fp32 train step (remat) of a small internlm2 on the card, through
    the forward and backward kernels, against the same step on CPU tensors
    (the plain versions): the loss, every gradient (relative L2 1e-3), and
    the launches: each norm and attention twice forward (remat), once
    backward (fp32: the SIMT backward)."""
    from repro_torch.configs import registry
    from repro_torch.core.pytree import leaves
    from repro_torch.models import stacking, transformer
    from repro_torch.train import step as tstep
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(registry.get_smoke_config("internlm2-1.8b"),
                              d_model=256, head_dim=64, dtype="float32")
    cpu = transformer.init(torch.Generator().manual_seed(0), cfg, "cpu")
    dev = stacking.tree_map(lambda t: t.to(cuda), cpu)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 96)))
    y = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 96)))
    grad_fn = tstep.value_and_grad(tstep.make_loss_fn(cfg, remat=True))
    counts = (rms.launches, rms.bwd_launches, fa.launches, fa.bwd_launches,
              fa.bwd_routes["simt"])
    (loss_d, _), g_d = grad_fn(dev, x.to(cuda), y.to(cuda))
    L = cfg.n_layers
    assert (rms.launches - counts[0], rms.bwd_launches - counts[1],
            fa.launches - counts[2], fa.bwd_launches - counts[3],
            fa.bwd_routes["simt"] - counts[4]) == \
        (2 * 2 * L + 1, 2 * (2 * L + 1), 2 * L, 3 * L, 3 * L)
    (loss_c, _), g_c = grad_fn(cpu, x, y)
    assert abs(loss_d.item() - loss_c.item()) <= 1e-5 * abs(loss_c.item())
    g_d, g_c = leaves(g_d), leaves(g_c)
    for n, (a, b) in enumerate(zip(g_d, g_c)):
        rel = ((a.cpu() - b).norm() / b.norm().clamp(min=1e-30)).item()
        assert rel <= 1e-3, f"leaf {n}: relative L2 {rel}"
        assert torch.isfinite(a).all() and a.abs().sum() > 0, n
    assert len(g_d) == len(leaves(cpu))


# ------------------------------------------- K4, K5, K6 backward kernels

def _wkv_bwd_operands(B, T, H, D, dtype, device, seed, lo=0.01):
    rng = np.random.default_rng(seed)
    r, k, v, dy = (_randn((B, T, H, D), dtype, device, seed + i)
                   for i in range(4))
    w = torch.from_numpy(rng.uniform(lo, 1.0, (B, T, H, D))
                         .astype(np.float32)).to(device, DTYPES[dtype])
    u = _randn((H, D), "float32", device, seed + 5) * 0.3
    ds = _randn((B, H, D, D), "float32", device, seed + 6)
    return r, k, v, w, u, dy, ds


def _held(got, want, dtype, what):
    for n, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and g.shape == w.shape, (what, n)
        assert _rel_err(g, w) <= BWD_TOL[dtype], (what, n, _rel_err(g, w))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", sorted(wkv.COLUMN_BLOCK))
@pytest.mark.parametrize("T", [1, 7, 8, 9, 16, 17, 77])
def test_wkv6_bwd_kernel_matches_plain(cuda, D, T, dtype):
    """Every head width the forward compiles (each walk instance), T at 1,
    the chunk (checkpoint interval) and its neighbours, two chunks and one
    step past them, and a ragged 77, decays down to 0.01 and a nonzero
    final-state gradient: the launches against the plain version, two
    calls bitwise equal."""
    args = _wkv_bwd_operands(2, T, 3, D, dtype, cuda, 70 + D + T)
    before = wkv.bwd_launches
    got = wkv.wkv6_bwd(*args)
    again = wkv.wkv6_bwd(*args)
    assert wkv.bwd_launches == before + 2 * len(wkv.BWD_STAGES)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    _held(got, wkv6_bwd_ref(*args), dtype, f"wkv6_bwd D{D} T{T}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,T", [(1, 1000), (4, 1024)])
def test_wkv6_bwd_at_rwkv6_3b(cuda, B, T, dtype):
    args = _wkv_bwd_operands(B, T, 40, 64, dtype, cuda, 80 + B)
    got = wkv.wkv6_bwd(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, wkv.wkv6_bwd(*args)))
    _held(got, wkv6_bwd_ref(*args), dtype, f"wkv6_bwd B{B} T{T}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wkv6_autograd_on_card(cuda, dtype):
    """Under grad: the forward launch gives the no-grad call's bits, the
    final state's unused gradient is taken as zeros, and the backward is
    the kernels' (wkv6_bwd's bits); views of a fused projection work."""
    r, k, v, w, u, dy, _ = _wkv_bwd_operands(2, 45, 4, 64, dtype, cuda, 90)
    fused = torch.cat([r, k, v, w], dim=-1)          # (B, T, H, 4D) views
    views = [fused[..., i * 64:(i + 1) * 64] for i in range(4)]
    with torch.no_grad():
        y0, s0 = wkv.wkv6(*views, u)
    live = fused.clone().requires_grad_(True)
    lu = u.clone().requires_grad_(True)
    lv = [live[..., i * 64:(i + 1) * 64] for i in range(4)]
    f, b = wkv.launches, wkv.bwd_launches
    y1, s1 = wkv.wkv6(*lv, lu)
    assert torch.equal(y0, y1) and torch.equal(s0, s1)
    assert wkv.launches == f + 1
    gf, gu = torch.autograd.grad(y1, (live, lu), dy)
    assert wkv.bwd_launches == b + len(wkv.BWD_STAGES)
    want = wkv.wkv6_bwd(*(t.contiguous() for t in views), u, dy, None)
    for i in range(4):
        assert torch.equal(gf[..., i * 64:(i + 1) * 64], want[i])
    assert torch.equal(gu, want[4])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,T,D", [(4, 1024, 2560), (1, 1000, 2560),
                                   (2, 77, 2568), (3, 1, 16), (1, 9, 5)])
def test_rglru_bwd_kernel_matches_plain(cuda, B, T, D, dtype):
    """Every strip (ragged D) and T around the 8-step load batch: against
    the plain version (the same fp32 h chain: bitwise), two calls
    bitwise."""
    a = torch.sigmoid(_randn((B, T, D), dtype, cuda, 100 + T))
    b, dh = (_randn((B, T, D), dtype, cuda, 101 + T + i) for i in range(2))
    dh_last = _randn((B, D), "float32", cuda, 103 + T)
    before = scan.bwd_launches
    got = scan.rglru_bwd(a, b, dh, dh_last)
    again = scan.rglru_bwd(a, b, dh, dh_last)
    assert scan.bwd_launches == before + 2
    want = rglru_bwd_ref(a, b, dh, dh_last)
    for g, g2, w in zip(got, again, want):
        assert torch.equal(g, g2)
        assert torch.equal(g, w)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rglru_autograd_on_card(cuda, dtype):
    a0 = torch.sigmoid(_randn((2, 300, 2560), dtype, cuda, 110))
    b0 = _randn((2, 300, 2560), dtype, cuda, 111)
    dh = _randn((2, 300, 2560), dtype, cuda, 112)
    with torch.no_grad():
        h0, l0 = scan.rglru(a0, b0)
    a, b = (t.clone().requires_grad_(True) for t in (a0, b0))
    h1, l1 = scan.rglru(a, b)
    assert torch.equal(h0, h1) and torch.equal(l0, l1)
    before = scan.bwd_launches
    got = torch.autograd.grad(h1, (a, b), dh)
    assert scan.bwd_launches == before + 1
    for g, w in zip(got, scan.rglru_bwd(a0, b0, dh, None)):
        assert torch.equal(g, w)


# granite B4 S1024 and olmoe S1000 (tiles of 256 rows); then each of the
# backward's tensor-core instances (64, 128, 192, 256 rows a tile) for dx
# (C rows) and dw (D rows) with ragged edges of C, D and F; then SIMT
GMM_BWD_CASES = [
    (40, 1056, 1536, 512), (40, 1056, 512, 1536),
    (64, 160, 2048, 1024), (64, 160, 1024, 2048),
    (3, 40, 48, 32), (3, 100, 96, 40), (2, 150, 160, 72), (2, 300, 200, 264),
    (4, 17, 256, 192), (5, 16, 48, 32),
    (3, 17, 40, 12), (4, 16, 100, 64),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("E,C,D,F", GMM_BWD_CASES)
def test_grouped_matmul_bwd_kernel_matches_plain(cuda, E, C, D, F, dtype):
    """dx and dw against the plain version on route_bwd()'s routes, two
    calls bitwise; bf16 with D and F multiples of 8 never runs on the SIMT
    kernel; a strided forward operand (x a transposed view) gives the
    same bits as a contiguous one."""
    x = _randn((E, C, D), dtype, cuda, 120) * 0.5
    w = _randn((E, D, F), dtype, cuda, 121) * D ** -0.5
    dy = _randn((E, C, F), dtype, cuda, 122)
    route = gmm.route_bwd(x, w)
    before = dict(gmm.bwd_routes)
    got = gmm.grouped_matmul_bwd(x, w, dy)
    again = gmm.grouped_matmul_bwd(x, w, dy)
    took = {r: gmm.bwd_routes[r] - n for r, n in before.items()}
    assert took == {r: 4 * (r == route) for r in took}     # two calls
    if dtype == "bfloat16" and D % 8 == 0 and F % 8 == 0:
        assert route == "wgmma"
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    _held(got, grouped_matmul_bwd_ref(x, w, dy), dtype,
          f"grouped_matmul_bwd ({E},{C},{D},{F})")
    xt = x.transpose(1, 2).contiguous().transpose(1, 2)
    assert all(torch.equal(a, b) for a, b in
               zip(gmm.grouped_matmul_bwd(xt, w, dy), got))


# one C for each tile height the backward's dx can pick (tile_rows: 8 to
# 256 rows in steps of 8, ragged below each but the first); D 72 is one
# partial 128-row tile of dx, F 64 one of dw
GMM_DX_ROWS = [5] + [n - 3 for n in range(16, 257, 8)]


@pytest.mark.parametrize("C", GMM_DX_ROWS)
def test_grouped_matmul_bwd_every_dx_instance(cuda, C):
    """Each dx instance (C rows a tile in steps of 8) against the plain
    version, two calls bitwise, on the tile height plan_bwd() picks; dw
    beside it on its 64-row instance."""
    E, D, F = 2, 72, 64
    x = _randn((E, C, D), "bfloat16", cuda, 140) * 0.5
    w = _randn((E, D, F), "bfloat16", cuda, 141) * D ** -0.5
    dy = _randn((E, C, F), "bfloat16", cuda, 142)
    assert gmm.plan_bwd(0, E, C, D, F, 132)[0] == -(-C // 8) * 8
    before = gmm.bwd_routes["wgmma"]
    got = gmm.grouped_matmul_bwd(x, w, dy)
    again = gmm.grouped_matmul_bwd(x, w, dy)
    assert gmm.bwd_routes["wgmma"] == before + 4
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    _held(got, grouped_matmul_bwd_ref(x, w, dy), "bfloat16",
          f"grouped_matmul_bwd dx instance C {C}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_matmul_autograd_on_card(cuda, dtype):
    x0 = _randn((8, 64, 128), dtype, cuda, 130)
    w0 = _randn((8, 128, 96), dtype, cuda, 131) * 0.1
    dy = _randn((8, 64, 96), dtype, cuda, 132)
    with torch.no_grad():
        y0 = gmm.grouped_matmul(x0, w0)
    x, w = (t.clone().requires_grad_(True) for t in (x0, w0))
    y1 = gmm.grouped_matmul(x, w)
    assert torch.equal(y0, y1)
    before = gmm.bwd_launches
    got = torch.autograd.grad(y1, (x, w), dy)
    assert gmm.bwd_launches == before + 2
    for g, want in zip(got, gmm.grouped_matmul_bwd(x0, w0, dy)):
        assert torch.equal(g, want)


@pytest.mark.parametrize("arch", ["rwkv6-3b", "recurrentgemma-2b",
                                  "granite-moe-3b-a800m"])
def test_family_train_step_on_card_matches_cpu(cuda, arch):
    """One fp32 remat step of each newly trained family at smoke size on
    the card, through every forward and backward kernel, against the same
    step on CPU tensors: the loss, every gradient (relative L2 1e-3); and
    the card's step twice, bitwise."""
    from repro_torch.configs import registry
    from repro_torch.core.pytree import leaves
    from repro_torch.models import stacking
    from repro_torch.models.api import get_model
    from repro_torch.train import step as tstep
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(registry.get_smoke_config(arch),
                              dtype="float32")
    cpu = get_model(cfg).init(torch.Generator().manual_seed(0), cfg, "cpu")
    dev = stacking.tree_map(lambda t: t.to(cuda), cpu)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 64)))
    y = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 64)))
    grad_fn = tstep.value_and_grad(tstep.make_loss_fn(cfg, remat=True))
    mod = {"ssm": wkv, "hybrid": scan, "moe": gmm}[cfg.family]
    before = mod.bwd_launches
    (loss_d, _), g_d = grad_fn(dev, x.to(cuda), y.to(cuda))
    assert mod.bwd_launches > before
    (loss_d2, _), g_d2 = grad_fn(dev, x.to(cuda), y.to(cuda))
    assert torch.equal(loss_d, loss_d2)
    assert all(torch.equal(a, b) for a, b in zip(leaves(g_d), leaves(g_d2)))
    (loss_c, _), g_c = grad_fn(cpu, x, y)
    assert abs(loss_d.item() - loss_c.item()) <= 1e-5 * abs(loss_c.item())
    for n, (a, b) in enumerate(zip(leaves(g_d), leaves(g_c))):
        rel = ((a.cpu() - b).norm() / b.norm().clamp(min=1e-30)).item()
        assert rel <= 1e-3, f"leaf {n}: relative L2 {rel}"
