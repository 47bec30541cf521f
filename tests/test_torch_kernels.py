"""The port's GEMM and RMSNorm wrappers on CPU tensors (their plain torch
versions) against the Pallas kernels in interpret mode, on the sweeps of
tests/test_kernels.py, plus the ragged and strided shapes the runtime
hands the GEMM.  Inputs are made with numpy from a seed and given to both
packages."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.matmul.matmul import matmul_pallas
from repro.kernels.matmul.ref import matmul_ref
from repro.kernels.rmsnorm.ref import rmsnorm_ref
from repro.kernels.rmsnorm.rmsnorm import rmsnorm_pallas
from repro_torch.kernels.matmul import matmul as tmm
from repro_torch.kernels.rmsnorm import rmsnorm as trms

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(rng, shape, dtype):
    """The same values as a JAX array and a CPU torch tensor of ``dtype``
    (rounded to bf16 once, on the torch side, and carried over)."""
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    x = x.to(DTYPES[dtype][1])
    return jnp.asarray(x.float().numpy()).astype(DTYPES[dtype][0]), x


def _np(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor)
                      else jnp.asarray(x, jnp.float32))


# ---------------------------------------------------------------- matmul
MM_SWEEP = [
    (128, 128, 128, "float32", 64, 64, 64),
    (256, 384, 128, "float32", 128, 128, 128),
    (64, 64, 256, "bfloat16", 32, 32, 64),
    (512, 128, 64, "float32", 128, 64, 64),
]


def _mm_tol(dtype, K):
    tol = 1e-4 if dtype == "float32" else 5e-2
    return dict(atol=tol * K ** 0.5, rtol=tol)


@pytest.mark.parametrize("M,N,K,dtype,bm,bn,bk", MM_SWEEP)
def test_matmul_matches_pallas(M, N, K, dtype, bm, bn, bk):
    rng = np.random.default_rng(0)
    ja, ta = _pair(rng, (M, K), dtype)
    jb, tb = _pair(rng, (K, N), dtype)
    want = matmul_pallas(ja, jb, block_m=bm, block_n=bn, block_k=bk,
                         interpret=True)
    got = tmm.matmul(ta, tb)
    assert got.dtype == DTYPES[dtype][1] and got.shape == (M, N)
    np.testing.assert_allclose(_np(got), _np(want), **_mm_tol(dtype, K))


# ragged shapes the runtime produces: decode rows (M = 1), narrow neuron
# tiles (N = 48), a column slice of a wider weight (strided B), leading
# batch dims on a dense input, and batch_matmul against a transposed kT
RAGGED = [
    ("decode", (1, 96), (96, 80), None),
    ("narrow", (5, 64), (64, 48), None),
    ("strided_b", (7, 64), (64, 200), (16, 64)),
    ("dense_3d", (2, 3, 32), (32, 24), None),
    ("batched_kT", (4, 9, 16), (4, 9, 16), "kT"),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case,ashape,bshape,view", RAGGED,
                         ids=[r[0] for r in RAGGED])
def test_matmul_ragged_matches_ref(case, ashape, bshape, view, dtype):
    rng = np.random.default_rng(1)
    ja, ta = _pair(rng, ashape, dtype)
    jb, tb = _pair(rng, bshape, dtype)
    if view == "kT":
        jb, tb = jnp.swapaxes(jb, 1, 2), tb.transpose(1, 2)
    elif view is not None:
        c0, c1 = view
        jb, tb = jb[:, c0:c1], tb[:, c0:c1]
        assert not tb.is_contiguous()
    got = tmm.matmul(ta, tb)
    want = (matmul_ref(ja, jb) if ja.ndim == 2 and jb.ndim == 2
            else jnp.matmul(ja.astype(jnp.float32),
                            jb.astype(jnp.float32)).astype(ja.dtype))
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(_np(got), _np(want),
                               **_mm_tol(dtype, ashape[-1]))


@pytest.mark.parametrize("a,b,err", [
    (torch.zeros(2, 3), torch.zeros(4, 5), ValueError),
    (torch.zeros(2, 3), torch.zeros(3, 5, dtype=torch.bfloat16), TypeError),
    (torch.zeros(3, dtype=torch.float64), torch.zeros(3, 2), TypeError),
    (torch.zeros(3), torch.zeros(3, 2), ValueError),
])
def test_matmul_rejects_unsupported(a, b, err):
    with pytest.raises(err):
        tmm.matmul(a, b)


def test_cpu_path_launches_no_kernel():
    before = (tmm.launches, trms.launches)
    tmm.matmul(torch.ones(2, 3), torch.ones(3, 4))
    trms.rmsnorm(torch.ones(2, 8))
    assert (tmm.launches, trms.launches) == before


# ---------------------------------------------------------------- rmsnorm
@pytest.mark.parametrize("shape,dtype", [
    ((4, 64, 512), "float32"),
    ((2, 128, 256), "bfloat16"),
    ((1, 8, 1024), "float32"),
    ((3, 2560), "float32"),
    ((1, 2560), "bfloat16"),
])
def test_rmsnorm_matches_pallas(shape, dtype):
    rng = np.random.default_rng(2)
    jx, tx = _pair(rng, shape, dtype)
    jg, tg = _pair(rng, shape[-1:], dtype)
    want = rmsnorm_pallas(jx, jg, interpret=True)
    got = trms.rmsnorm(tx, tg)
    tol = 1e-5 if dtype == "float32" else 2e-2
    assert got.dtype == DTYPES[dtype][1] and got.shape == shape
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


def test_rmsnorm_without_gain_matches_unit_gain():
    rng = np.random.default_rng(3)
    jx, tx = _pair(rng, (6, 128), "float32")
    want = rmsnorm_ref(jx, jnp.ones((128,), jnp.float32))
    np.testing.assert_allclose(_np(trms.rmsnorm(tx)), _np(want),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("x,g,err", [
    (torch.zeros(2, 8), torch.zeros(4), ValueError),
    (torch.zeros(2, 8), torch.zeros(8, dtype=torch.bfloat16), TypeError),
    (torch.zeros(2, 8, dtype=torch.float16), None, TypeError),
])
def test_rmsnorm_rejects_unsupported(x, g, err):
    with pytest.raises(err):
        trms.rmsnorm(x, g)


# ------------------------------------------------------------------ routes
# route() reads dtypes, shapes, strides and data pointers only, so these
# run on meta tensors (whose data pointer is the storage offset in bytes)
# and CPU tensors, with no card.

def _meta(shape, dtype=torch.float32, stride=None, offset=0):
    if stride is None:
        return torch.empty(shape, dtype=dtype, device="meta")
    base = torch.empty(offset + sum((n - 1) * s for n, s in zip(shape, stride))
                       + 1, dtype=dtype, device="meta")
    return base.as_strided(shape, stride, offset)


# chip_smoke.py phase a: rows M of a column slice B = w[:, 32:32 + N] of a
# (K, N + 64) weight, decode and bucket rows, both dtypes
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M", [1, 8, 16, 32, 64])
@pytest.mark.parametrize("K", [2560, 8960])
@pytest.mark.parametrize("N", [48, 1280, 4480])
def test_matmul_route_at_phase_a_shapes(M, K, N, dtype):
    dt = DTYPES[dtype][1]
    w = _meta((K, N + 64), dt)
    assert tmm.route(_meta((M, K), dt), w[:, 32:32 + N]) == \
        ("gemv" if M <= 8 else "tile")


# chip_smoke.py phase c (the rwkv6 tenant at d 2560, ffn 8960, and the
# 64-wide vision tenant): A, then B's shape, strides and offset, as the
# runtime hands them to the GEMM (whole weights and column tiles)
PHASE_C_MM = [
    ((1, 2560), (2560, 2560), (2560, 1), 0, "gemv"),
    ((1, 2560), (2560, 8960), (8960, 1), 0, "gemv"),
    ((1, 8960), (8960, 2560), (2560, 1), 0, "gemv"),
    ((1, 64), (64, 16), (64, 1), 48, "gemv"),
    ((1, 64), (64, 32), (64, 1), 32, "gemv"),
    ((1, 64), (64, 48), (64, 1), 0, "gemv"),
    ((32, 2560), (2560, 2560), (2560, 1), 0, "tile"),
    ((32, 2560), (2560, 8960), (8960, 1), 0, "tile"),
    ((32, 8960), (8960, 2560), (2560, 1), 0, "tile"),
    ((64, 2560), (2560, 1280), (2560, 1), 1280, "tile"),
    ((64, 2560), (2560, 1920), (2560, 1), 0, "tile"),
    ((64, 2560), (2560, 640), (2560, 1), 1920, "tile"),
    ((64, 2560), (2560, 4480), (8960, 1), 4480, "tile"),
    ((64, 8960), (8960, 1920), (2560, 1), 0, "tile"),
    ((64, 8960), (8960, 640), (2560, 1), 1920, "tile"),
]


@pytest.mark.parametrize("ashape,bshape,bstride,boff,want", PHASE_C_MM)
def test_matmul_route_at_phase_c_shapes(ashape, bshape, bstride, boff, want):
    """No served GEMM of phase c takes the scalar route."""
    b = _meta(bshape, stride=bstride, offset=boff)
    assert tmm.route(_meta(ashape), b) == want


@pytest.mark.parametrize("a,b,want32,want16", [
    # batch_matmul's transposed kT: B's innermost stride is not 1
    (lambda dt: _meta((4, 64, 32), dt),
     lambda dt: _meta((4, 64, 32), dt).transpose(1, 2), "scalar", "scalar"),
    # column offsets of 1, 2 and 3 elements: no 16-byte vectors
    (lambda dt: _meta((64, 256), dt),
     lambda dt: _meta((256, 200), dt)[:, 1:129], "scalar", "scalar"),
    (lambda dt: _meta((1, 256), dt),
     lambda dt: _meta((256, 200), dt)[:, 2:130], "scalar", "scalar"),
    (lambda dt: _meta((64, 256), dt),
     lambda dt: _meta((256, 200), dt)[:, 3:131], "scalar", "scalar"),
    # an offset of 4 elements: 16 bytes in fp32, 8 in bf16
    (lambda dt: _meta((64, 256), dt),
     lambda dt: _meta((256, 200), dt)[:, 4:132], "tile", "scalar"),
    (lambda dt: _meta((1, 256), dt),
     lambda dt: _meta((256, 200), dt)[:, 4:132], "gemv", "scalar"),
    # a width of 100: rows 400 bytes apart in fp32, 200 in bf16
    (lambda dt: _meta((64, 64), dt), lambda dt: _meta((64, 100), dt),
     "tile", "scalar"),
    # A a misaligned slice: the tile route reads A in vectors, gemv does not
    (lambda dt: _meta((64, 257), dt)[:, 1:], lambda dt: _meta((256, 64), dt),
     "scalar", "scalar"),
    (lambda dt: _meta((8, 257), dt)[:, 1:], lambda dt: _meta((256, 64), dt),
     "gemv", "gemv"),
    # K 33: A's rows 132 bytes apart; B's rows 65 elements apart
    (lambda dt: _meta((9, 33), dt), lambda dt: _meta((33, 64), dt),
     "scalar", "scalar"),
    (lambda dt: _meta((9, 64), dt), lambda dt: _meta((64, 65), dt),
     "scalar", "scalar"),
    # batched and broadcast operands, leading dims of a dense input
    (lambda dt: _meta((2, 3, 64), dt), lambda dt: _meta((64, 32), dt),
     "gemv", "gemv"),
    (lambda dt: _meta((4, 16, 64), dt), lambda dt: _meta((64, 64), dt),
     "tile", "tile"),
    (lambda dt: _meta((4, 16, 64), dt), lambda dt: _meta((4, 64, 64), dt),
     "tile", "tile"),
], ids=["kT", "off1", "off2-decode", "off3", "off4", "off4-decode",
        "width100", "a-misaligned", "a-misaligned-decode", "k33-a",
        "n65-b", "dense-3d", "m-from-leading", "batched"])
def test_matmul_route_of_views(a, b, want32, want16):
    for dt, want in ((torch.float32, want32), (torch.bfloat16, want16)):
        assert tmm.route(a(dt), b(dt)) == want, dt


def test_matmul_route_on_cpu_tensors():
    """route() reads the real data pointer of a CPU slice."""
    w = torch.zeros(64, 200)
    a = torch.zeros(64, 64)
    assert tmm.route(a, w[:, 8:136]) == "tile"
    assert tmm.route(a, w[:, 9:137]) == "scalar"
    assert tmm.route(a[:1], w[:, 8:136]) == "gemv"


@pytest.mark.parametrize("route", ["gemv", "tile", "scalar"])
@pytest.mark.parametrize("M,N,K", [(1, 48, 2560), (1, 4480, 8960),
                                   (8, 1280, 2560), (16, 48, 8960),
                                   (64, 1280, 2560), (64, 4480, 8960),
                                   (64, 64, 33), (3, 5, 0), (1, 64, 200000)])
def test_matmul_plan_covers_k(route, M, N, K):
    """The split of K: whole chunks of the kernel's step (16 rows, 128 on
    gemv, whose chunk of A, chunk x M rounded up to 1, 2, 4 or 8 floats,
    fits 32 KB of shared memory), covering K with no empty chunk, a
    function of the shape and the SM count alone."""
    if route == "gemv" and M > tmm.GEMV_MAX_M:
        return
    splits, chunk = tmm.plan(route, M, N, K, 132)
    assert chunk % (128 if route == "gemv" else 16) == 0 and chunk >= 16
    if route == "gemv":
        mr = next(r for r in (1, 2, 4, 8) if r >= M)
        assert chunk * mr * 4 <= 32 * 1024
    assert splits >= 1 and splits * chunk >= K
    assert (splits - 1) * chunk < K or splits == 1
    assert tmm.plan(route, M, N, K, 132) == (splits, chunk)
    assert (splits, chunk) in tmm.splits(route, M, N, K)


@pytest.mark.parametrize("M,N,K,route", [
    (1, 4480, 8960, "gemv"), (1, 1280, 2560, "gemv"), (8, 1280, 8960, "gemv"),
    (16, 1280, 2560, "tile"), (64, 1280, 2560, "tile"),
    (64, 4480, 8960, "tile"), (64, 1920, 2560, "tile"),
])
@pytest.mark.parametrize("sms", [132, 114])
def test_matmul_plan_fills_the_card(M, N, K, route, sms):
    """Phase a's and phase c's wider shapes launch a block for nearly every
    SM (64 x 2560 x 1280 has 10 tiles of 64 x 128), on an H100 SXM (132
    SMs) and an H100 PCIe (114)."""
    splits, _ = tmm.plan(route, M, N, K, sms)
    tm, tn = tmm.tile(route, M, N)
    if route == "gemv":
        tiles = -(-N // 128)
    else:
        tiles = -(-M // (8 * tm)) * -(-N // (16 * tn))
    assert tiles * splits >= 0.9 * sms


# M, N -> the tile the wrapper passes to csrc/matmul.cu: gemv's rows held
# (M rounded up to 1, 2, 4 or 8), else (TM, TN) of an 8TM x 16TN block
# tile, 64 rows 128 wide past N 64; the C side compiles these alone
@pytest.mark.parametrize("route,M,N,want", [
    ("gemv", 1, 4480, (1, 0)), ("gemv", 2, 48, (2, 0)),
    ("gemv", 3, 48, (4, 0)), ("gemv", 8, 1280, (8, 0)),
    ("tile", 9, 1280, (2, 4)), ("tile", 16, 4480, (2, 4)),
    ("tile", 17, 48, (4, 4)), ("tile", 32, 1280, (4, 4)),
    ("tile", 33, 64, (8, 4)), ("tile", 64, 65, (8, 8)),
    ("scalar", 1, 1280, (2, 4)), ("scalar", 64, 1280, (8, 8)),
    ("scalar", 4096, 64, (8, 4)),
])
def test_matmul_tile(route, M, N, want):
    assert tmm.tile(route, M, N) == want


# width -> route: rwkv6's ln_x (64) and qwen3's q/k-norm (128) on the warp
# route; olmoe (2048), rwkv6/recurrentgemma and phase c (2560) and qwen3
# (4096) on the block route
@pytest.mark.parametrize("shape,dtype,want", [
    ((4096, 40, 64), "bfloat16", "warp"),      # rwkv6 ln_x, T 4096
    ((1, 40, 64), "bfloat16", "warp"),         # ... at decode
    ((1, 1000, 32, 128), "bfloat16", "warp"),  # qwen3 q-norm, S 1000
    ((1, 1000, 8, 128), "bfloat16", "warp"),   # qwen3 k-norm
    ((1, 1, 8, 128), "bfloat16", "warp"),      # ... at decode
    ((1, 4096, 2048), "bfloat16", "block"),    # olmoe ln
    ((1, 4096, 2560), "bfloat16", "block"),    # recurrentgemma, rwkv6
    ((1, 1000, 4096), "bfloat16", "block"),    # qwen3
    ((64, 2560), "float32", "block"),          # phase c prefill
    ((1, 2560), "float32", "block"),           # phase c decode
    ((5, 100), "bfloat16", "scalar"),          # 100 bf16: 12.5 vectors
    ((5, 100), "float32", "warp"),             # 100 fp32: 25 vectors
    ((5, 512), "float32", "warp"),
    ((5, 1024), "float32", "block"),
    ((5, 1024), "bfloat16", "warp"),
    ((5, 16400), "float32", "scalar"),         # past the block route
])
def test_rmsnorm_route_by_width(shape, dtype, want):
    dt = DTYPES[dtype][1]
    x = _meta(shape, dt)
    assert trms.route(x, _meta(shape[-1:], dt)) == want
    assert trms.route(x) == want


def test_rmsnorm_route_of_views():
    """Misaligned rows or gain take the scalar route; a view with a
    non-unit column stride is made contiguous first."""
    bf = torch.bfloat16
    assert trms.route(_meta((50, 136), bf)[:, 1:129]) == "scalar"
    assert trms.route(_meta((50, 136), bf)[:, 8:136]) == "warp"
    assert trms.route(_meta((50, 132), bf)[:, :128]) == "scalar"   # stride
    assert trms.route(_meta((1, 132), bf)[:, :128]) == "warp"      # one row
    assert trms.route(_meta((50, 128), bf),
                      _meta((129,), bf)[1:]) == "scalar"
    assert trms.route(_meta((128, 50), bf).t()) == "warp"
    assert trms.route(torch.zeros(6, 130)[:, 2:]) == "scalar"      # CPU
    assert trms.route(torch.zeros(6, 132)[:, 4:]) == "warp"


# ------------------------------------------------- the RMSNorm backward
# route_bwd() and grid_bwd() read dtypes, widths, row strides and data
# pointers only, never the row count (route_bwd) or the card (grid_bwd is
# given the SM count): they run on meta and CPU tensors here

# width -> the backward's route: rwkv6's ln_x (64), qwen3's q/k-norm
# (128) and rows up to 1024 bf16 / 512 fp32 on the warp route; wider rows
# (2048 internlm2-1.8b and olmoe, 2560 recurrentgemma, 8192 the widest) on
# the block route; 100 bf16 (12.5 vectors) on the scalar route
RMS_BWD_WIDTHS = {
    64: ("warp", "warp"), 100: ("scalar", "warp"), 128: ("warp", "warp"),
    1000: ("warp", "block"), 1024: ("warp", "block"),
    2048: ("block", "block"), 2560: ("block", "block"),
    8192: ("block", "block"),
}


@pytest.mark.parametrize("d", sorted(RMS_BWD_WIDTHS))
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_rmsnorm_route_bwd_by_width(d, dtype, device):
    want = RMS_BWD_WIDTHS[d][dtype == "float32"]
    dt = DTYPES[dtype][1]
    rows = 4096 if device == "meta" else 3
    x = torch.empty(rows, d, dtype=dt, device=device)
    g = torch.empty(d, dtype=dt, device=device)
    assert trms.route_bwd(x, g, torch.empty_like(x)) == want
    assert trms.route_bwd(x, g) == want
    assert trms.route_bwd(x) == want
    assert trms.route_bwd(x.reshape(rows, 1, d)) == want


def test_rmsnorm_route_bwd_of_views():
    """x, dy or g one element past a 16-byte boundary, or rows an odd
    number of elements apart, take the scalar route; rows 16 bytes wider
    apart than the width keep their vector route (the kernels read the
    row stride); a view with a non-unit column stride is made contiguous
    first; a dy in another dtype is converted first."""
    bf = torch.bfloat16
    x = _meta((50, 128), bf)
    assert trms.route_bwd(_meta((50, 136), bf)[:, 1:129]) == "scalar"
    assert trms.route_bwd(_meta((50, 136), bf)[:, 8:136]) == "warp"
    assert trms.route_bwd(_meta((50, 132), bf)[:, :128]) == "scalar"
    assert trms.route_bwd(_meta((50, 2056), bf)[:, :2048]) == "block"
    assert trms.route_bwd(_meta((50, 2049), bf)[:, :2048]) == "scalar"
    assert trms.route_bwd(x, _meta((129,), bf)[1:]) == "scalar"
    assert trms.route_bwd(x, None, _meta((50, 129), bf)[:, 1:]) == "scalar"
    assert trms.route_bwd(x, None, _meta((50, 136), bf)[:, :128]) == "warp"
    assert trms.route_bwd(x, None, _meta((50, 128))) == "warp"      # fp32 dy
    assert trms.route_bwd(_meta((128, 50), bf).t()) == "warp"
    flat = torch.zeros(6 * 64 + 1)
    assert trms.route_bwd(flat[1:].view(6, 64)) == "scalar"         # CPU
    assert trms.route_bwd(flat[:-1].view(6, 64)) == "warp"


@pytest.mark.parametrize("d", sorted(RMS_BWD_WIDTHS))
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("pad", [0, 8, 1])
def test_rmsnorm_route_bwd_ignores_the_row_count(d, dtype, pad):
    """One row, a few, a prefill's and rwkv6's 163840: the same route, rows
    laid out ``pad`` elements wider apart than the width (a lone row's
    stride is read as any other's)."""
    dt = DTYPES[dtype][1]
    got = {trms.route_bwd(_meta((rows, d), dt, (d + pad, 1)))
           for rows in (1, 2, 7, 4096, 163840)}
    assert len(got) == 1
    if pad == 1:
        assert got == {"scalar"}


def test_rmsnorm_route_bwd_refuses_past_the_widest_row():
    with pytest.raises(ValueError, match="8192"):
        trms.route_bwd(_meta((4, 8200)))
    with pytest.raises(ValueError, match="does not match"):
        trms.route_bwd(_meta((4, 64)), None, _meta((4, 32)))
    with pytest.raises(ValueError, match="no rmsnorm backward route"):
        trms.grid_bwd("simt", 4, 64, 2, 132)


@pytest.mark.parametrize("d,dtype", [(64, "bfloat16"), (1000, "bfloat16"),
                                     (2048, "bfloat16"), (100, "bfloat16"),
                                     (512, "float32"), (2048, "float32"),
                                     (101, "float32")])
@pytest.mark.parametrize("gain", [True, False])
def test_rmsnorm_bwd_on_cpu_is_the_plain_version(d, dtype, gain):
    """On CPU tensors the wrapper is its plain version, bitwise, whatever
    route the same operands would take on the card."""
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_bwd_ref
    dt = DTYPES[dtype][1]
    rng = np.random.default_rng(d)
    x, dy = (torch.from_numpy(rng.normal(size=(5, 3, d)).astype(np.float32)
                              ).to(dt) for _ in range(2))
    g = torch.from_numpy(1 + 0.1 * rng.normal(size=d).astype(
        np.float32)).to(dt) if gain else None
    got, want = trms.rmsnorm_bwd(x, g, dy), rmsnorm_bwd_ref(x, g, dy)
    assert torch.equal(got[0], want[0])
    assert got[1] is None if not gain else torch.equal(got[1], want[1])


# (rows, width, element size): phase i's rows (internlm2-1.8b bf16 and the
# fp32 check, rwkv6-3b's ln_x, qwen3's q-norm width, recurrentgemma-2b)
# and the widest rows
RMS_BWD_GRID_ROWS = [(4096, 2048, 2), (256, 2048, 4), (163840, 64, 2),
                     (131072, 128, 2), (4096, 2560, 2), (4096, 8192, 2),
                     (4096, 8192, 4), (32000, 1024, 2), (5, 64, 2),
                     (1, 2048, 2)]


@pytest.mark.parametrize("rows,d,size", RMS_BWD_GRID_ROWS)
@pytest.mark.parametrize("sms", [132, 114])
def test_rmsnorm_grid_bwd_fills_the_card_once(rows, d, size, sms):
    """Every block of the row kernel resident at once (at most the route's
    blocks an SM: 4, 2 or 1 on the warp route as a lane holds 1, 2 or 4
    vectors; on the block route up to 4, as its ring of rows and its
    registers at the kernel's cap fit), at least one block an SM where the
    rows allow it, and no warp or block more than one row group ahead of
    another."""
    x = _meta((rows, d), torch.bfloat16 if size == 2 else torch.float32)
    route = trms.route_bwd(x)
    blocks = trms.grid_bwd(route, rows, d, size, sms)
    assert 1 <= blocks <= rows
    e = 16 // size
    nvec = d // e
    if route == "warp":
        lanes = min(32, 1 << max(0, nvec - 1).bit_length())
        group = 32 // lanes * (2 if nvec <= 32 else 1)
        groups = -(-rows // group)
        vecs = 1 if nvec <= 32 else 2 if nvec <= 64 else 4
        assert blocks <= 4 // vecs * sms
        warps = blocks * trms.BWD_WARPS
        # grid-stride: each warp walks floor or ceil of groups / warps
        assert -(-groups // warps) - groups // warps <= 1
        if groups >= trms.BWD_WARPS * sms:
            assert blocks >= sms
    else:
        row_bytes = 2 * d * size
        stages = min(trms.BWD_MAX_STAGES,
                     max(2, 1 + -(-trms.BWD_RING_BYTES // row_bytes)))
        vecs = 2 if nvec <= 256 else 4 if nvec <= 512 else 8
        threads = -(-nvec // vecs + 31) // 32 * 32
        per_sm = -(-blocks // sms)
        assert per_sm <= 4
        assert per_sm * (stages * row_bytes + 1024) <= trms.SMEM_PER_SM
        assert per_sm * threads * (256 if vecs == 8 else 128) <= 65536
        if rows >= sms:
            assert blocks >= sms
        assert -(-rows // blocks) - rows // blocks <= 1


def test_rmsnorm_bwd_constants_match_the_kernels():
    """The launch shapes grid_bwd() reckons with are the ones
    csrc/rmsnorm_bwd.cu compiles."""
    import re
    from pathlib import Path
    src = (Path(trms.__file__).resolve().parents[2] / "csrc" /
           "rmsnorm_bwd.cu").read_text()

    def const(name):
        # an integer, or a product of two ("24 * 1024")
        m = re.search(rf"constexpr int {name} = (\d+)(?: \* (\d+))?;", src)
        return int(m.group(1)) * int(m.group(2) or 1)

    assert const("WARP_THREADS") // 32 == trms.BWD_WARPS
    assert const("RING_BYTES") == trms.BWD_RING_BYTES
    assert const("MAX_STAGES") == trms.BWD_MAX_STAGES
    assert const("MAX_WIDTH") == trms.BWD_MAX_WIDTH
    assert const("WARP_MAX_VECS") == trms.WARP_MAX_VECS
