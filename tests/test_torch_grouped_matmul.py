"""The port's grouped-matmul wrapper on CPU tensors (its plain version)
against the JAX package: the Pallas kernel in interpret mode over the
sweep of tests/test_kernels.py, the wrapper's dispatch and checks, and
the reference-side fault that the MoE serving shapes expose (the Pallas
kernel asserts that its 128-row block divides C).  Inputs are made with
numpy from a seed and given to both packages."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.grouped_matmul.grouped_matmul import grouped_matmul_pallas
from repro.kernels.grouped_matmul.ref import grouped_matmul_ref as jax_ref
from repro_torch.kernels.grouped_matmul import grouped_matmul as tgmm
from repro_torch.kernels.grouped_matmul.ref import grouped_matmul_ref

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": 1e-3, "bfloat16": 5e-2}       # tests/test_kernels.py's


def _pair(seed, shape, dtype):
    """One normal tensor as a (JAX array, CPU tensor) pair of the same
    values (rounded to ``dtype`` once, on the torch side)."""
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    t = torch.from_numpy(x).to(DTYPES[dtype][1])
    return jnp.asarray(t.float().numpy()).astype(DTYPES[dtype][0]), t


def _np(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor)
                      else jnp.asarray(x, jnp.float32))


# tests/test_kernels.py's sweep
SWEEP = [(4, 128, 256, 128, "float32"), (8, 64, 128, 64, "bfloat16"),
         (2, 256, 64, 256, "float32")]


@pytest.mark.parametrize("E,C,D,F,dtype", SWEEP)
def test_plain_version_matches_pallas(E, C, D, F, dtype):
    jx, tx = _pair(0, (E, C, D), dtype)
    jw, tw = _pair(1, (E, D, F), dtype)
    want = grouped_matmul_pallas(jx, jw, block_c=64, block_f=64, block_d=64,
                                 interpret=True)
    got = grouped_matmul_ref(tx, tw)
    assert got.dtype == DTYPES[dtype][1] and got.shape == (E, C, F)
    np.testing.assert_allclose(_np(got), _np(want), atol=TOL[dtype],
                               rtol=TOL[dtype])


# the sweep, then the MoE serving rows the Pallas kernel cannot take:
# olmoe decode (C = 8) and ragged C, D and F
@pytest.mark.parametrize("E,C,D,F,dtype", SWEEP + [
    (5, 8, 48, 32, "bfloat16"), (3, 40, 33, 65, "float32")])
def test_wrapper_on_cpu_runs_the_plain_version(E, C, D, F, dtype):
    """CPU tensors go to the plain version (no launch counted), which
    agrees with the JAX package's plain version."""
    jx, tx = _pair(2, (E, C, D), dtype)
    jw, tw = _pair(3, (E, D, F), dtype)
    before = tgmm.launches
    got = tgmm.grouped_matmul(tx, tw)
    assert tgmm.launches == before
    assert torch.equal(got, grouped_matmul_ref(tx, tw))
    np.testing.assert_allclose(_np(got), _np(jax_ref(jx, jw)),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("view", ["expert-strided", "transposed"])
def test_strided_x_on_cpu(view):
    """x as a view (every third row block of a wider buffer, or the
    transpose of a (E, D, C) tensor) gives the contiguous result."""
    if view == "expert-strided":
        x = _pair(4, (3, 3, 24, 32), "float32")[1][:, 0]
    else:
        x = _pair(4, (3, 32, 24), "float32")[1].transpose(1, 2)
    _, w = _pair(5, (3, 32, 16), "float32")
    assert x.shape == (3, 24, 32) and not x.is_contiguous()
    torch.testing.assert_close(tgmm.grouped_matmul(x, w),
                               grouped_matmul_ref(x.contiguous(), w))


@pytest.mark.parametrize("x,w,err", [
    (torch.zeros(2, 8, 16), torch.zeros(3, 16, 4), ValueError),   # E
    (torch.zeros(2, 8, 16), torch.zeros(2, 12, 4), ValueError),   # D
    (torch.zeros(8, 16), torch.zeros(16, 4), ValueError),         # rank
    (torch.zeros(2, 8, 16), torch.zeros(2, 16, 4, dtype=torch.bfloat16),
     TypeError),
    (torch.zeros(2, 8, 16, dtype=torch.float16),
     torch.zeros(2, 16, 4, dtype=torch.float16), TypeError),
    # storage-less tensors are checked too, before their shape-only branch
    (torch.zeros(2, 8, 16, device="meta"), torch.zeros(3, 16, 4,
                                                       device="meta"),
     ValueError),
])
def test_rejects_unsupported(x, w, err):
    with pytest.raises(err):
        tgmm.grouped_matmul(x, w)


def test_storageless_operands_give_shapes_and_the_kernels_count():
    """Meta (or fake) operands take the dry run's branch: no kernel, no
    plain version, an output of the product's shape and dtype, and the
    kernel's operations and bytes in ``kernels/dry.py``'s tally (the
    counts behind PERF.md's bound); under grad a backward of the inputs'
    shapes adds the backward kernels' counts."""
    from repro_torch.kernels import dry
    dry.reset()
    x = torch.empty(4, 24, 32, dtype=torch.bfloat16, device="meta",
                    requires_grad=True)
    w = torch.empty(4, 32, 16, dtype=torch.bfloat16, device="meta",
                    requires_grad=True)
    y = tgmm.grouped_matmul(x, w)
    assert (y.shape, y.dtype, y.device.type) == ((4, 24, 16), x.dtype,
                                                 "meta")
    assert dry.calls == {"grouped_matmul": 1}
    assert dry.flops == 2.0 * 4 * 24 * 32 * 16
    assert dry.nbytes == (4 * 24 * 32 + 4 * 32 * 16 + 4 * 24 * 16) * 2
    dx, dw = torch.autograd.grad(y, (x, w), torch.empty_like(y))
    assert (dx.shape, dw.shape) == (x.shape, w.shape)
    assert dry.calls == {"grouped_matmul": 1, "grouped_matmul_bwd": 1}
    assert dry.flops == 6.0 * 4 * 24 * 32 * 16


def test_pallas_asserts_at_a_serving_capacity():
    """Reference-side fault (ROADMAP Queue 3): olmoe-1b-7b's prefill of
    1000 tokens dispatches C = 160 rows per expert; the Pallas kernel's
    default 128-row block does not divide it, and the kernel asserts.  The
    port's plain version takes the shape and matches a numpy einsum."""
    jx, tx = _pair(6, (2, 160, 128), "float32")
    jw, tw = _pair(7, (2, 128, 128), "float32")
    with pytest.raises(AssertionError):
        grouped_matmul_pallas(jx, jw, interpret=True)
    want = np.einsum("ecd,edf->ecf", tx.numpy().astype(np.float64),
                     tw.numpy().astype(np.float64))
    np.testing.assert_allclose(grouped_matmul_ref(tx, tw).numpy(), want,
                               atol=1e-4, rtol=1e-4)


# E, C, D, F of the MoE serving path: olmoe-1b-7b's gate/up GEMM at C 8
# (decode), 16, 48, 160 and 648 (prefill of 77, 256, 1000 and 4096
# tokens), its down GEMM at C 160, granite-moe-3b-a800m's gate at C 256
SERVING = [(64, 8, 2048, 1024), (64, 16, 2048, 1024), (64, 48, 2048, 1024),
           (64, 160, 2048, 1024), (64, 648, 2048, 1024),
           (64, 160, 1024, 2048), (40, 256, 1536, 512)]


def _meta(shape, dtype):
    """A tensor with shape, strides and a data pointer, and no storage."""
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("E,C,D,F", SERVING)
@pytest.mark.parametrize("dtype,want", [(torch.bfloat16, "wgmma"),
                                        (torch.float32, "simt")])
def test_route_at_the_serving_shapes(E, C, D, F, dtype, want):
    """Contiguous bf16 operands take the tensor-core kernel; fp32 takes
    the SIMT one (the fp32 contract allows no TF32)."""
    assert tgmm.route(_meta((E, C, D), dtype), _meta((E, D, F), dtype)) \
        == want


@pytest.mark.parametrize("x,w,want", [
    # x the transpose of an (E, D, C) tensor: its innermost stride is C
    (_meta((64, 2048, 160), torch.bfloat16).transpose(1, 2),
     _meta((64, 2048, 1024), torch.bfloat16), "simt"),
    # D or F not a multiple of 8
    (_meta((40, 17, 100), torch.bfloat16),
     _meta((40, 100, 7), torch.bfloat16), "simt"),
    (_meta((5, 40, 33), torch.bfloat16),
     _meta((5, 33, 64), torch.bfloat16), "simt"),
    (_meta((5, 40, 64), torch.bfloat16),
     _meta((5, 64, 65), torch.bfloat16), "simt"),
    # ragged C, D 1000 and F 200 (multiples of 8)
    (_meta((40, 104, 1000), torch.bfloat16),
     _meta((40, 1000, 200), torch.bfloat16), "wgmma"),
    (_meta((4, 17, 256), torch.bfloat16),
     _meta((4, 256, 192), torch.bfloat16), "wgmma"),
    # a column slice of a wider w: 8 columns in (16 bytes) keeps the
    # alignment, 4 columns in (8 bytes) breaks it
    (_meta((40, 24, 96), torch.bfloat16),
     _meta((40, 96, 88), torch.bfloat16)[:, :, 8:80], "wgmma"),
    (_meta((40, 24, 96), torch.bfloat16),
     _meta((40, 96, 88), torch.bfloat16)[:, :, 4:76], "simt"),
    # x one of two row blocks per expert: strides stay 16-byte multiples
    (_meta((40, 2, 24, 96), torch.bfloat16)[:, 1],
     _meta((40, 96, 72), torch.bfloat16), "wgmma"),
    # a row stride that is not a multiple of 16 bytes
    (_meta((8, 16, 100), torch.bfloat16)[:, :, :96],
     _meta((8, 96, 64), torch.bfloat16), "simt"),
    # an expert stride of 0 (one x broadcast to every expert)
    (_meta((1, 16, 64), torch.bfloat16).expand(8, 16, 64),
     _meta((8, 64, 64), torch.bfloat16), "simt"),
    # D = 0: nothing for TMA to load
    (_meta((4, 8, 0), torch.bfloat16), _meta((4, 0, 64), torch.bfloat16),
     "simt"),
    # mixed or fp32 operands
    (_meta((4, 8, 64), torch.float32), _meta((4, 64, 64), torch.float32),
     "simt"),
])
def test_route_of_views_and_widths(x, w, want):
    assert tgmm.route(x, w) == want


def test_route_on_cpu_tensors():
    """route() reads the data pointer: a real CPU slice whose offset is
    16 bytes stays on the tensor-core route, one of 8 bytes leaves it."""
    base = torch.zeros(3, 32, 88, dtype=torch.bfloat16)
    x = torch.zeros(3, 16, 32, dtype=torch.bfloat16)
    assert base.data_ptr() % 16 == 0
    assert tgmm.route(x, base[:, :, 8:72]) == "wgmma"
    assert tgmm.route(x, base[:, :, 4:68]) == "simt"


@pytest.mark.parametrize("E,C,D,F", [(5, 8, 48, 32), (3, 17, 64, 40)])
def test_cpu_bf16_runs_the_plain_version_whatever_the_route(E, C, D, F):
    """A CPU tensor on the tensor-core route still runs the plain version:
    no launch and no route counted, the result equal to the plain one."""
    _, tx = _pair(8, (E, C, D), "bfloat16")
    _, tw = _pair(9, (E, D, F), "bfloat16")
    assert tgmm.route(tx, tw) == "wgmma"
    before, routes = tgmm.launches, dict(tgmm.routes)
    got = tgmm.grouped_matmul(tx, tw)
    assert tgmm.launches == before and tgmm.routes == routes
    assert torch.equal(got, grouped_matmul_ref(tx, tw))


# E, C, D, F, dtype, the backward's route (both products): granite's
# training products at B4 S1024 (C = 4 x 264), olmoe's, a ragged C, odd
# widths, fp32
BWD_ROUTES = [
    (40, 1056, 1536, 512, torch.bfloat16, "wgmma"),
    (40, 1056, 512, 1536, torch.bfloat16, "wgmma"),
    (64, 2592, 2048, 1024, torch.bfloat16, "wgmma"),
    (4, 17, 256, 192, torch.bfloat16, "wgmma"),
    (40, 1056, 1536, 512, torch.float32, "simt"),
    (40, 17, 100, 7, torch.bfloat16, "simt"),
    (4, 16, 256, 100, torch.bfloat16, "simt"),
    (4, 16, 100, 64, torch.bfloat16, "simt"),
]


@pytest.mark.parametrize("E,C,D,F,dtype,want", BWD_ROUTES)
def test_route_bwd_by_dtype_and_widths(E, C, D, F, dtype, want):
    """route_bwd() names the one route of both products: the tensor cores for
    bf16 with D and F multiples of 8 (any C: the kernel reads x, w and dy
    in place), SIMT otherwise.  Pure: shapes and dtypes (meta tensors),
    whatever the forward operands' strides."""
    x, w = _meta((E, C, D), dtype), _meta((E, D, F), dtype)
    assert tgmm.route_bwd(x, w) == want
    assert tgmm.route_bwd(_meta((E, D, C), dtype).transpose(1, 2),
                          w) == want


@pytest.mark.parametrize("pick,step", [("tile_rows", 8),
                                       ("tile_rows64", 64)])
def test_tile_rows_cover_in_equal_tiles(pick, step):
    """tile_rows() (dx's and the forward's C tiles, a K-major B) splits any
    row count into equal tiles of at most 256 rows in steps of 8 with no
    empty tile; tile_rows64() (dw's D tiles, an MN-major B) the same in
    whole 64-column atoms."""
    for rows in list(range(1, 1100)) + [2592, 4096]:
        n = getattr(tgmm, pick)(rows)
        tiles = -(-rows // n)
        assert n % step == 0 and step <= n <= 256
        assert tiles == -(-rows // 256)          # as few tiles as 256 allow
        assert (tiles - 1) * n < rows <= tiles * n


def test_plan_bwd_at_granite():
    """granite-moe-3b-a800m's training products (C = 1056 rows an expert):
    dx's C tiles are 5 x 216 (1080 rows, 2% past C; 64-row atoms would
    take 5 x 256, 21%), dw's D tiles whole atoms of 64, and the persistent
    blocks one an SM."""
    for D, F in ((1536, 512), (512, 1536)):
        n, tiles, blocks = tgmm.plan_bwd(0, 40, 1056, D, F, 132)
        assert (n, -(-1056 // n)) == (216, 5)
        assert tiles == 40 * 5 * D // tgmm.TILE_M and blocks == 132
        assert (5 * n - 1056) / 1056 < 0.03
        n, tiles, blocks = tgmm.plan_bwd(1, 40, 1056, D, F, 132)
        assert n % 64 == 0 and D % n == 0
        assert tiles == 40 * (F // tgmm.TILE_M) * (D // n) and blocks == 132


@pytest.mark.parametrize("E,C,D,F", [(40, 1056, 1536, 512), (3, 40, 48, 32),
                                     (2, 150, 160, 72), (2, 300, 200, 264),
                                     (1, 5, 8, 8), (64, 8, 2048, 1024)])
@pytest.mark.parametrize("sms", [132, 114, 1])
def test_plan_bwd_tiles_and_blocks(E, C, D, F, sms):
    """plan_bwd() covers each product's output with its tiles (dx: D in
    TILE_M rows, C in tile_rows(C); dw: F in TILE_M, D in tile_rows64(D)),
    and runs min(tiles, SMs) persistent blocks: never more blocks than
    tiles, never more than the card's SMs.  Pure: shapes and the count."""
    n, tiles, blocks = tgmm.plan_bwd(0, E, C, D, F, sms)
    assert n == tgmm.tile_rows(C) and n % 8 == 0
    assert tiles == E * -(-D // tgmm.TILE_M) * -(-C // n)
    assert blocks == min(tiles, sms)
    n, tiles, blocks = tgmm.plan_bwd(1, E, C, D, F, sms)
    assert n == tgmm.tile_rows64(D) and n % 64 == 0
    assert tiles == E * -(-F // tgmm.TILE_M) * -(-D // n)
    assert blocks == min(tiles, sms)
    with pytest.raises(ValueError):
        tgmm.plan_bwd(2, E, C, D, F, sms)


def test_plan_bwd_matches_the_source():
    """The planner's constants and picks are csrc/grouped_matmul.cu's: the
    tile's output columns, an instance for every C tile a K-major B can
    take (8 to 256 in steps of 8, the forward's and dx's) and for every D
    tile of dw's MN-major B; the plan is the wrapper's alone (the C side
    launches the instance it names and plans nothing)."""
    import re
    from pathlib import Path
    src = (Path(tgmm.__file__).resolve().parents[2] / "csrc"
           / "grouped_matmul.cu").read_text()
    assert int(re.search(r"constexpr int BM = (\d+);", src).group(1)) \
        == tgmm.TILE_M
    cases = re.search(r"#define REPRO_GMM_CASES\(CASE\)(.*?)\n\n", src,
                      re.S).group(1)
    assert sorted(int(n) for n in re.findall(r"CASE\((\d+)\)", cases)) \
        == list(range(8, 257, 8))
    assert "REPRO_GMM_CASES(REPRO_GMM_DX_CASE)" in src
    dw = sorted(int(n) for n in re.findall(r"REPRO_GMM_DW_CASE\((\d+)\)",
                                           src))
    assert dw == [64, 128, 192, 256]
    assert {tgmm.tile_rows(c) for c in range(1, 4097)} \
        == set(range(8, 257, 8))
    assert {tgmm.tile_rows64(d) for d in range(1, 4097)} == set(dw)
    assert "REPRO_GMM_CASES(REPRO_GMM_CASE)" in src
    assert "tile_rows" not in src and "sm_count" not in src


@pytest.mark.parametrize("E,C,F", [(64, 160, 1024), (64, 8, 2048),
                                   (40, 1056, 1536), (2, 4096, 8),
                                   (1, 1, 1)])
@pytest.mark.parametrize("sms", [132, 1])
def test_plan_forward_tiles_and_blocks(E, C, F, sms):
    """plan() of the forward's (E,C,F): C tiles of tile_rows(C) rows in
    8-row steps (up to 256 rows, a capacity that is a multiple of 8
    multiplies no pad row), F in TILE_M columns, min(tiles, SMs)
    persistent blocks; and plan_bwd() is plan() on dx's (E,C,D) and dw's
    (E,D,F)."""
    n, tiles, blocks = tgmm.plan(E, C, F, sms)
    assert n == tgmm.tile_rows(C)
    assert C % 8 or C > 256 or n == C
    assert tiles == E * -(-F // tgmm.TILE_M) * -(-C // n)
    assert blocks == min(tiles, sms) >= 1
    assert tgmm.plan_bwd(0, E, C, F, 8, sms) == tgmm.plan(E, C, F, sms)
    assert tgmm.plan_bwd(1, E, 8, C, F, sms) \
        == tgmm.plan(E, C, F, sms, tgmm.tile_rows64)


def _t(shape, dtype=torch.float32):
    return _meta(shape, dtype)


# x, w, (x's contiguous axis, w's, x's copy bytes, w's, rows a block):
# the forward contiguous (olmoe-1b-7b S1000, fp32), x a transposed view
# (bf16), w a transposed view, the backward's dy wᵀ and xᵀ dy views at
# granite-moe-3b-a800m's training shapes (fp32: both products SIMT),
# misaligned slices (element copies), strides that are not unit on either
# axis, a broadcast x (expert stride 0), odd widths, C <= 16
PLAN_SIMT = [
    (_t((64, 160, 2048)), _t((64, 2048, 1024)), ("k", "mn", 16, 16, 80)),
    (_t((64, 2048, 160), torch.bfloat16).transpose(1, 2),
     _t((64, 2048, 1024), torch.bfloat16), ("mn", "mn", 16, 16, 80)),
    (_t((64, 160, 2048)), _t((64, 1024, 2048)).transpose(1, 2),
     ("k", "k", 16, 16, 80)),
    (_t((40, 1056, 512)), _t((40, 1536, 512)).transpose(1, 2),
     ("k", "k", 16, 16, 128)),
    (_t((40, 1056, 1536)).transpose(1, 2), _t((40, 1056, 512)),
     ("mn", "mn", 16, 16, 128)),
    (_t((40, 1056, 1536)), _t((40, 512, 1536)).transpose(1, 2),
     ("k", "k", 16, 16, 128)),
    (_t((40, 1056, 512)).transpose(1, 2), _t((40, 1056, 1536)),
     ("mn", "mn", 16, 16, 128)),
    (_t((40, 24, 96)), _t((40, 96, 88))[:, :, 1:73], ("k", "mn", 16, 4, 16)),
    (_t((8, 16, 100), torch.bfloat16)[:, :, :96],
     _t((8, 96, 64), torch.bfloat16), ("k", "mn", 2, 16, 16)),
    (_t((4, 40, 128))[:, :, ::2], _t((4, 64, 72)), ("k", "mn", 4, 16, 16)),
    (_t((1, 16, 64), torch.bfloat16).expand(8, 16, 64),
     _t((8, 64, 64), torch.bfloat16), ("k", "mn", 16, 16, 16)),
    (_t((40, 17, 100), torch.bfloat16), _t((40, 100, 7), torch.bfloat16),
     ("k", "mn", 2, 2, 16)),
    (_t((64, 8, 2048)), _t((64, 2048, 1024)), ("k", "mn", 16, 16, 16)),
]


@pytest.mark.parametrize("x,w,want", PLAN_SIMT)
def test_plan_simt_reads_each_orientation_in_place(x, w, want):
    """plan_simt() names each operand's contiguous axis (K, or C for x
    and F for w) and its copy width (16 bytes, or the element size where
    the axis is misaligned or not of unit stride) from the strides and
    the pointer alone, for the views the backward passes too (dy wᵀ: both
    K-contiguous; xᵀ dy: both M/N-contiguous): no operand is copied.  The
    tile: 80 rows at olmoe's C 160 (two, no padding), 128 at granite's
    1056 (nine), 16 at C <= 16 and where the grid is small."""
    p = tgmm.plan_simt(x, w, 132)
    assert (p.x_axis, p.w_axis, p.x_copy, p.w_copy, p.rows) == want
    assert p.threads == tgmm.simt_threads(p.rows)
    assert p.threads == (128 if p.rows == 16 else p.rows * 2)


@pytest.mark.parametrize("sms", [132, 114, 1])
def test_plan_simt_tiles_cover_ragged_edges(sms):
    """simt_rows() covers any C with its tiles (no empty tile) and always
    names an instance the source compiles: the smallest that holds C's
    equal split into tiles of at most the largest, where that grid fills
    the ``sms`` SMs; else the largest smaller one whose grid does, or the
    smallest; 16 rows at C <= 16.  Pure: shapes and the SM count."""
    for E in (1, 3, 40, 64):
        for C in list(range(1, 300, 7)) + [1056, 2592, 4096]:
            for F in (7, 128, 136, 1024):
                rows = tgmm.simt_rows(E, C, F, sms)
                tiles = -(-C // rows)
                assert rows in tgmm.SIMT_ROWS
                assert (tiles - 1) * rows < C <= tiles * rows or C < rows
                split = -(-C // -(-C // max(tgmm.SIMT_ROWS)))
                fits = min(r for r in tgmm.SIMT_ROWS if r >= split)

                def blocks(r):
                    return E * -(-C // r) * -(-F // tgmm.SIMT_BN)
                if C <= 16:
                    assert rows == 16
                if blocks(fits) >= sms:
                    assert rows == fits
                else:
                    assert rows == max([r for r in tgmm.SIMT_ROWS
                                        if r < fits and blocks(r) >= sms],
                                       default=min(tgmm.SIMT_ROWS))


def test_plan_simt_matches_the_source():
    """The planner's instances and constants are the SIMT kernel's
    (csrc/grouped_matmul_simt.cu): 128-column tiles, one instance for each
    row count the planner picks (SIMT_ROWS, each picked) on rows / 8 x 16
    threads (128 at 16 rows), no atomics; the C side plans nothing."""
    import re
    from pathlib import Path
    simt = (Path(tgmm.__file__).resolve().parents[2] / "csrc"
            / "grouped_matmul_simt.cu").read_text()
    assert int(re.search(r"constexpr int BN = (\d+);", simt).group(1)) \
        == tgmm.SIMT_BN
    cases = re.search(r"#define REPRO_SIMT_ROWS\(CASE\)(.*?)\n\n", simt,
                      re.S).group(1)
    rows = sorted(int(n) for n in re.findall(r"CASE\((\d+)\)", cases))
    assert rows == list(tgmm.SIMT_ROWS)
    assert {tgmm.simt_rows(E, C, 1024, 132) for E in (1, 64)
            for C in range(1, 1200)} == set(rows)
    assert "TM = ROWS == 16 ? 2 : 8;" in simt
    assert "THREADS = ROWS / TM * (BN / 8)" in simt
    assert "simt_rows" not in simt and "sm_count" not in simt
    assert not re.search(r"\batomic\w*\s*\(", simt)     # no atomics
