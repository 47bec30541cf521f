"""The port's WKV6 wrapper on CPU tensors (its plain version) against the
JAX package: the Pallas kernel in interpret mode over the sweep of
tests/test_kernels.py, and the JAX package's exact recurrence at a
ragged T and at strong decays, which the Pallas kernel cannot take.  The
range where the Pallas kernel's chunked rescaling leaves fp32 is kept as
an expected failure of the reference.  Inputs are made with numpy from a
seed and given to both packages."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rwkv_scan.ref import wkv6_ref as jax_ref
from repro.kernels.rwkv_scan.rwkv_scan import wkv6_pallas
from repro_torch.kernels.rwkv_scan import rwkv_scan as twkv
from repro_torch.kernels.rwkv_scan.ref import wkv6_ref

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(seed, B, T, H, D, dtype="float32", w=None):
    """r, k, v, w (B,T,H,D) and u (H,D) as (JAX array, CPU tensor) pairs
    of the same values.  The decay is Finch's exp(-exp(x / 2)) unless
    ``w`` (a constant or a (lo, hi) uniform range) is given."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(B, T, H, D)) for _ in range(3))
    if w is None:
        wv = np.exp(-np.exp(rng.normal(size=(B, T, H, D)) * 0.5))
    elif isinstance(w, tuple):
        wv = rng.uniform(*w, size=(B, T, H, D))
    else:
        wv = np.full((B, T, H, D), w)
    u = rng.normal(size=(H, D)) * 0.5
    out = []
    for x in (r, k, v, wv, u):
        t = torch.from_numpy(x.astype(np.float32)).to(DTYPES[dtype][1])
        out.append((jnp.asarray(t.float().numpy()).astype(DTYPES[dtype][0]),
                    t))
    return out


def _np(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor)
                      else jnp.asarray(x, jnp.float32))


def _assert_close(got, want, tol, what):
    for g, w, name in zip(got, want, ("y", "S")):
        assert g.shape == tuple(w.shape), (what, name)
        np.testing.assert_allclose(_np(g), _np(w), atol=tol, rtol=tol,
                                   err_msg=f"{what} {name}")


# B, T, H, D, chunk: tests/test_kernels.py's sweep
SWEEP = [(2, 128, 2, 32, 32), (1, 64, 4, 16, 16), (1, 96, 1, 64, 32)]


@pytest.mark.parametrize("B,T,H,D,chunk", SWEEP)
def test_wkv6_matches_pallas(B, T, H, D, chunk):
    (jr, r), (jk, k), (jv, v), (jw, w), (ju, u) = _inputs(0, B, T, H, D)
    want = wkv6_pallas(jr, jk, jv, jw, ju, chunk=chunk, interpret=True)
    before = twkv.launches
    got = twkv.wkv6(r, k, v, w, u)
    assert twkv.launches == before        # CPU tensors: no kernel
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.float32
    _assert_close(got, want, 5e-3, "pallas")


# the exact recurrence where the Pallas kernel cannot go: a ragged T (it
# asserts T % chunk == 0) and decays of 0.05 and below
@pytest.mark.parametrize("T,w", [(77, None), (77, 0.05), (64, 0.01),
                                 (33, (1e-4, 0.05)), (1, None)])
def test_wkv6_matches_jax_exact_recurrence(T, w):
    (jr, r), (jk, k), (jv, v), (jw, wt), (ju, u) = _inputs(1, 2, T, 2, 32,
                                                          w=w)
    _assert_close(twkv.wkv6(r, k, v, wt, u), jax_ref(jr, jk, jv, jw, ju),
                  1e-5, "exact")


def test_wkv6_bf16_inputs_match_jax():
    """bf16 r/k/v/w: both compute in fp32 from the same bf16 values and
    round y to bf16 once (one bf16 ulp apart at most); S stays fp32."""
    (jr, r), (jk, k), (jv, v), (jw, w), (ju, u) = _inputs(
        2, 1, 40, 2, 64, "bfloat16")
    got = twkv.wkv6(r, k, v, w, u)
    assert got[0].dtype == torch.bfloat16 and got[1].dtype == torch.float32
    _assert_close(got, jax_ref(jr, jk, jv, jw, ju), 1e-2, "bf16")


def test_wkv6_from_a_state_matches_jax():
    (jr, r), (jk, k), (jv, v), (jw, w), (ju, u) = _inputs(3, 2, 9, 2, 16)
    s0 = np.random.default_rng(3).normal(size=(2, 2, 16, 16)) \
        .astype(np.float32)
    _assert_close(wkv6_ref(r, k, v, w, u, torch.from_numpy(s0)),
                  jax_ref(jr, jk, jv, jw, ju, jnp.asarray(s0)), 1e-5,
                  "state")


@pytest.mark.parametrize("w", [0.5, 0.1])
def test_pallas_in_range_for_mild_decays(w):
    """Constant decays of 0.1 and above over 32-token chunks keep the
    Pallas kernel's 1/A rescaling inside fp32 (the range table's finite
    rows)."""
    (jr, _), (jk, _), (jv, _), (jw, _), (ju, _) = _inputs(4, 1, 64, 2, 32,
                                                          w=w)
    got = wkv6_pallas(jr, jk, jv, jw, ju, interpret=True)
    assert all(np.isfinite(_np(g)).all() for g in got)
    _assert_close(got, jax_ref(jr, jk, jv, jw, ju), 5e-3, "pallas")


@pytest.mark.xfail(strict=True, reason=(
    "reference-side fault: wkv6_pallas divides k by the cumulative decay "
    "exp(logA) of its 32-token chunk (src/repro/kernels/rwkv_scan/"
    "rwkv_scan.py:48-53), which overflows fp32 once a chunk's summed "
    "-log w passes ~88, i.e. w <= 0.05; the port's kernel steps the exact "
    "recurrence instead"))
@pytest.mark.parametrize("w", [0.05, 0.01])
def test_pallas_overflows_for_strong_decays(w):
    (jr, _), (jk, _), (jv, _), (jw, _), (ju, _) = _inputs(4, 1, 64, 2, 32,
                                                          w=w)
    got = wkv6_pallas(jr, jk, jv, jw, ju, interpret=True)
    assert all(np.isfinite(_np(g)).all() for g in got)
    _assert_close(got, jax_ref(jr, jk, jv, jw, ju), 5e-3, "pallas")


def _t(*shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype)


@pytest.mark.parametrize("args,err", [
    ((_t(1, 4, 2, 24),) * 4 + (_t(2, 24),), ValueError),      # head width
    ((_t(1, 4, 2, 16),) * 3 + (_t(1, 4, 2, 16, dtype=torch.bfloat16),
                               _t(2, 16)), TypeError),          # mixed dtypes
    ((_t(1, 4, 2, 16),) * 3 + (_t(1, 5, 2, 16), _t(2, 16)), ValueError),
    ((_t(1, 4, 2, 16),) * 4 + (_t(1, 16),), ValueError),        # u shape
    ((_t(4, 2, 16),) * 4 + (_t(2, 16),), ValueError),           # not 4-D
    ((_t(1, 4, 2, 16, dtype=torch.float16),) * 4 + (_t(2, 16),), TypeError),
])
def test_wkv6_rejects_unsupported(args, err):
    with pytest.raises(err):
        twkv.wkv6(*args)


# rwkv6-3b's K4 shapes (B, T) at H40 D64: phase e's prompts, with phase a's
# serving rows among them; then phase a's sweep rows (B, T, H, D)
SERVED = [(1, 77), (1, 256), (1, 1000), (1, 4096), (2, 128)]
SWEEP_ROWS = [(2, 128, 2, 32), (1, 64, 4, 16), (1, 96, 1, 64)]


def _fill(shape, dtype, sms=132):
    """(warps that step the state, SMs that get a block) in the launch of
    :func:`twkv.grid` on ``sms`` SMs: each block's threads less the
    producers, less the warps of a head's last block that lie wholly past
    D (a warp steps 32 / (D/4) column pairs)."""
    D = shape[3]
    cb = twkv.plan(shape, dtype)
    (gx, gy, gz), threads = twkv.grid(shape, dtype)
    per_block = (threads - twkv.PRODUCERS) // 32
    columns_a_warp = 32 // (D // twkv.TILE[0]) * twkv.TILE[1]
    last = -(-(D - (gx - 1) * cb) // columns_a_warp)
    warps = gy * gz * ((gx - 1) * per_block + min(per_block, last))
    return warps, min(gx * gy * gz, sms)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T", SERVED)
def test_wkv6_grid_fills_the_card(B, T, dtype):
    """On an H100's 132 SMs the served shapes run at least 4 x 132 warps
    that step the state on at least 118 SMs (0.9 of them), and at B1 no
    SM holds two blocks."""
    r = torch.empty((B, T, 40, 64), dtype=dtype, device="meta")
    (gx, gy, gz), threads = twkv.grid(r.shape, r.dtype)
    cb = twkv.plan(r.shape, r.dtype)
    assert cb == twkv.COLUMN_BLOCK[64] and gx == -(-64 // cb)
    assert (gy, gz) == (40, B)
    stepping = threads - twkv.PRODUCERS
    assert stepping == cb // 2 * (64 // 4) and stepping % 32 == 0
    warps, sms = _fill(r.shape, r.dtype)
    assert warps >= 4 * 132 and sms >= 118
    assert B > 1 or gx * gy * gz <= 132


@pytest.mark.parametrize("cb,sms", [(24, 120), (64, 40), (32, 80),
                                    (8, 132), (28, 120)])
def test_wkv6_fill_counts_the_plan(monkeypatch, cb, sms):
    """The count follows the plan: every column pair is stepped by one
    warp's lanes whatever the column block (a narrower last block idles
    its warps past D), and a plan of 64 or 32 columns a block leaves
    SMs without a block, which the check above refuses."""
    monkeypatch.setitem(twkv.COLUMN_BLOCK, 64, cb)
    assert _fill((1, 1000, 40, 64), torch.bfloat16) == (640, sms)


def test_wkv6_plan_matches_the_compiled_instances():
    """COLUMN_BLOCK is the list of (D, columns per block) instances that
    csrc/wkv6.cu compiles, and the thread tile and producers are its."""
    src = (Path(twkv.__file__).resolve().parents[2] / "csrc"
           / "wkv6.cu").read_text()
    compiled = dict(map(int, m) for m in re.findall(
        r"^  REPRO_WKV6_CASE\((\d+), (\d+)\)$", src, re.M))
    assert compiled == twkv.COLUMN_BLOCK
    consts = dict(re.findall(r"^constexpr int (\w+) = (\d+);", src, re.M))
    assert (int(consts["RT"]), int(consts["CT"])) == twkv.TILE
    assert int(consts["PRODUCERS"]) == twkv.PRODUCERS


@pytest.mark.parametrize("B,T,H,D", SWEEP_ROWS + [(1, 33, 3, 128),
                                                  (3, 1, 2, 32)])
def test_wkv6_plan_picks_a_compiled_instance(B, T, H, D):
    for dtype in (torch.float32, torch.bfloat16):
        r = torch.empty((B, T, H, D), dtype=dtype, device="meta")
        cb = twkv.plan(r.shape, r.dtype)
        assert cb == twkv.COLUMN_BLOCK[D]
        (gx, _, _), threads = twkv.grid(r.shape, r.dtype)
        assert gx * cb >= D > (gx - 1) * cb
        # whole warps: the D/4 threads of a column pair share one
        assert (threads - twkv.PRODUCERS) % 32 == 0 and 32 % (D // 4) == 0
        assert threads - twkv.PRODUCERS <= 256
        assert twkv.plan(r.shape, r.dtype) == cb           # pure


@pytest.mark.parametrize("shape,dtype,err", [
    ((1, 4, 2, 24), torch.float32, ValueError),      # no such head width
    ((1, 4, 2, 256), torch.bfloat16, ValueError),
    ((1, 4, 2, 64), torch.float16, TypeError),
])
def test_wkv6_plan_rejects_what_is_not_compiled(shape, dtype, err):
    with pytest.raises(err):
        twkv.plan(shape, dtype)


def test_wkv6_vector_copies_need_aligned_strides():
    x = torch.zeros((2, 5, 3, 4 * 64))
    assert twkv._vec_ok(torch.zeros((2, 5, 3, 64)))
    assert twkv._vec_ok(x[..., 64:128])                # a fused slice
    assert not twkv._vec_ok(torch.zeros((2, 5, 3, 65))[..., 1:])
    assert twkv.chunk(64) == 32 and twkv.chunk(128) == 16


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,H,D", [(4, 1024, 40, 64), (1, 1000, 40, 64),
                                     (2, 77, 4, 16), (2, 77, 4, 32),
                                     (2, 77, 4, 128), (3, 1, 1, 64)])
def test_wkv6_bwd_grid_covers_every_line(B, T, H, D, dtype):
    """The backward's grid: D lines (state rows, or columns) of D /
    BWD_LINE lanes a head, whole lines and whole warps a block, at most
    BWD_MAX_THREADS threads, a line's lanes inside one warp (its sums are
    shuffles); independent of T, and refusing what the forward refuses."""
    (gx, gy, gz), threads = twkv.grid_bwd((B, T, H, D), dtype)
    lanes = D // twkv.BWD_LINE
    assert (gy, gz) == (H, B)
    assert gx * threads == D * lanes
    assert threads % 32 == 0 and threads % lanes == 0
    assert threads <= twkv.BWD_MAX_THREADS and 32 % lanes == 0
    assert lanes >= 4       # the rows kernel's lanes 0-2 store dr, dk, dw
    assert twkv.grid_bwd((B, 5 * T + 3, H, D), dtype) == ((gx, gy, gz),
                                                          threads)
    with pytest.raises(ValueError):
        twkv.grid_bwd((B, T, H, 48), dtype)
    with pytest.raises(TypeError):
        twkv.grid_bwd((B, T, H, D), torch.float16)


def test_wkv6_bwd_constants_match_the_source():
    """The wrapper's backward constants are csrc/wkv6_bwd.cu's: the lanes'
    width, the checkpoint interval, the block cap, and one stage of the C
    entry for each name in BWD_STAGES."""
    src = (Path(twkv.__file__).resolve().parents[2] / "csrc"
           / "wkv6_bwd.cu").read_text()
    consts = dict(re.findall(r"^constexpr int (\w+) = (\d+);", src, re.M))
    assert int(consts["W"]) == twkv.BWD_LINE
    assert int(consts["L"]) == twkv.BWD_CHUNK
    assert int(consts["MAX_THREADS"]) == twkv.BWD_MAX_THREADS
    stages = sorted(int(n) for n in re.findall(r"stage == (\d)", src))
    assert stages + [3] == list(range(len(twkv.BWD_STAGES)))
    assert "st == 3" in src
    assert not re.search(r"\batomic\w*\s*\(", src)     # no atomics
