"""The port's RG-LRU scan wrapper on CPU tensors (its plain version)
against the JAX package: the Pallas kernel in interpret mode over the
sweep of tests/test_kernels.py, and the JAX package's exact scan at
ragged T, which the Pallas kernel cannot take.  Inputs are made with
numpy from a seed and given to both packages."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rglru_scan.ref import rglru_ref as jax_ref
from repro.kernels.rglru_scan.rglru_scan import rglru_pallas
from repro_torch.kernels.rglru_scan import rglru_scan as tscan
from repro_torch.kernels.rglru_scan.ref import rglru_ref

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(seed, B, T, D, dtype="float32"):
    """a = 0.98 * sigmoid(x) and b = 0.3 * x' (tests/test_kernels.py's
    ranges) as (JAX array, CPU tensor) pairs of the same values."""
    rng = np.random.default_rng(seed)
    a = 0.98 / (1.0 + np.exp(-rng.normal(size=(B, T, D))))
    b = rng.normal(size=(B, T, D)) * 0.3
    out = []
    for x in (a, b):
        t = torch.from_numpy(x.astype(np.float32)).to(DTYPES[dtype][1])
        out.append((jnp.asarray(t.float().numpy()).astype(DTYPES[dtype][0]),
                    t))
    return out


def _np(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor)
                      else jnp.asarray(x, jnp.float32))


def _assert_close(got, want, tol, what):
    for g, w, name in zip(got, want, ("h", "h_T")):
        assert g.shape == tuple(w.shape), (what, name)
        np.testing.assert_allclose(_np(g), _np(w), atol=tol, rtol=tol,
                                   err_msg=f"{what} {name}")


# B, T, D, chunk, block_d: tests/test_kernels.py's sweep
SWEEP = [(2, 256, 384, 64, 128), (1, 128, 64, 32, 64), (3, 64, 96, 64, 32)]


@pytest.mark.parametrize("B,T,D,chunk,bd", SWEEP)
def test_rglru_matches_pallas(B, T, D, chunk, bd):
    (ja, a), (jb, b) = _inputs(0, B, T, D)
    want = rglru_pallas(ja, jb, chunk=chunk, block_d=bd, interpret=True)
    before = tscan.launches
    got = tscan.rglru(a, b)
    assert tscan.launches == before        # CPU tensors: no kernel
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.float32
    _assert_close(got, want, 1e-4, "pallas")


# ragged T and D (the Pallas kernel asserts T % chunk == 0)
@pytest.mark.parametrize("B,T,D", [(1, 77, 2560 // 8), (2, 33, 50),
                                   (1, 1, 7)])
def test_rglru_matches_jax_exact_scan(B, T, D):
    (ja, a), (jb, b) = _inputs(1, B, T, D)
    _assert_close(tscan.rglru(a, b), jax_ref(ja, jb), 1e-5, "exact")


def test_rglru_bf16_inputs_match_jax():
    """bf16 a/b: both scan in fp32 from the same bf16 values and round h
    to bf16 once; h_T stays fp32."""
    (ja, a), (jb, b) = _inputs(2, 2, 100, 64, "bfloat16")
    got = tscan.rglru(a, b)
    assert got[0].dtype == torch.bfloat16 and got[1].dtype == torch.float32
    _assert_close(got, jax_ref(ja, jb), 1e-2, "bf16")


def test_rglru_from_a_state_matches_jax():
    (ja, a), (jb, b) = _inputs(3, 2, 9, 16)
    h0 = np.random.default_rng(3).normal(size=(2, 16)).astype(np.float32)
    _assert_close(rglru_ref(a, b, torch.from_numpy(h0)),
                  jax_ref(ja, jb, jnp.asarray(h0)), 1e-5, "state")


def _t(*shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype)


@pytest.mark.parametrize("a,b,err", [
    (_t(1, 4, 8), _t(1, 4, 8, dtype=torch.bfloat16), TypeError),
    (_t(1, 4, 8), _t(1, 5, 8), ValueError),
    (_t(4, 8), _t(4, 8), ValueError),
    (_t(1, 4, 8, dtype=torch.float16), _t(1, 4, 8, dtype=torch.float16),
     TypeError),
])
def test_rglru_rejects_unsupported(a, b, err):
    with pytest.raises(err):
        tscan.rglru(a, b)


# recurrentgemma-2b's K5 shapes (B, T) at D 2560: phase f's prompts, with
# phase a's serving rows among them; then phase a's sweep rows (B, T, D)
SERVED = [(1, 77), (1, 256), (1, 1000), (1, 4096), (2, 128)]
SWEEP_ROWS = [(2, 256, 384), (1, 128, 64), (3, 64, 96)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T", SERVED)
def test_rglru_grid_uses_most_sms(B, T, dtype):
    """On an H100's 132 SMs D 2560 spreads over at least 80 SMs."""
    a = torch.empty((B, T, 2560), dtype=dtype, device="meta")
    (gx, gy), threads = tscan.grid(a.shape, a.dtype)
    assert gx * tscan.STRIP == 2560 and gy == B
    assert threads == tscan.THREADS and min(gx * gy, 132) >= 80


@pytest.mark.parametrize("B,T,D", SWEEP_ROWS + [(1, 33, 50), (2, 1, 7)])
def test_rglru_grid_covers_every_channel(B, T, D):
    for dtype in (torch.float32, torch.bfloat16):
        a = torch.empty((B, T, D), dtype=dtype, device="meta")
        (gx, gy), threads = tscan.grid(a.shape, a.dtype)
        assert gx * tscan.STRIP >= D > (gx - 1) * tscan.STRIP
        assert (gy, threads) == (B, tscan.THREADS)
        # the chain lanes step 8 at a time through chunks of 8 KB of a, b
        n = tscan.chunk(dtype)
        assert n % 8 == 0 and 2 * n * tscan.STRIP * a.element_size() == 8192


def test_rglru_grid_rejects_what_is_not_compiled():
    with pytest.raises(TypeError):
        tscan.grid((1, 4, 8), torch.float16)


def test_rglru_grid_matches_the_compiled_instance():
    """STRIP and THREADS are csrc/rglru_scan.cu's one instance: strips of
    16 channels, a chain warp and the mover warps."""
    src = (Path(tscan.__file__).resolve().parents[2] / "csrc"
           / "rglru_scan.cu").read_text()
    assert re.findall(r"launch_sw<T, (\d+)>", src) == [str(tscan.STRIP)]
    movers = re.search(r"^constexpr int MOVERS = (\d+);", src, re.M)
    assert 32 + 32 * int(movers.group(1)) == tscan.THREADS


def test_rglru_vector_copies_need_aligned_strides():
    ab = torch.zeros((2, 5, 2 * 384))
    assert tscan._vec_ok(ab[..., :384]) and tscan._vec_ok(ab[..., 384:])
    assert not tscan._vec_ok(torch.zeros((2, 5, 51))[..., 1:])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,D", [(4, 1024, 2560), (1, 1000, 2560),
                                   (2, 77, 2568), (3, 1, 5),
                                   (2, 4096 + 5, 2560)])
def test_rglru_bwd_plan_matches_the_source(B, T, D, dtype):
    """The backward's grid_bwd(): strips of BWD_STRIP channels (grid x;
    batch y) of BWD_THREADS threads, independent of T; chunk_bwd(): 4 KB
    of one array of a strip; bwd_workspace(): None while a block's fp32
    checkpoints (one a chunk and channel) fit in BWD_CKPT_BYTES of shared
    memory, else the (B, chunks, D) tensor, never a (B,T,D) one; each
    constant csrc/rglru_scan_bwd.cu's, and no atomics there."""
    a = torch.empty((B, T, D), dtype=dtype, device="meta")
    (strips, batch), threads = tscan.grid_bwd(a.shape, a.dtype)
    assert (batch, threads) == (B, tscan.BWD_THREADS)
    assert strips * tscan.BWD_STRIP >= D > (strips - 1) * tscan.BWD_STRIP
    assert tscan.grid_bwd((B, 7 * T + 3, D), dtype) == ((strips, B),
                                                         threads)
    tch = tscan.chunk_bwd(dtype)
    assert tch * tscan.BWD_STRIP * a.element_size() == tscan.BWD_CHUNK_BYTES
    chunks = -(-T // tch)
    ws = tscan.bwd_workspace(a.shape, dtype)
    fits = chunks * tscan.BWD_STRIP * 4 <= tscan.BWD_CKPT_BYTES
    assert ws == (None if fits else (B, chunks, D))
    assert (ws is None) == (T < 4096)
    src = (Path(tscan.__file__).resolve().parents[2] / "csrc"
           / "rglru_scan_bwd.cu").read_text()
    consts = dict(re.findall(r"^constexpr int (\w+) = (\d+);", src, re.M))
    assert int(consts["SW"]) == tscan.BWD_STRIP
    assert int(consts["CHUNK_BYTES"]) == tscan.BWD_CHUNK_BYTES
    assert int(consts["CKPT_BYTES"]) == tscan.BWD_CKPT_BYTES
    assert 32 + 32 * int(consts["MOVERS"]) == tscan.BWD_THREADS
    assert not re.search(r"\batomic\w*\s*\(", src)     # no atomics
    with pytest.raises(TypeError):
        tscan.grid_bwd(a.shape, torch.float16)
