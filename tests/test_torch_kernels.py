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
