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
    (torch.zeros(2, 8, 16, device="meta"), torch.zeros(2, 16, 4,
                                                       device="meta"),
     ValueError),                                   # no kernel, no fallback
])
def test_rejects_unsupported(x, w, err):
    with pytest.raises(err):
        tgmm.grouped_matmul(x, w)


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
