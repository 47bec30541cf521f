"""The port's CUDA kernels against their plain torch versions, on the card.

Marked ``gpu``: each test skips (inside the test, never at collection)
when no CUDA device is visible.  On a machine with an H100 run

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""

import math

import numpy as np
import pytest
import torch

from repro_torch.kernels.matmul import matmul as mm
from repro_torch.kernels.matmul.ref import matmul_ref
from repro_torch.kernels.rmsnorm import rmsnorm as rms
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

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


# M, K, N, column offset of B inside a wider weight (None: contiguous)
MM_CASES = [
    (1, 2560, 48, 32), (64, 2560, 1280, 640), (64, 8960, 4480, None),
    (1, 8960, 2560, 0), (7, 33, 65, None), (128, 128, 128, None),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,K,N,off", MM_CASES)
def test_matmul_kernel_matches_plain(cuda, M, K, N, off, dtype):
    a = _randn((M, K), dtype, cuda, 0)
    if off is None:
        b = _randn((K, N), dtype, cuda, 1)
    else:
        b = _randn((K, off + N + 16), dtype, cuda, 1)[:, off:off + N]
    before = mm.launches
    got = mm.matmul(a, b)
    assert mm.launches == before + 1
    tol = 1e-4 if dtype == "float32" else 5e-2
    _close(got, matmul_ref(a, b), tol * math.sqrt(K), tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batched_matmul_kT_view(cuda, dtype):
    q = _randn((4, 64, 32), dtype, cuda, 2)
    kt = _randn((4, 64, 32), dtype, cuda, 3).transpose(1, 2)
    tol = 1e-4 if dtype == "float32" else 5e-2
    _close(mm.matmul(q, kt), matmul_ref(q, kt), tol * math.sqrt(32), tol)


def test_matmul_is_deterministic(cuda):
    a = _randn((64, 2560), "float32", cuda, 4)
    b = _randn((2560, 1280), "float32", cuda, 5)
    assert torch.equal(mm.matmul(a, b), mm.matmul(a, b))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(64, 2560), (1, 2560), (3, 5, 96)])
@pytest.mark.parametrize("gain", [True, False])
def test_rmsnorm_kernel_matches_plain(cuda, shape, dtype, gain):
    x = _randn(shape, dtype, cuda, 6)
    g = _randn(shape[-1:], dtype, cuda, 7) if gain else None
    before = rms.launches
    got = rms.rmsnorm(x, g)
    assert rms.launches == before + 1
    tol = 1e-5 if dtype == "float32" else 2e-2
    _close(got, rmsnorm_ref(x, g), tol, tol)
