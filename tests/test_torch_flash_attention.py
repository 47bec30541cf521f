"""The port's flash-attention wrapper on CPU tensors (its plain versions)
against the Pallas kernel in interpret mode over the sweep of
tests/test_kernels.py, the chunked form against the exact one, and the
shapes the Pallas kernel cannot take (ragged S, Dh = 80) against the JAX
package's exact reference.  Inputs are made with numpy from a seed and
given to both packages."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.flash_attention import \
    flash_attention_pallas
from repro.kernels.flash_attention.ref import attention_ref as jax_ref
from repro_torch.kernels.flash_attention import flash_attention as tfa
from repro_torch.kernels.flash_attention.ref import (attention_chunked,
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
