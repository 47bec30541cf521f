"""The plain backward versions of the WKV6, RG-LRU scan and grouped-matmul
kernels (``wkv6_bwd_ref``, ``rglru_bwd_ref``, ``grouped_matmul_bwd_ref``)
against ``jax.vjp`` of the JAX package's references, in fp32 and bf16, with
a nonzero gradient of the final state and decays down to 0.01 (where the
Pallas chunked WKV6 leaves fp32 range); then the wrappers on CPU tensors:
autograd through their plain forwards, and their backward entries (the
CUDA kernels' on the card) giving the plain versions' bits."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.grouped_matmul.ref import \
    grouped_matmul_ref as jax_grouped_matmul
from repro.kernels.rglru_scan.ref import rglru_ref as jax_rglru
from repro.kernels.rwkv_scan.ref import wkv6_ref as jax_wkv6
from repro_torch.kernels.grouped_matmul import grouped_matmul as tgm
from repro_torch.kernels.grouped_matmul.ref import grouped_matmul_bwd_ref
from repro_torch.kernels.rglru_scan import rglru_scan as tscan
from repro_torch.kernels.rglru_scan.ref import rglru_bwd_ref
from repro_torch.kernels.rwkv_scan import rwkv_scan as twkv
from repro_torch.kernels.rwkv_scan.ref import wkv6_bwd_ref

# dtype -> (JAX dtype, torch dtype, tolerance relative to the largest
# |gradient|): fp32 sums in other orders; bf16 rounds each output once
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _pair(x, dtype):
    """(JAX array, CPU tensor) of the same values of numpy ``x``."""
    t = torch.from_numpy(np.asarray(x, np.float32)).to(DTYPES[dtype][1])
    return jnp.asarray(t.float().numpy()).astype(DTYPES[dtype][0]), t


def _rel_close(got, want, tol, what):
    g = got.float().numpy()
    w = np.asarray(jnp.asarray(want, jnp.float32))
    assert g.shape == w.shape, what
    assert np.isfinite(g).all(), what
    scale = max(float(np.abs(w).max()), 1e-30)
    err = float(np.abs(g - w).max()) / scale
    assert err <= tol, f"{what}: max error {err:.3e} of max |want|"


# B, T, H, D, decay range: Finch's head widths; a ragged T; decays down to
# 0.01 over 64 steps (the chunked form's summed -log w passes 88 there)
WKV = [(2, 19, 3, 16, (0.3, 1.0)), (1, 40, 2, 32, (0.01, 1.0)),
       (1, 64, 2, 64, (0.01, 0.05)), (1, 9, 1, 128, (0.5, 1.0))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,T,H,D,decay", WKV)
def test_wkv6_bwd_ref_matches_jax_vjp(B, T, H, D, decay, dtype):
    rng = np.random.default_rng(B * 100 + T + D)
    r, k, v, dy = (rng.normal(size=(B, T, H, D)) for _ in range(4))
    w = rng.uniform(*decay, size=(B, T, H, D))
    u = rng.normal(size=(H, D)) * 0.5
    ds = rng.normal(size=(B, H, D, D))
    jr, tr = _pair(r, dtype)
    jk, tk = _pair(k, dtype)
    jv, tv = _pair(v, dtype)
    jw, tw = _pair(w, dtype)
    ju, tu = _pair(u, dtype)
    jdy, tdy = _pair(dy, dtype)
    jds, tds = _pair(ds, "float32")
    _, vjp = jax.vjp(jax_wkv6, jr, jk, jv, jw, ju)
    want = vjp((jdy, jds))
    got = wkv6_bwd_ref(tr, tk, tv, tw, tu, tdy, tds)
    tol = DTYPES[dtype][2]
    for name, g, w_, t in zip(("dr", "dk", "dv", "dw", "du"), got, want,
                              (tr, tk, tv, tw, tu)):
        assert g.dtype == t.dtype and g.shape == t.shape, name
        _rel_close(g, w_, tol, name)
    # the wrapper on CPU tensors: autograd through its plain forward, and
    # wkv6_bwd (the CUDA kernels' entry) giving the plain version's bits
    live = [t.clone().requires_grad_(True) for t in (tr, tk, tv, tw, tu)]
    y, s = twkv.wkv6(*live)
    auto = torch.autograd.grad((y, s), live, (tdy, tds))
    for name, g, w_ in zip(("dr", "dk", "dv", "dw", "du"), auto, want):
        _rel_close(g, w_, tol, f"autograd {name}")
    for a, b in zip(twkv.wkv6_bwd(tr, tk, tv, tw, tu, tdy, tds), got):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_wkv6_bwd_ref_none_is_zero():
    """A gradient that is None (an output the loss does not use, as the
    final state in training) gives the bits of explicit zeros."""
    rng = np.random.default_rng(7)
    r, k, v, dy = (torch.from_numpy(rng.normal(size=(1, 12, 2, 16))
                                    .astype(np.float32)) for _ in range(4))
    w = torch.from_numpy(rng.uniform(0.01, 1, (1, 12, 2, 16))
                         .astype(np.float32))
    u = torch.from_numpy(rng.normal(size=(2, 16)).astype(np.float32))
    ds = torch.from_numpy(rng.normal(size=(1, 2, 16, 16)).astype(np.float32))
    zeros = (torch.zeros_like(dy), torch.zeros_like(ds))
    for got, want in ((wkv6_bwd_ref(r, k, v, w, u, dy, None),
                       wkv6_bwd_ref(r, k, v, w, u, dy, zeros[1])),
                      (wkv6_bwd_ref(r, k, v, w, u, None, ds),
                       wkv6_bwd_ref(r, k, v, w, u, zeros[0], ds))):
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, atol=0, rtol=0)
    # with neither, every gradient is exactly zero
    assert all(torch.count_nonzero(g) == 0
               for g in wkv6_bwd_ref(r, k, v, w, u))


# B, T, D: a strip and a half (ragged D), a long one, one step
RGLRU = [(2, 23, 24), (1, 70, 16), (3, 1, 8)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,T,D", RGLRU)
def test_rglru_bwd_ref_matches_jax_vjp(B, T, D, dtype):
    rng = np.random.default_rng(B * 100 + T + D)
    ja, ta = _pair(rng.uniform(0.01, 1.0, size=(B, T, D)), dtype)
    jb, tb = _pair(rng.normal(size=(B, T, D)), dtype)
    jdh, tdh = _pair(rng.normal(size=(B, T, D)), dtype)
    jdl, tdl = _pair(rng.normal(size=(B, D)), "float32")
    _, vjp = jax.vjp(jax_rglru, ja, jb)
    want = vjp((jdh, jdl))
    got = rglru_bwd_ref(ta, tb, tdh, tdl)
    tol = DTYPES[dtype][2]
    for name, g, w_, t in zip(("da", "db"), got, want, (ta, tb)):
        assert g.dtype == t.dtype and g.shape == t.shape, name
        _rel_close(g, w_, tol, name)
    live = [t.clone().requires_grad_(True) for t in (ta, tb)]
    h, h_last = tscan.rglru(*live)
    auto = torch.autograd.grad((h, h_last), live, (tdh, tdl))
    for name, g, w_ in zip(("da", "db"), auto, want):
        _rel_close(g, w_, tol, f"autograd {name}")
    for a, b in zip(tscan.rglru_bwd(ta, tb, tdh, tdl), got):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    # h_T's gradient None: the bits of zeros
    for a, b in zip(rglru_bwd_ref(ta, tb, tdh, None),
                    rglru_bwd_ref(ta, tb, tdh, torch.zeros_like(tdl))):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


# E, C, D, F: granite's widths cut down (16-row capacity), ragged widths
GMM = [(5, 16, 48, 32), (3, 17, 40, 12), (2, 8, 64, 24)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("E,C,D,F", GMM)
def test_grouped_matmul_bwd_ref_matches_jax_vjp(E, C, D, F, dtype):
    rng = np.random.default_rng(E * 100 + C + D + F)
    jx, tx = _pair(rng.normal(size=(E, C, D)), dtype)
    jw, tw = _pair(rng.normal(size=(E, D, F)) * D ** -0.5, dtype)
    jdy, tdy = _pair(rng.normal(size=(E, C, F)), dtype)
    _, vjp = jax.vjp(jax_grouped_matmul, jx, jw)
    want = vjp(jdy)
    got = grouped_matmul_bwd_ref(tx, tw, tdy)
    tol = DTYPES[dtype][2]
    for name, g, w_, t in zip(("dx", "dw"), got, want, (tx, tw)):
        assert g.dtype == t.dtype and g.shape == t.shape, name
        _rel_close(g, w_, tol, name)
    live = [t.clone().requires_grad_(True) for t in (tx, tw)]
    auto = torch.autograd.grad(tgm.grouped_matmul(*live), live, tdy)
    for name, g, w_ in zip(("dx", "dw"), auto, want):
        _rel_close(g, w_, tol, f"autograd {name}")
    for a, b in zip(tgm.grouped_matmul_bwd(tx, tw, tdy), got):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
