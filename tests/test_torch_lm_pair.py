"""One transformer-family config through the JAX package and the port
side by side (:func:`compare`, used by tests/test_torch_transformer_*.py):
the JAX ``init`` params carried over with
``repro_torch.core.weights.tree_from_jax``, the same numpy-seeded inputs
to both, and ``forward`` logits, ``prefill`` logits and caches, and
``decode_step`` logits, caches and ``pos`` compared leaf by leaf.  The
tests here show that the leaf-by-leaf comparison catches a difference.

``eager=True`` runs the JAX side op by op (``jax.disable_jit``), as the
port runs: each op then rounds to its dtype where the port's op does.
Compiled, XLA fuses bf16 elementwise chains and skips some of those
roundings, so the JAX package's compiled and eager results differ by
bf16 noise of their own (rwkv6-3b SMOKE, bf16, S = 64: up to 0.067 at
one logit of 32768, CPU run)."""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models.api import get_model as jax_model
from repro_torch.configs import registry as treg
from repro_torch.core.weights import tree_from_jax
from repro_torch.models.api import get_model as torch_model

TOL = {"float32": 1e-4, "bfloat16": 5e-2}


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.is_floating_point() else x.numpy()
    x = jnp.asarray(x)
    return np.asarray(x.astype(jnp.float32) if jnp.issubdtype(
        x.dtype, jnp.floating) else x)


def assert_trees_close(got, want, tol, what):
    g, w = list(_leaves(got)), list(_leaves(want))
    assert [p for p, _ in g] == [p for p, _ in w], what
    for (path, a), (_, b) in zip(g, w):
        a, b = _np(a), _np(b)
        assert a.shape == b.shape, f"{what}{path}: {a.shape} vs {b.shape}"
        np.testing.assert_allclose(a, b, atol=tol, rtol=tol,
                                   err_msg=f"{what}{path}")


def compare(arch, dtype, B=2, S=24, n_decode=3, max_seq=32, seed=0,
            eager=False):
    """Port vs JAX package for one SMOKE config in ``dtype``."""
    with jax.disable_jit() if eager else contextlib.nullcontext():
        _compare(arch, dtype, B, S, n_decode, max_seq, seed)


def _compare(arch, dtype, B, S, n_decode, max_seq, seed):
    cfg_j = dataclasses.replace(jreg.get_smoke_config(arch), dtype=dtype)
    cfg_t = dataclasses.replace(treg.get_smoke_config(arch), dtype=dtype)
    jm, tm = jax_model(cfg_j), torch_model(cfg_t)
    jp = jm.init(jax.random.PRNGKey(seed), cfg_j)
    tp = tree_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(seed)
    if cfg_j.input_kind == "tokens":
        x = rng.integers(0, cfg_j.vocab, (B, S + n_decode)).astype(np.int32)
    else:
        x = rng.normal(size=(B, S + n_decode, cfg_j.d_model)) \
            .astype(np.float32)
    tol = TOL[dtype]

    def both(i0, i1):
        return jnp.asarray(x[:, i0:i1]), torch.from_numpy(x[:, i0:i1])

    jx, tx = both(0, S)
    assert_trees_close(tm.forward(cfg_t, tp, tx), jm.forward(cfg_j, jp, jx),
                       tol, f"{arch} {dtype} forward")
    tl, tc = tm.prefill(cfg_t, tp, tx, max_seq)
    jl, jc = jm.prefill(cfg_j, jp, jx, max_seq)
    assert_trees_close(tl, jl, tol, f"{arch} {dtype} prefill logits")
    assert_trees_close(tc, jc, tol, f"{arch} {dtype} prefill cache")
    for t in range(S, S + n_decode):
        jt, tt = both(t, t + 1)
        jl, jc = jm.decode_step(cfg_j, jp, jc, jt[:, 0])
        tl, tc = tm.decode_step(cfg_t, tp, tc, tt[:, 0])
        assert_trees_close(tl, jl, tol, f"{arch} {dtype} decode {t} logits")
        assert_trees_close(tc, jc, tol, f"{arch} {dtype} decode {t} cache")
    assert tc["pos"].tolist() == [S + n_decode] * B


def test_tree_comparison_catches_differences():
    want = {"slots": [{"k": jnp.ones((2, 3))}], "pos": jnp.arange(2)}
    same = {"slots": [{"k": torch.ones(2, 3)}], "pos": torch.arange(2)}
    assert_trees_close(same, want, 1e-4, "same")
    off = {"slots": [{"k": torch.ones(2, 3) + 1e-3}], "pos": torch.arange(2)}
    with pytest.raises(AssertionError):
        assert_trees_close(off, want, 1e-4, "value")
    with pytest.raises(AssertionError):
        assert_trees_close({"slots": [], "pos": torch.arange(2)}, want, 1e-4,
                           "structure")
    with pytest.raises(AssertionError):
        assert_trees_close({"slots": [{"k": torch.ones(3, 2)}],
                            "pos": torch.arange(2)}, want, 1e-4, "shape")
