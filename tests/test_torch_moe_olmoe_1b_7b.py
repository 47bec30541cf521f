"""olmoe-1b-7b SMOKE (top-k routed experts) through the port and the JAX
package, whose grouped matmul and attention run the Pallas kernels in
interpret mode: ``forward``, ``prefill`` (logits and caches) and three
``decode_step``s, the JAX side op by op (``eager``, see
tests/test_torch_lm_pair.py).  Then the MoE layer alone, for both MoE
configs: the capacity and the sort-based routing equal the JAX package's
as integers (overflow included), a router biased to two experts drops
assignments in both packages alike, the dispatched layer equals the
explicit per-token expert sum once nothing can drop, and the sharding
hints are the identity on one device."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import moe as jmoe
from repro_torch.configs import registry as treg
from repro_torch.core import hints
from repro_torch.core.weights import tree_from_jax
from repro_torch.models import moe as tmoe
from test_torch_lm_pair import compare

ARCHS = ["olmoe-1b-7b", "granite-moe-3b-a800m"]


@pytest.mark.parametrize("S", [24, 64])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_matches_jax(dtype, S, monkeypatch):
    monkeypatch.setenv("REPRO_USE_PALLAS", "1")
    compare("olmoe-1b-7b", dtype, S=S, max_seq=S + 8, eager=True)


def _configs(arch, dtype="float32"):
    return (dataclasses.replace(jreg.get_smoke_config(arch), dtype=dtype),
            dataclasses.replace(treg.get_smoke_config(arch), dtype=dtype))


@pytest.mark.parametrize("factor", [1.25, 8.0, 0.5])
@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_matches_jax(arch, factor, monkeypatch):
    """Full configs, the serving prompt lengths; the factor is read when
    ``capacity`` is called, in both packages."""
    monkeypatch.setattr(jmoe, "CAPACITY_FACTOR", factor)
    monkeypatch.setattr(tmoe, "CAPACITY_FACTOR", factor)
    jcfg, tcfg = jreg.get_config(arch), treg.get_config(arch)
    for n in (1, 24, 77, 128, 256, 1000, 1001, 4096):
        assert tmoe.capacity(tcfg, n) == jmoe.capacity(jcfg, n)
    assert tmoe.capacity(tcfg, 1000) % 8 == 0


def _top_e(rng, S, E, K, skew):
    """Each token's K distinct experts; ``skew`` > 0 favours the low
    experts, so some receive more assignments than their capacity."""
    p = np.exp(-skew * np.arange(E))
    p /= p.sum()
    return np.stack([rng.choice(E, K, replace=False, p=p)
                     for _ in range(S)]).astype(np.int32)


# S, E, K, C (None: capacity of the default factor), skew
ROUTE_CASES = [(64, 8, 2, None, 0.0), (64, 8, 2, None, 0.5),
               (64, 8, 2, 8, 0.0),          # S*K = 128 > E*C = 64
               (24, 5, 2, None, 1.0), (77, 64, 8, None, 0.05),
               (1, 64, 8, 8, 0.0), (100, 40, 8, 16, 0.0)]


@pytest.mark.parametrize("S,E,K,C,skew", ROUTE_CASES)
def test_route_group_matches_jax(S, E, K, C, skew):
    if C is None:
        C = jmoe.capacity(dataclasses.replace(
            jreg.get_smoke_config("olmoe-1b-7b"), n_experts=E, top_k=K), S)
    top_e = _top_e(np.random.default_rng(S + E), S, E, K, skew)
    want = np.asarray(jmoe._route_group(jnp.asarray(top_e), E, C))
    got = tmoe._route_group(torch.from_numpy(top_e), E, C)
    assert got.shape == (E * C,)
    np.testing.assert_array_equal(got.numpy(), want)
    # batched over token groups, as moe_mlp calls it
    both = torch.from_numpy(np.stack([top_e, top_e[::-1].copy()]))
    batched = tmoe._route_group(both, E, C)
    np.testing.assert_array_equal(batched[0].numpy(), want)
    flipped = jmoe._route_group(jnp.asarray(top_e[::-1].copy()), E, C)
    np.testing.assert_array_equal(batched[1].numpy(), np.asarray(flipped))


def _moe_pair(arch, seed, dtype="float32"):
    jcfg, tcfg = _configs(arch, dtype)
    jp = jmoe.init_moe_mlp(jax.random.PRNGKey(seed), jcfg)
    return jcfg, tcfg, jp


@pytest.mark.parametrize("arch", ARCHS)
def test_forced_overflow_drops_alike(arch, monkeypatch):
    """A router that sends every token to experts 0 and 1 (weights about
    0.75 and 0.25): both overflow their capacity, the JAX gather really
    drops assignments, and the port's layer equals the JAX package's
    (Pallas grouped matmul in interpret mode), dropped tokens included."""
    monkeypatch.setenv("REPRO_USE_PALLAS", "1")
    jcfg, tcfg, jp = _moe_pair(arch, 3)
    w = np.asarray(jp["router"]["w"]).copy()
    w[:, 0], w[:, 1] = 1.0, 0.98        # x > 0 below: logits 0, 1 >> rest
    jp = {**jp, "router": {"w": jnp.asarray(w)}}
    B, S, D = 2, 64, jcfg.d_model
    x = np.abs(np.random.default_rng(3).normal(size=(B, S, D))) + 0.1
    x = x.astype(np.float32)
    E, K = jcfg.n_experts, jcfg.top_k
    C = jmoe.capacity(jcfg, S)
    probs = jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(w), -1)
    top_e = jax.lax.top_k(probs, K)[1]
    assert bool(jnp.all(top_e[..., 0] == 0) & jnp.all(top_e[..., 1] == 1))
    for b in range(B):
        gather = np.asarray(jmoe._route_group(top_e[b], E, C))
        assert int((gather < S * K).sum()) < S * K, "nothing was dropped"
        assert int((gather[:2 * C] < S * K).sum()) == 2 * C  # 0 and 1 full
    want = jmoe.moe_mlp(jp, jcfg, jnp.asarray(x))
    tp = tree_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    got = tmoe.moe_mlp(tp, tcfg, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_equivalent_to_dense_at_high_capacity(arch, monkeypatch):
    """With the capacity raised so nothing drops, the dispatched layer
    equals the per-token explicit expert sum (the port's twin of
    tests/test_train_moe.py's test of the same name, fp32, 1e-3)."""
    _, cfg = _configs(arch)
    p = tmoe.init_moe_mlp(torch.Generator().manual_seed(0), cfg, "cpu")
    B, S, D = 2, 16, cfg.d_model
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(B, S, D))
                         .astype(np.float32))
    monkeypatch.setattr(tmoe, "CAPACITY_FACTOR", float(cfg.n_experts))
    got = tmoe.moe_mlp(p, cfg, x)
    probs = torch.softmax(x @ p["router"]["w"], -1)
    top_p, top_e = torch.topk(probs, cfg.top_k, -1)
    top_p = top_p / top_p.sum(-1, keepdim=True)
    want = torch.zeros_like(x)
    for b in range(B):
        for s in range(S):
            for k in range(cfg.top_k):
                e = int(top_e[b, s, k])
                h = torch.nn.functional.silu(x[b, s] @ p["w_gate"][e]) \
                    * (x[b, s] @ p["w_up"][e])
                want[b, s] += float(top_p[b, s, k]) * (h @ p["w_down"][e])
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-3,
                               rtol=1e-3)


def test_top_k_breaks_ties_as_jax():
    """Equal probabilities go to the lower expert first, as in
    ``jax.lax.top_k``."""
    probs = np.array([[0.1, 0.3, 0.3, 0.05, 0.3, 0.3],
                      [0.25, 0.25, 0.25, 0.25, 0.0, 0.0]], np.float32)
    jv, je = jax.lax.top_k(jnp.asarray(probs), 3)
    tv, te = tmoe._top_k(torch.from_numpy(probs), 3)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_hints_are_identity_without_a_mesh():
    x = torch.arange(6.0).reshape(2, 3)
    hints.set_hints(None)
    assert hints.constraint(x, "moe_dispatch") is x
    assert hints.get("moe_dispatch") is None
    _, cfg = _configs("olmoe-1b-7b")
    p = tmoe.init_moe_mlp(torch.Generator().manual_seed(1), cfg, "cpu")
    xs = torch.randn(1, 4, cfg.d_model, generator=torch.Generator()
                     .manual_seed(1))
    try:
        hints.set_hints({"moe_hidden": ("expert", None, None)})
        assert hints.get("moe_hidden") == ("expert", None, None)
        assert hints.constraint(x, "moe_dispatch") is x
        # a hint that is set lays out a DTensor on the plan's mesh, and
        # refuses a plain tensor
        with pytest.raises(TypeError, match="not a DTensor"):
            hints.constraint(x, "moe_hidden")
        with pytest.raises(TypeError, match="moe_hidden"):
            tmoe.moe_mlp(p, cfg, xs)
    finally:
        hints.set_hints(None)
    assert tmoe.moe_mlp(p, cfg, xs).shape == xs.shape
