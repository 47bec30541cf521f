"""The port's LM stack on its own: decode against forward (as
tests/test_arch_smoke.py checks the JAX package), the family dispatch,
the stacked param layout, decoding from ``init_cache`` against JAX, and
JAX pytrees carried over bitwise."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as jtransformer
from repro.models.api import get_model as jax_model
from repro_torch.configs import registry
from repro_torch.core.weights import tree_from_jax
from repro_torch.models import moe, rglru, rwkv6
from repro_torch.models import stacking as ST
from repro_torch.models import transformer
from repro_torch.models.api import get_model

DECODE_ARCHS = [a for a in registry.ARCH_IDS
                if registry.get_config(a).has_decode
                and registry.get_config(a).input_kind == "tokens"]


def _tokens(cfg, B, S, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, cfg.vocab, (B, S)))


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_decode_matches_forward(arch, monkeypatch):
    """decode_step at position S equals forward on the extended sequence
    (bf16 params, the tolerance of tests/test_arch_smoke.py).  For the
    MoE family the capacity factor is raised so that no assignment drops,
    as tests/test_arch_smoke.py does: the forward pass drops assignments
    past capacity, the single-token decode step never does."""
    cfg = registry.get_smoke_config(arch)
    if cfg.family == "moe":
        monkeypatch.setattr(moe, "CAPACITY_FACTOR", float(cfg.n_experts))
    model = get_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), cfg, "cpu")
    B, S = 2, 24
    x = _tokens(cfg, B, S)
    lg, cache = model.prefill(cfg, params, x, max_seq=S + 8)
    tok = lg.argmax(-1)
    lg2, cache2 = model.decode_step(cfg, params, cache, tok)
    full = model.forward(cfg, params, torch.cat([x, tok[:, None]], 1))
    err = (full[:, S] - lg2).abs().max().item()
    assert err < 5e-2, err
    assert cache2["pos"].tolist() == [S + 1] * B


def test_gemma3_ring_decode_past_the_window():
    """Local layers keep window-sized ring caches: decoding well past the
    window still matches forward at every step (fp32)."""
    cfg = dataclasses.replace(registry.get_smoke_config("gemma3-12b"),
                              dtype="float32")
    params = transformer.init(torch.Generator().manual_seed(1), cfg, "cpu")
    x = _tokens(cfg, 1, 40, seed=1)
    full = transformer.forward(cfg, params, x)
    _, cache = transformer.prefill(cfg, params, x[:, :10], max_seq=48)
    assert cache["slots"][0]["k"].shape[2] == cfg.window      # a ring
    for t in range(10, 40):
        lg, cache = transformer.decode_step(cfg, params, cache, x[:, t])
        if t + 1 < 40:
            torch.testing.assert_close(lg, full[:, t], atol=1e-4, rtol=1e-4)


def test_rglru_ring_decode_past_the_window():
    """recurrentgemma's local-attention layer keeps a window-sized ring
    and its recurrent layers a conv history and h: decoding from a short
    prompt to well past the window matches forward at every step
    (fp32)."""
    cfg = dataclasses.replace(registry.get_smoke_config("recurrentgemma-2b"),
                              dtype="float32")
    params = rglru.init(torch.Generator().manual_seed(1), cfg, "cpu")
    x = _tokens(cfg, 2, 40, seed=1)
    full = rglru.forward(cfg, params, x)
    _, cache = rglru.prefill(cfg, params, x[:, :10], max_seq=48)
    assert cache["slots"][2]["k"].shape[2] == cfg.window      # a ring
    for t in range(10, 40):
        lg, cache = rglru.decode_step(cfg, params, cache, x[:, t])
        if t + 1 < 40:
            torch.testing.assert_close(lg, full[:, t], atol=1e-4, rtol=1e-4)


def test_rwkv6_long_decode_matches_forward():
    """rwkv6's O(1) state carries the whole history: 30 decode steps after
    a 10-token prompt match forward at every step (fp32)."""
    cfg = dataclasses.replace(registry.get_smoke_config("rwkv6-3b"),
                              dtype="float32")
    params = rwkv6.init(torch.Generator().manual_seed(1), cfg, "cpu")
    x = _tokens(cfg, 2, 40, seed=1)
    full = rwkv6.forward(cfg, params, x)
    _, cache = rwkv6.prefill(cfg, params, x[:, :10], max_seq=48)
    for t in range(10, 40):
        lg, cache = rwkv6.decode_step(cfg, params, cache, x[:, t])
        if t + 1 < 40:
            torch.testing.assert_close(lg, full[:, t], atol=1e-4, rtol=1e-4)


FAMILY_MODULES = {"dense": transformer, "vlm": transformer,
                  "audio": transformer, "moe": moe, "ssm": rwkv6,
                  "hybrid": rglru}


@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_family_dispatch(arch):
    """Every family of the registry is ported and dispatches."""
    cfg = registry.get_smoke_config(arch)
    assert get_model(cfg) is FAMILY_MODULES[cfg.family]


def test_init_stacked_layout():
    """Layer i = g*unit + u lands in slot u at position g; the remainder
    stays as tail layers (8 layers in units of 6: 6 slots of G = 1 and a
    tail of 2; 7 layers in units of 2: 2 slots of G = 3 and a tail of 1)."""
    def make(i):
        return {"w": torch.full((2, 3), float(i)),
                "g": {"b": torch.ones(1) * i}}

    for n, unit in ((8, 6), (7, 2)):
        slots, tail = ST.init_stacked(make, n, unit)
        G = n // unit
        assert len(slots) == unit and len(tail) == n - G * unit
        for u, slot in enumerate(slots):
            assert slot["w"].shape == (G, 2, 3)
            for g in range(G):
                assert torch.equal(slot["w"][g], make(g * unit + u)["w"])
                assert slot["g"]["b"][g].item() == g * unit + u
        for j, layer in enumerate(tail):
            assert torch.equal(layer["w"], make(G * unit + j)["w"])


def test_param_layout_matches_jax():
    """The port's ``init`` gives the JAX package's tree: same paths,
    shapes and dtypes (the MoE layers' stacked (G, E, D, F) expert
    weights included), so the one carries over onto the other."""
    from repro.configs import registry as jreg
    for arch in ("gemma3-12b", "hubert-xlarge", "rwkv6-3b",
                 "recurrentgemma-2b", "recurrentgemma-2b 4 layers",
                 "olmoe-1b-7b", "granite-moe-3b-a800m"):
        name, *rest = arch.split(" ")
        # 4 layers of recurrentgemma: one stacked unit and a tail layer
        n = {"n_layers": 4} if rest else {}
        jcfg = dataclasses.replace(jreg.get_smoke_config(name), **n)
        jp = jax.tree.map(np.asarray,
                          jax_model(jcfg).init(jax.random.PRNGKey(0), jcfg))
        cfg = dataclasses.replace(registry.get_smoke_config(name), **n)
        tp = get_model(cfg).init(torch.Generator().manual_seed(0), cfg,
                                 "cpu")
        carried = tree_from_jax(jp, device="cpu")
        flat_t = ST.tree_map(lambda t: (tuple(t.shape), t.dtype), tp)
        flat_c = ST.tree_map(lambda t: (tuple(t.shape), t.dtype), carried)
        assert flat_t == flat_c


def test_decode_from_init_cache_matches_jax():
    """``init_cache`` gives the JAX package's cache tree (gemma3: window
    rings on the local slots, full length on the global one), and
    decoding from it matches JAX step by step (fp32).  Decoding past the
    window is held to JAX after a prefill (tests/test_torch_lm_pair.py)
    and to forward here (test_gemma3_ring_decode_past_the_window)."""
    from repro.configs import registry as jreg
    from test_torch_lm_pair import assert_trees_close
    jcfg = dataclasses.replace(jreg.get_smoke_config("gemma3-12b"),
                               dtype="float32")
    cfg = dataclasses.replace(registry.get_smoke_config("gemma3-12b"),
                              dtype="float32")
    jp = jtransformer.init(jax.random.PRNGKey(2), jcfg)
    tp = tree_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    jc = jtransformer.init_cache(jcfg, 2, 24)
    tc = transformer.init_cache(cfg, 2, 24, device="cpu")
    assert_trees_close(tc, jc, 0, "init_cache")
    assert tc["slots"][0]["k"].shape[2] == cfg.window
    assert tc["slots"][cfg.unit - 1]["k"].shape[2] == 24
    toks = np.random.default_rng(2).integers(0, cfg.vocab, (2, 6))
    for t in range(6):
        jl, jc = jtransformer.decode_step(jcfg, jp, jc,
                                          jnp.asarray(toks[:, t]))
        tl, tc = transformer.decode_step(cfg, tp, tc,
                                         torch.from_numpy(toks[:, t]))
        assert_trees_close(tl, jl, 1e-4, f"decode {t} logits")
    assert_trees_close(tc, jc, 1e-4, "cache after 6 steps")


@pytest.mark.parametrize("arch", ["rwkv6-3b", "recurrentgemma-2b"])
def test_recurrent_decode_from_init_cache_matches_jax(arch):
    """``init_cache`` gives the JAX package's state tree (rwkv6: fp32 WKV
    states and shifts; recurrentgemma on 4 layers: fp32 h and conv
    histories on the recurrent slots and the tail layer, a window ring on
    the attention slot), and decoding from it matches JAX step by step,
    the cache too (fp32)."""
    from repro.configs import registry as jreg
    from test_torch_lm_pair import assert_trees_close
    n = {"n_layers": 4} if arch == "recurrentgemma-2b" else {}
    jcfg = dataclasses.replace(jreg.get_smoke_config(arch), dtype="float32",
                               **n)
    cfg = dataclasses.replace(registry.get_smoke_config(arch),
                              dtype="float32", **n)
    jm, tm = jax_model(jcfg), get_model(cfg)
    jp = jm.init(jax.random.PRNGKey(2), jcfg)
    tp = tree_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    jc = jm.init_cache(jcfg, 2, 24)
    tc = tm.init_cache(cfg, 2, 24, device="cpu")
    assert_trees_close(tc, jc, 0, "init_cache")
    toks = np.random.default_rng(2).integers(0, cfg.vocab, (2, 20))
    for t in range(20):
        jl, jc = jm.decode_step(jcfg, jp, jc, jnp.asarray(toks[:, t]))
        tl, tc = tm.decode_step(cfg, tp, tc, torch.from_numpy(toks[:, t]))
        assert_trees_close(tl, jl, 1e-4, f"{arch} decode {t} logits")
    assert_trees_close(tc, jc, 1e-4, f"{arch} cache after 20 steps")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_primitives_match_jax(dtype):
    """rmsnorm (through the RMSNorm wrapper), RoPE, SwiGLU and GeGLU on
    the same params and inputs as the JAX package's layers."""
    from repro.models import layers as JL
    from repro_torch.models import layers as TL
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(5), 3)
    params = {"rmsnorm": {"g": jax.random.normal(k3, (32,), jdt)},
              "swiglu": JL.init_swiglu(k1, 32, 64, jdt),
              "gelu_mlp": JL.init_gelu_mlp(k2, 32, 64, jdt)}
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 7, 32)).astype(np.float32)
    jx, tx = jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt)
    tol = 1e-5 if dtype == "float32" else 2e-2
    for name, jp in params.items():
        tp = tree_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
        got = getattr(TL, name)(tp, tx)
        want = getattr(JL, name)(jp, jx)
        assert got.dtype == tdt
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   atol=tol, rtol=tol, err_msg=name)
    pos = np.arange(7)[None].repeat(2, 0) + 3
    got = TL.apply_rope(tx.reshape(2, 7, 2, 16), torch.from_numpy(pos), 1e6)
    want = JL.apply_rope(jx.reshape(2, 7, 2, 16), jnp.asarray(pos), 1e6)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


# ------------------------------------------------------ weights carry-over
def _jax_tree(dtype):
    k = jax.random.split(jax.random.PRNGKey(3), 4)
    return {"blocks": [{"w": jax.random.normal(k[0], (3, 5, 7), dtype)},
                       {"w": jax.random.normal(k[1], (3, 2), dtype)}],
            "tail": ({"g": jax.random.normal(k[2], (7,), dtype)},),
            "head": {"w": jax.random.normal(k[3], (4, 6), dtype)},
            "pos": jnp.arange(3, dtype=jnp.int32)}


@pytest.mark.parametrize("dtype,bits", [(jnp.bfloat16, np.uint16),
                                        (jnp.float32, np.uint32)])
def test_tree_from_jax_is_bitwise(dtype, bits):
    jt = _jax_tree(dtype)
    tt = tree_from_jax(jax.tree.map(np.asarray, jt), device="cpu")
    assert isinstance(tt["blocks"], list) and isinstance(tt["tail"], tuple)
    j_leaves, j_def = jax.tree.flatten(jt)
    t_leaves, t_def = jax.tree.flatten(tt)
    assert j_def == t_def
    tdtype = {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32}
    for j, t in zip(j_leaves, t_leaves):
        j = np.asarray(j)
        assert tuple(t.shape) == j.shape
        if j.dtype == np.int32:
            assert t.dtype == torch.int32
            assert np.array_equal(t.numpy(), j)
            continue
        assert t.dtype == tdtype[dtype]
        tbits = t.view({np.uint16: torch.int16,
                        np.uint32: torch.int32}[bits]).numpy().view(bits)
        assert np.array_equal(tbits, j.view(bits))


def test_tree_from_jax_takes_jax_arrays_and_owns_its_memory():
    a = jax.random.normal(jax.random.PRNGKey(4), (4,), jnp.bfloat16)
    arr = np.asarray(a).copy()
    t = tree_from_jax({"a": arr}, device="cpu")["a"]
    arr[...] = 0
    assert torch.equal(t, tree_from_jax({"a": a}, device="cpu")["a"])
    assert t.abs().sum().item() > 0
