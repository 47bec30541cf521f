"""The port's training path against the JAX package's, on CPU tensors.

The same numpy-seeded inputs and the JAX ``init`` params (carried over by
``core/weights.tree_from_jax``) go through ``train/step.py`` of both
packages at smoke size in fp32: the cross entropy, one train step's loss,
gradients, updated params and AdamW moments, remat against none, the
microbatch equivalence and a falling loss (the twins of
tests/test_train_moe.py's).  The JAX side runs with ``REPRO_USE_PALLAS``
unset: ``jax.grad`` cannot pass a ``pallas_call`` (no kernel of the JAX
package has a custom_vjp), so the JAX package trains through its jnp
references.  Then the backward kernels' plain versions (``rmsnorm_bwd_ref``,
``attention_bwd_ref``) against ``jax.vjp`` of the JAX package's
references, causal, windowed, bidirectional and GQA, in fp32 and bf16,
and ``forward(remat=True)`` against ``remat=False`` for every family."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.kernels.flash_attention.ref import attention_ref as jax_attention
from repro.kernels.rmsnorm.ref import rmsnorm_ref as jax_rmsnorm
from repro.models.api import get_model as jax_model
from repro.optim import adamw as jadamw
from repro.train.step import cross_entropy as jax_ce
from repro.train.step import make_loss_fn as jax_loss_fn
from repro.train.step import make_train_step as jax_train_step
from repro_torch.configs import registry as treg
from repro_torch.core.pytree import leaves, tree_map
from repro_torch.core.weights import tree_from_jax
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import flash_attention as tfa
from repro_torch.kernels.flash_attention.ref import attention_bwd_ref
from repro_torch.kernels.rmsnorm import rmsnorm as trms
from repro_torch.kernels.rmsnorm.ref import rmsnorm_bwd_ref
from repro_torch.models.api import get_model as torch_model
from repro_torch.optim import adamw as tadamw
from repro_torch.train import step as tstep

TOL = 1e-4          # grads, params and moments after one fp32 step
LOSS_TOL = 1e-5


@pytest.fixture(autouse=True)
def _jnp_references(monkeypatch):
    monkeypatch.delenv("REPRO_USE_PALLAS", raising=False)


def _pair(arch, seed=0, dtype="float32"):
    cj = dataclasses.replace(jreg.get_smoke_config(arch), dtype=dtype)
    ct = dataclasses.replace(treg.get_smoke_config(arch), dtype=dtype)
    jp = jax_model(cj).init(jax.random.PRNGKey(seed), cj)
    tp = tree_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return cj, ct, jp, tp


def _batch(vocab, B, S, seed=0, ignore=True):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, vocab, (B, S)).astype(np.int32)
    y = rng.integers(0, vocab, (B, S)).astype(np.int32)
    if ignore:
        y[0, 3] = tstep.IGNORE
        y[-1, -2:] = tstep.IGNORE
    return ({"x": jnp.asarray(x), "labels": jnp.asarray(y)},
            {"x": torch.from_numpy(x), "labels": torch.from_numpy(y)})


def _close(got, want, tol, what):
    got, want = list(got), list(want)
    assert len(got) == len(want), what
    for n, (a, b) in enumerate(zip(got, want)):
        a = a.float().numpy() if isinstance(a, torch.Tensor) else a
        b = np.asarray(jnp.asarray(b, jnp.float32))
        assert a.shape == b.shape, f"{what} leaf {n}: {a.shape} {b.shape}"
        np.testing.assert_allclose(a, b, atol=tol, rtol=tol,
                                   err_msg=f"{what} leaf {n}")


def test_cross_entropy_matches_jax():
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(2, 8, 17)).astype(np.float32) * 3
    labels = rng.integers(0, 17, (2, 8)).astype(np.int32)
    labels[0, 3] = tstep.IGNORE
    labels[1, :2] = tstep.IGNORE
    want, wn = jax_ce(jnp.asarray(logits), jnp.asarray(labels))
    got, n = tstep.cross_entropy(torch.from_numpy(logits),
                                 torch.from_numpy(labels))
    assert int(n) == int(wn) == 13
    assert abs(float(got) - float(want)) < LOSS_TOL
    # every position ignored: n is clamped at 1 and the loss is 0
    none = np.full((2, 8), tstep.IGNORE, np.int32)
    got, n = tstep.cross_entropy(torch.from_numpy(logits),
                                 torch.from_numpy(none))
    assert int(n) == 1 and float(got) == 0.0


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "qwen3-8b"])
def test_train_step_matches_jax(arch):
    """One step at smoke size in fp32 (qwen3-8b: per-head qk-norm, so
    RMSNorm's backward runs at width Dh with a gain too): the loss, every
    gradient, every updated param and both moments.  The other families'
    cases are in tests/test_torch_train_step_{recurrent,moe}.py."""
    check_train_step(arch)


def check_train_step(arch):
    """:func:`test_train_step_matches_jax`'s comparison for ``arch``: one
    fp32 smoke step of both packages, with ``REPRO_USE_PALLAS`` unset."""
    cj, ct, jp, tp = _pair(arch)
    jb, tb = _batch(cj.vocab, 4, 16)
    jopt = jadamw.AdamWConfig(warmup_steps=1)
    topt = tadamw.AdamWConfig(warmup_steps=1)
    (jloss, _), jgrads = jax.value_and_grad(
        jax_loss_fn(cj, remat=True), has_aux=True)(jp, jb["x"],
                                                   jb["labels"])
    (tloss, _), tgrads = tstep.value_and_grad(
        tstep.make_loss_fn(ct, remat=True))(tp, tb["x"], tb["labels"])
    assert abs(float(tloss) - float(jloss)) < LOSS_TOL
    _close(leaves(tgrads), jax.tree.leaves(jgrads), TOL, f"{arch} grads")
    jpn, jos, jm = jax.jit(jax_train_step(cj, jopt, remat=True))(
        jp, jadamw.init(jp), jb)
    tpn, tos, tm = tstep.make_train_step(ct, topt, remat=True)(
        tp, tadamw.init(tp), tb)
    assert abs(float(tm["loss"]) - float(jm["loss"])) < LOSS_TOL
    assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) < TOL
    assert int(tos.step) == int(jos.step) == 1
    _close(leaves(tpn), jax.tree.leaves(jpn), TOL, f"{arch} params")
    _close(leaves(tos.m), jax.tree.leaves(jos.m), TOL, f"{arch} m")
    _close(leaves(tos.v), jax.tree.leaves(jos.v), TOL, f"{arch} v")
    # the step leaves its arguments as they were
    for a, b in zip(leaves(tp), jax.tree.leaves(jp)):
        assert not a.requires_grad
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("microbatches", [1, 2])
def test_donated_step_equals_pure_step(microbatches):
    """``donate=True`` (the launcher's, as the JAX launcher donates its
    state to the jitted step) writes the pure step's results into the
    argument tensors and returns those tensors."""
    _, ct, _, tp = _pair("qwen3-8b")
    _, tb = _batch(ct.vocab, 4, 16)
    opt = tadamw.AdamWConfig(warmup_steps=1)
    pure = tstep.make_train_step(ct, opt, microbatches=microbatches)(
        tp, tadamw.init(tp), tb)
    own = tree_map(torch.clone, tp)
    own_state = tadamw.init(own)
    got = tstep.make_train_step(ct, opt, microbatches=microbatches,
                                donate=True)(own, own_state, tb)
    assert float(got[2]["loss"]) == float(pure[2]["loss"])
    for tree, mine, want in ((got[0], own, pure[0]),
                             (got[1].m, own_state.m, pure[1].m),
                             (got[1].v, own_state.v, pure[1].v)):
        for a, b, c in zip(leaves(tree), leaves(mine), leaves(want)):
            assert a is b
            torch.testing.assert_close(a, c, atol=0, rtol=0)


def test_donated_update_in_slices_is_bitwise(monkeypatch):
    """A donated leaf larger than ``DONATE_SLICE`` elements is updated in
    slices along its first axis (bounding the fp32 temporaries): the same
    bits as the whole-leaf update, for matrices (decayed), vectors and a
    scalar, a ragged last slice included."""
    g = torch.Generator().manual_seed(4)
    params = {"w": torch.randn(7, 5, 3, generator=g).to(torch.bfloat16),
              "b": torch.randn(11, generator=g), "s": torch.tensor(0.5)}
    grads = tree_map(lambda t: torch.randn(t.shape, generator=g)
                     .to(t.dtype), params)
    cfg = tadamw.AdamWConfig(warmup_steps=1)
    state = tadamw.init(params)
    state = tadamw.AdamWState(state.step, *(
        tree_map(lambda t: torch.rand(t.shape, generator=g), tree)
        for tree in (state.m, state.v)))
    want = tadamw.update(cfg, state, grads, params)
    monkeypatch.setattr(tadamw, "DONATE_SLICE", 10)
    assert len(tadamw._slices(params["w"], 10)) == 7
    assert len(tadamw._slices(params["b"], 10)) == 2
    mine = tree_map(torch.clone, params)
    own = tadamw.AdamWState(state.step, tree_map(torch.clone, state.m),
                            tree_map(torch.clone, state.v))
    got = tadamw.update(cfg, own, grads, mine, donate=True)
    for a, b in zip(leaves(got[0]) + leaves(got[1].m) + leaves(got[1].v),
                    leaves(want[0]) + leaves(want[1].m)
                    + leaves(want[1].v)):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    assert all(a is b for a, b in zip(leaves(got[0]), leaves(mine)))


def test_remat_equals_no_remat():
    _, ct, _, tp = _pair("internlm2-1.8b")
    _, tb = _batch(ct.vocab, 2, 16)
    opt = tadamw.AdamWConfig(warmup_steps=1)
    outs = [tstep.make_train_step(ct, opt, remat=r)(tp, tadamw.init(tp), tb)
            for r in (True, False)]
    assert float(outs[0][2]["loss"]) == float(outs[1][2]["loss"])
    for a, b in zip(leaves(outs[0][0]), leaves(outs[1][0])):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


FAMILIES = ["internlm2-1.8b", "rwkv6-3b", "recurrentgemma-2b",
            "olmoe-1b-7b"]


@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_remat_equals_plain(arch):
    """``forward(remat=True)`` gives ``forward(remat=False)``'s logits and,
    under autograd, its gradients, for each of the four families."""
    cfg = dataclasses.replace(treg.get_smoke_config(arch), dtype="float32")
    model = torch_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), cfg, "cpu")
    x = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 24)))
    outs = []
    for remat in (False, True):
        live = tree_map(lambda p: p.detach().requires_grad_(True), params)
        logits = model.forward(cfg, live, x, remat=remat)
        grads = torch.autograd.grad((logits ** 2).mean(), leaves(live),
                                    allow_unused=True)
        outs.append((logits.detach(), grads))
    torch.testing.assert_close(outs[1][0], outs[0][0], atol=0, rtol=0)
    for a, b in zip(outs[1][1], outs[0][1]):
        assert (a is None) == (b is None)
        if a is not None:
            torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_microbatch_equivalence():
    """grad accumulation over 4 microbatches == single big batch (fp32),
    tests/test_train_moe.py's bounds (no ignored label: the loss is the
    mean of the microbatches' means, as in the JAX package)."""
    _, ct, _, tp = _pair("internlm2-1.8b")
    _, tb = _batch(ct.vocab, 8, 16, ignore=False)
    s1 = tstep.make_train_step(ct, tadamw.AdamWConfig(), remat=False,
                               microbatches=1)
    s4 = tstep.make_train_step(ct, tadamw.AdamWConfig(), remat=False,
                               microbatches=4)
    p1, _, m1 = s1(tp, tadamw.init(tp), tb)
    p4, _, m4 = s4(tp, tadamw.init(tp), tb)
    assert abs(float(m1["loss"]) - float(m4["loss"])) < 1e-4
    for a, b in zip(leaves(p1), leaves(p4)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=5e-4,
                                   rtol=5e-3)
    # accum_specs lays out DTensor params on their mesh: plain ones refuse
    with pytest.raises(ValueError, match="DTensor"):
        tstep.make_train_step(ct, microbatches=4, accum_specs=tadamw.zero_specs(
            _PlanStub(), _Mesh2x2(), tp))(tp, tadamw.init(tp), tb)
    with pytest.raises(ValueError):
        tstep.make_train_step(ct, microbatches=3)(tp, tadamw.init(tp), tb)


def test_loss_decreases():
    """Overfit one fixed batch at smoke size (bf16 params), as
    tests/test_train_moe.py does."""
    cfg = treg.get_smoke_config("internlm2-1.8b")
    model = torch_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), cfg, "cpu")
    opt = tadamw.init(params)
    step = tstep.make_train_step(
        cfg, tadamw.AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=30),
        remat=False)
    rng = np.random.default_rng(0)
    batch = {"x": torch.from_numpy(rng.integers(0, cfg.vocab, (4, 32))),
             "labels": torch.from_numpy(rng.integers(0, cfg.vocab, (4, 32)))}
    losses = []
    for _ in range(25):
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] * 0.7, losses[::6]
    ev = tstep.make_eval_step(cfg)(params, batch)
    assert float(ev["loss"]) < losses[0] * 0.7


class _Mesh2x2:
    """What the planners read of a mesh: a 2 x 2 ("data", "model") one in
    both packages' spellings."""
    mesh_dim_names = axis_names = ("data", "model")
    shape = (2, 2)

    class devices:
        shape = (2, 2)


class _PlanStub:
    """A plan whose every param is replicated."""
    @staticmethod
    def spec_for(path, ndim=None):
        from repro_torch.core.meshplan import Spec
        return Spec()


def test_adamw_zero_helpers_wait_for_the_mesh():
    """The ZeRO helpers, once the mesh planner's port arrived: the port's
    ``zero_specs`` and ``zero1_shardings`` give the JAX package's specs
    for every moment leaf of a plan over a 2 x 2 mesh (the params' plan
    specs plus "data" on the largest unsharded dim it divides), with the
    strategies forced alike (the two planners price other lanes)."""
    from repro.core import meshplan as jmp
    from repro_torch.core import meshplan as tmp
    from repro_torch.core.pytree import leaves_with_path
    for arch, ffn in (("internlm2-1.8b", "ffn_tp"),
                      ("olmoe-1b-7b", "expert_parallel")):
        cj, ct, jp, tp = _pair(arch)
        force = {"attention": "head_tp", "ffn": ffn, "vocab": "vocab_tp"}
        jplan = jmp.plan_model(cj, _Mesh2x2(), "train", 8, 16,
                               override=force)
        tplan = tmp.plan_model(ct, _Mesh2x2(), "train", 8, 16,
                               override=force)
        want = {jmp._path_str(p): tuple(s) for p, s in
                jax.tree_util.tree_flatten_with_path(
                    jadamw.zero_specs(jplan, _Mesh2x2(), jp),
                    is_leaf=lambda x: isinstance(x, jax.sharding
                                                 .PartitionSpec))[0]}
        specs = tadamw.zero_specs(tplan, _Mesh2x2(), tp)
        got = {"/".join(p): tuple(s) for p, s in leaves_with_path(specs)}
        assert got == want, arch
        sh = tadamw.zero1_shardings(tplan, _Mesh2x2(), tp, tadamw.init(tp))
        assert tuple(sh.step.spec) == ()
        for tree in (sh.m, sh.v):
            assert {"/".join(p): tuple(s.spec)
                    for p, s in leaves_with_path(tree)} == want, arch


@pytest.mark.parametrize("step", [0, 5, 50, 200, 10_000])
def test_adamw_schedule_matches_jax(step):
    cfg_j = jadamw.AdamWConfig(warmup_steps=10, total_steps=100)
    cfg_t = tadamw.AdamWConfig(warmup_steps=10, total_steps=100)
    want = float(jadamw.schedule(cfg_j, jnp.asarray(step, jnp.int32)))
    got = float(tadamw.schedule(cfg_t, torch.tensor(step,
                                                    dtype=torch.int32)))
    assert abs(got - want) <= 1e-9 + 1e-6 * abs(want)


# ------------------------------------------------- backward plain versions

BWD_DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
              "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _pair_tensors(rng, shape, dtype, scale=1.0, shift=0.0):
    t = torch.from_numpy((rng.normal(size=shape) * scale + shift)
                         .astype(np.float32)).to(BWD_DTYPES[dtype][1])
    return jnp.asarray(t.float().numpy()).astype(BWD_DTYPES[dtype][0]), t


def _rel_close(got, want, tol, what):
    g = got.float().numpy()
    w = np.asarray(jnp.asarray(want, jnp.float32))
    scale = max(float(np.abs(w).max()), 1e-30)
    err = float(np.abs(g - w).max()) / scale
    assert err <= tol, f"{what}: max error {err:.3e} of max |want|"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,d", [(37, 128), (6, 2048), (9, 100)])
def test_rmsnorm_bwd_ref_matches_jax_grad(rows, d, dtype):
    rng = np.random.default_rng(rows + d)
    jx, tx = _pair_tensors(rng, (rows, d), dtype)
    jg, tg = _pair_tensors(rng, (d,), dtype, 0.1, 1.0)
    jdy, tdy = _pair_tensors(rng, (rows, d), dtype)
    _, vjp = jax.vjp(lambda x, g: jax_rmsnorm(x, g), jx, jg)
    want_dx, want_dg = vjp(jdy)
    dx, dg = rmsnorm_bwd_ref(tx, tg, tdy)
    tol = BWD_DTYPES[dtype][2]
    assert dx.dtype == tx.dtype and dg.dtype == tg.dtype
    _rel_close(dx, want_dx, tol, "dx")
    _rel_close(dg, want_dg, tol, "dg")
    # the wrapper on CPU tensors: autograd through the plain forward, and
    # rmsnorm_bwd (the CUDA kernel's entry) on CPU tensors
    x = tx.clone().requires_grad_(True)
    g = tg.clone().requires_grad_(True)
    auto = torch.autograd.grad(trms.rmsnorm(x, g), (x, g), tdy)
    _rel_close(auto[0], want_dx, tol, "autograd dx")
    _rel_close(auto[1], want_dg, tol, "autograd dg")
    for a, b in zip(trms.rmsnorm_bwd(tx, tg, tdy), (dx, dg)):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_rmsnorm_bwd_ref_without_gain():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(5, 64)).astype(np.float32))
    dy = torch.from_numpy(rng.normal(size=(5, 64)).astype(np.float32))
    xr = x.clone().requires_grad_(True)
    (want,) = torch.autograd.grad(trms.rmsnorm(xr, None), xr, dy)
    dx, dg = rmsnorm_bwd_ref(x, None, dy)
    assert dg is None
    torch.testing.assert_close(dx, want, atol=1e-6, rtol=1e-5)


# B, S, H, KV, Dh, causal, window
ATTN_BWD = [
    (2, 48, 4, 2, 16, True, None),       # GQA 2, causal
    (1, 64, 4, 1, 32, True, 20),         # GQA 4, causal window
    (1, 40, 2, 2, 16, False, None),      # bidirectional
    (2, 33, 6, 2, 8, False, 9),          # bidirectional window, ragged S
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,KV,Dh,causal,win", ATTN_BWD)
def test_attention_bwd_ref_matches_jax_grad(B, S, H, KV, Dh, causal, win,
                                            dtype):
    rng = np.random.default_rng(S + H)
    jq, tq = _pair_tensors(rng, (B, S, H, Dh), dtype)
    jk, tk = _pair_tensors(rng, (B, S, KV, Dh), dtype)
    jv, tv = _pair_tensors(rng, (B, S, KV, Dh), dtype)
    jdo, tdo = _pair_tensors(rng, (B, S, H, Dh), dtype)
    _, vjp = jax.vjp(lambda q, k, v: jax_attention(q, k, v, causal=causal,
                                                   window=win), jq, jk, jv)
    want = vjp(jdo)
    got = attention_bwd_ref(tq, tk, tv, tdo, causal=causal, window=win)
    tol = BWD_DTYPES[dtype][2]
    for name, a, b, t in zip("qkv", got, want, (tq, tk, tv)):
        assert a.dtype == t.dtype and a.shape == t.shape
        _rel_close(a, b, tol, f"d{name}")
    # the wrapper on CPU tensors: autograd through its plain forward, and
    # flash_attention_bwd (the CUDA kernels' entry) on CPU tensors
    live = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    out = tfa.flash_attention(*live, causal=causal, window=win)
    auto = torch.autograd.grad(out, live, tdo)
    for name, a, b in zip("qkv", auto, want):
        _rel_close(a, b, tol, f"autograd d{name}")
    for a, b in zip(tfa.flash_attention_bwd(tq, tk, tv, out.detach(), tdo,
                                            causal, win), got):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_attention_bwd_ref_row_without_keys_has_zero_grads():
    """window 0 masks every key: the kernels' output is 0 (clamped
    denominator), so every gradient is 0."""
    rng = np.random.default_rng(5)
    q, k, v, do = (torch.from_numpy(rng.normal(size=(1, 8, 2, 16))
                                    .astype(np.float32)) for _ in range(4))
    for g in attention_bwd_ref(q, k[:, :, :1], v[:, :, :1], do, True, 0):
        assert torch.count_nonzero(g) == 0


def test_refuse_grad_only_under_grad():
    """The K1 wrapper's guard on the card (``refuse_grad``; the GEMM has no
    backward kernel): it raises where grad is enabled and an operand
    requires grad, and lets every other call pass."""
    a = torch.ones(2, 2, requires_grad=True)
    b = torch.ones(2, 2)
    with pytest.raises(RuntimeError, match="no backward kernel"):
        _build.refuse_grad("matmul", a, b)
    _build.refuse_grad("matmul", b, b)
    _build.refuse_grad("wkv6", b, None)
    with torch.no_grad():
        _build.refuse_grad("matmul", a, b)
