"""The port on a device mesh, in four ``gloo`` processes on the CPU.

All cases run in one group of ``tests/test_torch_mesh_worker.py``
processes, four joined by a ``file://`` rendezvous under the module's own
temporary directory (xdist workers never share a port), on a 2 x 2
("data", "model") mesh: params, AdamW moments, batch and cache laid out
by ``core/meshplan.py``'s plan and ``adamw.zero1_shardings``/
``zero_specs`` (ZeRO-1 moments and the ZeRO-2 accumulator over "data"),
the kernels entered through ``local_map`` (their plain versions here),
the plan's hints redistributing interior tensors.  Rank 0 gathers the
results.

At these SMOKE widths the CP picks ``dp_replicated`` for every class
under the H100's lanes (the interconnect's cost of a tensor-parallel
layout outweighs a 64-wide model's products), so each case forces the
strategies its family can take at model 2 through ``plan_model``'s
``override``: internlm2-1.8b head_tp / ffn_tp / vocab_tp (4 heads, 2 KV
heads, d_ff 128, vocab 256: all divide by 2), granite-moe-3b-a800m
head_tp / expert_ffn_tp / vocab_tp (5 experts: expert_parallel is
infeasible, d_ff 32 divides), olmoe-1b-7b head_tp / expert_parallel /
vocab_tp (8 experts), and qwen3-8b decode with head_tp / ffn_tp /
vocab_tp, whose plan sets every decode hint (the cache sequence-sharded
over "model", the logits, the q heads, the FFN hidden), its cache written
by a select over each rank's shard and, with ``DECODE_SCATTER_UPDATE``,
by a scatter of the written slot.

Two train steps (2 microbatches each, fp32, the gradient clipped: its
norm is above ``max_grad_norm``, so the clip factor, and with it the
global norm, reaches the second step's params) are held to the JAX
package's unsharded ``make_train_step`` at 1e-4 (the reference's
tolerance, as tests/test_torch_train.py) and to the port's unsharded
step at 1e-5: each step's loss and global gradient norm (each element
counted once, however many ranks hold it), every param, and both moments
at a tolerance scaled to each leaf's largest magnitude (a second moment
is ~1e-3 g^2, below any absolute tolerance).  The decode's logits are held to the
JAX package's ``decode_step`` at 1e-4.  One H100 cannot check any of
this: a sharded layout needs more than one device.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.core import meshplan as jmeshplan
from repro.models.api import get_model as jax_model
from repro.optim import adamw as jadamw
from repro.train.step import make_train_step as jax_train_step
from repro_torch.configs import registry as treg
from repro_torch.core import meshplan
from repro_torch.core.pytree import leaves_with_path
from repro_torch.core.weights import tree_from_jax
from repro_torch.models.api import get_model as torch_model
from repro_torch.optim import adamw as tadamw
from repro_torch.train import step as tstep

ROOT = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).with_name("test_torch_mesh_worker.py")
RANKS = 4
TIMEOUT = 240       # seconds for the group of four processes
JAX_TOL = 1e-4
PORT_TOL = 1e-5
# eps 1e-6: Adam's first step moves a param by lr * g / (|g| + eps), which
# for a gradient element near eps is ill-conditioned (at the default 1e-8
# two summation orders of one 1e-8 olmoe w_down gradient moved the param
# by 1.4e-5); at 1e-6 the step is a smooth function of the gradient
# max_grad_norm 0.1: below every case's gradient norm, so the clip acts
OPT = dict(lr=1e-3, eps=1e-6, warmup_steps=0, total_steps=10,
           max_grad_norm=0.1)
STEPS = 2
B, S = 8, 16
MAX_SEQ = 16        # the decode's cache slots

TRAIN = {
    "internlm2-1.8b": {"attention": "head_tp", "ffn": "ffn_tp",
                       "vocab": "vocab_tp"},
    "granite-moe-3b-a800m": {"attention": "head_tp",
                             "ffn": "expert_ffn_tp", "vocab": "vocab_tp"},
    "olmoe-1b-7b": {"attention": "head_tp", "ffn": "expert_parallel",
                    "vocab": "vocab_tp"},
}
DECODE = ("qwen3-8b", {"attention": "head_tp", "ffn": "ffn_tp",
                       "vocab": "vocab_tp"})


@pytest.fixture(autouse=True)
def _jnp_references(monkeypatch):
    monkeypatch.delenv("REPRO_USE_PALLAS", raising=False)


def _pair(arch, seed=0):
    cj = dataclasses.replace(jreg.get_smoke_config(arch), dtype="float32")
    ct = dataclasses.replace(treg.get_smoke_config(arch), dtype="float32")
    jp = jax_model(cj).init(jax.random.PRNGKey(seed), cj)
    tp = tree_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return cj, ct, jp, tp


def _batch(vocab, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, vocab, (B, S)).astype(np.int32)
    y = rng.integers(0, vocab, (B, S)).astype(np.int32)
    y[0, 3] = tstep.IGNORE
    y[-1, -2:] = tstep.IGNORE
    return x, y


def _start(tmp_path, cases):
    """The four processes of a group, started on ``cases``."""
    torch.save(cases, tmp_path / "case.pt")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), str(r), str(RANKS),
         str(tmp_path / "rendezvous"), str(tmp_path / "case.pt"),
         str(tmp_path / "out.pt")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(RANKS)]
    return tmp_path, procs


def _finish(started):
    """Rank 0's gathered results (name -> results), once the four
    processes are done."""
    tmp_path, procs = started
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    rcs = [p.returncode for p in procs]
    assert rcs == [0] * RANKS, "\n".join(log[-3000:] for log in logs)
    return torch.load(tmp_path / "out.pt", weights_only=False)


class _JaxMesh:
    """What the JAX package's planner reads of a mesh: the 2 x 2 mesh."""
    axis_names = ("data", "model")

    class devices:
        shape = (2, 2)
        size = 4


def _placements(spec):
    """A JAX PartitionSpec as DTensor placements on the 2 x 2 mesh, in
    the worker's text."""
    out = []
    for name in _JaxMesh.axis_names:
        dims = [i for i, e in enumerate(spec)
                if e == name or (isinstance(e, tuple) and name in e)]
        out.append(f"Shard(dim={dims[0]})" if dims else "Replicate()")
    return "(" + ", ".join(out) + ")"


def _close(got, want, tol, what, scaled=False):
    """``got`` against ``want`` at rtol ``tol`` and atol ``tol``, or, with
    ``scaled``, atol ``tol`` times ``want``'s largest magnitude."""
    a = got.float().numpy()
    b = np.asarray(jnp.asarray(want, jnp.float32)) \
        if not isinstance(want, torch.Tensor) else want.float().numpy()
    assert a.shape == b.shape, what
    atol = tol * float(np.abs(b).max(initial=0.0)) if scaled else tol
    np.testing.assert_allclose(a, b, atol=atol, rtol=tol, err_msg=what)


def _train_case(arch):
    cj, ct, jp, tp = _pair(arch)
    batches = [_batch(ct.vocab, seed) for seed in range(STEPS)]
    case = dict(cfg=ct, mode="train", mesh=(2, 2), batch=B, seq=S,
                override=TRAIN[arch], params=tp,
                data=[{"x": torch.from_numpy(x),
                       "labels": torch.from_numpy(y)} for x, y in batches],
                opt=OPT, remat=True, micro=2)
    return case, (cj, jp, batches)


def _decode_case(arch, override, scatter):
    cj, ct, jp, tp = _pair(arch)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, ct.vocab, (3, B)).astype(np.int32)
    case = dict(cfg=ct, mode="decode", mesh=(2, 2), batch=B, seq=MAX_SEQ,
                override=override, params=tp, scatter=scatter,
                cache=torch_model(ct).init_cache(ct, B, MAX_SEQ, "cpu"),
                tokens=[torch.from_numpy(t) for t in tokens])
    return case, (cj, jp, tokens)


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """Every case in one group of four processes, started at once (the
    tests compute their references while it runs; the ranks' sharding
    propagation, cached per process, serves all cases): (the started
    group, name -> (case, what the references need))."""
    built = {arch: _train_case(arch) for arch in TRAIN}
    for scatter in (False, True):
        built[f"decode scatter={scatter}"] = _decode_case(*DECODE, scatter)
    started = _start(tmp_path_factory.mktemp("mesh"),
                     {name: case for name, (case, _) in built.items()})
    results = {}

    def finish(name):
        if not results:
            results.update(_finish(started))
        return results[name]
    yield finish, built
    for p in started[1]:
        if p.poll() is None:
            p.kill()
            p.wait()


@pytest.mark.parametrize("arch", list(TRAIN))
def test_train_step_on_a_2x2_mesh(group, arch):
    finish, built = group
    case, (cj, jp, batches) = built[arch]
    tp = case["params"]
    ct = case["cfg"]
    # the port on one device
    step = tstep.make_train_step(ct, tadamw.AdamWConfig(**OPT), remat=True,
                                 microbatches=2)
    p1, o1, m1 = tp, tadamw.init(tp), []
    for data in case["data"]:
        p1, o1, metrics = step(p1, o1, data)
        m1.append({k: float(metrics[k]) for k in ("loss", "grad_norm")})
    # the JAX package on one device
    jstep = jax.jit(jax_train_step(cj, jadamw.AdamWConfig(**OPT),
                                   remat=True, microbatches=2))
    jp1, jo1, jm1 = jp, jadamw.init(jp), []
    for x, y in batches:
        jp1, jo1, metrics = jstep(
            jp1, jo1, {"x": jnp.asarray(x), "labels": jnp.asarray(y)})
        jm1.append({k: float(metrics[k]) for k in ("loss", "grad_norm")})
    out = finish(arch)
    assert out["strategy"] == TRAIN[arch]
    # the moments laid out as the JAX package's ZeRO-1 specs say
    jplan = jmeshplan.plan_model(cj, _JaxMesh(), "train", B, S,
                                 override=TRAIN[arch])
    specs = jadamw.zero_specs(jplan, _JaxMesh(), jp)
    for path, spec in jax.tree_util.tree_flatten_with_path(
            specs, is_leaf=lambda x: isinstance(x, jax.sharding
                                                .PartitionSpec))[0]:
        key = jmeshplan._path_str(path)
        assert out["moment_placements"][key] == _placements(spec), key
    # the clip acts at every step, so the norm reaches the params
    assert min(m["grad_norm"] for m in m1) > OPT["max_grad_norm"]
    for n, (want, jwant) in enumerate(zip(m1, jm1)):
        for k in ("loss", "grad_norm"):
            got = out[k][n]
            assert got == pytest.approx(want[k], rel=PORT_TOL,
                                        abs=PORT_TOL), (k, n)
            assert got == pytest.approx(jwant[k], rel=JAX_TOL,
                                        abs=JAX_TOL), (k, n)
    for name, tree in (("params", p1), ("m", o1.m), ("v", o1.v)):
        for path, t in leaves_with_path(tree):
            key = "/".join(path)
            _close(out["trees"][name][key], t, PORT_TOL, f"{name} {key}",
                   scaled=name != "params")
    for name, tree in (("params", jp1), ("m", jo1.m), ("v", jo1.v)):
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            key = jmeshplan._path_str(path)
            _close(out["trees"][name][key], leaf, JAX_TOL, f"{name} {key}",
                   scaled=name != "params")


@pytest.mark.parametrize("scatter", [False, True])
def test_decode_with_the_decode_hints_on_a_2x2_mesh(group, scatter):
    """The cache written by a select over each rank's shard (the JAX
    default) or, with ``DECODE_SCATTER_UPDATE``, by a scatter of the
    written slot."""
    finish, built = group
    name = f"decode scatter={scatter}"
    _, (cj, jp, tokens) = built[name]
    jm = jax_model(cj)
    cache = jm.init_cache(cj, B, MAX_SEQ)
    want = []
    for t in tokens:
        logits, cache = jm.decode_step(cj, jp, cache, jnp.asarray(t))
        want.append(logits)
    out = finish(name)
    assert out["strategy"] == DECODE[1]
    assert set(out["hints"]) == {"decode_cache", "decode_logits",
                                 "decode_heads", "ffn_hidden"} | (
        {"decode_scatter_update"} if scatter else set())
    for n, logits in enumerate(want):
        _close(out["logits"][n], logits, JAX_TOL, f"decode step {n}")
