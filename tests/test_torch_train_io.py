"""The port's checkpoint manager, fault supervisor, data pipeline and
gradient compression: the twins of tests/test_checkpoint_fault.py and
tests/test_data_compress.py on the port's modules, and the port against
the JAX package where the two meet: a checkpoint the JAX manager wrote
(bf16 leaves included) restored by the port bitwise, the same manifest and
bf16 bytes for the same tree, the pipeline's batches identical, and the
compressed sum of one replica and of two (``torch.distributed`` over gloo,
two processes) against the JAX package's."""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JaxManager
from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import Pipeline as JaxPipeline
from repro.optim import adamw as jadamw
from repro.optim import compress as jcompress
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core.pytree import leaves
from repro_torch.core.weights import tree_from_jax
from repro_torch.data.pipeline import DataConfig, Pipeline
from repro_torch.fault.supervisor import StepFailure, Supervisor, \
    SupervisorConfig
from repro_torch.optim import adamw as tadamw
from repro_torch.optim import compress
from repro_torch.train.step import IGNORE

SRC = Path(__file__).resolve().parents[1] / "src"


# ------------------------------------------------------------- checkpoint

def _tree(x=0.0):
    return {"a": torch.full((4, 3), x), "b": [torch.full((2,), x + 1),
                                              torch.zeros((),
                                                          dtype=torch.int32)]}


def test_save_restore_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    t = _tree(3.5)
    mgr.save(7, t, blocking=True)
    assert mgr.latest_step() == 7
    got = mgr.restore(7, _tree())
    for a, b in zip(leaves(got), leaves(t)):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)


def test_save_restore_dtensor_leaves(tmp_path):
    """A state laid out on a device mesh (the launcher's mesh path):
    each DTensor leaf is written whole and restored bitwise in its
    ``like``'s layout."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.launch.mesh import make_mesh
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
        g = torch.Generator().manual_seed(3)
        tree = {"w": torch.randn(6, 4, generator=g).to(torch.bfloat16),
                "m": torch.randn(6, 4, generator=g)}
        placed = {"w": DTensor.from_local(tree["w"], mesh,
                                          [Replicate(), Shard(1)]),
                  "m": DTensor.from_local(tree["m"], mesh,
                                          [Shard(0), Replicate()])}
        mgr = CheckpointManager(str(tmp_path))
        mgr.save(1, placed, blocking=True)
        back = mgr.restore(1, placed)
        for k in tree:
            assert isinstance(back[k], DTensor)
            assert back[k].placements == placed[k].placements
            assert torch.equal(back[k].full_tensor(), tree[k])
    finally:
        dist.destroy_process_group()


def test_save_snapshots_before_returning(tmp_path):
    """The tree may change in place once ``save`` returns (the launcher's
    donated step does): the checkpoint holds the values at the call."""
    mgr = CheckpointManager(str(tmp_path))
    t = _tree(1.5)
    mgr.save(3, t)
    for leaf in leaves(t):
        leaf.add_(7)
    mgr.wait()
    for a, b in zip(leaves(mgr.restore(3, _tree())), leaves(_tree(1.5))):
        assert torch.equal(a, b)


def test_async_save_and_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in range(5):
        mgr.save(s, _tree(float(s)))
    mgr.wait()
    assert mgr.finished_steps() == [3, 4]


def test_unfinished_checkpoint_ignored(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _tree(1.0), blocking=True)
    os.makedirs(tmp_path / "step_000002" / "data")
    assert mgr.latest_step() == 1
    with pytest.raises(FileNotFoundError):
        mgr.restore(2, _tree())


def test_supervisor_restarts_from_checkpoint(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    cfg = SupervisorConfig(total_steps=20, ckpt_every=5, max_restarts=3)
    sup = Supervisor(cfg, mgr, failure_schedule={12: StepFailure("boom")})
    trace = []

    def step_fn(state, step):
        trace.append(step)
        return {"a": state["a"] + 1.0,
                "b": [state["b"][0], state["b"][1] + 1]}

    report = sup.run(_tree(0.0), step_fn)
    assert report.restarts == 1
    assert report.steps_run == 20
    assert len(report.recovery_s) == 1 and report.recovery_s[0] >= 0.0
    assert trace.count(12) == 2 or trace.count(11) == 2
    assert int(report.final_state["b"][1]) == 20


def test_launcher_trains_under_the_supervisor(tmp_path):
    """``launch/train.py`` at smoke size on the CPU: the donated step under
    the supervisor, step 0 checkpointed and the state it returns the one
    the supervisor ends with."""
    from repro_torch.launch import train as launch
    out = launch.train("internlm2-1.8b", steps=3, batch=2, seq=32,
                       ckpt_dir=str(tmp_path), log_every=100, device="cpu")
    assert len(out["losses"]) == 3
    assert all(np.isfinite(out["losses"]))
    assert CheckpointManager(str(tmp_path)).finished_steps() == [0]
    assert int(out["state"]["opt"].step) == 3


def test_launcher_refuses_restart_from_donated_state(tmp_path, monkeypatch):
    """With no checkpoint to go back to, the supervisor restarts from its
    initial state, which the launcher's donated step has overwritten: the
    launcher raises instead of training on from it."""
    from repro_torch.launch import train as launch

    class NoCheckpoint(CheckpointManager):
        def latest_step(self):
            return None

    monkeypatch.setattr(launch, "CheckpointManager", NoCheckpoint)
    monkeypatch.setattr(launch, "Supervisor", lambda cfg, ckpt: Supervisor(
        cfg, ckpt, failure_schedule={2: StepFailure("boom")}))
    with pytest.raises(RuntimeError, match="overwritten"):
        launch.train("internlm2-1.8b", steps=3, batch=2, seq=32,
                     ckpt_dir=str(tmp_path), log_every=100, device="cpu")


def test_supervisor_straggler_detection(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    cfg = SupervisorConfig(total_steps=30, ckpt_every=100,
                           straggler_factor=2.5, straggler_patience=2)
    times = {k: 0.01 for k in range(30)}
    for k in (20, 21, 22):
        times[k] = 0.2
    mitigated = []
    sup = Supervisor(cfg, mgr, step_time_hook=lambda s: times[s],
                     on_straggler=lambda s: mitigated.append(s))
    report = sup.run(_tree(0.0), lambda st, i: st)
    assert len(report.stragglers) >= 2
    assert report.mitigations >= 1 and mitigated


def _train_state(seed=0):
    """A params + AdamW state tree with bf16, fp32 and int32 leaves, as the
    JAX package's launcher checkpoints it."""
    rng = np.random.default_rng(seed)
    params = {"embed": {"table": jnp.asarray(rng.normal(size=(7, 4)),
                                             jnp.bfloat16)},
              "blocks": [{"ln1": {"g": jnp.asarray(rng.normal(size=(2, 4)),
                                                   jnp.bfloat16)},
                          "w": jnp.asarray(rng.normal(size=(2, 4, 3)),
                                           jnp.float32)}],
              "tail": []}
    opt = jadamw.AdamWState(step=jnp.asarray(3, jnp.int32),
                            m=jax.tree.map(lambda p: jnp.asarray(
                                rng.normal(size=p.shape), jnp.float32),
                                params),
                            v=jax.tree.map(lambda p: jnp.asarray(
                                rng.random(size=p.shape), jnp.float32),
                                params))
    return {"params": params, "opt": opt}


def _port_state(state):
    p = tree_from_jax(jax.tree.map(np.asarray, state["params"]), "cpu")
    o = state["opt"]
    return {"params": p, "opt": tadamw.AdamWState(
        step=torch.tensor(int(o.step), dtype=torch.int32),
        m=tree_from_jax(jax.tree.map(np.asarray, o.m), "cpu"),
        v=tree_from_jax(jax.tree.map(np.asarray, o.v), "cpu"))}


def _bits(x):
    if isinstance(x, torch.Tensor):
        return (x.view(torch.int16) if x.dtype == torch.bfloat16
                else x).numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def test_restores_a_checkpoint_the_jax_manager_wrote(tmp_path):
    state = _train_state()
    JaxManager(str(tmp_path)).save(5, state, blocking=True)
    like = _port_state(_train_state(seed=1))
    got = CheckpointManager(str(tmp_path)).restore(5, like)
    want = leaves(_port_state(state))
    assert len(leaves(got)) == len(want) == 10
    for a, b in zip(leaves(got), want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(_bits(a), _bits(b))
    assert got["params"]["embed"]["table"].dtype == torch.bfloat16
    assert int(got["opt"].step) == 3


def test_writes_what_the_jax_manager_writes(tmp_path):
    """The same tree through both managers: the same manifest (names,
    files, shapes, dtypes) and the same bytes in every leaf's file, bf16
    included; and the port's own bf16 round trip is bitwise."""
    state = _train_state()
    JaxManager(str(tmp_path / "jax")).save(1, state, blocking=True)
    port = _port_state(state)
    CheckpointManager(str(tmp_path / "port")).save(1, port, blocking=True)
    step = "step_000001"
    jm = json.loads((tmp_path / "jax" / step / "manifest.json").read_text())
    pm = json.loads((tmp_path / "port" / step / "manifest.json").read_text())
    assert pm == jm
    for leaf in jm["leaves"]:
        a = (tmp_path / "jax" / step / "data" / leaf["file"]).read_bytes()
        b = (tmp_path / "port" / step / "data" / leaf["file"]).read_bytes()
        assert a == b, leaf["name"]
    back = CheckpointManager(str(tmp_path / "port")).restore(1, port)
    for a, b in zip(leaves(back), leaves(port)):
        np.testing.assert_array_equal(_bits(a), _bits(b))


# ------------------------------------------------------------------ data

def _cfg(**kw):
    base = dict(vocab=1000, seq_len=64, global_batch=4, seed=7)
    base.update(kw)
    return kw, DataConfig(**base), JaxDataConfig(**base)


def test_pipeline_batches_equal_the_jax_packages():
    for kw in ({}, {"num_docs": 5}, {"num_hosts": 2, "host_index": 1},
               {"embed_dim": 8}):
        _, tc, jc = _cfg(**kw)
        tp, jp = Pipeline(tc), JaxPipeline(jc)
        for _ in range(3):
            a, b = next(tp), next(jp)
            assert sorted(a) == sorted(b)
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
                assert a[k].dtype == b[k].dtype


def test_determinism():
    _, c, _ = _cfg()
    a, b = next(Pipeline(c)), next(Pipeline(c))
    np.testing.assert_array_equal(a["x"], b["x"])
    np.testing.assert_array_equal(a["labels"], b["labels"])


def test_resume_exact():
    _, c, _ = _cfg()
    p = Pipeline(c)
    for _ in range(3):
        next(p)
    state = p.state()
    want = next(p)
    got = next(Pipeline.restore(c, state))
    np.testing.assert_array_equal(got["x"], want["x"])


def test_host_sharding_disjoint_and_complete():
    full = next(Pipeline(_cfg(num_hosts=1, host_index=0)[1]))
    parts = [next(Pipeline(_cfg(num_hosts=2, host_index=i)[1]))
             for i in range(2)]
    np.testing.assert_array_equal(
        np.concatenate([p["x"] for p in parts], axis=0), full["x"])


def test_label_shift_and_boundaries():
    p = Pipeline(_cfg()[1])
    saw_boundary = False
    for _ in range(6):
        b = next(p)
        x, y = b["x"], b["labels"]
        agree = (y[:, :-1] == x[:, 1:]) | (y[:, :-1] == IGNORE)
        assert agree.mean() > 0.99
        saw_boundary |= bool((y == IGNORE).sum() >= 1)
    assert saw_boundary


def test_embed_stub_mode():
    b = next(Pipeline(_cfg(embed_dim=32)[1]))
    assert b["x"].shape == (4, 64, 32)
    assert b["labels"].shape == (4, 64)


# -------------------------------------------------------------- compress

def test_quantize_roundtrip_error_bounded():
    x = torch.from_numpy(np.random.default_rng(0).normal(size=128)
                         .astype(np.float32))
    q, s = compress.quantize(x)
    assert q.dtype == torch.int8
    err = torch.max(torch.abs(compress.dequantize(q, s) - x))
    assert float(err) <= float(s) / 2 + 1e-6
    jq, js = jcompress.quantize(jnp.asarray(x.numpy()))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert abs(float(s) - float(js)) <= 1e-9


def test_compressed_psum_single_replica_exact_with_feedback():
    """No process group: the one-replica sum, as the JAX test's one-device
    shard_map gives it."""
    g = {"w": torch.from_numpy(np.random.default_rng(1).normal(
        size=(32, 8)).astype(np.float32))}
    e = compress.init_error(g)
    avg, e2 = compress.compressed_psum(g, e)
    resid = g["w"] - avg["w"]
    np.testing.assert_allclose(e2["w"].numpy(), resid.numpy(), atol=1e-6)
    avg2, _ = compress.compressed_psum(g, e2)
    scale = float(torch.max(torch.abs(g["w"]))) / 127.0
    two_step = (avg["w"] + avg2["w"]).numpy() / 2
    np.testing.assert_allclose(two_step, g["w"].numpy(), atol=2 * scale)
    # against the JAX package's quantization of the same leaf
    jq, js = jcompress.quantize(jnp.asarray(g["w"].numpy()))
    np.testing.assert_allclose(
        avg["w"].numpy(), np.asarray(jcompress.dequantize(jq, js)),
        atol=1e-6)


WORKER = """
import sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.optim import compress
rank, port = int(sys.argv[1]), sys.argv[2]
dist.init_process_group("gloo", init_method="tcp://localhost:" + port,
                        world_size=2, rank=rank)
rng = np.random.default_rng(10 + rank)
g = {"w": torch.from_numpy(rng.normal(size=(16, 4)).astype(np.float32))}
e = {"w": torch.from_numpy(rng.normal(size=(16, 4)).astype(np.float32)
                           * 1e-3)}
avg, e2 = compress.compressed_psum(g, e)
np.save(sys.argv[3], np.stack([avg["w"].numpy(), e2["w"].numpy()]))
dist.destroy_process_group()
"""


def test_compressed_psum_two_replicas_over_gloo(tmp_path):
    """Two processes over gloo: both get the same average, the int8 sum
    under the shared (max) scale, each keeping its own residual."""
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = str(s.getsockname()[1])
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    outs = [tmp_path / f"r{r}.npy" for r in range(2)]
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(r), port,
                               str(outs[r])], env=env)
             for r in range(2)]
    for p in procs:
        assert p.wait(timeout=120) == 0
    got = [np.load(o) for o in outs]
    gf = [np.random.default_rng(10 + r).normal(size=(16, 4))
          .astype(np.float32) for r in range(2)]
    rngs = [np.random.default_rng(10 + r) for r in range(2)]
    for r in range(2):
        rngs[r].normal(size=(16, 4))
    ef = [rngs[r].normal(size=(16, 4)).astype(np.float32) * 1e-3
          for r in range(2)]
    tot = [g + e for g, e in zip(gf, ef)]
    scale = max(np.abs(t).max() / 127.0 + 1e-12 for t in tot)
    qs = [np.clip(np.round(t / np.float32(scale)), -127, 127) for t in tot]
    want = (qs[0] + qs[1]) * np.float32(scale) / 2
    np.testing.assert_array_equal(got[0][0], got[1][0])
    np.testing.assert_allclose(got[0][0], want, atol=1e-6)
    for r in range(2):
        np.testing.assert_allclose(got[r][1], tot[r] - qs[r] * scale,
                                   atol=1e-6)
