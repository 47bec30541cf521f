"""The port's dry run (``launch/dryrun.py``) against the JAX package's
planners.

Four cells, each ``python -m repro_torch.launch.dryrun`` in a subprocess
of its own (all at once) on the 16 x 16 mesh over a ``fake`` process
group of 256 ranks, at 16 GiB a device (``--capacity-gib``): rwkv6-3b x
long_500k (the one cell the JAX reference passes end to end) gives ``0
FAIL``, hubert-xlarge x decode_32k gives ``SKIP``, internlm2-1.8b x
decode_32k is ``ok`` in the port (the JAX reference fails there, ROADMAP
Queue 3; not held to JAX), and internlm2-1.8b x train_4k gives the memory
plan.  Each record's strategy is JAX's ``plan_model``'s and a train
cell's ``hbm_plan`` JAX's ``plan_memory``'s at 16 GiB, computed here with
no lowering; its per-device parameter bytes are the sum over JAX's
``param_specs`` leaves of nbytes over the shard count of JAX's spec.
Then the tally itself: one column-sharded product's FLOPs are the global
count over the shards, and one all-gather's result bytes are counted.
"""

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.configs.shapes import SHAPES
from repro.core import meshplan as jmp
from repro.core.hbmplan import plan_memory as jax_plan_memory

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 300
GIB = 16
CELLS = [("rwkv6-3b", "long_500k"), ("hubert-xlarge", "decode_32k"),
         ("internlm2-1.8b", "decode_32k"), ("internlm2-1.8b", "train_4k")]
LIVE = [c for c in CELLS if c[0] != "hubert-xlarge"]


class _JaxMesh:
    axis_names = ("data", "model")

    class devices:
        shape = (16, 16)
        size = 256


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(arch, shape) -> (exit code, output, the cell's record)."""
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    procs = {}
    for arch, shape in CELLS:
        out = tmp_path_factory.mktemp(f"{arch}_{shape}")
        procs[arch, shape] = (out, subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--mesh", "single", "--capacity-gib",
             str(GIB), "--out", str(out)], env=env, cwd=str(ROOT),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    done = {}
    try:
        for key, (out, proc) in procs.items():
            log, _ = proc.communicate(timeout=TIMEOUT)
            rec = json.loads((out / "dryrun.json").read_text())[0]
            done[key] = (proc.returncode, log, rec)
    finally:
        for _, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return done


def _summary(log):
    return [line for line in log.splitlines()
            if line.startswith("dry-run:")][-1]


def test_rwkv6_long_500k_has_no_fail(runs):
    rc, log, rec = runs["rwkv6-3b", "long_500k"]
    assert rc == 0, log[-3000:]
    assert _summary(log).startswith("dry-run: 1 ok, 0 skip, 0 FAIL")
    assert rec["status"] == "ok" and rec["mesh"] == "16x16"
    assert rec["cost_correction"] == "none"
    assert rec["flops"] == rec["flops_raw"] > 0
    mem = rec["memory"]
    assert mem["peak_bytes"] == mem["argument_bytes"] + mem["temp_bytes"]


def test_hubert_decode_skips(runs):
    rc, log, rec = runs["hubert-xlarge", "decode_32k"]
    assert rc == 0
    assert rec["status"] == "skip" and "encoder-only" in rec["reason"]
    assert "hubert-xlarge x decode_32k: SKIP" in log
    assert _summary(log).startswith("dry-run: 0 ok, 1 skip, 0 FAIL")


def test_internlm2_decode_32k_is_ok_in_the_port(runs):
    """The JAX reference fails this cell (ROADMAP Queue 3); the port's
    trace of it passes, with the decode hints' collectives."""
    rc, log, rec = runs["internlm2-1.8b", "decode_32k"]
    assert rc == 0 and rec["status"] == "ok", log[-3000:]
    assert rec["collectives"] and rec["memory"]["temp_bytes"] > 0


@pytest.mark.parametrize("cell", LIVE, ids=lambda c: f"{c[0]}-{c[1]}")
def test_strategy_and_memory_plan_are_jax(runs, cell):
    """The record's strategy is JAX's ``plan_model``'s; a train cell's
    ``hbm_plan`` is JAX's ``plan_memory``'s at 16 GiB a device."""
    _, log, rec = runs[cell]
    assert rec["status"] == "ok", log[-3000:]
    cfg, shape = jreg.get_config(cell[0]), SHAPES[cell[1]]
    plan = jmp.plan_model(cfg, _JaxMesh(), shape.kind, shape.global_batch,
                          shape.seq_len)
    assert rec["strategy"] == plan.strategy
    if shape.kind == "train":
        mem = jax_plan_memory(cfg, shape.global_batch, shape.seq_len, 16, 16)
        assert rec["hbm_plan"] == {"remat": mem.remat, "zero1": mem.zero1,
                                   "est_gib": round(mem.total / 2 ** 30, 2)}
        assert rec["microbatches"] == mem.microbatches
    else:
        assert "hbm_plan" not in rec


@pytest.mark.parametrize("cell", LIVE, ids=lambda c: f"{c[0]}-{c[1]}")
def test_param_bytes_are_jax_shards(runs, cell):
    """Per device: the sum over JAX's param specs of each leaf's bytes
    over the shard count its JAX spec gives."""
    rec = runs[cell][2]
    cfg, shape = jreg.get_config(cell[0]), SHAPES[cell[1]]
    plan = jmp.plan_model(cfg, _JaxMesh(), shape.kind, shape.global_batch,
                          shape.seq_len)
    sizes = dict(zip(_JaxMesh.axis_names, _JaxMesh.devices.shape))
    want = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            jreg.param_specs(cfg))[0]:
        spec = plan.spec_for(jmp._path_str(path), len(leaf.shape))
        names = [n for e in spec if e is not None
                 for n in (e if isinstance(e, tuple) else (e,))]
        shards = math.prod(sizes[n] for n in names)
        want += math.prod(leaf.shape) * np.dtype(leaf.dtype).itemsize \
            // shards
    assert rec["param_bytes"] == want


@pytest.fixture
def pod():
    """A 16 x 16 mesh over a fake group of 256 ranks, torn down after."""
    import torch.distributed as dist
    from repro_torch.launch.dryrun import init_fake_group
    from repro_torch.launch.mesh import make_production_mesh
    init_fake_group(256)
    yield make_production_mesh(device="cpu")
    dist.destroy_process_group()


def test_tally_counts_per_device_flops_and_collectives(pod):
    """A (4096 x 4096) @ (4096 x 14336) product, rows over "data" and
    columns over "model": the tally sees rank 0's product, 1/256 of the
    global FLOPs; gathering the columns counts one all-gather of the
    result's bytes on that rank."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import (Replicate, Shard,
                                          distribute_tensor)
    from repro_torch.launch.dryrun import Tally
    M, K, N = 4096, 4096, 14336
    with FakeTensorMode():
        a = distribute_tensor(torch.empty(M, K), pod, [Shard(0), Replicate()])
        b = distribute_tensor(torch.empty(K, N), pod, [Replicate(), Shard(1)])
        with Tally() as t:
            c = a @ b
        assert t.flops == 2.0 * M * K * N / 256
        assert t.collectives == {}
        with Tally() as t:
            c.redistribute(pod, [Shard(0), Replicate()])
    assert t.flops == 0.0
    # each rank gathers its rows' 16 column blocks: (M/16) x N fp32
    assert t.collectives == {"all-gather": M // 16 * N * 4.0}
