"""The port's memory planner (``repro_torch.core.hbmplan``) against the
JAX package's: with the JAX package's per-chip capacity (16 GiB) named as
``capacity_bytes``, ``plan_memory`` gives the same ``MemoryPlan``, field
for field, for every registry config over a grid of (global batch,
sequence, data-parallel replicas, model shards); ``param_count`` is the
same number for every config; at an H100's 80 GB the families that
``chip_smoke.py`` phases i and j train are feasible and olmoe-1b-7b is not;
without a card and without a capacity the planner refuses."""

import dataclasses

import pytest
import torch

from repro.configs import registry as jregistry
from repro.core import hbmplan as jplan
from repro_torch.configs import registry
from repro_torch.core import hbmplan

TPU_CAPACITY = 16 * 1024 ** 3
H100_CAPACITY = 80 * 1024 ** 3
# (global_batch, seq, dp, model_par): one replica at phase i's batch, then
# data and model parallel points, past and at the 2048-token remat cut
GRID = [(4, 1024, 1, 1), (8, 512, 2, 1), (32, 2048, 8, 4),
        (64, 4096, 16, 8), (256, 8192, 32, 16), (16, 32768, 4, 8),
        (3, 2047, 1, 2), (1, 128, 1, 1)]
TRAINED = ("internlm2-1.8b", "rwkv6-3b", "recurrentgemma-2b",
           "granite-moe-3b-a800m")


@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_plan_memory_equals_the_jax_planner(arch):
    cfg, jcfg = registry.get_config(arch), jregistry.get_config(arch)
    for point in GRID:
        got = hbmplan.plan_memory(cfg, *point, capacity_bytes=TPU_CAPACITY)
        want = jplan.plan_memory(jcfg, *point)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), point


@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_param_count_equals_the_jax_count(arch):
    assert hbmplan.param_count(registry.get_config(arch)) == \
        jplan.param_count(jregistry.get_config(arch))


@pytest.mark.parametrize("arch", TRAINED + ("olmoe-1b-7b",))
def test_feasibility_at_the_cards_capacity(arch):
    plan = hbmplan.plan_memory(registry.get_config(arch), 4, 1024, 1, 1,
                               capacity_bytes=H100_CAPACITY)
    assert plan.feasible == (arch in TRAINED), plan.notes
    if arch == "olmoe-1b-7b":
        # its fp32 AdamW moments alone take 55 GB
        assert plan.est_bytes["adam_m+v(f32)"] > 55e9
        assert plan.notes[0].startswith("infeasible")


def test_capacity_is_a_seam_not_a_constant():
    assert not hasattr(hbmplan, "HBM_BYTES")
    cfg = registry.get_config("internlm2-1.8b")
    small = hbmplan.plan_memory(cfg, 4, 1024, 1, 1, capacity_bytes=1e9)
    assert not small.feasible and small.notes[0].endswith("> 0.8")


def test_no_card_and_no_capacity_refuses():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="capacity_bytes"):
        hbmplan.plan_memory(registry.get_config("internlm2-1.8b"), 4, 1024,
                            1, 1)
