"""``examples/fleet_torch.py``, the port's twin of ``examples/fleet.py``.
Its CP compiles alone take about two minutes, so this file checks the
twin's wiring on the CPU through its own functions: a two-SoC rack of two
classes placed, the twin's trace replayed with every round executed on CPU
tensors, nothing dropped, every engine on the device and in the mode that
``make_config`` passed.  ``chip_smoke.py`` phase h serves the twin's full
rack on the card, and ``tests/test_torch_fleet.py`` holds the fleet layer
to the JAX package."""

import pytest
import torch

from repro_torch.fleet import Fleet, FleetRouter, replay_open_loop
from test_torch_examples_quickstart import load_example

CLASSES = ("autoencoder", "ds_cnn")


@pytest.fixture(scope="module")
def twin():
    return load_example("fleet_torch")


def test_config_threads_execute_and_device(twin):
    cfg = twin.make_config()
    assert (cfg.n_socs, cfg.execute, cfg.device) == (4, False, "cuda")
    cfg = twin.make_config(n_socs=2, execute=True, device="cpu")
    assert (cfg.n_socs, cfg.execute, cfg.device) == (2, True, "cpu")


def test_placement_and_a_short_trace_on_the_cpu(twin):
    config = twin.make_config(n_socs=2, execute=True, device="cpu")
    graphs, cache, contention, placement = twin.place(config, CLASSES)
    assert sorted(n for names in placement.assignment for n in names) == \
        sorted(CLASSES)
    fleet = Fleet(config, graphs, cache=cache, contention=contention)
    fleet.apply_placement(placement)
    for name in CLASSES:
        for host in fleet.hosts_of(name):
            assert host.engine.execute and host.engine.device == "cpu"
    trace = twin.make_trace(contention, CLASSES, high="autoencoder",
                            horizon_s=0.3)
    assert {c for _, c, _, _ in trace} == set(CLASSES)
    assert all((d is not None) == (c == "autoencoder")
               for _, c, _, d in trace)
    summary = replay_open_loop(fleet,
                               FleetRouter(fleet,
                                           split=placement.demand_split),
                               trace)
    assert summary["served"] == len(trace)
    assert summary["router"]["dropped"] == 0


def test_fleet_twin_refuses_a_missing_card(twin):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        twin.main(["--execute"])
