"""``examples/multi_tenant_torch.py``, the port's twin of
``examples/multi_tenant.py``.  Run whole it takes over two minutes on the
CPU (its compiles are time-budgeted CP solves), so this file goes through
its own functions on its one mix (autoencoder + ds_cnn on a Carfield SoC)
with a smaller compile budget: the session's co-scheduled plan held to
each tenant alone by the twin's oracle assert, and held to the JAX
runtime on the same seeded values at 1e-4; the occupancy replay; the
mixed serving rounds executed on CPU tensors; the SLO demo.  The card runs
the twin whole (``chip_smoke.py`` phase k)."""

import pytest
import torch

from repro_torch.models import edge
from repro_torch.soc.carfield import carfield_patterns, carfield_soc
from test_torch_examples_quickstart import jax_vs_port_multi, load_example


@pytest.fixture(scope="module")
def twin():
    return load_example("multi_tenant_torch")


@pytest.fixture(scope="module")
def compiled(twin):
    soc, pats = carfield_soc(), carfield_patterns()
    graphs = [edge.autoencoder(), edge.ds_cnn()]
    session, mc = twin.co_compile(graphs, soc, pats, "cpu",
                                  time_budget_s=0.3)
    return soc, graphs, session, mc


def test_co_compiled_plan_matches_jax(compiled):
    *_, mc = compiled
    assert [g.name for g in mc.graphs] == ["autoencoder", "ds_cnn"]
    jax_vs_port_multi(mc.plan)


def test_occupancy_replay_compiles_each_subset_once(twin, compiled):
    soc, graphs, session, _ = compiled
    twin.replay_occupancies(session, graphs, soc)
    occupancies = [tuple(ev["occupancy"]) for ev in session.miss_events]
    assert len(occupancies) == len(set(occupancies))


def test_serving_rounds_execute_on_the_cpu(twin, compiled):
    *_, mc = compiled
    rep = twin.serve_mixed(mc, "cpu")
    assert rep["served"] == 7
    assert {t["model"]: t["served"] for t in rep["per_tenant"]} == {
        "autoencoder": 4, "ds_cnn": 3}
    assert rep["analysis"]["errors"] == 0


def test_slo_demo_serves_every_request(twin, compiled):
    soc, _, _, mc = compiled
    srep = twin.serve_slo(mc, soc, "cpu")
    assert srep["served"] == 7
    assert srep["starvation_events"] == 0
    assert srep["per_class"]["HIGH"]["slo_attainment"] is not None


def test_multi_tenant_twin_refuses_a_missing_card(twin):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        twin.main([])
