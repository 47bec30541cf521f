"""The port's fleet (placement, routing, failure migration) against the
JAX package's, on the two-accelerator contention testbed of
``tests/test_fleet.py``.

Compiles are time-budgeted, so two compiles of one mix may ship different
plans.  The JAX and port fleets are therefore compared over ONE compiled
set of plans: the JAX fleet's plan cache compiles every mix, the port's
plan cache shares its table of compiled artifacts, and the JAX
parameters cross to the port through ``core/weights.py``.  Both fleets
then serve the same open-loop trace, with a SoC failing halfway; the
router ledgers must agree request by request and every result must agree
by request id at the runtime's 1e-4.  The port's own fleet (its own
compiles, on CPU tensors) is held to the reference's migration, drain and
failure checks: migration leaves the bits unchanged, and nothing is
dropped."""

import numpy as np
import pytest
import torch

from repro import fleet as jfleet
from repro.soc import testbed as jtestbed
import repro_torch.fleet as pfleet
from repro_torch.core.runtime import execute_plan, init_inputs
from repro_torch.core.weights import tree_from_jax
from repro_torch.fleet import (FailureEvent, Fleet, FleetConfig,
                               FleetRebalancer, FleetRouter, PlanCache,
                               Placement, place_contention_aware,
                               replay_open_loop)
from repro_torch.serve.admission import Priority
from repro_torch.soc.testbed import (FORCED_DMA_BW, FORCED_L2_KIB,
                                     dense_chain, two_acc_soc)

TOL = dict(atol=1e-4, rtol=1e-4)
CLASSES = ["a", "b", "c"]
# 4 tenants in 6 slots: the survivors keep room for the migration
TENANTS = ["a", "a", "b", "c"]


def _budgets(**kw):
    base = dict(n_socs=3, capacity=2, requested_tiles=4, time_budget_s=0.25,
                joint_time_budget_s=0.4, lazy_joint_time_budget_s=0.25,
                incremental_time_budget_s=0.25)
    base.update(kw)
    return base


def _config(**kw):
    return FleetConfig(
        soc_factory=lambda: two_acc_soc(FORCED_L2_KIB, FORCED_DMA_BW),
        **_budgets(**kw))


def _graphs(chain=dense_chain):
    # "a" is the heavy contention-prone class; "b"/"c" lighter
    return [chain("a", [64] * 5), chain("b", [48] * 4),
            chain("c", [32] * 4)]


def _trace():
    """tests/test_fleet.py's dense failure trace: 40 arrivals 0.1 ms
    apart, every fourth HIGH with a deadline."""
    return [(i * 1e-4, CLASSES[i % 3],
             Priority.HIGH if i % 4 == 0 else Priority.NORMAL,
             1.0 if i % 4 == 0 else None) for i in range(40)]


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _result(fleet, rr):
    """The outputs the ledger entry ``rr`` was served with."""
    eng = fleet.instances[rr.soc_id].engine_at(rr.epoch)
    return eng.results[rr.engine_rid]


# ---------------------------------------------------------------------------
# The JAX fleet and the port's, over one compiled set of plans
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def twin_fleets():
    graphs = _graphs(jtestbed.dense_chain)
    jcfg = jfleet.FleetConfig(
        soc_factory=lambda: jtestbed.two_acc_soc(jtestbed.FORCED_L2_KIB,
                                                 jtestbed.FORCED_DMA_BW),
        execute=True, **_budgets())
    jax_fleet = jfleet.Fleet(jcfg, graphs)
    jplace = jfleet.place_contention_aware(TENANTS, 3, 2,
                                           jax_fleet.contention,
                                           use_cp=False)

    cache = PlanCache(_config(execute=True, device="cpu"), graphs)
    cache._mcs = jax_fleet.cache._mcs       # one table of compiled mixes
    for name in CLASSES:
        cache._params[name] = tree_from_jax(jax_fleet.cache.params_for(name),
                                            "cpu")
    port_fleet = Fleet(cache.config, graphs, cache=cache)
    pplace = place_contention_aware(TENANTS, 3, 2, port_fleet.contention,
                                    use_cp=False)

    out = {"jplace": jplace, "pplace": pplace}
    for side, fleet, mod, placement in (
            ("jax", jax_fleet, jfleet, jplace),
            ("port", port_fleet, pfleet, pplace)):
        fleet.apply_placement(placement)
        victim = fleet.hosts_of("c")[0].soc_id
        router = mod.FleetRouter(fleet, split=placement.demand_split)
        reb = mod.FleetRebalancer(fleet, router)
        # Priority is an IntEnum on both sides: one trace serves both
        summary = mod.replay_open_loop(
            fleet, router, _trace(), rebalancer=reb,
            failures=[mod.FailureEvent(5e-4, victim, "fail")])
        out[side] = (fleet, router, summary)
    return out


def test_port_contention_and_placement_match_jax(twin_fleets):
    jax_fleet = twin_fleets["jax"][0]
    port_fleet = twin_fleets["port"][0]
    assert port_fleet.contention.edges() == jax_fleet.contention.edges()
    jp, pp = twin_fleets["jplace"], twin_fleets["pplace"]
    assert pp.assignment == jp.assignment
    assert pp.max_rho == jp.max_rho
    assert pp.demand_split == jp.demand_split


def test_port_fleet_routes_as_jax_does(twin_fleets):
    _, jrouter, jsum = twin_fleets["jax"]
    _, prouter, psum = twin_fleets["port"]
    want = {rid: (rr.class_name, rr.soc_id, rr.epoch, rr.engine_rid,
                  rr.requeues) for rid, rr in jrouter.requests.items()}
    got = {rid: (rr.class_name, rr.soc_id, rr.epoch, rr.engine_rid,
                 rr.requeues) for rid, rr in prouter.requests.items()}
    assert got == want
    assert psum["router"] == jsum["router"]
    for key in ("served", "rounds", "floor_rounds", "makespan_s",
                "slo_attainment", "per_class"):
        assert psum[key] == jsum[key], key
    assert psum["rebalance"]["failures"] == 1
    assert psum["rebalance"]["migrations"] >= 1
    assert [(r["class_name"], r["src_soc"], r["dst_soc"])
            for r in psum["rebalance"]["records"]] == \
        [(r["class_name"], r["src_soc"], r["dst_soc"])
         for r in jsum["rebalance"]["records"]]


def test_port_fleet_results_match_jax_by_request_id(twin_fleets):
    jax_fleet, jrouter, _ = twin_fleets["jax"]
    port_fleet, prouter, psum = twin_fleets["port"]
    audit = psum["router"]
    assert audit["dropped"] == 0 and audit["queued"] == 0
    assert audit["served"] == audit["submitted"] == len(_trace())
    for rid, rr in prouter.requests.items():
        got = _result(port_fleet, rr)
        want = _result(jax_fleet, jrouter.requests[rid])
        assert got.keys() == want.keys()
        for t in want:
            assert isinstance(got[t], torch.Tensor)
            assert got[t].device.type == "cpu"
            np.testing.assert_allclose(_np(got[t]), _np(want[t]), **TOL,
                                       err_msg=f"request {rid} {t}")


# ---------------------------------------------------------------------------
# The port's own fleet: migration, failure, drain
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def exec_fleet():
    """2 SoCs, numeric execution on CPU tensors, class 'a' alone on SoC0
    and 'b' alone on SoC1: failing SoC0 forces a real (a, b) migration
    compile."""
    fleet = Fleet(_config(n_socs=2, execute=True, precompile="singles",
                          device="cpu"), _graphs()[:2])
    fleet.apply_placement(Placement(assignment=[("a",), ("b",)],
                                    method="manual"))
    return fleet


def test_migration_preserves_numerics_bitwise(exec_fleet):
    fleet = exec_fleet
    router = FleetRouter(fleet)
    reb = FleetRebalancer(fleet, router)
    inputs = init_inputs(fleet.cache.classes["a"], seed=123, device="cpu")
    params = fleet.cache.params_for("a")

    src = fleet.instances[0]
    rid_before = src.engine.submit("a", inputs=dict(inputs))
    src.engine.run()
    out_before = src.engine.results[rid_before]

    recs = reb.fail(0, at_s=1.0)
    assert [r.class_name for r in recs] == ["a"]
    dst = fleet.instances[recs[0].dst_soc]
    assert dst.hosts("a") and dst.hosts("b")
    assert recs[0].analyzer_errors == 0
    assert dst.mc.session.analysis_stats()["errors"] == 0

    rid_after = dst.engine.submit("a", inputs=dict(inputs))
    dst.engine.run()
    out_after = dst.engine.results[rid_after]

    assert out_before.keys() == out_after.keys()
    for t in out_before:
        assert torch.equal(out_before[t], out_after[t]), t

    idx = dst.engine.resolve("a")
    plan = dst.mc.plan_for([idx])
    ref = dst.mc.session.reference_plan(idx, plan.tenants[0])
    want = execute_plan(ref, inputs, params)
    for t in want:
        assert torch.equal(out_after[t], want[t]), t


def test_mid_trace_failure_drops_nothing():
    fleet = Fleet(_config(execute=True, device="cpu"), _graphs())
    fleet.apply_placement(place_contention_aware(TENANTS, 3, 2,
                                                 fleet.contention))
    router = FleetRouter(fleet)
    reb = FleetRebalancer(fleet, router)
    victim = fleet.hosts_of("c")[0].soc_id
    failures = [FailureEvent(at_s=5e-4, soc_id=victim, kind="fail")]
    summary = replay_open_loop(fleet, router, _trace(), failures=failures,
                               rebalancer=reb)
    audit = summary["router"]
    assert audit["dropped"] == 0
    assert audit["queued"] == 0
    assert audit["served"] == audit["submitted"] - audit["rejected"]
    assert summary["served"] >= 40
    reb_stats = summary["rebalance"]
    assert reb_stats["failures"] == 1
    assert reb_stats["migrations"] >= 1
    assert reb_stats["analyzer_errors"] == 0
    assert len(reb_stats["recovery_s"]) == 1
    assert reb_stats["recovery_s"][0] >= 0.0
    assert fleet.instances[victim].failed
    assert not fleet.instances[victim].accepting
    for name in CLASSES:
        assert fleet.hosts_of(name), f"class {name} orphaned"
    # every served result lies on the CPU, as the config asked
    for eng in fleet.engines():
        for out in eng.results.values():
            assert all(t.device.type == "cpu" for t in out.values())


def test_drain_is_graceful():
    fleet = Fleet(_config(device="cpu"), _graphs())
    fleet.apply_placement(Placement(
        assignment=[("a",), ("b", "c"), ()], method="manual"))
    router = FleetRouter(fleet)
    reb = FleetRebalancer(fleet, router)
    for i in range(4):
        router.submit("a", arrival_s=i * 1e-4)
    recs = reb.drain(0, at_s=1e-3)
    assert fleet.instances[0].engine.pending == 0
    assert router.requeued == 0
    assert [r.class_name for r in recs] == ["a"]
    assert fleet.hosts_of("a")
    assert router.audit()["dropped"] == 0


# ---------------------------------------------------------------------------
# The device seam
# ---------------------------------------------------------------------------


def test_fleet_config_device_defaults_to_cuda():
    cfg = FleetConfig(soc_factory=lambda: two_acc_soc(64, 8.0), n_socs=1)
    assert cfg.device == "cuda"


def test_fleet_serves_on_its_config_device():
    """A fleet left at the default device makes its parameters on the
    card; where there is none it raises, never falling back to the
    CPU."""
    cache = PlanCache(FleetConfig(
        soc_factory=lambda: two_acc_soc(64, 8.0), n_socs=1),
        [dense_chain("a", [32, 32])])
    if torch.cuda.is_available():
        params = cache.params_for("a")
        assert all(t.device.type == "cuda" for t in params.values())
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            cache.params_for("a")
