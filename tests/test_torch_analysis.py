"""The port's copies of the mutation harness, the concurrency lint and the
benchmark-mix scan, against the JAX package's originals.

The mutation tests twin ``tests/test_plan_analysis.py``'s on a plan the
port's compiler builds (the three-tenant two-accelerator testbed); the
port's harness is also held to the original on ONE plan the JAX package
compiled (compiles are time-budgeted, so two compiles may differ): each
rule's mutation must give the same diagnostics on both sides.  The lint
tests twin the originals and run the lint over the port's serving layer,
its fleet and its deployment session, the port's side of the CI lane
``lockcheck src/repro/serve src/repro/fleet src/repro/core/deploy.py``."""

import io
import itertools
import pathlib

import pytest

from repro.analysis import analyze as jax_analyze
from repro.analysis.mutate import mutate as jax_mutate
from repro.core.api import compile_multi as jax_compile_multi
from repro.soc.testbed import dense_chain as jax_dense_chain
from repro.soc.testbed import two_acc_soc as jax_two_acc_soc
from repro_torch.analysis import Severity, analyze, analyze_errors
from repro_torch.analysis.lockcheck import check_paths, check_source
from repro_torch.analysis.mutate import (MUTATORS, check_rules, clone_plan,
                                         mutate)
from repro_torch.analysis.scan_mixes import mixes_from_baseline, scan
from repro_torch.core.api import compile_multi
from repro_torch.soc.testbed import dense_chain, two_acc_soc

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "src" / "repro_torch"
REQUESTED_TILES = 4
TIME_BUDGET_S = 0.5


def _testbed(compile_fn, soc_fn, chain_fn):
    soc, pats = soc_fn(64, 8.0)
    graphs = [chain_fn("a", [64, 64, 64]), chain_fn("b", [48, 48, 48]),
              chain_fn("c", [32, 32, 32])]
    return compile_fn(graphs, soc, pats, requested_tiles=REQUESTED_TILES,
                      time_budget_s=TIME_BUDGET_S)


@pytest.fixture(scope="module")
def mc():
    """The port's compile of the three-tenant testbed."""
    return _testbed(compile_multi, two_acc_soc, dense_chain)


@pytest.fixture(scope="module")
def jax_mc():
    """The JAX package's compile of the same testbed."""
    return _testbed(jax_compile_multi, jax_two_acc_soc, jax_dense_chain)


# ---------------------------------------------------------------------------
# Mutation harness
# ---------------------------------------------------------------------------


def test_port_plans_have_no_error_diagnostics(mc):
    plans = {"full": mc.plan}
    for r in (1, 2):
        for ids in itertools.combinations(range(3), r):
            plans[str(ids)] = mc.plan_for(list(ids))
    for i, cm in enumerate(mc.singles):
        plans[f"single{i}"] = cm.plan
    for label, plan in plans.items():
        assert analyze_errors(plan) == [], label


@pytest.mark.parametrize("rule", sorted(MUTATORS))
def test_rule_catches_its_mutation(mc, rule):
    mutated = mutate(mc.plan, rule)
    diags = analyze(mutated)
    assert any(d.rule == rule and d.severity >= Severity.ERROR
               for d in diags), (rule, [str(d) for d in diags])
    assert analyze_errors(mc.plan) == []


def test_check_rules_all_fire_on_multi(mc):
    fired = check_rules(mc.plan)
    assert set(fired) == set(MUTATORS)
    assert all(fired.values()), fired


def test_check_rules_all_fire_on_single(mc):
    fired = check_rules(mc.singles[0].plan)
    assert set(fired) == set(MUTATORS) - {"PA006"}
    assert all(fired.values()), fired


def test_clone_plan_is_deep_enough(mc):
    clone = clone_plan(mc.plan)
    first = mc.plan.order[0]
    clone.nodes[first].start += 1.0
    clone.memory.allocations[0].addr += 64
    assert mc.plan.nodes[first].start != clone.nodes[first].start
    assert mc.plan.memory.allocations[0].addr != \
        clone.memory.allocations[0].addr


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("rule", sorted(MUTATORS))
def test_mutation_matches_original_on_one_plan(jax_mc, rule, seed):
    """The copy and the original mutate the same plan the same way and
    analyze it to the same diagnostics."""
    for plan in (jax_mc.plan, jax_mc.singles[1].plan):
        if rule == "PA006" and not hasattr(plan, "budgets"):
            continue
        want = [str(d) for d in jax_analyze(jax_mutate(plan, rule, seed))]
        got = [str(d) for d in analyze(mutate(plan, rule, seed))]
        assert got == want, rule
        assert any(rule in d for d in got), rule


# ---------------------------------------------------------------------------
# Concurrency lint
# ---------------------------------------------------------------------------


def test_lockcheck_clean_on_port_serving_fleet_and_session():
    """The port's side of the CI lint lane: its serving layer (whose
    engine differs from the original by the device keyword), its fleet
    (whose placement differs by the device seam) and its deployment
    session."""
    paths = [PORT / "serve", PORT / "fleet", PORT / "core" / "deploy.py"]
    assert all(p.exists() for p in paths)
    assert check_paths([str(p) for p in paths]) == []


def test_lockcheck_flags_unlocked_write():
    src = (
        "import threading\n"
        "class Store:\n"
        "    def __init__(self):\n"
        "        self._lock = threading.Lock()\n"
        "        self.items = {}\n"
        "    def put(self, k, v):\n"
        "        with self._lock:\n"
        "            self.items[k] = v\n"
        "    def drop(self, k):\n"
        "        del self.items[k]\n"
    )
    vs = check_source(src, "snippet.py")
    assert any(v.method == "drop" and v.field == "items" for v in vs)


def test_lockcheck_honors_caller_holds_the_lock_marker():
    src = (
        "import threading\n"
        "class Store:\n"
        "    def __init__(self):\n"
        "        self._lock = threading.Lock()\n"
        "        self.items = {}\n"
        "    def put(self, k, v):\n"
        "        with self._lock:\n"
        "            self._put(k, v)\n"
        "    def _put(self, k, v):\n"
        "        \"\"\"Caller holds the lock.\"\"\"\n"
        "        self.items[k] = v\n"
    )
    assert check_source(src, "snippet.py") == []


def test_lockcheck_enforces_docstring_declared_guards():
    src = (
        "import threading\n"
        "class Pool:\n"
        "    \"\"\"Worker pool.\n"
        "\n"
        "    Lock-guarded: _recent, _hints\n"
        "    \"\"\"\n"
        "    def __init__(self):\n"
        "        self._lock = threading.Lock()\n"
        "        self._recent = {}\n"
        "        self._hints = {}\n"
        "    def peek(self):\n"
        "        return len(self._recent)\n"
        "    def ok(self):\n"
        "        with self._lock:\n"
        "            return len(self._hints)\n"
    )
    vs = check_source(src, "snippet.py")
    assert [(v.method, v.field, v.access) for v in vs] == \
        [("peek", "_recent", "read")]
    undeclared = src.replace("    Lock-guarded: _recent, _hints\n", "")
    assert check_source(undeclared, "snippet.py") == []


def test_lockcheck_declared_guards_on_port_background_compiler():
    path = PORT / "serve" / "compiler_thread.py"
    src = path.read_text()
    assert "Lock-guarded: _queued" in src
    assert check_source(src, str(path)) == []
    broken = src.replace("        with self._lock:\n"
                         "            self._recent.pop(key, None)",
                         "        if True:\n"
                         "            self._recent.pop(key, None)")
    assert broken != src
    vs = check_source(broken, str(path))
    assert any(v.field == "_recent" and v.access == "write" for v in vs)


def test_lockcheck_flags_an_unlocked_read_in_the_port_fleet():
    """The lint has teeth on the fleet copy: the plan cache's hit counter
    read outside its lock is caught."""
    path = PORT / "fleet" / "placement.py"
    src = path.read_text()
    broken = src.replace("        with self._lock:\n"
                         "            return {\"hits\": self._hits,",
                         "        if True:\n"
                         "            return {\"hits\": self._hits,")
    assert broken != src
    vs = check_source(broken, str(path))
    assert any(v.field == "_hits" and v.access == "read" for v in vs)


# ---------------------------------------------------------------------------
# Benchmark-mix scan
# ---------------------------------------------------------------------------


def test_scan_mixes_finds_the_baseline_mixes_and_a_clean_mix():
    """The copy reads the baseline's mixes, and its scan of the smallest
    (every plan the session emits for it, compiled by the port's
    compiler) finds no ERROR diagnostic."""
    baseline = str(REPO / "benchmarks" / "baseline.json")
    mixes = mixes_from_baseline(baseline)
    assert ("autoencoder", "ds_cnn") in mixes
    out = io.StringIO()
    assert scan([("autoencoder", "ds_cnn")], TIME_BUDGET_S, out=out) == 0
    text = out.getvalue()
    for label in ("full-house", "occupancy [0]", "occupancy [1]",
                  "single autoencoder", "single ds_cnn"):
        assert label in text, text
