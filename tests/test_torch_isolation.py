"""The port stands alone: no module of ``src/repro_torch``, no twin of an
example (``examples/*_torch.py``) and not ``chip_smoke.py`` imports JAX
or the JAX package, the serving entry point
imports with both blocked, and the framework-free modules are copies of
the JAX package's: the same text, with only the package name changed,
except that a comment or docstring passage citing the project's change
history by its change number is reworded without the number."""

import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
PORT = SRC / "repro_torch"

# framework-free modules the port keeps as copies of the JAX package's
COPIES = [
    "core/__init__.py", "core/ir.py", "core/patterns.py", "core/zigzag.py",
    "core/tiling.py", "core/cpsolver.py", "core/rewrite.py",
    "core/schedule.py", "core/memplan.py", "core/shapes.py",
    "core/decompose.py", "core/deploy.py", "core/api.py", "core/heft.py",
    "core/codegen.py", "analysis/__init__.py", "analysis/diagnostics.py",
    "analysis/plan_analyzer.py", "soc/__init__.py", "soc/device.py",
    "soc/carfield.py", "soc/testbed.py", "models/__init__.py",
    "models/edge.py", "models/lm_graphs.py", "serve/admission.py",
    "serve/compiler_thread.py", "configs/__init__.py", "configs/shapes.py",
    "configs/gemma3_12b.py", "configs/granite_moe_3b_a800m.py",
    "configs/hubert_xlarge.py", "configs/internlm2_1_8b.py",
    "configs/llava_next_mistral_7b.py", "configs/olmoe_1b_7b.py",
    "configs/qwen3_32b.py", "configs/qwen3_8b.py",
    "configs/recurrentgemma_2b.py", "configs/rwkv6_3b.py",
    "analysis/lockcheck.py", "analysis/mutate.py", "analysis/scan_mixes.py",
    "fleet/__init__.py", "fleet/router.py", "fleet/rebalance.py",
    "data/pipeline.py", "fault/supervisor.py",
]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0], node.lineno


def _port_files():
    return (sorted(PORT.rglob("*.py"))
            + sorted((ROOT / "examples").glob("*_torch.py"))
            + [ROOT / "chip_smoke.py"])


def test_port_files_exist():
    files = _port_files()
    assert (ROOT / "chip_smoke.py").is_file()
    assert len(files) > len(COPIES)
    twins = {p.name for p in files if p.parent.name == "examples"}
    assert twins == {f"{name}_torch.py" for name in (
        "quickstart", "custom_soc", "multi_tenant", "serve_lm", "fleet",
        "train_lm")}


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import(path):
    bad = [(m, ln) for m, ln in _imported_roots(path) if m in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


BLOCKER = """
import sys
class Block:
    def find_spec(self, name, path=None, target=None):
        root = name.split('.')[0]
        if root in ('jax', 'jaxlib', 'repro'):
            raise ImportError('blocked: ' + name)
sys.meta_path.insert(0, Block())
import repro_torch.launch.serve
import repro_torch.core.runtime
import repro_torch.core.weights
import repro_torch.analysis, repro_torch.core.codegen, repro_torch.core.heft
import repro_torch.models.transformer, repro_torch.models.api
import repro_torch.models.rwkv6, repro_torch.models.rglru
import repro_torch.models.moe, repro_torch.core.hints
import repro_torch.kernels.flash_attention.flash_attention
import repro_torch.kernels.rwkv_scan.rwkv_scan
import repro_torch.kernels.rglru_scan.rglru_scan
import repro_torch.kernels.grouped_matmul.grouped_matmul
import repro_torch.configs.registry
import repro_torch.fleet, repro_torch.analysis.mutate
import repro_torch.analysis.lockcheck, repro_torch.analysis.scan_mixes
import repro_torch.launch.train, repro_torch.train.step
import repro_torch.optim.adamw, repro_torch.optim.compress
import repro_torch.checkpoint.manager, repro_torch.fault.supervisor
import repro_torch.data.pipeline, repro_torch.core.pytree
bad = sorted(m for m in sys.modules
             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))
assert not bad, bad
print('ok')
"""


def test_serve_imports_with_jax_and_repro_blocked():
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    proc = subprocess.run([sys.executable, "-c", BLOCKER], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


# a change-history citation: "PR" and a number, as the originals write it
HISTORY = re.compile(r"\bPR[- ]?\d")


def _tree(text: str) -> ast.Module:
    """The module's syntax tree with every docstring removed."""
    tree = ast.parse(text)
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body
                and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
    return tree


def _code(text: str) -> str:
    return ast.dump(_tree(text))


@pytest.mark.parametrize("rel", COPIES)
def test_copy_equals_original(rel):
    port = (PORT / rel).read_text().replace("repro_torch", "repro")
    orig = (SRC / "repro" / rel).read_text()
    port_lines, orig_lines = port.splitlines(), orig.splitlines()
    assert len(port_lines) == len(orig_lines)
    assert not any(HISTORY.search(line) for line in port_lines)
    # every run of differing lines rewords a passage that cites the
    # change history, and the code itself is the same
    diff = [a != b for a, b in zip(port_lines, orig_lines)]
    n = 0
    while n < len(diff):
        if not diff[n]:
            n += 1
            continue
        end = n
        while end < len(diff) and diff[end]:
            end += 1
        assert any(HISTORY.search(line) for line in orig_lines[n:end]), (
            f"{rel}:{n + 1}-{end} differs beyond the package name")
        n = end
    assert _code(port) == _code(orig)


# the port's fleet placement is the original but for its device seam: the
# config's device, the parameters made on it and the engines built on it
SEAM = ("FleetConfig", "PlanCache.params_for", "SoCInstance.host")
# the port's memory planner is the original but for its capacity seam:
# plan_memory takes the capacity (the card's by default), and the
# original's per-chip constant is gone
HBM_SEAM = ("plan_memory",)
HBM_GONE = ("HBM_BYTES",)


def _cut_seam(tree: ast.Module, seam=SEAM) -> dict:
    """Replace each class, function or method named in ``seam``, and each
    module-level assignment to a name in it, by ``pass``; returns the
    syntax of what was cut, by name."""
    cut = {}

    def visit(body, prefix):
        for n, node in enumerate(body):
            if isinstance(node, ast.Assign) and not prefix:
                names = [t.id for t in node.targets
                         if isinstance(t, ast.Name)]
                if len(names) == 1 and names[0] in seam:
                    cut[names[0]] = ast.dump(node)
                    body[n] = ast.Pass()
                continue
            if not isinstance(node, (ast.ClassDef, ast.FunctionDef)):
                continue
            name = prefix + node.name
            if name in seam:
                cut[name] = ast.dump(node)
                body[n] = ast.Pass()
            elif isinstance(node, ast.ClassDef):
                visit(node.body, name + ".")

    visit(tree.body, "")
    return cut


def test_placement_differs_from_original_only_in_the_device_seam():
    rel = "fleet/placement.py"
    port = _tree((PORT / rel).read_text().replace("repro_torch", "repro"))
    orig = _tree((SRC / "repro" / rel).read_text())
    port_cut, orig_cut = _cut_seam(port), _cut_seam(orig)
    assert sorted(port_cut) == sorted(orig_cut) == sorted(SEAM)
    assert ast.dump(port) == ast.dump(orig)
    for name in SEAM:
        assert port_cut[name] != orig_cut[name], name
        assert "'device'" in port_cut[name], name
        assert "'device'" not in orig_cut[name], name
    text = (PORT / rel).read_text()
    assert not any(HISTORY.search(line) for line in text.splitlines())


def test_hbmplan_differs_from_original_only_in_the_capacity_seam():
    """The port's ``core/hbmplan.py`` is the original (not listed in
    ``COPIES``) but for ``plan_memory``, which takes the capacity, and the
    original's per-chip constant, which the port drops: cut both, and the
    two syntax trees are the same, statement for statement."""
    rel = "core/hbmplan.py"
    assert rel not in COPIES
    port = _tree((PORT / rel).read_text().replace("repro_torch", "repro"))
    orig = _tree((SRC / "repro" / rel).read_text())
    port_cut = _cut_seam(port, HBM_SEAM + HBM_GONE)
    orig_cut = _cut_seam(orig, HBM_SEAM + HBM_GONE)
    assert sorted(orig_cut) == sorted(HBM_SEAM + HBM_GONE)
    assert sorted(port_cut) == sorted(HBM_SEAM)
    # where the original assigned the constant, the port has nothing: drop
    # the module-level stand-ins of what was cut on both sides
    for tree in (port, orig):
        tree.body = [n for n in tree.body if not isinstance(n, ast.Pass)]
    assert ast.dump(port) == ast.dump(orig)
    assert "'capacity_bytes'" in port_cut["plan_memory"]
    assert "'HBM_BYTES'" in orig_cut["plan_memory"]
    assert "'HBM_BYTES'" not in port_cut["plan_memory"]
    text = (PORT / rel).read_text()
    assert not any(HISTORY.search(line) for line in text.splitlines())
