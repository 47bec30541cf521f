"""The port stands alone: no module of ``src/repro_torch`` and not
``chip_smoke.py`` imports JAX or the JAX package, the serving entry point
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
    "serve/compiler_thread.py",
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
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_port_files_exist():
    files = _port_files()
    assert (ROOT / "chip_smoke.py").is_file()
    assert len(files) > len(COPIES)


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


def _code(text: str) -> str:
    """The module's syntax tree with every docstring removed."""
    tree = ast.parse(text)
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body
                and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
    return ast.dump(tree)


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
