"""AST-based concurrency lint for the serving layer.

The serving stack shares mutable state between the dispatch thread and
the background compiler worker (``PlanStore`` caches, ``BackgroundCompiler``
counters/retry state).  The locking discipline is simple — every field
*written* under a class's ``self._lock`` (or a ``threading.Condition``
built over it) belongs to that lock and must never be touched outside a
``with``-block holding it — but nothing enforced it, and unguarded reads
of guarded counters had already crept into ``BackgroundCompiler.stats``.

This lint infers the discipline from the code itself, per class:

1. *lock attributes*: ``self.X = threading.Lock() | RLock() |
   Condition(...)`` anywhere in the class;
2. *guarded fields*: every ``self.F`` assigned, aug-assigned, deleted,
   subscript-stored, or mutated via a mutating method call
   (``.append``/``.pop``/...) lexically inside a ``with self.<lock>:``
   block;
3. *violations*: any access (read or write) of a guarded field outside
   such a block.

Escapes, because a lint must not fight the code it protects:
``__init__`` is exempt (no concurrent access before construction
completes), and so is any method whose docstring contains the marker
phrase ``"caller holds the lock"`` (the documented private-helper
convention in ``core.deploy``).

Inference has a blind spot the worker-pool state exposed: a field the
pool mutates under the lock in only ONE method but *reads* everywhere
(or a field whose locked write lives behind a mutating call the lint
does not model) is silently unguarded.  A class can therefore *declare*
its guarded fields in its docstring::

    Lock-guarded: _queued, _recent, _hints

Declared fields join the inferred set and are enforced in every
non-exempt method — whether or not any locked write was seen.

Run as a CI lane::

    PYTHONPATH=src python -m repro_torch.analysis.lockcheck src/repro/serve

Exit code 1 on any violation.
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
import os
import sys
from typing import List, Optional, Set

LOCK_FACTORIES = {"Lock", "RLock", "Condition"}
MUTATING_CALLS = {"append", "appendleft", "add", "pop", "popleft",
                  "popitem", "discard", "remove", "clear", "update",
                  "extend", "insert", "setdefault", "sort", "reverse"}
EXEMPT_MARKER = "caller holds the lock"
DECLARED_MARKER = "lock-guarded:"


@dataclasses.dataclass(frozen=True)
class Violation:
    path: str
    line: int
    cls: str
    method: str
    field: str
    access: str                     # "read" | "write"

    def __str__(self) -> str:
        return (f"{self.path}:{self.line}: {self.cls}.{self.method} "
                f"{self.access}s lock-guarded field self.{self.field} "
                f"outside the owning lock")


def _self_attr(node: ast.AST) -> Optional[str]:
    """``self.F`` -> ``"F"``, else None."""
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


def _is_lock_ctor(node: ast.AST) -> bool:
    """``threading.Lock()`` / ``Condition(...)`` (module-qualified or
    bare-imported)."""
    if not isinstance(node, ast.Call):
        return False
    f = node.func
    if isinstance(f, ast.Attribute):
        return f.attr in LOCK_FACTORIES
    if isinstance(f, ast.Name):
        return f.id in LOCK_FACTORIES
    return False


def _lock_attrs(cls: ast.ClassDef) -> Set[str]:
    out: Set[str] = set()
    for node in ast.walk(cls):
        if isinstance(node, ast.Assign) and _is_lock_ctor(node.value):
            for tgt in node.targets:
                attr = _self_attr(tgt)
                if attr:
                    out.add(attr)
    return out


class _MethodScan(ast.NodeVisitor):
    """One pass over a method body tracking whether the lexical position
    is inside a ``with self.<lock>:`` block; records guarded-field writes
    and out-of-lock accesses."""

    def __init__(self, locks: Set[str]) -> None:
        self.locks = locks
        self.locked = False
        self.writes_locked: Set[str] = set()
        # (field, line, "read"|"write") seen outside any lock block
        self.unlocked_accesses: List[tuple] = []

    def _is_lock_with(self, item: ast.withitem) -> bool:
        attr = _self_attr(item.context_expr)
        return attr is not None and attr in self.locks

    def visit_With(self, node: ast.With) -> None:
        takes = any(self._is_lock_with(i) for i in node.items)
        for i in node.items:
            self.visit(i)
        prev, self.locked = self.locked, self.locked or takes
        for stmt in node.body:
            self.visit(stmt)
        self.locked = prev

    def _record(self, field: str, line: int, access: str) -> None:
        if field in self.locks:
            return
        if self.locked:
            if access == "write":
                self.writes_locked.add(field)
        else:
            self.unlocked_accesses.append((field, line, access))

    def visit_Attribute(self, node: ast.Attribute) -> None:
        field = _self_attr(node)
        if field is not None:
            access = ("write" if isinstance(node.ctx,
                                            (ast.Store, ast.Del))
                      else "read")
            self._record(field, node.lineno, access)
        self.generic_visit(node)

    def visit_Subscript(self, node: ast.Subscript) -> None:
        # self.F[k] = v  /  del self.F[k]: a write to F's contents
        field = _self_attr(node.value)
        if field is not None and isinstance(node.ctx,
                                            (ast.Store, ast.Del)):
            self._record(field, node.lineno, "write")
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        # self.F.append(x): a write to F's contents
        if isinstance(node.func, ast.Attribute):
            field = _self_attr(node.func.value)
            if field is not None and node.func.attr in MUTATING_CALLS:
                self._record(field, node.lineno, "write")
        self.generic_visit(node)


def _methods(cls: ast.ClassDef):
    for node in cls.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


def _declared_guards(cls: ast.ClassDef) -> Set[str]:
    """Fields the class docstring explicitly declares lock-guarded
    (``Lock-guarded: f1, f2, ...`` — one or more such lines)."""
    out: Set[str] = set()
    for line in (ast.get_docstring(cls) or "").splitlines():
        s = line.strip()
        if s.lower().startswith(DECLARED_MARKER):
            rest = s[len(DECLARED_MARKER):]
            out |= {f.strip().rstrip(".,;") for f in rest.split(",")
                    if f.strip()}
    return out


def check_class(cls: ast.ClassDef, path: str) -> List[Violation]:
    locks = _lock_attrs(cls)
    if not locks:
        return []
    scans = {}
    guarded: Set[str] = set(_declared_guards(cls))
    for m in _methods(cls):
        scan = _MethodScan(locks)
        for stmt in m.body:
            scan.visit(stmt)
        scans[m.name] = (m, scan)
        guarded |= scan.writes_locked
    violations: List[Violation] = []
    for name, (m, scan) in scans.items():
        if name == "__init__":
            continue
        doc = " ".join((ast.get_docstring(m) or "").split())
        if EXEMPT_MARKER in doc.lower():
            continue
        for field, line, access in scan.unlocked_accesses:
            if field in guarded:
                violations.append(Violation(path, line, cls.name,
                                            name, field, access))
    return violations


def check_source(src: str, path: str = "<string>") -> List[Violation]:
    tree = ast.parse(src, filename=path)
    out: List[Violation] = []
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef):
            out.extend(check_class(node, path))
    return sorted(out, key=lambda v: (v.path, v.line))


def check_file(path: str) -> List[Violation]:
    with open(path) as f:
        return check_source(f.read(), path)


def check_paths(paths) -> List[Violation]:
    out: List[Violation] = []
    for p in paths:
        if os.path.isdir(p):
            for root, _dirs, files in os.walk(p):
                for fn in sorted(files):
                    if fn.endswith(".py"):
                        out.extend(check_file(os.path.join(root, fn)))
        else:
            out.extend(check_file(p))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("paths", nargs="+",
                    help="files or directories to lint")
    args = ap.parse_args(argv)
    violations = check_paths(args.paths)
    for v in violations:
        print(v)
    if violations:
        print(f"lockcheck: {len(violations)} violation(s)")
        return 1
    print("lockcheck: ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
