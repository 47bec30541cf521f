"""Sharding hints: mesh-plan decisions threaded into model internals.

The JAX package's mesh partitioner records the intended layout of a few
interior tensors (the MoE dispatch buffers, decode cache updates) by
name, and model code requests them through :func:`constraint`.  The port
runs on one device and has no mesh yet, so :func:`constraint` is the
identity while no hint is set, and a hint that is set raises: placing a
tensor on a device mesh is ROADMAP Queue 1 item 12 (GSPMD specs become
``DeviceMesh``/DTensor placements).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

_ACTIVE: Dict[str, Any] = {}


def set_hints(hints: Optional[Dict[str, Any]]) -> None:
    _ACTIVE.clear()
    if hints:
        _ACTIVE.update(hints)


def get(name: str):
    return _ACTIVE.get(name)


def constraint(x, name: str):
    spec = _ACTIVE.get(name)
    if spec is None:
        return x
    raise NotImplementedError(
        f"sharding hint {name!r} = {spec!r}: the port has no device mesh "
        f"yet (ROADMAP Queue 1 item 12)")
