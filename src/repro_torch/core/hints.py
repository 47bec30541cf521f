"""Sharding hints: mesh-plan decisions threaded into model internals.

DTensor propagates layouts op by op from the tensors it is given, but
some interior tensors (the MoE dispatch buffers, decode caches and
logits, the FFN hidden) reshape or transpose enough that propagation
picks a poor layout (gathering an expert-parallel dispatch buffer, or a
sequence-sharded KV cache every decode step).  The mesh partitioner
records the intended :class:`~repro_torch.core.meshplan.Spec` for those
tensors in ``plan.hints``; model code requests them by name through
:func:`constraint`.  :func:`set_hints` takes the plan's hints with the
mesh they are laid out on; while a hint is set, :func:`constraint`
redistributes a DTensor to it and holds its gradient to the same layout
(as JAX's ``with_sharding_constraint`` constrains the cotangent), and it
is the identity for every name while none is (one device, no plan).  A
hint set for a plain tensor raises: a layout can only be given to a
tensor that lives on the mesh.

This is the MaxText "logical axis rules" pattern, and on the MATCHA side
the moral equivalent of §3.2's device-specific scheduling refinement:
the global CP decision gets enforced at the tensor level.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

_ACTIVE: Dict[str, Any] = {}
_MESH: list = [None]


def set_hints(hints: Optional[Dict[str, Any]], mesh=None) -> None:
    """Make ``hints`` (name -> Spec, as ``ShardingPlan.hints``) the active
    ones, laid out on ``mesh`` (None: the mesh of the DTensor each is
    applied to); None clears them."""
    _ACTIVE.clear()
    if hints:
        _ACTIVE.update(hints)
    _MESH[0] = mesh if hints else None


def get(name: str):
    return _ACTIVE.get(name)


def constraint(x, name: str):
    spec = _ACTIVE.get(name)
    if spec is None:
        return x
    from torch.distributed.tensor import DTensor
    from repro_torch.core.meshplan import placements
    from repro_torch.core.on_mesh import grad_as_forward
    if not isinstance(x, DTensor):
        raise TypeError(f"sharding hint {name!r} = {spec!r} is set, and the "
                        f"tensor it names is not a DTensor on the plan's "
                        f"mesh")
    on = x.device_mesh if _MESH[0] is None else _MESH[0]
    if x.device_mesh != on:
        raise ValueError(f"sharding hint {name!r}: the tensor lives on "
                         f"{x.device_mesh}, the plan on {on}")
    want = placements(spec, on)
    if tuple(x.placements) != want:
        x = x.redistribute(on, want)
    # as JAX's with_sharding_constraint constrains the cotangent too
    return grad_as_forward(x)
