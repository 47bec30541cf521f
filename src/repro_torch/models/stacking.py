"""Per-slot stacked layer params, walked by Python loops.

The JAX package stacks the per-layer params of each repeating slot on a
leading ``G`` axis so that ``lax.scan`` lowers one loop body; the port
keeps that layout, so a JAX params tree carries over leaf by leaf, and
walks it eagerly.  Layers repeat with period ``unit`` (1 for uniform
stacks, 6 for gemma3's 5-local:1-global); layer ``i = g*unit + u`` lands
in slot ``u`` at position ``g``.  A non-divisible remainder stays as
unstacked ``tail`` layers applied after the stacked ones.

Param layout:  ``{"blocks": [slot_0_stacked, ...], "tail": [layer, ...]}``
— slot trees have leading dim G on every leaf.
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.pytree import tree_map


def init_stacked(make_layer: Callable[[int], Any], n_layers: int, unit: int
                 ) -> Tuple[List[Any], List[Any]]:
    """Regroup the layers ``make_layer(0..n_layers-1)`` into (slots, tail):
    slot ``u`` stacks layers ``g*unit + u`` on a leading G axis, and the
    remainder stays as a list.  The layers are made in order, each copied
    into its slot as it is made, so the peak memory is the stack plus one
    layer."""
    G = n_layers // unit
    slots: List[Any] = [None] * unit
    for i in range(G * unit):
        g, u = divmod(i, unit)
        layer = make_layer(i)
        if slots[u] is None:
            slots[u] = tree_map(lambda x: x.new_empty((G,) + x.shape), layer)
        tree_map(lambda s, x: s[g].copy_(x), slots[u], layer)
    tail = [make_layer(i) for i in range(G * unit, n_layers)]
    return [s for s in slots if s is not None], tail


def unstack_all(slot: Any, G: int) -> List[Any]:
    """The G layers of a stacked slot, as views of its leaves, by one
    ``unbind`` a leaf: under autograd the G layers' gradients reach the
    stacked leaf by one stack, where indexing ``x[g]`` would build a
    zero-filled gradient of the whole stack for every layer."""
    parts = []
    tree_map(lambda x: parts.append(x.unbind(0)), slot)

    def layer(g):
        it = iter(parts)          # tree_map's leaf order, as above
        return tree_map(lambda x: next(it)[g], slot)

    return [layer(g) for g in range(G)]


def scan_blocks(h: torch.Tensor, slots: List[Any], tail: List[Any],
                body: Callable[[torch.Tensor, Any, int, int], torch.Tensor],
                unit: int, n_layers: int, remat: bool = False
                ) -> torch.Tensor:
    """h -> h through all layers; ``body(h, blk, u, g)`` applies one layer
    (``g`` is -1 for stacked layers, as inside the JAX scan, and the layer
    index for tail layers).  ``remat``: each repeating unit of stacked
    layers runs under ``torch.utils.checkpoint`` (as the JAX package wraps
    its scan body in ``jax.checkpoint``): backward keeps only the unit's
    input and runs its forward again; tail layers are not checkpointed,
    as in the JAX package.  Gradients reach the stacked leaves through
    :func:`unstack_all`'s views of them."""
    G = n_layers // unit

    def unit_body(h, slices):
        for u in range(unit):
            h = body(h, slices[u], u, -1)
        return h

    layers = [unstack_all(s, G) for s in slots]
    for g in range(G):
        slices = [layers_u[g] for layers_u in layers]
        if remat:
            h = checkpoint(unit_body, h, slices, use_reentrant=False)
        else:
            h = unit_body(h, slices)
    for j, blk in enumerate(tail):
        h = body(h, blk, j % unit, G * unit + j)
    return h


def scan_blocks_collect(h: torch.Tensor, slots: List[Any], tail: List[Any],
                        body: Callable, unit: int, n_layers: int
                        ) -> Tuple[torch.Tensor, List[Any], List[Any]]:
    """Like scan_blocks but the body also *emits* a per-layer tree (the KV
    cache built during prefill): body(h, blk, u) -> (h, emitted).
    Returns (h, [stacked emissions per slot], [tail emissions])."""
    G = n_layers // unit
    layers = [unstack_all(s, G) for s in slots]
    per_g = []
    for g in range(G):
        outs = []
        for u in range(unit):
            h, e = body(h, layers[u][g], u)
            outs.append(e)
        per_g.append(outs)
    emitted_slots = [tree_map(lambda *xs: torch.stack(xs),
                              *[per_g[g][u] for g in range(G)])
                     for u in range(unit)] if G > 0 else []
    emitted_tail = []
    for j, blk in enumerate(tail):
        h, e = body(h, blk, j % unit)
        emitted_tail.append(e)
    return h, emitted_slots, emitted_tail


def scan_blocks_cached(h: torch.Tensor, slots: List[Any], tail: List[Any],
                       cache_slots: List[Any], cache_tail: List[Any],
                       body: Callable, unit: int, n_layers: int
                       ) -> Tuple[torch.Tensor, List[Any], List[Any]]:
    """Decode-step traversal: body(h, blk, cache_entry, u) -> h.  Each
    cache entry is a view into the stacked caches, and the body updates it
    IN PLACE, so the stacked caches come back as the updated caches."""
    G = n_layers // unit
    layers = [unstack_all(s, G) for s in slots]
    entries = [unstack_all(c, G) for c in cache_slots]
    for g in range(G):
        for u in range(unit):
            h = body(h, layers[u][g], entries[u][g], u)
    for j, (blk, ce) in enumerate(zip(tail, cache_tail)):
        h = body(h, blk, ce, j % unit)
    return h, cache_slots, cache_tail
