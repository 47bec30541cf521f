"""Pytrees of tensors: nested dicts, lists, tuples and NamedTuples.

The JAX package walks its parameter and optimizer trees with
``jax.tree``; the port walks the same structures here, leaves in JAX's
order (dict keys sorted, sequences and NamedTuple fields in order), so a
flat list of leaves lines up with ``jax.tree.leaves`` of the same tree
and a checkpoint's leaves keep the JAX manager's order and names."""

from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple


class LeafTuple(tuple):
    """A tuple that the functions here take as one leaf, not as a
    sequence (a sharding spec in a tree of specs)."""


def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _is_seq(x: Any) -> bool:
    return isinstance(x, (list, tuple)) and not isinstance(x, LeafTuple)


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` (and of same-shaped ``rest``),
    keeping the structure; ``None`` is a leaf."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, *xs) for xs in zip(tree, *rest)))
    if _is_seq(tree):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def tree_map_with_path(fn: Callable, tree: Any,
                       path: Tuple[str, ...] = ()) -> Any:
    """``fn(path, leaf)`` over ``tree``'s leaves, keeping the structure;
    paths as :func:`leaves_with_path` spells them."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map_with_path(fn, v, path + (f".{n}",))
                            for n, v in zip(tree._fields, tree)))
    if _is_seq(tree):
        return type(tree)(tree_map_with_path(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def leaves_with_path(tree: Any, path: Tuple[str, ...] = ()
                     ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    """(path, leaf) in JAX's flattening order.  A path holds a dict's key,
    a sequence's index and a NamedTuple's ``.field``, as the JAX
    checkpoint manager spells them."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves_with_path(tree[k], path + (str(k),))
    elif _is_namedtuple(tree):
        for name, v in zip(tree._fields, tree):
            yield from leaves_with_path(v, path + (f".{name}",))
    elif _is_seq(tree):
        for i, v in enumerate(tree):
            yield from leaves_with_path(v, path + (str(i),))
    else:
        yield path, tree


def leaves(tree: Any) -> List[Any]:
    return [leaf for _, leaf in leaves_with_path(tree)]


def unflatten(like: Any, flat: List[Any]) -> Any:
    """``like``'s structure with its leaves, in :func:`leaves` order,
    replaced by ``flat``."""
    it = iter(flat)
    end = object()

    def take():
        leaf = next(it, end)
        if leaf is end:
            raise ValueError("fewer leaves than the structure holds")
        return leaf

    def build(t):
        if isinstance(t, dict):
            got = {k: build(t[k]) for k in sorted(t)}
            return {k: got[k] for k in t}
        if _is_namedtuple(t):
            return type(t)(*(build(v) for v in t))
        if _is_seq(t):
            return type(t)(build(v) for v in t)
        return take()

    out = build(like)
    if next(it, end) is not end:
        raise ValueError("more leaves than the structure holds")
    return out
