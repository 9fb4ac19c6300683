"""Nested tuples and NamedTuples of tensors, flattened as ``jax.tree``
flattens them.

The JAX package keeps its state as pytrees of tuples and NamedTuples.
The port keeps the same structures, and these helpers walk them in
``jax.tree.flatten``'s order (fields in declaration order, depth
first), which is the order of the checkpoint's ``leaf_NNN`` keys.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, List


def _is_node(x: Any) -> bool:
    return isinstance(x, tuple)


def leaves(tree: Any) -> List[Any]:
    """The leaves of ``tree``, depth first, in field order."""
    return list(_iter_leaves(tree))


def _iter_leaves(tree: Any) -> Iterator[Any]:
    if _is_node(tree):
        for child in tree:
            yield from _iter_leaves(child)
    elif tree is not None:
        yield tree


def map_tree(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """``jax.tree.map``: ``fn`` applied leafwise over trees of one shape."""
    if _is_node(tree):
        kids = [map_tree(fn, *cs) for cs in zip(tree, *rest)]
        return type(tree)(*kids) if hasattr(tree, "_fields") else tuple(kids)
    return fn(tree, *rest)


def unflatten(template: Any, flat: List[Any]) -> Any:
    """Rebuild ``template``'s structure around the leaves ``flat``."""
    it = iter(flat)
    out = map_tree(lambda _: next(it), template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out
