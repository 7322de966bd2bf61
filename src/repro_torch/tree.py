"""Nested dict / list trees of tensors, the port's stand-in for ``jax.tree``:
the model's weights, their gradients and the optimizer's state share one
structure (dicts with JAX's names, ``blocks`` a list of per-layer dicts).
Dict keys are walked in sorted order, as ``jax.tree`` walks them."""
from __future__ import annotations

from typing import Any, Callable, Iterator, List


def _walk(tree: Any) -> Iterator[Any]:
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k])
    elif isinstance(tree, list):
        for t in tree:
            yield from _walk(t)
    else:
        yield tree


def leaves(tree: Any) -> List[Any]:
    """Every leaf, in the order ``map`` visits them."""
    return list(_walk(tree))


def map(fn: Callable, tree: Any, *rest: Any) -> Any:  # noqa: A001
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure); returns a tree of the results."""
    if isinstance(tree, dict):
        return {k: map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, list):
        return [map(fn, t, *(r[i] for r in rest))
                for i, t in enumerate(tree)]
    return fn(tree, *rest)


def unflatten(like: Any, values: List[Any]) -> Any:
    """A tree shaped like ``like`` whose leaves are ``values`` in
    ``leaves(like)`` order."""
    it = iter(values)
    return map(lambda _: next(it), like)
