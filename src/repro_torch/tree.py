"""Trees of dicts, lists and named tuples with tensor leaves (the port's
pytrees).

The reference keeps parameters, gradients and optimizer state as JAX
pytrees; the port keeps them as nested dicts and lists (one dict per
layer), and its ``TrainState`` is a named tuple.  ``None`` is an empty
subtree, as in JAX: it has no leaves and maps to ``None``.
"""

from __future__ import annotations

from typing import Any, Callable

__all__ = ["tree_map", "tree_leaves", "tree_paths"]


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure); lists and tuples map to lists,
    named tuples to their own type."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, v, *(r[i] for r in rest))
               for i, v in enumerate(tree)]
        return type(tree)(*out) if hasattr(tree, "_fields") else out
    return fn(tree, *rest)


def tree_paths(tree, prefix: str = "") -> list[tuple[str, Any]]:
    """``(path, leaf)`` pairs in order, path parts joined with ``/``
    (a named tuple's parts are its field names)."""
    if tree is None:
        return []
    if hasattr(tree, "_fields"):
        tree = tree._asdict()
    if isinstance(tree, dict):
        return [pl for k, v in tree.items()
                for pl in tree_paths(v, f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [pl for i, v in enumerate(tree)
                for pl in tree_paths(v, f"{prefix}{i}/")]
    return [(prefix[:-1], tree)]


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in tree_paths(tree)]
