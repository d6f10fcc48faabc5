"""Trees of tensors: the nested dicts, lists and tuples that hold the
port's parameters and optimizer state (what ``jax.tree_util`` does for the
JAX package).  A leaf is anything that is not a dict, list or tuple."""
from __future__ import annotations

from typing import Any, Callable, Iterator


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching parts of
    ``rest``, which follow ``tree``'s structure down to its leaves and may
    hold a subtree where ``tree`` holds a leaf (``flatten_up_to``)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_map_with_path(fn: Callable, tree: Any, prefix: tuple = ()) -> Any:
    """``fn(path, leaf)`` over the leaves of ``tree``, the path as
    :func:`leaves_with_paths` gives it."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, prefix + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, prefix + (i,))
                          for i, v in enumerate(tree))
    return fn(prefix, tree)


def leaves(tree: Any) -> list:
    """The leaves of ``tree``, in :func:`tree_map`'s order."""
    return [leaf for _, leaf in leaves_with_paths(tree)]


def leaves_with_paths(tree: Any, prefix: tuple = ()) -> Iterator:
    """``(path, leaf)`` pairs in :func:`tree_map`'s order, the path a tuple
    of dict keys and sequence indices."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves_with_paths(v, prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves_with_paths(v, prefix + (i,))
    else:
        yield prefix, tree


def structure(tree: Any) -> str:
    """The tree's shape in JAX's ``PyTreeDef`` notation, ``*`` a leaf."""
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {structure(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, list):
        return "[" + ", ".join(structure(v) for v in tree) + "]"
    if isinstance(tree, tuple):
        inner = ", ".join(structure(v) for v in tree)
        return f"({inner}{',' if len(tree) == 1 else ''})"
    return "*"


def tree_stack(trees: list) -> Any:
    """Trees of one structure stacked leaf by leaf on a new leading axis
    (``jax.tree.map(lambda *xs: jnp.stack(xs), *trees)``)."""
    import torch
    return tree_map(lambda *xs: torch.stack(xs), trees[0], *trees[1:])


def tree_unstack(tree: Any) -> list:
    """The slices of a stacked tree along its leading axis, one tree a
    slice, from one ``unbind`` a leaf (whose backward stacks the slices'
    gradients in one write)."""
    parts = tree_map(lambda x: x.unbind(0), tree)
    n = len(leaves(tree)[0])

    def pick(i):
        def walk(node):
            if isinstance(node, dict):
                return {k: walk(v) for k, v in node.items()}
            if isinstance(node, list):
                return [walk(v) for v in node]
            return node[i]              # a leaf's tuple of slices
        return walk(parts)
    return [pick(i) for i in range(n)]
