"""Pytree helpers for the port's nested param / state trees.

A tree is nested dicts, lists, tuples and NamedTuples with tensor (or
numpy, or scalar) leaves; ``None`` is an empty subtree.  Dicts flatten in
sorted key order and a leaf's name joins its path with ``/`` - a dict key,
a sequence index, or ``.field`` for a NamedTuple field - which is the order
and the naming of JAX's ``tree_flatten_with_path`` as the reference's
checkpoints use them (``repro/checkpoint/io.py`` ``_path_str``).
"""
from __future__ import annotations

from typing import Any, Callable


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _children(node):
    """(path element, child) pairs of an inner node; None for a leaf."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if _is_namedtuple(node):
        return [(f".{f}", getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return [(str(i), c) for i, c in enumerate(node)]
    return None


def leaves_with_path(tree, prefix: tuple = ()) -> list[tuple[tuple, Any]]:
    """[(path, leaf)] in flatten order; a path is a tuple of elements."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out = []
    for k, c in kids:
        out.extend(leaves_with_path(c, prefix + (k,)))
    return out


def path_str(path: tuple) -> str:
    return "/".join(path)


def leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_path(tree)]


def map_with_path(fn: Callable, tree, *rest, prefix: tuple = ()):
    """``fn(path, leaf, *rest_leaves)`` over every leaf, keeping the tree's
    structure (dict insertion order and container types included); the
    other trees must share the first one's structure."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, *(r[k] for r in rest), prefix=prefix + (str(k),))
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(map_with_path(fn, getattr(tree, f), *(getattr(r, f) for r in rest),
                                          prefix=prefix + (f".{f}",))
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, v, *(r[i] for r in rest), prefix=prefix + (str(i),))
                          for i, v in enumerate(tree))
    return fn(prefix, tree, *rest)


def tree_map(fn: Callable, tree, *rest):
    """``fn(leaf, *rest_leaves)`` over every leaf."""
    return map_with_path(lambda _, *xs: fn(*xs), tree, *rest)


def unflatten_like(template, values: list):
    """A tree of ``template``'s structure whose leaves are ``values``, in
    flatten order (sorted dict keys)."""
    it = iter(values)
    order = {path: next(it) for path, _ in leaves_with_path(template)}
    return map_with_path(lambda path, _: order[path], template)
