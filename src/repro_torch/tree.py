"""Nested dicts and lists of tensors (the port's parameter, optimizer and
checkpoint trees): flatten to leaves with their key paths, rebuild, map.

A path is the list of keys from the root: a ``str`` for a dict entry, an
``int`` for a list or tuple entry.  Anything that is not a dict, list or
tuple is a leaf.  Dicts keep their insertion order."""
from __future__ import annotations

from typing import Any, Callable


def flatten(tree: Any) -> tuple[list, list[list]]:
    """(leaves, paths) in depth-first order."""
    leaves, paths = [], []

    def walk(node, path):
        if isinstance(node, dict):
            for key, child in node.items():
                walk(child, path + [key])
        elif isinstance(node, (list, tuple)):
            for i, child in enumerate(node):
                walk(child, path + [i])
        else:
            leaves.append(node)
            paths.append(path)

    walk(tree, [])
    return leaves, paths


def leaves(tree: Any) -> list:
    return flatten(tree)[0]


def leaves_at(tree: Any, paths: list[list]) -> list:
    """The leaves of ``tree`` at ``paths`` (another tree's, of the same
    structure), in that order, whatever order ``tree``'s dicts keep."""
    out = []
    for path in paths:
        node = tree
        for key in path:
            node = node[key]
        out.append(node)
    return out


def unflatten(paths: list[list], values: list) -> Any:
    """The tree whose leaves at ``paths`` are ``values``: an ``int`` key
    makes a list, a ``str`` key a dict.  (A tree that is itself one leaf
    has the path [].)"""
    if len(paths) == 1 and not paths[0]:
        return values[0]
    root: Any = None

    def container(key):
        return [] if isinstance(key, int) else {}

    for path, value in zip(paths, values):
        if root is None:
            root = container(path[0])
        node = root
        for key, nxt in zip(path[:-1], path[1:]):
            if isinstance(key, int):
                while len(node) <= key:
                    node.append(None)
                if node[key] is None:
                    node[key] = container(nxt)
            elif key not in node:
                node[key] = container(nxt)
            node = node[key]
        last = path[-1]
        if isinstance(last, int):
            while len(node) <= last:
                node.append(None)
        node[last] = value
    return root


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of each
    tree in ``rest`` (same structure), in a tree of ``tree``'s
    structure."""
    flat, paths = flatten(tree)
    others = [leaves_at(r, paths) for r in rest]
    return unflatten(paths, [fn(x, *(o[i] for o in others))
                             for i, x in enumerate(flat)])
