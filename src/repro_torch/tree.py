"""Trees of tensors as nested dicts: the params, their gradients and the
optimizer state.

The reference handles these as JAX pytrees; the port's are plain nested
dicts, walked in key (insertion) order.  A node that is not a dict is a
leaf, so an int8 moment ``{"q", "scale"}`` is reached by the path of its
param with ``at_path``.
"""
from __future__ import annotations

__all__ = ["paths", "at_path", "from_paths", "map_leaves"]


def paths(tree, prefix=()):
    """(path, leaf) pairs of a nested dict, in key order.

    >>> list(paths({"a": 1, "b": {"c": 2}}))
    [(('a',), 1), (('b', 'c'), 2)]
    """
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from paths(v, prefix + (k,))
    else:
        yield prefix, tree


def at_path(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def from_paths(pairs) -> dict:
    """A nested dict from (path, value) pairs.

    >>> from_paths([(("a",), 1), (("b", "c"), 2)])
    {'a': 1, 'b': {'c': 2}}
    """
    out: dict = {}
    for path, value in pairs:
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = value
    return out


def map_leaves(fn, tree):
    """``tree`` with every leaf replaced by ``fn(leaf)``."""
    if isinstance(tree, dict):
        return {k: map_leaves(fn, v) for k, v in tree.items()}
    return fn(tree)
