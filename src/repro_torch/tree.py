"""Trees of tensors in the JAX package's leaf order: nested dicts by
sorted key, named tuples by field (e.g. `optim.adamw.AdamWState`), lists
and tuples by item.  Anything else is a leaf.  A leaf's path is the tuple
of keys, field names and indices that leads to it."""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple


def _is_named_tuple(tree) -> bool:
    return isinstance(tree, tuple) and hasattr(tree, "_fields")


def leaves_with_paths(tree, prefix: Tuple = ()
                      ) -> Iterator[Tuple[Tuple, Any]]:
    """(path, leaf) of every leaf of `tree`, in order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves_with_paths(tree[k], prefix + (k,))
    elif _is_named_tuple(tree):
        for f in tree._fields:
            yield from leaves_with_paths(getattr(tree, f), prefix + (f,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves_with_paths(v, prefix + (i,))
    else:
        yield prefix, tree


def leaves(tree) -> List[Any]:
    """Every leaf of `tree`, in order."""
    return [leaf for _, leaf in leaves_with_paths(tree)]


def map_with_path(fn: Callable[[Tuple, Any], Any], tree, prefix: Tuple = ()):
    """A tree of the same structure holding ``fn(path, leaf)`` for every
    leaf, called in order."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, tree[k], prefix + (k,))
                for k in sorted(tree)}
    if _is_named_tuple(tree):
        return type(tree)(*(map_with_path(fn, getattr(tree, f), prefix + (f,))
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, v, prefix + (i,))
                          for i, v in enumerate(tree))
    return fn(prefix, tree)


def tree_map(fn: Callable[[Any], Any], tree):
    """A tree of the same structure holding ``fn(leaf)`` for every leaf,
    called in order."""
    return map_with_path(lambda _, leaf: fn(leaf), tree)
