"""Containers of tensors walked as trees.

The port passes its data around in frozen dataclasses (``LpProblem``,
``LpState``), NamedTuples (``TrajectoryDataset``), tuples, lists and
dicts.  This is the part of ``jax.tree_util`` that the checkpoint and
the data-parallel helpers need over them: the children of a container
(dataclass and NamedTuple fields in order, dict entries by sorted key,
as jax orders them) and a map over the leaves.  ``None`` is an empty
subtree, as in jax: ``leaves`` skips it and ``tree_map`` keeps it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Tuple


def children(tree: Any) -> Optional[Tuple[list, Callable[[list], Any]]]:
    """The children of a container and a function that rebuilds the
    container from new children; None for a leaf."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        names = [f.name for f in dataclasses.fields(tree)]
        return ([getattr(tree, n) for n in names],
                lambda vals: dataclasses.replace(tree,
                                                 **dict(zip(names, vals))))
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return list(tree), lambda vals: type(tree)(*vals)
    if isinstance(tree, (tuple, list)):
        return list(tree), lambda vals: type(tree)(vals)
    if isinstance(tree, dict):
        keys = sorted(tree)
        return [tree[k] for k in keys], lambda vals: dict(zip(keys, vals))
    return None


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    """``fn`` applied to every leaf (``None`` kept as it is)."""
    if tree is None:
        return None
    c = children(tree)
    if c is None:
        return fn(tree)
    vals, rebuild = c
    return rebuild([tree_map(fn, v) for v in vals])


def leaves(tree: Any) -> List[Any]:
    """The leaves in order (``None`` has none)."""
    out: List[Any] = []
    tree_map(out.append, tree)
    return out


def unflatten(example: Any, new_leaves: List[Any]) -> Any:
    """``example``'s structure with its leaves replaced, in order, by
    ``new_leaves``."""
    it = iter(new_leaves)
    return tree_map(lambda _: next(it), example)
