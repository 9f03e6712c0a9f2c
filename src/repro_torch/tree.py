"""Parameter trees of the port: nested dicts of tensors, with tuples (an
``AdamWState``) where the training state has them, flattened in the
reference's order (JAX's: dict keys sorted, tuples and lists in order),
the order its checkpoints store leaves in."""
from __future__ import annotations

from typing import Any, Iterator, List


def leaves(tree: Any) -> List[Any]:
    """The tree's leaves in the reference's flatten order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def unflatten(template: Any, it: Iterator[Any]) -> Any:
    """Leaves from ``it`` (in :func:`leaves` order) in ``template``'s
    structure (dicts keep the template's key order)."""
    if isinstance(template, dict):
        out = {k: unflatten(template[k], it) for k in sorted(template)}
        return {k: out[k] for k in template}
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*(unflatten(v, it) for v in template))
    if isinstance(template, (tuple, list)):
        return type(template)(unflatten(v, it) for v in template)
    return next(it)


def tree_map(fn, tree: Any, *rest: Any) -> Any:
    """fn over the leaves of one or more trees of nested dicts with the
    same keys."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)
