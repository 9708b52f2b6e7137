"""Parameter trees: nested dicts, lists, tuples and named tuples of
tensors, the port's stand-in for JAX pytrees. ``None`` is a node without
leaves, as in JAX (an optimizer without momentum keeps ``trace=None``)."""

from __future__ import annotations

from typing import Any, Callable, List


def _is_namedtuple(tree) -> bool:
    return isinstance(tree, tuple) and hasattr(tree, "_fields")


def tree_map(fn: Callable, tree, *rest, is_leaf: Callable = None):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure); a node for which ``is_leaf``
    is true counts as one leaf, as in JAX (an int8 qleaf dict)."""
    if tree is None:
        return None
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest), is_leaf=is_leaf)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        items = [tree_map(fn, v, *(r[i] for r in rest), is_leaf=is_leaf)
                 for i, v in enumerate(tree)]
        return type(tree)(*items) if _is_namedtuple(tree) else type(tree)(
            items)
    return fn(tree, *rest)


def tree_leaves(tree, is_leaf: Callable = None) -> List[Any]:
    """The leaves in :func:`tree_map`'s order."""
    out: List[Any] = []
    tree_map(out.append, tree, is_leaf=is_leaf)
    return out


def tree_unflatten(tree, leaves):
    """A tree of ``tree``'s structure holding ``leaves`` in order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def tree_paths(tree, prefix: str = "") -> List[str]:
    """The key of each leaf in :func:`tree_map`'s order, in the JAX
    package's checkpoint scheme: a dict key or a sequence index as is, a
    named-tuple field as ``.field``, joined by ``/`` (``.params/dense_1/
    kernel``, ``.opt_state/mu/dense_1/kernel``, ``.step``)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        items = [(str(k), v) for k, v in tree.items()]
    elif _is_namedtuple(tree):
        items = [("." + f, v) for f, v in zip(tree._fields, tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return [prefix]
    out: List[str] = []
    for key, sub in items:
        out += tree_paths(sub, f"{prefix}/{key}" if prefix else key)
    return out


def jax_leaf_order(tree) -> List[int]:
    """The positions in :func:`tree_leaves`'s order of the leaves in the
    order JAX flattens the same tree: dict keys sorted, sequences and
    named-tuple fields in order. What ``ravel_pytree`` and the JAX
    package's checkpoint keys follow, where :func:`tree_leaves` keeps a
    dict's insertion order."""
    counter = iter(range(1 << 62))
    positions = tree_map(lambda _: next(counter), tree)
    out: List[int] = []

    def walk(node):
        if node is None:
            return
        if isinstance(node, dict):
            for key in sorted(node):
                walk(node[key])
        elif isinstance(node, (list, tuple)):
            for sub in node:
                walk(sub)
        else:
            out.append(node)

    walk(positions)
    return out
