"""Nested dicts and lists of tensors, walked as `jax.tree` walks them:
dict keys in sorted order, list items in order."""
from __future__ import annotations


def tree_leaves(tree) -> list:
    """The leaves of `tree`, dict keys sorted (the order of
    `jax.tree.leaves`); None is an empty subtree."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [] if tree is None else [tree]


def tree_unflatten(tree, leaves):
    """A tree of `tree`'s structure holding `leaves` (in tree_leaves
    order)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}
        if isinstance(t, (list, tuple)):
            return [build(x) for x in t]
        return None if t is None else next(it)
    return build(tree)


def tree_map(fn, tree, *rest):
    """fn over the leaves of `tree` and the matching subtrees of `rest`
    (as `jax.tree.map` with `flatten_up_to`: where `tree` has a leaf,
    `rest` may have a whole subtree, such as an int8 moment's
    {"q", "scale"}). A NamedTuple (a TrainState) keeps its type; None is
    an empty subtree, as in jax."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v, *(r[i] for r in rest))
                            for i, v in enumerate(tree)))
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)
