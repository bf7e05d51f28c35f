"""Parameter and state trees: nested dicts, lists, tuples and
dataclasses whose leaves are tensors (the port's stand-in for JAX's
pytrees).  Leaves are visited in container order: dict insertion order,
list and tuple order, dataclass field order."""

from __future__ import annotations

import dataclasses


def _children(tree):
    if isinstance(tree, dict):
        return list(tree.values())
    if isinstance(tree, (list, tuple)):
        return list(tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [getattr(tree, f.name) for f in dataclasses.fields(tree)]
    return None


def _rebuild(tree, children):
    if isinstance(tree, dict):
        return dict(zip(tree, children))
    if isinstance(tree, (list, tuple)):
        return type(tree)(children)
    return dataclasses.replace(tree, **{
        f.name: c for f, c in zip(dataclasses.fields(tree), children)})


def leaves(tree) -> list:
    """The leaves of ``tree`` in order."""
    kids = _children(tree)
    if kids is None:
        return [tree]
    return [leaf for kid in kids for leaf in leaves(kid)]


def unflatten(like, new_leaves):
    """A tree of ``like``'s structure holding ``new_leaves`` in order."""
    it = iter(new_leaves)

    def build(t):
        kids = _children(t)
        if kids is not None:
            return _rebuild(t, [build(k) for k in kids])
        leaf = next(it, it)
        if leaf is it:
            raise ValueError("fewer leaves than the tree holds")
        return leaf

    out = build(like)
    if next(it, it) is not it:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_map(fn, tree, *rest):
    """``fn`` applied leafwise over trees of one structure."""
    cols = [leaves(t) for t in (tree, *rest)]
    if any(len(c) != len(cols[0]) for c in cols):
        raise ValueError("trees of different structure")
    return unflatten(tree, [fn(*xs) for xs in zip(*cols)])


def flatten_up_to(like, tree) -> list:
    """The subtrees of ``tree`` at the positions of ``like``'s leaves, in
    ``like``'s leaf order (JAX's ``treedef.flatten_up_to``): ``tree``
    holds ``like``'s structure with a subtree where ``like`` has a leaf.
    Dicts are matched by key, so the two may order their keys apart."""
    kids = _children(like)
    if kids is None:
        return [tree]
    if isinstance(like, dict):
        sub = [tree[k] for k in like]
    else:
        sub = _children(tree)
    return [x for k, t in zip(kids, sub, strict=True)
            for x in flatten_up_to(k, t)]
