"""Nested parameter trees of the port — dicts, lists and tuples of tensors
(the parameter dict, AdamW's moments, a checkpoint's state) — mapped and
flattened in one fixed order: dict insertion order, then sequence order."""
from __future__ import annotations


def tree_map(fn, tree, *rest):
    """fn applied leaf by leaf over `tree` and the trees of the same
    structure in `rest` → a tree of that structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_items(tree, prefix: str = "") -> list:
    """[(key, leaf)] with keys the "/"-joined path ("layers/0/wq")."""
    if isinstance(tree, dict):
        it = tree.items()
    elif isinstance(tree, (list, tuple)):
        it = enumerate(tree)
    else:
        return [(prefix, tree)]
    out = []
    for k, v in it:
        out += tree_items(v, f"{prefix}/{k}" if prefix else str(k))
    return out


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in tree_items(tree)]


def tree_unflatten(template, leaves) -> object:
    """The leaves, in `tree_leaves` order, in the structure of
    `template`."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), template)
