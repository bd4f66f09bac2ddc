"""Parameter trees: nested dicts and lists of tensors, as the JAX package's
pytrees of arrays."""

from __future__ import annotations


def tree_leaves(tree):
    """The tensors of a (nested dict / list / tuple) tree, depth-first in
    insertion order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def trainable_leaves(tree):
    """`tree_leaves`, each set to require a gradient (in place)."""
    leaves = tree_leaves(tree)
    for p in leaves:
        p.requires_grad_(True)
    return leaves


def first_device(tree):
    """The device of a tree's first tensor."""
    return tree_leaves(tree)[0].device
