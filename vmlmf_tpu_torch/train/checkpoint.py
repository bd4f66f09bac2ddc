"""Checkpoints of parameter trees, and deterministic run names (counterpart
of `vmlmf_tpu.train.checkpoint`'s NumPy format).

A checkpoint is a directory with ``arrays.npz``, the tree's leaves as
``a0 ... aN``, and ``meta.json`` with ``num_arrays``, the caller's ``meta``
and a description of the tree. The leaves go in the JAX package's flatten
order (`jax.tree_util`: dict keys sorted, lists and tuples in order, None
an empty subtree), whatever the insertion order of the port's dicts, so the
two packages read each other's checkpoints: the JAX loader reads only the
arrays, into the structure of the tree it is given, and so does this one.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch


def run_name(model_name, *, layer_sizes=None, w_rank=None, u_ranks=None,
             data=None, seed=None):
    """Deterministic run id from the experiment coordinates (the reference's
    auto-naming scheme, minus its crash)."""
    parts = [model_name]
    if layer_sizes is not None:
        parts.append("L" + "-".join(map(str, layer_sizes)))
    if w_rank is not None:
        parts.append(f"w{w_rank}")
    if u_ranks is not None:
        u = "-".join(map(str, u_ranks)) if isinstance(u_ranks, (list, tuple)) else str(u_ranks)
        parts.append(f"u{u}")
    if data is not None:
        parts.append(str(data).lower())
    if seed is not None:
        parts.append(f"seed{seed}")
    return "_".join(parts)


def flatten(tree):
    """The leaves of a (nested dict / list / tuple) tree in the JAX package's
    flatten order -> (leaves, a description of the structure)."""
    if tree is None:
        return [], "None"
    if isinstance(tree, dict):
        leaves, parts = [], []
        for key in sorted(tree):
            sub, desc = flatten(tree[key])
            leaves += sub
            parts.append(f"{key!r}: {desc}")
        return leaves, "{" + ", ".join(parts) + "}"
    if isinstance(tree, (list, tuple)):
        leaves, parts = [], []
        for item in tree:
            sub, desc = flatten(item)
            leaves += sub
            parts.append(desc)
        return leaves, ("[{}]" if isinstance(tree, list) else "({})").format(", ".join(parts))
    return [tree], "*"


def unflatten(like, leaves):
    """A tree of ``like``'s structure (its insertion order kept) whose leaves,
    in flatten order, are ``leaves``."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            built = {key: build(node[key]) for key in sorted(node)}
            return {key: built[key] for key in node}
        if isinstance(node, (list, tuple)):
            return type(node)(build(item) for item in node)
        return next(it)

    return build(like)


def _to_numpy(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def save_checkpoint(path, state, *, meta=None):
    """Write ``state`` (a tree of tensors or arrays) into directory ``path``."""
    os.makedirs(path, exist_ok=True)
    flat, desc = flatten(state)
    np.savez(os.path.join(path, "arrays.npz"),
             **{f"a{i}": _to_numpy(x) for i, x in enumerate(flat)})
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump({"treedef": desc, "num_arrays": len(flat), "meta": meta or {}}, f)
    return path


def load_checkpoint(path, like):
    """The checkpoint at ``path`` in the structure of ``like`` (the tree it
    was saved from, or the JAX package's same tree), each leaf a tensor on
    the device of ``like``'s leaf in its place (numpy leaves: on the CPU).
    Raises ValueError where a leaf's shape differs from ``like``'s."""
    flat_like, _ = flatten(like)
    with np.load(os.path.join(path, "arrays.npz")) as z:
        flat = [z[f"a{i}"] for i in range(len(flat_like))]
    for i, (a, b) in enumerate(zip(flat, flat_like)):
        want = tuple(b.shape) if hasattr(b, "shape") else np.shape(b)
        if tuple(a.shape) != want:
            raise ValueError(f"checkpoint leaf {i} shape {a.shape} != expected {want}")
    leaves = [torch.from_numpy(np.array(a)).to(b.device if isinstance(b, torch.Tensor) else "cpu")
              for a, b in zip(flat, flat_like)]
    return unflatten(like, leaves)


def checkpoint_meta(path):
    with open(os.path.join(path, "meta.json")) as f:
        return json.load(f)["meta"]
