"""Shardings of parameter trees, and the operations on sharded tables that
XLA derives from the annotations in the JAX package (counterpart of
`vmlmf_tpu.parallel.sharding`).

A sharding is a tuple naming, per tensor dimension, the mesh axis it is split
over (the JAX package's `PartitionSpec`): ``()`` replicated, ``("model",
None)`` rows on ``model``. HAR nets are replicated (data parallel). An LM's
vocabulary tables are split on ``model``: the embedding's rows, the head's
columns and its bias; the recurrent towers are replicated over ``model`` and
data parallel over ``data``.

Each process holds its own shard of a split tensor (`shard_params`), so the
operations on the vocabulary are written out here:

  * the embedding lookup on a row shard: a masked local gather, then a sum
    over the ``model`` group (`embed`; `gather_rows` for the sampled
    softmax's rows);
  * the logits block of a column shard (`logits`);
  * a logsumexp over the shards, for `lm_loss`'s ``lse − target`` form with
    the target logit from the shard that owns it (`lm_loss`).

Autograd through collectives follows Megatron's pair: `copy_to_group` is the
identity forward and a sum over the group backward (where a replicated
tensor enters per-shard work), `reduce_from_group` a sum forward and the
identity backward (where per-shard parts become a replicated tensor that
every rank then uses alike). A plain all-reduce with an all-reduce backward
would scale such gradients by the group's size. With one rank on ``model``
(group None) each operation is the single-device one, to the bit.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from vmlmf_tpu_torch.nn.losses import lm_loss as plain_lm_loss
from vmlmf_tpu_torch.parallel.mesh import axis_group, axis_rank, axis_size
from vmlmf_tpu_torch.utils.rows import take_rows


def replicated(mesh=None):
    return ()


def _tree_fill(tree, spec):
    if isinstance(tree, dict):
        return {k: _tree_fill(v, spec) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_fill(v, spec) for v in tree]
    return spec


def har_param_sharding(params, mesh=None):
    """HAR nets: everything replicated (data parallel)."""
    return _tree_fill(params, replicated(mesh))


def lm_param_sharding(params, mesh=None):
    """LM: the embedding's rows, the head's columns and its bias on ``model``;
    ``fc.w`` is absent under tied embeddings (the head is the table)."""
    specs = _tree_fill(params, replicated(mesh))
    specs["embed"]["w"] = ("model", None)      # [V, H]
    if "w" in params["fc"]:
        specs["fc"]["w"] = (None, "model")     # [H, V]
    specs["fc"]["b"] = ("model",)              # [V]
    return specs


def lm_state_sharding(states, mesh=None):
    """Recurrent states: batch rows on ``data`` (dim 0 of [B, H])."""
    return _tree_fill(states, ("data", None))


def _map(fn, tree, specs):
    if isinstance(tree, dict):
        return {k: _map(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v, s) for v, s in zip(tree, specs))
    return fn(tree, specs)


def shard_params(params, shardings, mesh):
    """This process's shard of every tensor of a full tree: each dimension
    named in its sharding cut into equal blocks along that axis."""

    def cut(t, spec):
        for dim, axis in enumerate(spec):
            if axis is not None:
                n = axis_size(mesh, axis)
                if t.shape[dim] % n:
                    raise ValueError(f"dimension {dim} of {tuple(t.shape)} does not divide "
                                     f"the {n}-way '{axis}' axis")
                t = t.chunk(n, dim)[axis_rank(mesh, axis)]
        return t.contiguous().clone()

    return _map(cut, params, shardings)


def gather_params(params, shardings, mesh):
    """The full tree from every process's shards (for checkpoints and tests),
    outside autograd."""

    def join(t, spec):
        for dim, axis in enumerate(spec):
            group = axis_group(mesh, axis) if axis is not None else None
            if group is not None:
                parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
                dist.all_gather(parts, t.detach().contiguous(), group=group)
                t = torch.cat(parts, dim)
        return t.detach().clone()

    return _map(join, params, shardings)


def spec_leaves(specs):
    """The shardings of a tree of them, in `utils.tree.tree_leaves` order
    (a sharding is a tuple, so tuples are leaves here)."""
    if isinstance(specs, dict):
        return [s for v in specs.values() for s in spec_leaves(v)]
    if isinstance(specs, list):
        return [s for v in specs for s in spec_leaves(v)]
    return [specs]


class _CopyToGroup(torch.autograd.Function):
    """Identity forward; the gradient summed over the group backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromGroup(torch.autograd.Function):
    """Sum over the group forward; the identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromGroup(torch.autograd.Function):
    """Concatenate every rank's part along ``dim`` forward; backward, the sum
    of every rank's gradient, cut to this rank's part (each rank's loss is its
    own share of a global sum, so a part's gradient comes from all of them)."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.n = group, dim, x.shape[dim]
        ctx.rank = dist.get_rank(group)
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g.narrow(ctx.dim, ctx.rank * ctx.n, ctx.n), None, None


def copy_to_group(x, group):
    return x if group is None else _CopyToGroup.apply(x, group)


def reduce_from_group(x, group):
    return x if group is None else _ReduceFromGroup.apply(x, group)


def gather_from_group(x, group, dim=0):
    return x if group is None else _GatherFromGroup.apply(x, group, dim)


def _owned(ids, group, n_local):
    """(local row of each id, whether this shard owns it)."""
    local = ids - dist.get_rank(group) * n_local
    own = (local >= 0) & (local < n_local)
    return torch.where(own, local, torch.zeros_like(local)), own


def gather_rows(table, ids, group):
    """Rows ``ids`` of a table split by rows over ``group``: each shard
    gathers the rows it owns, zeros elsewhere, summed over the group. The
    gradient reaches each shard's own rows. ``table`` is [N/S] or [N/S, H]."""
    if group is None:
        return take_rows(table, ids)
    local, own = _owned(ids, group, table.shape[0])
    rows = take_rows(table, local)
    mask = own.reshape(own.shape + (1,) * (rows.dim() - own.dim()))
    return reduce_from_group(rows * mask.to(rows.dtype), group)


def gather_rows_nograd(table, ids, group):
    """`gather_rows` outside autograd."""
    with torch.no_grad():
        return gather_rows(table, ids, group)


def embed(table, ids, group):
    """The embedding lookup ``table[ids]`` on a row-sharded table."""
    return gather_rows(table, ids, group)


def logits(model, params, x, group):
    """This shard's columns of ``model``'s head on the replicated hidden
    states ``x [..., H]`` -> [..., V/S] (`LMModel._logits` on one shard)."""
    if group is None:
        return model._logits(params, x)
    return model._logits(params, copy_to_group(x, group))


def lm_loss(logits_local, y, group):
    """`lm_loss` of column-sharded logits ``[T, B, V/S]``: the logsumexp taken
    over every shard (a max, then a sum of exponentials, over the group) minus
    the target logit, taken from the shard that owns the target."""
    if group is None:
        return plain_lm_loss(logits_local, y)
    b = y.shape[1]
    m = logits_local.detach().amax(-1, keepdim=True)
    dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
    s = reduce_from_group((logits_local - m).exp().sum(-1), group)
    lse = s.log() + m[..., 0]
    local, own = _owned(y, group, logits_local.shape[-1])
    tgt = torch.gather(logits_local, -1, local[..., None])[..., 0]
    tgt = reduce_from_group(tgt * own.to(tgt.dtype), group)
    return (lse - tgt).mean() * b


def global_sq_norm(grads, specs=(), mesh=None):
    """Σ‖g‖² over a tree's leaves in leaf order, each split leaf's squares
    summed over the ``model`` group once (the replicated leaves are whole on
    every rank). ``specs``: the leaves' shardings (`spec_leaves`), read only
    where ``model`` has more than one rank; with one, this is the plain sum,
    to the bit."""
    sqs = [torch.sum(torch.square(g)) for g in grads]
    group = axis_group(mesh, "model")
    split = [i for i, s in enumerate(specs) if "model" in s] if group is not None else []
    if split:
        part = torch.stack([sqs[i] for i in split])
        dist.all_reduce(part, group=group)
        for j, i in enumerate(split):
            sqs[i] = part[j]
    return sum(sqs)
