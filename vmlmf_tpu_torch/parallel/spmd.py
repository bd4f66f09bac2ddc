"""Data parallelism of the fused kernels over a mesh's ``data`` axis
(counterpart of `vmlmf_tpu.parallel.spmd`).

In the JAX package the program is global and `shard_batch_kernel` wraps each
fused Pallas call in `shard_map`, so that every device runs the kernel on its
own rows while the rest stays global; the transpose of the replicated weights
inserts the gradient `psum`. Here each process runs the whole tower on its own
rows: the trainers and the ranker cut them out with `shard_batch` (the
counterpart of the shard_map's batch specs), the kernels then run on those
rows as they are, and `allreduce_grads` is the `psum` over the ``data``
group. `gather_batch` puts rows back together where a result must be global.

When the global batch does not divide the data axis, `shard_batch` warns once
and hands every rank the whole batch, as the unwrapped JAX call runs it: each
rank then computes the same global step, and no gradient is summed.

The JAX package's `kernel_spmd` context and `current_kernel_spmd` make a mesh
current at trace time, for the Pallas wrappers deep inside a global program
to read. Here nothing deep inside a step needs the mesh: the callers cut and
join rows themselves, so each helper takes its ``spmd = (mesh, axis)`` pair
explicitly, and ``mesh=None`` is the one-process case. `holds_share` says
whether a step's rows are this rank's share of a split batch, the one fact
the trainers and the ranker's sampled softmax read from it.
"""

from __future__ import annotations

import warnings

import torch
import torch.distributed as dist

from vmlmf_tpu_torch.parallel.mesh import axis_group, axis_rank, axis_size

_warned_indivisible: set = set()


def _warn_indivisible(b, n, axis):
    key = (b, n, axis)
    if key not in _warned_indivisible:
        _warned_indivisible.add(key)
        warnings.warn(
            f"kernel SPMD: global batch {b} does not divide the {n}-way '{axis}' mesh axis; "
            "every rank computes the whole batch (prefer divisible batches)", stacklevel=3)


def is_split(b, spmd):
    """Whether a global batch of ``b`` rows splits over ``spmd = (mesh,
    axis)``: more than one rank, and ``b`` divides."""
    mesh, axis = spmd
    n = axis_size(mesh, axis)
    return n > 1 and b % n == 0


def holds_share(b, batch_size, mesh, axis="data"):
    """Whether a step's ``b`` rows are this rank's share of a global batch of
    ``batch_size`` rows split over ``axis``, so that its loss and gradients
    are summed over the axis's group. A one-rank axis counts (the sum is an
    identity, which still drives the collective); a whole batch on every
    rank of a larger axis does not."""
    n = axis_size(mesh, axis)
    return n == 1 or b * n == batch_size


def local_batch(b, spmd):
    """Rows a rank computes of a global batch of ``b`` over ``spmd = (mesh,
    axis)``: b / n where it splits, else b."""
    mesh, axis = spmd
    return b // axis_size(mesh, axis) if is_split(b, spmd) else b


def shard_batch(x, dim, spmd):
    """This rank's contiguous rows along ``dim`` of a global batch ``x`` split
    over ``spmd = (mesh, axis)`` (the counterpart of `shard_batch_kernel`'s
    batch specs); the whole of ``x``, after a warning, where the batch does
    not divide."""
    mesh, axis = spmd
    n, b = axis_size(mesh, axis), x.shape[dim]
    if n == 1:
        return x
    if b % n:
        _warn_indivisible(b, n, axis)
        return x
    return x.narrow(dim, axis_rank(mesh, axis) * (b // n), b // n)


def gather_batch(x, dim, spmd):
    """The global batch from every rank's rows along ``dim`` (the inverse of
    `shard_batch` on a split batch), outside autograd."""
    mesh, axis = spmd
    group = axis_group(mesh, axis)
    if group is None:
        return x
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim)


def _memory_order(t):
    """``t``'s dimensions from the largest stride to the smallest: the order
    in which a new tensor of the same layout (an elementwise op's output)
    holds its elements."""
    return sorted(range(t.dim()), key=lambda d: -t.stride(d))


def allreduce_grads(grads, mesh, axis="data", *, mean=False):
    """Sum (or average) ``grads`` over the ``axis`` group, in one collective
    over a flat buffer: the gradient `psum` of the JAX package's shard_map
    transpose. Runs on a one-rank axis too (an identity), so that a one-card
    mesh drives its collectives.

    Each gradient comes back in its own dimension order (a BPTT's gradient
    of V arrives transposed): a reduction over it, such as the clip's sum of
    squares, then adds in the order it does without a mesh, to the bit."""
    if mesh is None or not grads:
        return list(grads)
    orders = [_memory_order(g) for g in grads]
    flat = torch.cat([g.permute(o).reshape(-1) for g, o in zip(grads, orders)])
    dist.all_reduce(flat, group=mesh.get_group(axis))
    if mean:
        flat = flat / axis_size(mesh, axis)
    out = []
    for f, g, o in zip(flat.split([g.numel() for g in grads]), grads, orders):
        back = sorted(range(g.dim()), key=o.__getitem__)
        out.append(f.view([g.shape[d] for d in o]).permute(back))
    return out
