"""Process groups and the (data, model) device mesh (counterpart of
`vmlmf_tpu.parallel.mesh`).

One process drives one device. A mesh is a `torch.distributed` DeviceMesh
with the axes ``("data", "model")``: batch rows are split over ``data``
(gradients summed over its groups), the vocabulary tables over ``model``.
Where the JAX package lets XLA derive the collectives from sharding
annotations, the port writes them out (`parallel.sharding`, `parallel.spmd`).

Like every entry point of the port, `make_mesh` and `initialize` take
``device_type="cuda"`` (NCCL) by default and raise on a machine without a
CUDA device; ``device_type="cpu"`` selects gloo.
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from vmlmf_tpu_torch.utils.device import resolve_device

AXES = ("data", "model")
# the variables a launcher such as torchrun sets for every process
CLUSTER_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def _backend(device_type):
    resolve_device(device_type)  # raises for "cuda" on a machine without one
    return "nccl" if device_type == "cuda" else "gloo"


def initialize(init_method=None, world_size=None, rank=None, *, device_type="cuda",
               timeout=300.0):
    """Join (or start) the default process group; counterpart of
    `initialize_multihost`.

    ``init_method`` is a rendezvous URL such as ``"tcp://127.0.0.1:29500"``;
    ``timeout`` (seconds) bounds the rendezvous and every collective. Already
    initialised: a no-op.

    Failure semantics, as in the JAX package: when any argument is given
    explicitly, a failed initialisation raises, so that a misconfigured launch
    never degrades into independent single-process runs. With no argument
    given, the cluster variables (`CLUSTER_ENV`, set by torchrun) are used
    when present, and errors raise too; only when none of them is set does
    the call fall back to a one-process group held in memory.
    """
    if dist.is_initialized():
        return
    backend = _backend(device_type)
    kw = dict(backend=backend, timeout=datetime.timedelta(seconds=timeout))
    explicit = not (init_method is None and world_size is None and rank is None)
    if explicit:
        if world_size is None or rank is None:
            raise ValueError("initialize: pass world_size and rank with init_method")
        dist.init_process_group(init_method=init_method or "env://", world_size=world_size,
                                rank=rank, **kw)
    elif all(v in os.environ for v in CLUSTER_ENV):
        dist.init_process_group(init_method="env://", **kw)
    else:  # no cluster environment: one process
        dist.init_process_group(store=dist.HashStore(), world_size=1, rank=0, **kw)
    if device_type == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())


def make_mesh(data=None, model=1, *, device_type="cuda"):
    """DeviceMesh over (data, model); ``data=None``: all remaining processes.

    Initialises a one-process group first when there is none (`initialize`).
    Unlike a JAX mesh, the mesh spans every process of the group.
    """
    _backend(device_type)
    initialize(device_type=device_type)
    n = dist.get_world_size()
    if data is None:
        if n % model != 0:
            raise ValueError(f"{n} processes do not divide into model={model}")
        data = n // model
    if data * model != n:
        raise ValueError(f"a {data}x{model} mesh needs {data * model} processes, have {n}")
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, (data, model), mesh_dim_names=AXES)


def axis_size(mesh, axis):
    """The number of ranks along ``axis`` of ``mesh``; 1 without a mesh."""
    return 1 if mesh is None else mesh.size(mesh.mesh_dim_names.index(axis))


def axis_rank(mesh, axis):
    """This process's coordinate along ``axis``; 0 without a mesh."""
    return 0 if mesh is None else mesh.get_local_rank(axis)


def axis_group(mesh, axis):
    """The process group of ``axis`` through this process, or None where the
    axis has one rank (nothing to communicate)."""
    return None if axis_size(mesh, axis) == 1 else mesh.get_group(axis)


def local_batch_slice(global_batch, mesh=None):
    """Rows of a global batch owned by this process: by its ``data``
    coordinate on ``mesh`` (the ranks of one data group share rows), else by
    its rank in the default group (one process: every row)."""
    if mesh is not None:
        n, r = axis_size(mesh, "data"), axis_rank(mesh, "data")
    elif dist.is_initialized():
        n, r = dist.get_world_size(), dist.get_rank()
    else:
        n, r = 1, 0
    per = global_batch // n
    return slice(r * per, (r + 1) * per)


def make_global_batch(mesh, x, dim=0, *, local=False, device=None):
    """Commit a host batch to this process's device: the counterpart of the
    JAX package's per-host input pipeline.

    With ``local=False`` (the repo's loaders hand every process the whole
    batch), ``x`` is the global batch and this process keeps its rows along
    ``dim`` (`local_batch_slice`); the batch must divide the ``data`` axis.
    With ``local=True``, ``x`` already holds this process's rows.
    ``device``: default the mesh's device type (the CPU without a mesh).
    """
    if device is None:
        device = mesh.device_type if mesh is not None else "cpu"
    x = torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x)
    if not local and axis_size(mesh, "data") > 1:
        n, b = axis_size(mesh, "data"), x.shape[dim]
        if b % n != 0:
            raise ValueError(f"global batch dim {b} is not divisible by the {n}-way 'data' "
                             "axis; rows would be silently dropped — pad or resize the batch")
        x = x.narrow(dim, local_batch_slice(b, mesh).start, b // n)
    return x.contiguous().to(resolve_device(device))
