"""HAR training and evaluation: Adam steps, accuracy and macro-F1
(counterpart of `vmlmf_tpu.train.har`).

The optimizer is `torch.optim.Adam` with lr 2e-3; its defaults (betas 0.9,
0.999, eps 1e-8 outside the square root) are optax's ``adam``. On CUDA it is
built ``capturable=True`` (its step count and bias corrections on the
device), for the eager and the captured step alike; the CPU keeps the
default Adam.

``fuse_batches`` (the JAX package's field and default) runs many steps in
one device dispatch: `fit` stacks that many shuffled batches, and on CUDA
`_fused_steps` replays one captured CUDA graph of `train_step` per batch
(`utils.graphs.CarriedSteps`), the counterpart of the JAX package's
`lax.scan`; the batches left over step one by one. Under a ``mesh`` the
graph holds the step's collectives (NCCL), and each stack is cut to this
rank's rows along its batch dimension, as the JAX package's ``P(None,
"data")``. On the CPU the steps run eagerly. ``fuse_batches=1`` steps batch
by batch.

With a ``mesh`` (`parallel.mesh.make_mesh`), training is data parallel over
its ``data`` axis: the parameters and the Adam state are replicated (the same
seed on every rank), each rank takes its rows of a batch (`commit_batch`),
and the gradients are averaged over the ``data`` group before Adam's update,
the gradient `psum` the JAX package's sharding inserts.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch
import torch.distributed as dist

from vmlmf_tpu_torch.data.batching import batch_iterator, pad_last_batch
from vmlmf_tpu_torch.parallel import spmd
from vmlmf_tpu_torch.parallel.mesh import axis_size
from vmlmf_tpu_torch.utils.device import resolve_device
from vmlmf_tpu_torch.utils.graphs import CarriedSteps, graph_key, on_card, steps_eagerly
from vmlmf_tpu_torch.utils.tree import first_device, trainable_leaves


def cross_entropy(logits, labels):
    """Mean softmax cross-entropy of integer ``labels``."""
    return torch.nn.functional.cross_entropy(logits, labels.long())


@dataclasses.dataclass
class HARTrainer:
    model: object
    learning_rate: float = 2e-3
    batch_size: int = 81
    seed: int = 3
    fuse_batches: int = 64
    device: str = "cuda"
    mesh: object = None
    # the captured train step: (key, CarriedSteps, the optimizer it steps)
    _graph: tuple = dataclasses.field(default=None, init=False, repr=False, compare=False)

    def init(self, dtype=torch.float32):
        """-> (params from ``seed`` on ``device``, their Adam optimizer); under a
        mesh, on its device type, replicated."""
        dev = self.mesh.device_type if self.mesh is not None else self.device
        params = self.model.init(torch.Generator().manual_seed(self.seed),
                                 resolve_device(dev), dtype)
        return params, self.optimizer(params)

    def optimizer(self, params):
        """Adam over every tensor of ``params`` (set to require a gradient):
        the optimizer state of `train_step` and `fit`; ``capturable`` where
        the parameters are on CUDA."""
        leaves = trainable_leaves(params)
        return torch.optim.Adam(leaves, lr=self.learning_rate,
                                capturable=leaves[0].is_cuda)

    def commit_batch(self, x, y, *, stacked=False):
        """A batch (numpy or tensors), or with ``stacked`` a stack of them
        ``[k, B, ...]`` (one copy each), on the parameters' device; under a
        mesh, this rank's rows of it (`parallel.spmd.shard_batch`)."""
        dev = resolve_device(self.mesh.device_type if self.mesh is not None else self.device)
        x, y = torch.as_tensor(x, device=dev), torch.as_tensor(y, device=dev)
        on, dim = (self.mesh, "data"), 1 if stacked else 0
        return spmd.shard_batch(x, dim, on), spmd.shard_batch(y, dim, on)

    def train_step(self, params, opt_state, x, y):
        """One Adam step on a batch ``x [B, T, F]``, ``y [B]`` (numpy or
        tensors). -> (params, opt_state, loss), updated in place; the loss
        stays on the device. Under a mesh, ``x, y`` are `commit_batch`'s rows
        (the whole batch where it does not divide the ``data`` axis), and the
        loss returned is the batch's."""
        dev = first_device(params)
        x, y = torch.as_tensor(x, device=dev), torch.as_tensor(y, device=dev)
        opt_state.zero_grad(set_to_none=True)
        loss = cross_entropy(self.model.apply(params, x), y)
        loss.backward()
        if self.mesh is not None:
            loss = self._average(params, loss.detach(), x.shape[0])
        opt_state.step()
        return params, opt_state, loss.detach()

    def _average(self, params, loss, b):
        """Average the gradients and the loss over the ``data`` group, where the
        batch is split (or the axis has one rank)."""
        if not spmd.holds_share(b, self.batch_size, self.mesh):
            return loss  # every rank computed the whole batch
        leaves = trainable_leaves(params)
        grads = spmd.allreduce_grads([p.grad for p in leaves], self.mesh, mean=True)
        for p, g in zip(leaves, grads):
            p.grad = g
        loss = loss.clone()
        dist.all_reduce(loss, group=self.mesh.get_group("data"))
        return loss / axis_size(self.mesh, "data")

    def _fused_steps(self, params, opt_state, xs, ys):
        """`train_step` over a stack of batches ``xs [k, B, T, F]``, ``ys
        [k, B]`` (the JAX package's one-dispatch scan): on CUDA, one replay
        of the captured step a batch, under a mesh with its collectives; on
        the CPU, the eager steps. Under a mesh the stacks are `commit_batch`'s
        rows (``stacked=True``). -> (params, opt_state, losses [k]) on the
        device."""

        def step(states, _, x, y):
            return states, self.train_step(params, opt_state, x, y)[2]

        dev = first_device(params)
        xs, ys = torch.as_tensor(xs, device=dev), torch.as_tensor(ys, device=dev)
        if not on_card(dev):
            _, (losses,) = steps_eagerly(step, [], None, xs, ys)
            return params, opt_state, losses
        key = graph_key(trainable_leaves(params), xs[0], ys[0])
        if self._graph is None or self._graph[0] != key or self._graph[2] is not opt_state:
            self._graph = (key, CarriedSteps(step, [], (xs[0], ys[0]), device=dev), opt_state)
        _, (losses,) = self._graph[1]([], None, xs, ys)
        return params, opt_state, losses

    def fit(self, params, opt_state, x_train, y_train, *, epochs, log_fn=print):
        """Shuffled drop-last epochs. With ``fuse_batches`` > 1, blocks of
        ``min(fuse_batches, batches an epoch)`` batches through
        `_fused_steps`, each block's stack sent in one copy (under a mesh,
        cut to this rank's rows), then the batches left over one
        `train_step` each; else one `train_step` a batch. -> (params,
        opt_state, history)."""
        history = []
        n_batches = len(x_train) // self.batch_size
        fuse = max(1, min(self.fuse_batches, n_batches))
        for epoch in range(epochs):
            t0 = time.perf_counter()
            losses, block = [], []
            for xb, yb in batch_iterator(x_train, y_train, self.batch_size, shuffle=True,
                                         drop_last=True, seed=self.seed, epoch=epoch):
                if fuse > 1:
                    block.append((xb, yb))
                    if len(block) == fuse:
                        xs, ys = self.commit_batch(
                            *(np.stack([b[i] for b in block]) for i in (0, 1)), stacked=True)
                        params, opt_state, ls = self._fused_steps(params, opt_state, xs, ys)
                        losses.append(ls)
                        block = []
                    continue
                xb, yb = self.commit_batch(xb, yb)
                params, opt_state, loss = self.train_step(params, opt_state, xb, yb)
                losses.append(loss[None])
            for xb, yb in block:  # the remainder, batch by batch
                xb, yb = self.commit_batch(xb, yb)
                params, opt_state, loss = self.train_step(params, opt_state, xb, yb)
                losses.append(loss[None])
            mean_loss = float(torch.cat(losses).mean())
            dt = time.perf_counter() - t0
            history.append({"epoch": epoch, "loss": mean_loss, "seconds": dt})
            if log_fn:
                log_fn(f"Epoch {epoch} cross_entropy {mean_loss:.6f} ({dt:.2f} sec.)")
        return params, opt_state, history

    def predict(self, params, x):
        """Class ids of a batch; under a mesh, each rank predicts its rows and
        the whole batch's ids come back on every rank."""
        on = (self.mesh, "data")
        with torch.no_grad():
            x = torch.as_tensor(x, device=first_device(params))
            pred = torch.argmax(self.model.apply(params, spmd.shard_batch(x, 0, on)), -1)
            return spmd.gather_batch(pred, 0, on) if spmd.is_split(x.shape[0], on) else pred


def evaluate(model, params, x_test, y_test, batch_size=256):
    """-> dict(accuracy, macro_f1) over the whole test set, in batches of one
    shape (the last one padded and masked), without gradients."""
    dev = first_device(params)
    xp, _, mask = pad_last_batch(np.asarray(x_test), np.asarray(y_test), batch_size)
    preds = []
    with torch.no_grad():
        for s in range(0, len(xp), batch_size):
            logits = model.apply(params, torch.as_tensor(xp[s : s + batch_size], device=dev))
            preds.append(torch.argmax(logits, -1).cpu().numpy())
    preds = np.concatenate(preds)[mask]
    y = np.asarray(y_test)
    return {"accuracy": float((preds == y).mean()), "macro_f1": macro_f1(preds, y)}


def macro_f1(pred, target):
    """Macro-averaged F1 over the classes present in pred ∪ target (sklearn's
    default label set for ``f1_score(average='macro')``)."""
    classes = np.union1d(np.unique(pred), np.unique(target))
    f1s = []
    for c in classes:
        tp = float(((pred == c) & (target == c)).sum())
        fp = float(((pred == c) & (target != c)).sum())
        fn = float(((pred != c) & (target == c)).sum())
        denom = 2 * tp + fp + fn
        f1s.append(0.0 if denom == 0 else 2 * tp / denom)
    return float(np.mean(f1s))
