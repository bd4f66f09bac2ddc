"""HAR training and evaluation: Adam steps, accuracy and macro-F1
(counterpart of `vmlmf_tpu.train.har`).

The optimizer is `torch.optim.Adam` with lr 2e-3; its defaults (betas 0.9,
0.999, eps 1e-8 outside the square root) are optax's ``adam``. The JAX
package's ``fuse_batches`` runs many steps in one `lax.scan` dispatch; here
`fit` steps batch by batch in a plain loop with the same step semantics.

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
    device: str = "cuda"
    mesh: object = None

    def init(self, dtype=torch.float32):
        """-> (params from ``seed`` on ``device``, their Adam optimizer); under a
        mesh, on its device type, replicated."""
        dev = self.mesh.device_type if self.mesh is not None else self.device
        params = self.model.init(torch.Generator().manual_seed(self.seed),
                                 resolve_device(dev), dtype)
        return params, self.optimizer(params)

    def optimizer(self, params):
        """Adam over every tensor of ``params`` (set to require a gradient):
        the optimizer state of `train_step` and `fit`."""
        return torch.optim.Adam(trainable_leaves(params), lr=self.learning_rate)

    def commit_batch(self, x, y):
        """A batch (numpy or tensors) on the parameters' device; under a mesh,
        this rank's rows of it (`parallel.spmd.shard_batch`)."""
        dev = resolve_device(self.mesh.device_type if self.mesh is not None else self.device)
        x, y = torch.as_tensor(x, device=dev), torch.as_tensor(y, device=dev)
        on = (self.mesh, "data")
        return spmd.shard_batch(x, 0, on), spmd.shard_batch(y, 0, on)

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

    def fit(self, params, opt_state, x_train, y_train, *, epochs, log_fn=print):
        """Shuffled drop-last epochs, each batch one `train_step`.
        -> (params, opt_state, history)."""
        history = []
        for epoch in range(epochs):
            t0 = time.perf_counter()
            losses = []
            for xb, yb in batch_iterator(x_train, y_train, self.batch_size, shuffle=True,
                                         drop_last=True, seed=self.seed, epoch=epoch):
                xb, yb = self.commit_batch(xb, yb)
                params, opt_state, loss = self.train_step(params, opt_state, xb, yb)
                losses.append(loss)
            mean_loss = float(torch.stack(losses).mean())
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
