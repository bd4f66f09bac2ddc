"""PTB language-model training: the Zaremba protocol (counterpart of
`vmlmf_tpu.train.lm`).

  * loss — softmax NLL averaged over (T, B) and multiplied by the batch
    size, computed as logsumexp minus the target logit;
  * optimizer — plain SGD ``p -= lr * g`` after clipping the gradients to a
    global norm of ``max_grad_norm``, with the learning rate divided by
    ``factor`` each epoch past ``factor_epoch`` while it is above 0.001;
  * perplexity — ``exp(mean(loss / batch_size))`` over chunks with the state
    carried;
  * TBPTT — the state is carried across the chunks of an epoch and reset per
    epoch. Where the JAX package detaches it implicitly at the jit boundary,
    `LMTrainer.train_step` returns it detached.

The JAX package's ``fuse_chunks`` runs many steps in one `lax.scan`
dispatch; here `fit` steps chunk by chunk in a plain loop with the same step
semantics, and pulls losses to the host only when it logs.

Two hooks, as in the JAX package:
  * ``loss_fn(params, x, y, states, generator) -> (loss, new_states)``
    replaces the full-CE training loss (the ranker's sampled softmax,
    `serve.ranker.SessionRanker.trainer`); `perplexity` stays full-CE;
  * ``mesh`` (a `parallel.mesh.make_mesh` DeviceMesh): the recurrent towers
    data parallel over ``data``, the vocabulary tables split on ``model``
    (`parallel.sharding.lm_param_sharding`). `init` returns this process's
    shards, `commit_batch` and `state0` its rows, and `train_step` sums the
    gradients over the ``data`` group before the clip, whose norm sums each
    split table's squares over ``model`` once. Under a mesh, ``loss_fn``
    gets this process's shards and rows and returns its share of the loss.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch
import torch.distributed as dist

from vmlmf_tpu_torch.nn.losses import lm_loss  # noqa: F401  (the JAX module's name)
from vmlmf_tpu_torch.parallel import sharding, spmd
from vmlmf_tpu_torch.parallel.mesh import axis_group, axis_rank
from vmlmf_tpu_torch.utils.device import resolve_device
from vmlmf_tpu_torch.utils.tree import first_device, trainable_leaves


def clip_by_global_norm(grads, max_norm, specs=(), mesh=None):
    """-> (grads scaled by min(1, max_norm / (norm + 1e-6)), their global norm).

    Under a mesh, ``specs`` are the leaves' shardings, and the squares of a
    leaf split on ``model`` are summed over that group once
    (`parallel.sharding.global_sq_norm`)."""
    norm = torch.sqrt(sharding.global_sq_norm(grads, specs, mesh))
    scale = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    return [g * scale for g in grads], norm


def _tokens(a, device):
    return torch.as_tensor(a, device=device).long()


def _detach(states):
    return [tuple(s.detach() for s in st) for st in states]


@dataclasses.dataclass
class LMTrainer:
    model: object
    batch_size: int = 20
    seq_length: int = 35
    learning_rate: float = 1.0
    factor_epoch: int = 6
    factor: float = 1.2
    max_grad_norm: float = 5.0
    seed: int = 0
    device: str = "cuda"
    mesh: object = None
    loss_fn: object = None

    def _device(self):
        return resolve_device(self.mesh.device_type if self.mesh is not None else self.device)

    def init(self, dtype=torch.float32):
        """The model's parameters from ``seed``, on ``device`` (under a mesh:
        this process's shards, on the mesh's device type)."""
        params = self.model.init(torch.Generator().manual_seed(self.seed), self._device(),
                                 dtype)
        if self.mesh is not None:
            params = sharding.shard_params(params, sharding.lm_param_sharding(params, self.mesh),
                                           self.mesh)
        return params

    def state0(self, batch=None):
        """Zero states for ``batch`` rows (default ``batch_size``); under a mesh,
        for this process's rows of them."""
        b = spmd.local_batch(batch or self.batch_size, (self.mesh, "data"))
        return self.model.state0(b, self._device())

    def commit_batch(self, x, y):
        """Token chunks ``[T, B]`` (numpy or tensors, the whole batch) as this
        process's rows on its device (`parallel.spmd.shard_batch`); without a
        mesh, the chunks on ``device``."""
        dev = self._device()
        on = (self.mesh, "data")
        return spmd.shard_batch(_tokens(x, dev), 1, on), spmd.shard_batch(_tokens(y, dev), 1, on)

    def _loss(self, params, x, y, states, generator, **loss_kw):
        """This rank's share of the training loss -> (loss, new_states):
        ``loss_fn``'s where one is set, else the full CE."""
        if self.loss_fn is not None:
            return self.loss_fn(params, x, y, states, generator, **loss_kw)
        if loss_kw:
            raise TypeError(f"train_step got {sorted(loss_kw)}, which only a loss_fn takes")
        return self._full_ce(params, x, y, states, generator, train=True)

    def _full_ce(self, params, x, y, states, generator, train):
        """This rank's share of `lm_loss` with the vocabulary split on
        ``model``; without a mesh (or with one rank on ``model``), `lm_loss`
        of `model.apply`, to the bit."""
        group = axis_group(self.mesh, "model")
        hs, new_states = self.model.hidden_from_embedded(
            params, sharding.embed(params["embed"]["w"], x, group), states,
            generator=generator, train=train)
        return sharding.lm_loss(sharding.logits(self.model, params, hs, group), y,
                                group), new_states

    def _holds_share(self, x):
        return spmd.holds_share(x.shape[1], self.batch_size, self.mesh)

    def _data_sum(self, loss):
        """The global loss from this rank's share: summed over ``data``."""
        if self.mesh is None:
            return loss
        loss = loss.clone()
        dist.all_reduce(loss, group=self.mesh.get_group("data"))
        return loss

    def train_step(self, params, states, x, y, lr, generator=None, **loss_kw):
        """One SGD step on a chunk ``x, y [T, B]`` (ids, numpy or tensors).

        Forward in train mode (dropout masks from ``generator``, on the
        parameters' device), backward, clip, then ``p -= lr * g`` in place.
        -> (params, new_states detached, loss, gnorm); loss and gnorm stay
        on the device.

        Under a mesh, ``x, y`` are `commit_batch`'s rows (or the whole batch,
        when it does not divide the ``data`` axis) and ``states`` their
        states; ``generator`` must draw the same dropout masks on the ranks of
        one ``data`` coordinate, whose towers are replicas. The loss and the
        norm returned are the global ones. ``loss_kw`` go to ``loss_fn`` (the
        ranker's sampled softmax takes ``negatives=``); without one they raise.
        """
        leaves = trainable_leaves(params)
        dev = leaves[0].device
        x, y = _tokens(x, dev), _tokens(y, dev)
        loss, new_states = self._loss(params, x, y, states, generator, **loss_kw)
        grads = torch.autograd.grad(loss, leaves)
        loss = loss.detach()
        if self._holds_share(x):  # this rank's loss is its rows' share: sum both
            grads = spmd.allreduce_grads(grads, self.mesh)
            loss = self._data_sum(loss)
        specs = sharding.spec_leaves(sharding.lm_param_sharding(params, self.mesh))
        grads, gnorm = clip_by_global_norm(grads, self.max_grad_norm, specs, self.mesh)
        with torch.no_grad():
            for p, g in zip(leaves, grads):
                p.sub_(lr * g)
        return params, _detach(new_states), loss, gnorm.detach()

    def fit(self, params, data, *, epochs, log_every=None, log_fn=print):
        """data = (train_chunks, valid_chunks, test_chunks) from
        `vmlmf_tpu_torch.data.ptb.minibatch`. -> (params, history)."""
        trn, vld, tst = data
        lr = self.learning_rate
        # the ranks of one data coordinate draw the same dropout masks
        seed = self.seed + 1 + 7919 * axis_rank(self.mesh, "data")
        generator = torch.Generator(device=first_device(params)).manual_seed(seed)
        history = []
        tic = time.perf_counter()
        total_words = 0
        for epoch in range(epochs):
            states = self.state0()
            if epoch > self.factor_epoch and lr > 0.001:
                lr = lr / self.factor
            for i, (x, y) in enumerate(trn):
                total_words += np.asarray(x).size
                x, y = self.commit_batch(x, y)
                params, states, loss, gnorm = self.train_step(params, states, x, y, lr,
                                                              generator)
                if log_every and i % log_every == 0:
                    toc = time.perf_counter()
                    log_fn(f"batch {i}/{len(trn)}, train loss = "
                           f"{float(loss) / self.batch_size:.3f}, "
                           f"wps = {round(total_words / (toc - tic))}, "
                           f"dw.norm() = {float(gnorm):.3f}, lr = {lr:.3f}, "
                           f"since beginning = {round((toc - tic) / 60)} mins")
            val_ppl = self.perplexity(params, vld)
            history.append({"epoch": epoch, "val_ppl": val_ppl, "lr": lr})
            if log_fn:
                log_fn(f"Epoch {epoch + 1} || Validation set perplexity : {val_ppl:.3f}")
        test_ppl = self.perplexity(params, tst)
        history.append({"test_ppl": test_ppl})
        if log_fn:
            log_fn(f"Test set perplexity : {test_ppl:.3f}")
        return params, history

    def perplexity(self, params, chunks):
        """Validation/test perplexity over ``chunks``, state carried, no grad,
        full CE whatever ``loss_fn`` is (on the "fused" backend, the no-grad
        scan kernel; on "fused_pipelined", the no-grad stack kernel); under a
        mesh, over the split vocabulary and every rank's rows."""
        states, losses = self.state0(), []
        with torch.no_grad():
            for x, y in chunks:
                x, y = self.commit_batch(x, y)
                loss, states = self._full_ce(params, x, y, states, None, train=False)
                if self._holds_share(x):
                    loss = self._data_sum(loss)
                losses.append(loss / self.batch_size)
        return float(torch.exp(torch.stack(losses).mean()))


def perplexity(model, params, chunks, batch_size):
    """``exp(mean(loss / batch_size))`` over (x, y) chunks with the state
    carried from a zero state, on the parameters' device, without gradients
    (`LMTrainer.perplexity` without a mesh)."""
    return LMTrainer(model, batch_size=batch_size,
                     device=first_device(params)).perplexity(params, chunks)
