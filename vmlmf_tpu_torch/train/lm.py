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

``fuse_chunks`` (the JAX package's field and default) runs many steps in
one device dispatch: `fit` takes the chunks in blocks of that many, and on
CUDA `_fused_chunks` replays one captured CUDA graph of `train_step` per
chunk (`utils.graphs.CarriedSteps`), the counterpart of the JAX package's
`lax.scan` over chunks, with the parameters and the states carried on the
device; the chunks past the last whole block step one by one. `perplexity`
replays a captured no-grad step over the chunks of one shape
(`_eval_chunks`). Under a ``mesh`` the same graphs hold the step's
collectives (NCCL), and each block's stack is cut to this rank's rows
(`commit_batch(..., stacked=True)`), as the JAX package commits it to the
``data`` axis. On the CPU both step eagerly, with the same step semantics.
``fuse_chunks=1`` steps chunk by chunk. The loss reaches the host once a
block, in the log line.

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
from vmlmf_tpu_torch.utils.graphs import CarriedSteps, graph_key, on_card, steps_eagerly
from vmlmf_tpu_torch.utils.tree import first_device, trainable_leaves, tree_leaves


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


def _stack(arrays, device):
    """Token chunks (numpy or tensors) as one ``[k, T, B]`` tensor on ``device``:
    one copy to the device for the whole stack."""
    if all(torch.is_tensor(a) for a in arrays):
        return torch.stack([a.to(device) for a in arrays]).long()
    return _tokens(np.stack([np.asarray(a) for a in arrays]), device)


def _detach(states):
    return [tuple(s.detach() for s in st) for st in states]


def _uniform_prefix(chunks):
    """How many chunks from the first have the first one's shapes."""
    n = 0
    if chunks:
        shape = np.shape(chunks[0][0])
        while (n < len(chunks) and np.shape(chunks[n][0]) == shape
               and np.shape(chunks[n][1]) == shape):
            n += 1
    return n


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
    fuse_chunks: int = 256
    device: str = "cuda"
    mesh: object = None
    loss_fn: object = None
    # the captured steps by role: "train" -> (key, CarriedSteps, its learning
    # rate tensor), "eval" -> (key, CarriedSteps)
    _graphs: dict = dataclasses.field(default_factory=dict, init=False, repr=False,
                                      compare=False)

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

    def commit_batch(self, x, y, *, stacked=False):
        """Token chunks ``[T, B]`` (numpy or tensors, the whole batch), or
        with ``stacked`` a stack of them ``[k, T, B]`` (one copy each), as
        this process's rows on its device (`parallel.spmd.shard_batch`);
        without a mesh, the chunks on ``device``."""
        dev = self._device()
        on, dim = (self.mesh, "data"), 2 if stacked else 1
        return (spmd.shard_batch(_tokens(x, dev), dim, on),
                spmd.shard_batch(_tokens(y, dev), dim, on))

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
        parameters' device), backward, clip, then ``p -= lr * g`` in place;
        ``lr`` is a float or a 0-d f32 tensor on the device (the same bits).
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

    def _fused_chunks(self, params, states, xs, ys, lr, generator=None):
        """`train_step` over a stack of chunks ``xs, ys [k, T, B]`` with the
        parameters and the states carried (the JAX package's one-dispatch
        scan): on CUDA, one replay of the captured step a chunk, under a
        mesh with its collectives; on the CPU, the eager steps. Under a mesh
        the stacks are `commit_batch`'s rows (``stacked=True``). ``lr``: a
        float or a 0-d tensor. -> (params, states, losses [k], gnorms [k]),
        all on the device."""
        def step_at(rate):
            def step(states, gen, x, y):
                return self.train_step(params, states, x, y, rate, gen)[1:]
            return step

        dev = first_device(params)
        xs, ys = _tokens(xs, dev), _tokens(ys, dev)
        if not on_card(dev):
            states, (losses, gnorms) = steps_eagerly(step_at(lr), states, generator, xs, ys)
            return params, states, losses, gnorms
        key = (graph_key(tree_leaves(params), xs[0], *tree_leaves(states)), generator is None)
        entry = self._graphs.get("train")
        if entry is None or entry[0] != key:
            lr_buf = torch.zeros((), dtype=torch.float32, device=dev)
            entry = self._graphs["train"] = (key, CarriedSteps(
                step_at(lr_buf), states, (xs[0], ys[0]), device=dev,
                draws=generator is not None), lr_buf)
        _, steps, lr_buf = entry
        lr_buf.fill_(lr)
        states, (losses, gnorms) = steps(states, generator, xs, ys)
        return params, states, losses, gnorms

    def fit(self, params, data, *, epochs, log_every=None, log_fn=print):
        """data = (train_chunks, valid_chunks, test_chunks) from
        `vmlmf_tpu_torch.data.ptb.minibatch`. -> (params, history).

        With ``fuse_chunks`` > 1, each epoch runs blocks of
        ``min(fuse_chunks, len(train_chunks))`` chunks through
        `_fused_chunks`, each block's stack sent to the device in one copy
        (under a mesh, cut to this rank's rows), then the chunks left over
        one `train_step` each; ``log_every`` then logs once a block, the
        block's one read of the loss."""
        trn, vld, tst = data
        lr = self.learning_rate
        # the ranks of one data coordinate draw the same dropout masks
        seed = self.seed + 1 + 7919 * axis_rank(self.mesh, "data")
        generator = torch.Generator(device=first_device(params)).manual_seed(seed)
        history = []
        tic = time.perf_counter()
        total_words = 0
        fuse = max(1, min(self.fuse_chunks, len(trn)))
        for epoch in range(epochs):
            states = self.state0()
            if epoch > self.factor_epoch and lr > 0.001:
                lr = lr / self.factor
            if fuse > 1:
                n_full = (len(trn) // fuse) * fuse
                for s0 in range(0, n_full, fuse):
                    block = trn[s0 : s0 + fuse]
                    xs, ys = (_stack([c[i] for c in block], first_device(params))
                              for i in (0, 1))
                    total_words += xs.numel()
                    xs, ys = self.commit_batch(xs, ys, stacked=True)
                    params, states, losses, _ = self._fused_chunks(params, states, xs, ys,
                                                                   lr, generator)
                    if log_every:
                        toc = time.perf_counter()
                        log_fn(f"chunks {s0 + fuse}/{len(trn)}, train loss = "
                               f"{float(losses[-1]) / self.batch_size:.3f}, "
                               f"wps = {round(total_words / (toc - tic))}, lr = {lr:.3f}")
                for x, y in trn[n_full:]:
                    total_words += np.asarray(x).size
                    x, y = self.commit_batch(x, y)
                    params, states, _, _ = self.train_step(params, states, x, y, lr, generator)
            else:
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

    def _eval_step(self, params, x, y, states):
        """This chunk's full-CE loss, summed over the ranks' rows -> (loss, states)."""
        loss, states = self._full_ce(params, x, y, states, None, train=False)
        if self._holds_share(x):
            loss = self._data_sum(loss)
        return loss, states

    @torch.no_grad()
    def _eval_chunks(self, params, states, xs, ys):
        """No-grad full-CE losses over a stack of chunks ``xs, ys [k, T, B]``
        with the state carried (the JAX package's one-dispatch eval scan): on
        CUDA, one replay of the captured eval step a chunk (under a mesh, with
        its collectives; the stacks are this rank's rows); on the CPU, the
        eager steps. -> (losses [k], states)."""

        def step(states, _, x, y):
            loss, new = self._eval_step(params, x, y, states)
            return new, loss

        dev = first_device(params)
        if not on_card(dev):
            states, (losses,) = steps_eagerly(step, states, None, xs, ys)
            return losses, states
        key = graph_key(tree_leaves(params), xs[0], *tree_leaves(states))
        entry = self._graphs.get("eval")
        if entry is None or entry[0] != key:
            entry = self._graphs["eval"] = (key, CarriedSteps(step, states, (xs[0], ys[0]),
                                                              device=dev))
        states, (losses,) = entry[1](states, None, xs, ys)
        return losses, states

    def perplexity(self, params, chunks):
        """Validation/test perplexity over ``chunks``, state carried, no grad,
        full CE whatever ``loss_fn`` is (on the "fused" backend, the no-grad
        scan kernel; on "fused_pipelined", the no-grad stack kernel); under a
        mesh, over the split vocabulary and every rank's rows. The leading
        chunks of one shape go through `_eval_chunks` as one stack, the rest
        one by one."""
        states, losses = self.state0(), []
        chunks = list(chunks)
        n = _uniform_prefix(chunks)
        with torch.no_grad():
            if n > 1:
                dev = first_device(params)
                xs, ys = (_stack([c[i] for c in chunks[:n]], dev) for i in (0, 1))
                xs, ys = self.commit_batch(xs, ys, stacked=True)
                fused, states = self._eval_chunks(params, states, xs, ys)
                losses.append(fused / self.batch_size)
                chunks = chunks[n:]
            for x, y in chunks:
                x, y = self.commit_batch(x, y)
                loss, states = self._eval_step(params, x, y, states)
                losses.append((loss / self.batch_size)[None])
        return float(torch.exp(torch.cat(losses).mean()))


def perplexity(model, params, chunks, batch_size):
    """``exp(mean(loss / batch_size))`` over (x, y) chunks with the state
    carried from a zero state, on the parameters' device, without gradients
    (`LMTrainer.perplexity` without a mesh)."""
    return LMTrainer(model, batch_size=batch_size,
                     device=first_device(params)).perplexity(params, chunks)
