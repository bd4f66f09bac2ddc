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
semantics, and pulls losses to the host only when it logs. The ``mesh`` and
``loss_fn`` hooks come with the multi-GPU and ranking slices.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from vmlmf_tpu_torch.utils.device import resolve_device
from vmlmf_tpu_torch.utils.tree import first_device, trainable_leaves


def lm_loss(logits, y):
    """Mean over (T, B) of the NLL of ``y [T, B]`` under ``logits [T, B, V]``,
    times B; as logsumexp minus the target logit, without a log-softmax."""
    b = y.shape[1]
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, y[..., None])[..., 0]
    return (lse - tgt).mean() * b


def clip_by_global_norm(grads, max_norm):
    """-> (grads scaled by min(1, max_norm / (norm + 1e-6)), their global norm)."""
    norm = torch.sqrt(sum(torch.sum(torch.square(g)) for g in grads))
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

    def init(self, dtype=torch.float32):
        """The model's parameters from ``seed``, on ``device``."""
        return self.model.init(torch.Generator().manual_seed(self.seed),
                               resolve_device(self.device), dtype)

    def state0(self, batch=None):
        return self.model.state0(batch or self.batch_size, resolve_device(self.device))

    def train_step(self, params, states, x, y, lr, generator=None):
        """One SGD step on a chunk ``x, y [T, B]`` (ids, numpy or tensors).

        Forward in train mode (dropout masks from ``generator``, on the
        parameters' device), backward, clip, then ``p -= lr * g`` in place.
        -> (params, new_states detached, loss, gnorm); loss and gnorm stay
        on the device.
        """
        leaves = trainable_leaves(params)
        dev = leaves[0].device
        logits, new_states = self.model.apply(params, _tokens(x, dev), states,
                                              generator=generator, train=True)
        loss = lm_loss(logits, _tokens(y, dev))
        grads, gnorm = clip_by_global_norm(torch.autograd.grad(loss, leaves),
                                           self.max_grad_norm)
        with torch.no_grad():
            for p, g in zip(leaves, grads):
                p.sub_(lr * g)
        return params, _detach(new_states), loss.detach(), gnorm.detach()

    def fit(self, params, data, *, epochs, log_every=None, log_fn=print):
        """data = (train_chunks, valid_chunks, test_chunks) from
        `vmlmf_tpu_torch.data.ptb.minibatch`. -> (params, history)."""
        trn, vld, tst = data
        lr = self.learning_rate
        generator = torch.Generator(device=first_device(params)).manual_seed(self.seed + 1)
        history = []
        tic = time.perf_counter()
        total_words = 0
        for epoch in range(epochs):
            states = self.state0()
            if epoch > self.factor_epoch and lr > 0.001:
                lr = lr / self.factor
            for i, (x, y) in enumerate(trn):
                total_words += np.asarray(x).size
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
        """Validation/test perplexity over ``chunks``, state carried, no grad."""
        return perplexity(self.model, params, chunks, self.batch_size)


def perplexity(model, params, chunks, batch_size):
    """``exp(mean(loss / batch_size))`` over (x, y) chunks with the state
    carried from a zero state, on the parameters' device, without gradients
    (on the "fused" backend, the no-grad scan kernel; on "fused_pipelined",
    the no-grad stack kernel)."""
    dev = first_device(params)
    states = model.state0(batch_size, dev)
    losses = []
    with torch.no_grad():
        for x, y in chunks:
            logits, states = model.apply(params, _tokens(x, dev), states, train=False)
            losses.append(lm_loss(logits, _tokens(y, dev)) / batch_size)
    return float(torch.exp(torch.stack(losses).mean()))
