"""HAR training and evaluation: Adam steps, accuracy and macro-F1
(counterpart of `vmlmf_tpu.train.har`).

The optimizer is `torch.optim.Adam` with lr 2e-3; its defaults (betas 0.9,
0.999, eps 1e-8 outside the square root) are optax's ``adam``. The JAX
package's ``fuse_batches`` runs many steps in one `lax.scan` dispatch; here
`fit` steps batch by batch in a plain loop with the same step semantics.
The ``mesh`` path comes with the multi-GPU slice.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from vmlmf_tpu_torch.data.batching import batch_iterator, pad_last_batch
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

    def init(self, dtype=torch.float32):
        """-> (params from ``seed`` on ``device``, their Adam optimizer)."""
        params = self.model.init(torch.Generator().manual_seed(self.seed),
                                 resolve_device(self.device), dtype)
        return params, self.optimizer(params)

    def optimizer(self, params):
        """Adam over every tensor of ``params`` (set to require a gradient):
        the optimizer state of `train_step` and `fit`."""
        return torch.optim.Adam(trainable_leaves(params), lr=self.learning_rate)

    def train_step(self, params, opt_state, x, y):
        """One Adam step on a batch ``x [B, T, F]``, ``y [B]`` (numpy or
        tensors). -> (params, opt_state, loss), updated in place; the loss
        stays on the device."""
        dev = first_device(params)
        x, y = torch.as_tensor(x, device=dev), torch.as_tensor(y, device=dev)
        opt_state.zero_grad(set_to_none=True)
        loss = cross_entropy(self.model.apply(params, x), y)
        loss.backward()
        opt_state.step()
        return params, opt_state, loss.detach()

    def fit(self, params, opt_state, x_train, y_train, *, epochs, log_fn=print):
        """Shuffled drop-last epochs, each batch one `train_step`.
        -> (params, opt_state, history)."""
        history = []
        for epoch in range(epochs):
            t0 = time.perf_counter()
            losses = []
            for xb, yb in batch_iterator(x_train, y_train, self.batch_size, shuffle=True,
                                         drop_last=True, seed=self.seed, epoch=epoch):
                params, opt_state, loss = self.train_step(params, opt_state, xb, yb)
                losses.append(loss)
            mean_loss = float(torch.stack(losses).mean())
            dt = time.perf_counter() - t0
            history.append({"epoch": epoch, "loss": mean_loss, "seconds": dt})
            if log_fn:
                log_fn(f"Epoch {epoch} cross_entropy {mean_loss:.6f} ({dt:.2f} sec.)")
        return params, opt_state, history

    def predict(self, params, x):
        with torch.no_grad():
            x = torch.as_tensor(x, device=first_device(params))
            return torch.argmax(self.model.apply(params, x), -1)


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
