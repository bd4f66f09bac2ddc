"""The language-model loss (counterpart of `vmlmf_tpu.train.lm.lm_loss`),
here in a leaf module that the trainer and the vocabulary-sharded loss of
`parallel.sharding` both import."""

from __future__ import annotations

import torch


def lm_loss(logits, y):
    """Mean over (T, B) of the NLL of ``y [T, B]`` under ``logits [T, B, V]``,
    times B; as logsumexp minus the target logit, without a log-softmax."""
    b = y.shape[1]
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, y[..., None])[..., 0]
    return (lse - tgt).mean() * b
