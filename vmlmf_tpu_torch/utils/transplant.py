"""Carry parameters over from the JAX package.

The JAX package keeps parameters as a pytree of arrays; the port keeps the
same tree (dicts and lists, same keys, same layouts) of tensors. So a JAX
`LMModel.init` tree, with its leaves as numpy arrays, maps key for key.
"""

from __future__ import annotations

import numpy as np
import torch

from vmlmf_tpu_torch.utils.device import resolve_device


def params_from_jax(np_params, device="cuda"):
    """A (nested dict / list / tuple of) numpy arrays -> the same tree of tensors."""
    dev = resolve_device(device)

    def conv(p):
        if isinstance(p, dict):
            return {k: conv(v) for k, v in p.items()}
        if isinstance(p, (list, tuple)):
            return [conv(v) for v in p]
        return torch.tensor(np.array(p), device=dev)

    return conv(np_params)
