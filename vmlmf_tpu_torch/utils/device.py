"""Where the port's tensors live.

Every entry point takes ``device="cuda"`` by default. A machine without a
CUDA device gets an error from that default, never a quiet run on the CPU:
the CPU is used only when the caller names it, as the tests do.
"""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a `torch.device`; raises if it names CUDA and none exists."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "vmlmf_tpu_torch runs on a CUDA device by default and this machine "
            "has none; pass device='cpu' to run on the CPU")
    return dev
