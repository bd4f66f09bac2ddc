"""vmlmf_tpu_torch — the PyTorch/CUDA port of vmlmf_tpu.

It mirrors the JAX package's layout (cells, ops, nn, serve, train, data,
utils) and keeps its parameter names, layouts and gate order (i, f, g, o),
so a JAX parameter tree carries over key for key
(`utils.transplant.params_from_jax`). The
JAX package's Pallas kernels become kernels written by hand for Hopper,
under ``csrc/``, built with nvcc at first use into ``_build/``.

Entry points run on ``device="cuda"`` unless the caller passes another
device; without a CUDA device the default raises.
"""

__version__ = "0.1.0"

from vmlmf_tpu_torch.cells import VMLMFCell  # noqa: F401
from vmlmf_tpu_torch.nn.models import LMModel  # noqa: F401
from vmlmf_tpu_torch.nn.recurrence import RNN  # noqa: F401
from vmlmf_tpu_torch.serve import Decoder  # noqa: F401
