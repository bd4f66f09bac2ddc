"""The port's command-line entry points: `har_main` and `lm_main`."""

from vmlmf_tpu_torch.nn.recurrence import BACKENDS as _PRODUCTION
from vmlmf_tpu_torch.nn.recurrence import WAVEFRONT_BACKENDS

# the recurrence backends the CLIs take, and the JAX package's names for
# them, which the CLIs also accept
BACKENDS = (*_PRODUCTION, *WAVEFRONT_BACKENDS)
JAX_BACKENDS = {"xla": "loop", "pallas": "fused", "pallas_pipelined": "fused_pipelined"}


def backend_name(name):
    """A ``--backend`` value as the port names it: the JAX package's names
    map to the port's (xla -> loop, pallas -> fused, pallas_pipelined ->
    fused_pipelined); the port's own pass through."""
    return JAX_BACKENDS.get(name, name)
