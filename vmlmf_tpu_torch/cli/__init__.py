"""The port's command-line entry points: `har_main` and `lm_main`."""

from vmlmf_tpu_torch.nn.recurrence import BACKENDS as _PRODUCTION
from vmlmf_tpu_torch.nn.recurrence import WAVEFRONT_BACKENDS

# the recurrence backends the CLIs take; they also accept the JAX package's
# names for them (`nn.recurrence.backend_name`)
BACKENDS = (*_PRODUCTION, *WAVEFRONT_BACKENDS)
