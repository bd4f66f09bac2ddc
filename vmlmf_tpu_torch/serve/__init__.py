"""Serving: autoregressive decode for the LM."""

from vmlmf_tpu_torch.serve.decoder import Decoder

__all__ = ["Decoder"]
