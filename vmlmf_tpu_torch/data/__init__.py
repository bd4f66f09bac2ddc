"""Host-side data for the trainers: batching, the PTB pipeline and synthetic
HAR windows (counterpart of `vmlmf_tpu.data`). Everything here is numpy;
the trainers move batches to the device."""
