"""Trainers: the PTB LM protocol (`lm`) and the HAR classifiers (`har`)
(counterpart of `vmlmf_tpu.train`)."""
