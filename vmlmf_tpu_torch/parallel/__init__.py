"""Multi-device execution on `torch.distributed` (counterpart of
`vmlmf_tpu.parallel`): the (data, model) mesh, shardings of parameter trees
and the operations on sharded tables, data parallelism of the fused kernels,
pipeline parallelism, and the multi-device dry run."""
