"""Profiling and numerical-sanitizer hooks (counterpart of
`vmlmf_tpu.utils.profiling`):

  * `trace(log_dir)` — a `torch.profiler` session over the CPU and, where
    there is one, the CUDA device, written as a Chrome trace (TensorBoard,
    Perfetto) into ``log_dir``;
  * `enable_nan_checks()` — `torch.autograd.set_detect_anomaly`: a backward
    that produces a NaN raises, naming the forward op that led to it;
  * `live_buffer_bytes()` — bytes of the tensors alive on a CUDA device
    (`torch.cuda.memory_allocated`).
"""

from __future__ import annotations

import contextlib
import os

import torch


@contextlib.contextmanager
def trace(log_dir="./vmlmf_trace"):
    """Profile the block; on exit write ``log_dir/trace.json``. Yields the
    profiler, whose ``key_averages()`` sums the time by op and kernel."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def enable_nan_checks(on=True):
    """NaN sanitizer: autograd's anomaly mode, on or off."""
    torch.autograd.set_detect_anomaly(on)


def live_buffer_bytes(device=None):
    """Bytes of the tensors alive on CUDA ``device`` (default: the current
    one), as the caching allocator counts them."""
    return torch.cuda.memory_allocated(device)
