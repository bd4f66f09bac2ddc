"""Timing helpers (counterpart of `vmlmf_tpu.utils.timer`).

`Timer` is tic/toc on the host clock. `device_time` times a call on the
device that runs it: CUDA events on a CUDA device (the launches are
asynchronous, so a host clock would time their enqueue), the host clock on
the CPU.
"""

from __future__ import annotations

import time

import torch


class Timer:
    def __init__(self):
        self._t0 = None
        self.laps = []

    def tic(self):
        self._t0 = time.perf_counter()
        return self

    def toc(self):
        dt = time.perf_counter() - self._t0
        self.laps.append(dt)
        return dt

    @property
    def total(self):
        return sum(self.laps)


def device_time(fn, *args, iters=1, warmup=1, device="cuda", **kw):
    """Median seconds of ``fn(*args, **kw)`` over ``iters`` calls after
    ``warmup`` calls: each call between two CUDA events on ``device``'s
    current stream when it is a CUDA device, else on the host clock."""
    dev = torch.device(device)
    for _ in range(warmup):
        fn(*args, **kw)
    times = []
    for _ in range(iters):
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            with torch.cuda.device(dev):
                start.record()
                fn(*args, **kw)
                end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            fn(*args, **kw)
            times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]
