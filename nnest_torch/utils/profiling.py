"""Profiling hooks: named regions, a device trace and named step timers.

Port of ``nnest_tpu/utils/profiling.py`` on ``torch.profiler``.

Usage::

    with trace_annotation('flow_train'):
        trainer.train(...)

    timer = StepTimer()
    with timer.time('mcmc'):
        ...
    timer.summary()  # {'mcmc': {'count': n, 'total_s': t, 'mean_s': m}}

To capture a trace viewable in TensorBoard's profiler view or Perfetto::

    with device_trace('/tmp/torch-trace'):
        run(...)

``device_trace`` records the host and, when the process has a GPU, its
CUDA kernels; on a machine without one it traces the host, which is all
there is to trace. ``StepTimer`` reads the host's clock: around work
queued on the GPU it times the dispatch, not the device (the samplers'
phases that end in a copy to the host cover the device work as well).
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch


def trace_annotation(name: str):
    """Named region in the profiler timeline."""
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Profile the block and write one trace file into ``log_dir``
    (``torch.profiler.tensorboard_trace_handler``'s ``*.pt.trace.json``)."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


class StepTimer:
    def __init__(self):
        self._totals = defaultdict(float)
        self._counts = defaultdict(int)

    @contextlib.contextmanager
    def time(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._totals[name] += time.perf_counter() - t0
            self._counts[name] += 1

    def summary(self):
        return {
            k: {'count': self._counts[k], 'total_s': self._totals[k],
                'mean_s': self._totals[k] / self._counts[k]}
            for k in self._totals
        }
