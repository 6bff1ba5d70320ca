"""Cross-cutting utilities: chain diagnostics, logging and run directories,
the sample buffer (``nnest_tpu.utils``' names). ``nnest_tpu.utils``' JAX
profiling helpers (``trace_annotation``, ``device_trace``, ``StepTimer``)
have no counterpart: ``torch.profiler`` takes their place."""

from nnest_torch.utils.evaluation import (
    effective_sample_size, acceptance_rate, mean_jump_distance,
    gelman_rubin_diagnostic, integrated_autocorr_time)
from nnest_torch.utils.logger import create_logger, get_or_create_run_dir
from nnest_torch.utils.buffer import SampleBuffer

__all__ = [
    'effective_sample_size', 'acceptance_rate', 'mean_jump_distance',
    'gelman_rubin_diagnostic', 'integrated_autocorr_time',
    'create_logger', 'get_or_create_run_dir', 'SampleBuffer',
]
