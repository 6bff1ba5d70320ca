"""Cross-cutting utilities: chain diagnostics, logging and run directories,
profiling, the sample buffer (``nnest_tpu.utils``' names)."""

from nnest_torch.utils.evaluation import (
    effective_sample_size, acceptance_rate, mean_jump_distance,
    gelman_rubin_diagnostic, integrated_autocorr_time)
from nnest_torch.utils.logger import create_logger, get_or_create_run_dir
from nnest_torch.utils.buffer import SampleBuffer
from nnest_torch.utils.profiling import trace_annotation, device_trace, \
    StepTimer

__all__ = [
    'effective_sample_size', 'acceptance_rate', 'mean_jump_distance',
    'gelman_rubin_diagnostic', 'integrated_autocorr_time',
    'create_logger', 'get_or_create_run_dir', 'SampleBuffer',
    'trace_annotation', 'device_trace', 'StepTimer',
]
