"""nnest_torch.utils.profiling and the samplers' phase timers against
nnest_tpu's.

- ``StepTimer``: on the same sequence of phases, ``summary()`` has the
  reference's keys, order, counts and entry fields, its mean the total
  over the count.
- ``device_trace`` on the CPU writes one trace file (the
  ``*.pt.trace.json`` of ``tensorboard_trace_handler``) whose events hold
  a ``trace_annotation`` name.
- A short nested run (2-D Gaussian, 50 live points, prior rejection then
  Metropolis after a volume switch, one retrain checked by the NLL gate)
  times only phase names the reference's samplers time
  (``nnest_tpu/samplers/{base,nested}.py``), the kernels', the training's
  and the checkpoints' among them, and logs them as ``Phase timers``.
"""

import glob
import inspect
import json
import os
import re

import numpy as np
import pytest
import torch

from nnest_torch import NestedSampler
from nnest_torch.likelihoods import Gaussian
from nnest_torch.utils import StepTimer, device_trace, trace_annotation

# One intra-op thread a process: the suite runs in parallel workers that
# share the cores.
torch.set_num_threads(1)

PHASES = ['mcmc_init', 'mcmc_kernel', 'mcmc_init', 'candidate_kernel',
          'mcmc_kernel', 'mcmc_kernel', 'flow_train']


def _reference_phase_names():
    import nnest_tpu.samplers.base as base
    import nnest_tpu.samplers.nested as nested
    src = inspect.getsource(base) + inspect.getsource(nested)
    return set(re.findall(r"timers\.time\('(\w+)'\)", src))


def _drive(timer):
    for name in PHASES:
        with timer.time(name):
            pass
    return timer.summary()


def test_step_timer_summary_matches_nnest_tpu():
    from nnest_tpu.utils.profiling import StepTimer as JaxStepTimer
    port, ref = _drive(StepTimer()), _drive(JaxStepTimer())
    assert list(port) == list(ref) == ['mcmc_init', 'mcmc_kernel',
                                       'candidate_kernel', 'flow_train']
    for name in ref:
        assert list(port[name]) == list(ref[name])
        assert port[name]['count'] == ref[name]['count'] == \
            PHASES.count(name)
        assert port[name]['total_s'] >= 0
        assert port[name]['mean_s'] == pytest.approx(
            port[name]['total_s'] / port[name]['count'])


def test_device_trace_writes_the_annotation(tmp_path):
    with device_trace(str(tmp_path)):
        with trace_annotation('nnest_probe_region'):
            torch.ones(64).cumsum(0).sum()
    files = glob.glob(os.path.join(str(tmp_path), '*.pt.trace.json'))
    assert len(files) == 1, os.listdir(str(tmp_path))
    with open(files[0]) as f:
        events = json.load(f)['traceEvents']
    assert any(e.get('name') == 'nnest_probe_region' for e in events)


def test_nested_run_times_the_reference_phases(tmp_path, capsys):
    s = NestedSampler(2, Gaussian(2, 0.0, lim=3), transform=lambda x: 3 * x,
                      num_live_points=50, log_dir=str(tmp_path / 'run'),
                      resume=False, seed=3, device='cpu')
    s.run(train_iters=10, volume_switch=0.5, max_iters=120,
          rejection_batch_size=32, mcmc_num_chains=8, mcmc_steps=4)
    phases = s.timers.summary()
    assert set(phases) <= _reference_phase_names()
    assert {'mcmc_kernel', 'candidate_kernel', 'flow_train',
            'retrain_check', 'checkpoint_io', 'diagnostics'} <= set(phases)
    assert s.run_stats['mcmc_generations'] >= 1
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if 'Phase timers: ' in ln]
    assert len(line) == 1
    logged = json.loads(line[0].split('Phase timers: ', 1)[1])
    assert set(logged) - {'train_plot'} == set(phases)
    assert all(np.isfinite(v) and v >= 0 for v in logged.values())
