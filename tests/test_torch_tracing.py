"""The recorder of nnest_torch's spans and counters
(``nnest_torch/utils/profiling.py``) and where the program records.

- Off (the default), ``span()`` returns one shared no-op context and
  ``count()`` returns at once: no clock read, no allocation.
- On, spans nest like the call stack, ``StepTimer`` phases are spans too,
  and counters add up, keyed or not.
- A short nested run (2-D Gaussian, 50 live points, prior rejection then
  Metropolis after a volume switch, as ``test_torch_profiling.py``) run
  twice, plainly and recorded, gives bit-identical results and the same
  phase timers; the recorded spans are properly nested and their counts
  agree with ``run_stats``; ``run_stats``' seconds are the phases' and the
  pool refills' own.
- A shorter run inside ``device_trace`` records itself (as under any
  collecting ``torch.profiler``), and the trace file holds its ``loop``
  annotation.
"""

import glob
import json
import logging
import os
import time
import tracemalloc

import numpy as np
import pytest
import torch

from nnest_torch import NestedSampler
from nnest_torch.likelihoods import Gaussian
from nnest_torch.training import trainer as trainer_module
from nnest_torch.utils import StepTimer, device_trace, profiling
from nnest_torch.utils.profiling import (background, count, last_record,
                                         recording, span, timed)

# One intra-op thread a process: the suite runs in parallel workers that
# share the cores.
torch.set_num_threads(1)

RUN = dict(train_iters=10, volume_switch=0.5, max_iters=120,
           rejection_batch_size=32, mcmc_num_chains=8, mcmc_steps=4)


def test_off_reads_no_clock_and_allocates_nothing(monkeypatch):
    assert span('a') is span('b', generations=2) is background('io_writer')

    def no_clock():
        raise AssertionError('a clock was read with recording off')
    monkeypatch.setattr(profiling.time, 'time_ns', no_clock)
    monkeypatch.setattr(profiling.time, 'perf_counter', no_clock)
    before = last_record()
    for _ in range(100):
        with span('warm'):
            count('n')
    tracemalloc.start()
    try:
        for _ in range(10000):
            with span('loop'), background('io_writer'):
                count('host_syncs', 1, 'loop')
        current, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    assert peak < 1024, (current, peak)
    assert last_record() is before


def test_recording_nests_spans_and_adds_counters():
    timer = StepTimer()
    with recording() as rec:
        with span('outer', kind='x'):
            with timer.time('phase', steps=3) as phase:
                phase.attrs['generations'] = 2
                count('jobs')
                count('jobs', 2)
                count('ns', 5, 'io_writer')
            with recording() as inner:   # adds to the open recording
                with span('sibling'):
                    count('ns', 1, 'plot')
        left_open = span('left open')
        with span('holder'):
            left_open.__enter__()
    assert inner is rec and last_record() is rec
    assert span('after') is span('after again')
    names = [s.name for s in rec.spans]
    assert names == ['outer', 'phase', 'sibling', 'holder', 'left open']
    assert [s.parent for s in rec.spans] == [-1, 0, 0, -1, 3]
    assert rec.spans[0].attrs == {'kind': 'x'}
    assert rec.spans[1].attrs == {'steps': 3, 'generations': 2}
    assert rec.spans[4].end_ns == rec.spans[3].end_ns
    for s in rec.spans:
        held = rec.spans[s.parent] if s.parent >= 0 else None
        assert s.start_ns <= s.end_ns
        if held is not None:
            assert held.start_ns <= s.start_ns and s.end_ns <= held.end_ns
    assert rec.counters == {'jobs': 3, 'ns': {'io_writer': 5, 'plot': 1}}
    assert timer.summary()['phase']['count'] == 1
    assert timer.summary()['phase']['total_s'] == phase.seconds
    # a timed region reads its clock with recording off too
    with timed('region') as region:
        time.sleep(0.001)
    assert region.seconds > 0 and last_record() is rec


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def _run(log_dir):
    s = NestedSampler(2, Gaussian(2, 0.0, lim=3), transform=lambda x: 3 * x,
                      num_live_points=50, log_dir=str(log_dir),
                      resume=False, seed=3, device='cpu')
    lines = _Lines()
    s.logger.addHandler(lines)
    submitted = []
    submit = s._submit_io
    s._submit_io = lambda job: (submitted.append(1), submit(job))
    return s, lines, submitted


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp('tracing')
    with pytest.MonkeyPatch.context() as mp:
        # TensorBoard's first import can take seconds; the run directory
        # keeps its checkpoints, chains and plots without it
        mp.setattr(trainer_module, '_make_writer',
                   lambda path: trainer_module._NullWriter())
        off, off_lines, _ = _run(root / 'off')
        off.run(**RUN)
        on, on_lines, submitted = _run(root / 'on')
        with recording() as rec:
            on.run(**RUN)
    traced = NestedSampler(2, Gaussian(2, 0.0, lim=3),
                           transform=lambda x: 3 * x, num_live_points=50,
                           log_dir=None, seed=3, device='cpu')
    with device_trace(str(root / 'trace')):
        traced.run(**dict(RUN, max_iters=40))
    return {'off': off, 'on': on, 'rec': rec, 'submitted': len(submitted),
            'lines': (off_lines.lines, on_lines.lines),
            'trace': str(root / 'trace'), 'traced': last_record()}


def _counts(stats):
    return {k: v for k, v in stats.items() if not k.endswith('_s')}


def _under(rec, span_, name):
    """Whether ``span_`` is, or is nested in, a span named ``name``."""
    while True:
        if span_.name == name:
            return True
        if span_.parent < 0:
            return False
        span_ = rec.spans[span_.parent]


def test_results_are_bit_identical_with_recording(runs):
    off, on = runs['off'], runs['on']
    assert (off.logz, off.h, off.total_calls, off.niter) == \
        (on.logz, on.h, on.total_calls, on.niter)
    for name in ('samples', 'weights', 'loglikes', 'saved_u'):
        np.testing.assert_array_equal(getattr(off, name), getattr(on, name))
    assert _counts(off.run_stats) == _counts(on.run_stats)


def test_phase_timers_are_unchanged(runs):
    off, on = runs['off'], runs['on']
    a, b = off.timers.summary(), on.timers.summary()
    assert list(a) == list(b)
    for name in a:
        assert list(a[name]) == list(b[name]) == ['count', 'total_s',
                                                   'mean_s']
        assert a[name]['count'] == b[name]['count']
    logged = []
    for lines in runs['lines']:
        line = [ln for ln in lines if ln.startswith('Phase timers: ')]
        assert len(line) == 1
        logged.append(json.loads(line[0].split('Phase timers: ', 1)[1]))
    assert set(logged[0]) == set(logged[1]) == set(a) | {'train_plot'}


def test_recorded_spans_nest_like_the_call_stack(runs):
    rec = runs['rec']
    names = {s.name for s in rec.spans}
    assert {'run', 'loop', 'pool', 'mcmc_kernel', 'gen.prep', 'gen.steps',
            'gen.consume', 'gen.pull', 'gen.serve', 'io.drain',
            'flow_train', 'checkpoint_io'} <= names
    assert rec.spans[0].name == 'run' and rec.spans[0].parent == -1
    loop = [s for s in rec.spans if s.name == 'loop']
    assert len(loop) == 1 and rec.spans[loop[0].parent].name == 'run'
    for i, s in enumerate(rec.spans):
        assert s.start_ns <= s.end_ns
        if i:
            assert 0 <= s.parent < i
            held = rec.spans[s.parent]
            assert held.start_ns <= s.start_ns and s.end_ns <= held.end_ns
    for s in rec.spans:
        if s.name.startswith('gen.'):
            assert _under(rec, s, 'pool'), s.name
        if s.name == 'mcmc_kernel':
            assert set(s.attrs) == {'generations', 'steps'}
            assert s.attrs['steps'] == RUN['mcmc_steps']


def test_gen_span_counts_agree_with_run_stats(runs):
    rec, stats = runs['rec'], runs['on'].run_stats
    n = {}
    for s in rec.spans:
        n[s.name] = n.get(s.name, 0) + 1
    dispatches = [s for s in rec.spans if s.name == 'mcmc_kernel']
    made = sum(s.attrs['generations'] for s in dispatches)
    assert len(dispatches) == stats['mcmc_dispatches'] >= 1
    assert made == (stats['mcmc_generations'] + stats['speculation_losses']
                    + stats['generations_discarded'])
    assert n['gen.steps'] == made
    # the starts' draw, then the step loop's own preparation
    assert n['gen.prep'] == 2 * made
    assert n['gen.serve'] == stats['mcmc_generations']
    assert n['pool'] == sum(v for k, v in stats.items()
                            if k.endswith('_generations'))
    in_dispatch = [s.name for s in rec.spans if _under(rec, s, 'mcmc_kernel')]
    assert in_dispatch.count('gen.consume') == made
    # one stop-flag read a generation, one buffer pull a dispatch
    assert in_dispatch.count('gen.pull') == made + len(dispatches)
    assert n['flow_train'] == stats['trainings']


def test_run_stats_seconds_are_the_regions_own(runs):
    on, rec = runs['on'], runs['rec']
    stats, phases = on.run_stats, on.timers.summary()
    assert stats['train_s'] == phases['flow_train']['total_s']
    assert stats['checkpoint_s'] == phases['checkpoint_io']['total_s']
    for method, stem in (('mcmc', 'mcmc'), ('rejection_prior', 'rejection')):
        pools = [s.seconds for s in rec.spans if s.name == 'pool'
                 and s.attrs['method'] == method]
        assert stats[stem + '_s'] == pytest.approx(sum(pools), abs=1e-12)


def test_train_epochs_and_background_counters(runs):
    on, rec = runs['on'], runs['rec']
    assert on.run_stats['train_epochs'] == on.trainer.total_iters >= 1
    jobs = rec.counters['background_jobs']
    assert jobs['io_writer'] == runs['submitted'] >= 1
    assert jobs['plot'] == on.run_stats['trainings']
    # the render's own seconds, on the plot counter's clock
    assert on.trainer.plot_seconds == pytest.approx(
        rec.counters['background_ns']['plot'] * 1e-9, rel=1e-9)
    assert not rec.syncs_counted and 'host_syncs' not in rec.counters


def test_device_trace_records_the_run_and_holds_its_annotations(runs):
    traced = runs['traced']
    assert traced is not runs['rec']
    assert [s.name for s in traced.spans][:2] == ['run', 'loop']
    files = glob.glob(os.path.join(runs['trace'], '*.pt.trace.json'))
    assert len(files) == 1
    with open(files[0]) as f:
        names = {e.get('name') for e in json.load(f)['traceEvents']}
    assert {'run', 'loop', 'gen.steps'} <= names
