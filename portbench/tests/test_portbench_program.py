"""The program's spans and counters as the benchmark reads them
(``harness/program.py``, the six readers on it).

- The segment timeline names every time as ``harness/trace.py``'s
  ``_innermost`` does, and in ``summarize``'s place names every idle gap
  the same on the ``pb.*`` spans alone.
- Given the program's spans beside the ``pb.*`` ones, ``summarize`` reads
  every number but the idle gaps' names the same, and so does every
  existing reader; the gaps keep their count and time.
- Each new reader returns None, never 0, where the program recorded
  nothing (an older checkout) or not the span it reads.
- A traced run of the deep band on the CPU at a tiny size reports each new
  metric (host syncs are counted on a card only) and stays correct.
"""

import random

import pytest
import torch

from harness import cells, program, trace
from harness.bench import run_cell

torch.set_num_threads(1)

NEW = ['evidence_loop_self_ms', 'mcmc_prep_ms', 'host_syncs_per_gen',
       'io_stall_ms', 'background_busy_share', 'train_epochs_per_dead_point']


def _nested(rng, start, end, depth, names, out):
    """Random spans nested in [start, end], and siblings that share
    edges."""
    t = start
    while depth and t < end - 4:
        a = rng.randint(t, min(end - 2, t + (end - start) // 2))
        b = rng.randint(a + 1, min(end, a + (end - start) // 2 + 1))
        out.append((a, b, rng.choice(names)))
        _nested(rng, a, b, depth - 1, names, out)
        t = b if rng.random() < 0.3 else b + rng.randint(1, 5)
    return out


@pytest.mark.parametrize('seed', range(6))
def test_timeline_names_every_time_as_innermost_does(seed):
    rng = random.Random(seed)
    spans = _nested(rng, 0, 2000, 4, ['pb.a', 'pb.b', 'loop', 'gen.x'], [])
    # overlaps that do not nest, and equal twins
    spans += [(rng.randint(0, 1900), rng.randint(1900, 2100), 'pb.c')
              for _ in range(3)]
    spans += [spans[0][:2] + ('twin',)]
    rng.shuffle(spans)
    line = program.Timeline(spans)
    edges = {t for s in spans for t in s[:2]}
    times = sorted(edges | {t + 1 for t in edges} | {t - 1 for t in edges}
                   | {rng.randint(-10, 2110) for _ in range(500)})
    for t in times:
        assert line.name(t) == trace._innermost(spans, t), t


class _Event:
    def __init__(self, start, end, name='k'):
        self._s, self._e, self._n = start, end, name

    def device_type(self):
        return torch.autograd.DeviceType.CUDA

    def is_user_annotation(self):
        return False

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def name(self):
        return self._n


class _Results:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def _recorded_input(seed=0):
    """One traced job's summarize input: device events, the harness's
    ``pb.*`` spans, the program's spans inside them."""
    rng = random.Random(seed)
    pb = [(0, 10000, 'pb.job')]
    program_spans = [(5, 9995, 'run'), (20, 9900, 'loop')]
    t = 100
    for k in range(12):
        a, b = t, t + rng.randint(200, 600)
        name = ['pb.mcmc_dispatch', 'pb.checkpoint', 'pb.train'][k % 3]
        pb.append((a, b, name))
        inner = {'pb.mcmc_dispatch': 'mcmc_kernel',
                 'pb.checkpoint': 'checkpoint_io',
                 'pb.train': 'flow_train'}[name]
        program_spans.append((a + 2, b - 2, inner))
        program_spans.append((a + 10, a + 60, 'gen.prep'))
        program_spans.append((a + 70, b - 20, 'gen.steps'))
        t = b + rng.randint(50, 200)
    events = []
    t = 0
    while t < 10000:
        a = t + rng.randint(1, 30)
        b = a + rng.randint(1, 40)
        events.append(_Event(a, b, rng.choice(['k1', 'k2', 'Memcpy'])))
        t = b
    return _Results(events), pb, program_spans


def _readers():
    bench = cells.benchmark()
    return {m['name']: cells.reader(m['name'])
            for m in cells.metrics_for(bench['per_layer'], 'gauss16.deep')
            if m['name'] not in NEW}


def _ctx(summary):
    from harness import costs
    cfg = cells.config(cells.benchmark(), 'gauss16')
    return {'window_s': 1.0, 'jobs': [], 'dead': 2000, 'rows': 10 ** 5,
            'stats': {'trainings': 1, 'train_s': 0.4, 'mcmc_s': 0.3,
                      'mcmc_generations': 9, 'checkpoint_s': 0.1},
            'epochs': 100, 'config': cfg, 'traffic': {}, 'costs': costs,
            'inverse_calls': 0, 'inverse_rows': 0, 'traced_inverse_rows': [],
            'traced_steps': 720, 'traced_pools': [], 'trace': summary}


def test_timeline_in_summarize_names_the_gaps_as_before(monkeypatch):
    results, pb, _ = _recorded_input()
    before = trace.summarize(results, pb)
    monkeypatch.setattr(trace, '_innermost', lambda spans, t: program.Timeline(
        spans).name(t))
    assert trace.summarize(results, pb) == before


def test_program_spans_leave_every_existing_number_as_it_was(monkeypatch):
    results, pb, program_spans = _recorded_input(1)
    alone = trace.summarize(results, pb)
    lines = {}

    def innermost(spans, t):
        key = id(spans)
        if key not in lines:
            lines[key] = program.Timeline(spans)
        return lines[key].name(t)
    monkeypatch.setattr(trace, '_innermost', innermost)
    both = trace.summarize(results, pb + program_spans)
    assert {k: v for k, v in both.items() if k != 'idle'} == \
        {k: v for k, v in alone.items() if k != 'idle'}
    for i in (0, 1):
        assert sum(v[i] for v in both['idle'].values()) == \
            pytest.approx(sum(v[i] for v in alone['idle'].values()))
    assert set(both['idle']) - set(alone['idle']) >= {'gen.steps'}
    for name, read in _readers().items():
        assert read(_ctx(both)) == read(_ctx(alone)), name


class _Span:
    def __init__(self, name, start, end, parent=-1, syncs=0):
        self.name, self.start_ns, self.end_ns = name, start, end
        self.parent, self.syncs, self.attrs = parent, syncs, {}


class _Record:
    def __init__(self, spans, counters=None, syncs_counted=True):
        self.spans, self.counters = spans, counters or {}
        self.syncs_counted = syncs_counted


def _job_ctx():
    return {'jobs': [{'index': 0, 'dead': 2000,
                      'run_stats': {'mcmc_generations': 9}}],
            'stats': {}, 'dead': 2000, 'trace': {}}


@pytest.mark.parametrize('name', NEW)
def test_readers_give_none_where_nothing_was_recorded(name, monkeypatch):
    from nnest_torch.utils import profiling
    read = cells.reader(name)
    ctx = _job_ctx()
    monkeypatch.setattr(profiling, 'last_record', lambda: None)
    assert read(ctx) is None
    monkeypatch.delattr(profiling, 'last_record')
    assert read(ctx) is None
    # a record of the run alone: none of the spans or counters read
    bare = _Record([_Span('run', 0, 10 ** 9)], syncs_counted=False)
    monkeypatch.setattr(profiling, 'last_record', lambda: bare, raising=False)
    assert read(ctx) is None
    # the traced job failed: the window's first job is not the recorded one
    full = _Record([_Span('run', 0, 10 ** 9), _Span('loop', 1, 9 ** 9, 0),
                    _Span('mcmc_kernel', 2, 10 ** 6, 1, 3),
                    _Span('gen.prep', 3, 10 ** 5, 2),
                    _Span('checkpoint_io', 2 * 10 ** 6, 3 * 10 ** 6, 1)],
                   {'background_ns': {'io_writer': 10 ** 8}})
    monkeypatch.setattr(profiling, 'last_record', lambda: full)
    ctx['jobs'][0]['index'] = 1
    assert read(ctx) is None


def test_readers_read_a_record():
    spans = [_Span('run', 0, 10 ** 9), _Span('loop', 10, 9 * 10 ** 8, 0),
             _Span('pool', 20, 4 * 10 ** 8, 1),
             _Span('mcmc_kernel', 30, 3 * 10 ** 8, 2, 2),
             _Span('gen.prep', 40, 10 ** 7 + 40, 3),
             _Span('gen.pull', 10 ** 8, 2 * 10 ** 8, 3, 9),
             _Span('gen.serve', 3 * 10 ** 8, 3 * 10 ** 8 + 5, 2, 7),
             _Span('checkpoint_io', 5 * 10 ** 8, 6 * 10 ** 8, 1),
             _Span('io.drain', 5 * 10 ** 8, 6 * 10 ** 8, 7),
             _Span('io.drain', 95 * 10 ** 7, 96 * 10 ** 7, 0)]
    rec = _Record(spans, {'background_ns': {'io_writer': 10 ** 8,
                                            'plot': 5 * 10 ** 7}})
    ctx = dict(_job_ctx(), stats={'train_epochs': 300})
    from nnest_torch.utils import profiling
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(profiling, 'last_record', lambda: rec)
        got = {name: cells.reader(name)(ctx) for name in NEW}
    assert got == pytest.approx({
        'evidence_loop_self_ms': 1e-6 * (9 * 10 ** 8 - 10 - (4 * 10 ** 8 - 20)
                                         - 10 ** 8) / 2000,
        'mcmc_prep_ms': 1e-6 * 10 ** 7 / 9,
        'host_syncs_per_gen': (2 + 9 + 7) / 9,
        'io_stall_ms': 1e-6 * (10 ** 8 + 10 ** 7),
        'background_busy_share': 15.0,
        'train_epochs_per_dead_point': 0.15})


def test_traced_cpu_run_reports_the_new_metrics():
    """The deep band at the fault tests' tiny size (``test_portbench_faults``),
    traced: the window's first job runs under the profiler and records."""
    from test_portbench_faults import CONFIG
    traffic = dict(cells.traffic('band_r10'), radius=3.0, max_iters=150,
                   warmup_iters=10, inverse_sample_stride=7)
    bench = cells.benchmark()
    per_layer = [m for m in cells.metrics_for(bench['per_layer'],
                                              'gauss16.deep')
                 if m['name'] in NEW]
    result = run_cell('gauss16.deep', CONFIG, traffic,
                      cells.limits('gauss16.deep'), 2 ** 31 + 91, 0.0, True,
                      [], per_layer, device='cpu')
    assert result['correct'] and not result['failed']
    got = result['metrics']
    # no card: no host syncs to count
    assert set(got) == set(NEW) - {'host_syncs_per_gen'}
    assert all(v['value'] > 0 for v in got.values()), got
