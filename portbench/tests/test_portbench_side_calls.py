"""``side_calls_per_dead_point`` as the benchmark reads it from the
program's ``evidence_side`` counter
(``metrics/side_calls_per_dead_point.py``).

- It reads (``transform_calls`` + ``scalar_jobs``) / ``dead`` of the traced
  job, and None where the program counted no dead point, recorded nothing
  or the traced job failed.
- The benchmark lists it in the evidence loop's layer, for every cell.
- A traced run of the deep band on the CPU at a tiny size reads a few
  side calls a pool, far under one a dead point.
"""

import pytest
import torch

from harness import cells
from harness.bench import run_cell
from test_portbench_program import _job_ctx, _Record, _Span

torch.set_num_threads(1)

NAME = 'side_calls_per_dead_point'


def _read(monkeypatch, rec, index=0):
    from nnest_torch.utils import profiling
    monkeypatch.setattr(profiling, 'last_record', lambda: rec,
                        raising=False)
    ctx = _job_ctx()
    ctx['jobs'][0]['index'] = index
    return cells.reader(NAME)(ctx)


def _run_record(counters):
    return _Record([_Span('run', 0, 10 ** 9),
                    _Span('loop', 10, 10 ** 8, 0)], counters)


@pytest.mark.parametrize('counts,value', [
    ({'dead': 2000, 'transform_calls': 9, 'scalar_jobs': 21}, 0.015),
    ({'dead': 2000, 'transform_calls': 2000}, 1.0),
    ({'dead': 1999, 'transform_calls': 1999, 'scalar_jobs': 1999}, 2.0),
    ({'dead': 4}, 0.0),
])
def test_reads_the_side_calls_a_dead_point(counts, value, monkeypatch):
    got = _read(monkeypatch, _run_record({'evidence_side': counts}))
    assert got == pytest.approx(value)


@pytest.mark.parametrize('counters', [
    {}, {'evidence_side': {}},
    {'evidence_side': {'transform_calls': 3, 'scalar_jobs': 2}},
    {'mcmc_graph': {'graph_steps': 10}}])
def test_none_where_no_dead_point_was_counted(counters, monkeypatch):
    assert _read(monkeypatch, _run_record(counters)) is None


def test_none_without_a_record_or_the_traced_job(monkeypatch):
    from nnest_torch.utils import profiling
    assert _read(monkeypatch, None) is None
    rec = _run_record({'evidence_side': {'dead': 10, 'scalar_jobs': 1}})
    assert _read(monkeypatch, rec, index=1) is None
    monkeypatch.delattr(profiling, 'last_record')
    assert cells.reader(NAME)(_job_ctx()) is None


def test_listed_for_every_cell_in_the_evidence_loop_layer():
    bench = cells.benchmark()
    entry, = [m for m in bench['per_layer'] if m['name'] == NAME]
    loop, = [m for m in bench['per_layer']
             if m['name'] == 'evidence_loop_share']
    assert entry['layer'] == loop['layer']
    assert (entry['unit'], entry['better'], entry['source'],
            entry['moves']) == ('calls', 'lower', 'program_counter',
                                'dead_points_per_s')
    assert 'workloads' not in entry
    for cell in bench['workloads']:
        assert NAME in [m['name'] for m in cells.metrics_for(
            bench['per_layer'], cell['name'])]


def test_traced_cpu_run_reads_a_few_side_calls_a_pool():
    """The deep band at the fault tests' tiny size, traced, on the CPU."""
    from test_portbench_faults import CONFIG
    traffic = dict(cells.traffic('band_r10'), radius=3.0, max_iters=150,
                   warmup_iters=10, inverse_sample_stride=7)
    per_layer = [m for m in cells.benchmark()['per_layer']
                 if m['name'] == NAME]
    result = run_cell('gauss16.deep', CONFIG, traffic,
                      cells.limits('gauss16.deep'), 2 ** 31 + 95, 0.0, True,
                      [], per_layer, device='cpu')
    assert result['correct'] and not result['failed']
    value = result['metrics'][NAME]
    assert value['unit'] == 'calls'
    assert 0 < value['value'] < 0.5
