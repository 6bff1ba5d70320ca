"""``mcmc_graph_step_share`` as the benchmark reads it from the program's
``mcmc_graph`` counter (``metrics/mcmc_graph_step_share.py``).

- It reads the share of the traced job's Metropolis steps that replayed
  the captured graphs, 0 where every step ran eagerly, and None where the
  program counted no step, recorded nothing or the traced job failed.
- The benchmark lists it for both cells, in the latent kernels' layer.
- A traced run of the deep band on the CPU at a tiny size reports 0%:
  off a card every step is eager.
"""

import pytest
import torch

from harness import cells
from harness.bench import run_cell
from test_portbench_program import _job_ctx, _Record, _Span

torch.set_num_threads(1)

NAME = 'mcmc_graph_step_share'


def _read(monkeypatch, rec, index=0):
    from nnest_torch.utils import profiling
    monkeypatch.setattr(profiling, 'last_record', lambda: rec,
                        raising=False)
    ctx = _job_ctx()
    ctx['jobs'][0]['index'] = index
    return cells.reader(NAME)(ctx)


def _run_record(counters):
    return _Record([_Span('run', 0, 10 ** 9),
                    _Span('mcmc_kernel', 10, 10 ** 6, 0)], counters)


@pytest.mark.parametrize('counts,share', [
    ({'graph_steps': 720, 'captures': 0}, 100.0),
    ({'graph_steps': 720}, 100.0),
    ({'eager_steps': 720}, 0.0),
    ({'graph_steps': 540, 'eager_steps': 180, 'captures': 3}, 75.0),
])
def test_reads_the_share_of_replayed_steps(counts, share, monkeypatch):
    assert _read(monkeypatch, _run_record({'mcmc_graph': counts})) == share


@pytest.mark.parametrize('counters', [{}, {'mcmc_graph': {}},
                                      {'mcmc_graph': {'captures': 2}},
                                      {'host_syncs': {'loop': 4}}])
def test_none_where_no_step_was_counted(counters, monkeypatch):
    assert _read(monkeypatch, _run_record(counters)) is None


def test_none_without_a_record_or_the_traced_job(monkeypatch):
    from nnest_torch.utils import profiling
    assert _read(monkeypatch, None) is None
    rec = _run_record({'mcmc_graph': {'graph_steps': 10}})
    assert _read(monkeypatch, rec, index=1) is None
    monkeypatch.delattr(profiling, 'last_record')
    assert cells.reader(NAME)(_job_ctx()) is None


def test_listed_for_both_cells_in_the_latent_kernels_layer():
    bench = cells.benchmark()
    entry, = [m for m in bench['per_layer'] if m['name'] == NAME]
    steps, = [m for m in bench['per_layer']
              if m['name'] == 'kernels_per_mcmc_step']
    assert entry['layer'] == steps['layer']
    assert entry['source'] == 'program_counter'
    assert entry['moves'] == 'dead_points_per_s'
    assert entry['workloads'] == ['gauss16.deep', 'gauss50.deep']


def test_traced_cpu_run_reads_every_step_eager():
    """The deep band at the fault tests' tiny size, traced, on the CPU."""
    from test_portbench_faults import CONFIG
    traffic = dict(cells.traffic('band_r10'), radius=3.0, max_iters=150,
                   warmup_iters=10, inverse_sample_stride=7)
    per_layer = [m for m in cells.benchmark()['per_layer']
                 if m['name'] == NAME]
    result = run_cell('gauss16.deep', CONFIG, traffic,
                      cells.limits('gauss16.deep'), 2 ** 31 + 93, 0.0, True,
                      [], per_layer, device='cpu')
    assert result['correct'] and not result['failed']
    assert result['metrics'] == {NAME: {'value': 0.0, 'unit': '%'}}
