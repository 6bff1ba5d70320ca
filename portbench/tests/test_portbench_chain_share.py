"""``chain_forward_share`` as the benchmark reads it from the program's
``spline_chain`` counter (``metrics/chain_forward_share.py``).

- It reads ``kernel`` / (``kernel`` + ``plain``) of the traced job in %,
  and None where the program counted no spline-chain forward (a checkout
  without the counter, or a flow without a spline chain), recorded nothing
  or the traced job failed.
- The benchmark lists it in the flow-training layer for the three cells
  whose flows have spline chains.
"""

import pytest
import torch

from harness import cells
from test_portbench_program import _job_ctx, _Record, _Span

torch.set_num_threads(1)

NAME = 'chain_forward_share'


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
    ({'kernel': 57}, 100.0), ({'plain': 12}, 0.0),
    ({'kernel': 3, 'plain': 1}, 75.0)])
def test_reads_the_kernel_share_of_chain_forwards(counts, value,
                                                  monkeypatch):
    got = _read(monkeypatch, _run_record({'spline_chain': counts}))
    assert got == pytest.approx(value)


@pytest.mark.parametrize('counters', [
    {}, {'spline_chain': {}}, {'train_step': {'fused': 9}}])
def test_none_where_no_chain_forward_was_counted(counters, monkeypatch):
    assert _read(monkeypatch, _run_record(counters)) is None


def test_none_without_a_record_or_the_traced_job(monkeypatch):
    from nnest_torch.utils import profiling
    assert _read(monkeypatch, None) is None
    rec = _run_record({'spline_chain': {'kernel': 4}})
    assert _read(monkeypatch, rec, index=1) is None
    monkeypatch.delattr(profiling, 'last_record')
    assert cells.reader(NAME)(_job_ctx()) is None


def test_listed_for_the_spline_cells_in_the_training_layer():
    bench = cells.benchmark()
    entry, = [m for m in bench['per_layer'] if m['name'] == NAME]
    fused, = [m for m in bench['per_layer']
              if m['name'] == 'fused_train_step_share']
    assert entry['layer'] == fused['layer']
    assert (entry['unit'], entry['better'], entry['source'],
            entry['moves']) == ('%', 'higher', 'program_counter',
                                'dead_points_per_s')
    assert entry['workloads'] == ['gauss16.deep', 'gauss50.deep',
                                  'mog30fs.deep']
