"""A dead point's side work, done once a pool: the replacement's transform
and the ``logz`` records.

- The scalar event writer: the native runtime's entry and the Python
  encoder write the same bytes (a tag, steps out of order and signed, NaN,
  ±inf, a float64 that rounds to float32), which TensorBoard's record
  reader reads with valid CRCs, and whose events are, byte for byte, those
  ``SummaryWriter.add_scalar`` writes for the same calls.
- A nested run's ``samples`` are the sampler transform of its ``saved_u``
  row by row, bit for bit, for a device and a host transform; a pool
  restored from a checkpoint, which holds no ``v``, makes it at its first
  accept.
- The loop's counter ``evidence_side``: ``dead`` its dead points,
  ``transform_calls`` its calls of the transform, ``scalar_jobs`` at most
  one a pool and a checkpoint and one more; every ``logz`` and ``loss``
  record reaches the event file.
"""

import glob
import os
import shutil

import numpy as np
import pytest
import torch

from nnest_torch import NestedSampler, runtime
from nnest_torch.likelihoods import Gaussian
from nnest_torch.utils.events import ScalarEventFile, encode_scalar_events
from nnest_torch.utils.profiling import recording

# One intra-op thread a process: the suite runs in parallel workers that
# share the cores.
torch.set_num_threads(1)

FORMAT_DIR = os.path.join(os.path.dirname(__file__), 'data', 'checkpoint_2d')

# (tag, steps, values): out of order, 0 (left out, as proto3 does),
# negative, past 2^32; NaN, ±inf, a float64 that rounds to float32, -0.0,
# a value past float32's range
ROWS = {
    'logz': ([5, 3, 4, 1, 2], [-1.0 / 3.0, np.nan, np.inf, -np.inf, 2.5]),
    'loss': ([0, -7, 2 ** 40, 9], [-0.0, 1e30, 0.1, 7.0]),
    'x': ([1], [np.pi]),
}


def _wall_times(n, t0=1.7e9):
    return [t0 + 0.125 * i for i in range(n)]


def _write(log_dir, batches):
    """The batches through one :class:`ScalarEventFile`; its bytes."""
    os.makedirs(log_dir)
    f = ScalarEventFile(log_dir)
    for tag, steps, values in batches:
        f.write(tag, steps, values, _wall_times(len(steps)))
    with open(f.path, 'rb') as fh:
        return fh.read()


def _batches(order):
    return [(tag,) + ROWS[tag] for tag in order]


def _records(path):
    """The file's records through TensorBoard's own reader, which checks
    both CRCs of each."""
    from tensorboard.compat.tensorflow_stub import errors
    from tensorboard.compat.tensorflow_stub.pywrap_tensorflow import \
        PyRecordReader_New
    reader, out = PyRecordReader_New(path), []
    while True:
        try:
            reader.GetNext()
        except errors.OutOfRangeError:
            return out
        out.append(reader.record())


@pytest.mark.parametrize('order', [['logz'], ['logz', 'loss', 'x'],
                                   ['x', 'x', 'loss']])
def test_native_and_python_encoders_write_the_same_bytes(tmp_path, order,
                                                         monkeypatch):
    if not runtime.available():
        pytest.skip('no g++: the runtime is not built')
    native0, fallback0 = runtime.native_calls, runtime.fallbacks
    native = _write(str(tmp_path / 'native'), _batches(order))
    assert (runtime.native_calls, runtime.fallbacks) == (
        native0 + len(order), fallback0)
    monkeypatch.setattr(runtime, '_lib', None)
    monkeypatch.setattr(runtime.shutil, 'which', lambda name: None)
    python = _write(str(tmp_path / 'python'), _batches(order))
    assert runtime.fallbacks == fallback0 + len(order)
    assert native == python
    # the encoder alone: the file-version event, then the batches
    assert native == b''.join(
        encode_scalar_events(tag, steps, values, _wall_times(len(steps)),
                             new_file=i == 0)
        for i, (tag, steps, values) in enumerate(_batches(order)))


def test_nothing_is_written_for_no_rows(tmp_path):
    f = ScalarEventFile(str(tmp_path))
    f.write('logz', [], [], [])
    runtime.write_scalar_events(f.path, 'logz', [], [], [])
    assert os.listdir(tmp_path) == []


def _summary_writer_file(log_dir, batches):
    from torch.utils.tensorboard import SummaryWriter
    w = SummaryWriter(log_dir)
    for tag, steps, values in batches:
        for s, v, t in zip(steps, values, _wall_times(len(steps))):
            w.add_scalar(tag, v, s, walltime=t)
    w.close()
    path, = glob.glob(os.path.join(log_dir, 'events.out.tfevents.*'))
    return path


def test_events_are_summary_writers_and_read_back(tmp_path):
    pytest.importorskip('tensorboard')
    from tensorboard.backend.event_processing.event_accumulator import \
        EventAccumulator
    from tensorboard.compat.proto import event_pb2
    batches = _batches(['logz', 'loss', 'x'])
    ours = str(tmp_path / 'ours')
    os.makedirs(ours)
    f = ScalarEventFile(ours)
    for tag, steps, values in batches:
        f.write(tag, steps, values, _wall_times(len(steps)))
    theirs = _summary_writer_file(str(tmp_path / 'theirs'), batches)
    mine, ref = _records(f.path), _records(theirs)
    # the file-version event first, then the scalars byte for byte
    head = event_pb2.Event.FromString(mine[0])
    assert head.file_version == 'brain.Event:2'
    assert head.wall_time == _wall_times(1)[0]
    assert mine[1:] == ref[1:]
    assert len(mine) == 1 + sum(len(b[1]) for b in batches)
    # and whole through EventAccumulator, beside SummaryWriter's own file
    shutil.copy(theirs, ours)
    acc = EventAccumulator(ours, size_guidance={'scalars': 0})
    acc.Reload()
    for tag, steps, values in batches:
        got = acc.Scalars(tag)
        # each (step, value) twice, once from each file (repr: NaN too)
        want = [repr((s, np.float32(v))) for s, v in zip(steps, values)]
        pairs = [repr((e.step, np.float32(e.value))) for e in got]
        assert sorted(pairs) == sorted(want * 2)


def _like():
    return Gaussian(2, 0.0, lim=3)


def _run(log_dir, transform, **run_kw):
    s = NestedSampler(2, _like(), transform=transform, num_live_points=40,
                      log_dir=log_dir, seed=3, device='cpu', log_level=30)
    kw = dict(strategy=['rejection_prior', 'mcmc'], volume_switch=0.5,
              train_iters=5, mcmc_num_chains=8, mcmc_steps=6,
              rejection_batch_size=16, dlogz=0.5)
    kw.update(run_kw)
    s.run(**kw)
    return s


def _host_transform(u):
    return np.tanh(np.asarray(u)) * 3.0 + np.asarray(u) ** 3


@pytest.mark.parametrize('transform', [
    lambda u: 3.0 * u + u ** 3,   # a device (tensor) transform
    _host_transform,              # a host (numpy) transform
], ids=['device', 'host'])
def test_samples_are_the_transform_of_saved_u_row_by_row(transform):
    s = _run(None, transform)
    assert s._host_transform == (transform is _host_transform)
    rows = np.concatenate([s.transform(u) for u in s.saved_u])
    assert s.samples.shape == rows.shape
    assert np.array_equal(s.samples, rows)


def test_a_restored_pool_makes_its_v_at_first_use(tmp_path):
    def sampler():
        return NestedSampler(2, _like(), transform=lambda u: 3.0 * u,
                             num_live_points=50, hidden_dim=16,
                             num_blocks=1, log_dir=str(tmp_path / 'run'),
                             append_run_num=False, resume=True, seed=8,
                             device='cpu')

    sampler()   # makes the run directory
    for name in os.listdir(FORMAT_DIR):
        shutil.copy(os.path.join(FORMAT_DIR, name),
                    tmp_path / 'run' / 'checkpoint')
    s = sampler()
    st = s._load_checkpoint()
    keys = set(st.pool)
    assert 'v' not in keys and st.pool['u'].shape[0] > st.pool_pos
    with recording() as rec:
        worst = int(np.argmin(st.active_logl))
        s._replace_worst(st, worst, float(st.active_logl[worst]))
    assert st.accept_point
    assert rec.counters['evidence_side'] == {'transform_calls': 1}
    assert np.array_equal(st.pool['v'], s.transform(st.pool['u']))
    assert np.array_equal(st.active_v[worst],
                          s.transform(st.active_u[worst])[0])
    # the exact state still writes the pool it read
    assert set(st.pool_state()['pool']) == keys


def test_the_loop_counts_its_side_work_and_every_record_lands(tmp_path):
    pytest.importorskip('tensorboard')
    from tensorboard.backend.event_processing.event_accumulator import \
        EventAccumulator
    with recording() as rec:
        s = _run(str(tmp_path / 'run'), lambda u: 3.0 * u)
    side = rec.counters['evidence_side']
    stats = s.run_stats
    pools = sum(stats[k] for k in stats if k.endswith('_generations'))
    # niter counts one more than the loop's dead points (niter = it + 1)
    assert side['dead'] == len(s.loglikes) - s.num_live_points == s.niter - 1
    assert 1 <= side['transform_calls'] <= pools
    assert 1 <= side['scalar_jobs'] <= pools + stats['checkpoints'] + 1
    files = glob.glob(os.path.join(s.log_dir, 'events.out.tfevents.*'))
    assert len(files) == 2   # the SummaryWriter's and the scalars'
    acc = EventAccumulator(s.log_dir, size_guidance={'scalars': 0})
    acc.Reload()
    logz = acc.Scalars('logz')
    assert [e.step for e in logz] == list(range(1, s.niter))
    loss = acc.Scalars('loss')
    assert [e.step for e in loss] == list(range(1, s.trainer.total_iters + 1))
    walls = [e.wall_time for e in logz]
    assert walls == sorted(walls)


def test_events_file_names_are_distinct_and_made_at_first_write(tmp_path):
    pytest.importorskip('tensorboard')
    a, b = ScalarEventFile(str(tmp_path)), ScalarEventFile(str(tmp_path))
    assert a.path != b.path
    assert os.path.basename(a.path).startswith('events.out.tfevents.')
    assert os.listdir(tmp_path) == []
    a.write('logz', [1], [0.5], [1.7e9])
    assert os.listdir(tmp_path) == [os.path.basename(a.path)]
    a.write('logz', [2], [0.25], [1.8e9])
    from tensorboard.compat.proto import event_pb2
    events = [event_pb2.Event.FromString(r) for r in _records(a.path)]
    assert [e.file_version for e in events] == ['brain.Event:2', '', '']
    assert [e.wall_time for e in events] == [1.7e9, 1.7e9, 1.8e9]
    assert [(e.step, e.summary.value[0].simple_value)
            for e in events[1:]] == [(1, 0.5), (2, 0.25)]
