"""Checkpoints and resume of ``NestedSampler`` on the CPU.

A run killed at ``max_iters=120`` and resumed by a sampler built with
another seed finishes with the uninterrupted run's (logz, h, total_calls,
niter), to the bit: every random draw after the live set comes from the
generators the checkpoint restores. A corrupt exact state, an exact state
stamped with another iteration and a corrupt newest checkpoint each
degrade to a statistically exact resume that completes. A checkpoint
committed under ``tests/data/`` is read and written back unchanged, so the
format stays readable."""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from nnest_torch import NestedSampler
from nnest_torch.likelihoods import Gaussian
from nnest_torch.samplers.nested import EXACT_STATE

# One intra-op thread a process: the suite runs in parallel workers that
# share the cores.
torch.set_num_threads(1)

LIKE = Gaussian(2, 0.0, lim=3)
ANALYTIC = LIKE.analytic_logz([-3.0, -3.0], [3.0, 3.0])
RUN = dict(train_iters=30, mcmc_num_chains=10, mcmc_steps=10,
           rejection_batch_size=32, dlogz=0.5)


def _sampler(log_dir, seed):
    return NestedSampler(2, LIKE, transform=lambda u: 3.0 * u,
                         num_live_points=100, log_dir=str(log_dir),
                         append_run_num=False, resume=True, seed=seed,
                         device='cpu')


def _final(s):
    return (s.logz, s.h, s.total_calls, s.niter)


@pytest.mark.parametrize('strategy,extra', [
    # the default ladder, switched to MCMC by volume
    (None, {'volume_switch': 0.5}),
    # flow rejection with a retrain every update_interval (no NLL gate):
    # the envelope cache, the trainer and its Adam state cross the resume
    (['rejection_flow', 'mcmc'], {'retrain_nll_threshold': None}),
    # slice generations after a volume switch: the shrinkage loop's
    # data-dependent draws and the slice pool cross the resume
    (['rejection_prior', 'slice'], {'volume_switch': 0.5}),
])
def test_kill_and_resume_is_bit_exact(tmp_path, strategy, extra):
    kw = dict(RUN, strategy=strategy, **extra)
    whole = _sampler(tmp_path / 'whole', 7)
    whole.run(**kw)
    killed = _sampler(tmp_path / 'killed', 7)
    killed.run(max_iters=120, **kw)
    assert killed.niter < whole.niter
    ck = os.path.join(killed.log_dir, 'checkpoint')
    assert os.path.exists(os.path.join(ck, 'checkpoint_120.txt'))
    markers = [f for f in os.listdir(ck) if f.startswith('checkpoint_')]
    assert killed.run_stats['checkpoints'] == len(markers) > 1
    assert killed.run_stats['checkpoint_s'] > 0.0
    for name in ('active_u_120.npy', 'active_v_120.npy',
                 'active_logl_120.npy', 'saved_v.npy', 'saved_logl.npy',
                 'saved_logwt.npy', 'saved_slots.npy', EXACT_STATE):
        assert os.path.exists(os.path.join(ck, name)), name
    resumed = _sampler(tmp_path / 'killed', 99)
    resumed.run(**kw)
    assert _final(resumed) == _final(whole)
    np.testing.assert_array_equal(resumed.insertion_ranks,
                                  whole.insertion_ranks)
    np.testing.assert_array_equal(resumed.thread_slots, whole.thread_slots)
    if strategy is None:
        assert whole.run_stats['mcmc_generations'] > 0
    elif 'slice' in strategy:
        assert whole.run_stats['slice_generations'] > 0
        assert resumed.run_stats['slice_generations'] > 0
    else:
        assert whole.run_stats['rejection_flow_generations'] > 0
        assert resumed.run_stats['trainings'] > 0


@pytest.fixture(scope='module')
def killed_dir(tmp_path_factory):
    """A run of the default ladder killed at max_iters=120."""
    path = tmp_path_factory.mktemp('killed') / 'run'
    _sampler(path, 7).run(max_iters=120, **RUN)
    return path


def _copy(killed_dir, tmp_path):
    dst = tmp_path / 'run'
    shutil.copytree(killed_dir, dst)
    return dst, os.path.join(dst, 'checkpoint')


def _resume_completes(path):
    s = _sampler(path, 8)
    s.run(**RUN)
    assert abs(s.logz - ANALYTIC) <= 0.6
    return s


def test_corrupt_exact_state_degrades(killed_dir, tmp_path, capsys):
    path, ck = _copy(killed_dir, tmp_path)
    with open(os.path.join(ck, EXACT_STATE), 'wb') as f:
        f.write(b'not a torch file')
    state = _sampler(path, 8)._load_checkpoint()
    assert state.it == 120
    assert state.current_method is None and state.pool is None
    assert 'statistically (not bit-) exact' in capsys.readouterr().out
    _resume_completes(path)


def test_stamp_mismatch_drops_the_pool(killed_dir, tmp_path, capsys):
    path, ck = _copy(killed_dir, tmp_path)
    es_path = os.path.join(ck, EXACT_STATE)
    es = torch.load(es_path, weights_only=True)
    assert es['it'] == 120 and es['pool'] is not None
    es['it'] += 1   # the state ran ahead of its marker
    torch.save(es, es_path)
    s = _sampler(path, 8)
    state = s._load_checkpoint()
    assert state.it == 120
    assert state.current_method is None and state.pool is None
    # the generator and trainer states are still valid and restored
    assert torch.equal(s.generator.get_state(), es['generator'])
    assert state.insertion_ranks == es['insertion_ranks'][:120].tolist()
    assert 'Exact state is from iteration 121' in capsys.readouterr().out
    _resume_completes(path)


def test_corrupt_newest_checkpoint_falls_back(killed_dir, tmp_path, capsys):
    path, ck = _copy(killed_dir, tmp_path)
    with open(os.path.join(ck, 'active_u_120.npy'), 'wb') as f:
        f.write(b'truncated')
    state = _sampler(path, 8)._load_checkpoint()
    assert state.it == 100 and len(state.saved_logl) == 100
    # the exact state is stamped 120: statistically exact from 100
    assert state.current_method is None and state.pool is None
    out = capsys.readouterr().out
    assert 'Checkpoint 120 unusable' in out
    s = _resume_completes(path)
    assert s.niter > 100


# A checkpoint of the format: a 2-D Gaussian with 50 live points (a flow of
# one block, 16 hidden units), the default ladder at volume_switch=0.5,
# RUN's options with log_interval=20, seed 8, killed at max_iters=120:
# Metropolis by then, its pool part consumed and one generation buffered.
FORMAT_DIR = os.path.join(os.path.dirname(__file__), 'data', 'checkpoint_2d')


def _assert_same(got, want, where='exact state'):
    assert type(got) is type(want), where
    if isinstance(want, torch.Tensor):
        assert got.dtype == want.dtype and torch.equal(got, want), where
    elif isinstance(want, dict):
        assert list(got) == list(want), where
        for k in want:
            _assert_same(got[k], want[k], '%s[%r]' % (where, k))
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, '%s[%d]' % (where, i))
    else:
        assert got == want, where


def test_checkpoint_format_round_trips(tmp_path):
    def sampler():
        return NestedSampler(2, LIKE, transform=lambda u: 3.0 * u,
                             num_live_points=50, hidden_dim=16,
                             num_blocks=1, log_dir=str(tmp_path / 'run'),
                             append_run_num=False, resume=True, seed=8,
                             device='cpu')

    sampler()   # makes the run directory
    for name in os.listdir(FORMAT_DIR):
        shutil.copy(os.path.join(FORMAT_DIR, name),
                    tmp_path / 'run' / 'checkpoint')
    s = sampler()
    state = s._load_checkpoint()
    assert state.it == 120 and state.current_method == 'mcmc'
    assert state.pool is not None and len(state.mcmc_buf) == 1
    with open(os.path.join(FORMAT_DIR, 'checkpoint_120.txt')) as f:
        meta = json.load(f)
    out = tmp_path / 'out'
    out.mkdir()
    s.logs['checkpoint'] = str(out)
    s._write_checkpoint(state, meta['strategy'])
    s._drain_io()
    assert sorted(os.listdir(out)) == sorted(os.listdir(FORMAT_DIR))
    for name in os.listdir(FORMAT_DIR):
        want_path, got_path = os.path.join(FORMAT_DIR, name), out / name
        if name.endswith('.npy'):
            want, got = np.load(want_path), np.load(got_path)
            assert got.dtype == want.dtype, name
            np.testing.assert_array_equal(got, want, err_msg=name)
        elif name.endswith('.txt'):
            with open(got_path) as f:
                assert json.load(f) == meta
        else:
            want = torch.load(want_path, weights_only=True)
            got = torch.load(got_path, weights_only=True)
            _assert_same(got, want)
