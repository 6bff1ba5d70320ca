"""NestedSampler.prewarm and ``python -m nnest_torch.cli.nested --prewarm``
on the CPU: the counterpart of tests/test_nested.py's prewarm test at its
configuration (the 2-D Gaussian, 100 live points, seed 42,
``train_iters=50``, ``dlogz=0.5``) with ``device='cpu'``.

- ``prewarm`` returns a wall a method, leaves the sampler's generator,
  ``total_calls`` and the global torch generator as they were, refuses an
  unknown method, and the run after it equals a never-prewarmed twin's in
  (logz, h, total_calls); the sampler's INFO log lines still reach the
  caller after the throwaway samplers set their shared loggers to WARNING.
- The command line with ``--prewarm`` prints the walls and the run time,
  writes no run directory and leaves no temporary directory.
"""

import os
import tempfile

import pytest
import torch

from nnest_torch import NestedSampler
from nnest_torch.cli import nested as cli_nested
from nnest_torch.likelihoods import Gaussian

# One intra-op thread a process: the suite runs in parallel workers that
# share the cores.
torch.set_num_threads(1)


def _sampler(log_dir):
    return NestedSampler(2, Gaussian(2, 0.0, lim=3),
                         transform=lambda x: 3 * x, num_live_points=100,
                         log_dir=log_dir, resume=False, seed=42,
                         device='cpu')


def test_prewarm_leaves_the_sampler_untouched(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(tempfile, 'tempdir', str(tmp_path))
    s = _sampler(str(tmp_path / 'pw'))
    state = s.generator.get_state().clone()
    global_state = torch.random.get_rng_state().clone()
    walls = s.prewarm(strategy=['rejection_prior', 'slice'],
                      train_iters=50, mcmc_num_chains=8, slice_steps=4,
                      rejection_batch_size=32)
    assert set(walls) == {'rejection_prior', 'slice'}
    assert all(w >= 0 for w in walls.values())
    assert s.total_calls == 0
    assert torch.equal(s.generator.get_state(), state)
    assert torch.equal(torch.random.get_rng_state(), global_state)
    # the throwaway runs' directories are gone
    assert not [f for f in os.listdir(str(tmp_path))
                if f.startswith('nnest_prewarm_')]
    with pytest.raises(ValueError, match='unknown strategy'):
        s.prewarm(strategy=['nope'])
    out = capsys.readouterr().out
    assert "Prewarmed 'rejection_prior'" in out and "Prewarmed 'slice'" in out
    # the real run is bit-identical to a twin that never prewarmed
    s.run(train_iters=50, dlogz=0.5)
    assert 'Phase timers: ' in capsys.readouterr().out
    twin = _sampler(str(tmp_path / 'plain'))
    twin.run(train_iters=50, dlogz=0.5)
    assert (s.logz, s.h, s.total_calls) == (twin.logz, twin.h,
                                            twin.total_calls)


def test_cli_prewarm_prints_walls_and_writes_no_run(tmp_path, monkeypatch,
                                                    capsys):
    monkeypatch.setattr(tempfile, 'tempdir', str(tmp_path / 'tmp'))
    os.makedirs(str(tmp_path / 'tmp'))
    args = cli_nested.build_parser().parse_args(
        ['--prewarm', '--device', 'cpu', '--likelihood', 'gaussian',
         '--corr', '0.0', '--x_dim', '2', '--num_live_points', '100',
         '--train_iters', '10', '--mcmc_num_chains', '8',
         '--log_dir', str(tmp_path / 'logs')])
    s = cli_nested.main(args)
    out = capsys.readouterr().out
    assert "Prewarm walls (s): {'rejection_prior': " in out
    assert "'mcmc': " in out and 'Run time ' in out
    assert s.total_calls == 0 and s.logs is None
    assert not os.path.exists(str(tmp_path / 'logs'))
    assert not [f for f in os.listdir(str(tmp_path / 'tmp'))
                if f.startswith('nnest_prewarm_')]
