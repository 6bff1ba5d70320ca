"""The port's command-line drivers on the CPU: the nested CLI on the tiny
configuration of tests/test_cli_analyse.py, nnest_tpu's analyse script
and the port's printing the same lines for the same run directories, and
both samplers of the ensemble CLI at a few steps."""

import argparse
import contextlib
import importlib.util
import io
import os

import numpy as np
import pytest
import torch

from nnest_torch.cli import analyse, ensemble, nested

# One intra-op thread a process: the suite runs in parallel workers that
# share the cores.
torch.set_num_threads(1)

ROOT = os.path.realpath(os.path.join(os.path.dirname(__file__), '..'))


def _nested_args(log_dir, seed):
    """tests/test_cli_analyse.py's tiny configuration, on the CPU."""
    return argparse.Namespace(
        x_dim=2, train_iters=50, mcmc_steps=0, mcmc_num_chains=10,
        num_live_points=100, mcmc_fixed_step_size=False, switch=-1,
        hidden_dim=16, num_layers=1, flow='spline', num_blocks=3,
        jitter=-1, num_slow=0, log_dir=log_dir, likelihood='gaussian',
        log_suffix='', base_dist='', scale='', beta=8.0, corr=0.0,
        strategy='', dlogz=0.5, rejection_batch_size=256, seed=seed,
        mcmc_gen_batch=8, rejection_gen_batch=8, resume=False,
        max_iters=1000000, device='cpu')


@pytest.fixture(scope='module')
def cli_logs(tmp_path_factory):
    """Two runs of the port's nested CLI (seeds 1 and 2) under one root."""
    logs = str(tmp_path_factory.mktemp('cli') / 'logs')
    samplers = [nested.main(_nested_args(logs, seed)) for seed in (1, 2)]
    return logs, samplers


def test_nested_cli_writes_the_artifacts(cli_logs):
    logs, samplers = cli_logs
    for i, s in enumerate(samplers):
        run = os.path.join(logs, 'gaussian', 'run%d' % (i + 1))
        assert s.log_dir == run
        for rel in ('info/params.txt', 'results/final.csv',
                    'results/results.csv', 'results/diagnostics.json',
                    'results/threads.npz', 'chains/chain.txt'):
            assert os.path.exists(os.path.join(run, rel)), rel
        w, logl, samp = analyse.read_chain(
            os.path.join(run, 'chains', 'chain.txt'))
        assert samp.shape == (s.niter - 1 + 100, 2)
        assert np.all(w >= 0) and np.all(np.isfinite(logl))
        np.testing.assert_allclose(logl, s.loglikes, rtol=1e-5)
    # argparse gives the same defaults as the namespace above, plus cuda
    args = nested.build_parser().parse_args([])
    assert (args.num_live_points, args.train_iters, args.mcmc_num_chains,
            args.likelihood, args.device) == (1000, 2000, 10, 'rosenbrock',
                                              'cuda')


def _stdout(fn, args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(args)
    return buf.getvalue()


def test_analyse_prints_what_nnest_tpu_prints(cli_logs):
    """nnest_tpu's examples/nested/analyse.py and the port's, on the same
    port-written root (two runs, merged), print the same lines."""
    logs, _ = cli_logs
    spec = importlib.util.spec_from_file_location(
        'jax_analyse', os.path.join(ROOT, 'examples', 'nested', 'analyse.py'))
    jax_analyse = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_analyse)
    args = analyse.build_parser().parse_args(
        ['--root', os.path.join(logs, '*'), '--dim', '2', '--merge',
         '--merge_chain'])
    port_out = _stdout(analyse.main, args)
    assert _stdout(jax_analyse.main, args) == port_out
    for line in ('Dim: 2 (2 runs)', 'logz=', 'Num runs: 2', 'Posterior ESS',
                 'Insertion p', 'Merged logZ (combined run)',
                 'Merged posterior chain'):
        assert line in port_out, line


@pytest.mark.parametrize('sampler', ['mcmc', 'ensemble'])
def test_ensemble_cli(tmp_path, sampler):
    """Both samplers of the ensemble CLI on the 2-D Rosenbrock in its box
    prior, at a few steps: samples of the expected shape inside the prior,
    finite, and the flag defaults of nnest_tpu's script."""
    args = ensemble.build_parser().parse_args(
        ['--sampler', sampler, '--mcmc_steps', '20', '--mcmc_num_chains',
         '4', '--num_walkers', '8', '--bootstrap_steps', '40',
         '--num_training_samples', '100', '--hidden_dim', '16',
         '--log_dir', str(tmp_path), '--device', 'cpu'])
    s = ensemble.main(args)
    chains = 4 if sampler == 'mcmc' else 8
    assert s.samples.shape == (chains, 21, 2)
    assert np.all(np.isfinite(s.samples)) and np.all(np.isfinite(s.loglikes))
    assert np.all((s.samples >= -2) & (s.samples <= 5))
    assert os.path.exists(os.path.join(s.log_dir, 'models', 'netG.pkl'))
    defaults = ensemble.build_parser().parse_args([])
    assert (defaults.mcmc_steps, defaults.mcmc_num_chains,
            defaults.num_walkers, defaults.bootstrap_steps,
            defaults.device) == (10000, 16, 64, 500, 'cuda')


def test_cli_refuses_a_missing_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip('a GPU is present: the default device is usable')
    args = _nested_args(str(tmp_path), 0)
    del args.device   # the default: cuda
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        nested.main(args)
    eargs = ensemble.build_parser().parse_args(['--log_dir', str(tmp_path)])
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        ensemble.main(eargs)
