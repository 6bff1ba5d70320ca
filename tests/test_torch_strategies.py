"""The flow strategies and the run diagnostics of ``NestedSampler`` on the
CPU: flow rejection lands on the analytic evidence of the 2-D Gaussian,
flow-density candidates all pass their threshold, and the diagnostics
artifacts carry nnest_tpu's keys and numbers (``logzerr_adjusted``
through nnest_tpu's function; ``threads.npz`` through nnest_tpu's merged
evidence gives back the run's logZ)."""

import json
import os

import numpy as np
import pytest
import torch

from nnest_tpu.utils import evaluation as je
from nnest_torch import NestedSampler
from nnest_torch.likelihoods import Gaussian

# One intra-op thread a process: the suite runs in parallel workers that
# share the cores.
torch.set_num_threads(1)

# the keys of nnest_tpu's results/diagnostics.json
DIAGNOSTICS_KEYS = {
    'insertion_D', 'insertion_p', 'insertion_rolling_p', 'logzerr',
    'logzerr_bootstrap', 'n_ranks', 'mixing_min_ratio',
    'mixing_min_ratio_eig', 'mixing_rel_ratio', 'latent_cond_median',
    'latent_cond_rel', 'n_mix_windows', 'logzerr_adjusted',
    'quality_flags'}


def _gaussian_2d(tmp_path, name, seed=0):
    like = Gaussian(2, 0.0, lim=3)
    sampler = NestedSampler(2, like, transform=lambda u: 3.0 * u,
                            num_live_points=100,
                            log_dir=str(tmp_path / name), seed=seed,
                            device='cpu')
    return like, sampler


def _diagnostics(sampler):
    with open(os.path.join(sampler.log_dir, 'results',
                           'diagnostics.json')) as f:
        return json.load(f)


def test_rejection_flow_evidence_and_artifacts(tmp_path):
    like, sampler = _gaussian_2d(tmp_path, 'flow')
    sampler.run(train_iters=50, dlogz=0.5, strategy=['rejection_flow'])
    analytic = like.analytic_logz([-3.0, -3.0], [3.0, 3.0])
    assert abs(sampler.logz - analytic) <= max(3 * sampler.logzerr, 0.15)
    assert sampler.run_stats['rejection_flow_generations'] > 0
    assert sampler.run_stats['rejection_generations'] == 0

    diag = _diagnostics(sampler)
    assert set(diag) == DIAGNOSTICS_KEYS
    # no chain kernel ran: the mixing fields are null, the bar is sqrt(h/N)
    assert diag['mixing_min_ratio'] is None and diag['n_mix_windows'] == 0
    assert diag['logzerr_adjusted'] == diag['logzerr'] == sampler.logzerr
    assert diag['n_ranks'] == sampler.niter - 1
    assert diag['logzerr_bootstrap'] > 0

    res = os.path.join(sampler.log_dir, 'results')
    ranks = np.load(os.path.join(res, 'insertion_ranks.npy'))
    assert ranks.size == sampler.niter - 1 and ranks.max() < 100
    d, p = je.insertion_ks(ranks, 100)
    assert diag['insertion_D'] == pytest.approx(d, rel=1e-12)
    assert diag['insertion_p'] == pytest.approx(p, rel=1e-12)
    # threads.npz through nnest_tpu's merged-run evidence: the run's logz
    # within 0.01 and its logzerr within 10%
    rec = np.load(os.path.join(res, 'threads.npz'))
    assert int(rec['n_live']) == 100 and float(rec['birth_floor']) == -np.inf
    births = je.thread_birth_logl(rec['logl'], rec['slots'], 100,
                                  birth_floor=float(rec['birth_floor']))
    merged = je.merged_run_evidence(rec['logl'], births)
    assert abs(merged['logz'] - sampler.logz) <= 0.01
    assert abs(merged['logzerr'] / sampler.logzerr - 1.0) <= 0.1


def test_density_flow_candidates_pass_their_threshold(tmp_path):
    _, sampler = _gaussian_2d(tmp_path, 'density', seed=1)
    generations = []
    real = sampler._density_sample

    def capture(loglstar, num_trials=512):
        out = real(loglstar, num_trials=num_trials)
        generations.append((loglstar, out[1]))
        return out

    sampler._density_sample = capture
    sampler.run(train_iters=50, dlogz=0.5, strategy=['density_flow'])
    assert np.isfinite(sampler.logz) and sampler.niter > 100
    assert len(generations) == sampler.run_stats['density_generations'] > 0
    for loglstar, logl in generations:
        assert np.all(logl > loglstar)
    assert set(_diagnostics(sampler)) == DIAGNOSTICS_KEYS


def test_adjusted_logzerr_with_mcmc_at_8d(tmp_path):
    """At x_dim >= 8 with MCMC generations, logzerr_adjusted is
    nnest_tpu's adjusted_logzerr of the run's own per-generation ratios."""
    d = 8
    sampler = NestedSampler(d, Gaussian(d, 0.0), transform=lambda u: 3 * u,
                            num_live_points=40, log_dir=str(tmp_path / 'g8'),
                            seed=3, device='cpu')
    sampler.run(strategy=['mcmc'], max_iters=25, train_iters=5,
                mcmc_steps=6, mcmc_num_chains=12)
    n_gen = sampler.run_stats['mcmc_generations']
    assert n_gen > 0 and len(sampler._mix_rels) == n_gen
    assert len(sampler._cond_infl) == n_gen
    want = je.adjusted_logzerr(sampler.logzerr, sampler._mix_rels, d,
                               cond_rels=sampler._cond_infl)
    diag = _diagnostics(sampler)
    assert diag['logzerr_adjusted'] == pytest.approx(want, rel=1e-12)
    assert diag['logzerr_adjusted'] >= diag['logzerr']
    assert diag['n_mix_windows'] == n_gen
    assert diag['mixing_rel_ratio'] == pytest.approx(
        float(np.median(sampler._mix_rels)), rel=1e-12)
    assert diag['latent_cond_rel'] == pytest.approx(
        float(np.median(sampler._cond_rels)), rel=1e-12)
    assert isinstance(diag['quality_flags'], list)


def test_mcmc_steps_nudge_at_40d(capsys):
    sampler = NestedSampler(40, Gaussian(40, 0.0), num_live_points=8,
                            log_dir=None, device='cpu')
    sampler.run(strategy=['rejection_prior'], max_iters=0,
                rejection_batch_size=16)
    assert 'mcmc_steps defaulted to 5*x_dim = 200' in capsys.readouterr().out
