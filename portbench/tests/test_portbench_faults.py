"""The comparison that decides ``correct`` against a timed path broken
underneath: each run here skips the harness's look for a card (it calls
``run_cell`` on the CPU at a tiny size of the deep band) and drives the rest
of a run. A sound run comes out correct; each fault a cell can have comes
out not correct. (The cells run on one chip: there is no exchange between
chips to leave out.)"""

import numpy as np
import pytest
import torch

from harness import cells
from harness.bench import run_cell

torch.set_num_threads(1)

CONFIG = {'likelihood': {'kind': 'gaussian', 'x_dim': 4, 'corr': 0.9,
                         'lim': 3.0},
          'num_live_points': 100, 'hidden_dim': 16,
          'run': {'mcmc_steps': 20, 'mcmc_num_chains': 16,
                  'mcmc_adapt': 'cov', 'mcmc_gen_batch': 8,
                  'train_iters': 30, 'update_interval': 50, 'dlogz': 0.5}}


def _run(seed=2 ** 31 + 77, gen_batch=8):
    traffic = dict(cells.traffic('band_r10'), radius=3.0, max_iters=150,
                   warmup_iters=10, inverse_sample_stride=7)
    config = dict(CONFIG, run=dict(CONFIG['run'], mcmc_gen_batch=gen_batch))
    return run_cell('gauss16.deep', config, traffic,
                    cells.limits('gauss16.deep'), seed, 0.0, False, [], [],
                    device='cpu')


def _state_unchanged(monkeypatch):
    """The device's replay of a pool's consumption returns the live set
    as it came: the next generation starts from a stale live set."""
    from nnest_torch.samplers import kernels

    def unchanged(au, al, ad, it, *args, **kwargs):
        return au, al, ad, it, torch.tensor(False)
    monkeypatch.setattr(kernels, 'consume_pool', unchanged)


def _half_the_live_set(monkeypatch):
    """The worst point searched for in half of the live set only (one
    generation a dispatch: with the prefetch the device's replay of the
    consumption disagrees first, and the job fails)."""
    from nnest_torch.samplers import nested

    class HalfNumpy:
        def __getattr__(self, name):
            return getattr(np, name)

        @staticmethod
        def argmin(a, *args, **kwargs):
            a = np.asarray(a)
            if a.ndim == 1 and a.shape[0] == CONFIG['num_live_points']:
                return np.argmin(a[:a.shape[0] // 2])
            return np.argmin(a, *args, **kwargs)
    monkeypatch.setattr(nested, 'np', HalfNumpy())


def _answer_altered(monkeypatch):
    """A chain endpoint's likelihood altered where it is produced."""
    from nnest_torch.samplers.kernels import LatentKernels
    real = LatentKernels.mcmc

    def mcmc(self, *args, **kwargs):
        out = real(self, *args, **kwargs)
        if 'final_logl' in out:
            out['final_logl'] = out['final_logl'] + 0.05
        return out
    monkeypatch.setattr(LatentKernels, 'mcmc', mcmc)


def _inverse_altered(monkeypatch):
    """The spline inverse's output altered where it is produced."""
    from nnest_torch.ops import spline_inverse as si
    real = si._inverse_body

    def body(z, packed, *args, **kwargs):
        x, logdet = real(z, packed, *args, **kwargs)
        return x + 1e-2, logdet
    monkeypatch.setattr(si, '_inverse_body', body)


def test_a_sound_run_is_correct():
    result = _run()
    assert result['correct'], result['checks']
    assert result['attempted'] == 1 and result['failed'] == 0


def test_the_prior_band_is_correct():
    """The band of the cell left out of BENCHMARK.json for now: from the
    prior, a fresh sampler a job, no Metropolis generation."""
    traffic = dict(cells.traffic('prior_3000'), max_iters=150,
                   warmup_iters=10, inverse_sample_stride=7)
    result = run_cell('gauss16.prior', CONFIG, traffic,
                      cells.limits('gauss16.prior'), 2 ** 31 + 5, 0.0,
                      False, [], [], device='cpu')
    assert result['correct'], result['checks']
    assert result['checks']['forbidden_generations']['value'] == 0


@pytest.mark.parametrize('fault,caught_by,gen_batch', [
    (_state_unchanged, 'failed_jobs', 8),
    (_half_the_live_set, 'order_violations', 1),
    (_half_the_live_set, 'failed_jobs', 8),
    (_answer_altered, 'logl_gap', 8),
    (_inverse_altered, 'inverse_x_gap', 8),
])
def test_a_fault_is_not_correct(monkeypatch, fault, caught_by, gen_batch):
    fault(monkeypatch)
    result = _run(gen_batch=gen_batch)
    assert not result['correct']
    check = result['checks'][caught_by]
    assert check['value'] > check['limit'], result['checks']


def test_the_control_leaves_tf32_as_it_was():
    """A control run in a process leaves the float32 contract to the runs
    after it."""
    traffic = dict(cells.traffic('band_r10'), radius=3.0, max_iters=30,
                   warmup_iters=10, inverse_sample_stride=7)
    before = torch.backends.cuda.matmul.allow_tf32
    run_cell('gauss16.deep', CONFIG, traffic, cells.limits('gauss16.deep'),
             5, 0.0, False, [], [], device='cpu', control='tf32')
    assert torch.backends.cuda.matmul.allow_tf32 == before
    assert torch.backends.cudnn.allow_tf32 is False
