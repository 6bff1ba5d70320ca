"""The port's main path on the CPU: likelihoods and prior against
nnest_tpu's, the trainer's optimizer against nnest_tpu's optax chain, and
``NestedSampler`` end to end on the 2-D Gaussian whose evidence is
analytic (the tests/test_nested.py oracle)."""

import csv
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nnest_tpu import likelihoods as jax_likes
from nnest_tpu.training.trainer import trainable_mask
from nnest_torch import NestedSampler, Trainer
from nnest_torch import likelihoods as port_likes
from nnest_torch.flows import params_from_jax, params_to_jax
from nnest_torch.priors import UniformPrior
from tests.test_torch_flows import flow_pair

# One intra-op thread a process: the suite runs in parallel workers that
# share the cores.
torch.set_num_threads(1)


def test_likelihoods_and_prior_match_jax():
    x = np.random.RandomState(0).uniform(-3, 3, size=(64, 3))
    for jl, pl in ((jax_likes.Gaussian(3, 0.3), port_likes.Gaussian(3, 0.3)),
                   (jax_likes.Gaussian(3, 0.0, lim=3),
                    port_likes.Gaussian(3, 0.0, lim=3)),
                   (jax_likes.Rosenbrock(3), port_likes.Rosenbrock(3))):
        t = pl(torch.as_tensor(x, dtype=torch.float32))
        assert t.dtype == torch.float32 and t.shape == (64,)
        np.testing.assert_allclose(t.numpy(), jl(x), rtol=1e-6, atol=1e-5)
    # corr 0: closed-form erf terms, equal to rounding. corr 0.3: scipy's
    # randomised quasi-Monte-Carlo rectangle probability, whose default
    # absolute error target is 1e-5 on a mass near 1, so two calls differ
    # by up to ~1e-5 in log mass.
    for corr, tol in ((0.0, 1e-12), (0.3, 5e-5)):
        lo, hi = [-3.0] * 3, [3.0] * 3
        assert port_likes.Gaussian(3, corr).analytic_logz(lo, hi) == \
            pytest.approx(jax_likes.Gaussian(3, corr).analytic_logz(lo, hi),
                          abs=tol)
    prior = UniformPrior(3, -1.0, 1.0)
    lp = prior.logpdf(torch.tensor([[0.0, 0.5, -1.0], [0.0, 1.01, 0.0]]))
    assert lp.tolist() == [0.0, -np.inf]


def test_adam_step_matches_jax_optax():
    """Two optimizer steps from the same params on the same batch: the
    trainer's Adam with coupled L2 equals nnest_tpu's optax chain
    (decay, Adam, -lr, zero updates on '_' buffers)."""
    from nnest_tpu.training.trainer import Trainer as JaxTrainer
    jm, params, tm = flow_pair(3)
    batch = np.random.RandomState(2).normal(size=(40, 3)).astype(np.float32)
    jt = JaxTrainer(3, log_dir=None, learning_rate=1e-3, weight_decay=1e-2,
                    log=False)
    jt.params = params
    jt._init_optimizer()
    loss_j = jax.jit(jax.grad(
        lambda p: -jnp.mean(jm.log_prob(p, jnp.asarray(batch)))))
    p, state = params, jt._opt_state
    for _ in range(2):
        updates, state = jt._opt.update(loss_j(p), state, p)
        p = optax.apply_updates(p, updates)

    pt = Trainer(3, learning_rate=1e-3, weight_decay=1e-2, log=False,
                 device='cpu')
    pt.ensure_init(batch)
    params_from_jax(pt.model, jax.tree.map(np.asarray, params))
    for _ in range(2):
        loss = -torch.mean(pt.model.log_prob(torch.from_numpy(batch)))
        pt.optimizer.zero_grad()
        loss.backward()
        pt.optimizer.step()
    mask = jax.tree.leaves(trainable_mask(params))
    for got, want, m in zip(jax.tree.leaves(params_to_jax(pt.model)),
                            jax.tree.leaves(p), mask):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5,
                                   atol=2e-6)
    assert not all(mask)  # the frozen '_P' leaves are in the comparison


def test_trainer_early_stops_and_keeps_best():
    x = np.random.RandomState(1).normal(size=(95, 2)).astype(np.float32)
    t = Trainer(2, batch_size=20, learning_rate=1e-2, log=False, seed=3,
                device='cpu')
    t.train(x, max_iters=30, jitter=-1.0, patience=3)
    assert t.last_training_jitter > 0
    assert np.isfinite(t.best_validation_loss)
    assert 1 <= t.best_validation_epoch <= t.total_iters <= 30
    assert np.all(np.isfinite(t.log_probs(x, to_numpy=True)))


@pytest.mark.parametrize('strategy', [None, ['mcmc']])
def test_gaussian_2d_analytic_logz(tmp_path, strategy):
    """The default ladder (rejection only at 2-D) and the MCMC kernel
    alone both land within max(3 logzerr, 0.15) of the analytic logZ and
    write the artifact files."""
    like = port_likes.Gaussian(2, 0.0, lim=3)
    sampler = NestedSampler(2, like, transform=lambda u: 3.0 * u,
                            num_live_points=100,
                            log_dir=str(tmp_path / 'gauss'), seed=0,
                            device='cpu')
    sampler.run(train_iters=50, dlogz=0.5, strategy=strategy)
    analytic = like.analytic_logz([-3.0, -3.0], [3.0, 3.0])
    assert abs(sampler.logz - analytic) <= max(3 * sampler.logzerr, 0.15)
    if strategy == ['mcmc']:
        assert sampler.run_stats['mcmc_generations'] > 0
        assert sampler.run_stats['trainings'] >= 1
    run = sampler.log_dir
    for rel in ('info/params.txt', 'results/results.csv',
                'results/final.csv', 'chains/chain.txt'):
        assert os.path.exists(os.path.join(run, rel)), rel
    with open(os.path.join(run, 'results', 'results.csv')) as f:
        assert next(csv.reader(f)) == [
            'step', 'acceptance', 'min_ess', 'max_ess', 'jump_distance',
            'scale', 'loglstar', 'logz', 'fraction_remain', 'ncall']
    chain = np.loadtxt(os.path.join(run, 'chains', 'chain.txt'))
    assert chain.shape == (sampler.niter - 1 + 100, 4)


def test_unported_strategy_is_refused(tmp_path):
    sampler = NestedSampler(2, port_likes.Gaussian(2, 0.0), log_dir=None,
                            device='cpu')
    with pytest.raises(ValueError, match='unknown strategy'):
        sampler.run(strategy=['rejection_prior', 'slcie'])
