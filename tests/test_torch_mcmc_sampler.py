"""nnest_torch's MCMCSampler and the collect-chains mode of its Metropolis
kernel against nnest_tpu.

The kernel: the reference's draws are rebuilt with ``jax.random`` from the
key splits of ``nnest_tpu.samplers.kernels._mcmc_impl`` (``split(key,
steps)``; full MH ``k, kp, ku = split(k, 3)``, constrained ``k, kin =
split(k)`` then ``kk, kp, ku = split(kk, 3)`` a proposal; ``kdz, kfast =
split(kp)``) and fed to the port's ``LatentKernels.mcmc``, with the same
converted flow and starts and the dynamic step size on: the trajectories'
x and z within 1e-5, the log likelihoods within 1e-4, the final scale
within 1e-6 relative, and the accept counts and ``ncall`` equal. A
decision within 1e-4 of its threshold (an accept uniform against the
ratio, or a constrained logl against loglstar) could go either way in the
two frameworks; the test counts them and requires none at its seeds.

The sampler: posterior moments on the 2-D Gaussian of tests/test_samplers.py,
the per-chain ``chain_<i>.txt`` files, and the prior evaluated on the
physical point when the sampler transform is the training set's
de-normalisation."""

import os

import jax
import numpy as np
import pytest
import torch

from nnest_torch import MCMCSampler
from nnest_torch.flows import build_flow
from nnest_torch.likelihoods import Gaussian
from nnest_torch.priors import UniformPrior
from nnest_torch.samplers import kernels as tk
from tests.test_torch_kernels import (_port_like, _port_prior,  # noqa: F401
                                      kernel_pair)

# One intra-op thread a process: the suite runs in parallel workers that
# share the cores.
torch.set_num_threads(1)

CHAINS, STEPS, DIM = 32, 20, 3
NEAR = 1e-4


def _jax_draws(key, constrained, proposals, chains=CHAINS, steps=STEPS,
               dim=DIM):
    """The per-step (dz, u, u_fast) lists of ``_mcmc_impl`` on ``key``."""
    out = []
    for k in jax.random.split(key, steps):
        if constrained:
            _, kk = jax.random.split(k)
        keys = []
        for _ in range(proposals):
            if constrained:
                kk, kp, ku = jax.random.split(kk, 3)
            else:
                _, kp, ku = jax.random.split(k, 3)
            keys.append((jax.random.split(kp)[0], ku))
        out.append([(torch.from_numpy(np.array(jax.random.normal(
            kdz, (chains, dim)))), torch.from_numpy(np.array(
                jax.random.uniform(ku, (chains,)))), None)
            for kdz, ku in keys])
    return out


@pytest.mark.parametrize('loglstar,proposals', [(None, 1), (-2.0, 2)])
def test_collect_mode_trajectory_matches_jax(kernel_pair, monkeypatch,
                                             loglstar, proposals):
    jkern, params, tkern, tm = kernel_pair
    rs = np.random.RandomState(4)
    x0 = np.clip(0.5 * rs.normal(size=(CHAINS, DIM)), -1.0, 1.0).astype(
        np.float32)
    with torch.no_grad():
        z0 = tm(torch.from_numpy(x0))[0].numpy()
    logl0 = (-0.5 * np.sum(x0 ** 2, axis=1)).astype(np.float32)
    lp0 = np.zeros(CHAINS, np.float32)
    key = jax.random.PRNGKey(8)
    ref = jkern.mcmc(params, key, z0, logl0, np.zeros((CHAINS, 0),
                                                      np.float32), lp0,
                     loglstar=loglstar, step_size=0.6, mcmc_steps=STEPS,
                     dynamic_step_size=True, prior_volume_steps=proposals,
                     collect_chains=True)
    ref = {k: np.asarray(v) for k, v in ref.items()}

    margins = []
    real_mask = tk._accept_mask

    def recording(u, log_ratio):
        margins.append(torch.abs(
            u - torch.exp(torch.clamp(log_ratio, max=0.0))).min())
        return real_mask(u, log_ratio)

    monkeypatch.setattr(tk, '_accept_mask', recording)
    logls = []
    real_like = tkern.like_fn

    def recording_like(u):
        out = real_like(u)
        logls.append(out[0])
        return out

    monkeypatch.setattr(tkern, 'like_fn', recording_like)
    got = tkern.mcmc(None, torch.from_numpy(z0), torch.from_numpy(logl0),
                     torch.from_numpy(lp0), loglstar=loglstar,
                     step_size=0.6, mcmc_steps=STEPS, dynamic_step_size=True,
                     prior_volume_steps=proposals, collect_chains=True,
                     draws=_jax_draws(key, loglstar is not None, proposals))
    got = {k: v.numpy() if isinstance(v, torch.Tensor) else v
           for k, v in got.items()}
    near = sum(float(m) < NEAR for m in margins)
    if loglstar is not None:
        near += sum(int((torch.abs(ll - loglstar) < NEAR).sum())
                    for ll in logls)
    assert near == 0, near

    assert set(got) == set(ref) - {'derived'}
    assert got['samples'].shape == (CHAINS, STEPS + 1, DIM)
    np.testing.assert_allclose(got['samples'], ref['samples'], rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(got['latent'], ref['latent'], rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(got['loglikes'], ref['loglikes'], rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(got['scale'], ref['scale'], rtol=1e-6)
    for k in ('accepted', 'rejected', 'ncall', 'fast_calls'):
        assert int(got[k]) == int(ref[k]), k
    # some moves and some rejections, and the step size adapted
    assert 0 < int(got['accepted']) < STEPS * CHAINS
    assert float(got['scale']) != pytest.approx(0.6)
    if loglstar is not None:
        assert np.all(got['loglikes'] > loglstar)
        assert 0 < int(got['ncall']) < STEPS * CHAINS
    # the endpoint mode on the same draws ends where the trajectory ends
    end = tkern.mcmc(None, torch.from_numpy(z0), torch.from_numpy(logl0),
                     torch.from_numpy(lp0), loglstar=loglstar,
                     step_size=0.6, mcmc_steps=STEPS, dynamic_step_size=True,
                     prior_volume_steps=proposals,
                     draws=_jax_draws(key, loglstar is not None, proposals))
    np.testing.assert_array_equal(end['final_z'].numpy(),
                                  got['latent'][:, -1])
    assert int(end['accepted']) == int(got['accepted'])


@pytest.fixture(scope='module')
def gauss_problem():
    like = Gaussian(2, 0.0, lim=5)
    training = np.random.RandomState(0).normal(size=(800, 2))
    return like, training


def _prior(lo=-5.0, hi=5.0):
    prior = UniformPrior(2, lo, hi)
    prior.seed(0)
    return prior


def test_mcmc_sampler_posterior_moments(tmp_path, gauss_problem):
    like, training = gauss_problem
    s = MCMCSampler(2, like, prior=_prior(), log_dir=str(tmp_path), seed=1,
                    device='cpu')
    out = s.run(400, 16, training, output_interval=1, train_iters=5)
    assert out.shape == (16, 401, 2) and out is s.samples
    samp = out[:, 100:, :].reshape(-1, 2)
    assert np.all(np.abs(samp.mean(axis=0)) < 0.2)
    assert np.all(np.abs(samp.std(axis=0) - 1.0) < 0.2)
    assert s.latent_samples.shape == (16, 401, 2)
    assert s.loglikes.shape == (16, 401)
    # the chains' log likelihoods are those of their physical points
    np.testing.assert_allclose(
        s.loglikes[:, -1], like(out[:, -1].astype(np.float32)).numpy(),
        rtol=1e-4, atol=1e-4)
    assert np.isfinite(s.scale) and s.scale > 0
    # 16 starts, then 16 calls a step
    assert s.total_calls == 16 + 16 * 400
    assert s.total_accepted + s.total_rejected == 16 * 400
    files = sorted(os.listdir(s.logs['chains']))
    assert files == sorted('chain_%d.txt' % (i + 1) for i in range(16))
    chain = np.loadtxt(os.path.join(s.logs['chains'], 'chain_3.txt'))
    assert chain.shape == (401, 4)
    np.testing.assert_allclose(chain[:, 2:], out[2], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(chain[:, 1], -s.loglikes[2], rtol=1e-5)


def test_prior_sees_the_physical_point(tmp_path):
    """A posterior at 20 (std 0.5) inside the prior box [15, 25]: the
    chains move in the training set's normalised coordinates (~N(0, 1)),
    all outside the box, so a prior evaluated on them is -inf everywhere
    and no start is found; on the de-normalised point it is 0 and the
    chains give the posterior's moments."""
    def loglike(x):
        return -0.5 * torch.sum(((x - 20.0) / 0.5) ** 2, dim=-1)

    training = 20.0 + 0.5 * np.random.RandomState(1).normal(size=(600, 2))
    s = MCMCSampler(2, loglike, prior=_prior(15.0, 25.0),
                    log_dir=str(tmp_path / 'physical'), seed=2, device='cpu')
    s.run(300, 16, training, train_iters=5)
    samp = s.samples[:, 75:, :].reshape(-1, 2)
    assert np.all(np.abs(samp.mean(axis=0) - 20.0) < 0.1)
    assert np.all(np.abs(samp.std(axis=0) - 0.5) < 0.1)
    # host and device prior read the same transform
    u = np.array([[0.0, 0.0], [12.0, 0.0], [-12.0, 0.0]])
    np.testing.assert_array_equal(s.prior(u), [0.0, -np.inf, -np.inf])
    np.testing.assert_allclose(s.transform(u[:1]), [training.mean(axis=0)])
    with torch.no_grad():
        np.testing.assert_array_equal(
            s.kernels.prior_fn(torch.tensor(u, dtype=torch.float32)).numpy(),
            np.float32([0.0, tk.LOG_NEG, tk.LOG_NEG]))
    # a prior of the normalised point finds no start
    normalised = MCMCSampler(2, loglike, prior=_prior(15.0, 25.0),
                             log_dir=str(tmp_path / 'normalised'), seed=2,
                             transform_prior=False, device='cpu')
    with pytest.raises(RuntimeError, match='Could not find starting value'):
        normalised.run(300, 16, training, train_iters=1)


def test_full_mh_fast_moves_count_their_calls():
    """Fast-slow flow, full MH, every proposal fast-only: each step's calls
    are fast calls, and the slow dim of every trajectory stays put."""
    tm = build_flow(3, num_slow=1, seed=2, device='cpu')
    tm.data_init(torch.randn(64, 3,
                             generator=torch.Generator().manual_seed(0)))
    kern = tk.LatentKernels(tm, _port_like, _port_prior, num_slow=1,
                            oversample_rate=1.0)
    z0 = 0.3 * torch.randn(8, 3, generator=torch.Generator().manual_seed(1))
    x0, _ = kern._hot_inverse()(z0)
    out = kern.mcmc(torch.Generator().manual_seed(2), z0, kern.like_fn(x0)[0],
                    kern.prior_fn(x0), step_size=0.5, mcmc_steps=4,
                    collect_chains=True)
    assert int(out['fast_calls']) == int(out['ncall']) == 8 * 4
    assert int(out['accepted']) > 0
    assert torch.equal(out['samples'][:, :, 0],
                       x0[:, None, 0].expand(-1, 5))
