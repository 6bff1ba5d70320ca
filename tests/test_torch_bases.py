"""The generalised-normal and logit-uniform bases, flow rejection in the
generalised normal's box, and the other flows end to end.

``GeneralisedNormal.log_prob`` against ``scipy.stats.gennorm`` and
nnest_tpu, its gamma-construction draws against the distribution, and its
``usample`` box; ``LogitUniform`` against the logistic pdf. Flow rejection
with that base draws its trials uniform in the box times the enlargement
(nnest_tpu's ``use_usample`` branch): on JAX's own box draws x agrees
within 2e-5 and an accept may differ only where a decision of the
reference sits within tolerance (tests/test_torch_flow_kernels.py). End to
end, each of the NVP, Cholesky and fast-slow flows (and NVP with the
generalised-normal base under flow rejection) builds, trains and samples
the 2-D Gaussian to its analytic evidence."""

import jax
import numpy as np
import pytest
import scipy.stats
import torch

from nnest_tpu import distributions as jd
from nnest_tpu.samplers import kernels as jk
from nnest_torch import NestedSampler
from nnest_torch import distributions as td
from nnest_torch.likelihoods import Gaussian
from nnest_torch.samplers import kernels as tk
from tests.test_torch_flow_kernels import _check, _near
from tests.test_torch_kernels import (_jax_like, _jax_prior, _port_like,
                                      _port_prior)
from tests.test_torch_other_flows import other_flow_pair

# One intra-op thread a process: the suite runs in parallel workers that
# share the cores.
torch.set_num_threads(1)


def test_generalised_normal_and_logit_uniform():
    z = np.random.RandomState(5).normal(scale=1.2, size=(50, 3)).astype(
        np.float32)
    for beta, loc, scale in ((8.0, 0.0, 1.0), (2.0, 0.3, 1.5),
                             (3.5, -0.2, 0.7)):
        base = td.GeneralisedNormal(3, beta=beta, loc=loc, scale=scale)
        want = scipy.stats.gennorm.logpdf(z, beta, loc=loc,
                                          scale=scale).sum(axis=1)
        got = base.log_prob(torch.from_numpy(z)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
        ref = jd.GeneralisedNormal(dim=3, beta=beta, loc=loc, scale=scale)
        np.testing.assert_allclose(got, np.asarray(ref.log_prob(z)),
                                   rtol=1e-5, atol=1e-4)
    base = td.GeneralisedNormal(2)
    assert base.has_usample and not td.DiagNormal(2).has_usample
    g = torch.Generator().manual_seed(0)
    box = base.usample(20000, g)
    assert box.shape == (20000, 2) and bool((box.abs() <= 1.0).all())
    assert float(box.abs().max()) > 0.99
    # the gamma construction draws the distribution: moments and KS
    s = base.sample(20000, g).numpy()
    assert s.shape == (20000, 2) and np.all(np.isfinite(s))
    np.testing.assert_allclose(s.var(axis=0), scipy.stats.gennorm.var(8.0),
                               rtol=0.05)
    assert scipy.stats.kstest(s[:, 0], scipy.stats.gennorm(8.0).cdf
                              ).pvalue > 1e-3
    logistic = td.LogitUniform(3)
    np.testing.assert_allclose(
        logistic.log_prob(torch.from_numpy(z)).numpy(),
        scipy.stats.logistic.logpdf(z).sum(axis=1), rtol=1e-5, atol=1e-5)
    s = logistic.sample(20000, g).numpy()
    assert np.all(np.isfinite(s))
    np.testing.assert_allclose(s.var(axis=0), np.pi ** 2 / 3, rtol=0.05)


def test_rejection_flow_in_the_box_matches_jax():
    """The ``usample`` branch: trials uniform in the generalised normal's
    box times the enlargement, on JAX's own box draws."""
    jm, params, tm = other_flow_pair(3, 'spline', base='GeneralisedNormal')
    jkern = jk.LatentKernels(jm, _jax_like, _jax_prior)
    tkern = tk.LatentKernels(tm, _port_like, _port_prior)
    n, ef, loglstar = 2048, np.float32(2.2), np.float32(-1.2)
    live = np.random.RandomState(10).uniform(-0.9, 0.9, size=(60, 3)).astype(
        np.float32)
    mld, mr = (np.float32(v) for v in jkern._envelope(params, live,
                                                      np.float32(1.1)))
    key = jax.random.PRNGKey(8)
    ref = jkern._rejection_flow(params, key, loglstar, mld, mr, ef,
                                num_trials=n, use_usample=True)
    kz, ku, _ = jax.random.split(key, 3)
    box = np.array(jm.base_dist.usample(kz, n))
    u = np.array(jax.random.uniform(ku, (n,)))
    got = tkern.rejection_flow_body(
        torch.from_numpy(box), None, torch.from_numpy(u), float(loglstar),
        torch.tensor(mld), torch.tensor(mr), float(ef))
    near = _near(jkern, params, ef * box, np.asarray(ref[0]),
                 np.asarray(ref[1]), loglstar, u, mld)
    _check(got, ref, near)
    assert 0 < int(np.asarray(ref[3]).sum()) < n
    g, r, u_t = tkern.rejection_flow_draws(torch.Generator().manual_seed(1),
                                           16, 3)
    assert r is None and g.shape == (16, 3) and bool((g.abs() <= 1).all())


@pytest.mark.parametrize('kw,strategy', [
    (dict(flow='nvp'), ['rejection_prior', 'mcmc']),
    (dict(flow='cholesky'), ['rejection_prior', 'mcmc']),
    (dict(flow='spline', num_slow=1), ['rejection_prior', 'mcmc']),
    (dict(flow='nvp', scale='constant',
          base_dist=td.GeneralisedNormal(2)),
     ['rejection_flow', 'mcmc']),
])
def test_other_flows_give_the_analytic_evidence(tmp_path, kw, strategy):
    like = Gaussian(2, 0.0, lim=3)
    analytic = like.analytic_logz([-3.0, -3.0], [3.0, 3.0])
    s = NestedSampler(2, like, transform=lambda u: 3.0 * u,
                      num_live_points=100, log_dir=str(tmp_path), seed=5,
                      device='cpu', **kw)
    s.run(strategy=strategy, train_iters=30, mcmc_num_chains=10,
          volume_switch=0.5, rejection_batch_size=64, dlogz=0.5)
    assert s.run_stats['trainings'] > 0
    assert abs(s.logz - analytic) <= max(3.0 * s.logzerr, 0.15)
    stats = s.run_stats
    if strategy[0] == 'rejection_prior':
        assert stats['mcmc_generations'] > 0
    else:
        assert stats['rejection_flow_generations'] > 0
    slow = kw.get('num_slow', 0)
    assert (stats['total_fast_calls'] > 0) == (slow > 0)
    assert stats['total_fast_calls'] < s.total_calls
    assert s.oversample_rate == (2 - slow) / 2
