"""Host likelihoods, transforms and priors in ``nnest_torch`` on the CPU.

A likelihood (or transform) that does not return a tensor for a (2, d)
float32 tensor on the sampler's device is called on the host with float64
numpy of the transformed points, as ``nnest_tpu`` calls a likelihood it
cannot trace (``_host_batch_callback``); its result reaches the kernels as
float32 on the device. The probe that tells the two kinds apart costs no
counted call. A prior without ``logpdf`` is called once a point, as
``nnest_tpu``'s ``safe_prior`` does, on the host wrapper and inside the
kernels."""

import numpy as np
import pytest
import torch

from nnest_torch import MCMCSampler, NestedSampler
from nnest_torch.likelihoods import Gaussian
from nnest_torch.priors import UniformPrior
from nnest_torch.samplers import kernels as tk
from nnest_torch.samplers.base import Sampler
from tests.test_blackbox_likelihood import NumpyOnlyGaussian

# One intra-op thread a process: the suite runs in parallel workers that
# share the cores.
torch.set_num_threads(1)


class TensorRefusing:
    """-|x|^2 / 2 of numpy rows; raises on a tensor and records what it
    was given."""

    def __init__(self):
        self.inputs = []

    def __call__(self, x):
        if isinstance(x, torch.Tensor):
            raise TypeError('numpy only')
        self.inputs.append(x)
        out = -0.5 * np.sum(np.asarray(x) ** 2, axis=1)
        out[np.asarray(x)[:, 0] > 2.5] = np.nan
        return out


def test_host_likelihood_gets_float64_numpy_of_the_transform():
    like = TensorRefusing()
    s = Sampler(2, like, transform=lambda u: 3.0 * u, log_dir=None,
                device='cpu')
    assert s._host_loglike and not s._host_transform
    assert s.total_calls == 0 and like.inputs == []   # the probe raised
    u = np.array([[0.1, -0.2], [0.9, 0.0], [-0.5, 0.5]])
    logl, derived = s.loglike(u)
    assert derived.shape == (3, 0)
    (x,) = like.inputs
    assert type(x) is np.ndarray and x.dtype == np.float64
    np.testing.assert_array_equal(x, 3.0 * u)
    want = -0.5 * np.sum((3.0 * u) ** 2, axis=1)
    want[1] = -1e100                  # NaN beyond x = 2.5, clamped
    np.testing.assert_array_equal(logl, want)
    assert s.total_calls == 3
    # inside the kernels: float32 on the device, non-finite -> LOG_NEG
    got, derived = s.kernels.like_fn(torch.tensor(u, dtype=torch.float32))
    assert got.dtype == torch.float32 and derived is None
    np.testing.assert_allclose(got.numpy(), [logl[0], tk.LOG_NEG, logl[2]],
                               rtol=1e-6)
    assert like.inputs[-1].dtype == np.float64 and s.total_calls == 3


def test_probe_sorts_callables_and_costs_no_call():
    """A likelihood that returns numpy for a tensor is a host one too, and
    then gets numpy; the zoo's tensor likelihoods stay on the device
    path; a host transform feeds a tensor likelihood through float64."""
    seen = []

    def numpy_out(x):
        seen.append(type(x))
        return -np.sum(np.asarray(x) ** 2, axis=1)

    s = Sampler(2, numpy_out, log_dir=None, device='cpu')
    assert s._host_loglike and s.total_calls == 0
    seen.clear()
    s.loglike(np.zeros((4, 2)))
    assert seen == [np.ndarray] and s.total_calls == 4

    zoo = Gaussian(2, 0.0)

    def host_transform(u):
        if isinstance(u, torch.Tensor):
            raise TypeError('numpy only')
        return np.exp(u)

    t = Sampler(2, zoo, transform=host_transform, log_dir=None, device='cpu')
    assert not t._host_loglike and t._host_transform and t.total_calls == 0
    u = np.array([[0.0, 1.0], [-1.0, 0.5]])
    np.testing.assert_array_equal(t.transform(u), np.exp(u))
    with torch.no_grad():
        ref = zoo(np.exp(u)).numpy()
    np.testing.assert_allclose(t.loglike(u)[0], ref, rtol=1e-6)
    out = t._device_transform(torch.tensor(u, dtype=torch.float32))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.exp(u), rtol=1e-6)


def test_blackbox_nested_run(tmp_path):
    """``tests/test_blackbox_likelihood.py``'s run on the port: a
    numpy-only likelihood (a scipy row loop) through the whole nested
    loop, the analytic logz within the same bound; the ladder switched to
    MCMC by volume, so the kernels call it too."""
    like = NumpyOnlyGaussian(2)
    s = NestedSampler(2, like, transform=lambda x: 3 * x,
                      num_live_points=100, log_dir=str(tmp_path / 'bb'),
                      resume=False, seed=42, device='cpu')
    assert s._host_loglike
    s.run(train_iters=50, dlogz=0.3, mcmc_num_chains=10, volume_switch=0.5)
    assert like.calls > 0 and s.run_stats['mcmc_generations'] > 0
    assert abs(s.logz + 3.589) <= 0.6


def test_prior_and_transform_wrappers():
    """``tests/test_safe_wrappers.py::test_prior_and_transform_wrappers``
    with a plain callable prior: called once a point, on float64 numpy of
    the transformed point."""
    seen = []

    def box(p):
        seen.append(p)
        return 0.0 if np.all(np.abs(p) <= 5.0) else -np.inf

    s = Sampler(2, lambda x: -torch.sum(x ** 2, dim=1),
                transform=lambda x: 2 * x, prior=box, log_dir=None,
                device='cpu')
    assert s._host_prior
    lp = s.prior(np.array([[3.0, 0.0], [1.0, 1.0]]))
    assert lp[0] == -np.inf and lp[1] == 0.0
    assert [p.tolist() for p in seen] == [[6.0, 0.0], [2.0, 2.0]]
    assert all(p.dtype == np.float64 and p.shape == (2,) for p in seen)
    t = s.transform(np.array([1.0, 2.0]))
    assert t.shape == (1, 2)
    np.testing.assert_array_equal(t, [[2.0, 4.0]])
    got = s.kernels.prior_fn(torch.tensor([[3.0, 0.0], [1.0, 1.0]]))
    np.testing.assert_array_equal(got.numpy(),
                                  np.float32([tk.LOG_NEG, 0.0]))
    zero = Sampler(2, Gaussian(2, 0.0), prior=lambda p: 0.0, log_dir=None,
                   device='cpu')
    np.testing.assert_array_equal(zero.prior(np.zeros((3, 2))), [0.0] * 3)
    # the box prior of the zoo is still evaluated on tensors
    assert not Sampler(2, Gaussian(2, 0.0), prior=UniformPrior(2, -5, 5),
                       log_dir=None, device='cpu')._host_prior


def test_posterior_chains_with_host_likelihood_and_prior():
    """MCMCSampler with both host callables: the chains find starts inside
    the callable prior and give the posterior's moments."""
    def loglike(x):
        if isinstance(x, torch.Tensor):
            raise TypeError('numpy only')
        return -0.5 * np.sum(((x - 1.0) / 0.5) ** 2, axis=1)

    def prior(p):
        return 0.0 if np.all(np.abs(p) <= 5.0) else -np.inf

    training = 1.0 + 0.5 * np.random.RandomState(3).normal(size=(600, 2))
    s = MCMCSampler(2, loglike, prior=prior, log_dir=None, seed=1,
                    device='cpu')
    s.run(300, 16, training, train_iters=5)
    samp = s.samples[:, 75:, :].reshape(-1, 2)
    assert np.all(np.abs(samp.mean(axis=0) - 1.0) < 0.1)
    assert np.all(np.abs(samp.std(axis=0) - 0.5) < 0.1)
    assert s.total_calls >= 300 * 16


@pytest.mark.parametrize('bad', [lambda p: 'x', lambda p: [0.0, 1.0]])
def test_prior_must_give_one_number_a_point(bad):
    s = Sampler(2, Gaussian(2, 0.0), prior=bad, log_dir=None, device='cpu')
    with pytest.raises((TypeError, ValueError)):
        s.prior(np.zeros((2, 2)))
