"""The port's likelihood zoo against nnest_tpu's at random points, and the
``Likelihood`` helpers."""

import numpy as np
import pytest
import torch

from nnest_tpu import likelihoods as jl
from nnest_torch import likelihoods as tl
from nnest_torch.priors import UniformPrior

# One intra-op thread a process: the suite runs in parallel workers that
# share the cores.
torch.set_num_threads(1)

ZOO = [
    ('Himmelblau', (2,), {}),
    ('Eggbox', (2,), {}),
    ('GaussianShell', (3,), {}),
    ('GaussianShell', (2,), {'sigma': 0.3, 'rshell': 1.5,
                             'center': [0.5, -1.0]}),
    ('DoubleGaussianShell', (2,), {}),
    ('DoubleGaussianShell', (4,), {'sigmas': (0.2, 0.4), 'rshells': (1, 3),
                                   'weights': (0.3, 0.7)}),
    ('GaussianMix', (2,), {}),
    ('GaussianMix', (5,), {'sep': 2.5, 'weights': (0.5, 0.5),
                           'sigma': 0.7}),
    ('Rosenbrock', (4,), {}),
    ('Gaussian', (3, 0.4), {}),
]


@pytest.mark.parametrize('name,args,kwargs', ZOO)
def test_zoo_matches_jax(name, args, kwargs):
    d = args[0]
    x = np.random.RandomState(d).uniform(-6, 6, size=(200, d))
    port = getattr(tl, name)(*args, **kwargs)
    ref = getattr(jl, name)(*args, **kwargs)
    got = port(torch.as_tensor(x, dtype=torch.float32))
    assert got.dtype == torch.float32 and got.shape == (200,)
    want = ref(x)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(port.max_loglike, ref.max_loglike,
                               rtol=1e-5, atol=1e-5)
    assert port.num_evaluations > 0


def test_zoo_refuses_bad_arguments():
    with pytest.raises(ValueError):
        tl.Himmelblau(3)
    with pytest.raises(ValueError):
        tl.Eggbox(4)
    with pytest.raises(ValueError):
        tl.GaussianMix(2, weights=(0.5, 0.6))


def test_helpers_sample_and_range():
    like = tl.Gaussian(2, 0.0, lim=3)
    assert like.sample_range == ([-3] * 2, [3] * 2)
    assert tl.Rosenbrock(3).sample_range == ([-2] * 3, [12] * 3)
    prior = UniformPrior(2, -3.0, 3.0)
    prior.seed(1)
    pts, thr = like.uniform_sample(prior, 50, 0.25)
    assert pts.shape == (50, 2)
    logl = like(torch.as_tensor(pts, dtype=torch.float32)).numpy()
    assert np.all(logl >= thr - 1e-6)
    draws = like.sample(prior, 400, rng=np.random.RandomState(2))
    assert draws.shape == (400, 2)
    # rejection against exp(logl - max): a unit Gaussian truncated at ±3
    assert np.all(np.abs(draws.std(axis=0) - 0.986) < 0.1)
