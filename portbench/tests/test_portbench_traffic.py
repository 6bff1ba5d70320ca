"""The bands' live sets and the jobs' seeds."""

import numpy as np
import pytest
import torch

from harness import traffic
from harness.likelihood import Gaussian
from reference.likelihood import Gaussian as Gaussian64

torch.set_num_threads(1)


@pytest.mark.parametrize('dim,corr,radius', [(16, 0.99, 10.0),
                                             (50, 0.0, 8.7), (4, 0.5, 2.0)])
def test_init_set_inside_box_and_contour(dim, corr, radius):
    config = {'likelihood': {'kind': 'gaussian', 'x_dim': dim, 'corr': corr,
                             'lim': 3.0}}
    like = Gaussian(dim, corr, 'cpu')
    u, logl, floor = traffic.init_set(like, config, radius, 300, 7, 'cpu')
    assert u.shape == (300, dim) and logl.shape == (300,)
    assert np.all(np.abs(u) < 1.0)
    assert np.all(logl > floor)
    # float32 points, float32 likelihood values
    assert np.array_equal(u.astype(np.float32).astype(np.float64), u)
    assert np.array_equal(logl.astype(np.float32).astype(np.float64), logl)
    ref = Gaussian64(dim, corr)
    assert np.all(ref.radius2(3.0 * u) < radius ** 2 * (1 + 1e-5))
    assert like.rows == 0
    assert floor == pytest.approx(ref.logl_at_radius(radius))


@pytest.mark.parametrize('dim,corr', [(16, 0.99), (5, 0.0)])
def test_radial_cdf_is_r_to_the_d(dim, corr):
    """Without the box's cut, (r / R)^d of a uniform draw in the ellipsoid
    is uniform on (0, 1) (Kolmogorov-Smirnov at the 0.1% level)."""
    from scipy import stats
    u = traffic.ellipsoid_draw(dim, corr, 1e4, 2.0, 4000, 11, 'cpu')
    r2 = Gaussian64(dim, corr).radius2(1e4 * u.double().numpy())
    assert stats.kstest((r2 / 4.0) ** (dim / 2.0), 'uniform').pvalue > 1e-3


def test_job_seeds():
    big = 2 ** 31 + 987654
    assert traffic.job_seed(big, 3) == traffic.job_seed(big, 3)
    seeds = {traffic.job_seed(big, i) for i in range(100)}
    assert len(seeds) == 100
    assert traffic.job_seed(big, 'warmup') != traffic.job_seed(big + 1,
                                                               'warmup')
    assert all(0 <= s < 2 ** 62 for s in seeds)
