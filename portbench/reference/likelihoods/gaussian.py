"""The Gaussian log likelihood in float64 (NumPy), from the configuration's
covariance: every pairwise correlation ``corr``, unit variances, on the box
[-lim, lim]^d."""

from __future__ import annotations

import numpy as np


def covariance(dim, corr):
    return np.eye(dim) + corr * (1.0 - np.eye(dim))


class Gaussian:
    def __init__(self, dim, corr):
        cov = covariance(dim, corr)
        self.precision = np.linalg.inv(cov)
        self.log_norm = -0.5 * (dim * np.log(2.0 * np.pi)
                                + np.linalg.slogdet(cov)[1])

    def radius2(self, x):
        """The squared Mahalanobis radius of each row of ``x``."""
        x = np.asarray(x, dtype=np.float64)
        return np.einsum('ij,jk,ik->i', x, self.precision, x)

    def __call__(self, x):
        return self.log_norm - 0.5 * self.radius2(x)

    def logl_at_radius(self, r):
        return self.log_norm - 0.5 * r * r


def loglike(like_cfg):
    """The log likelihood of cube points ``u``: the Gaussian at
    ``lim * u``."""
    ref, lim = Gaussian(like_cfg['x_dim'], like_cfg['corr']), like_cfg['lim']
    return lambda u: ref(lim * u)
