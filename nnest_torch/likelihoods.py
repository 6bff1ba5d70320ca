"""Test likelihoods: ``Gaussian`` (with its analytic evidence) and
``Rosenbrock``.

Port of the matching classes in ``nnest_tpu/likelihoods.py``. A likelihood
is called on a (batch, d) float32 tensor and returns the (batch,) log
likelihood on the same device, computed in float32 as the JAX package
computes it. The rest of the zoo is not ported yet.
"""

from __future__ import annotations

import math

import numpy as np
import torch


class Likelihood:
    """Base class; subclasses implement ``logpdf(x)`` on a (batch, d)
    float32 tensor."""

    def __init__(self, x_dim: int):
        self.x_dim = x_dim
        self.num_evaluations = 0

    def logpdf(self, x):
        raise NotImplementedError

    def __call__(self, x):
        x = x.to(torch.float32)
        if x.dim() == 1:
            x = x[None, :]
        self.num_evaluations += x.shape[0]
        return self.logpdf(x)


class Rosenbrock(Likelihood):
    """-Σ 100(x_{i+1}-x_i²)² + (1-x_i)²."""

    def logpdf(self, x):
        return -torch.sum(100.0 * (x[:, 1:] - x[:, :-1] ** 2) ** 2
                          + (1.0 - x[:, :-1]) ** 2, dim=-1)


class Gaussian(Likelihood):
    """Correlated MVN with pairwise correlation ``corr``."""

    def __init__(self, x_dim: int, corr: float, lim: float = 5):
        super().__init__(x_dim)
        self.corr = corr
        self.lim = lim
        cov = np.eye(x_dim) + corr * (1.0 - np.eye(x_dim))
        # the precision matrix on each device the likelihood has run on
        self._prec = {'cpu': torch.as_tensor(np.linalg.inv(cov),
                                             dtype=torch.float32)}
        _, logdet = np.linalg.slogdet(cov)
        self._log_norm = -0.5 * (x_dim * math.log(2 * math.pi) + logdet)

    def logpdf(self, x):
        key = str(x.device)
        if key not in self._prec:
            self._prec[key] = self._prec['cpu'].to(x.device)
        prec = self._prec[key]
        return self._log_norm - 0.5 * torch.sum((x @ prec) * x, dim=-1)

    def analytic_logz(self, prior_lo, prior_hi):
        """Exact logZ for a uniform prior box: log(MVN mass inside the box)
        minus log(box volume); erf terms for ``corr == 0``, scipy's MVN
        rectangle probability otherwise."""
        lo = np.asarray(prior_lo, dtype=np.float64)
        hi = np.asarray(prior_hi, dtype=np.float64)
        vol = float(np.prod(hi - lo))
        if self.corr == 0.0:
            from scipy.special import erf
            sqrt2 = math.sqrt(2.0)
            log_mass = float(np.sum(np.log(
                0.5 * (erf(hi / sqrt2) - erf(lo / sqrt2)))))
        else:
            from scipy.stats import multivariate_normal
            cov = (np.eye(self.x_dim)
                   + self.corr * (1.0 - np.eye(self.x_dim)))
            mass = float(multivariate_normal(
                mean=np.zeros(self.x_dim), cov=cov,
                allow_singular=False).cdf(hi, lower_limit=lo))
            log_mass = math.log(mass)
        return log_mass - math.log(vol)
