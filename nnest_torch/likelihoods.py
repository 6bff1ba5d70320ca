"""The test likelihood zoo: ``Rosenbrock``, ``Himmelblau``, ``Gaussian``
(with its analytic evidence), ``Eggbox``, ``GaussianShell``,
``DoubleGaussianShell`` and ``GaussianMix``.

Port of ``nnest_tpu/likelihoods.py``. A likelihood is called on a
(batch, d) float32 tensor and returns the (batch,) log likelihood on the
same device, computed in float32 as the JAX package computes it (numpy
arrays and lists are taken as CPU tensors). The helpers ``sample``,
``uniform_sample`` and ``max_loglike`` work on host numpy points.
"""

from __future__ import annotations

import math

import numpy as np
import torch


class Likelihood:
    """Base class; subclasses implement ``logpdf(x)`` on a (batch, d)
    float32 tensor. The zoo returns no derived parameters."""

    num_derived = 0

    def __init__(self, x_dim: int):
        self.x_dim = x_dim
        self.num_evaluations = 0

    def logpdf(self, x):
        raise NotImplementedError

    def __call__(self, x):
        x = torch.as_tensor(x, dtype=torch.float32)
        if x.dim() == 1:
            x = x[None, :]
        self.num_evaluations += x.shape[0]
        return self.logpdf(x)

    def _host(self, x):
        """Log likelihood of host points as float64 numpy."""
        with torch.no_grad():
            logl = self(np.asarray(x, dtype=np.float32))
        return logl.cpu().numpy().astype(np.float64)

    def sample(self, prior, num_samples, rng=None):
        """Rejection-sample ``num_samples`` draws under this likelihood
        from ``prior.sample`` (host numpy points)."""
        rng = rng or np.random
        max_loglike = self.max_loglike
        out = np.empty((0, self.x_dim))
        while out.shape[0] < num_samples:
            x = prior.sample(num_samples)
            ratio = np.exp(self._host(x) - max_loglike)
            keep = ratio > rng.uniform(size=(num_samples,))
            out = np.vstack((np.asarray(x)[keep], out))
        return out[:num_samples]

    def uniform_sample(self, prior, num_samples, fraction):
        """The top ``fraction`` of prior draws; returns (points, threshold
        loglike)."""
        x = prior.sample(int(num_samples / fraction))
        loglike = self._host(x)
        idx = np.argsort(-loglike)
        return np.asarray(x)[idx[:num_samples]], loglike[idx[num_samples - 1]]

    @property
    def max_loglike(self):
        raise NotImplementedError

    def _max_at(self, point):
        return float(self._host(np.asarray(point)[None, :])[0])


class Rosenbrock(Likelihood):
    """-Σ 100(x_{i+1}-x_i²)² + (1-x_i)²."""

    def logpdf(self, x):
        return -torch.sum(100.0 * (x[:, 1:] - x[:, :-1] ** 2) ** 2
                          + (1.0 - x[:, :-1]) ** 2, dim=-1)

    @property
    def max_loglike(self):
        return self._max_at(np.ones(self.x_dim))

    @property
    def sample_range(self):
        return [-2] * self.x_dim, [12] * self.x_dim


class Himmelblau(Likelihood):
    """2-D four-mode surface."""

    def __init__(self, x_dim: int):
        if x_dim != 2:
            raise ValueError('Himmelblau is 2-D')
        super().__init__(x_dim)

    def logpdf(self, x):
        return (-(x[:, 0] ** 2 + x[:, 1] - 11.0) ** 2
                - (x[:, 0] + x[:, 1] ** 2 - 7.0) ** 2)

    @property
    def max_loglike(self):
        return self._max_at(np.array([3.0, 2.0]))


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

    @property
    def max_loglike(self):
        return self._max_at(np.zeros(self.x_dim))

    @property
    def sample_range(self):
        return [-self.lim] * self.x_dim, [self.lim] * self.x_dim

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


class Eggbox(Likelihood):
    """(2 + cos(x/2)cos(y/2))^5."""

    def __init__(self, x_dim: int):
        if x_dim != 2:
            raise ValueError('Eggbox is 2-D')
        super().__init__(x_dim)

    def logpdf(self, x):
        chi = torch.cos(x[:, 0] / 2.0) * torch.cos(x[:, 1] / 2.0)
        return (2.0 + chi) ** 5

    @property
    def max_loglike(self):
        return self._max_at(np.zeros(2))


class GaussianShell(Likelihood):
    """Thin Gaussian shell of radius ``rshell`` around ``center``."""

    def __init__(self, x_dim: int, sigma: float = 0.1, rshell: float = 2,
                 center=0):
        super().__init__(x_dim)
        if not hasattr(center, '__len__'):
            center = np.full(x_dim, float(center))
        self.center = np.asarray(center, dtype=np.float32)
        self.sigma = sigma
        self.rshell = rshell

    def logpdf(self, x):
        c = torch.as_tensor(self.center, device=x.device)
        rad = torch.sqrt(torch.sum((c - x) ** 2, dim=-1))
        return -((rad - self.rshell) ** 2) / (2.0 * self.sigma ** 2)

    @property
    def max_loglike(self):
        p = self.center.copy()
        p[0] -= self.rshell
        return self._max_at(p)


class DoubleGaussianShell(Likelihood):
    """Mixture of two Gaussian shells."""

    def __init__(self, x_dim: int, sigmas=(0.1, 0.1), rshells=(2, 2),
                 centers=(-4, 4), weights=(1.0, 1.0)):
        super().__init__(x_dim)
        self.shell1 = GaussianShell(x_dim, sigma=sigmas[0],
                                    rshell=rshells[0], center=centers[0])
        self.shell2 = GaussianShell(x_dim, sigma=sigmas[1],
                                    rshell=rshells[1], center=centers[1])
        self.weights = weights

    def logpdf(self, x):
        return torch.logaddexp(
            math.log(self.weights[0]) + self.shell1.logpdf(x),
            math.log(self.weights[1]) + self.shell2.logpdf(x))

    @property
    def max_loglike(self):
        return self.shell1.max_loglike + self.shell2.max_loglike


class GaussianMix(Likelihood):
    """2-4 Gaussian modes on the axes at separation ``sep`` in the first
    two dims."""

    def __init__(self, x_dim: int, sep: float = 4,
                 weights=(0.4, 0.3, 0.2, 0.1), sigma: float = 1):
        if len(weights) not in (2, 3, 4):
            raise ValueError('GaussianMix takes 2 to 4 weights')
        if not np.isclose(sum(weights), 1.0):
            raise ValueError('GaussianMix weights must sum to 1')
        super().__init__(x_dim)
        self.sep = sep
        self.weights = tuple(weights)
        self.sigma = sigma
        offsets = [(0.0, sep), (0.0, -sep), (sep, 0.0), (-sep, 0.0)]
        self.positions = np.asarray(offsets[:len(weights)], dtype=np.float32)

    def logpdf(self, x):
        d = self.x_dim
        log_norm = -0.5 * d * math.log(2 * math.pi * self.sigma ** 2)
        comps = []
        for w, pos in zip(self.weights, self.positions):
            shifted = torch.cat(
                [x[:, :2] - torch.as_tensor(pos, device=x.device), x[:, 2:]],
                dim=-1)
            lg = (-torch.sum(shifted ** 2, dim=-1) / (2 * self.sigma ** 2)
                  + log_norm)
            comps.append(lg + math.log(w))
        return torch.logsumexp(torch.stack(comps, dim=0), dim=0)

    @property
    def max_loglike(self):
        p = np.zeros(self.x_dim, dtype=np.float32)
        p[:2] = self.positions[int(np.argmax(self.weights))]
        return self._max_at(p)
