"""Priors: the box prior (the nested sampler's unit cube, or a physical
prior of the MCMC and ensemble samplers).

Port of ``Prior`` and ``UniformPrior`` in ``nnest_tpu/priors.py``.
``logpdf`` takes a (batch, d) tensor and returns 0 inside the box and -inf
outside (the subclass hook; batched, where the JAX package's is a point's
and is vmapped); calling a prior, as ``nnest_tpu``'s, takes one point (a
list or a 1-D array: a Python float) or a batch (float64 numpy).
``sample`` draws host points from a seeded numpy generator (the initial
live set, the ensemble bootstrap's walkers) and ``sample_torch`` draws on a
``torch.Generator``'s device (batched prior rejection).
"""

from __future__ import annotations

import numpy as np
import torch


class Prior:
    """A prior over ``x_dim`` parameters: subclasses define the batched
    ``logpdf``."""

    def __init__(self, x_dim: int):
        self.x_dim = x_dim

    def logpdf(self, x):
        raise NotImplementedError

    def __call__(self, x):
        x = torch.as_tensor(np.asarray(x), dtype=torch.float32)
        if x.dim() > 1:
            return self.logpdf(x).numpy().astype(np.float64)
        return float(self.logpdf(x[None])[0])

    def sample(self, num_samples):
        raise NotImplementedError


class UniformPrior(Prior):
    """Box prior on [minimum, maximum]^dim."""

    def __init__(self, x_dim: int, minimum, maximum):
        if not hasattr(minimum, '__len__'):
            minimum = [minimum] * x_dim
        if not hasattr(maximum, '__len__'):
            maximum = [maximum] * x_dim
        if len(minimum) != x_dim or len(maximum) != x_dim:
            raise ValueError('prior bounds must have x_dim entries')
        super().__init__(x_dim)
        self.minimum = np.asarray(minimum, dtype=np.float64)
        self.maximum = np.asarray(maximum, dtype=np.float64)
        self._rng = np.random.default_rng(0)
        # the bounds as tensors, by dtype and device: a chain step on the
        # GPU evaluates the prior without a host-to-device copy
        self._bounds = {}

    def bounds(self, dtype, device):
        """(lo, hi) as tensors of ``dtype`` on ``device``."""
        key = (dtype, str(device))
        if key not in self._bounds:
            self._bounds[key] = (
                torch.as_tensor(self.minimum, dtype=dtype, device=device),
                torch.as_tensor(self.maximum, dtype=dtype, device=device))
        return self._bounds[key]

    def logpdf(self, x):
        lo, hi = self.bounds(x.dtype, x.device)
        inside = torch.all((x >= lo) & (x <= hi), dim=-1)
        return torch.where(inside, torch.zeros_like(x[:, 0]),
                           torch.full_like(x[:, 0], -np.inf))

    def seed(self, seed: int):
        self._rng = np.random.default_rng(seed)

    def sample(self, num_samples):
        u = self._rng.uniform(size=(num_samples, self.x_dim))
        return self.minimum + (self.maximum - self.minimum) * u

    def sample_torch(self, num_samples, generator):
        device = generator.device
        lo, hi = self.bounds(torch.float32, device)
        u = torch.rand(num_samples, self.x_dim, generator=generator,
                       device=device)
        return lo + (hi - lo) * u
