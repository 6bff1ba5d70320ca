"""Base distributions for the latent space of a flow.

Port of ``nnest_tpu/distributions/base.py``. Each has ``sample(num,
generator)``, drawing on the generator's device, and ``log_prob(z)``
summed over dims:

- ``DiagNormal``: the standard normal N(0, I);
- ``GeneralisedNormal``: the exponential-power distribution of shape
  ``beta`` (beta = 2 is Gaussian; large beta approaches the uniform box),
  sampled by the gamma construction X = loc + scale * s * G^(1/beta),
  G ~ Gamma(1/beta), s = ±1, as ``scipy.stats.gennorm.rvs`` draws. It also
  has ``usample(num, generator)``, uniform in [-1, 1]^dim, the box flow
  rejection draws in (``has_usample``);
- ``LogitUniform``: logit(U(0, 1)) per dim, the standard logistic.
"""

from __future__ import annotations

import math

import torch

from nnest_torch.bijectors.rqs import softplus


def _device(generator, device):
    return generator.device if generator is not None else device


def standard_gamma(shape_param, size, generator=None, device=None):
    """Gamma(shape_param, 1) draws of ``size`` from ``generator``
    (``torch._standard_gamma`` takes no generator): Marsaglia and Tsang's
    squeeze-free rejection on Gamma(a + 1) for a < 1, times U^(1/a). Each
    round redraws the rejected lanes only (acceptance is over 95% for
    a + 1 >= 1), so the draws a call takes depend on the generator state
    alone."""
    device = _device(generator, device)
    a = float(shape_param)
    boost = a < 1.0
    d = (a + 1.0 if boost else a) - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    n = math.prod(size)
    out = torch.empty(n, device=device)
    pending = torch.arange(n, device=device)
    while pending.numel() > 0:
        x = torch.randn(pending.numel(), generator=generator, device=device)
        u = torch.rand(pending.numel(), generator=generator, device=device)
        v = (1.0 + c * x) ** 3
        ok = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v
                        + d * torch.log(torch.clamp(v, min=1e-30)))
        out[pending[ok]] = d * v[ok]
        pending = pending[~ok]
    if boost:
        u = torch.rand(n, generator=generator, device=device)
        out = out * u ** (1.0 / a)
    return out.reshape(size)


class BaseDistribution:
    """A latent distribution of ``dim`` dims; its repr names its fields
    (``params.txt`` records it)."""

    has_usample = False

    def __repr__(self):
        return '%s(%s)' % (type(self).__name__, ', '.join(
            '%s=%r' % kv for kv in vars(self).items()))


class DiagNormal(BaseDistribution):

    def __init__(self, dim):
        self.dim = int(dim)

    def sample(self, num, generator=None, device=None):
        return torch.randn(num, self.dim, generator=generator,
                           device=_device(generator, device))

    def log_prob(self, z):
        return torch.sum(-0.5 * z ** 2 - 0.5 * math.log(2.0 * math.pi),
                         dim=-1)


class GeneralisedNormal(BaseDistribution):

    has_usample = True

    def __init__(self, dim, beta=8.0, loc=0.0, scale=1.0):
        self.dim = int(dim)
        self.beta = float(beta)
        self.loc = float(loc)
        self.scale = float(scale)

    def sample(self, num, generator=None, device=None):
        device = _device(generator, device)
        g = standard_gamma(1.0 / self.beta, (num, self.dim), generator,
                           device)
        sign = 2.0 * torch.randint(0, 2, (num, self.dim), generator=generator,
                                   device=device).to(torch.float32) - 1.0
        return self.loc + self.scale * sign * g ** (1.0 / self.beta)

    def log_prob(self, z):
        lp = (-(torch.abs(z - self.loc) / self.scale) ** self.beta
              + math.log(self.beta) - math.log(self.scale)
              - math.log(2.0) - math.lgamma(1.0 / self.beta))
        return torch.sum(lp, dim=-1)

    def usample(self, num, generator=None, device=None):
        """Uniform in the box [-1, 1]^dim."""
        return 2.0 * torch.rand(num, self.dim, generator=generator,
                                device=_device(generator, device)) - 1.0


class LogitUniform(BaseDistribution):

    def __init__(self, dim):
        self.dim = int(dim)

    def sample(self, num, generator=None, device=None):
        u = torch.rand(num, self.dim, generator=generator,
                       device=_device(generator, device))
        u = 1e-7 + (1.0 - 2e-7) * u
        return torch.log(u) - torch.log1p(-u)

    def log_prob(self, z):
        # logistic pdf: e^{-z} / (1 + e^{-z})^2
        return torch.sum(-z - 2.0 * softplus(-z), dim=-1)
