"""Samplers: nested, MCMC and ensemble, and the latent kernels on the
sampler's device (``nnest_tpu.samplers``' names)."""

from nnest_torch.samplers.base import Sampler
from nnest_torch.samplers.kernels import LatentKernels
from nnest_torch.samplers.nested import NestedSampler
from nnest_torch.samplers.mcmc import MCMCSampler
from nnest_torch.samplers.ensemble import EnsembleSampler

__all__ = ['Sampler', 'LatentKernels', 'NestedSampler', 'MCMCSampler',
           'EnsembleSampler']
