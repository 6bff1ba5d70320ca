"""nnest_torch — neural nested sampling on PyTorch and CUDA.

A port of ``nnest_tpu`` (the JAX reference, kept beside this package) to
PyTorch on an NVIDIA H100. Flows are ``nn.Module``s, random numbers come
from explicit ``torch.Generator``s, and the spline-flow inverse that every
Metropolis, slice, ensemble and flow-rejection proposal of a single-speed
spline flow runs is a hand-written CUDA kernel (``ops/spline_inverse.py`` +
``csrc/spline_inverse.cu``) with a plain PyTorch twin that serves CPU
tensors. The NVP, Cholesky and fast-slow flows invert in plain PyTorch.

Ported: the nested sampler with its strategy ladder (prior and flow
rejection, flow density, Metropolis and slice chains), diagnostics and
exact resume; the dynamic nested sampler; the MCMC and ensemble posterior
samplers; every flow and base of ``build_flow``; torch and host (numpy)
likelihoods and priors; derived parameters (a likelihood returning
``(logl, derived)``, ``num_derived``) through every strategy, sampler,
checkpoint and chain file; the trainer with its transport API (``forward``,
``inverse``, ``log_probs`` and the sample getters), its run directory
(``netG.pkl`` in ``nnest_tpu``'s format, plots, TensorBoard) and, on a GPU,
its training step replayed as a CUDA graph; the background writer, the
progress bar and the command lines (``nnest_torch.cli``). Not ported:
meshes and multi-device runs (ROADMAP.md).

Entry points run on ``device='cuda'`` unless the caller asks for the CPU;
with no GPU they raise instead of falling back. This package never imports
``jax`` or ``nnest_tpu``.
"""

import torch

# The repo's numerics contract is float32: keep TF32 out of every matmul
# and convolution (PyTorch enables TF32 for cuDNN convolutions by default).
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = '0.1.0'

__all__ = ['NestedSampler', 'DynamicNestedSampler', 'MCMCSampler',
           'EnsembleSampler', 'Trainer', 'build_flow', '__version__']

_LAZY = {
    'NestedSampler': 'nnest_torch.samplers.nested',
    'DynamicNestedSampler': 'nnest_torch.samplers.dynamic',
    'MCMCSampler': 'nnest_torch.samplers.mcmc',
    'EnsembleSampler': 'nnest_torch.samplers.ensemble',
    'Trainer': 'nnest_torch.training.trainer',
    'build_flow': 'nnest_torch.flows.factory',
}


def __getattr__(name):
    if name in _LAZY:
        import importlib
        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(name)
