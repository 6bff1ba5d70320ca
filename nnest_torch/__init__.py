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
progress bar and the command lines (``nnest_torch.cli``); multi-process
data and tensor parallelism (``nnest_torch.parallel``); the host C++
runtime of the chain files and diagnostics (``nnest_torch.runtime``); and
``nnest_tpu``'s import surface (``samplers``, ``utils``, ``ops``,
``distributions``, ``parallel``, ``priors.Prior``).

``mesh=`` (every sampler and the ``Trainer``) runs one process a rank on
``torch.distributed``, every rank the same loop from the same seed: the
Metropolis and slice chains and the training batches are dp-sharded, the
flow strategies and the ensemble replicated with a host likelihood farmed
over the ranks, and rank 0 alone owns the run directory and broadcasts a
resume. With a (dp, tp) mesh whose tp > 1 the ``MCMCSampler``'s flow is
also sharded over the tp group: its wide conditioner layers column-parallel
(``parallel.get_mesh(dp, tp)``). Launch with ``torchrun --nproc_per_node N -m nnest_torch.cli.multihost``
or with the rank given by hand (``--num_processes N --process_id i
--coordinator host:port``, plus ``--local_rank`` and ``--local_world_size``
where ranks share a host; or ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT`` for
``parallel.initialize_distributed``). The backend is NCCL when every rank
of a host has a card of its own (``cuda:LOCAL_RANK``), gloo on CPU ranks,
and gloo when several ranks share one card, which NCCL refuses.

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
