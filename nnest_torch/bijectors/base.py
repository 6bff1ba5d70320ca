"""Bijector core: invertible transforms as ``nn.Module``s.

Port of ``nnest_tpu/bijectors/base.py``. Each bijector maps
``forward(x) -> (z, logdet)`` and ``inverse(z) -> (x, logdet)`` with ``x``
of shape (batch, dim) and ``logdet`` of shape (batch,). Both are total
functions: out-of-domain inputs take identity tails instead of raising.

Data-dependent initialisation (ActNorm) is the optional ``data_init(x)``
hook; ``Chain.data_init`` threads the batch through the chain so each
bijector sees the activations of the ones before it, as the JAX
``Chain.init`` does.

A chain with the spline layout ([ActNorm, Invertible1x1Conv,
SplineCoupling] x blocks) runs its forward on a card through one kernel
launch where ``ops.spline_chain.takes`` it, and module by module otherwise
(the CPU's path); the recorder's counter ``spline_chain`` counts each such
forward by its path.

Under tensor parallelism (``parallel.shard_params``) a tensor may hold
only this rank's columns; :func:`whole` gives the whole tensor wherever a
bijector needs it.
"""

from __future__ import annotations

import torch
from torch import nn

from nnest_torch.utils.profiling import count


def whole(t):
    """``t``, or, where tensor parallelism keeps only this rank's columns
    of it (a ``tp_shard`` on the tensor), all of them gathered over the tp
    group (differentiable; every tp rank calls it)."""
    shard = getattr(t, 'tp_shard', None)
    return t if shard is None else shard.gather(t)


class Bijector(nn.Module):
    """Invertible transform with a log-determinant."""

    def forward(self, x):
        raise NotImplementedError

    def inverse(self, z):
        raise NotImplementedError

    def data_init(self, x):
        """Initialise from a data batch; the default has nothing to set."""


class Chain(Bijector):
    """Sequential composition with logdet accumulation."""

    def __init__(self, bijectors):
        super().__init__()
        self.bijectors = nn.ModuleList(bijectors)

    def forward(self, x):
        # imported here: nnest_torch.ops imports this package
        from nnest_torch.ops import spline_chain
        path = spline_chain.path(self, x)
        if path is not None:
            count('spline_chain', key=path)
        if path == 'kernel':
            return spline_chain.chain_forward(self, x)
        logdet = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
        for b in self.bijectors:
            x, ld = b(x)
            logdet = logdet + ld
        return x, logdet

    def inverse(self, z):
        logdet = torch.zeros(z.shape[0], dtype=z.dtype, device=z.device)
        for b in reversed(self.bijectors):
            z, ld = b.inverse(z)
            logdet = logdet + ld
        return z, logdet

    @torch.no_grad()
    def data_init(self, x):
        for b in self.bijectors:
            b.data_init(x)
            x = b(x)[0]
