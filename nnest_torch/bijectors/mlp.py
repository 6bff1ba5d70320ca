"""Small MLP conditioners used inside coupling layers.

Port of ``nnest_tpu/bijectors/mlp.py``: linear layers with an activation
after every layer but the last, LeakyReLU(0.2) for the spline conditioner
and tanh (scale) or ReLU (translation) for the NVP coupling. Weights keep
the JAX layout ``(n_in, n_out)`` and the layer computes ``x @ w + b``, so a
JAX parameter tree loads leaf by leaf (``flows/convert.py``) and the CUDA
kernel reads the same layout. Init follows ``nn.Linear``'s default (uniform
±1/sqrt(fan_in) for weight and bias), as the JAX package does. Under
tensor parallelism (``parallel.shard_params``) a weight whose output
columns are sharded holds this rank's columns, and its layer is
column-parallel: this rank's part of the product, all-gathered over the tp
group, plus the whole (replicated) bias.
"""

from __future__ import annotations

import math

import torch
from torch import nn


def leaky_relu(x):
    return torch.where(x >= 0, x, 0.2 * x)


_ACTS = {
    'relu': torch.relu,
    'tanh': torch.tanh,
    'sigmoid': torch.sigmoid,
    'leaky_relu': leaky_relu,
}


class MLP(nn.Module):
    """``sizes = [n_in, h1, ..., n_out]``; one (w, b) pair per layer and
    the activation ``act`` after every layer but the last."""

    def __init__(self, sizes, generator=None, act='leaky_relu'):
        super().__init__()
        self.sizes = tuple(int(s) for s in sizes)
        self.act = act
        self._act = _ACTS[act]
        self.w = nn.ParameterList()
        self.b = nn.ParameterList()
        for n_in, n_out in zip(self.sizes[:-1], self.sizes[1:]):
            bound = 1.0 / math.sqrt(max(n_in, 1))
            w = torch.empty(n_in, n_out).uniform_(-bound, bound,
                                                  generator=generator)
            b = torch.empty(n_out).uniform_(-bound, bound,
                                            generator=generator)
            self.w.append(nn.Parameter(w))
            self.b.append(nn.Parameter(b))

    def forward(self, x):
        n = len(self.w)
        for i in range(n):
            w = self.w[i]
            # column-parallel under tp: this rank's output columns, gathered
            shard = getattr(w, 'tp_shard', None)
            x = (x @ w if shard is None else shard.matmul(x, w)) + self.b[i]
            if i < n - 1:
                x = self._act(x)
        return x
