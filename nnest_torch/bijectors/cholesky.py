"""Learnable lower-triangular (Cholesky-whitening) linear flow.

Port of ``CholeskyLinear`` in ``nnest_tpu/bijectors/cholesky.py``:
y = x L^T + b with L lower triangular, its strict lower part learned
(row-major, as ``np.tril_indices(dim, -1)`` orders it) and its diagonal
softplus(udiag) + eps, so logdet = sum(log diag(L)). The identity init
sets udiag so the diagonal starts at 1. The inverse is a triangular solve.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from nnest_torch.bijectors.base import Bijector
from nnest_torch.bijectors.rqs import softplus


class CholeskyLinear(Bijector):

    def __init__(self, dim, identity_init=True, eps=1e-3, generator=None):
        super().__init__()
        self.dim = int(dim)
        self.eps = float(eps)
        n_tri = (self.dim - 1) * self.dim // 2
        if identity_init:
            lower = torch.zeros(n_tri)
            udiag = torch.full((self.dim,),
                               math.log(math.exp(1.0 - self.eps) - 1.0))
        else:
            stdv = 1.0 / math.sqrt(self.dim)
            lower = torch.empty(n_tri).uniform_(-stdv, stdv,
                                                generator=generator)
            udiag = torch.empty(self.dim).uniform_(-stdv, stdv,
                                                   generator=generator)
        self.bias = nn.Parameter(torch.zeros(self.dim))
        self.lower = nn.Parameter(lower)
        self.udiag = nn.Parameter(udiag)
        rows, cols = np.tril_indices(self.dim, k=-1)
        self.register_buffer('_rows', torch.from_numpy(rows),
                             persistent=False)
        self.register_buffer('_cols', torch.from_numpy(cols),
                             persistent=False)

    def matrix(self):
        """(L, diag(L))."""
        diag = softplus(self.udiag) + self.eps
        L = torch.zeros(self.dim, self.dim, dtype=diag.dtype,
                        device=diag.device)
        L = L.index_put((self._rows, self._cols), self.lower)
        return L + torch.diag(diag), diag

    def forward(self, x):
        L, diag = self.matrix()
        logdet = torch.sum(torch.log(diag))
        return x @ L.T + self.bias, logdet.expand(x.shape[0])

    def inverse(self, z):
        L, diag = self.matrix()
        x = torch.linalg.solve_triangular(L, (z - self.bias).T,
                                          upper=False).T
        logdet = -torch.sum(torch.log(diag))
        return x, logdet.expand(z.shape[0])
