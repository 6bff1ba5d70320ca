"""Glow-style invertible 1x1 convolution with PLU parameterisation.

Port of ``nnest_tpu/bijectors/conv1x1.py``: W = P L (U + diag(S)), with P
the fixed permutation from the LU decomposition of a random orthogonal
init, held as the frozen buffer ``_P`` (the optimizer sees parameters
only); logdet = sum(log|S|). The inverse solves ``x W = z`` rather than
forming W⁻¹; the hot path packs W⁻¹ once per call instead
(``ops/fused_spline.py``).
"""

from __future__ import annotations

import torch
from torch import nn

from nnest_torch.bijectors.base import Bijector, whole


def random_orthogonal(dim, generator=None):
    """Haar-distributed orthogonal matrix (QR of a Gaussian, sign-fixed)."""
    a = torch.randn(dim, dim, generator=generator, dtype=torch.float64)
    q, r = torch.linalg.qr(a)
    return (q * torch.sign(torch.diagonal(r))).float()


class Invertible1x1Conv(Bijector):

    def __init__(self, dim, generator=None):
        super().__init__()
        self.dim = int(dim)
        p, l, u = torch.linalg.lu(random_orthogonal(self.dim, generator))
        self.register_buffer('_P', p)
        self.L = nn.Parameter(l)
        self.S = nn.Parameter(torch.diagonal(u).clone())
        self.U = nn.Parameter(torch.triu(u, diagonal=1))

    def assemble(self):
        eye = torch.eye(self.dim, dtype=self.L.dtype, device=self.L.device)
        L = torch.tril(whole(self.L), diagonal=-1) + eye
        U = torch.triu(whole(self.U), diagonal=1) + torch.diag(self.S)
        return whole(self._P) @ L @ U

    def forward(self, x):
        z = x @ self.assemble()
        logdet = torch.sum(torch.log(torch.abs(self.S)))
        return z, logdet.expand(x.shape[0])

    def inverse(self, z):
        # x W = z  →  solve W^T x^T = z^T (solve_ex: the same solve without
        # the host read of its error flag; W = P L U is invertible)
        x = torch.linalg.solve_ex(self.assemble().T, z.T)[0].T
        logdet = -torch.sum(torch.log(torch.abs(self.S)))
        return x, logdet.expand(z.shape[0])
