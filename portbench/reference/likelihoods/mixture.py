"""The ``mixture`` likelihood in float64 (NumPy): upstream nnest's
``GaussianMix`` (adammoss/nnest v0.4.2, ``likelihoods.py``), up to four
Gaussian modes of width ``sigma`` in d dims whose centres differ only in
the first two, at (0, sep), (0, -sep), (sep, 0) and (-sep, 0) in that
order, with ``weights``; on the box [-lim, lim]^d. It imports nothing of
the program."""

from __future__ import annotations

import numpy as np

OFFSETS = ((0.0, 1.0), (0.0, -1.0), (1.0, 0.0), (-1.0, 0.0))


class Mixture:
    def __init__(self, dim, sep, weights, sigma):
        self.dim, self.sigma = int(dim), float(sigma)
        self.centres = float(sep) * np.asarray(OFFSETS[:len(weights)])
        self.log_w = np.log(np.asarray(weights, dtype=np.float64))
        self.log_norm = -0.5 * self.dim * np.log(2.0 * np.pi
                                                 * self.sigma ** 2)

    def slow_part(self, xs):
        """log sum_i w_i exp(-|x_s - c_i|^2 / 2 sigma^2) of slow pairs
        ``xs`` (n, 2): the log likelihood less the normalisation and the
        fast dims' -|x_f|^2 / 2 sigma^2."""
        xs = np.asarray(xs, dtype=np.float64)
        a = self.log_w - 0.5 * np.sum(
            (xs[:, None, :] - self.centres) ** 2, axis=-1) / self.sigma ** 2
        top = np.max(a, axis=1)
        return top + np.log(np.sum(np.exp(a - top[:, None]), axis=1))

    def __call__(self, x):
        x = np.asarray(x, dtype=np.float64)
        fast = np.sum(x[:, 2:] ** 2, axis=1) / self.sigma ** 2
        return self.log_norm + self.slow_part(x[:, :2]) - 0.5 * fast


def mixture(like_cfg):
    return Mixture(like_cfg['x_dim'], like_cfg['sep'], like_cfg['weights'],
                   like_cfg['sigma'])


def loglike(like_cfg):
    """The log likelihood of cube points ``u``: the mixture at
    ``lim * u``."""
    ref, lim = mixture(like_cfg), like_cfg['lim']
    return lambda u: ref(lim * np.asarray(u, dtype=np.float64))
