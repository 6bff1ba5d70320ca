"""A nested-sampling run's evidence and information from its dead points
and final live set (Skilling 2006): the i-th dead point (from 0) carries
the shell log(1 - e^(-1/n)) - i/n of prior volume, and each of the n final
live points an equal share e^(-D/n)/n of what is left after D deaths."""

from __future__ import annotations

import numpy as np


def band_evidence(logl_dead, logl_live, n_live):
    """(logz, h) in float64."""
    logl_dead = np.asarray(logl_dead, dtype=np.float64)
    logl_live = np.asarray(logl_live, dtype=np.float64)
    dead = logl_dead.shape[0]
    shell = np.log(-np.expm1(-1.0 / n_live)) - np.arange(dead) / n_live
    rest = np.full(logl_live.shape[0], -dead / n_live - np.log(n_live))
    logwt = np.concatenate([shell + logl_dead, rest + logl_live])
    logl = np.concatenate([logl_dead, logl_live])
    top = np.max(logwt)
    logz = top + np.log(np.sum(np.exp(logwt - top)))
    h = float(np.sum(np.exp(logwt - logz) * logl) - logz)
    return float(logz), h
