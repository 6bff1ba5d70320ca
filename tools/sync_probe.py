#!/usr/bin/env python3
"""Where the host syncs of a pool generation come from, on the card.

Run from the repository root on a machine with the GPU:
``python3 tools/sync_probe.py``. On an untrained 16-D flow (the phase-3
model of ``chip_smoke.py``, a synthetic shell of 1000 live points) it runs
one Metropolis generation (256 chains x 80 steps) a dispatch, eight in one
batch (and speculating: no stop flag read, the generator's state read before
each), one prior-rejection generation (4096 trials) and eight in one batch,
each under ``torch.cuda.set_sync_debug_mode('warn')``, and prints for each
the number of synchronizing calls and, for each, the innermost frame of
this repository that made it.
"""

import collections
import os
import sys
import traceback
import warnings

import numpy as np
import torch

sys.path.insert(0, os.getcwd())

import chip_smoke  # noqa: E402  (the repository root is on the path)


def sync_sites(fn, root):
    """Counter of the repository frames that made ``fn``'s host syncs (one
    warm call first)."""
    fn()
    torch.cuda.synchronize()
    hits = collections.Counter()

    def show(message, category, filename, lineno, file=None, line=None):
        if 'synchroniz' not in str(message):
            return
        frames = [f for f in traceback.extract_stack()[:-1]
                  if f.filename.startswith(root)
                  and not f.filename.endswith('sync_probe.py')]
        f = frames[-1] if frames else None
        hits['%s:%d %s' % (os.path.relpath(f.filename, root), f.lineno,
                           f.line) if f else '?'] += 1

    torch.cuda.set_sync_debug_mode('warn')
    try:
        with warnings.catch_warnings():
            warnings.simplefilter('always')
            warnings.showwarning = show
            fn()
    finally:
        torch.cuda.set_sync_debug_mode('default')
    return hits


def main():
    from nnest_torch import NestedSampler
    from nnest_torch.likelihoods import Gaussian
    if not torch.cuda.is_available():
        print('sync_probe: CUDA is not available', file=sys.stderr)
        return 2
    d = 16
    s = NestedSampler(d, Gaussian(d, 0.0), transform=lambda x: 5.0 * x,
                      log_dir=None, seed=1, device='cuda', log_level=30)
    s.trainer.ensure_init()
    u, logl, derived = chip_smoke.synthetic_shell(s)
    lstar = float(logl.min())
    root = os.getcwd()
    for name, fn in (
            ('metropolis, 1 a dispatch', lambda: s._mcmc_sample_live(
                80, u, logl, 256, lstar, 0.25, dynamic_step_size=True,
                adapt_cov=True)),
            ('metropolis, 8 a dispatch', lambda: s._mcmc_generations_batch(
                80, u, logl, derived, 256, 0.25, 0, 10 ** 9, 8,
                dynamic_step_size=True, adapt_cov=True)),
            ('metropolis, 8 a dispatch, speculating',
             lambda: s._mcmc_generations_batch(
                 80, u, logl, derived, 256, 0.25, 0, 10 ** 9, 8,
                 dynamic_step_size=True, speculate=True, adapt_cov=True)),
            ('prior rejection, 1 a dispatch',
             lambda: s._rejection_prior_sample(lstar, num_trials=4096)),
            ('prior rejection, 8 a dispatch',
             lambda: s._rejection_prior_generations_batch(
                 u, logl, derived, 0, 2 ** 30, [], np.float32(1e30), 125,
                 4096, 8, False, False, False))):
        hits = sync_sites(fn, root)
        print(name, sum(hits.values()))
        for site, n in hits.most_common():
            print('   %4d  %s' % (n, site))
        sys.stdout.flush()
    return 0


if __name__ == '__main__':
    sys.exit(main())
