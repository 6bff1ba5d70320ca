#!/usr/bin/env python3
"""Host time of a Metropolis pool generation at one and eight a dispatch.

Run from the repository root on a machine with the GPU:
``python3 tools/prefetch_probe.py``. On an untrained 16-D flow (the
phase-3 model of ``chip_smoke.py``, a synthetic shell of 1000 live points,
256 chains x 80 steps) it runs, in ``ROUNDS`` rounds of turns, eight
generations one a dispatch (``_mcmc_sample_live``), one batch of eight
without speculation and one with (``_mcmc_generations_batch``), each
served as the run serves it (``_consume_endpoint_out``), and prints the
wall a generation of every turn, the host's wait at the stop-flag read a
generation, and the host operations that take the most CPU time in one
profiled call of each.
"""

import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.getcwd())

import chip_smoke  # noqa: E402  (the repository root is on the path)

ROUNDS = 5


def main():
    from torch.profiler import ProfilerActivity, profile
    from nnest_torch import NestedSampler
    from nnest_torch.likelihoods import Gaussian
    from nnest_torch.samplers.kernels import LatentKernels
    if not torch.cuda.is_available():
        print('prefetch_probe: CUDA is not available', file=sys.stderr)
        return 2
    print(chip_smoke.phase_device()['gpu'], flush=True)
    d = 16
    s = NestedSampler(d, Gaussian(d, 0.0), transform=lambda x: 5.0 * x,
                      log_dir=None, seed=1, device='cuda', log_level=30)
    s.trainer.ensure_init()
    u, logl, derived = chip_smoke.synthetic_shell(s)
    lstar = float(logl.min())
    wait = {'s': 0.0, 'n': 0}
    host_ints = LatentKernels._host_ints

    def timed_host_ints(*tensors):
        t0 = time.perf_counter()
        out = host_ints(*tensors)
        wait['s'] += time.perf_counter() - t0
        wait['n'] += 1
        return out

    LatentKernels._host_ints = staticmethod(timed_host_ints)

    def one_a_dispatch():
        for _ in range(8):
            s._mcmc_sample_live(80, u, logl, 256, lstar, 0.25,
                                dynamic_step_size=True, adapt_cov=True)

    def batch(speculate):
        gens = s._mcmc_generations_batch(
            80, u, logl, derived, 256, 0.25, 0, 10 ** 9, 8,
            dynamic_step_size=True, adapt_cov=True, speculate=speculate)
        for out, _, _, _ in gens:
            s._consume_endpoint_out(out)

    modes = (('one a dispatch', one_a_dispatch),
             ('eight a dispatch', lambda: batch(False)),
             ('eight, speculating', lambda: batch(True)))
    for _, fn in modes:
        fn()
    walls = {name: [] for name, _ in modes}
    waits = []
    for _ in range(ROUNDS):
        for name, fn in modes:
            wait['s'], wait['n'] = 0.0, 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls[name].append((time.perf_counter() - t0) * 1e3 / 8)
            if name == 'eight a dispatch':
                waits.append(wait['s'] * 1e3 / max(wait['n'], 1))
    for name, w in walls.items():
        print('%-20s median %.2f ms a generation; turns %s' % (
            name, float(np.median(w)), ', '.join('%.2f' % x for x in w)))
    print('stop-flag read, eight a dispatch: %s ms a generation'
          % ', '.join('%.3f' % x for x in waits))
    for name, fn in modes:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        top = sorted(prof.key_averages(),
                     key=lambda e: -e.self_cpu_time_total)[:5]
        print(name, 'host ops by CPU time:')
        for e in top:
            print('   %-40s %8.1f ms  %d calls' % (
                e.key[:40], e.self_cpu_time_total / 1e3, e.count))
    return 0


if __name__ == '__main__':
    sys.exit(main())
