"""The comparison that decides ``correct``, run once the window has closed.

Each job's record (every dead point and the final live set, as the run
returned them) is held to the plain reference in ``reference/``:

- ``logl_gap``: the widest gap between a saved point's logl and the float64
  likelihood of the configuration's kind at that point (nats);
- ``logz_gap``, ``h_gap``: the band's evidence and information as the run
  returned them against the reference's, worked out in float64 from the
  reference's own logl at the same points;
- ``order_violations``: dead points that were not the live set's lowest or
  not the point then holding their slot; ``contour_violations``: births
  not strictly above their contour or outside the box (exact, limit 0);
- ``inverse_x_gap``, ``inverse_logdet_gap``: the hot inverse's output (the
  spline kernel's, or the flow's own ``inverse`` where no kernel covers
  it) at calls sampled from the window against the float64 inverse of the
  configuration's flow reference at the flow's parameters at that call;
  read wherever the window sampled hot-inverse calls, and wherever the
  band requires the spline kernel or runs Metropolis chains, which then
  have to have been sampled (``missing_samples``);
- ``failed_jobs``, ``twin_calls``, ``missing_kernels``,
  ``forbidden_generations``, ``missing_samples``: counts held to 0.

Each number passes when it is at most its limit; a number with no limit
measured yet fails."""

from __future__ import annotations

import numpy as np
import torch

from harness import cells
from reference import evidence, replay

EXACT = ('failed_jobs', 'order_violations', 'contour_violations',
         'twin_calls', 'missing_kernels', 'forbidden_generations',
         'missing_samples')


def job_readings(job, ref, n_live):
    """The numbers of one job's record (a dict of the run's outputs);
    ``ref`` is the float64 likelihood of cube points."""
    u, logl = job['u'], job['logl']
    logl_ref = ref(u)
    order, contour = replay.replay(u, logl, job['slots'], n_live,
                                   job.get('init_u'), job.get('init_logl'))
    dead = logl.shape[0] - n_live
    logz_ref, h_ref = evidence.band_evidence(logl_ref[:dead],
                                             logl_ref[dead:], n_live)
    return {'logl_gap': float(np.max(np.abs(logl - logl_ref))),
            'logz_gap': abs(job['logz'] - logz_ref),
            'h_gap': abs(job['h'] - h_ref),
            'order_violations': order, 'contour_violations': contour}


def inverse_readings(samples, device, inverse):
    """Widest gaps of the sampled hot-inverse calls against the float64
    reference ``inverse``, computed on ``device``."""
    x_gap = ld_gap = 0.0
    for _, z, x, logdet, state in samples:
        with torch.no_grad():
            state64 = {k: v.to(device, torch.float64)
                       for k, v in state.items()}
            xr, ldr = inverse(state64, z.to(device, torch.float64))
        x_gap = max(x_gap, float(torch.max(torch.abs(
            x.to(device, torch.float64) - xr))))
        ld_gap = max(ld_gap, float(torch.max(torch.abs(
            logdet.to(device, torch.float64) - ldr))))
    return {'inverse_x_gap': x_gap, 'inverse_logdet_gap': ld_gap}


def readings(config, jobs, samples, counts, traffic, device):
    """Every number the cell compares, the widest over its jobs."""
    lk = config['likelihood']
    ref = cells.reference_kind(lk['kind']).loglike(lk)
    out = {name: 0 for name in EXACT}
    out.update({'logl_gap': 0.0, 'logz_gap': 0.0, 'h_gap': 0.0})
    for job in jobs:
        if job.get('error'):
            out['failed_jobs'] += 1
            continue
        for name, value in job_readings(job, ref,
                                        config['num_live_points']).items():
            out[name] = (out[name] + value if name in EXACT
                         else max(out[name], value))
        for stem in traffic.get('forbid_generations', []):
            out['forbidden_generations'] += job['run_stats'].get(
                stem + '_generations', 0)
    required = ('spline_inverse' in traffic.get('require_launches', [])
                or ('mcmc' in traffic.get('strategy', [])
                    and 'mcmc' not in traffic.get('forbid_generations', [])))
    if required:
        out['missing_samples'] = int(not samples)
    if required or samples:
        out.update(inverse_readings(samples, device,
                                    cells.flow_reference(config).inverse))
    if counts is not None:
        # the card's counters (on the CPU the plain twins are the path)
        out['twin_calls'] = counts['twin_calls']
        out['missing_kernels'] = sum(
            1 for name in traffic.get('require_launches', [])
            if counts[name + '.launches'] == 0)
    return out


def judge(values, limits, not_compared=()):
    """(correct, {name: {'value', 'limit'}}): each number beside its limit
    (exact counts 0); a number without a limit is not correct, and one the
    cell's limits file names as not compared is shown with no limit."""
    checks, correct = {}, True
    for name, value in values.items():
        if name in not_compared:
            checks[name] = {'value': value, 'limit': 'not compared'}
            continue
        limit = 0 if name in EXACT else limits.get(name)
        ok = limit is not None and value <= limit
        correct = correct and ok
        checks[name] = {'value': value, 'limit': limit}
    return correct, checks
