"""One run of one cell: set-up, the measured window, the comparison and the
metrics.

A job is one ``NestedSampler.run`` over one band of a run, in a run
directory of its own under ``TMPDIR`` that is removed once read, with the
trainer's files and TensorBoard events as the defaults write them. Jobs
run back to back, one at a time (one user's process stepping one
sampler). A run's work is fixed: ``seconds // job_seconds`` jobs (at least
one), ``job_seconds`` from the band, and the window runs from the first
job's start to the last job's end. The garbage collector runs between jobs
and at no other time in the window, so every run does the same work. A deep band starts each job
from a live set that the configuration's likelihood kind draws within the
band's contour (``init_points``); a prior band (``start`` ``prior``) starts
each job from the prior. A band's ``trainer`` is ``shared`` (one
``Trainer`` across its jobs, as the dynamic sampler's batches do) or
``per_job`` (a fresh sampler and trainer a job, as a user's run does). The
configuration's ``flow_args`` go alike to the shared ``Trainer`` and to
every job's ``NestedSampler``. Set-up is the imports, the three libraries
(built into ``nnest_torch/csrc/build/`` on a checkout's first run), the
bands' live sets and one short warm-up job on the cell's own shapes.

With ``trace`` the first job of the window runs under ``torch.profiler``
and the cell's per-layer metrics are read; without it its end-to-end
metrics."""

from __future__ import annotations

import contextlib
import gc
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

from harness import cells, check, costs, guard, likelihood, trace as tracing
from harness.hooks import Hooks
from harness.traffic import job_seed
from reference.consume import consumption_counts


def _log(*args):
    print(*args, file=sys.stderr, flush=True)


def power_limit():
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return 'unknown'
    return out[0].split(',')[-1].strip() if out else 'unknown'


def _close_writer(trainer):
    """Close a trainer's TensorBoard writer before its directory goes: the
    trainer never closes it, and its thread would write into a removed
    directory for the life of the process."""
    writer = getattr(trainer, 'writer', None)
    if writer is not None:
        writer.close()


def _sum_stats(jobs):
    stats = {}
    for job in jobs:
        for key, value in job.get('run_stats', {}).items():
            if isinstance(value, (int, float)) and not isinstance(value,
                                                                  bool):
                stats[key] = stats.get(key, 0) + value
    return stats


def run_cell(workload, config, traffic, limits, seed, seconds, trace,
             end_to_end, per_layer, device='cuda', control=None,
             t_start=None):
    """The result of one run: a dict with ``correct``, ``attempted``,
    ``failed``, ``metrics``, ``device``, ``breakdown`` when traced, and
    ``checks`` last. ``control='tf32'`` runs the control; TF32 is off
    otherwise (the float32 contract), and as it was once the run ends."""
    t_start = time.perf_counter() if t_start is None else t_start
    guard.keep_jax_out()
    import torch

    import nnest_torch  # noqa: F401  (sets the float32 contract: TF32 off)

    if control not in (None, 'tf32'):
        raise ValueError('unknown control %r' % control)
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = (
        control == 'tf32')
    try:
        return _run_cell(workload, config, traffic, limits, seed, seconds,
                         trace, end_to_end, per_layer, device, control,
                         t_start)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32


def _run_cell(workload, config, traffic, limits, seed, seconds, trace,
              end_to_end, per_layer, device, control, t_start):
    import torch

    from nnest_torch import runtime
    from nnest_torch.ops import consume_pool as cp
    from nnest_torch.ops import fused_spline
    from nnest_torch.ops import spline_inverse as si
    from nnest_torch.samplers.nested import NestedSampler
    from nnest_torch.training.trainer import Trainer

    dev = torch.device(device)
    on_card = dev.type == 'cuda'
    if on_card:
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(3) as pool:
            for job in [pool.submit(m.load_library)
                        for m in (si, cp, runtime)]:
                job.result()

    like, transform = likelihood.build(config, dev)
    lk = config['likelihood']
    dim, n_live, hidden = lk['x_dim'], config['num_live_points'], \
        config['hidden_dim']
    deep = traffic['start'] != 'prior'
    run_kw = dict(config['run'], strategy=traffic['strategy'])
    flow_kw = cells.flow_args(config)
    hooks = Hooks(traffic['inverse_sample_stride'], control,
                  cells.flow_reference(config).inverse)
    root = tempfile.mkdtemp(prefix='portbench_')
    trainer = None
    if traffic['trainer'] == 'shared':
        # the arguments a NestedSampler gives the Trainer it makes
        trainer = Trainer(dim, hidden_dim=hidden, batch_size=100,
                          learning_rate=0.001,
                          log_dir=os.path.join(root, 'trainer'),
                          seed=job_seed(seed, 'trainer'), device=dev,
                          **flow_kw)
    n_jobs = max(1, int(seconds // traffic['job_seconds']))
    inits = {}
    if deep:
        kind = cells.kind(lk['kind'])
        for index in ['warmup'] + list(range(n_jobs)):
            inits[index] = kind.init_set(like, config, traffic, n_live,
                                         job_seed(seed, 'init %s' % index),
                                         dev)

    def job(index, max_iters, traced=False):
        rec = {'index': index}
        seed_j = job_seed(seed, index)
        job_dir = tempfile.mkdtemp(prefix='job_', dir=root)
        rows0, t0 = like.rows, time.perf_counter()
        span = hooks.span('pb.job') if traced else contextlib.nullcontext()
        sampler = None
        try:
            with span:
                sampler = NestedSampler(
                    dim, like, transform=transform, num_live_points=n_live,
                    hidden_dim=hidden, log_dir=job_dir, append_run_num=False,
                    resume=False, seed=seed_j, trainer=trainer, device=dev,
                    **flow_kw)
                hooks.begin_job(index, seed_j, sampler.trainer.model)
                kw = dict(run_kw, max_iters=max_iters)
                if deep:
                    u0, l0, floor = inits[index]
                    kw.update(init_points={'u': u0, 'logl': l0},
                              birth_floor=floor)
                    rec.update(init_u=u0, init_logl=l0)
                epochs0 = sampler.trainer.total_iters
                sampler.run(**kw)
            rec.update(u=np.array(sampler.saved_u, dtype=np.float64),
                       logl=np.array(sampler.loglikes, dtype=np.float64),
                       slots=np.array(sampler.thread_slots),
                       logz=float(sampler.logz), h=float(sampler.h),
                       run_stats=dict(sampler.run_stats),
                       epochs=sampler.trainer.total_iters - epochs0,
                       dead=len(sampler.loglikes) - n_live)
        except Exception:   # a job that raises is reported, not fatal
            rec['error'] = traceback.format_exc()
            _log('job %s failed:\n%s' % (index, rec['error']))
        finally:
            if sampler is not None and trainer is None:
                _close_writer(sampler.trainer)
            shutil.rmtree(job_dir, ignore_errors=True)
        rec['rows'] = like.rows - rows0
        rec['wall'] = time.perf_counter() - t0
        return rec

    prof = None
    try:
        with hooks.installed(trace):
            warm = job('warmup', traffic['warmup_iters'])
            if on_card:
                torch.cuda.synchronize()
            hooks.samples.clear()
            hooks.inverse_calls = hooks.inverse_rows = 0
            start = {'spline_inverse.launches': si.launches,
                     'consume_pool.launches': cp.launches,
                     'twin_calls': fused_spline.calls + cp.twin_calls}

            # the set-up's garbage goes now and the window's between jobs
            gc.collect()
            gc.freeze()
            gc.disable()
            jobs = []
            if trace and not warm.get('error'):
                # the traced job is the window's first
                from torch.profiler import ProfilerActivity, profile
                # the device's events only: the host's are ~5 a kernel
                # and would cost minutes to read
                prof = profile(activities=[ProfilerActivity.CUDA]
                               if on_card else [ProfilerActivity.CPU])
                prof.__enter__()
                hooks.traced = True
                if on_card:
                    hooks.profiler = prof
            w0 = t_window = time.perf_counter()
            if warm.get('error'):
                # a program that fails its warm-up runs no window
                jobs.append(warm)
                n_jobs = 0
            while len(jobs) < n_jobs:
                if jobs and time.perf_counter() - w0 > 2 * seconds:
                    _log('window cut after %d of %d jobs: over twice %s s'
                         % (len(jobs), n_jobs, seconds))
                    break
                traced = trace and not jobs
                jobs.append(job(len(jobs), traffic['max_iters'], traced))
                if traced:
                    if on_card:
                        torch.cuda.synchronize()
                    # the profiler's stop reads its events: not the run's
                    t_stop = time.perf_counter()
                    prof.__exit__(None, None, None)
                    w0 += time.perf_counter() - t_stop
                    hooks.profiler = None
                    _log('profiler stopped in %.3f s' % (
                        time.perf_counter() - t_stop))
                    hooks.traced = False
                gc.collect()
                rec = jobs[-1]
                _log('job %d: dead %s rows %d wall %.3f s trainings %s '
                     'epochs %s generations %s' % (
                         rec['index'], rec.get('dead'), rec['rows'],
                         rec['wall'],
                         rec.get('run_stats', {}).get('trainings'),
                         rec.get('epochs'),
                         {k: v for k, v in rec.get('run_stats', {}).items()
                          if k.endswith('_generations') and v}))
            w1 = time.perf_counter()
    finally:
        gc.enable()
        gc.unfreeze()
        if trainer is not None:
            _close_writer(trainer)
        shutil.rmtree(root, ignore_errors=True)

    found = guard.forbidden_modules()
    if found:
        raise SystemExit('forbidden modules loaded in the run: %s' % found)
    counts = None
    memory_peak = 0
    if on_card:
        counts = {'spline_inverse.launches':
                  si.launches - start['spline_inverse.launches'],
                  'consume_pool.launches':
                  cp.launches - start['consume_pool.launches'],
                  'twin_calls': fused_spline.calls + cp.twin_calls
                  - start['twin_calls']}
        memory_peak = int(torch.cuda.max_memory_allocated(dev))
    _log('counters: %s' % counts)
    # the program's state goes before the reference runs
    hooks.model = None
    del trainer
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    window_s = w1 - w0
    ok_jobs = [j for j in jobs if not j.get('error')]
    dead = sum(j['dead'] for j in ok_jobs)
    rows = sum(j['rows'] for j in jobs)
    values = check.readings(config, jobs, hooks.samples, counts, traffic,
                            dev)
    correct, checks = check.judge(values, limits['limits'],
                                  limits['not_compared'])

    metrics = {}
    if trace:
        t_read = time.perf_counter()
        summary = (tracing.summarize(prof.profiler.kineto_results,
                                     hooks.spans, hooks.untraced,
                                     hooks.epochs)
                   if prof is not None else None)
        _log('trace read in %.3f s: %s' % (
            time.perf_counter() - t_read,
            None if summary is None else {
                k: summary[k] for k in ('device_events', 'in_window',
                                        'window_s', 'busy_s',
                                        'untraced_s', 'untraced_epochs',
                                        'untraced_busy_s',
                                        'traced_window_s',
                                        'traced_busy_s')}))
        ctx = {'window_s': window_s, 'jobs': ok_jobs, 'dead': dead,
               'rows': rows, 'stats': _sum_stats(ok_jobs),
               'epochs': sum(j['epochs'] for j in ok_jobs),
               'config': config, 'traffic': traffic, 'costs': costs,
               'inverse_calls': hooks.inverse_calls,
               'inverse_rows': hooks.inverse_rows,
               'traced_inverse_rows': hooks.traced_inverse_rows,
               'traced_steps': hooks.traced_steps,
               'traced_pools': [
                   (n, m, d, k) + consumption_counts(
                       al.cpu().numpy(), fl.cpu().numpy(), cl.cpu().numpy())
                   for n, m, d, k, al, fl, cl in hooks.traced_pools],
               'trace': summary}
        for metric in per_layer:
            value = cells.reader(metric['name'])(ctx)
            if value is not None:
                metrics[metric['name']] = {'value': value,
                                           'unit': metric['unit']}
    elif dead:
        e2e = {'dead_points_per_s': dead / window_s,
               'calls_per_dead_point': rows / dead,
               'setup_s': t_window - t_start}
        for metric in end_to_end:
            metrics[metric['name']] = {'value': e2e[metric['name']],
                                       'unit': metric['unit']}
    _log('window %.3f s, %d jobs, %d dead points, %d likelihood rows, '
         'set-up %.3f s' % (window_s, len(jobs), dead, rows,
                            t_window - t_start))

    result = {'correct': bool(correct and dead > 0),
              'attempted': len(jobs),
              'failed': sum(1 for j in jobs if j.get('error')),
              'metrics': metrics}
    if on_card:
        result['device'] = {
            'platform': 'gpu', 'kind': torch.cuda.get_device_name(dev),
            'count': 1, 'memory_peak_bytes': memory_peak,
            'power_limit': power_limit(), 'torch': torch.__version__,
            'cuda': torch.version.cuda}
    else:
        result['device'] = {'platform': 'cpu', 'kind': 'cpu', 'count': 1,
                            'memory_peak_bytes': 0}
    if trace and summary is not None:
        result['device'].update(busy_s=summary['busy_s'],
                                window_s=summary['window_s'])
        result['breakdown'] = tracing.breakdown(summary)
    result['checks'] = checks
    return result
