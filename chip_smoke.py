#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``nnest_torch``) on one GPU.

Run from the repository root: ``python3 chip_smoke.py``. It imports nothing
from JAX or ``nnest_tpu`` and runs four phases, printing one JSON line per
phase with its seconds:

1. device: the card's name and power limit (``nvidia-smi``), and the build
   of ``nnest_torch/csrc/spline_inverse.cu`` with its ``-Xptxas -v`` report;
2. kernel: the CUDA spline-flow inverse against its plain PyTorch twin on
   the card, at d in {2, 5, 16, 50} (hidden 16/16/32/64) and N in
   {1, 128, 256, 1000, 4096}, with inputs beyond ±3, exactly at ±3 and on
   spline knots; max |dx| <= 3e-5 and max |dlogdet| <= 3e-4. Then the kernel
   and the twin are timed with CUDA events (median) at (d=16, N=256) and
   (d=16, N=4096) beside the least time the card could take;
3. main path: ``NestedSampler`` on a 16-D Gaussian (transform 5x, hidden 32,
   256 chains x 80 steps, default strategy and retrain gate) until the
   ladder has reached 'mcmc', the flow has been trained and at least three
   MCMC generations have run; the kernel's launch counter must be > 0;
4. correctness: the 2-D Gaussian (transform 3x, 200 live points) to
   completion; logz within max(3 logzerr, 0.15) of the analytic value.

Before the last line it prints the ``{"kernels": [...]}`` record; the last
line is ``{"ok": true, "device": {...}}``. Any failure raises and exits
non-zero before that line.
"""

import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet): f32 outside the tensor cores, HBM3.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
TOL_X = 3e-5
TOL_LOGDET = 3e-4


def emit(obj):
    print(json.dumps(obj), flush=True)


def hidden_for(d):
    """The samplers' capacity autoscale (samplers/base.py)."""
    return 16 if d < 16 else (32 if d < 32 else 64)


def cuda_time_ms(fn, reps=10, calls=20, warmup=5):
    """Per-call device time: CUDA events around ``calls`` back-to-back
    calls, divided by ``calls``; the median over ``reps`` such runs. Queued
    back to back, the calls hide the host's launch cost behind the
    device's work wherever the device is the slower of the two."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return float(np.median(times))


def rqs_inverse_ops(k):
    """f32 operations the RQS inverse of one value needs with K = k bins
    (each exp, log, log1p, sqrt, division, comparison and select counted
    as one), as the function is defined, not as the kernel computes it:

    - width and height pre-normalisation, two softmaxes of 5K - 2 (max,
      subtract, exp, sum, divide) and the 2B scale: 12K - 4;
    - the knots, two more softmaxes and two cumulative sums of 5 per
      interior knot: 20K - 14;
    - the K - 1 interior derivatives, min + softplus(softplus(.)) at 13
      each (the pinned ends are constants): 13K - 13;
    - the clamp to [-B, B] and the K comparisons y >= edge_k: K + 2;
    - the chosen bin's width, height and slope: 3;
    - the quadratic's coefficients, clamped discriminant, guarded and
      clipped root, the output, the logdet's numerator, denominator and
      logs, and the tail select: 52.
    """
    return 46 * k + 26


def inverse_cost(n, d, hidden, num_bins, num_blocks, param_floats):
    """(operations, bytes) the whole-chain inverse needs for n rows.

    Operations per row and block: the two conditioner MLPs' multiply-adds
    (2 each), bias adds and LeakyReLUs; the RQS inverse of each of the d
    dims (``rqs_inverse_ops``); the per-dim logdet sum; the x @ W^-1
    product; and the affine (x - t) * e^-s, whose e^-s is parameter-only
    and counted once per block. Then the constant logdet add per row.
    Bytes: z read once, the packed parameters read once, x and logdet
    written once."""
    per = 3 * num_bins - 1
    cut = d - d // 2
    up = d - cut

    def mlp(n_in, n_out):
        return (2 * (n_in * hidden + 2 * hidden * hidden + hidden * n_out)
                + 6 * hidden + n_out)

    per_block = (mlp(up, cut * per) + mlp(cut, up * per)
                 + d * rqs_inverse_ops(num_bins) + d + 2 * d * d + 2 * d)
    ops = n * (num_blocks * per_block + 1) + num_blocks * 2 * d
    nbytes = 4 * (2 * n * d + n + param_floats)
    return ops, nbytes


def bound_ms(ops, nbytes):
    t_ops = ops / PEAK_F32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ('operations' if t_ops >= t_bytes
                                 else 'bytes')


def random_flow(d, seed, device):
    """A random spline flow at the autoscaled width, ActNorm initialised on
    a non-trivial data batch so every block is off the identity."""
    from nnest_torch.flows import build_flow
    model = build_flow(d, hidden_dim=hidden_for(d), seed=seed, device=device)
    g = torch.Generator(device=device).manual_seed(seed)
    data = 0.7 * torch.randn(512, d, generator=g, device=device) + 0.3
    model.data_init(data)
    return model


def kernel_inputs(model, n, seed, device):
    """z ~ N(0, 2^2) with rows beyond ±3, exactly at ±3, and on the knots of
    the first spline the inverse meets (last block's lower half)."""
    from nnest_torch.bijectors.rqs import knots
    d = model.dim
    g = torch.Generator(device=device).manual_seed(seed)
    z = 2.0 * torch.randn(n, d, generator=g, device=device)
    if n >= 4:
        z[0, :] = 3.0
        z[1, :] = -3.0
        z[2, :] = 4.5
    if n >= 8:
        sc = model.chain.bijectors[-1]
        with torch.no_grad():
            W, H, _ = sc.knots(sc.f2, z[:, sc.cut:], sc.cut)
            _, ch = knots(W, H, sc.tail_bound)
        k = (torch.arange(3, n, device=device) % (sc.num_bins + 1))
        z[3:, :sc.cut] = ch[3:].gather(
            2, k.view(-1, 1, 1).expand(-1, sc.cut, 1)).squeeze(2)
    return z.contiguous()


def phase_device():
    from nnest_torch.ops import spline_inverse as si
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.time()
    si.load_library()
    build_s = time.time() - t0
    ptxas = [line.strip() for line in si.build_log.splitlines()
             if 'ptxas' in line and ('Used' in line or 'spill' in line)]
    for line in ptxas:
        print(line, flush=True)
    return {'gpu': smi, 'kind': torch.cuda.get_device_name(0),
            'count': torch.cuda.device_count(),
            'torch': torch.__version__, 'cuda': torch.version.cuda,
            'build_seconds': build_s, 'ptxas': ptxas}


def phase_kernel(record):
    from nnest_torch.ops import spline_inverse as si
    from nnest_torch.ops.fused_spline import _inverse_body, pack_inverse_consts
    device = torch.device('cuda')
    worst_x, worst_ld, cases = 0.0, 0.0, []
    for d in (2, 5, 16, 50):
        model = random_flow(d, seed=100 + d, device=device)
        packed = pack_inverse_consts(model)
        for n in (1, 128, 256, 1000, 4096):
            z = kernel_inputs(model, n, seed=7 * n + d, device=device)
            x_k, ld_k = si.spline_inverse(z, packed)
            x_p, ld_p = _inverse_body(z, packed)
            torch.cuda.synchronize()
            if not (torch.isfinite(x_k).all() and torch.isfinite(ld_k).all()):
                raise AssertionError('non-finite kernel output at d=%d n=%d'
                                     % (d, n))
            ex = float((x_k - x_p).abs().max())
            eld = float((ld_k - ld_p).abs().max())
            cases.append({'d': d, 'n': n, 'max_abs_dx': ex,
                          'max_abs_dlogdet': eld})
            worst_x, worst_ld = max(worst_x, ex), max(worst_ld, eld)
            if ex > TOL_X or eld > TOL_LOGDET:
                raise AssertionError(
                    'kernel disagrees with its twin at d=%d n=%d: '
                    'dx %.3g (tol %g), dlogdet %.3g (tol %g)'
                    % (d, n, ex, TOL_X, eld, TOL_LOGDET))

    timings = {}
    model = random_flow(16, seed=116, device=device)
    packed = pack_inverse_consts(model)
    flat = si.pack_kernel_params(packed)
    for n in (256, 4096):
        z = kernel_inputs(model, n, seed=n, device=device)
        ms = cuda_time_ms(lambda: si.spline_inverse(z, packed))
        plain_ms = cuda_time_ms(lambda: _inverse_body(z, packed))
        ops, nbytes = inverse_cost(n, 16, hidden_for(16), 8, 3, flat.numel())
        b_ms, b_by = bound_ms(ops, nbytes)
        timings[n] = {'ms': ms, 'plain_ms': plain_ms, 'bound_ms': b_ms,
                      'bound_by': b_by, 'ops': ops, 'bytes': nbytes}
    record.update({
        'max_abs_err': worst_x,
        'max_abs_err_logdet': worst_ld,
        'ms': timings[256]['ms'], 'plain_ms': timings[256]['plain_ms'],
        'bound_ms': timings[256]['bound_ms'],
        'bound_by': timings[256]['bound_by'],
        'shape': 'd=16 hidden=32 K=8 blocks=3 N=256',
        'ms_n4096': timings[4096]['ms'],
        'plain_ms_n4096': timings[4096]['plain_ms'],
        'bound_ms_n4096': timings[4096]['bound_ms'],
        'bound_by_n4096': timings[4096]['bound_by'],
    })
    return {'cases': cases, 'max_abs_dx': worst_x,
            'max_abs_dlogdet': worst_ld,
            'timings': {str(k): v for k, v in timings.items()}}


def phase_main_path(record, log_dir):
    from nnest_torch import NestedSampler
    from nnest_torch.likelihoods import Gaussian
    from nnest_torch.ops import spline_inverse as si
    d = 16
    like = Gaussian(d, 0.0)
    sampler = NestedSampler(d, like, transform=lambda x: 5.0 * x,
                            log_dir=os.path.join(log_dir, 'main'),
                            seed=1, device='cuda')
    si.launches = 0
    t0 = time.time()
    sampler.run(max_iters=5200, train_iters=100)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = si.launches
    record['launches'] = launches
    stats = sampler.run_stats
    if launches <= 0:
        raise AssertionError('the main path never launched the kernel')
    if stats['mcmc_generations'] < 3 or stats['trainings'] < 1:
        raise AssertionError('main path did not reach 3 MCMC generations '
                             'and a training: %s' % stats)
    if not math.isfinite(sampler.logz):
        raise AssertionError('non-finite logz %r' % sampler.logz)
    return {'wall_s': wall, 'launches': launches, 'iterations': sampler.niter,
            'ncall': sampler.total_calls, 'logz_so_far': sampler.logz,
            **stats, 'generation_profile': profile_mcmc_generation(sampler)}


def profile_mcmc_generation(sampler, mcmc_steps=80, num_chains=256):
    """One MCMC pool generation at the main path's shape on a synthetic
    shell (live points ~ N(0, 0.3^2) in the unit cube): its wall time
    without and with the profiler, device busy time by kernel from the
    profiler's CUDA events, and the spline kernel's share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    g = torch.Generator(device='cuda').manual_seed(5)
    u = torch.clamp(0.3 * torch.randn(1000, sampler.x_dim, generator=g,
                                      device='cuda'), -1.0, 1.0)
    u = u.cpu().numpy().astype(np.float64)
    logl = sampler.loglike(u)

    def generation():
        sampler._mcmc_sample_live(
            mcmc_steps, u, logl, num_chains, float(np.min(logl)),
            1.0 / sampler.x_dim ** 0.5, dynamic_step_size=True,
            adapt_cov=True)
        torch.cuda.synchronize()

    generation()
    t0 = time.perf_counter()
    generation()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        generation()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            ms, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    busy_ms = sum(ms for ms, _ in by_name.values())
    spline = [(ms, n) for name, (ms, n) in by_name.items()
              if 'spline_inverse' in name]
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
    return {
        'wall_ms': wall_ms, 'profiled_wall_ms': prof_wall_ms,
        'device_busy_ms': busy_ms if by_name else 'not measured',
        'device_busy_share': (busy_ms / prof_wall_ms if by_name
                              else 'not measured'),
        'kernel_launches': sum(n for _, n in by_name.values()),
        'spline_inverse_ms': sum(ms for ms, _ in spline),
        'spline_inverse_launches': sum(n for _, n in spline),
        'top_kernels': [{'name': name[:80], 'ms': ms, 'count': n}
                        for name, (ms, n) in top],
    }


def phase_correctness(log_dir):
    from nnest_torch import NestedSampler
    from nnest_torch.likelihoods import Gaussian
    like = Gaussian(2, 0.0, lim=3)
    sampler = NestedSampler(2, like, transform=lambda x: 3.0 * x,
                            num_live_points=200,
                            log_dir=os.path.join(log_dir, 'gauss2'),
                            seed=42, device='cuda')
    t0 = time.time()
    sampler.run(train_iters=200, dlogz=0.1)
    wall = time.time() - t0
    analytic = like.analytic_logz([-3.0, -3.0], [3.0, 3.0])
    err = max(3.0 * sampler.logzerr, 0.15)
    ok = abs(sampler.logz - analytic) <= err
    out = {'wall_s': wall, 'logz': sampler.logz, 'logzerr': sampler.logzerr,
           'analytic_logz': analytic, 'allowed': err,
           'niter': sampler.niter, 'ncall': sampler.total_calls}
    if not ok:
        raise AssertionError('2-D Gaussian logz off the analytic value: %s'
                             % out)
    return out


def main():
    if not torch.cuda.is_available():
        print('chip_smoke: CUDA is not available', file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import nnest_torch  # noqa: F401  (fails outside a checkout of the repo)

    record = {'name': 'spline_inverse', 'route': 'cuda',
              'source': 'nnest_torch/csrc/spline_inverse.cu',
              'replaces': 'nnest_tpu/ops/pallas_spline.py:338',
              'launches': None, 'library_ms': None}
    with tempfile.TemporaryDirectory(prefix='chip_smoke_') as log_dir:
        for num, name, fn in (
                (1, 'device', phase_device),
                (2, 'kernel', lambda: phase_kernel(record)),
                (3, 'main_path', lambda: phase_main_path(record, log_dir)),
                (4, 'correctness', lambda: phase_correctness(log_dir))):
            t0 = time.time()
            out = fn()
            emit({'phase': num, 'name': name,
                  'seconds': time.time() - t0, **out})
    emit({'kernels': [record]})
    emit({'ok': True, 'device': {'platform': 'gpu',
                                 'kind': torch.cuda.get_device_name(0),
                                 'count': torch.cuda.device_count()}})
    return 0


if __name__ == '__main__':
    sys.exit(main())
