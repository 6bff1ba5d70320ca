#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``nnest_torch``) on one GPU.

Run from the repository root: ``python3 chip_smoke.py``. It imports nothing
from JAX or ``nnest_tpu`` and runs thirteen phases, printing one JSON line
per phase with its seconds:

1. device: the card's name and power limit (``nvidia-smi``), and the build
   of ``nnest_torch/csrc/spline_inverse.cu`` with the ``-Xptxas -v``
   registers and spills of every instantiation;
2. kernel: the CUDA spline-flow inverse against its plain PyTorch twin on
   the card, at d in {2, 5, 16, 50, 100} (hidden 16/16/32/64/64) and N in
   {1, 128, 256, 512, 1000, 4096, 4097}, and at d in {16, 50} with N in
   {65536, 65537} (the flow strategies' trials), and at d = 16 with N in
   {16, 32, 32064} (phase 10's shapes) and N = 200 (phase 11's seed
   refresh), and at d = 2 with N in {10, 16, 32, 64, 32064, 128064}
   (phase 13's command lines: chains, half-updates, the ensemble's starts
   and trajectories), with inputs beyond ±3, exactly at
   ±3 and on spline knots; max |dx| <= 3e-5 and max |dlogdet| <= 3e-4.
   The per-block entry against the twin (the same limits) and against the
   whole-chain kernel (1e-6, 1e-5) at d in {5, 16}. Then the kernel is
   timed by CUDA-graph replay (and eagerly, back to back) and the twin
   eagerly, at the main path's shapes (N = 512, a slice expansion's
   2 x 256 stacked rows, N = 65536, phase 10's N = 16, 32 and 32064,
   phase 11's N = 200 and phase 13's d = 2 shapes included) beside the
   least time the card could take;
   the per-block
   entry at d = 16; and the rows a thread block takes and the ring's
   stages are swept (N = 65536: 32, 64 and 128 rows);
3. main path: ``NestedSampler`` on a 16-D Gaussian (transform 5x, hidden 32,
   256 chains x 80 steps, default strategy and retrain gate) until the
   ladder has reached 'mcmc', the flow has been trained and at least three
   MCMC generations have run; the kernel's launch counter must be > 0;
   then the same run with its trainer's files and TensorBoard events on,
   its files alone, and neither, in turns, and the host cost of one
   TensorBoard scalar, for what the run tooling costs;
4. correctness: the 2-D Gaussian (transform 3x, 200 live points) to
   completion; logz within max(3 logzerr, 0.15) of the analytic value,
   and ``diagnostics.json`` with every key and a finite
   ``logzerr_adjusted``;
5. per-block entry: ``spline_inverse_per_block`` called as a user would, on
   a 16-D flow at 256 rows, with its own launch counter, against the
   whole-chain kernel;
6. flow rejection: ``NestedSampler`` on the 16-D Gaussian (transform 5x,
   hidden 32, 1000 live points, ``train_iters=100``) with
   ``['rejection_flow', 'mcmc']`` at 65536 trials a generation, cut by
   ``max_iters`` after at least three generations and a training; the
   kernel's launches on the path (> 0) and the plain twin's calls (0);
   the wall of each generation, a profile of one and its parts; then one
   ``density_flow`` generation at 65536 trials with its own counts;
7. resume: the 2-D Gaussian with ``['rejection_flow', 'mcmc']``,
   uninterrupted against killed at ``max_iters=120`` and resumed by a
   sampler built with another seed; both within max(3 logzerr, 0.15) of
   the analytic logz, and whether (logz, h, ncall, niter) are equal;
8. slice: the phase-3 model (1000 live points, 256 chains) with
   ``['rejection_prior', 'slice']``, switched to slice at iteration 4000
   by ``volume_switch`` and cut by ``max_iters=5000`` after at least three
   slice generations and a training; the kernel's launches on the path
   (> 0, all of them in the slice generations), the twin's calls (0), no
   MCMC generation; the launches and wall of each generation and a profile
   of one; then the 2-D Gaussian with ``['rejection_prior', 'slice']`` to
   its analytic logz within max(3 logzerr, 0.15);
9. other flows: one run each of ``flow='nvp'`` (2-D), ``flow='cholesky'``
   (2-D) and ``flow='spline', num_slow=2`` (4-D) on the Gaussian
   (transform 3x, 200 live points, MCMC after a volume switch) to its
   analytic logz within the same bound; their inverse is ``model.inverse``
   in plain PyTorch, so the kernel's launches and the twin's calls must
   both be 0;
10. posterior samplers: ``MCMCSampler.run`` (2000 full-MH steps, 16 chains)
   and ``EnsembleSampler.bootstrap`` (200 steps, 64 walkers, one phase)
   then ``run`` (500 steps) on the 16-D Gaussian with correlation 0.9 in
   the box [-5, 5]^16, trained on 1000 exact draws (hidden 32, 50 epochs
   at most); the kernel's launches equal to one a step plus one a call
   (MCMC) and two a step plus two a call (ensemble), the twin's calls 0,
   the moments within bounds from each run's ESS, the final step size
   finite and positive; the wall and launches of every sampler call and a
   profile of one ``_mcmc_sample`` (500 steps) and one ``_ensemble_sample``
   (100 steps) call;
11. dynamic: ``DynamicNestedSampler`` on the phase-3 model (1000 live points
   in batch 0, batches of the default 200, 256 chains x 80 steps), each
   batch switched to MCMC at iteration ~2000 by ``volume_switch`` and cut at
   ``max_iters=2400`` (``dlogz=1e-3``), ``train_iters=20``, one batch above
   a finite floor (``G=1``): every seeded logl above the floor, the seed
   refresh one launch a step plus one at N = 200, the batch ended above its
   ceiling or at ``max_iters``, the kernel's launches on the path (> 0) and
   the twin's calls (0); then the 2-D Gaussian dynamic run (200 live points,
   batches of 100) to its analytic logz within max(3 logzerr, 0.15),
   uninterrupted and killed after batch 1 then resumed, and whether (logz,
   h, ncall, niter) are equal; then a 2-D nested run with a numpy-only
   likelihood (called on the host with float64 numpy) to its analytic logz
   within the same bound, with the kernel's launches (> 0) and the twin's
   calls (0);
12. derived: the phase-3 model with a torch likelihood returning three
   derived parameters (sum x, |x|^2, x0 x1; ``num_derived=3``), cut at
   ``max_iters=5200`` with ``train_iters=20``: at least three MCMC
   generations, ``samples`` with 19 columns whose derived columns equal the
   float32 function of the parameter columns (rtol and atol 1e-4),
   ``chain.txt`` with 21; ``MCMCSampler`` (16 chains, 500 steps) and
   ``EnsembleSampler.run`` (64 walkers, 200 steps) on phase 10's model with
   the same derived parameters and 10 training epochs, checked the same
   way; the 2-D dynamic run (two batches) with a numpy likelihood returning
   them, to its analytic logz within max(3 logzerr, 0.15); each run with
   the kernel's launches (> 0) and the twin's calls (0); then one MCMC
   generation of the 16-D model profiled with ``num_derived`` 3 and 0 on
   the same flow, and the device kernels a step that derived adds;
13. cli: the port's command lines called in-process as a user runs them:
   ``nnest_torch.cli.nested`` at its defaults on the 2-D Rosenbrock (1000
   live points, ``--train_iters 2000``, 10 chains, seed 0) to logZ within
   0.2 of -5.80, with ``results/final.csv``, ``chains/chain.txt``,
   ``info/params.txt``, ``models/netG.pkl`` and ``data/originals.npy``,
   and the flow of ``netG.pkl`` reloaded by ``Trainer(load_model=)`` giving
   the same log_prob on 1000 points to 1e-6; a second, smaller run under
   the same root (200 live points, ``--train_iters 200``, seed 1) and
   ``nnest_torch.cli.analyse`` over both (``--merge``), which must print
   ``logz=`` and a posterior ESS; ``nnest_torch.cli.ensemble`` with
   ``--sampler mcmc`` (16 chains) and ``--sampler ensemble`` (64 walkers,
   500-step bootstrap) on the 2-D Rosenbrock, ``--mcmc_steps`` cut to 2000,
   with finite samples and the kernel's launches one a step plus one a
   call and two a step plus two a call; which of tqdm, matplotlib and
   TensorBoard the machine has, and the plots and event files written
   exactly when they are there; and an epoch of the 2-D flow's training
   (1000 rows, 9 steps) with its steps eager and replayed as a CUDA graph,
   timed in turns, and one graphed epoch profiled.

``--baseline SRC`` also builds SRC, an earlier version of the kernel with
its own C entry point (the unpadded layout, no launch plan), checks it
against the twin and times it beside this kernel at every phase-2 shape
and the sweep's, in turns (earlier, this, this, earlier).

Before the last line it prints the ``{"kernels": [...]}`` record, with each
kernel's launches by path (``mcmc``: phase 3, ``rejection_flow`` and
``density_flow``: phase 6, ``per_block``: phase 5, ``slice``: phase 8,
``mcmc_sampler`` and ``ensemble``: phase 10, ``dynamic`` and
``host_likelihood``: phase 11, ``derived``: phase 12, ``cli``: phase 13);
the last line is
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero
before that line.
"""

import json
import math
import os
import re
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
# the flow strategies' trials a generation (bench.py's workload D)
FLOW_TRIALS = 65536
# phase 10's sizes: the CLI's widths (examples/ensemble/run.py: 16 chains,
# 64 walkers), depth cut to these steps and training epochs
MCMC_STEPS, MCMC_CHAINS = 2000, 16
BOOT_STEPS, RUN_STEPS, WALKERS = 200, 500, 64
POSTERIOR_TRAIN_ITERS = 50
# phase 11's sizes: the phase-3 model with 1000 live points in batch 0 and
# the default 1000 // 5 = 200 in a batch; depth cut by a volume switch to
# MCMC at iteration ~2000 and these iterations and training epochs a batch
DYN_LIVE, DYN_BATCH_LIVE = 1000, 200
DYN_MAX_ITERS, DYN_TRAIN_ITERS = 2400, 20
DYN_SWITCH = math.exp(-2.0)
# phase 12's sizes: the phase-3 model with three derived parameters, cut to
# these iterations and training epochs; the posterior samplers' training
# epochs
DERIVED = 3
DERIVED_MAX_ITERS, DERIVED_TRAIN_ITERS = 5200, 20
DERIVED_POSTERIOR_EPOCHS = 10
# phase 13's command lines: the nested one at its defaults; the ensemble
# one at its widths with --mcmc_steps cut to this; the 2-D Rosenbrock's
# evidence (tests/test_nested.py) and the error allowed
CLI_MCMC_STEPS = 2000
CLI_WALKERS, CLI_BOOT_STEPS = 64, 500   # the ensemble command's defaults
ROSENBROCK_LOGZ, ROSENBROCK_TOL = -5.80, 0.2
# the keys of results/diagnostics.json (nnest_tpu's set)
DIAGNOSTICS_KEYS = {
    'insertion_D', 'insertion_p', 'insertion_rolling_p', 'logzerr',
    'logzerr_bootstrap', 'n_ranks', 'mixing_min_ratio',
    'mixing_min_ratio_eig', 'mixing_rel_ratio', 'latent_cond_median',
    'latent_cond_rel', 'n_mix_windows', 'logzerr_adjusted',
    'quality_flags'}


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


def graph_time_ms(fn, reps=10, calls=20):
    """Per-call device time of a kernel: ``calls`` calls captured in one
    CUDA graph, the graph replayed between CUDA events, divided by
    ``calls``; the median over ``reps`` replays. The host's launch cost
    stays out of the reading, which back-to-back eager calls
    (``cuda_time_ms``) cannot promise where a call's host work outlasts
    its device work."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return float(np.median(times))


def rqs_inverse_ops(k):
    """f32 operations the RQS inverse of one value needs with K = k bins
    (each exp, log, log1p, sqrt, division, comparison and select counted
    as one), as the function is defined, not as a kernel computes it:

    - width and height pre-normalisation, two softmaxes of 5K - 2 (max,
      subtract, exp, sum, divide) and the 2B scale: 12K - 4;
    - the knots, two more softmaxes and two cumulative sums of 5 per
      interior knot: 20K - 14;
    - the clamp to [-B, B] and the K comparisons y >= edge_k: K + 2;
    - the chosen bin's width, height and slope: 3;
    - the derivatives at the chosen bin's two knots, min +
      softplus(softplus(.)) at 13 each (a pinned end is a constant): 26;
    - the quadratic's coefficients, clamped discriminant, guarded and
      clipped root, the output, the logdet's numerator, denominator and
      logs, and the tail select: 52.
    """
    return 33 * k + 65


def inverse_cost(n, d, hidden, num_bins, num_blocks):
    """(operations, bytes) the chain inverse needs for n rows.

    Operations per row and block: the two conditioner MLPs' multiply-adds
    (2 each), bias adds and LeakyReLUs; the RQS inverse of each of the d
    dims (``rqs_inverse_ops``); the per-dim logdet sum; the x @ W^-1
    product; and the affine (x - t) * e^-s, whose e^-s is parameter-only
    and counted once per block. Then the constant logdet add per row.
    Bytes: z read once, the parameters (unpadded: s, t, W^-1 and the MLPs
    of every block, and the constant) read once, x and logdet written
    once. The per-block entry computes the same function."""
    per = 3 * num_bins - 1
    cut = d - d // 2
    up = d - cut

    def mlp(n_in, n_out):
        return (2 * (n_in * hidden + 2 * hidden * hidden + hidden * n_out)
                + 6 * hidden + n_out)

    def mlp_params(n_in, n_out):
        return (n_in * hidden + hidden + 2 * (hidden * hidden + hidden)
                + hidden * n_out + n_out)

    per_block = (mlp(up, cut * per) + mlp(cut, up * per)
                 + d * rqs_inverse_ops(num_bins) + d + 2 * d * d + 2 * d)
    ops = n * (num_blocks * per_block + 1) + num_blocks * 2 * d
    params = num_blocks * (2 * d + d * d + mlp_params(up, cut * per)
                           + mlp_params(cut, up * per)) + 1
    nbytes = 4 * (2 * n * d + n + params)
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


def ptxas_report(build_log):
    """One line per kernel instantiation: its template arguments, then
    ptxas's register, barrier, stack and spill figures."""
    out, label = [], None
    for line in build_log.splitlines():
        m = re.search(r'spline_inverse_kernelILi(\d+)ELi(\d+)E', line)
        if m and 'Compiling entry' in line:
            h = int(m.group(2))
            label = 'K=%s hidden=%s' % (m.group(1), h if h else 'run-time')
        elif 'spill' in line or 'Used' in line:
            out.append('%s: %s' % (label, line.strip()))
    return out


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
    ptxas = ptxas_report(si.build_log)
    for line in ptxas:
        print(line, flush=True)
    return {'gpu': smi, 'kind': torch.cuda.get_device_name(0),
            'count': torch.cuda.device_count(),
            'torch': torch.__version__, 'cuda': torch.version.cuda,
            'build_seconds': build_s, 'ptxas': ptxas}


class EarlierKernel:
    """An earlier version of the kernel, built from ``src`` (``--baseline``):
    C entry ``nnest_spline_inverse(z, params, x, logdet, n, d, hidden,
    num_bins, total_blocks, first_block, num_blocks, include_const,
    tail_bound, rows_per_block, stream)`` over the unpadded layout (per
    block s, t, W^-1, then f2 and f1 as (w, b) x 4, then the constant),
    ceil(n / 264) rows a block up to 16. It is timed beside the port's
    kernel and is no part of the port."""

    def __init__(self, src, build_dir):
        import ctypes
        from nnest_torch.ops.spline_inverse import NVCC_FLAGS, _find_nvcc
        so = os.path.join(build_dir, 'libspline_inverse_earlier.so')
        subprocess.run([_find_nvcc(), *NVCC_FLAGS, '-o', so, src],
                       check=True, capture_output=True, text=True)
        self.lib = ctypes.CDLL(so)
        vp, ci = ctypes.c_void_p, ctypes.c_int
        self.lib.nnest_spline_inverse.argtypes = (
            [vp] * 4 + [ci] * 8 + [ctypes.c_float, ci, vp])
        self.lib.nnest_spline_inverse.restype = ci
        self._flat = {}

    def __call__(self, z, packed):
        key = id(packed)
        if key not in self._flat:
            parts = []
            for blk in packed['blocks']:
                parts += [blk['s'], blk['t'], blk['winv']]
                for net in (blk['sc'].f2, blk['sc'].f1):
                    for w, b in zip(net.w, net.b):
                        parts += [w, b]
            parts.append(packed['const_logdet'])
            self._flat[key] = (packed, torch.cat(
                [p.detach().reshape(-1).float() for p in parts]))
        flat = self._flat[key][1]
        sc = packed['blocks'][0]['sc']
        n, d = z.shape
        per_row = 3 * d + 2 * sc.hidden + (d - d // 2) * (3 * sc.num_bins - 1) + 1
        rows = max(1, min(16, 232448 // (4 * per_row), -(-n // 264)))
        x = torch.empty_like(z)
        logdet = torch.empty(n, dtype=torch.float32, device=z.device)
        nb = len(packed['blocks'])
        err = self.lib.nnest_spline_inverse(
            z.data_ptr(), flat.data_ptr(), x.data_ptr(), logdet.data_ptr(),
            n, d, sc.hidden, sc.num_bins, nb, 0, nb, 1,
            float(sc.tail_bound), rows,
            torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError('earlier kernel launch failed: %d' % err)
        return x, logdet


def max_diff(a, b):
    return float((a[0] - b[0]).abs().max()), float((a[1] - b[1]).abs().max())


def timed_pair(fn, earlier):
    """(ms of fn, ms of earlier or None) by ``graph_time_ms``, measured in
    turns: earlier, fn, fn, earlier; each the mean of its two readings."""
    if earlier is None:
        return graph_time_ms(fn), None
    e1 = graph_time_ms(earlier)
    f1 = graph_time_ms(fn)
    f2 = graph_time_ms(fn)
    e2 = graph_time_ms(earlier)
    return (f1 + f2) / 2, (e1 + e2) / 2


SWEEP_SHAPES = ((16, 256), (16, 4096), (50, 256), (50, 4096),
                (16, FLOW_TRIALS), (50, FLOW_TRIALS))
SWEEP_ROWS = {256: (1, 2, 4, 8), 4096: (8, 16, 32, 64),
              FLOW_TRIALS: (32, 64, 128)}
# the posterior samplers' shapes at d = 16 (phase 10): a full-MH step's 16
# chains, an ensemble half-update's 32 walkers and the trajectory inverse
# of a 64-walker, 500-step ensemble
TRAJECTORY_ROWS = (RUN_STEPS + 1) * WALKERS
POSTERIOR_SHAPES = ((16, MCMC_CHAINS), (16, WALKERS // 2),
                    (16, TRAJECTORY_ROWS))
# the command lines' shapes at d = 2 (phase 13): a nested Metropolis
# step's 10 chains, a full-MH step's 16, an ensemble half-update's 32, the
# ensemble's 64 starts and the trajectory inverses of its 500-step
# bootstrap and CLI_MCMC_STEPS-step run (64 walkers)
CLI_SHAPES = ((2, 10), (2, 16), (2, 32), (2, CLI_WALKERS),
              (2, (CLI_BOOT_STEPS + 1) * CLI_WALKERS),
              (2, (CLI_MCMC_STEPS + 1) * CLI_WALKERS))
TIMED_SHAPES = ((16, 256), (16, 4096), (2, 128), (50, 256), (50, 4096),
                (16, FLOW_TRIALS), (50, FLOW_TRIALS), (16, 512)) \
    + POSTERIOR_SHAPES + ((16, DYN_BATCH_LIVE),) + CLI_SHAPES


def phase_kernel(records, earlier):
    from nnest_torch.ops import spline_inverse as si
    from nnest_torch.ops.fused_spline import _inverse_body, pack_inverse_consts
    device = torch.device('cuda')
    worst = {'x': 0.0, 'ld': 0.0, 'pb_x': 0.0, 'pb_ld': 0.0}
    cases, models = [], {}

    def check(name, got, ref, tx, tld, d, n):
        ex, eld = max_diff(got, ref)
        if not (torch.isfinite(got[0]).all() and torch.isfinite(got[1]).all()):
            raise AssertionError('non-finite %s output at d=%d n=%d'
                                 % (name, d, n))
        if ex > tx or eld > tld:
            raise AssertionError(
                '%s disagrees at d=%d n=%d: dx %.3g (tol %g), dlogdet %.3g '
                '(tol %g)' % (name, d, n, ex, tx, eld, tld))
        return ex, eld

    for d in (2, 5, 16, 50, 100):
        model = random_flow(d, seed=100 + d, device=device)
        packed = models[d] = pack_inverse_consts(model)
        wide = (FLOW_TRIALS, FLOW_TRIALS + 1) if d in (16, 50) else ()
        if d == 16:
            wide += tuple(n for _, n in POSTERIOR_SHAPES) + (DYN_BATCH_LIVE,)
        if d == 2:
            wide += tuple(n for _, n in CLI_SHAPES)
        for n in (1, 128, 256, 512, 1000, 4096, 4097) + wide:
            z = kernel_inputs(model, n, seed=7 * n + d, device=device)
            got = si.spline_inverse(z, packed)
            ref = _inverse_body(z, packed)
            torch.cuda.synchronize()
            ex, eld = check('kernel', got, ref, TOL_X, TOL_LOGDET, d, n)
            case = {'d': d, 'n': n, 'max_abs_dx': ex, 'max_abs_dlogdet': eld}
            worst['x'], worst['ld'] = max(worst['x'], ex), max(worst['ld'], eld)
            if d in (5, 16):
                pb = si.spline_inverse_per_block(z, packed)
                torch.cuda.synchronize()
                pex, peld = check('per-block entry', pb, ref, TOL_X,
                                  TOL_LOGDET, d, n)
                check('per-block entry vs whole chain', pb, got, 1e-6, 1e-5,
                      d, n)
                case.update({'per_block_dx': pex, 'per_block_dlogdet': peld})
                worst['pb_x'] = max(worst['pb_x'], pex)
                worst['pb_ld'] = max(worst['pb_ld'], peld)
            if earlier is not None:
                check('earlier kernel', earlier(z, packed), ref, TOL_X,
                      TOL_LOGDET, d, n)
                ms, e_ms = timed_pair(lambda: si.spline_inverse(z, packed),
                                      lambda: earlier(z, packed))
                case.update({'ms': ms, 'earlier_ms': e_ms,
                             'earlier_over_this': e_ms / ms})
            cases.append(case)

    def shape_timing(d, n, per_block=False):
        model = random_flow(d, seed=200 + d, device=device)
        packed = pack_inverse_consts(model)
        z = kernel_inputs(model, n, seed=n, device=device)
        fn = ((lambda: si.spline_inverse_per_block(z, packed)) if per_block
              else (lambda: si.spline_inverse(z, packed)))
        ms, e_ms = timed_pair(fn, None if (earlier is None or per_block)
                              else (lambda: earlier(z, packed)))
        eager_ms = cuda_time_ms(fn)
        plain_ms = cuda_time_ms(lambda: _inverse_body(z, packed))
        ops, nbytes = inverse_cost(n, d, hidden_for(d), 8, 3)
        b_ms, b_by = bound_ms(ops, nbytes)
        plan = si.launch_plan(n, d, hidden_for(d), 8)
        out = {'d': d, 'hidden': hidden_for(d), 'n': n, 'ms': ms,
               'eager_ms': eager_ms, 'plain_ms': plain_ms, 'bound_ms': b_ms, 'bound_by': b_by,
               'over_bound': ms / b_ms, 'ops': ops, 'bytes': nbytes,
               'rows': plan['rows'], 'stages': plan['stages']}
        if e_ms is not None:
            out.update({'earlier_ms': e_ms, 'earlier_over_this': e_ms / ms})
        return out

    timings = [shape_timing(d, n) for d, n in TIMED_SHAPES]
    per_block = [shape_timing(16, n, per_block=True) for n in (256, 4096)]

    sweep = []
    for d, n in SWEEP_SHAPES:
        model = random_flow(d, seed=300 + d, device=device)
        packed = pack_inverse_consts(model)
        z = kernel_inputs(model, n, seed=n + 1, device=device)
        ref = _inverse_body(z, packed)
        for rows in SWEEP_ROWS[n]:
            try:
                top = si.launch_plan(n, d, hidden_for(d), 8, rows)['stages']
            except ValueError as e:   # the rows' state alone overflows
                sweep.append({'d': d, 'n': n, 'rows': rows, 'fits': False,
                              'why': str(e)})
                continue
            for stages in sorted({0, min(2, top), top}):
                check('kernel at %d rows a block, %d stages' % (rows, stages),
                      si._launch(z, packed, 0, 3, True, rows, stages), ref,
                      TOL_X, TOL_LOGDET, d, n)
                plan = si.launch_plan(n, d, hidden_for(d), 8, rows, stages)
                sweep.append({
                    'd': d, 'n': n, 'rows': rows, 'grid': plan['grid'],
                    'stages': stages, 'smem_bytes': plan['smem_bytes'],
                    'ms': graph_time_ms(lambda: si._launch(
                        z, packed, 0, 3, True, rows, stages)),
                    'default': (rows, stages) == tuple(
                        si.launch_plan(n, d, hidden_for(d), 8)[k]
                        for k in ('rows', 'stages'))})

    main, pb = timings[0], per_block[0]
    records[0].update({
        'max_abs_err': worst['x'], 'max_abs_err_logdet': worst['ld'],
        'ms': main['ms'], 'plain_ms': main['plain_ms'],
        'bound_ms': main['bound_ms'], 'bound_by': main['bound_by'],
        'shape': 'd=16 hidden=32 K=8 blocks=3 N=256', 'shapes': timings})
    records[1].update({
        'max_abs_err': worst['pb_x'], 'max_abs_err_logdet': worst['pb_ld'],
        'ms': pb['ms'], 'plain_ms': pb['plain_ms'],
        'bound_ms': pb['bound_ms'], 'bound_by': pb['bound_by'],
        'shape': 'd=16 hidden=32 K=8 blocks=3 N=256', 'shapes': per_block})
    return {'cases': cases, 'max_abs_dx': worst['x'],
            'max_abs_dlogdet': worst['ld'], 'timings': timings,
            'per_block_timings': per_block, 'rows_sweep': sweep}


def phase_per_block_entry(record):
    """The per-block entry as a user calls it, at the main path's width,
    with its own launch counter reset just before and read just after."""
    from nnest_torch.ops import spline_inverse as si
    from nnest_torch.ops.fused_spline import pack_inverse_consts
    device = torch.device('cuda')
    model = random_flow(16, seed=400, device=device)
    packed = pack_inverse_consts(model)
    z = kernel_inputs(model, 256, seed=401, device=device)
    whole = si.spline_inverse(z, packed)
    reset_counts()
    got = si.spline_inverse_per_block(z, packed)
    torch.cuda.synchronize()
    launches = si.launches_per_block
    record['launches_by_path']['per_block'] = launches
    if launches != len(packed['blocks']):
        raise AssertionError('per-block entry launched %d times, expected %d'
                             % (launches, len(packed['blocks'])))
    ex, eld = max_diff(got, whole)
    if ex > 1e-6 or eld > 1e-5:
        raise AssertionError('per-block entry vs whole chain: dx %.3g, '
                             'dlogdet %.3g' % (ex, eld))
    return {'launches': launches, 'vs_whole_chain_dx': ex,
            'vs_whole_chain_dlogdet': eld}


def main_path_sampler(log_dir, name, tooling='on'):
    """Phase 3's sampler: the 16-D Gaussian, 5x box. ``tooling`` 'on': the
    default trainer, which writes ``netG.pkl``, ``originals.npy`` and
    TensorBoard events into the run directory; 'files': the same without
    the events; 'off': a trainer with the same arguments and no run
    directory. The sampler's own files and checkpoints are always
    written."""
    from nnest_torch import NestedSampler, Trainer
    from nnest_torch.likelihoods import Gaussian
    d = 16
    trainer = None
    if tooling == 'off':
        # the arguments the sampler gives its default trainer
        trainer = Trainer(d, hidden_dim=32, learning_rate=0.001, seed=2,
                          device='cuda')
    sampler = NestedSampler(d, Gaussian(d, 0.0), transform=lambda x: 5.0 * x,
                            log_dir=os.path.join(log_dir, name), seed=1,
                            trainer=trainer, device='cuda')
    if tooling == 'files' and sampler.trainer.writer is not None:
        sampler.trainer.writer.close()
        sampler.trainer.writer = None
    return sampler


def scalar_cost(log_dir, n=2000):
    """Host microseconds of one TensorBoard ``add_scalar`` on this
    machine's CPU (the writer's own thread included by the closing flush)
    and the protobuf implementation behind it; None without TensorBoard."""
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:
        return None
    from google.protobuf.internal import api_implementation
    writer = SummaryWriter(os.path.join(log_dir, 'scalar_cost'))
    t0 = time.perf_counter()
    for i in range(n):
        writer.add_scalar('logz', float(i), i)
    writer.close()
    return {'add_scalar_us': (time.perf_counter() - t0) * 1e6 / n,
            'protobuf': api_implementation.Type()}


def tooling_turns(log_dir):
    """Wall seconds of phase 3's run with its trainer's tooling on, its
    files without TensorBoard events, and off (:func:`main_path_sampler`),
    in turns (on, files, off, off, files, on), the training step a CUDA
    graph in every run; the TensorBoard scalars an 'on' run writes (one
    'logz' an iteration, one 'loss' an epoch) and what one costs here."""
    order = ('on', 'files', 'off', 'off', 'files', 'on')
    walls = {k: [] for k in order}
    for i, tooling in enumerate(order):
        sampler = main_path_sampler(log_dir, 'tooling_%d' % i, tooling)
        t0 = time.time()
        sampler.run(max_iters=5200, train_iters=100)
        walls[tooling].append(time.time() - t0)
        if tooling == 'on':
            scalars = sampler.niter - 1 + sampler.trainer.total_iters
    off = np.mean(walls['off'])
    return {'on_s': walls['on'], 'files_s': walls['files'],
            'off_s': walls['off'],
            'cost_fraction': float((np.mean(walls['on']) - off) / off),
            'files_cost_fraction': float((np.mean(walls['files']) - off)
                                         / off),
            'scalars': scalars, 'scalar_cost': scalar_cost(log_dir)}


def phase_main_path(record, log_dir):
    sampler = main_path_sampler(log_dir, 'main')
    reset_counts()
    t0 = time.time()
    sampler.run(max_iters=5200, train_iters=100)
    wall = time.time() - t0
    launches = read_counts('mcmc')
    record['launches_by_path']['mcmc'] = launches
    stats = sampler.run_stats
    if stats['mcmc_generations'] < 3 or stats['trainings'] < 1:
        raise AssertionError('main path did not reach 3 MCMC generations '
                             'and a training: %s' % stats)
    if not math.isfinite(sampler.logz):
        raise AssertionError('non-finite logz %r' % sampler.logz)
    return {'wall_s': wall, 'launches': launches, 'iterations': sampler.niter,
            'ncall': sampler.total_calls, 'logz_so_far': sampler.logz,
            **stats,
            'generation_profile': profile_generation(mcmc_generation(sampler)),
            'tooling_turns': tooling_turns(log_dir)}


def synthetic_shell(sampler, seed=5):
    """A live set on a synthetic shell (~ N(0, 0.3^2) in the unit cube) and
    its host log likelihoods and derived values."""
    g = torch.Generator(device='cuda').manual_seed(seed)
    u = torch.clamp(0.3 * torch.randn(1000, sampler.x_dim, generator=g,
                                      device='cuda'), -1.0, 1.0)
    u = u.cpu().numpy().astype(np.float64)
    return (u,) + sampler.loglike(u)


def profile_generation(generation):
    """One call of ``generation`` (which ends in a synchronise): its wall
    time without and with the profiler, device busy time by kernel from
    the profiler's CUDA events, and the spline kernel's share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
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
    spline_ms = sum(ms for ms, _ in spline)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
    return {
        'wall_ms': wall_ms, 'profiled_wall_ms': prof_wall_ms,
        'device_busy_ms': busy_ms if by_name else 'not measured',
        'device_busy_share': (busy_ms / prof_wall_ms if by_name
                              else 'not measured'),
        'kernel_launches': sum(n for _, n in by_name.values()),
        'spline_inverse_ms': spline_ms,
        'spline_inverse_launches': sum(n for _, n in spline),
        'spline_inverse_share_of_busy': (spline_ms / busy_ms if busy_ms
                                         else 'not measured'),
        'top_kernels': [{'name': name[:80], 'ms': ms, 'count': n}
                        for name, (ms, n) in top],
    }


def mcmc_generation(sampler, mcmc_steps=80, num_chains=256):
    """One MCMC pool generation at the main path's shape on a synthetic
    shell, as a function that ends in a synchronise; the live set's derived
    values ride along when the sampler has them."""
    u, logl, derived = synthetic_shell(sampler)

    def generation():
        sampler._mcmc_sample_live(
            mcmc_steps, u, logl, num_chains, float(np.min(logl)),
            1.0 / sampler.x_dim ** 0.5, dynamic_step_size=True,
            adapt_cov=True, active_derived=derived)
        torch.cuda.synchronize()

    return generation


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
    with open(os.path.join(sampler.log_dir, 'results',
                           'diagnostics.json')) as f:
        diag = json.load(f)
    if set(diag) != DIAGNOSTICS_KEYS:
        raise AssertionError('diagnostics.json keys differ: %s'
                             % sorted(set(diag) ^ DIAGNOSTICS_KEYS))
    if not math.isfinite(diag['logzerr_adjusted']):
        raise AssertionError('logzerr_adjusted is %r'
                             % diag['logzerr_adjusted'])
    out['diagnostics'] = diag
    return out


def reset_counts():
    from nnest_torch.ops import fused_spline
    from nnest_torch.ops import spline_inverse as si
    si.launches = si.launches_per_block = 0
    fused_spline.calls = 0


def read_counts(path):
    """The launch counts after a path, checked: the whole-chain kernel
    launched, the plain twin never called."""
    from nnest_torch.ops import fused_spline
    from nnest_torch.ops import spline_inverse as si
    torch.cuda.synchronize()
    launches, twin = si.launches, fused_spline.calls
    if launches <= 0:
        raise AssertionError('the %s path never launched the kernel' % path)
    if twin != 0:
        raise AssertionError('the %s path called the plain twin %d times on '
                             'the card' % (path, twin))
    return launches


def phase_flow_rejection(records, log_dir):
    """Flow rejection on the 16-D main-path model at 65536 trials a
    generation, then one flow-density generation; each with its counts
    reset just before and read just after."""
    from nnest_torch import NestedSampler
    from nnest_torch.likelihoods import Gaussian
    d = 16
    sampler = NestedSampler(d, Gaussian(d, 0.0), transform=lambda x: 5.0 * x,
                            log_dir=os.path.join(log_dir, 'flow'), seed=3,
                            device='cuda')
    walls = []
    real = sampler._rejection_flow_sample

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        out = real(*args, **kwargs)   # ends in a device-to-host copy
        walls.append((time.perf_counter() - t0) * 1e3)
        return out

    sampler._rejection_flow_sample = timed
    reset_counts()
    t0 = time.time()
    # max_iters < update_interval (500): one training, no retrain check
    sampler.run(strategy=['rejection_flow', 'mcmc'], max_iters=499,
                train_iters=100, rejection_batch_size=FLOW_TRIALS,
                rejection_max_trials=FLOW_TRIALS)
    wall = time.time() - t0
    launches = read_counts('rejection_flow')
    del sampler._rejection_flow_sample
    stats = sampler.run_stats
    if stats['rejection_flow_generations'] < 3 or stats['trainings'] < 1:
        raise AssertionError('flow rejection did not reach 3 generations '
                             'and a training: %s' % stats)
    # every launch of the run is a flow-rejection one: one a generation
    if stats['mcmc_generations'] != 0:
        raise AssertionError('the ladder reached mcmc; its launches would '
                             'count as rejection_flow ones: %s' % stats)
    if launches != stats['rejection_flow_generations']:
        raise AssertionError('%d launches for %d rejection_flow generations'
                             % (launches, stats['rejection_flow_generations']))
    if not math.isfinite(sampler.logz):
        raise AssertionError('non-finite logz %r' % sampler.logz)
    by_path = {'rejection_flow': launches}

    # one flow-density generation at the same width
    u, logl, _ = synthetic_shell(sampler)
    loglstar = float(np.min(logl))
    reset_counts()
    t0 = time.perf_counter()
    s_d, ll_d, _, _ = sampler._density_sample(loglstar,
                                              num_trials=FLOW_TRIALS)
    density_ms = (time.perf_counter() - t0) * 1e3
    by_path['density_flow'] = read_counts('density_flow')
    if not np.all(ll_d > loglstar):
        raise AssertionError('a density candidate is below its threshold')
    records[0]['launches_by_path'].update(by_path)

    def generation():
        sampler._rejection_flow_sample(u, loglstar, cache=False,
                                       num_trials=FLOW_TRIALS)
        torch.cuda.synchronize()

    profile = profile_generation(generation)
    # the parts of a generation, each timed alone (eager, back to back)
    kernels = sampler.kernels
    live = torch.as_tensor(u.astype(np.float32), device='cuda')
    packed_inverse = kernels._hot_inverse()
    draws = kernels.rejection_flow_draws(sampler.generator, FLOW_TRIALS, d)
    mld, mr = kernels.envelope(live, 1.1)
    x, _ = packed_inverse(draws[0])
    parts = {
        'envelope_forward_ms': cuda_time_ms(
            lambda: kernels.envelope(live, 1.1)),
        'draws_ms': cuda_time_ms(lambda: kernels.rejection_flow_draws(
            sampler.generator, FLOW_TRIALS, d)),
        # a generation packs the flow's consts and the kernel's layout anew
        'pack_and_spline_inverse_ms': cuda_time_ms(
            lambda: kernels._hot_inverse()(draws[0])),
        'spline_inverse_ms': cuda_time_ms(lambda: packed_inverse(draws[0])),
        'likelihood_and_prior_ms': cuda_time_ms(
            lambda: (kernels.like_fn(x), kernels.prior_fn(x))),
        'body_ms': cuda_time_ms(lambda: kernels.rejection_flow_body(
            *draws, loglstar, mld, mr, 1.1)),
        'generation_wall_ms': profile['wall_ms'],
    }
    return {'wall_s': wall, 'launches': launches, 'iterations': sampler.niter,
            'ncall': sampler.total_calls, 'logz_so_far': sampler.logz,
            **stats, 'generation_walls_ms': walls,
            'median_generation_ms': float(np.median(walls)),
            'density_candidates': int(s_d.shape[0]),
            'density_generation_ms': density_ms,
            'density_launches': by_path['density_flow'],
            'generation_profile': profile, 'generation_parts': parts}


def phase_resume(log_dir):
    """Kill-and-resume on the card: the 2-D Gaussian with
    ['rejection_flow', 'mcmc'], uninterrupted against killed at
    max_iters=120 and resumed by a sampler built with another seed."""
    from nnest_torch import NestedSampler
    from nnest_torch.likelihoods import Gaussian
    like = Gaussian(2, 0.0, lim=3)
    analytic = like.analytic_logz([-3.0, -3.0], [3.0, 3.0])
    kw = dict(strategy=['rejection_flow', 'mcmc'], train_iters=30,
              mcmc_num_chains=10, mcmc_steps=10, rejection_batch_size=32,
              dlogz=0.5, retrain_nll_threshold=None)

    def sampler(name, seed):
        return NestedSampler(2, like, transform=lambda x: 3.0 * x,
                             num_live_points=100,
                             log_dir=os.path.join(log_dir, name),
                             append_run_num=False, resume=True, seed=seed,
                             device='cuda')

    t0 = time.time()
    whole = sampler('whole', 7)
    whole.run(**kw)
    again = sampler('again', 7)
    again.run(**kw)
    sampler('killed', 7).run(max_iters=120, **kw)
    resumed = sampler('killed', 99)
    resumed.run(**kw)
    wall = time.time() - t0

    def final(s):
        return [float(s.logz), float(s.h), int(s.total_calls), int(s.niter)]

    out = {'wall_s': wall, 'analytic_logz': analytic,
           'uninterrupted': final(whole), 'uninterrupted_again': final(again),
           'resumed': final(resumed),
           'resume_bit_exact': final(resumed) == final(whole),
           'rerun_bit_exact': final(again) == final(whole),
           'trainings': whole.run_stats['trainings'],
           'rejection_flow_generations':
               whole.run_stats['rejection_flow_generations']}
    for name, s in (('uninterrupted', whole), ('resumed', resumed)):
        allowed = max(3.0 * s.logzerr, 0.15)
        if abs(s.logz - analytic) > allowed:
            raise AssertionError('%s run off the analytic logz: %s'
                                 % (name, out))
    return out


def phase_slice(record, log_dir):
    """Slice on the 16-D main-path model, its counts reset just before
    the run and read just after; the launches and wall of each slice
    generation, a profile of one; then the 2-D slice evidence check."""
    from nnest_torch import NestedSampler
    from nnest_torch.likelihoods import Gaussian
    from nnest_torch.ops import spline_inverse as si
    d = 16
    sampler = NestedSampler(d, Gaussian(d, 0.0), transform=lambda x: 5.0 * x,
                            log_dir=os.path.join(log_dir, 'slice'), seed=4,
                            device='cuda')
    gens = []
    real = sampler._slice_sample_live

    def timed(*args, **kwargs):
        n0 = si.launches
        t0 = time.perf_counter()
        out = real(*args, **kwargs)   # ends in a device-to-host copy
        gens.append({'ms': (time.perf_counter() - t0) * 1e3,
                     'launches': si.launches - n0})
        return out

    sampler._slice_sample_live = timed
    reset_counts()
    t0 = time.time()
    # prior rejection until the expected volume falls below e^-4 (it =
    # 4000), then slice; the training comes with the switch
    sampler.run(strategy=['rejection_prior', 'slice'], max_iters=5000,
                train_iters=30, volume_switch=math.exp(-4.0))
    wall = time.time() - t0
    launches = read_counts('slice')
    del sampler._slice_sample_live
    stats = sampler.run_stats
    if stats['slice_generations'] < 3 or stats['trainings'] < 1:
        raise AssertionError('the slice path did not reach 3 generations '
                             'and a training: %s' % stats)
    if stats['mcmc_generations'] != 0:
        raise AssertionError('an MCMC generation ran: %s' % stats)
    if launches != sum(g['launches'] for g in gens):
        raise AssertionError('%d launches, %d of them in slice generations'
                             % (launches, sum(g['launches'] for g in gens)))
    if not math.isfinite(sampler.logz):
        raise AssertionError('non-finite logz %r' % sampler.logz)
    record['launches_by_path']['slice'] = launches

    u, logl, _ = synthetic_shell(sampler)

    def generation():
        sampler._slice_sample_live(2 * d, u, logl, 256, float(np.min(logl)),
                                   1.0, adapt_cov=True)
        torch.cuda.synchronize()

    profile = profile_generation(generation)
    evidence = evidence_run('slice2', log_dir, 2, {},
                            ['rejection_prior', 'slice'])
    if evidence['slice_generations'] < 1:
        raise AssertionError('the 2-D run never reached slice: %s'
                             % evidence)
    return {'wall_s': wall, 'launches': launches,
            'iterations': sampler.niter, 'ncall': sampler.total_calls,
            'logz_so_far': sampler.logz, **stats, 'generations': gens,
            'launches_per_generation': float(np.median(
                [g['launches'] for g in gens])),
            'median_generation_ms': float(np.median([g['ms'] for g in gens])),
            'generation_profile': profile, 'evidence_2d': evidence}


def evidence_run(name, log_dir, d, flow_kw, strategy):
    """The d-D Gaussian (transform 3x, 200 live points) with ``strategy``
    (the within-shell kernel after a volume switch at 0.5) to completion;
    its logz must lie within max(3 logzerr, 0.15) of the analytic value."""
    from nnest_torch import NestedSampler
    from nnest_torch.likelihoods import Gaussian
    like = Gaussian(d, 0.0, lim=3)
    sampler = NestedSampler(d, like, transform=lambda x: 3.0 * x,
                            num_live_points=200,
                            log_dir=os.path.join(log_dir, name), seed=42,
                            device='cuda', **flow_kw)
    t0 = time.time()
    sampler.run(strategy=strategy, train_iters=50, volume_switch=0.5,
                dlogz=0.1)
    analytic = like.analytic_logz([-3.0] * d, [3.0] * d)
    allowed = max(3.0 * sampler.logzerr, 0.15)
    out = {'d': d, **flow_kw, 'wall_s': time.time() - t0,
           'logz': sampler.logz, 'logzerr': sampler.logzerr,
           'analytic_logz': analytic, 'allowed': allowed,
           'niter': sampler.niter, 'ncall': sampler.total_calls,
           **sampler.run_stats}
    if not abs(sampler.logz - analytic) <= allowed:
        raise AssertionError('%s: logz off the analytic value: %s'
                             % (name, out))
    return out


def phase_other_flows(log_dir):
    """NVP, Cholesky and fast-slow spline runs to their analytic evidence,
    each with the counts reset just before and read just after: their
    inverse is plain PyTorch, so neither the kernel nor its twin runs."""
    from nnest_torch.ops import fused_spline
    from nnest_torch.ops import spline_inverse as si
    runs = []
    for flow, d, kw in (('nvp', 2, {}), ('cholesky', 2, {}),
                        ('spline', 4, {'num_slow': 2})):
        reset_counts()
        out = evidence_run(flow, log_dir, d, dict(flow=flow, **kw),
                           ['rejection_prior', 'mcmc'])
        torch.cuda.synchronize()
        out.update({'launches': si.launches,
                    'twin_calls': fused_spline.calls})
        if si.launches != 0 or fused_spline.calls != 0:
            raise AssertionError('flow %r ran the spline kernel or its twin: '
                                 '%s' % (flow, out))
        if out['mcmc_generations'] < 1 or out['trainings'] < 1:
            raise AssertionError('flow %r never trained or reached mcmc: %s'
                                 % (flow, out))
        if (out['total_fast_calls'] > 0) != bool(kw):
            raise AssertionError('flow %r: fast calls %d'
                                 % (flow, out['total_fast_calls']))
        runs.append(out)
    return {'runs': runs}


def ess_bounded_moments(chains, corr, name):
    """Check posterior chains (chains, steps, d) of the correlated Gaussian
    (unit variances, pairwise correlation ``corr``) against bounds from
    their own ESS (``utils/evaluation.effective_sample_size`` times the
    chains): each dim's mean within 5/sqrt(ESS) of 0, its std within
    5/sqrt(2 ESS) of 1, and the mean pairwise correlation within
    5 (1 - corr^2)/sqrt(min ESS) of ``corr``; the smallest ESS at least
    50. Returns the moments, the bounds and the ESS range."""
    from nnest_torch.utils.evaluation import effective_sample_size
    flat = chains.reshape(-1, chains.shape[2])
    ess = chains.shape[0] * effective_sample_size(
        chains, flat.mean(axis=0), flat.var(axis=0))
    mean, std = flat.mean(axis=0), flat.std(axis=0)
    c = np.corrcoef(flat, rowvar=False)
    mean_corr = float(c[np.triu_indices_from(c, k=1)].mean())
    out = {'ess_min': float(ess.min()), 'ess_max': float(ess.max()),
           'max_abs_mean_over_bound': float(np.max(
               np.abs(mean) * np.sqrt(ess) / 5.0)),
           'max_abs_std_dev_over_bound': float(np.max(
               np.abs(std - 1.0) * np.sqrt(2.0 * ess) / 5.0)),
           'mean_corr': mean_corr,
           'corr_bound': 5.0 * (1.0 - corr ** 2) / math.sqrt(ess.min())}
    ok = (out['ess_min'] >= 50 and out['max_abs_mean_over_bound'] <= 1.0
          and out['max_abs_std_dev_over_bound'] <= 1.0
          and abs(mean_corr - corr) <= out['corr_bound'])
    if not ok:
        raise AssertionError('%s posterior moments out of their ESS bounds: '
                             '%s' % (name, out))
    return out


def phase_mcmc_ensemble(record, log_dir):
    """MCMCSampler and EnsembleSampler (bootstrap, then run) on the 16-D
    Gaussian with pairwise correlation 0.9 in the box [-5, 5]^16, each
    with its counts reset just before and read just after: MCMCSampler
    launches the kernel once a step and once a call (the starts),
    EnsembleSampler twice a step (the two half-updates) and twice a call
    (the starts' target and the trajectory's inverse); its bootstrap's
    phase 0 runs in real space without the flow. Posterior moments within
    bounds from each run's ESS; the final step size finite and positive.
    Then one ``_mcmc_sample`` and one ``_ensemble_sample`` call profiled."""
    from nnest_torch import EnsembleSampler, MCMCSampler
    from nnest_torch.likelihoods import Gaussian
    from nnest_torch.ops import spline_inverse as si
    from nnest_torch.priors import UniformPrior
    d, corr = 16, 0.9
    cov = np.eye(d) + corr * (1.0 - np.eye(d))
    # exact posterior draws as the training set (rejection from the box is
    # hopeless at 16-D)
    training = np.random.default_rng(10).multivariate_normal(
        np.zeros(d), cov, size=1000)

    def sampler(cls, name, seed):
        s = cls(d, Gaussian(d, corr), prior=UniformPrior(d, -5.0, 5.0),
                log_dir=os.path.join(log_dir, name), seed=seed,
                device='cuda')
        calls = s.calls = []
        for method in ('_mcmc_sample', '_ensemble_sample'):
            real = getattr(s, method)

            def timed(*args, _real=real, _method=method, **kwargs):
                n0 = si.launches
                t0 = time.perf_counter()
                # ends in device-to-host copies
                out = _real(*args, **kwargs)
                calls.append({'call': _method, 'steps': args[0],
                              'ms': (time.perf_counter() - t0) * 1e3,
                              'launches': si.launches - n0})
                return out

            setattr(s, method, timed)
        return s

    mcmc = sampler(MCMCSampler, 'mcmc_sampler', 10)
    reset_counts()
    t0 = time.time()
    mcmc.run(MCMC_STEPS, MCMC_CHAINS, training,
             train_iters=POSTERIOR_TRAIN_ITERS)
    mcmc_wall = time.time() - t0
    mcmc_launches = read_counts('mcmc_sampler')
    if mcmc_launches != MCMC_STEPS + 1:
        raise AssertionError('MCMCSampler launched the kernel %d times, '
                             'expected %d (one a step, one for the starts)'
                             % (mcmc_launches, MCMC_STEPS + 1))
    if not (math.isfinite(mcmc.scale) and mcmc.scale > 0):
        raise AssertionError('final step size %r' % mcmc.scale)
    burn = MCMC_STEPS // 10
    mcmc_moments = ess_bounded_moments(mcmc.samples[:, burn:], corr,
                                       'MCMCSampler')

    ens = sampler(EnsembleSampler, 'ensemble', 11)
    reset_counts()
    t0 = time.time()
    boot = ens.bootstrap(BOOT_STEPS, WALKERS, iters=1,
                         train_iters=POSTERIOR_TRAIN_ITERS)
    boot_wall = time.time() - t0
    if not (boot.shape[1] == d and np.all(np.isfinite(boot))):
        raise AssertionError('bootstrap training set %s' % (boot.shape,))
    t0 = time.time()
    ens.run(RUN_STEPS, WALKERS, training, train_iters=POSTERIOR_TRAIN_ITERS)
    run_wall = time.time() - t0
    ens_launches = read_counts('ensemble')
    expected = 2 * (BOOT_STEPS + RUN_STEPS) + 2 * 2
    if ens_launches != expected:
        raise AssertionError('EnsembleSampler launched the kernel %d times, '
                             'expected %d (two a step, two a call)'
                             % (ens_launches, expected))
    ens_moments = ess_bounded_moments(ens.samples[:, RUN_STEPS // 5:], corr,
                                      'EnsembleSampler')
    record['launches_by_path'].update(mcmc_sampler=mcmc_launches,
                                      ensemble=ens_launches)

    def mcmc_call():
        mcmc._mcmc_sample(500, num_chains=MCMC_CHAINS,
                          dynamic_step_size=True)
        torch.cuda.synchronize()

    def ensemble_call():
        ens._ensemble_sample(100, WALKERS)
        torch.cuda.synchronize()

    return {'mcmc_wall_s': mcmc_wall, 'mcmc_launches': mcmc_launches,
            'mcmc_scale': mcmc.scale, 'mcmc_calls': mcmc.calls,
            'mcmc_moments': mcmc_moments, 'bootstrap_wall_s': boot_wall,
            'bootstrap_rows': int(boot.shape[0]), 'run_wall_s': run_wall,
            'ensemble_launches': ens_launches, 'ensemble_calls': ens.calls,
            'ensemble_moments': ens_moments, 'total_calls': {
                'mcmc': mcmc.total_calls, 'ensemble': ens.total_calls},
            'mcmc_call_profile_500_steps': profile_generation(mcmc_call),
            'ensemble_call_profile_100_steps': profile_generation(
                ensemble_call)}


class NumpyOnlyGaussian:
    """The 2-D standard normal as a host likelihood: numpy and a scipy row
    loop (``tests/test_blackbox_likelihood.py``'s); ``np.asarray`` of a
    CUDA tensor raises, so the sampler calls it with float64 numpy."""

    def __init__(self, dim):
        self.x_dim = dim
        self.calls = 0

    def __call__(self, x):
        from scipy.stats import multivariate_normal
        x = np.asarray(x, dtype=np.float64)
        self.calls += x.shape[0]
        return np.array([multivariate_normal.logpdf(
            row, mean=np.zeros(self.x_dim), cov=np.eye(self.x_dim))
            for row in x])


def dynamic_2d_resume(log_dir):
    """The 2-D Gaussian dynamic run, uninterrupted against stopped after
    batch 1 and resumed (from ``dynamic_state.pkl``) to batch 2; both within
    max(3 logzerr, 0.15) of the analytic logz."""
    from nnest_torch import DynamicNestedSampler
    from nnest_torch.likelihoods import Gaussian
    like = Gaussian(2, 0.0, lim=3)
    analytic = like.analytic_logz([-3.0, -3.0], [3.0, 3.0])
    kw = dict(G=0.5, num_batches=2, num_live_batch=100, dlogz=0.1,
              train_iters=50)

    def sampler(name, resume):
        return DynamicNestedSampler(2, like, transform=lambda x: 3.0 * x,
                                    num_live_init=200,
                                    log_dir=os.path.join(log_dir, name),
                                    append_run_num=False, resume=resume,
                                    seed=8, device='cuda')

    def final(s):
        return [float(s.logz), float(s.h), int(s.total_calls), int(s.niter)]

    t0 = time.time()
    whole = sampler('dyn2_whole', False)
    whole.run(**kw)
    sampler('dyn2_killed', True).run(**dict(kw, num_batches=1))
    resumed = sampler('dyn2_killed', True)
    resumed.run(**kw)
    out = {'wall_s': time.time() - t0, 'analytic_logz': analytic,
           'uninterrupted': final(whole), 'resumed': final(resumed),
           'logzerr': whole.logzerr, 'peak_n_live': int(np.max(whole.n_live)),
           'insertion_p': whole.insertion_p_value,
           'posterior_ess': whole.posterior_ess,
           'resume_bit_exact': final(resumed) == final(whole)}
    for name, s in (('uninterrupted', whole), ('resumed', resumed)):
        if abs(s.logz - analytic) > max(3.0 * s.logzerr, 0.15):
            raise AssertionError('2-D dynamic %s run off the analytic logz: '
                                 '%s' % (name, out))
    return out


def phase_dynamic(record, log_dir):
    """The dynamic sampler on the 16-D main-path model, its counts reset
    just before the run and read just after: the seeded batch above a
    finite floor and its seed refresh, the batch's end; then the 2-D
    dynamic evidence and resume check, and the host-likelihood nested run
    (its own counts)."""
    from nnest_torch import DynamicNestedSampler, NestedSampler
    from nnest_torch.likelihoods import Gaussian
    from nnest_torch.ops import spline_inverse as si
    d = 16
    dyn = DynamicNestedSampler(d, Gaussian(d, 0.0),
                               transform=lambda x: 5.0 * x,
                               num_live_init=DYN_LIVE,
                               log_dir=os.path.join(log_dir, 'dynamic'),
                               seed=6, device='cuda')
    samplers, bounds, seeds, refreshes = [], [], [], []
    make, seed_batch = dyn._make_sampler, dyn._seed_batch

    def made(*args, **kwargs):
        s = make(*args, **kwargs)
        final = s._mcmc_sample_final

        def refresh(*a, **kw):
            n0, t0 = si.launches, time.perf_counter()
            out = final(*a, **kw)   # ends in a device-to-host copy
            refreshes.append({'ms': (time.perf_counter() - t0) * 1e3,
                              'launches': si.launches - n0,
                              'rows': int(kw['init_samples'].shape[0])})
            return out

        s._mcmc_sample_final = refresh
        samplers.append(s)
        return s

    def window(merged, parts, **kwargs):
        bounds.append(DynamicNestedSampler.batch_bounds(merged, parts,
                                                        **kwargs))
        return bounds[-1]

    def seeded(s, L_lo, *args, **kwargs):
        pts = seed_batch(s, L_lo, *args, **kwargs)
        seeds.append({'L_lo': L_lo, 'rows': int(pts['logl'].size),
                      'min_logl': float(np.min(pts['logl'])),
                      'above_floor': bool(np.all(pts['logl'] > L_lo))})
        return pts

    dyn._make_sampler, dyn.batch_bounds, dyn._seed_batch = (
        made, window, seeded)
    reset_counts()
    t0 = time.time()
    # dlogz so small that max_iters or the ceiling ends every batch
    dyn.run(G=1.0, num_batches=1, num_live_batch=DYN_BATCH_LIVE,
            dlogz=1e-3, max_iters=DYN_MAX_ITERS,
            train_iters=DYN_TRAIN_ITERS, volume_switch=DYN_SWITCH)
    wall = time.time() - t0
    launches = read_counts('dynamic')
    record['launches_by_path']['dynamic'] = launches
    s0, s1 = samplers
    (L_lo, L_hi), = bounds
    ceiling = (L_hi is not None
               and float(np.min(s1.loglikes[-DYN_BATCH_LIVE:])) > L_hi)
    out = {'wall_s': wall, 'launches': launches, 'logz_so_far': dyn.logz,
           'ncall': dyn.total_calls, 'niter': dyn.niter,
           'peak_n_live': int(np.max(dyn.n_live)), 'L_lo': L_lo,
           'L_hi': L_hi, 'seeds': seeds, 'seed_refresh': refreshes,
           'batch_ended_above_ceiling': ceiling,
           'batch_ended_at_max_iters': s1.niter - 1 > DYN_MAX_ITERS,
           'batches': [{'niter': s.niter, 'ncall': s.total_calls,
                        'birth_floor': s._birth_floor, **s.run_stats}
                       for s in samplers]}
    if s0.run_stats['mcmc_generations'] < 1 or s0.run_stats['trainings'] < 1:
        raise AssertionError('batch 0 did not reach mcmc and a training: %s'
                             % out)
    if not (np.isfinite(L_lo) and len(seeds) == 1
            and seeds[0]['above_floor'] and s1._birth_floor == L_lo):
        raise AssertionError('no batch was seeded above a finite floor: %s'
                             % out)
    if [r['launches'] for r in refreshes] != [5 * d + 1] or \
            refreshes[0]['rows'] != DYN_BATCH_LIVE:
        raise AssertionError('the seed refresh did not launch the kernel once '
                             'a step and once for its starts: %s' % out)
    if not (ceiling or out['batch_ended_at_max_iters']):
        raise AssertionError('the batch ended below its ceiling before '
                             'max_iters: %s' % out)
    if s1.run_stats['mcmc_generations'] < 1 or not math.isfinite(dyn.logz):
        raise AssertionError('the batch ran no MCMC generation: %s' % out)

    out['evidence_2d'] = dynamic_2d_resume(log_dir)

    like = NumpyOnlyGaussian(2)
    host = NestedSampler(2, like, transform=lambda x: 3.0 * x,
                         num_live_points=200,
                         log_dir=os.path.join(log_dir, 'host_like'), seed=42,
                         device='cuda')
    reset_counts()
    t0 = time.time()
    host.run(train_iters=50, dlogz=0.1, volume_switch=0.5)
    host_wall = time.time() - t0
    record['launches_by_path']['host_likelihood'] = read_counts(
        'host_likelihood')
    analytic = Gaussian(2, 0.0).analytic_logz([-3.0, -3.0], [3.0, 3.0])
    out['host_likelihood'] = {
        'wall_s': host_wall, 'logz': host.logz, 'logzerr': host.logzerr,
        'analytic_logz': analytic, 'niter': host.niter,
        'ncall': host.total_calls, 'likelihood_rows': like.calls,
        'host_path': host._host_loglike,
        'launches': record['launches_by_path']['host_likelihood'],
        **host.run_stats}
    if not (host._host_loglike and host.run_stats['mcmc_generations'] > 0
            and abs(host.logz - analytic) <= max(3.0 * host.logzerr, 0.15)):
        raise AssertionError('host-likelihood run: %s'
                             % out['host_likelihood'])
    return out


def derived_of(x, xp=torch):
    """The three derived parameters of the derived phase: (sum x, |x|^2,
    x0 x1), as a (batch, 3) array of ``x``'s type (``xp`` torch or numpy)."""
    cat = torch.stack if xp is torch else np.stack
    return cat([x.sum(-1), (x * x).sum(-1), x[:, 0] * x[:, 1]], -1)


class DerivedGaussian:
    """The zoo's d-D Gaussian (pairwise correlation ``corr``) as a torch
    likelihood returning ``(logl, derived)``, the derived parameters those
    of ``derived_of``."""

    def __init__(self, d, corr=0.0):
        from nnest_torch.likelihoods import Gaussian
        self.gaussian = Gaussian(d, corr)

    def __call__(self, x):
        return self.gaussian(x), derived_of(x)


class NumpyDerivedGaussian(NumpyOnlyGaussian):
    """The 2-D standard normal as a host likelihood returning ``(logl,
    derived)``, vectorised in float64 numpy."""

    def __call__(self, x):
        x = np.asarray(x, dtype=np.float64)
        self.calls += x.shape[0]
        logl = -0.5 * np.sum(x * x, axis=1) - 0.5 * self.x_dim * math.log(
            2.0 * math.pi)
        return logl, derived_of(x, np)


def check_derived(samples, d, name):
    """The derived columns of ``samples`` (..., d + 3) against the float32
    function of its parameter columns (rtol 1e-4, atol 1e-4); returns the
    largest absolute difference."""
    flat = samples.reshape(-1, samples.shape[-1])
    if flat.shape[1] != d + DERIVED:
        raise AssertionError('%s: %d columns, expected %d'
                             % (name, flat.shape[1], d + DERIVED))
    want = derived_of(flat[:, :d].astype(np.float32), np)
    got = flat[:, d:]
    if not (np.all(np.isfinite(got))
            and np.allclose(got, want, rtol=1e-4, atol=1e-4)):
        raise AssertionError('%s: derived columns disagree with their '
                             'parameters by up to %.3g'
                             % (name, float(np.max(np.abs(got - want)))))
    return float(np.max(np.abs(got - want)))


def phase_derived(record, log_dir):
    """Derived parameters through every strategy and sampler that runs the
    kernel, each run with its counts reset just before and read just after:
    the 16-D nested run with three derived columns, MCMCSampler and
    EnsembleSampler on the correlated model with them, the 2-D dynamic run
    with a numpy likelihood returning them; then one MCMC generation of the
    16-D model profiled with num_derived = 3 and with num_derived = 0, on
    the same flow."""
    from nnest_torch import (DynamicNestedSampler, EnsembleSampler,
                             MCMCSampler, NestedSampler)
    from nnest_torch.likelihoods import Gaussian
    from nnest_torch.priors import UniformPrior
    d = 16
    out, launches = {}, {}
    names = ['x%d' % i for i in range(d)] + ['sum', 'norm2', 'x0x1']
    nested = NestedSampler(d, DerivedGaussian(d), transform=lambda x: 5.0 * x,
                           num_derived=DERIVED, param_names=names,
                           log_dir=os.path.join(log_dir, 'derived'), seed=12,
                           device='cuda')
    reset_counts()
    t0 = time.time()
    nested.run(max_iters=DERIVED_MAX_ITERS, train_iters=DERIVED_TRAIN_ITERS)
    wall = time.time() - t0
    launches['nested'] = read_counts('derived')
    stats = nested.run_stats
    if stats['mcmc_generations'] < 3 or not math.isfinite(nested.logz):
        raise AssertionError('the derived run did not reach 3 MCMC '
                             'generations: %s' % stats)
    chain = np.loadtxt(os.path.join(nested.logs['chains'], 'chain.txt'))
    if chain.shape[1] != 2 + d + DERIVED:
        raise AssertionError('chain.txt has %d columns' % chain.shape[1])
    out['nested'] = {
        'wall_s': wall, 'launches': launches['nested'],
        'iterations': nested.niter, 'ncall': nested.total_calls,
        'logz_so_far': nested.logz,
        'samples_shape': list(nested.samples.shape),
        'chain_columns': int(chain.shape[1]),
        'max_abs_derived_dev': check_derived(nested.samples, d, 'nested'),
        **stats}

    corr = 0.9
    cov = np.eye(d) + corr * (1.0 - np.eye(d))
    training = np.random.default_rng(10).multivariate_normal(
        np.zeros(d), cov, size=1000)
    for cls, key, steps, chains in ((MCMCSampler, 'mcmc_sampler', 500, 16),
                                    (EnsembleSampler, 'ensemble', 200, 64)):
        s = cls(d, DerivedGaussian(d, corr), prior=UniformPrior(d, -5.0, 5.0),
                num_derived=DERIVED, log_dir=os.path.join(log_dir, 'd_' + key),
                seed=13, device='cuda')
        reset_counts()
        t0 = time.time()
        samples = s.run(steps, chains, training,
                        train_iters=DERIVED_POSTERIOR_EPOCHS)
        launches[key] = read_counts('derived ' + key)
        if samples.shape != (chains, steps + 1, d + DERIVED):
            raise AssertionError('%s samples %s' % (key, samples.shape))
        out[key] = {'wall_s': time.time() - t0, 'launches': launches[key],
                    'samples_shape': list(samples.shape),
                    'max_abs_derived_dev': check_derived(samples, d, key)}

    like = NumpyDerivedGaussian(2)
    dyn = DynamicNestedSampler(2, like, transform=lambda x: 3.0 * x,
                               num_live_init=200, num_derived=DERIVED,
                               log_dir=os.path.join(log_dir, 'd_dynamic'),
                               seed=8, device='cuda')
    reset_counts()
    t0 = time.time()
    dyn.run(G=0.5, num_batches=2, num_live_batch=100, dlogz=0.1,
            train_iters=50)
    launches['host_dynamic'] = read_counts('derived host dynamic')
    analytic = Gaussian(2, 0.0).analytic_logz([-3.0, -3.0], [3.0, 3.0])
    allowed = max(3.0 * dyn.logzerr, 0.15)
    out['host_dynamic'] = {
        'wall_s': time.time() - t0, 'launches': launches['host_dynamic'],
        'logz': dyn.logz, 'logzerr': dyn.logzerr, 'analytic_logz': analytic,
        'allowed': allowed, 'ncall': dyn.total_calls,
        'likelihood_rows': like.calls,
        'samples_shape': list(dyn.samples.shape),
        'max_abs_derived_dev': check_derived(dyn.samples, 2, 'host dynamic')}
    if abs(dyn.logz - analytic) > allowed:
        raise AssertionError('2-D host dynamic run off the analytic logz: %s'
                             % out['host_dynamic'])
    record['launches_by_path']['derived'] = sum(launches.values())

    # one generation with and without derived columns, on the same flow
    plain = NestedSampler(d, Gaussian(d, 0.0), transform=lambda x: 5.0 * x,
                          trainer=nested.trainer, log_dir=None, seed=12,
                          device='cuda')
    gens = {0: mcmc_generation(plain), DERIVED: mcmc_generation(nested)}
    with_d = profile_generation(gens[DERIVED])
    without = profile_generation(gens[0])
    # the unprofiled wall, in turns: without, with, with, without, thrice
    walls = {0: [], DERIVED: []}
    for _ in range(3):
        for nd in (0, DERIVED, DERIVED, 0):
            t0 = time.perf_counter()
            gens[nd]()
            walls[nd].append((time.perf_counter() - t0) * 1e3)
    steps = 80
    out['generation_profile'] = {
        'num_derived_3': with_d, 'num_derived_0': without,
        'device_kernels_per_step_added': (
            with_d['kernel_launches'] - without['kernel_launches']) / steps,
        'wall_ms_in_turns': {'num_derived_0': walls[0],
                             'num_derived_3': walls[DERIVED],
                             'median_0': float(np.median(walls[0])),
                             'median_3': float(np.median(walls[DERIVED]))}}
    return out


def optional_packages():
    """Which of the optional packages the port's tooling uses are here."""
    import importlib
    out = {}
    for name in ('tqdm', 'matplotlib', 'torch.utils.tensorboard'):
        try:
            importlib.import_module(name)
            out[name] = True
        except ImportError:
            out[name] = False
    return out


def quiet(fn, *args):
    """``fn(*args)`` with its standard output captured; (result, text)."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    return out, buf.getvalue()


def training_turns(x, epochs=10):
    """ms an epoch of a 2-D trainer (hidden 16, batch 100) on ``x``, its
    steps eager and replayed as a CUDA graph, in turns (eager, graphed,
    graphed, eager), each after one warm-up epoch (the graph's capture);
    then one graphed epoch profiled."""
    from nnest_torch import Trainer

    def trainer(graphs):
        t = Trainer(2, hidden_dim=16, log=False, seed=0, device='cuda')
        t._use_graphs = graphs
        t.train(x, max_iters=1, jitter=0.0)
        return t

    ms = {False: [], True: []}
    for graphs in (False, True, True, False):
        t = trainer(graphs)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        t.train(x, max_iters=epochs, patience=epochs, jitter=0.0)
        torch.cuda.synchronize()
        ms[graphs].append((time.perf_counter() - t0) * 1e3 / epochs)
    t = trainer(True)

    def one_epoch():
        t.train(x, max_iters=1, jitter=0.0)
        torch.cuda.synchronize()

    return {'rows': int(x.shape[0]), 'steps_per_epoch': -(-int(
        0.9 * x.shape[0]) // 100), 'eager_ms_per_epoch': ms[False],
            'graphed_ms_per_epoch': ms[True],
            'eager_over_graphed': float(np.mean(ms[False])
                                        / np.mean(ms[True])),
            'graphed_epoch_profile': profile_generation(one_epoch)}


def phase_cli(record, log_dir):
    """The port's command lines called in-process, each with the counts
    reset just before and read just after: the nested one at its defaults
    on the 2-D Rosenbrock, its run directory and model file; a second,
    smaller nested run and ``analyse`` over both; the ensemble one with
    both samplers; the optional packages and what they wrote."""
    from nnest_torch import Trainer
    from nnest_torch.cli import analyse, ensemble, nested
    from nnest_torch.ops import spline_inverse as si
    has = optional_packages()
    print(json.dumps({'optional_packages': has}), flush=True)
    root = os.path.join(log_dir, 'cli')
    launches, out = {}, {'optional_packages': has}

    reset_counts()
    t0 = time.time()
    s = nested.main(nested.build_parser().parse_args(
        ['--likelihood', 'rosenbrock', '--x_dim', '2', '--log_dir', root]))
    wall = time.time() - t0
    launches['nested'] = read_counts('cli nested')
    run = s.log_dir
    out['nested'] = {
        'wall_s': wall, 'launches': launches['nested'], 'logz': s.logz,
        'logzerr': s.logzerr, 'expected_logz': ROSENBROCK_LOGZ,
        'allowed': ROSENBROCK_TOL, 'niter': s.niter, 'ncall': s.total_calls,
        'plot_seconds': s.trainer.plot_seconds, **s.run_stats}
    if abs(s.logz - ROSENBROCK_LOGZ) > ROSENBROCK_TOL:
        raise AssertionError('2-D Rosenbrock logz off -5.80: %s'
                             % out['nested'])
    for rel in ('results/final.csv', 'chains/chain.txt', 'info/params.txt',
                'models/netG.pkl', 'data/originals.npy'):
        if not os.path.exists(os.path.join(run, rel)):
            raise AssertionError('the nested command line wrote no %s' % rel)
    # the model file, reloaded as a user would
    loaded = Trainer(2, hidden_dim=16, log_dir=os.path.dirname(run),
                     load_model=os.path.basename(run), log=False,
                     device='cuda')
    pts = np.asarray(s.saved_u[-1000:], dtype=np.float32)
    lp_run = s.trainer.log_probs(pts, to_numpy=True)
    lp_file = loaded.log_probs(pts, to_numpy=True)
    out['nested']['netG_max_abs_dlogprob'] = float(np.max(np.abs(
        lp_run - lp_file)))
    if not (np.all(np.isfinite(lp_run))
            and out['nested']['netG_max_abs_dlogprob'] <= 1e-6):
        raise AssertionError('netG.pkl reloaded disagrees: %s'
                             % out['nested']['netG_max_abs_dlogprob'])
    out['training'] = training_turns(pts)

    # files of the optional packages, there exactly when the package is
    plots = [f for f in os.listdir(os.path.join(run, 'plots'))
             if f.startswith('plot_')]
    events = [f for f in os.listdir(run) if f.startswith('events.out')]
    out['nested'].update(plots=len(plots), event_files=len(events))
    if bool(plots) != has['matplotlib'] or \
            bool(events) != has['torch.utils.tensorboard']:
        raise AssertionError('plots %s, events %s with packages %s'
                             % (plots, events, has))

    # a second, smaller run under the same root, then analyse over both
    reset_counts()
    t0 = time.time()
    small = nested.main(nested.build_parser().parse_args(
        ['--likelihood', 'rosenbrock', '--x_dim', '2', '--log_dir', root,
         '--num_live_points', '200', '--train_iters', '200', '--seed', '1']))
    launches['nested_small'] = read_counts('cli nested (small)')
    out['nested_small'] = {'wall_s': time.time() - t0, 'logz': small.logz,
                           'logzerr': small.logzerr, 'niter': small.niter,
                           'launches': launches['nested_small']}
    _, text = quiet(analyse.main, analyse.build_parser().parse_args(
        ['--root', os.path.join(root, '*'), '--dim', '2', '--merge']))
    print(text, flush=True)
    if 'logz=' not in text or 'Posterior ESS' not in text:
        raise AssertionError('analyse printed no logz= or ESS:\n%s' % text)
    out['analyse_lines'] = len(text.splitlines())

    # launches: one a step and one for the starts (MCMC); two a step (the
    # half-updates) and two a call, bootstrap phase 1 then run (ensemble)
    for sampler, expected in (
            ('mcmc', CLI_MCMC_STEPS + 1),
            ('ensemble', 2 * (CLI_BOOT_STEPS + CLI_MCMC_STEPS) + 4)):
        reset_counts()
        t0 = time.time()
        e = ensemble.main(ensemble.build_parser().parse_args(
            ['--sampler', sampler, '--likelihood', 'rosenbrock', '--x_dim',
             '2', '--mcmc_steps', str(CLI_MCMC_STEPS), '--log_dir',
             os.path.join(log_dir, 'cli_' + sampler)]))
        n = launches[sampler] = read_counts('cli ' + sampler)
        flat = e.samples.reshape(-1, e.samples.shape[-1])
        out[sampler] = {'wall_s': time.time() - t0, 'launches': n,
                        'samples_shape': list(e.samples.shape),
                        'mean': flat.mean(axis=0).tolist(),
                        'std': flat.std(axis=0).tolist(),
                        'ncall': e.total_calls,
                        'trace_plot': os.path.exists(os.path.join(
                            e.log_dir, 'plots', 'trace.png'))}
        if n != expected:
            raise AssertionError('%s command line launched the kernel %d '
                                 'times, expected %d' % (sampler, n, expected))
        if not (np.all(np.isfinite(flat)) and np.all(np.isfinite(
                out[sampler]['std']))):
            raise AssertionError('%s samples not finite' % sampler)
        if sampler == 'mcmc' and out[sampler]['trace_plot'] != \
                has['matplotlib']:
            raise AssertionError('trace.png %s with matplotlib %s'
                                 % (out[sampler]['trace_plot'],
                                    has['matplotlib']))
    record['launches_by_path']['cli'] = sum(launches.values())
    out['launches'] = launches
    return out


def main():
    import argparse
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--baseline', metavar='SRC',
                        help='an earlier kernel source to time beside '
                             'this one in phase 2')
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print('chip_smoke: CUDA is not available', file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import nnest_torch  # noqa: F401  (fails outside a checkout of the repo)

    paths = ('mcmc', 'rejection_flow', 'density_flow', 'per_block', 'slice',
             'mcmc_sampler', 'ensemble', 'dynamic', 'host_likelihood',
             'derived', 'cli')
    records = [
        {'name': 'spline_inverse', 'route': 'cuda',
         'source': 'nnest_torch/csrc/spline_inverse.cu',
         'replaces': 'nnest_tpu/ops/pallas_spline.py:338',
         'launches': None, 'library_ms': None,
         'launches_by_path': dict.fromkeys(paths, 0)},
        {'name': 'spline_inverse_per_block', 'route': 'cuda',
         'source': 'nnest_torch/csrc/spline_inverse.cu',
         'replaces': 'nnest_tpu/ops/pallas_spline.py:346',
         'launches': None, 'library_ms': None,
         'launches_by_path': dict.fromkeys(paths, 0)},
    ]
    with tempfile.TemporaryDirectory(prefix='chip_smoke_') as log_dir:
        earlier = (EarlierKernel(os.path.abspath(args.baseline), log_dir)
                   if args.baseline else None)
        for num, name, fn in (
                (1, 'device', phase_device),
                (2, 'kernel', lambda: phase_kernel(records, earlier)),
                (3, 'main_path', lambda: phase_main_path(records[0],
                                                         log_dir)),
                (4, 'correctness', lambda: phase_correctness(log_dir)),
                (5, 'per_block_entry',
                 lambda: phase_per_block_entry(records[1])),
                (6, 'flow_rejection',
                 lambda: phase_flow_rejection(records, log_dir)),
                (7, 'resume', lambda: phase_resume(log_dir)),
                (8, 'slice', lambda: phase_slice(records[0], log_dir)),
                (9, 'other_flows', lambda: phase_other_flows(log_dir)),
                (10, 'mcmc_ensemble',
                 lambda: phase_mcmc_ensemble(records[0], log_dir)),
                (11, 'dynamic', lambda: phase_dynamic(records[0], log_dir)),
                (12, 'derived', lambda: phase_derived(records[0], log_dir)),
                (13, 'cli', lambda: phase_cli(records[0], log_dir))):
            t0 = time.time()
            out = fn()
            emit({'phase': num, 'name': name,
                  'seconds': time.time() - t0, **out})
    for rec in records:
        # launches on the paths that drive the kernel (phases 3, 5, 6, 8,
        # 10, 11, 12, 13)
        rec['launches'] = sum(rec['launches_by_path'].values())
    emit({'kernels': records})
    emit({'ok': True, 'device': {'platform': 'gpu',
                                 'kind': torch.cuda.get_device_name(0),
                                 'count': torch.cuda.device_count()}})
    return 0


if __name__ == '__main__':
    sys.exit(main())
