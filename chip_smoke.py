#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``nnest_torch``) on one GPU.

Run from the repository root: ``python3 chip_smoke.py``. It imports nothing
from JAX or ``nnest_tpu`` and runs twenty phases (``--phases 3,20`` runs
only those listed), printing one JSON line per phase with its seconds:

1. device: the card's name and power limit (``nvidia-smi``), and the builds
   of ``nnest_torch/csrc/spline_inverse.cu`` and ``consume_pool.cu`` (one
   ``nvcc`` each, started together) with the ``-Xptxas -v`` registers and
   spills of every instantiation;
2. kernel: the CUDA spline-flow inverse against its plain PyTorch twin on
   the card, at d in {2, 5, 16, 50, 100} (hidden 16/16/32/64/64) and N in
   {1, 128, 256, 512, 1000, 4096, 4097}, and at d in {16, 50} with N in
   {65536, 65537} (the flow strategies' trials), and at d = 16 with N in
   {16, 32, 32064} (phase 10's shapes) and N = 200 (phase 11's seed
   refresh), and at d = 2 with N in {10, 16, 32, 64, 32064, 128064}
   (phase 13's command lines: chains, half-updates, the ensemble's starts
   and trajectories) and N in {4, 8} (a rank's share of 8 and 16 chains on
   2 ranks; phase 14's share of 256 chains, d = 16 at N = 128, is in the
   first list), and at hidden 256 (phase 16's tensor-parallel width) at
   d = 16 with N in {1, 16, 256, 4096, 4097} and d = 4 with N in {1, 64,
   4097}, with inputs beyond ±3, exactly at
   ±3 and on spline knots; max |dx| <= 3e-5 and max |dlogdet| <= 3e-4.
   The per-block entry against the twin (the same limits) and against the
   whole-chain kernel (1e-6, 1e-5) at d in {5, 16}. The fast-slow entry
   ``fast_slow_inverse`` at the benchmark's ``mog30fs`` widths (d = 30,
   2 slow dims, both chains at hidden 16; N in {1, 256, 4097}): each
   chain's launch against its twin at d = 2 and d = 28, hidden 16, the
   entry against ``model.inverse`` and against the chains' twins composed
   (the same limits), two launches a call and no twin call, and x's slow
   dims bit for bit under a fast-only move. Then the kernel is
   timed by CUDA-graph replay (and eagerly, back to back) and the twin
   eagerly, at the main path's shapes (N = 512, a slice expansion's
   2 x 256 stacked rows, N = 65536, phase 10's N = 16, 32 and 32064,
   phase 11's N = 200, phase 13's d = 2 shapes, phase 14's per-rank
   shapes and phase 16's hidden-256 shapes (d = 16 at N = 16, 256 and
   4096, d = 4 at N = 64) included) beside the least time the card could
   take;
   the per-block
   entry at d = 16; and the rows a thread block takes and the ring's
   stages are swept (N = 65536: 32, 64 and 128 rows). Then the
   pool-consumption kernel (``consume_pool``) against its twin, bit for
   bit, at every shape a path runs it (``POOL_SHAPES``: 1000 live points x
   256 Metropolis candidates at d = 16, with and without 3 derived values;
   100 x 10 at d = 2; 1000 x 65536 rejection trials with 0.1% and 30%
   flagged; 60000 live points, past its shared memory; 1000 x 512 and
   1000 x 16384 prior-rejection trials with 25% and 0.8% flagged), each
   launch timed between CUDA events beside its bound and the twin's time;
3. main path: ``NestedSampler`` on a 16-D Gaussian (transform 5x, hidden 32,
   256 chains x 80 steps, default strategy and retrain gate) until the
   ladder has reached 'mcmc', the flow has been trained and at least three
   MCMC generations have run; the kernel's launch counter must be > 0; the
   share of their trials its prior-rejection generations passed, by trial
   count (its ``run_stats``), beside ``POOL_SHAPES``' prior rows;
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
   analytic logz within the same bound; the NVP flow's chains run through
   the NVP kernel (``ops/nvp_inverse.py``), so its launches must be > 0
   and the spline kernel's 0; the Cholesky inverse is ``model.inverse`` in
   plain PyTorch, so it launches neither; the fast-slow spline flow's
   chains run through the spline kernel, so its launches must be > 0; no
   twin may be called in any of the three;
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
   timed in turns, and one graphed epoch profiled;
14. mesh: multi-process data parallelism (``nnest_torch.parallel``) on the
   one card, the script starting itself as rank processes with the rank
   variables ``torchrun`` sets: (a) the phase-3 model on 2 ranks over gloo
   (two ranks share the card, which NCCL refuses), 128 chains a rank, 50
   training epochs a training: the
   ranks equal on logz, ncall and niter, the kernel launched on each rank
   (> 0) and the twin never; the run's wall beside phase 3's, one sharded
   generation's wall and collectives (one a step for the dynamic step
   size, two a generation), the time of one collective of a 0-d tensor,
   and a dp-sharded training epoch graphed against eager from the same
   state (equal within 1e-5, both timed); (b) the 2-D Gaussian on 2
   ranks to its analytic logz within max(3 logzerr, 0.15) with a torch
   likelihood and with a numpy one farmed over the ranks, rank 0 alone
   writing; (c) ``python -m nnest_torch.cli.multihost`` as one NCCL rank
   on the 5-D Gaussian to its logz, through MCMC generations; (d) a 2-rank
   run cut at ``max_iters=300`` and resumed by fresh ranks with another
   seed, ncall grown, to its logz. It prints the
   backend of each part and the per-step syncs of (a);
15. prefetch: multi-generation prefetch (``mcmc_gen_batch`` and
   ``rejection_gen_batch``, 8 by default, so phases 3, 6, 8, 11, 12 and 13
   run it, consume_pool launched on phases 3, 6 and 8): the phase-3 model
   at one generation a dispatch, equal to phase 3's run in (logz, h, ncall,
   niter); on its trained flow, one generation a dispatch against eight, in
   turns, for a Metropolis and a prior-rejection generation: the wall a
   generation, the host syncs a generation (under
   ``torch.cuda.set_sync_debug_mode``), the device's busy share and the
   launches a generation; then the 2-D Gaussian (100 live points) at 1 and
   8 with speculation won and lost, with slice and with flow rejection,
   equal bit for bit, and a run cut inside a Metropolis buffer and resumed
   with another seed, equal to the uninterrupted run;
16. tp and runtime: (a) tensor parallelism on the one card, the script
   starting itself as 2 ranks over gloo on a (dp 1, tp 2) mesh:
   ``MCMCSampler`` on phase 10's model (16-D, correlation 0.9) at
   ``hidden_dim=256``, 16 chains, 500 steps, 10 training epochs; the ranks
   equal on the samples bit for bit, the moments within bounds from the
   run's ESS, the kernel launched one a step plus one a call on each rank
   and the twin never; the run's wall, its collectives in training and a
   sampling step, one all-gather's time; a tp training epoch (eager) beside
   a one-rank epoch (graphed) from the same weights on the same data, in
   turns, timed, with their losses and flows after the epoch, and the
   epoch's first step on both: its NLL equal within 1e-5 relative, its
   gradients within rtol 1e-4, atol 1e-5; (b) the native runtime
   (``nnest_torch.runtime``, its g++ build log line printed) against its
   numpy twins on phase 10's MCMC chains and phase 13's ensemble chains:
   ESS, acceptance and jump within 1e-12 relative, timed in turns (native,
   numpy, numpy, native), and the ensemble's 64 chain files written
   natively against ``np.savetxt``, byte-equal, timed in turns; the
   runtime's native calls (> 0) and fallbacks (0) on phases 10 and 13;
17. prewarm, traces and the Jacobian oracle: (a) cold starts in turns
   (prewarm, plain, prewarm, plain), each the script started as a process
   of its own whose kernel and runtime build directories point at a new
   empty one: the 2-D Gaussian (100 live points, ``train_iters=50``,
   ``dlogz=0.5``, seed 42) at the default ladder, after
   ``NestedSampler.prewarm`` in a prewarm turn; each turn's prewarm walls,
   which library was built in the prewarm and which in the run, the run's
   wall and first generation's seconds; no build inside a prewarmed run
   (the build directory unchanged by it), both kernels launched by each
   prewarm, the four runs' (logz, h, ncall) equal; (b)
   ``nnest_torch.utils.device_trace`` around one Metropolis batch of
   phase 3's model (2 generations of 256 chains x 80 steps, from a
   synthetic shell) under ``trace_annotation('mcmc_generation')``: the
   trace file holds the region and both kernels' symbols, and the device
   kernels a step are printed by name with their counts; phase 3's
   ``Phase timers`` (``Sampler.timers``), which must sum to no more than
   its run's wall; (c) the kernel's logdet against
   ``nnest_torch.flows.testing.brute_force_logdet`` of the plain model
   (autograd on the card) at d = 2, hidden 16 and d = 16, hidden 32, N =
   64 rows of N(0, 2^2), within rtol and atol 1e-3;
18. training kernels: (a) the spline coupling's kernel pair
   (``ops/spline_coupling.py``, ``csrc/spline_coupling.cu``) at the
   benchmark cells' coupling halves (1, 8, 14 and 25 dims, K = 8) at 100
   and 256 rows: y and the row logdet within the inverse kernel's 3e-5
   and 3e-4 of the plain version, both gradients within 1e-4 of the
   largest magnitude of float64 autograd's, two launches bit-equal;
   each kernel timed by CUDA-graph replay and eagerly beside its bound,
   the pair's forward and backward against the plain forward and the
   plain forward and backward, by graph replay; (b) for the cells' three flows (d 16 and 50 at hidden 16, the
   d 30 fast-slow flow with 2 slow dims), a captured training step at
   batch 100 with the coupling's transform plain and fused, in turns: a
   short training's ``train_step`` counter (all ``fused``, or all
   ``plain``) and kernel launches (> 0 fused, 0 plain), the kernels one
   replay runs by name, a replay's device time and an epoch's wall (1000
   rows). Phase 3's training must launch the pair too;
19. NVP kernel: the build of ``nnest_torch/csrc/nvp_inverse.cu`` with its
   ``-Xptxas -v`` report; the kernel (``ops/nvp_inverse.py``) at the
   benchmark's ``gauss50nvp`` widths (d 50, 3 couplings: hidden 16 and 64
   with ``scale`` '', hidden 16 with ``'translate'`` and ``'constant'``;
   1, 256 and 4097 rows) against its twin and ``model.inverse`` on the
   card (the phase-2 limits) and the float64 reference of
   ``portbench/reference/flows/nvp.py`` (1e-4 and 1e-3), each relative to
   max(1, |value|) (the flow's x is unbounded), one launch a call
   and no twin call, each row on its own at a second batch size; then
   timed at 256 rows (hidden 16 and 64) and 4097 rows (hidden 16) by
   CUDA-graph replay and eagerly beside its bound (the reference's
   ``inverse_cost``), against ``model.inverse`` eagerly and by graph
   replay, with the aten operations one plain call dispatches;
20. spline chain kernels: the build of ``nnest_torch/csrc/spline_chain.cu``
   with its ``-Xptxas -v`` report; (a) the chain's pair
   (``ops/spline_chain.py``) at the cells' chains (d 16 and 50, the
   fast-slow flow's 2-dim and 28-dim chains; hidden 16, K 8) at 100 rows
   forward and backward and at 256 and 1000 rows forward, against float64
   (y within 1.5e-5 and the row logdet within 3e-5 of max(1, |value|), or
   within twice the plain chain's own distance in float32 where that is
   farther; the gradients' largest gap, each relative to its largest
   magnitude, within twice float32's own, autograd through the plain
   chain in float32 on the CPU and on the card, plus 1e-5), two launches
   bit-equal, each launch timed by CUDA-graph replay and eagerly beside
   its bound (``chain_cost``), the pair against
   the module-by-module chain (each coupling half on its own pair) by
   graph replay; (b) for the cells' three flows, a captured training step
   with each coupling half's pair and with the chain's, in turns: the
   counters of a short training, the kernels one replay runs, a replay's
   device time and an epoch's wall (1000 rows). Phase 3's training launches
   a training pair (the chain's, at its widths).

Depth cut to keep the script inside its time limit (widths and checks
unchanged; old -> new): phase 2's plain-twin timing, 5 warm-up calls then
10 runs of 20 -> 2 then 3 runs of 5 (``PLAIN_TIMING``); phase 14 (a)'s
training epochs, 100 -> 50 (``MESH_TRAIN_ITERS``).

``--baseline SRC`` also builds SRC, an earlier version of the kernel with
its own C entry point (the unpadded layout, no launch plan), checks it
against the twin and times it beside this kernel at every phase-2 shape
and the sweep's, in turns (earlier, this, this, earlier).
``--pool-baseline SRC`` does the same for another ``consume_pool.cu``
(its C entry with or without the scratch argument): built under its own
library name beside the port's sources, held to the twin bit for bit and
timed in turns with this kernel at every ``POOL_SHAPES`` row.

Before the last line it prints the ``{"kernels": [...]}`` record, with each
kernel's launches by path (``mcmc``: phase 3, ``rejection_flow`` and
``density_flow``: phase 6, ``per_block``: phase 5, ``slice``: phase 8,
``mcmc_sampler`` and ``ensemble``: phase 10, ``dynamic`` and
``host_likelihood``: phase 11, ``derived``: phase 12, ``cli``: phase 13,
``mesh``: phase 14, every rank's launches in parts a, b and d,
``prefetch``: phase 15, ``tp``: phase 16, both ranks' launches,
``prewarm``: the prewarms of phase 17 (a), ``cold_start``: its four runs;
consume_pool's by the first word of each path; the NVP kernel's:
``other_flows``, phase 9, and ``nvp_kernel``, phase 19; the chain pair's:
``mcmc``, phase 3, and ``chain_kernel``, phase 20);
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
# phase 14's ranks (two processes on the one card) and the 2-D runs' sizes
# (phase 11's host-likelihood run: 200 live points, a volume switch to
# MCMC at ~140 iterations, 50 training epochs); the resumed run is cut at
# this iteration, past the switch
MESH_RANKS = 2
# part (a)'s training epochs (cut from phase 3's 100, which took ~25 s of
# a rank's 34 s run)
MESH_TRAIN_ITERS = 50
MESH_2D_LIVE, MESH_2D_TRAIN_ITERS, MESH_2D_SWITCH = 200, 50, 0.5
MESH_CUT_ITERS = 300
# the multihost command line's dimension in phase 14: the smallest at which
# its run (200 live points, no volume switch) reaches MCMC
MESH_CLI_DIM = 5
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


# the plain twin's timing in phase 2: 2 warm-up calls, then the median of
# 3 runs of 5 calls (cut from 5, then 10 runs of 20: ~75 s of the phase at
# the large shapes)
PLAIN_TIMING = {'reps': 3, 'calls': 5, 'warmup': 2}


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


def random_flow(d, seed, device, hidden=None):
    """A random spline flow at the autoscaled width (or ``hidden``),
    ActNorm initialised on a non-trivial data batch so every block is off
    the identity."""
    from nnest_torch.flows import build_flow
    model = build_flow(d, hidden_dim=hidden or hidden_for(d), seed=seed,
                       device=device)
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
        elif 'Compiling entry' in line:
            m = re.search(r"entry function '(\w+)'", line)
            label = m.group(1) if m else line.strip()
        elif 'spill' in line or 'Used' in line:
            out.append('%s: %s' % (label, line.strip()))
    return out


def phase_device(earlier):
    """The card, and the builds: the port's two sources and the earlier
    versions of ``earlier`` (a dict of name to a constructor, replaced by
    what each returns), one nvcc for each, started together."""
    from concurrent.futures import ThreadPoolExecutor
    from nnest_torch.ops import consume_pool as cp
    from nnest_torch.ops import spline_coupling as sc
    from nnest_torch.ops import spline_inverse as si
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.time()
    with ThreadPoolExecutor(3 + len(earlier)) as pool:
        port = [pool.submit(m.load_library) for m in (si, cp, sc)]
        more = {name: pool.submit(make) for name, make in earlier.items()}
        for f in port:
            f.result()
        earlier.update({name: f.result() for name, f in more.items()})
    build_s = time.time() - t0
    ptxas = ptxas_report(si.build_log) + [
        '%s: %s' % (name, line.strip())
        for name, m in (('consume_pool', cp), ('spline_coupling', sc))
        for line in m.build_log.splitlines()
        if 'spill' in line or 'Used' in line]
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


class EarlierPool:
    """An earlier version of the pool-consumption kernel, built from ``src``
    (``--pool-baseline``) under its own library name: C entry
    ``nnest_consume_pool(au, al, ad, it_in, it_out, crossed_out, flags,
    cand_logl, cand_x, cand_d, n, d, k, m, update_interval, stream)``, or,
    where the library has ``nnest_consume_pool_scratch_bytes``, the
    wrapper's entry with its scratch pointer before the stream. Called as
    ``consume_pool`` is; it is timed beside the port's kernel, counts no
    launch and is no part of the port."""

    def __init__(self, src, build_dir):
        import ctypes
        from nnest_torch.ops.consume_pool import bind
        from nnest_torch.ops.spline_inverse import NVCC_FLAGS, _find_nvcc
        so = os.path.join(build_dir, 'libconsume_pool_earlier.so')
        subprocess.run([_find_nvcc(), *NVCC_FLAGS, '-o', so, src],
                       check=True, capture_output=True, text=True)
        self.lib = ctypes.CDLL(so)
        self.scratch = hasattr(self.lib, 'nnest_consume_pool_scratch_bytes')
        if self.scratch:
            self.lib = bind(so)
        else:
            vp, ci = ctypes.c_void_p, ctypes.c_int
            self.lib.nnest_consume_pool.argtypes = [vp] * 10 + [ci] * 5 + [vp]
            self.lib.nnest_consume_pool.restype = ci

    def __call__(self, au, al, ad, it, flags, cand_logl, cand_x,
                 cand_derived, update_interval=None):
        n, d = au.shape
        k = 0 if ad is None else ad.shape[1]
        it_out = torch.empty((), dtype=torch.int32, device=au.device)
        crossed = torch.empty((), dtype=torch.bool, device=au.device)
        m = cand_logl.shape[0]
        scratch = []
        if self.scratch:
            buf = torch.empty(self.lib.nnest_consume_pool_scratch_bytes(n, m),
                              dtype=torch.uint8, device=au.device)
            scratch = [buf.data_ptr()]
        err = self.lib.nnest_consume_pool(
            au.data_ptr(), al.data_ptr(), ad.data_ptr() if k else None,
            it.data_ptr(), it_out.data_ptr(), crossed.data_ptr(),
            flags.data_ptr(), cand_logl.data_ptr(), cand_x.data_ptr(),
            cand_derived.data_ptr() if k else None, n, d, k, m,
            int(update_interval or 0), *scratch,
            torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError('earlier pool kernel launch failed: %d' % err)
        return au, al, ad, it_out, crossed


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
# a rank's share of the chains on the mesh path (phase 14): the 16-D
# model's 256 chains on 2 ranks, and the 2-D runs' 8 and 16 chains of the
# CPU tests on 2 ranks
MESH_SHAPES = ((16, 128), (2, 4), (2, 8))
# the tensor-parallel path's width (phase 16: the 16-D model at hidden
# 256, 16 chains) and its shapes: a full-MH step's 16 chains, 256 and 4096
# rows, and the CPU tests' 4-D flow at 64 rows (tests/test_torch_tp.py)
TP_HIDDEN = 256
TP_SHAPES = ((16, 16), (16, 256), (16, 4096), (4, 64))
TIMED_SHAPES = ((16, 256), (16, 4096), (2, 128), (50, 256), (50, 4096),
                (16, FLOW_TRIALS), (50, FLOW_TRIALS), (16, 512)) \
    + POSTERIOR_SHAPES + ((16, DYN_BATCH_LIVE),) + CLI_SHAPES + MESH_SHAPES


# the fast-slow flow of the benchmark's mog30fs configuration (upstream
# run_mog4_fast.sh at its largest x_dim): 2 slow dims and 28 fast ones,
# both chains at hidden 16, and the row counts its entry is held at
FAST_SLOW_DIM, FAST_SLOW_SLOW, FAST_SLOW_HIDDEN = 30, 2, 16
FAST_SLOW_ROWS = (1, 256, 4097)


def random_fast_slow_flow(d, num_slow, seed, device,
                          hidden=FAST_SLOW_HIDDEN):
    """A random fast-slow spline flow, ActNorm initialised as in
    ``random_flow``, then every parameter moved by N(0, 0.05^2), so the
    combine coupling is off the identity too."""
    from nnest_torch.flows import build_flow
    model = build_flow(d, num_slow=num_slow, hidden_dim=hidden, seed=seed,
                       device=device)
    g = torch.Generator(device=device).manual_seed(seed)
    model.data_init(0.7 * torch.randn(512, d, generator=g, device=device)
                    + 0.3)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=g, device=device))
    return model


def fast_slow_checks(check):
    """``fast_slow_inverse`` on card tensors at ``FAST_SLOW_ROWS``: each
    chain's launch against its twin on the combine coupling's output (the
    held cases, returned first), the entry against ``model.inverse`` and
    against the chains' twins composed, two launches a call and no twin
    call, and x's slow dims bit for bit under a fast-only latent move
    (the fast dims moved). ``check`` is ``phase_kernel``'s."""
    from nnest_torch.ops import fused_spline
    from nnest_torch.ops import spline_inverse as si
    from nnest_torch.ops.fused_spline import (_inverse_body,
                                              pack_fast_slow_consts)
    device = torch.device('cuda')
    d, k = FAST_SLOW_DIM, FAST_SLOW_SLOW
    model = random_fast_slow_flow(d, k, seed=500 + d, device=device)
    packed = pack_fast_slow_consts(model)
    fast_only = torch.ones(d, device=device)
    fast_only[:k] = 0.0
    held, entry = [], []
    for n in FAST_SLOW_ROWS:
        g = torch.Generator(device=device).manual_seed(13 * n + d)
        z = 2.0 * torch.randn(n, d, generator=g, device=device)
        if n >= 4:
            z[0], z[1], z[2] = 3.0, -3.0, 4.5
        launches, twin = si.launches, fused_spline.calls
        got = si.fast_slow_inverse(z, packed)
        torch.cuda.synchronize()
        if si.launches - launches != 2 or fused_spline.calls != twin:
            raise AssertionError(
                'fast-slow entry at n=%d: %d launches (want 2), %d twin '
                'calls (want 0)' % (n, si.launches - launches,
                                    fused_spline.calls - twin))
        with torch.no_grad():
            want = model.inverse(z)
            h, ld_c = packed['combine'].inverse(z)
        twins = []
        for name, v in (('slow', h[:, :k]), ('fast', h[:, k:])):
            v = v.contiguous()
            chain = packed[name]
            kx = si._launch(v, chain, 0, len(chain['blocks']), True)
            ref = _inverse_body(v, chain)
            torch.cuda.synchronize()
            ex, eld = check('kernel on the %s chain' % name, kx, ref, TOL_X,
                            TOL_LOGDET, v.shape[1], n)
            held.append({'d': v.shape[1], 'hidden': FAST_SLOW_HIDDEN,
                         'n': n, 'chain': name, 'max_abs_dx': ex,
                         'max_abs_dlogdet': eld})
            twins.append(ref)
        (xs, lds), (xf, ldf) = twins
        ex, eld = check('fast-slow entry against model.inverse', got, want,
                        TOL_X, TOL_LOGDET, d, n)
        tx, tld = check('fast-slow entry against its chains\' twins', got,
                        (torch.cat([xs, xf], dim=1), lds + ldf + ld_c),
                        TOL_X, TOL_LOGDET, d, n)
        dz = 0.3 * torch.randn(n, d, generator=g, device=device) * fast_only
        moved = si.fast_slow_inverse(z + dz, packed)
        torch.cuda.synchronize()
        if not torch.equal(moved[0][:, :k], got[0][:, :k]):
            raise AssertionError('fast-slow entry at n=%d: a fast-only move '
                                 'changed x\'s slow dims' % n)
        if torch.equal(moved[0][:, k:], got[0][:, k:]):
            raise AssertionError('fast-slow entry at n=%d: a fast-only move '
                                 'left x\'s fast dims as they were' % n)
        entry.append({'d': d, 'num_slow': k, 'hidden': FAST_SLOW_HIDDEN,
                      'n': n, 'launches': 2, 'vs_model_dx': ex,
                      'vs_model_dlogdet': eld, 'vs_twins_dx': tx,
                      'vs_twins_dlogdet': tld, 'slow_dims_bit_exact': True})
    return held, entry


def phase_kernel(records, earlier, earlier_pool):
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
            wide += tuple(n for dd, n in CLI_SHAPES + MESH_SHAPES if dd == 2)
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

    # the tensor-parallel path's width, a new shape for the kernel
    for d in sorted({d for d, _ in TP_SHAPES}):
        model = random_flow(d, seed=400 + d, device=device,
                            hidden=TP_HIDDEN)
        packed = pack_inverse_consts(model)
        for n in sorted({n for dd, n in TP_SHAPES if dd == d} | {1, 4097}):
            z = kernel_inputs(model, n, seed=11 * n + d, device=device)
            got = si.spline_inverse(z, packed)
            ref = _inverse_body(z, packed)
            torch.cuda.synchronize()
            ex, eld = check('kernel at hidden %d' % TP_HIDDEN, got, ref,
                            TOL_X, TOL_LOGDET, d, n)
            cases.append({'d': d, 'hidden': TP_HIDDEN, 'n': n,
                          'max_abs_dx': ex, 'max_abs_dlogdet': eld})
            worst['x'], worst['ld'] = max(worst['x'], ex), max(worst['ld'],
                                                               eld)

    # the fast-slow entry and its chains at the benchmark's mog30fs widths
    held, fast_slow = fast_slow_checks(check)
    cases += held
    for case in held:
        worst['x'] = max(worst['x'], case['max_abs_dx'])
        worst['ld'] = max(worst['ld'], case['max_abs_dlogdet'])

    def shape_timing(d, n, per_block=False, hidden=None):
        hidden = hidden or hidden_for(d)
        model = random_flow(d, seed=200 + d, device=device, hidden=hidden)
        packed = pack_inverse_consts(model)
        z = kernel_inputs(model, n, seed=n, device=device)
        fn = ((lambda: si.spline_inverse_per_block(z, packed)) if per_block
              else (lambda: si.spline_inverse(z, packed)))
        ms, e_ms = timed_pair(fn, None if (earlier is None or per_block)
                              else (lambda: earlier(z, packed)))
        eager_ms = cuda_time_ms(fn)
        # the plain twin (tens of ms a call at the large shapes) is timed
        # with fewer calls than the kernel: PLAIN_TIMING
        plain_ms = cuda_time_ms(lambda: _inverse_body(z, packed),
                                **PLAIN_TIMING)
        ops, nbytes = inverse_cost(n, d, hidden, 8, 3)
        b_ms, b_by = bound_ms(ops, nbytes)
        plan = si.launch_plan(n, d, hidden, 8)
        out = {'d': d, 'hidden': hidden, 'n': n, 'ms': ms,
               'eager_ms': eager_ms, 'plain_ms': plain_ms, 'bound_ms': b_ms, 'bound_by': b_by,
               'over_bound': ms / b_ms, 'ops': ops, 'bytes': nbytes,
               'rows': plan['rows'], 'stages': plan['stages']}
        if e_ms is not None:
            out.update({'earlier_ms': e_ms, 'earlier_over_this': e_ms / ms})
        return out

    timings = [shape_timing(d, n) for d, n in TIMED_SHAPES] + [
        shape_timing(d, n, hidden=TP_HIDDEN) for d, n in TP_SHAPES]
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

    pool = consume_pool_checks(records[2], earlier_pool)
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
            'max_abs_dlogdet': worst['ld'], 'fast_slow': fast_slow,
            'timings': timings,
            'per_block_timings': per_block, 'rows_sweep': sweep,
            'consume_pool': pool}


# consume_pool's shapes: (live points, candidates, d, derived values, share
# of the candidates flagged, what runs it). A phase-3 Metropolis generation
# (256 chains), the same with phase 12's derived values, the 2-D command
# line's (100 live points in the CPU tests' runs, 10 chains), a rejection
# generation at 65536 trials with few candidates passing and with many (a
# flow generation just after the switch, before the ladder halves the
# trials), a live set past the kernel's shared memory (its global-memory
# path), and phase 3's prior-rejection generations (44 of its 49
# launches): the trial ladder's start (rejection_batch_size 512, the ladder
# holding n_ok near trials_target = 1000 // 8 = 125) and a deep rung
# (16384 trials); phase 3 reports the shares its prior generations passed.
POOL_SHAPES = ((1000, 256, 16, 0, 0.9, 'mcmc'),
               (1000, 256, 16, 3, 0.9, 'derived'),
               (100, 10, 2, 0, 0.9, 'cli'),
               (1000, 65536, 16, 0, 0.001, 'rejection'),
               (1000, 65536, 16, 0, 0.3, 'rejection, many passing'),
               (60000, 256, 2, 0, 0.9, 'global memory'),
               (1000, 512, 16, 0, 0.25, 'prior'),
               (1000, 16384, 16, 0, 0.008, 'prior, deep'))


def pool_inputs(n, m, d, k, share, seed):
    """Live set and candidates on the card, logl rounded to 0.01 so that
    ties occur: (au, al, ad, it, flags, cand_logl, cand_x, cand_derived)."""
    g = torch.Generator(device='cuda').manual_seed(seed)

    def normal(*shape, mean=0.0):
        return torch.randn(*shape, generator=g, device='cuda') + mean

    al = torch.round(normal(n) * 100) / 100
    cl = torch.round(normal(m, mean=0.5) * 100) / 100
    flags = torch.rand(m, generator=g, device='cuda') < share
    return (normal(n, d), al, normal(n, k) if k else None,
            torch.tensor(5, dtype=torch.int32, device='cuda'), flags, cl,
            normal(m, d), normal(m, k) if k else None)


def pool_cost(n, m, d, k, flagged, sectors, accepts, slots):
    """(operations, bytes) that one consumption needs at these inputs:
    a compare a flagged candidate, a tournament over the live set at the
    start (n compares) and its path after each accept (ceil(log2 n)
    compares); the m flags read, the logl of the flagged candidates only
    (``sectors``: the 32-byte sectors of the candidates' logl that hold a
    flagged one), the live logl read once, ``it`` read and written and the
    boundary flag written, and for each slot replaced (``slots``; a slot's
    last accept overwrites the others) its row of x and derived read and
    written and its logl written."""
    ops = flagged + n + accepts * math.ceil(math.log2(max(n, 2)))
    nbytes = m + 32 * sectors + 4 * n + 9 + slots * (8 * d + 8 * k + 4)
    return ops, nbytes


def pool_ms(fn, fresh, reps=20):
    """Device ms of one consumption by ``fn``: each launch between CUDA
    events on its own fresh copy of the inputs, all queued behind a sleep
    so that the host's launch cost stays out; the median."""
    copies = [fresh() for _ in range(reps)]
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda.synchronize()
    torch.cuda._sleep(int(5e6))
    for (start, end), args in zip(events, copies):
        start.record()
        fn(*args, update_interval=7)
        end.record()
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in events]))


def consume_pool_checks(record, earlier=None):
    """consume_pool against its twin at every shape a path runs
    (:data:`POOL_SHAPES`), bit for bit (live set, logl, derived, it and
    the boundary flag, signed zeros included), then timed by
    :func:`pool_ms`; the twin (which reads a flag to the host an accept)
    by the host clock; the bound from :func:`pool_cost`. With ``earlier``
    (an :class:`EarlierPool`) that kernel is held to the twin the same way
    and timed in turns with this one (earlier, this, this, earlier)."""
    from nnest_torch.ops.consume_pool import consume_pool, consume_pool_twin
    shapes = []
    for i, (n, m, d, k, share, path) in enumerate(POOL_SHAPES):
        inputs = pool_inputs(n, m, d, k, share, seed=40 + i)

        def fresh():
            return [None if t is None else t.clone() for t in inputs]

        want = consume_pool_twin(*fresh(), update_interval=7)
        kernels = [('this', consume_pool)]
        if earlier is not None:
            kernels.append(('earlier', earlier))
        for name, fn in kernels:
            got = fn(*fresh(), update_interval=7)
            torch.cuda.synchronize()
            for part, a, b in zip(('au', 'al', 'ad', 'it', 'crossed'), got,
                                  want):
                # the same bits, signed zeros included
                if (a is None) != (b is None) or (a is not None and not (
                        torch.equal(a.reshape(-1).view(torch.uint8),
                                    b.reshape(-1).view(torch.uint8)))):
                    raise AssertionError(
                        '%s consume_pool differs from its twin in %s at '
                        'n=%d m=%d d=%d k=%d' % (name, part, n, m, d, k))
        accepts = int(want[3]) - 5
        flags = inputs[4]
        flagged = int(flags.sum())
        padded = torch.zeros(m + -m % 8, dtype=torch.bool, device='cuda')
        padded[:m] = flags
        sectors = int(padded.view(-1, 8).any(1).sum())
        # a replaced slot ends strictly above its first value
        slots = int((want[1] != inputs[1]).sum())
        if earlier is None:
            ms, e_ms = pool_ms(consume_pool, fresh), None
        else:
            e1 = pool_ms(earlier, fresh)
            f1 = pool_ms(consume_pool, fresh)
            f2 = pool_ms(consume_pool, fresh)
            e2 = pool_ms(earlier, fresh)
            ms, e_ms = (f1 + f2) / 2, (e1 + e2) / 2
        plain = []
        for _ in range(3):
            args = fresh()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            consume_pool_twin(*args, update_interval=7)
            torch.cuda.synchronize()
            plain.append((time.perf_counter() - t0) * 1e3)
        ops, nbytes = pool_cost(n, m, d, k, flagged, sectors, accepts, slots)
        b_ms, b_by = bound_ms(ops, nbytes)
        row = {'path': path, 'n': n, 'm': m, 'd': d, 'k': k,
               'share': share, 'flagged': flagged, 'sectors': sectors,
               'accepts': accepts, 'slots': slots, 'ms': ms,
               'plain_ms': float(np.median(plain)), 'bound_ms': b_ms,
               'bound_by': b_by, 'over_bound': ms / b_ms, 'ops': ops,
               'bytes': nbytes}
        if e_ms is not None:
            row.update({'earlier_ms': e_ms, 'earlier_over_this': e_ms / ms,
                        'turns_ms': {'earlier': [e1, e2], 'this': [f1, f2]}})
        print('consume_pool %-24s n=%-5d m=%-5d accepts %-4d slots %-4d '
              '%.6f ms%s, bound %.3g ms (%s)' % (
                  path, n, m, accepts, slots, ms,
                  '' if e_ms is None else ' (earlier %.6f)' % e_ms,
                  b_ms, b_by), flush=True)
        shapes.append(row)
    main = shapes[0]
    record.update({'max_abs_err': 0.0, 'ms': main['ms'],
                   'plain_ms': main['plain_ms'], 'bound_ms': main['bound_ms'],
                   'bound_by': main['bound_by'],
                   'shape': 'n=1000 m=256 d=16', 'shapes': shapes})
    return shapes


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


def main_path_sampler(log_dir, name, tooling='on', mesh=None):
    """Phase 3's sampler: the 16-D Gaussian, 5x box. ``tooling`` 'on': the
    default trainer, which writes ``netG.pkl``, ``originals.npy`` and
    TensorBoard events into the run directory; 'files': the same without
    the events; 'off': a trainer with the same arguments and no run
    directory. The sampler's own files and checkpoints are always
    written. ``mesh`` makes it a rank of a multi-process run (phase 14)."""
    from nnest_torch import NestedSampler, Trainer
    from nnest_torch.likelihoods import Gaussian
    d = 16
    trainer = None
    if tooling == 'off':
        # the arguments the sampler gives its default trainer
        trainer = Trainer(d, hidden_dim=32, learning_rate=0.001, seed=2,
                          device='cuda', mesh=mesh)
    sampler = NestedSampler(d, Gaussian(d, 0.0), transform=lambda x: 5.0 * x,
                            log_dir=os.path.join(log_dir, name), seed=1,
                            trainer=trainer, device='cuda', mesh=mesh)
    if tooling == 'files' and sampler.trainer.writer is not None:
        sampler.trainer.writer.close()
        sampler.trainer.writer = None
    return sampler


def scalar_cost(log_dir, n=2000):
    """Host microseconds of one TensorBoard ``add_scalar`` on this
    machine's CPU (the writer's own thread included by the closing flush),
    the protobuf implementation behind it, and a scalar's share of one
    batch of ``n`` through the port's writer (``utils/events.py``, the
    native runtime's one call); None without TensorBoard."""
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:
        return None
    from google.protobuf.internal import api_implementation
    from nnest_torch import runtime
    from nnest_torch.utils.events import ScalarEventFile
    runtime.load_library()   # a checkout's first call builds it: not timed
    writer = SummaryWriter(os.path.join(log_dir, 'scalar_cost'))
    t0 = time.perf_counter()
    for i in range(n):
        writer.add_scalar('logz', float(i), i)
    writer.close()
    add_scalar_us = (time.perf_counter() - t0) * 1e6 / n
    batch = ScalarEventFile(os.path.join(log_dir, 'scalar_cost'))
    t0 = time.perf_counter()
    batch.write('logz', range(n), np.arange(n, dtype=np.float64),
                np.full(n, time.time()))
    return {'add_scalar_us': add_scalar_us,
            'batch_us_per_scalar': (time.perf_counter() - t0) * 1e6 / n,
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


def prior_shares(by_trials):
    """The share of its trials phase 3's prior-rejection generations passed
    (``n_ok / trials``), by trial count, from the sampler's
    ``run_stats['rejection_by_trials']``, beside :data:`POOL_SHAPES`'
    prior rows."""
    return {'generations': sum(g for g, _ in by_trials.values()),
            'pool_shapes': {m: share for _, m, _, _, share, path in
                            POOL_SHAPES if path.startswith('prior')},
            'by_trials': {t: {'generations': g, 'passed': ok,
                              'share': ok / (g * t)}
                          for t, (g, ok) in sorted(by_trials.items())}}


def phase_main_path(record, log_dir):
    sampler = main_path_sampler(log_dir, 'main')
    reset_counts()
    t0 = time.time()
    sampler.run(max_iters=5200, train_iters=100)
    wall = time.time() - t0
    timers = {k: v['total_s'] for k, v in sampler.timers.summary().items()}
    launches = read_counts('mcmc', pool_launched=True)
    record['launches_by_path']['mcmc'] = launches
    from nnest_torch.ops import spline_chain as sch
    from nnest_torch.ops import spline_coupling as sc
    if sc.launches + sch.launches <= 0:
        raise AssertionError('the main path\'s training never launched a '
                             'training kernel pair')
    COUPLING_LAUNCHES['mcmc'] = sc.launches
    CHAIN_LAUNCHES['mcmc'] = sch.launches
    stats = sampler.run_stats
    if stats['mcmc_generations'] < 3 or stats['trainings'] < 1:
        raise AssertionError('main path did not reach 3 MCMC generations '
                             'and a training: %s' % stats)
    if not math.isfinite(sampler.logz):
        raise AssertionError('non-finite logz %r' % sampler.logz)
    return {'wall_s': wall, 'launches': launches, 'iterations': sampler.niter,
            'ncall': sampler.total_calls, 'logz_so_far': sampler.logz,
            'h': sampler.h, 'pool_launches': POOL_LAUNCHES['mcmc'],
            'phase_timers': timers,
            'prior_shares': prior_shares(stats['rejection_by_trials']),
            'training_epochs': sampler.trainer.total_iters, **stats,
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


# consume_pool's launches by path (the first word of read_counts' path),
# added up over the phases
POOL_LAUNCHES = {}
# the spline coupling pair's and the spline chain pair's launches in phase
# 3's run (its trainings)
COUPLING_LAUNCHES = {}
CHAIN_LAUNCHES = {}


def reset_counts():
    from nnest_torch.ops import consume_pool as cp
    from nnest_torch.ops import fused_spline
    from nnest_torch.ops import nvp_inverse as nv
    from nnest_torch.ops import spline_chain as sch
    from nnest_torch.ops import spline_coupling as sc
    from nnest_torch.ops import spline_inverse as si
    si.launches = si.launches_per_block = 0
    sc.launches = sch.launches = 0
    fused_spline.calls = 0
    nv.launches = nv.calls = 0
    cp.launches = cp.twin_calls = 0


def read_counts(path, pool_launched=False):
    """The launch counts after a path, checked: the whole-chain kernel
    launched, neither plain twin called, and with ``pool_launched`` the
    consumption kernel launched too (a path that prefetches generations).
    consume_pool's launches go to :data:`POOL_LAUNCHES`."""
    from nnest_torch.ops import consume_pool as cp
    from nnest_torch.ops import fused_spline
    from nnest_torch.ops import spline_inverse as si
    torch.cuda.synchronize()
    launches, twin = si.launches, fused_spline.calls
    if launches <= 0:
        raise AssertionError('the %s path never launched the kernel' % path)
    if twin != 0:
        raise AssertionError('the %s path called the plain twin %d times on '
                             'the card' % (path, twin))
    if cp.twin_calls != 0:
        raise AssertionError('the %s path called consume_pool\'s twin %d '
                             'times on the card' % (path, cp.twin_calls))
    if pool_launched and cp.launches <= 0:
        raise AssertionError('the %s path never launched consume_pool'
                             % path)
    key = path.split()[0]
    POOL_LAUNCHES[key] = POOL_LAUNCHES.get(key, 0) + cp.launches
    return launches


def time_dispatches(sampler, names):
    """Wrap the pool-generation methods ``names`` of ``sampler`` so that
    each call records its wall (each ends in a device-to-host copy), the
    spline kernel's launches and its generations (a batch helper's list,
    else one). Returns (the records, a function that unwraps them)."""
    from nnest_torch.ops import spline_inverse as si
    calls = []
    for name in names:
        def timed(*args, _real=getattr(sampler, name), _name=name,
                  **kwargs):
            n0 = si.launches
            t0 = time.perf_counter()
            out = _real(*args, **kwargs)
            calls.append({'method': _name,
                          'ms': (time.perf_counter() - t0) * 1e3,
                          'launches': si.launches - n0,
                          'generations': (len(out) if _name.endswith('_batch')
                                          else 1)})
            return out
        setattr(sampler, name, timed)

    def undo():
        for name in names:
            delattr(sampler, name)

    return calls, undo


def per_generation_ms(calls):
    """The median wall a generation over the dispatches ``calls``."""
    return float(np.median([c['ms'] / max(c['generations'], 1)
                            for c in calls])) if calls else None


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
    calls, undo = time_dispatches(sampler, (
        '_rejection_flow_sample', '_rejection_flow_generations_batch'))
    reset_counts()
    t0 = time.time()
    # max_iters < update_interval (500): one training, no retrain check
    sampler.run(strategy=['rejection_flow', 'mcmc'], max_iters=499,
                train_iters=100, rejection_batch_size=FLOW_TRIALS,
                rejection_max_trials=FLOW_TRIALS)
    wall = time.time() - t0
    launches = read_counts('rejection_flow', pool_launched=True)
    undo()
    stats = sampler.run_stats
    if stats['rejection_flow_generations'] < 3 or stats['trainings'] < 1:
        raise AssertionError('flow rejection did not reach 3 generations '
                             'and a training: %s' % stats)
    # every launch of the run is a flow-rejection one: one a generation
    if stats['mcmc_generations'] != 0:
        raise AssertionError('the ladder reached mcmc; its launches would '
                             'count as rejection_flow ones: %s' % stats)
    # one a generation run, the served and those left in the buffer
    run = sum(c['generations'] for c in calls)
    if launches != run or run != (stats['rejection_flow_generations']
                                  + stats['generations_discarded']):
        raise AssertionError('%d launches for %d rejection_flow generations '
                             'run: %s' % (launches, run, stats))
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
            **stats, 'dispatches': calls,
            'median_generation_ms': per_generation_ms(calls),
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
    d = 16
    sampler = NestedSampler(d, Gaussian(d, 0.0), transform=lambda x: 5.0 * x,
                            log_dir=os.path.join(log_dir, 'slice'), seed=4,
                            device='cuda')
    gens, undo = time_dispatches(sampler, ('_slice_sample_live',
                                           '_slice_generations_batch'))
    reset_counts()
    t0 = time.time()
    # prior rejection until the expected volume falls below e^-4 (it =
    # 4000), then slice; the training comes with the switch
    sampler.run(strategy=['rejection_prior', 'slice'], max_iters=5000,
                train_iters=30, volume_switch=math.exp(-4.0))
    wall = time.time() - t0
    launches = read_counts('slice', pool_launched=True)
    undo()
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
            'logz_so_far': sampler.logz, **stats, 'dispatches': gens,
            'launches_per_generation': float(np.median(
                [g['launches'] / g['generations'] for g in gens])),
            'median_generation_ms': per_generation_ms(gens),
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


def phase_other_flows(log_dir, record):
    """NVP, Cholesky and fast-slow spline runs to their analytic evidence,
    each with the counts reset just before and read just after: the NVP
    flow's chains run through the NVP kernel (``ops.nvp_inverse``), so it
    launches and the spline kernel does not; the Cholesky inverse is plain
    PyTorch, so neither kernel runs; the fast-slow spline flow's chains run
    through the spline kernel (``ops.spline_inverse.fast_slow_inverse``), so
    it launches. No twin ever runs."""
    from nnest_torch.ops import fused_spline
    from nnest_torch.ops import nvp_inverse as nv
    from nnest_torch.ops import spline_inverse as si
    runs = []
    for flow, d, kw in (('nvp', 2, {}), ('cholesky', 2, {}),
                        ('spline', 4, {'num_slow': 2})):
        reset_counts()
        out = evidence_run(flow, log_dir, d, dict(flow=flow, **kw),
                           ['rejection_prior', 'mcmc'])
        torch.cuda.synchronize()
        out.update({'launches': si.launches, 'nvp_launches': nv.launches,
                    'twin_calls': fused_spline.calls + nv.calls})
        if ((si.launches > 0) != bool(kw)
                or (nv.launches > 0) != (flow == 'nvp')
                or fused_spline.calls + nv.calls != 0):
            raise AssertionError('flow %r: spline kernel launches %d (want '
                                 '%s), NVP kernel launches %d (want %s), '
                                 'twin calls %d (want 0): %s' % (
                                     flow, si.launches,
                                     '> 0' if kw else '0', nv.launches,
                                     '> 0' if flow == 'nvp' else '0',
                                     fused_spline.calls + nv.calls, out))
        if flow == 'nvp':
            record['launches_by_path']['other_flows'] = nv.launches
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


def correlated_training(d, corr):
    """1000 exact draws of the d-D Gaussian with pairwise correlation
    ``corr``, the posterior samplers' training set (rejection from the box
    is hopeless at 16-D)."""
    cov = np.eye(d) + corr * (1.0 - np.eye(d))
    return np.random.default_rng(10).multivariate_normal(np.zeros(d), cov,
                                                         size=1000)


# chains a phase leaves for phase 16's runtime checks: (samples (chains,
# steps, d), loglikes (chains, steps)) by name
CHAINS = {}


def reset_runtime_counts():
    """Set the native runtime's counts to 0 (before a path that uses
    it)."""
    from nnest_torch import runtime
    runtime.native_calls = runtime.fallbacks = 0


def read_runtime_counts():
    """The native runtime's calls and fallbacks since
    :func:`reset_runtime_counts`, checked: native calls, no fallback."""
    from nnest_torch import runtime
    out = {'native_calls': runtime.native_calls,
           'fallbacks': runtime.fallbacks}
    if out['native_calls'] <= 0 or out['fallbacks'] != 0:
        raise AssertionError('the native runtime was not what ran: %s'
                             % out)
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
    training = correlated_training(d, corr)
    reset_runtime_counts()

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
    runtime_counts = read_runtime_counts()
    CHAINS['mcmc_sampler'] = (mcmc.samples[:, :, :d], mcmc.loglikes)

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
            'runtime': runtime_counts,
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
    reset_runtime_counts()

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
        if sampler == 'ensemble':
            CHAINS['cli_ensemble'] = (e.samples, e.loglikes)
    record['launches_by_path']['cli'] = sum(launches.values())
    out['launches'] = launches
    out['runtime'] = read_runtime_counts()
    return out


# ------------------------------------------------------------- phase 14

def free_port():
    import socket
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as sock:
        sock.bind(('127.0.0.1', 0))
        return sock.getsockname()[1]


def run_ranks(world, argv, timeout):
    """This script as ``world`` rank processes on the card (``--mesh-part``
    and ``argv``), the rank variables set as ``torchrun`` sets them; every
    rank's ``RESULT`` JSON in rank order. A rank that fails or outlasts
    ``timeout`` raises, with every rank's tail; no rank outlives the
    call."""
    port = free_port()
    root = os.path.dirname(os.path.abspath(__file__))
    procs = []
    try:
        for rank in range(world):
            env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world),
                       LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                       MASTER_ADDR='localhost', MASTER_PORT=str(port))
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), *argv],
                cwd=root, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        raise AssertionError('rank(s) %s of %s failed:\n%s' % (
            bad, argv, '\n'.join('--- rank %d ---\n%s' % (
                r, '\n'.join(o.splitlines()[-30:]))
                for r, o in enumerate(outs))))
    results = []
    for r, out in enumerate(outs):
        lines = [ln for ln in out.splitlines() if ln.startswith('RESULT ')]
        if not lines:
            raise AssertionError('rank %d of %s printed no RESULT:\n%s'
                                 % (r, argv, out[-3000:]))
        results.append(json.loads(lines[-1][len('RESULT '):]))
    return results


def count_collectives():
    """Count this process's collectives: every call of the three
    ``torch.distributed`` functions ``nnest_torch.parallel.mesh`` uses."""
    import torch.distributed as dist
    counts = {'collectives': 0}
    for name in ('all_gather', 'all_gather_into_tensor',
                 'broadcast_object_list'):
        real = getattr(dist, name)

        def counted(*a, _real=real, **k):
            counts['collectives'] += 1
            return _real(*a, **k)

        setattr(dist, name, counted)
    return counts


def mesh_main_path(mesh, log_dir, counts):
    """Part (a) on one rank: the phase-3 model on the mesh, then one
    dp-sharded Metropolis generation (``mcmc_generation``, phase 3's) timed
    with its collectives, the cost of one collective of a 0-d tensor on
    the card, and one training epoch dp-sharded graphed against eager from
    the same state."""
    from nnest_torch.parallel import all_reduce_sum
    sampler = main_path_sampler(log_dir, 'mesh_main', mesh=mesh)
    reset_counts()
    counts['collectives'] = 0
    t0 = time.time()
    sampler.run(max_iters=5200, train_iters=MESH_TRAIN_ITERS)
    wall = time.time() - t0
    launches = read_counts('mesh')
    stats = sampler.run_stats
    if stats['mcmc_generations'] < 3 or stats['trainings'] < 1:
        raise AssertionError('the mesh path did not reach 3 MCMC '
                             'generations and a training: %s' % stats)
    out = {'wall_s': wall, 'launches': launches, 'twin_calls': 0,
           'logz': sampler.logz, 'ncall': sampler.total_calls,
           'niter': sampler.niter, 'run_collectives': counts['collectives'],
           'train_ms_per_epoch': 1e3 * stats['train_s']
           / max(sampler.trainer.total_iters, 1), **stats}

    generation = mcmc_generation(sampler)
    for _ in range(2):   # the second call is the reading
        counts['collectives'] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        generation()
        gen_ms = (time.perf_counter() - t0) * 1e3
    out.update(generation_ms=gen_ms, generation_steps=80,
               generation_collectives=counts['collectives'])

    one = torch.zeros((), dtype=torch.int64, device='cuda')
    times = []
    for _ in range(200):
        t0 = time.perf_counter()
        int(all_reduce_sum(one, mesh))
        times.append((time.perf_counter() - t0) * 1e6)
    out['sync_us_median'] = float(np.median(times))

    trainer = sampler.trainer
    u = synthetic_shell(sampler)[0]
    data = torch.as_tensor(u.astype(np.float32), device='cuda')
    valid, train = data[:100], data[100:]
    order = torch.arange(train.shape[0], device='cuda')
    g = torch.Generator(device='cuda').manual_seed(9)
    noise = torch.randn((9, 100, 16), generator=g, device='cuda')
    snap = trainer.snapshot_state()
    params, epoch_ms = {}, {}
    for graphed in (True, False, True, False):
        trainer.restore_state(snap)
        trainer._use_graphs = graphed
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer._train_epoch(train, valid, order, noise, 0.01, 0.0, True,
                             True)
        torch.cuda.synchronize()
        epoch_ms.setdefault(graphed, []).append(
            (time.perf_counter() - t0) * 1e3)
        params[graphed] = [p.detach().clone()
                           for p in trainer.model.parameters()]
    trainer.restore_state(snap)
    trainer._use_graphs = True
    diff = max(float((a - b).abs().max())
               for a, b in zip(params[True], params[False]))
    out.update(dp_epoch_graphed_ms=epoch_ms[True],
               dp_epoch_eager_ms=epoch_ms[False],
               dp_epoch_graphed_vs_eager_max_abs=diff)
    if diff > 1e-5:
        raise AssertionError('graphed and eager dp epochs differ by %g'
                             % diff)
    return out


def mesh_2d(mesh, log_dir, name, like, seed, **run_kw):
    """A 2-D Gaussian nested run on the mesh (parts b and d)."""
    from nnest_torch import NestedSampler
    sampler = NestedSampler(2, like, transform=lambda x: 3.0 * x,
                            num_live_points=MESH_2D_LIVE,
                            log_dir=os.path.join(log_dir, name), seed=seed,
                            append_run_num=False, resume=True, mesh=mesh,
                            device='cuda')
    reset_counts()
    t0 = time.time()
    sampler.run(train_iters=MESH_2D_TRAIN_ITERS, dlogz=0.1,
                volume_switch=MESH_2D_SWITCH, **run_kw)
    wall = time.time() - t0
    return {'wall_s': wall, 'logz': sampler.logz, 'logzerr': sampler.logzerr,
            'ncall': sampler.total_calls, 'niter': sampler.niter,
            'has_logs': sampler.logs is not None,
            'mcmc_generations': sampler.run_stats['mcmc_generations'],
            'launches': read_counts('mesh ' + name)}


def mesh_rank_main(args):
    """One rank of a phase-14 part, run by :func:`run_ranks`: joins the
    process group the rank variables name and prints its ``RESULT``."""
    from nnest_torch.likelihoods import Gaussian
    from nnest_torch.parallel import get_mesh, initialize_distributed
    import torch.distributed as dist
    backend = initialize_distributed(device='cuda')
    mesh = get_mesh()
    counts = count_collectives()
    out = {'rank': mesh.rank, 'backend': backend, 'device': str(mesh.device)}
    part, log_dir = args.mesh_part, args.mesh_dir
    if part == 'a':
        out.update(mesh_main_path(mesh, log_dir, counts))
    elif part == 'b':
        out['torch'] = mesh_2d(mesh, log_dir, 'b_torch',
                               Gaussian(2, 0.0, lim=3), 42)
        like = NumpyOnlyGaussian(2)
        out['numpy'] = mesh_2d(mesh, log_dir, 'b_numpy', like, 42)
        out['numpy']['likelihood_rows'] = like.calls
    else:   # 'd1': cut at MESH_CUT_ITERS; 'd2': resumed with another seed
        out.update(mesh_2d(mesh, log_dir, 'd', Gaussian(2, 0.0, lim=3),
                           5 if part == 'd1' else 6,
                           **({'max_iters': MESH_CUT_ITERS}
                              if part == 'd1' else {})))
    print('RESULT ' + json.dumps(out), flush=True)
    dist.destroy_process_group()
    return 0


def phase_mesh(record, log_dir, main_path):
    """Phase 14: multi-process data parallelism on the one card."""
    from nnest_torch.likelihoods import Gaussian
    analytic = Gaussian(2, 0.0, lim=3).analytic_logz([-3.0, -3.0],
                                                     [3.0, 3.0])
    out, launches = {}, 0

    def lockstep(results, name, keys=('logz', 'ncall', 'niter')):
        for k in keys:
            if len({r[k] for r in results}) != 1:
                raise AssertionError('%s: ranks disagree on %s: %s'
                                     % (name, k, results))

    def evidence(res, name):
        if not (res['mcmc_generations'] > 0 and abs(res['logz'] - analytic)
                <= max(3.0 * res['logzerr'], 0.15)):
            raise AssertionError('%s off the analytic logz %.4f: %s'
                                 % (name, analytic, res))

    # (a) the phase-3 model, 2 ranks on the card over gloo
    t0 = time.time()
    ranks = run_ranks(MESH_RANKS, ['--mesh-part', 'a', '--mesh-dir',
                                   log_dir], timeout=400)
    lockstep(ranks, 'part a')
    if {r['backend'] for r in ranks} != {'gloo'}:
        raise AssertionError('two ranks on one card took %s'
                             % [r['backend'] for r in ranks])
    launches += sum(r['launches'] for r in ranks)
    out['a'] = {'seconds': time.time() - t0, 'ranks': ranks,
                'phase_3_wall_s': main_path['wall_s'],
                'phase_3_train_ms_per_epoch': 1e3 * main_path['train_s']
                / max(main_path['training_epochs'], 1),
                'phase_3_generation_ms':
                    main_path['generation_profile']['wall_ms']}
    r0 = ranks[0]
    # two collectives a generation (the gathered chains, the counters), the
    # rest one a step; each a host sync under gloo
    out['a']['per_step_syncs'] = ((r0['generation_collectives'] - 2)
                                  / r0['generation_steps'])
    print('phase 14 (a): backend %s, per-step syncs %g (%d collectives in a '
          'generation of %d steps), a sync %.1f us' % (
              r0['backend'], out['a']['per_step_syncs'],
              r0['generation_collectives'], r0['generation_steps'],
              r0['sync_us_median']), flush=True)

    # (b) the 2-D Gaussian to its analytic logz: a torch likelihood, then a
    # numpy-only one farmed over the ranks
    t0 = time.time()
    ranks = run_ranks(MESH_RANKS, ['--mesh-part', 'b', '--mesh-dir',
                                   log_dir], timeout=400)
    for kind in ('torch', 'numpy'):
        runs = [r[kind] for r in ranks]
        lockstep(runs, 'part b (%s)' % kind)
        evidence(runs[0], 'part b (%s)' % kind)
        if [r['has_logs'] for r in runs] != [True, False]:
            raise AssertionError('rank 0 alone should write: %s' % runs)
        launches += sum(r['launches'] for r in runs)
    out['b'] = {'seconds': time.time() - t0, 'ranks': ranks,
                'backend': ranks[0]['backend']}

    # (c) the command line as one NCCL rank, at 5-D so that the run reaches
    # the sharded Metropolis generations and a training
    t0 = time.time()
    env = dict(os.environ, RANK='0', WORLD_SIZE='1', LOCAL_RANK='0',
               LOCAL_WORLD_SIZE='1', MASTER_ADDR='localhost',
               MASTER_PORT=str(free_port()))
    run_dir = os.path.join(log_dir, 'multihost')
    proc = subprocess.run(
        [sys.executable, '-m', 'nnest_torch.cli.multihost', '--x_dim',
         str(MESH_CLI_DIM), '--num_live_points', str(MESH_2D_LIVE),
         '--mcmc_num_chains', '16', '--log_dir', run_dir],
        cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
        capture_output=True, text=True, timeout=400)
    text = proc.stdout + proc.stderr
    m = re.search(r'logz (\S+) \+- (\S+) \(ncall (\d+)\)', text)
    if proc.returncode != 0 or 'backend nccl' not in text or m is None:
        raise AssertionError('the multihost command line as one NCCL rank '
                             '(rc %d):\n%s' % (proc.returncode, text[-3000:]))
    logz, logzerr = float(m.group(1)), float(m.group(2))
    with open(os.path.join(run_dir, 'run1', 'results',
                           'diagnostics.json')) as f:
        mcmc_generations = json.load(f)['n_mix_windows']
    analytic_c = Gaussian(MESH_CLI_DIM, 0.0, lim=3).analytic_logz(
        [-3.0] * MESH_CLI_DIM, [3.0] * MESH_CLI_DIM)
    out['c'] = {'seconds': time.time() - t0, 'backend': 'nccl',
                'logz': logz, 'logzerr': logzerr, 'ncall': int(m.group(3)),
                'analytic_logz': analytic_c,
                'mcmc_generations': mcmc_generations}
    if mcmc_generations < 1 or \
            abs(logz - analytic_c) > max(3.0 * logzerr, 0.15):
        raise AssertionError('the multihost command line: %s' % out['c'])

    # (d) a 2-rank run cut, then resumed by fresh ranks with another seed
    t0 = time.time()
    first = run_ranks(MESH_RANKS, ['--mesh-part', 'd1', '--mesh-dir',
                                   log_dir], timeout=300)
    second = run_ranks(MESH_RANKS, ['--mesh-part', 'd2', '--mesh-dir',
                                    log_dir], timeout=300)
    lockstep(first, 'part d (cut)')
    lockstep(second, 'part d (resumed)')
    evidence(second[0], 'part d (resumed)')
    if not (first[0]['niter'] <= MESH_CUT_ITERS + 2
            and second[0]['ncall'] > first[0]['ncall']
            and second[0]['niter'] > MESH_CUT_ITERS + 1):
        raise AssertionError('resume did not continue: %s then %s'
                             % (first, second))
    launches += sum(r['launches'] for r in first + second)
    out['d'] = {'seconds': time.time() - t0, 'cut': first,
                'resumed': second, 'backend': first[0]['backend']}
    print('phase 14 backends: a %s, b %s, c %s, d %s' % tuple(
        out[k]['backend'] if 'backend' in out[k]
        else out[k]['ranks'][0]['backend'] for k in 'abcd'), flush=True)
    record['launches_by_path']['mesh'] = launches
    return out


# ------------------------------------------------------------- phase 15

def count_syncs(fn):
    """``fn()`` under ``torch.cuda.set_sync_debug_mode('warn')``: the host
    syncs it made (the warnings of synchronizing calls; an explicit
    ``torch.cuda.synchronize`` would not count, and the port makes none)."""
    import warnings
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode('warn')
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter('always')
            fn()
    finally:
        torch.cuda.set_sync_debug_mode('default')
    torch.cuda.synchronize()
    return sum('synchroniz' in str(w.message) for w in caught)


def prefetch_turns(sampler, batch=8, trials=4096, rounds=3):
    """One generation a dispatch against ``batch`` a dispatch on the
    phase-3 model's trained flow, in ``rounds`` of turns (1, batch, batch,
    1), from a
    synthetic shell: a Metropolis generation (256 chains x 80 steps, as
    the run) and a prior-rejection generation at ``trials`` trials (the
    ladder off, so a batch runs ``batch``). Each side does the host work
    that serves its generations (the endpoint statistics, the compaction).
    For each: the wall a generation (median of the turns), the host syncs
    a generation (:func:`count_syncs`) and a profiled call's device busy
    share and launches (:func:`profile_generation`); for Metropolis also
    a speculating batch (no stop flag read; the generator's state read
    before each generation) with its wall and syncs."""
    u, logl, derived = synthetic_shell(sampler)
    lstar = float(np.min(logl))
    step = 1.0 / sampler.x_dim ** 0.5

    def mcmc(n, speculate=False):
        if n == 1:
            sampler._mcmc_sample_live(80, u, logl, 256, lstar, step,
                                      dynamic_step_size=True, adapt_cov=True,
                                      active_derived=derived)
            return 1
        gens = sampler._mcmc_generations_batch(
            80, u, logl, derived, 256, step, 0, 10 ** 9, n,
            dynamic_step_size=True, speculate=speculate, adapt_cov=True)
        for out, _, _, _ in gens:
            sampler._consume_endpoint_out(out)
        return len(gens)

    def prior(n):
        if n == 1:
            sampler._rejection_prior_sample(lstar, num_trials=trials)
            return 1
        gens = sampler._rejection_prior_generations_batch(
            u, logl, derived, 0, 2 ** 30, [], np.float32(1e30), 125, trials,
            n, False, False, False)
        for out, g_lstar, g_it, _ in gens:
            sampler._compact_rejection_gen(
                out['x'], out['logl'], np.zeros((trials, 0)), out['ok'],
                None, None, None, g_lstar, g_it, trials)
        return len(gens)

    out = {}
    for name, fn in (('metropolis', mcmc), ('prior_rejection', prior)):
        walls = {1: [], batch: []}
        gens = {}
        for n in (1, batch, batch, 1) * rounds:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            gens[n] = fn(n)
            torch.cuda.synchronize()
            walls[n].append((time.perf_counter() - t0) * 1e3 / gens[n])
        res = {}
        for n in (1, batch):
            holder = {}
            syncs = count_syncs(lambda: holder.update(g=fn(n)))
            prof = profile_generation(
                lambda: (fn(n), torch.cuda.synchronize()))
            res['batch_%d' % n] = {
                'generations_a_dispatch': gens[n],
                'generation_ms': walls[n],
                'median_generation_ms': float(np.median(walls[n])),
                'syncs_a_generation': syncs / holder['g'],
                'device_busy_share': prof['device_busy_share'],
                'device_busy_ms_a_generation': (
                    prof['device_busy_ms'] / gens[n]
                    if isinstance(prof['device_busy_ms'], float)
                    else 'not measured'),
                'kernel_launches_a_generation': (prof['kernel_launches']
                                                 / gens[n]),
                'spline_launches_a_generation': (
                    prof['spline_inverse_launches'] / gens[n])}
        out[name] = res
    holder = {}
    syncs = count_syncs(lambda: holder.update(g=mcmc(batch, True)))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gens = mcmc(batch, True)
    torch.cuda.synchronize()
    out['metropolis']['batch_%d_speculating' % batch] = {
        'generations_a_dispatch': gens,
        'generation_ms': (time.perf_counter() - t0) * 1e3 / gens,
        'syncs_a_generation': syncs / holder['g']}
    return out


def prefetch_2d(log_dir, name, batch, log=False, seed=7, **run_kw):
    """The 2-D Gaussian (100 live points, 10 chains x 20 steps, a volume
    switch at 0.5, 50 training epochs: the CPU tests' configuration at
    nnest_tpu's size) at ``batch`` generations a dispatch, its counts
    reset before and read after. Returns (final numbers, run_stats, spline
    launches)."""
    from nnest_torch import NestedSampler, Trainer
    from nnest_torch.likelihoods import Gaussian
    kw = {}
    if log:
        # a trainer without files: the checkpoints are the sampler's
        kw = dict(log_dir=os.path.join(log_dir, 'prefetch_' + name),
                  append_run_num=False,
                  resume=True, trainer=Trainer(2, hidden_dim=16, seed=8,
                                               device='cuda', log_level=30))
    s = NestedSampler(2, Gaussian(2, 0.0, lim=3), transform=lambda x: 3.0 * x,
                      num_live_points=100, seed=seed, device='cuda',
                      log_level=30, **dict(dict(log_dir=None), **kw))
    reset_counts()
    s.run(**dict(dict(train_iters=50, dlogz=0.5, volume_switch=0.5,
                      mcmc_num_chains=10, mcmc_steps=20,
                      mcmc_gen_batch=batch, rejection_gen_batch=batch),
                 **run_kw))
    launches = read_counts('prefetch ' + name)
    final = [float(s.logz), float(s.logzerr), float(s.h),
             int(s.total_calls), int(s.niter)]
    return final, dict(s.run_stats), launches, s


def phase_prefetch(record, log_dir, main):
    """Multi-generation prefetch on the card (module docstring, phase
    15)."""
    from nnest_torch.samplers.nested import EXACT_STATE
    out, launches = {}, 0
    # (a) the phase-3 model at one generation a dispatch beside phase 3's
    # run at the default 8
    sampler = main_path_sampler(log_dir, 'prefetch_b1', tooling='off')
    reset_counts()
    t0 = time.time()
    sampler.run(max_iters=5200, train_iters=100, mcmc_gen_batch=1,
                rejection_gen_batch=1)
    wall = time.time() - t0
    b1_launches = read_counts('prefetch phase-3')
    b1 = [sampler.logz, sampler.h, sampler.total_calls, sampler.niter]
    b8 = [main['logz_so_far'], main['h'], main['ncall'], main['iterations']]
    keys = ('mcmc_generations', 'mcmc_dispatches', 'rejection_generations',
            'rejection_dispatches', 'generations_discarded',
            'speculation_losses', 'mcmc_s', 'rejection_s')
    out['phase3'] = {
        'batch_1': {'final': b1, 'wall_s': wall,
                    'spline_launches': b1_launches,
                    **{k: sampler.run_stats[k] for k in keys}},
        'batch_8': {'final': b8, 'wall_s': main['wall_s'],
                    'spline_launches': main['launches'],
                    'pool_launches': main['pool_launches'],
                    **{k: main[k] for k in keys}},
        'equal': b1 == b8}
    if b1 != b8:
        raise AssertionError('phase-3 model at batch 1 differs from phase 3 '
                             'at 8: %s' % out['phase3'])
    out['turns'] = prefetch_turns(sampler)

    # (b) 2-D pairs: speculation won and lost, slice, flow rejection
    pairs = {
        'speculation_won': dict(retrain_nll_threshold=1e9),
        'speculation_lost': dict(retrain_nll_threshold=-1e9),
        'slice': dict(strategy=['rejection_prior', 'slice'], slice_steps=8),
        'flow': dict(strategy=['rejection_prior', 'rejection_flow', 'mcmc'],
                     rejection_batch_size=64),
    }
    for name, kw in pairs.items():
        spec = dict(mcmc_speculate=True) if 'speculation' in name else {}
        one, st1, l1, _ = prefetch_2d(log_dir, name + '_1', 1, **kw)
        eight, st8, l8, _ = prefetch_2d(log_dir, name + '_8', 8, **kw, **spec)
        launches += l1 + l8
        out[name] = {'batch_1': one, 'batch_8': eight, 'equal': one == eight,
                     'spline_launches': [l1, l8],
                     'stats_1': {k: v for k, v in st1.items() if v},
                     'stats_8': {k: v for k, v in st8.items() if v}}
        if one != eight:
            raise AssertionError('2-D %s: batch 1 %s, batch 8 %s'
                                 % (name, one, eight))
    if not out['speculation_lost']['stats_8'].get('speculation_losses'):
        raise AssertionError('no speculation was lost: %s'
                             % out['speculation_lost'])
    if out['speculation_won']['stats_8'].get('speculation_losses'):
        raise AssertionError('a winning speculation lost generations: %s'
                             % out['speculation_won'])

    # (c) killed inside a Metropolis buffer and resumed with another seed
    kw = dict(log_interval=20, mcmc_speculate=True, rejection_batch_size=32)
    whole, _, l0, _ = prefetch_2d(log_dir, 'whole', 8, log=True, **kw)
    launches += l0
    cut = None
    for stop in (150, 170, 190, 210, 230):
        _, _, l_cut, s = prefetch_2d(log_dir, 'cut_%d' % stop, 8, log=True,
                                     max_iters=stop, **kw)
        launches += l_cut
        s._drain_io()
        es = torch.load(os.path.join(s.log_dir, 'checkpoint', EXACT_STATE),
                        weights_only=True)
        if es['pool']['mcmc_buf']:
            cut = {'max_iters': stop, 'checkpoint_it': es['it'],
                   'buffered': len(es['pool']['mcmc_buf'])}
            break
    if cut is None:
        raise AssertionError('no cut landed inside a Metropolis buffer')
    resumed, _, l_res, _ = prefetch_2d(log_dir, 'cut_%d' % cut['max_iters'],
                                       8, log=True, seed=99, **kw)
    launches += l_res
    cut.update({'whole': whole, 'resumed': resumed,
                'equal': whole == resumed})
    out['resume'] = cut
    if not cut['equal']:
        raise AssertionError('resume inside a buffer differs: %s' % cut)
    record['launches_by_path']['prefetch'] = launches + b1_launches
    return out


# ------------------------------------------------------------- phase 16

# part (a): phase 10's 16-D model at the tensor-parallel width on 2 ranks
# sharing the card (dp 1, tp 2): chains, steps and training epochs
TP_RANKS, TP_CHAINS, TP_STEPS, TP_EPOCHS = 2, 16, 500, 10


def tp_epoch_turns(trainer, data, counts):
    """One training epoch of the tp trainer (eager, tp-sharded) beside one
    of a one-rank trainer (no mesh; its steps a CUDA graph, captured by a
    warm-up epoch) from the same whole weights with a fresh Adam, on the
    same rows, order and noise, in turns (tp, one, one, tp): their ms, the
    collectives of a tp epoch and of its validation forward, and the two
    epochs' losses and flows after them (reported: nine Adam steps amplify
    the rounding of the two layouts' products). Then the epoch's first
    step on both from the same weights, before Adam: the NLL of its
    jittered batch (its relative difference) and the gradients (the worst
    excess of |a - b| over 1e-5 + 1e-4 |b|, tests/test_tp_sharding.py's
    tolerance)."""
    from nnest_torch import Trainer
    from nnest_torch.flows import params_to_jax
    d = trainer.x_dim
    tree = params_to_jax(trainer.model)   # whole: a collective over tp
    tp_state = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    one = Trainer(d, hidden_dim=TP_HIDDEN, log=False, seed=0, device='cuda',
                  learning_rate=trainer.learning_rate,
                  weight_decay=trainer.weight_decay)
    one.load_params(tree)
    one_state = {k: v.clone() for k, v in one.model.state_dict().items()}
    x = torch.as_tensor(data.astype(np.float32), device='cuda')
    valid, train = x[:100], x[100:]
    order = torch.arange(train.shape[0], device='cuda')
    g = torch.Generator(device='cuda').manual_seed(9)
    noise = torch.randn((-(-train.shape[0] // 100), 100, d), generator=g,
                        device='cuda')

    def epoch(which):
        if which == 'tp':
            trainer.model.load_state_dict(tp_state)
            trainer._new_optimizer()
        else:   # in place: the captured graph holds these tensors
            one.model.load_state_dict(one_state)
            for state in one.optimizer.state.values():
                for v in state.values():
                    v.zero_()
        t, shard = (trainer, True) if which == 'tp' else (one, False)
        counts['collectives'] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = t._train_epoch(train, valid, order, noise, 0.01, 0.0,
                                shard, shard)
        torch.cuda.synchronize()
        return ((time.perf_counter() - t0) * 1e3, counts['collectives'],
                (float(losses[0]), losses[1]))

    epoch('one')   # the graph's capture
    ms, losses = {'tp': [], 'one': []}, {}
    for which in ('tp', 'one', 'one', 'tp'):
        t, n, losses[which] = epoch(which)
        ms[which].append(t)
        if which == 'tp':
            epoch_collectives = n
    counts['collectives'] = 0
    with torch.no_grad():
        trainer._validation_loss(valid, True)
    val_collectives = counts['collectives']
    got = params_to_jax(trainer.model)
    want = params_to_jax(one.model)
    dparam = max(float(np.max(np.abs(a - b))) for a, b in zip(
        _leaves(got), _leaves(want)))

    batch = train[order[:noise.shape[1]]] + 0.01 * noise[0]

    def nll_grads(model, state):
        model.load_state_dict(state)
        model.zero_grad(set_to_none=True)
        with torch.enable_grad():
            loss = -torch.mean(model.log_prob(batch))
            loss.backward()
        grads = []
        for p in model.parameters():
            shard = getattr(p, 'tp_shard', None)
            grads.append(p.grad if shard is None else shard.gather(p.grad))
        return float(loss), grads

    (l_tp, g_tp), (l_one, g_one) = (nll_grads(trainer.model, tp_state),
                                    nll_grads(one.model, one_state))
    grad_excess = max(float(torch.max(
        (a - b).abs() - (1e-5 + 1e-4 * b.abs()))) for a, b in zip(g_tp, g_one))
    return {'first_step_nll': [l_tp, l_one],
            'first_step_nll_rel_diff': abs(l_tp - l_one) / abs(l_one),
            'first_step_grad_excess': grad_excess,
            'tp_epoch_ms': ms['tp'], 'one_rank_graphed_epoch_ms': ms['one'],
            'steps_a_epoch': int(noise.shape[0]),
            'tp_epoch_collectives': epoch_collectives,
            'tp_validation_collectives': val_collectives,
            'collectives_a_tp_step': (epoch_collectives - val_collectives)
            / int(noise.shape[0]),
            'tp_losses': losses['tp'], 'one_rank_losses': losses['one'],
            'max_abs_dparam_after_epoch': dparam}


def _leaves(tree):
    if isinstance(tree, dict):
        tree = [tree[k] for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in _leaves(v)]
    return [np.asarray(tree)]


def tp_rank_main(args):
    """One rank of phase 16 (a), run by :func:`run_ranks`: ``MCMCSampler``
    on phase 10's model at hidden 256 on a (dp 1, tp 2) mesh, its counts
    reset just before and read just after; its collectives in training and
    in sampling; one all-gather of a layer's activations timed; then
    :func:`tp_epoch_turns`."""
    import hashlib
    from nnest_torch import MCMCSampler
    from nnest_torch.likelihoods import Gaussian
    from nnest_torch.parallel import get_mesh, initialize_distributed
    from nnest_torch.priors import UniformPrior
    import torch.distributed as dist
    backend = initialize_distributed(device='cuda')
    mesh = get_mesh(dp=1, tp=TP_RANKS)
    counts = count_collectives()
    d, corr = 16, 0.9
    training = correlated_training(d, corr)
    s = MCMCSampler(d, Gaussian(d, corr), prior=UniformPrior(d, -5.0, 5.0),
                    hidden_dim=TP_HIDDEN,
                    log_dir=os.path.join(args.mesh_dir, 'tp'), seed=10,
                    mesh=mesh, device='cuda')
    parts = {}
    for obj, name in ((s.trainer, 'train'), (s, '_mcmc_sample')):
        real = getattr(obj, name)

        def counted(*a, _real=real, _name=name, **k):
            counts['collectives'] = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = _real(*a, **k)
            torch.cuda.synchronize()
            parts[_name] = {'s': time.perf_counter() - t0,
                            'collectives': counts['collectives']}
            return out

        setattr(obj, name, counted)
    reset_counts()
    t0 = time.time()
    s.run(TP_STEPS, TP_CHAINS, training, train_iters=TP_EPOCHS)
    wall = time.time() - t0
    launches = read_counts('tp')
    if launches != TP_STEPS + 1:
        raise AssertionError('the tp run launched the kernel %d times, '
                             'expected %d (one a step, one a call)'
                             % (launches, TP_STEPS + 1))
    samples = np.ascontiguousarray(s.samples)
    moments = ess_bounded_moments(samples[:, TP_STEPS // 10:], corr,
                                  'MCMCSampler at tp = 2')
    sharded = [t for t in s.trainer.model.parameters()
               if getattr(t, 'tp_shard', None) is not None]
    shard = sharded[0].tp_shard
    act = torch.randn(TP_CHAINS, TP_HIDDEN // TP_RANKS, device='cuda')
    times = []
    for _ in range(200):
        t1 = time.perf_counter()
        shard.gather(act).sum().item()
        times.append((time.perf_counter() - t1) * 1e6)
    data = (training - training.mean(axis=0)) / training.std(axis=0)
    out = {'rank': mesh.rank, 'dp_rank': mesh.dp_rank,
           'tp_rank': mesh.tp_rank, 'backend': backend, 'wall_s': wall,
           'launches': launches, 'twin_calls': 0,
           'samples_shape': list(samples.shape),
           'samples_sha256': hashlib.sha256(samples.tobytes()).hexdigest(),
           'sharded_tensors': len(sharded),
           'train_s': parts['train']['s'],
           'train_collectives': parts['train']['collectives'],
           'train_epochs': s.trainer.total_iters,
           'sample_s': parts['_mcmc_sample']['s'],
           'sample_collectives': parts['_mcmc_sample']['collectives'],
           'sample_collectives_a_step': parts['_mcmc_sample']['collectives']
           / TP_STEPS, 'gather_us_median': float(np.median(times)),
           'scale': s.scale, 'moments': moments,
           'epoch': tp_epoch_turns(s.trainer, data, counts)}
    print('RESULT ' + json.dumps(out), flush=True)
    dist.destroy_process_group()
    return 0


def timed_turns(fns):
    """``fns`` (a dict of two names to calls) in turns a, b, b, a: each
    call's seconds by name, and each call's result by name (the last)."""
    (a, fa), (b, fb) = fns.items()
    secs, results = {a: [], b: []}, {}
    for name, fn in ((a, fa), (b, fb), (b, fb), (a, fa)):
        t0 = time.perf_counter()
        results[name] = fn()
        secs[name].append(time.perf_counter() - t0)
    return secs, results


def runtime_turns():
    """Part (b): the native runtime against its numpy twins on phase 10's
    MCMC chains and phase 13's ensemble chains (the ESS, acceptance and
    jump, within 1e-12 relative; native, numpy, numpy, native), and the
    ensemble's chain files, one a walker, written natively and by
    ``np.savetxt`` (byte-equal; in turns)."""
    from nnest_torch import runtime
    from nnest_torch.utils import evaluation as ev
    runtime.load_library()   # built at its first use, by phase 3
    out = {'build_log': runtime.build_log}
    print('phase 16 (b): %s' % runtime.build_log.splitlines()[0],
          flush=True)

    def native(x, mu, var):
        return (ev.effective_sample_size(x, mu, var), ev.acceptance_rate(x),
                ev.mean_jump_distance(x))

    def numpy_twin(x, mu, var):
        return (ev.effective_sample_size_numpy(x, mu, var),
                ev.acceptance_rate_numpy(x), ev.mean_jump_distance_numpy(x))

    for name, (x, _) in CHAINS.items():
        x = np.asarray(x, dtype=np.float64)
        flat = x.reshape(-1, x.shape[2])
        mu, var = flat.mean(axis=0), flat.var(axis=0)
        reset_runtime_counts()
        secs, res = timed_turns({'native': lambda: native(x, mu, var),
                                 'numpy': lambda: numpy_twin(x, mu, var)})
        (ess, acc, jump), (ess_np, acc_np, jump_np) = (res['native'],
                                                       res['numpy'])
        rel = {'ess': float(np.max(np.abs(ess - ess_np) / np.abs(ess_np))),
               'acceptance': abs(acc - acc_np) / abs(acc_np),
               'jump': abs(jump - jump_np) / abs(jump_np)}
        out[name] = {'shape': list(x.shape), 'native_s': secs['native'],
                     'numpy_s': secs['numpy'], 'max_rel_diff': rel,
                     'runtime': read_runtime_counts()}
        if max(rel.values()) > 1e-12:
            raise AssertionError('native diagnostics of %s differ from '
                                 'numpy: %s' % (name, rel))
    samples, loglikes = CHAINS['cli_ensemble']
    root = tempfile.mkdtemp(prefix='chain_files_')

    def write(kind):
        folder = os.path.join(root, kind)
        os.makedirs(folder, exist_ok=True)
        for i in range(samples.shape[0]):
            path = os.path.join(folder, 'chain_%d.txt' % (i + 1))
            w = np.ones(samples.shape[1])
            if kind == 'native':
                if not runtime.write_chain(path, w, loglikes[i], samples[i]):
                    raise AssertionError('no native chain writer')
            else:
                np.savetxt(path, np.hstack([
                    np.maximum(w, 1e-30)[:, None], -loglikes[i][:, None],
                    samples[i]]), fmt='%.5E', header='', comments='')
        return folder

    secs, folders = timed_turns({'native': lambda: write('native'),
                                 'numpy': lambda: write('numpy')})
    names = sorted(os.listdir(folders['native']))
    equal = all(open(os.path.join(folders['native'], f), 'rb').read()
                == open(os.path.join(folders['numpy'], f), 'rb').read()
                for f in names)
    out['chain_files'] = {'files': len(names), 'rows': int(samples.shape[1]),
                          'native_s': secs['native'],
                          'numpy_s': secs['numpy'], 'byte_equal': equal}
    if not equal or len(names) != samples.shape[0]:
        raise AssertionError('native chain files differ from np.savetxt\'s: '
                             '%s' % out['chain_files'])
    return out


def phase_tp_runtime(record, log_dir, outputs):
    """Phase 16: (a) tensor parallelism on the one card, (b) the native
    runtime against its numpy twins, and its counts on phases 10 and 13."""
    t0 = time.time()
    ranks = run_ranks(TP_RANKS, ['--mesh-part', 'tp', '--mesh-dir',
                                 log_dir], timeout=500)
    if len({r['samples_sha256'] for r in ranks}) != 1:
        raise AssertionError('tp ranks disagree on the samples: %s'
                             % [r['samples_sha256'] for r in ranks])
    if {r['backend'] for r in ranks} != {'gloo'} or \
            [r['tp_rank'] for r in ranks] != list(range(TP_RANKS)):
        raise AssertionError('tp ranks: %s' % [
            (r['backend'], r['tp_rank']) for r in ranks])
    record['launches_by_path']['tp'] = sum(r['launches'] for r in ranks)
    r0 = ranks[0]
    e = r0['epoch']
    print('phase 16 (a): %d sharded tensors a rank, wall %.1f s (train '
          '%.1f s, %d collectives; sampling %.1f s, %g collectives a step), '
          'an all-gather %.0f us, a tp epoch %s ms against a one-rank graphed '
          'epoch %s ms; first step NLL rel diff %.3g, gradient excess %.3g; '
          'after the epoch losses %s vs %s, max |dparam| %.3g' % (
              r0['sharded_tensors'], r0['wall_s'], r0['train_s'],
              r0['train_collectives'], r0['sample_s'],
              r0['sample_collectives_a_step'], r0['gather_us_median'],
              ['%.1f' % v for v in e['tp_epoch_ms']],
              ['%.1f' % v for v in e['one_rank_graphed_epoch_ms']],
              e['first_step_nll_rel_diff'], e['first_step_grad_excess'],
              e['tp_losses'], e['one_rank_losses'],
              e['max_abs_dparam_after_epoch']), flush=True)
    for r in ranks:
        e = r['epoch']
        if e['first_step_nll_rel_diff'] > 1e-5 or \
                e['first_step_grad_excess'] > 0:
            raise AssertionError('a tp step and a one-rank step differ: %s'
                                 % e)
    out = {'a': {'seconds': time.time() - t0, 'ranks': ranks}}
    t0 = time.time()
    out['b'] = runtime_turns()
    out['b']['seconds'] = time.time() - t0
    out['b']['runtime_by_phase'] = {
        10: outputs[10]['runtime'], 13: outputs[13]['runtime']}
    return out


# ------------------------------------------------------------- phase 17

# part (a): the turns, each a fresh process with empty build directories
COLD_TURNS = ('prewarm', 'plain', 'prewarm', 'plain')
# part (b): the Metropolis batch traced (phase 3's chains and steps; two
# generations, one consumption between them, keep the trace ~40 MB)
TRACE_GENS, TRACE_CHAINS, TRACE_STEPS = 2, 256, 80
# part (c): (d, hidden) of the kernel's logdet against the Jacobian oracle
ORACLE_SHAPES, ORACLE_ROWS = ((2, 16), (16, 32)), 64


def cold_turn_main(args):
    """One turn of phase 17 (a), a process of its own: the kernels' and the
    runtime's build directories pointed at a new empty one before their
    first use, then the reference test's 2-D Gaussian (100 live points,
    ``train_iters=50``, ``dlogz=0.5``, seed 42) at the default ladder, with
    a ``prewarm`` first in a 'prewarm' turn. Prints its ``RESULT``: the
    prewarm's walls and launches, which module built in the prewarm and
    which in the run (its ``build_log`` before and after the run), the
    build directory before and after the run, the run's wall, its first
    generation's seconds, its launches and (logz, h, ncall)."""
    import logging
    from nnest_torch import NestedSampler, runtime
    from nnest_torch.likelihoods import Gaussian
    from nnest_torch.ops import consume_pool as cp
    from nnest_torch.ops import spline_coupling as sc
    from nnest_torch.ops import spline_inverse as si
    build = os.path.join(args.mesh_dir, 'build')
    # the kernels build into the spline module's BUILD_DIR (its build())
    si.BUILD_DIR = runtime.BUILD_DIR = build
    modules = {'spline_inverse': si, 'consume_pool': cp,
               'spline_coupling': sc, 'runtime': runtime}
    sampler = NestedSampler(2, Gaussian(2, 0.0, lim=3),
                            transform=lambda x: 3.0 * x,
                            num_live_points=100,
                            log_dir=os.path.join(args.mesh_dir, 'run'),
                            resume=False, seed=42, log_level=logging.WARNING,
                            device='cuda')
    out = {'turn': args.cold_turn}
    reset_counts()
    if args.cold_turn == 'prewarm':
        t0 = time.time()
        out['prewarm_walls'] = sampler.prewarm(train_iters=50, dlogz=0.5)
        torch.cuda.synchronize()
        out['prewarm_s'] = time.time() - t0
    out['prewarm_launches'] = {'spline_inverse': si.launches,
                               'consume_pool': cp.launches}
    before = {k: m.build_log is not None for k, m in modules.items()}
    files = sorted(os.listdir(build)) if os.path.isdir(build) else []
    reset_counts()
    calls, _ = time_dispatches(sampler, (
        '_rejection_prior_generations_batch', '_rejection_prior_sample',
        '_mcmc_generations_batch', '_mcmc_sample_live'))
    t0 = time.time()
    sampler.run(train_iters=50, dlogz=0.5)
    torch.cuda.synchronize()
    out['run_s'] = time.time() - t0
    from nnest_torch.ops import fused_spline
    out['run_launches'] = {'spline_inverse': si.launches,
                           'consume_pool': cp.launches,
                           'twin': fused_spline.calls + cp.twin_calls}
    out['built_in'] = {
        k: ('prewarm' if before[k] else
            'run' if m.build_log is not None else None)
        for k, m in modules.items()}
    out['build_files'] = {'before_run': files,
                          'after_run': sorted(os.listdir(build))}
    out['first_generation_s'] = calls[0]['ms'] / 1e3 if calls else None
    out['first_generation_method'] = calls[0]['method'] if calls else None
    out['final'] = [sampler.logz, sampler.h, sampler.total_calls]
    out['trainings'] = sampler.run_stats['trainings']
    print('RESULT ' + json.dumps(out), flush=True)
    return 0


def cold_turns(record, log_dir):
    """Part (a): :data:`COLD_TURNS`, each this script started as a
    ``--cold-turn`` process on the card."""
    root = os.path.dirname(os.path.abspath(__file__))
    turns = []
    for i, kind in enumerate(COLD_TURNS):
        folder = os.path.join(log_dir, 'cold_%d' % i)
        os.makedirs(folder)
        t0 = time.time()
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), '--cold-turn', kind,
             '--mesh-dir', folder], cwd=root, capture_output=True,
            text=True, timeout=240)
        lines = [ln for ln in proc.stdout.splitlines()
                 if ln.startswith('RESULT ')]
        if proc.returncode != 0 or not lines:
            raise AssertionError('cold turn %d (%s) failed (exit %d):\n%s\n%s'
                                 % (i, kind, proc.returncode,
                                    proc.stdout[-3000:], proc.stderr[-3000:]))
        turn = json.loads(lines[-1][len('RESULT '):])
        turn['process_s'] = time.time() - t0
        turns.append(turn)
        print('phase 17 (a) turn %d %s: prewarm %s, built in %s, run %.2f s '
              '(first generation %.3f s, %s), process %.1f s, final %s' % (
                  i, kind, turn.get('prewarm_walls'), turn['built_in'],
                  turn['run_s'], turn['first_generation_s'] or 0.0,
                  turn['first_generation_method'], turn['process_s'],
                  turn['final']), flush=True)
    for turn in turns:
        if turn['run_launches']['twin']:
            raise AssertionError('a cold turn called a plain twin: %s' % turn)
        if turn['turn'] != 'prewarm':
            continue
        if set(turn['built_in'].values()) != {'prewarm'} or \
                turn['build_files']['before_run'] != \
                turn['build_files']['after_run']:
            raise AssertionError('a build ran inside a prewarmed run: %s'
                                 % turn)
        if min(turn['prewarm_launches'].values()) <= 0:
            raise AssertionError('the prewarm did not launch both kernels: %s'
                                 % turn['prewarm_launches'])
    finals = [t['final'] for t in turns]
    if any(f != finals[0] for f in finals):
        raise AssertionError('the cold turns differ: %s' % finals)
    prewarms = [t for t in turns if t['turn'] == 'prewarm']
    record['launches_by_path']['prewarm'] = sum(
        t['prewarm_launches']['spline_inverse'] for t in prewarms)
    POOL_LAUNCHES['prewarm'] = sum(t['prewarm_launches']['consume_pool']
                                   for t in prewarms)
    record['launches_by_path']['cold_start'] = sum(
        t['run_launches']['spline_inverse'] for t in turns)
    POOL_LAUNCHES['cold_start'] = sum(t['run_launches']['consume_pool']
                                      for t in turns)
    return {'turns': turns, 'equal': True}


def traced_batch(log_dir):
    """Part (b): one Metropolis batch of phase 3's model (:data:`TRACE_GENS`
    generations of 256 chains x 80 steps, from a synthetic shell) under
    ``trace_annotation('mcmc_generation')`` inside ``device_trace``, after
    one untraced batch: the trace file, its CUDA kernels by name and count,
    and the kernels a step."""
    from nnest_torch.utils import device_trace, trace_annotation
    sampler = main_path_sampler(log_dir, 'traced', tooling='off')
    u, logl, derived = synthetic_shell(sampler)
    step = 1.0 / sampler.x_dim ** 0.5

    def batch():
        gens = sampler._mcmc_generations_batch(
            TRACE_STEPS, u, logl, derived, TRACE_CHAINS, step, 0, 10 ** 9,
            TRACE_GENS, dynamic_step_size=True, adapt_cov=True)
        torch.cuda.synchronize()
        return len(gens)

    batch()
    trace_dir = os.path.join(log_dir, 'trace')
    with device_trace(trace_dir):
        with trace_annotation('mcmc_generation'):
            gens = batch()
    files = [f for f in os.listdir(trace_dir) if f.endswith('.json')]
    if len(files) != 1:
        raise AssertionError('device_trace wrote %s' % files)
    with open(os.path.join(trace_dir, files[0])) as f:
        events = json.load(f)['traceEvents']
    counts = {}
    for e in events:
        if e.get('cat') == 'kernel':
            counts[e['name']] = counts.get(e['name'], 0) + 1
    if not any(e.get('name') == 'mcmc_generation' for e in events):
        raise AssertionError('the trace holds no mcmc_generation region')
    for symbol in ('spline_inverse_kernel', 'consume_pool_kernel'):
        if not any(symbol in name for name in counts):
            raise AssertionError('the trace holds no %s: %s'
                                 % (symbol, sorted(counts)[:20]))
    steps = gens * TRACE_STEPS
    top = sorted(counts.items(), key=lambda kv: -kv[1])[:15]
    return {'trace_file': files[0],
            'trace_bytes': os.path.getsize(os.path.join(trace_dir,
                                                        files[0])),
            'generations': gens, 'steps': steps,
            'kernels': sum(counts.values()), 'kernel_names': len(counts),
            'kernels_a_step': sum(counts.values()) / steps,
            'top': [{'name': name[:200], 'count': n, 'a_step': n / steps}
                    for name, n in top]}


def oracle_logdets():
    """Part (c): the CUDA kernel's logdet against ``brute_force_logdet`` of
    the plain model (its Jacobian by autograd on the card, a row at a time)
    at :data:`ORACLE_SHAPES`, N = :data:`ORACLE_ROWS`, rtol and atol 1e-3."""
    from nnest_torch.flows.testing import brute_force_logdet
    from nnest_torch.ops.fused_spline import pack_inverse_consts
    from nnest_torch.ops.spline_inverse import spline_inverse
    out = []
    for d, hidden in ORACLE_SHAPES:
        model = random_flow(d, 17, 'cuda', hidden)
        # N(0, 2^2), rows beyond the tail bound among them; not phase 2's
        # rows exactly at the bound, where autograd's one-sided Jacobian
        # is singular (phase 2 holds those against the twin)
        g = torch.Generator(device='cuda').manual_seed(18)
        z = 2.0 * torch.randn(ORACLE_ROWS, d, generator=g, device='cuda')
        with torch.no_grad():
            _, logdet = spline_inverse(z, pack_inverse_consts(model))
        t0 = time.perf_counter()
        oracle = brute_force_logdet(model, z).detach()
        torch.cuda.synchronize()
        oracle_s = time.perf_counter() - t0
        err = (logdet - oracle).abs()
        excess = float((err - 1e-3 - 1e-3 * oracle.abs()).max())
        out.append({'d': d, 'hidden': hidden, 'n': ORACLE_ROWS,
                    'max_abs_err': float(err.max()),
                    'excess_over_tolerance': excess, 'oracle_s': oracle_s})
        if not excess <= 0:   # a non-finite logdet or oracle fails too
            raise AssertionError('kernel logdet off the Jacobian oracle: %s'
                                 % out[-1])
    return out


def phase_prewarm_trace_oracle(record, log_dir, main):
    """Phase 17: (a) cold starts in turns, (b) a traced Metropolis batch
    and phase 3's phase timers, (c) the kernel's logdet against the
    Jacobian oracle."""
    out = {}
    t0 = time.time()
    out['a'] = cold_turns(record, log_dir)
    out['a']['seconds'] = time.time() - t0
    t0 = time.time()
    out['b'] = traced_batch(log_dir)
    print('phase 17 (b): %d kernels in %d steps, %.2f a step; top: %s' % (
        out['b']['kernels'], out['b']['steps'], out['b']['kernels_a_step'],
        ', '.join('%s x%d' % (k['name'][:48], k['count'])
                  for k in out['b']['top'])), flush=True)
    timers = main['phase_timers']
    print('phase 17 (b): phase 3 Phase timers: %s (run %.2f s)' % (
        json.dumps({k: round(v, 2) for k, v in timers.items()}),
        main['wall_s']), flush=True)
    out['b']['phase3_timers'] = timers
    out['b']['phase3_timers_sum_s'] = sum(timers.values())
    if not timers or sum(timers.values()) > main['wall_s']:
        raise AssertionError('phase 3\'s phase timers %s exceed its run\'s '
                             'wall %r' % (timers, main['wall_s']))
    out['b']['seconds'] = time.time() - t0
    t0 = time.time()
    out['c'] = {'shapes': oracle_logdets(), 'seconds': time.time() - t0}
    return out


# phase 18's shapes: the benchmark cells' flows (portbench/configs: spline
# chains at hidden 16, K = 8, a fast-slow flow with 2 slow dims at d = 30)
# and their training batch; a coupling half has 1, 8, 14 or 25 dims (100
# rows a training step and a validation, 256 the Metropolis starts)
TRAIN_FLOWS = (('gauss16', 16, 0), ('gauss50', 50, 0), ('mog30fs', 30, 2))
TRAIN_BATCH, TRAIN_ROWS, TRAIN_EPOCHS = 100, 1000, 20
COUPLING_HALVES = (1, 8, 14, 25)
COUPLING_ROWS = (100, 256)
COUPLING_BINS, COUPLING_BOUND = 8, 3.0


def coupling_cost(rows, n, k, backward=False):
    """(operations, bytes) of the spline coupling's transform of one half
    (rows x n values, K = k bins), forward or backward, as the function is
    defined (each exp, log, log1p, division, comparison and select one):

    - forward, a value: the knots' two normalisations as the inverse's
      (``rqs_inverse_ops``: 32K - 18), the K + 2 comparisons and clamp, the
      bin's width, height and slope (3), the two derivatives (26), theta
      and its clamp (4), the value and the log-derivative (31); then the
      row sum, one add a value: 33K + 45;
    - backward, a value: the forward again, then the RQS body's gradient
      (~60), the two sides' reverse cumulative sums and two softmax
      gradients each (16K) and the interior derivatives' chain (26 (K - 1)):
      75K + 79.

    Bytes: raw (3K - 1 a value) and x read once, y and the row logdet
    written once; backward also reads dL/dy and dL/dlogdet and writes
    d raw and d x."""
    per = 3 * k - 1
    if backward:
        return (rows * n * (75 * k + 79),
                4 * (rows * n * (2 * per + 3) + rows))
    return rows * n * (33 * k + 45), 4 * (rows * n * (per + 2) + rows)


def coupling_inputs(rows, n, k, seed):
    """Raw outputs at an MLP's scale and x ~ N(0, 2^2) with rows in both
    tails and at -B and B; dL/dy and dL/dlogdet ~ N(0, 1)."""
    g = torch.Generator(device='cuda').manual_seed(seed)
    raw = 0.7 * torch.randn(rows, n * (3 * k - 1), generator=g,
                            device='cuda')
    x = 2.0 * torch.randn(rows, n, generator=g, device='cuda')
    x[0], x[1], x[2], x[3] = 3.5, -4.0, COUPLING_BOUND, -COUPLING_BOUND
    gy = torch.randn(rows, n, generator=g, device='cuda')
    gl = torch.randn(rows, generator=g, device='cuda')
    return raw, x, gy, gl


def coupling_kernel_turns():
    """Part (a): the kernel pair at every half-shape the cells train and
    start chains with, checked (y and the row logdet within ``TOL_X`` and
    ``TOL_LOGDET`` of the plain version, the inverse kernel's allowances;
    both gradients within 1e-4 of the largest magnitude of float64
    autograd's; two launches bit-equal) and timed: each kernel by CUDA-graph replay and eagerly,
    the plain forward and the plain forward + backward by graph replay,
    the pair's forward + backward the same way, beside the bound."""
    from nnest_torch.ops import spline_coupling as sc
    k, b = COUPLING_BINS, COUPLING_BOUND
    out = []
    for n in COUPLING_HALVES:
        for rows in COUPLING_ROWS:
            raw, x, gy, gl = coupling_inputs(rows, n, k, 100 * n + rows)
            y_p, ld_p = sc.coupling_rqs_plain(raw, x, k, b)
            y_k, ld_k = sc.forward_kernel(raw, x, k, b)
            graw, gx = sc.backward_kernel(raw, x, gy, gl, k, b)
            again = sc.forward_kernel(raw, x, k, b) + \
                sc.backward_kernel(raw, x, gy, gl, k, b)
            r64 = raw.double().requires_grad_()
            x64 = x.double().requires_grad_()
            y64, l64 = sc.coupling_rqs_plain(r64, x64, k, b)
            w_raw, w_x = torch.autograd.grad(
                torch.sum(y64 * gy.double()) + torch.sum(l64 * gl.double()),
                (r64, x64))
            torch.cuda.synchronize()
            rec = {'rows': rows, 'n': n, 'bins': k,
                   'max_dy': float((y_k - y_p).abs().max()),
                   'max_dlogdet': float((ld_k - ld_p).abs().max()),
                   'kernel_logdet_off_f64': float(
                       (ld_k.double() - l64.detach()).abs().max()),
                   'plain_logdet_off_f64': float(
                       (ld_p.double() - l64.detach()).abs().max()),
                   'graw_rel': float((graw.double() - w_raw).abs().max()
                                     / w_raw.abs().max()),
                   'gx_rel': float((gx.double() - w_x).abs().max()
                                   / w_x.abs().max()),
                   'bit_equal': all(torch.equal(u, v) for u, v in
                                    zip((y_k, ld_k, graw, gx), again))}
            if not (rec['max_dy'] <= TOL_X and rec['max_dlogdet'] <= TOL_LOGDET
                    and rec['graw_rel'] <= 1e-4 and rec['gx_rel'] <= 1e-4
                    and rec['bit_equal']):
                raise AssertionError('spline coupling kernel pair off its '
                                     'plain version: %s' % rec)

            def pair(fn):
                def run():
                    r = raw.detach().requires_grad_()
                    v = x.detach().requires_grad_()
                    y, ld = fn(r, v, k, b)
                    return torch.autograd.grad(
                        torch.sum(y * gy) + torch.sum(ld * gl), (r, v))
                return run

            for name, fn, cost in (
                    ('forward', lambda: sc.forward_kernel(raw, x, k, b),
                     coupling_cost(rows, n, k)),
                    ('backward',
                     lambda: sc.backward_kernel(raw, x, gy, gl, k, b),
                     coupling_cost(rows, n, k, backward=True))):
                rec[name + '_ms'] = graph_time_ms(fn)
                rec[name + '_eager_ms'] = cuda_time_ms(fn)
                rec[name + '_bound_ms'], rec[name + '_bound'] = bound_ms(
                    *cost)
            rec['pair_ms'] = graph_time_ms(pair(sc._CouplingRQS.apply),
                                           calls=5)
            rec['plain_forward_ms'] = graph_time_ms(
                lambda: sc.coupling_rqs_plain(raw, x, k, b), calls=5)
            rec['plain_pair_ms'] = graph_time_ms(
                pair(sc.coupling_rqs_plain), calls=5)
            out.append(rec)
            print('phase 18 (a): %d x %d: forward %.5f ms (bound %.6f), '
                  'backward %.5f ms (bound %.6f), pair %.4f ms against '
                  'plain %.4f ms' % (rows, n, rec['forward_ms'],
                                     rec['forward_bound_ms'],
                                     rec['backward_ms'],
                                     rec['backward_bound_ms'],
                                     rec['pair_ms'], rec['plain_pair_ms']),
                  flush=True)
    return out


def step_measures(t, d, data):
    """A trainer's captured training step (batch ``TRAIN_BATCH``): the
    kernels one replay runs, by name, from the profiler (the step's copies
    in, the graph and the loss's clone out), a replay's device time by CUDA
    events, and an epoch's wall as the cells' trainer runs it on ``data``
    (``TRAIN_ROWS`` rows: 9 steps and the validation)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    step = t._graphed_step(TRAIN_BATCH, 0.0)
    batch = torch.randn(TRAIN_BATCH, d, device='cuda')
    w = torch.ones(TRAIN_BATCH, device='cuda')
    step(batch, w)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(50):
        step(batch, w)
    end.record()
    end.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            step(batch, w)
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0) + 1
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    t.train(data, max_iters=TRAIN_EPOCHS, patience=10 ** 6)
    torch.cuda.synchronize()
    epoch_ms = (time.perf_counter() - t0) * 1e3 / TRAIN_EPOCHS
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    return {'kernels_a_step': sum(by_name.values()) / 5,
            'coupling_kernels_a_step': sum(
                v for k_, v in by_name.items() if 'coupling_' in k_) / 5,
            'chain_kernels_a_step': sum(
                v for k_, v in by_name.items() if 'chain_' in k_) / 5,
            'step_ms': start.elapsed_time(end) / 50,
            'epoch_ms': epoch_ms,
            'top': [{'name': k_[:80], 'a_step': v / 5} for k_, v in top]}


def train_step_turns():
    """Part (b): for each cell's flow, a captured training step (forward,
    backward, Adam at batch 100) with the coupling's transform plain and
    fused, in turns (plain, fused, fused, plain): the kernels one replay
    runs, by name, from the profiler; a replay's device time by CUDA
    events; an epoch's wall as the cells' trainer runs it (1000 rows: 9
    steps and the validation); and a short training's launches and
    ``train_step`` counter. The plain turns put
    ``coupling_rqs_plain`` in ``coupling_rqs``'s place, which the card
    otherwise never runs; both keep the spline chain's pair (phase 20)
    off."""
    from nnest_torch import Trainer
    from nnest_torch.ops import spline_chain as sch
    from nnest_torch.ops import spline_coupling as sc
    from nnest_torch.utils.profiling import recording
    fused_fn, takes = sc.coupling_rqs, sch.takes
    out = {}
    # the chain's pair (phase 20) off: these turns are the coupling's
    sch.takes = lambda chain, x: False
    try:
        for name, d, num_slow in TRAIN_FLOWS:
            g = torch.Generator().manual_seed(d)
            data = torch.randn(TRAIN_ROWS, d, generator=g).numpy()
            res = {'plain': [], 'fused': []}
            for mode in ('plain', 'fused', 'fused', 'plain'):
                sc.coupling_rqs = (sc.coupling_rqs_plain if mode == 'plain'
                                   else fused_fn)
                t = Trainer(d, hidden_dim=16, num_slow=num_slow,
                            batch_size=TRAIN_BATCH, log=False, seed=d,
                            device='cuda')
                launches = sc.launches
                with recording() as rec:
                    t.train(data, max_iters=2, patience=50)
                torch.cuda.synchronize()
                counted = dict(rec.counters.get('train_step', {}))
                launched = sc.launches - launches
                if counted != {mode: 2 * 9} or (launched > 0) != (
                        mode == 'fused'):
                    raise AssertionError(
                        '%s %s training: train_step %s, %d launches'
                        % (name, mode, counted, launched))
                res[mode].append({'launches_in_training': launched,
                                  'train_step_counter': counted,
                                  **step_measures(t, d, data)})
            out[name] = res
            print('phase 18 (b): %s: kernels a step plain %s, fused %s; '
                  'step ms plain %s, fused %s; epoch ms plain %s, fused %s'
                  % (name, [r['kernels_a_step'] for r in res['plain']],
                     [r['kernels_a_step'] for r in res['fused']],
                     ['%.4f' % r['step_ms'] for r in res['plain']],
                     ['%.4f' % r['step_ms'] for r in res['fused']],
                     ['%.2f' % r['epoch_ms'] for r in res['plain']],
                     ['%.2f' % r['epoch_ms'] for r in res['fused']]),
                  flush=True)
    finally:
        sc.coupling_rqs, sch.takes = fused_fn, takes
    return out


def phase_train_kernels(record):
    """Phase 18: (a) the spline coupling's kernel pair checked and timed
    at the cells' half-shapes, (b) a captured training step's kernels and
    times, plain against fused, for the cells' three flows."""
    from nnest_torch.ops import spline_coupling as sc
    before = sc.launches
    t0 = time.time()
    out = {'a': coupling_kernel_turns()}
    out['a_seconds'] = time.time() - t0
    t0 = time.time()
    out['b'] = train_step_turns()
    out['b_seconds'] = time.time() - t0
    record['launches_by_path']['training'] = sc.launches - before
    return out


# phase 19: the benchmark's gauss50nvp flow (upstream run.py --flow nvp at
# d 50, 3 blocks, the example's hidden 16) and the port's autoscaled width
# 64 at that d; the rows it is held at and timed at; and the float64
# reference's limits (the kernel computes in float32)
NVP_DIM = 50
NVP_CASES = ((16, ''), (64, ''), (16, 'translate'), (16, 'constant'))
NVP_ROWS = (1, 256, 4097)
NVP_TIMED = ((16, 256), (64, 256), (16, 4097))
NVP_REF_X, NVP_REF_LOGDET = 1e-4, 1e-3


def random_nvp_flow(d, hidden, scale, seed, device):
    """A random NVP flow, every parameter moved by N(0, 0.1^2) off its
    init (so every ScaleLayer's s is off 0)."""
    from nnest_torch.flows import build_flow
    model = build_flow(d, flow='nvp', hidden_dim=hidden, scale=scale,
                       seed=seed, device=device)
    g = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=g, device=device))
    return model


def relative_gap(a, b):
    """The widest gap of ``a`` from ``b`` relative to max(1, |b|): an NVP
    flow's x is unbounded (|x| reaches 30 at hidden 64 on phase 19's
    weights), and float32 keeps a relative precision."""
    b = b.double()
    return float(((a.double() - b).abs() / b.abs().clamp(min=1.0)).max())


def nvp_reference():
    """The benchmark's float64 NVP reference (it imports nothing of the
    port), and with it the kernel's yardstick ``inverse_cost``."""
    here = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        'portbench')
    if here not in sys.path:
        sys.path.append(here)
    from reference.flows import nvp
    return nvp


def aten_ops(fn):
    """The aten operations one call of ``fn`` dispatches."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    return Count.n


def phase_nvp_kernel(record):
    """Phase 19: the NVP kernel built, held to its twin, ``model.inverse``
    and the float64 reference at the ``gauss50nvp`` widths, and timed."""
    from nnest_torch.ops import nvp_inverse as nv
    ref = nvp_reference()
    device = torch.device('cuda')
    t0 = time.time()
    nv.load_library()
    out = {'build_s': time.time() - t0,
           'ptxas': [line.strip() for line in nv.build_log.splitlines()
                     if 'spill' in line or 'Used' in line],
           'checks': [], 'timed': []}
    before = nv.launches
    worst = [0.0, 0.0]
    for hidden, scale in NVP_CASES:
        model = random_nvp_flow(NVP_DIM, hidden, scale, 600 + hidden, device)
        packed = nv.pack_nvp_consts(model)
        state = {k: v.double() for k, v in model.state_dict().items()}
        for n in NVP_ROWS:
            g = torch.Generator(device=device).manual_seed(17 * n + hidden)
            z = 2.0 * torch.randn(n, NVP_DIM, generator=g, device=device)
            launches, calls = nv.launches, nv.calls
            got = nv.nvp_inverse(z, packed)
            torch.cuda.synchronize()
            if nv.launches - launches != 1 or nv.calls != calls:
                raise AssertionError(
                    'nvp kernel at n=%d: %d launches (want 1), %d twin '
                    'calls (want 0)' % (n, nv.launches - launches,
                                        nv.calls - calls))
            with torch.no_grad():
                twin = nv.nvp_inverse_twin(z, packed)
                want = model.inverse(z)
                x64, ld64 = ref.inverse(state, z.double())
            case = {'d': NVP_DIM, 'hidden': hidden, 'scale': scale, 'n': n}
            for name, other, tx, tld in (
                    ('twin', twin, TOL_X, TOL_LOGDET),
                    ('model', want, TOL_X, TOL_LOGDET),
                    ('reference', (x64, ld64), NVP_REF_X, NVP_REF_LOGDET)):
                dx, dld = (relative_gap(a, b) for a, b in zip(got, other))
                case['vs_%s' % name] = (dx, dld)
                if not (dx <= tx and dld <= tld):
                    raise AssertionError('nvp kernel against the %s: %s'
                                         % (name, case))
            worst = [max(worst[0], case['vs_twin'][0]),
                     max(worst[1], case['vs_twin'][1])]
            if n > 77:
                # each row on its own: a second batch size
                part = nv.nvp_inverse(z[:77].contiguous(), packed)
                torch.cuda.synchronize()
                case['rows_alone'] = (torch.equal(part[0], got[0][:77])
                                      and torch.equal(part[1], got[1][:77]))
                if not case['rows_alone']:
                    raise AssertionError('nvp kernel: 77 rows differ from '
                                         'the same rows of %d' % n)
            out['checks'].append(case)
    for hidden, n in NVP_TIMED:
        model = random_nvp_flow(NVP_DIM, hidden, '', 700 + hidden, device)
        packed = nv.pack_nvp_consts(model)
        g = torch.Generator(device=device).manual_seed(n)
        z = 2.0 * torch.randn(n, NVP_DIM, generator=g, device=device)

        def plain():
            with torch.no_grad():
                return model.inverse(z)
        bound = bound_ms(*ref.inverse_cost(n, NVP_DIM, hidden, 3))
        row = {'d': NVP_DIM, 'hidden': hidden, 'n': n,
               'ms': graph_time_ms(lambda: nv.nvp_inverse(z, packed)),
               'eager_ms': cuda_time_ms(lambda: nv.nvp_inverse(z, packed)),
               'bound_ms': bound[0], 'bound_by': bound[1],
               'plain_ms': cuda_time_ms(plain),
               'plain_graph_ms': graph_time_ms(plain),
               'plain_aten_ops': aten_ops(plain),
               'plan': nv.launch_plan(n, NVP_DIM, hidden, 2, 3)}
        row['x_bound'] = row['ms'] / row['bound_ms']
        print('phase 19: d %d, hidden %d, n %d: %.5f ms by replay (%.5f '
              'eager), bound %.6f ms, plain %.4f ms eager (%.4f replay, %d '
              'aten ops)' % (NVP_DIM, hidden, n, row['ms'], row['eager_ms'],
                             row['bound_ms'], row['plain_ms'],
                             row['plain_graph_ms'], row['plain_aten_ops']),
              flush=True)
        out['timed'].append(row)
    torch.cuda.synchronize()
    out['worst_vs_twin'] = worst
    record['launches_by_path']['nvp_kernel'] = nv.launches - before
    return out


# phase 20: the spline chain's training pair at the cells' chains (name,
# d, the fast-slow flow's num_slow and chain), all at hidden 16 and K 8; the
# rows a training step takes (forward and backward), and the forward alone
# at the starts' 256 and the NLL gate's and covariance factor's 1000; the
# limits against float64: y and the row logdet (relative to max(1, |value|))
# within these or, where float32 itself is farther off on the inputs (the
# plain chain in float32 on the CPU), within twice its distance; the
# gradients' largest gap (each relative to its largest magnitude) within
# twice float32's own (autograd through the plain chain in float32, on the
# CPU and on the card with each coupling half on its own pair) plus 1e-5
CHAIN_CASES = (('gauss16', 16, 0, None), ('gauss50', 50, 0, None),
               ('mog30fs.slow', 30, 2, 'slow'),
               ('mog30fs.fast', 30, 2, 'fast'))
CHAIN_ROWS, CHAIN_FORWARD_ROWS = 100, (256, 1000)
CHAIN_TOL_Y, CHAIN_TOL_LOGDET, CHAIN_TOL_GRAD = 1.5e-5, 3e-5, 1e-5


def worst_gap(got, want):
    """The largest gap of any gradient from float64's, relative to that
    gradient's largest magnitude."""
    return max(float((a.detach().double().cpu() - w).abs().max())
               / float(w.abs().max()) for a, w in zip(got, want))


def chain_cost(rows, d, hidden, k, blocks, backward=False):
    """(operations, bytes) of the spline chain's forward, or of its
    backward, at ``rows`` x ``d``, as the function is defined: a block's
    ActNorm (2 a value), the conv and the two conditioner MLPs (2 a
    multiply-add, 1 a bias, 2 a LeakyReLU), the RQS of each value
    (``coupling_cost``); the backward takes each product twice (d/d input
    and d/d weight) and each RQS's backward (``coupling_cost``'s, the RQS
    forward it needs included; the rest of the forward it reads from the
    forward's records). Bytes: the weights once
    and the rows in and out; the backward reads the saved block inputs,
    dL/dz and dL/dlogdet and writes d/dx and a gradient for every
    weight."""
    per = 3 * k - 1
    cut = d - d // 2
    up = d - cut
    macs, weights, extra = d * d, 2 * d + d * d, 2 * d
    for n_in, n_out in ((cut, up * per), (up, cut * per)):
        sizes = (n_in, hidden, hidden, hidden, n_out)
        for i in range(4):
            macs += sizes[i] * sizes[i + 1]
            weights += sizes[i] * sizes[i + 1] + sizes[i + 1]
            extra += sizes[i + 1] + (2 * sizes[i + 1] if i < 3 else 0)
    forward = rows * blocks * (2 * macs + extra) + \
        blocks * coupling_cost(rows, d, k)[0]
    if not backward:
        return forward, 4 * (blocks * weights + 2 * rows * d + rows)
    ops = rows * blocks * 4 * macs + \
        blocks * coupling_cost(rows, d, k, backward=True)[0]
    return ops, 4 * (2 * blocks * weights + (blocks + 2) * rows * d + rows)


def chain_case(d, num_slow, part):
    """A cell's chain in float64 on the CPU (every parameter moved by
    N(0, 0.1^2) off its init) and in float32 on the card."""
    import copy
    from nnest_torch.flows import build_flow
    model = build_flow(d, hidden_dim=16, num_slow=num_slow, seed=d,
                       device='cpu')
    chain64 = copy.deepcopy(getattr(model, part) if num_slow
                            else model.chain)
    g = torch.Generator().manual_seed(d + 1)
    with torch.no_grad():
        for p in chain64.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=g))
    chain64 = chain64.double()
    return chain64, copy.deepcopy(chain64).to('cuda', torch.float32)


def chain_autograd(chain64, x, gz, gl):
    """Autograd through the chain (its dtype, on its device) of sum(z gz)
    + sum(RQS logdet gl), each assembled W a leaf: d/dx and each tensor's
    gradient in the kernels' table order."""
    import copy
    from nnest_torch.ops import spline_chain as sch
    chain = copy.deepcopy(chain64)
    for _, conv, _ in sch._blocks(chain):
        W = conv.assemble().detach().requires_grad_()
        conv.assemble = (lambda W=W: W)
    x = x.clone().requires_grad_()
    tensors = sch.chain_tensors(chain)
    z, logdet = chain(x)
    rqs = logdet - sch.const_logdet(chain)
    got = torch.autograd.grad(torch.sum(z * gz) + torch.sum(rqs * gl),
                              [x] + tensors)
    return [g.detach() for g in got]


def chain_kernel_turns():
    """Part (a): the chain pair at the cells' chains, checked (y, the row
    logdet within ``CHAIN_TOL_*`` of float64, the gradients no farther from
    it than twice float32's own distance plus ``CHAIN_TOL_GRAD``; two
    launches bit-equal) and timed: each launch by CUDA-graph replay and
    eagerly beside its bound (``chain_cost``), the pair under autograd
    against the module-by-module chain (each coupling half on its own pair,
    the path before the chain's) forward alone and forward and backward,
    by graph replay."""
    import copy
    from nnest_torch.ops import spline_chain as sch
    takes = sch.takes
    out = []
    for name, d, num_slow, part in CHAIN_CASES:
        chain64, chain = chain_case(d, num_slow, part)
        n = chain.bijectors[0].dim
        meta = sch._shape(chain)
        tensors = [t.detach() for t in sch.chain_tensors(chain)]
        with torch.no_grad():
            const = float(sch.const_logdet(chain64))
        for rows in (CHAIN_ROWS,) + CHAIN_FORWARD_ROWS:
            backward = rows == CHAIN_ROWS
            g = torch.Generator().manual_seed(rows + n)
            x64 = 2.0 * torch.randn(rows, n, generator=g,
                                    dtype=torch.float64)
            x64[0], x64[1] = 9.0, -9.0
            gz64 = torch.randn(rows, n, generator=g, dtype=torch.float64)
            gl64 = torch.randn(rows, generator=g, dtype=torch.float64)
            x, gz, gl = (v.float().cuda() for v in (x64, gz64, gl64))
            if not sch.takes(chain, x):
                raise AssertionError('%s: the chain kernels refuse it' % name)
            z, ld, saved = sch.forward_kernel(x, tensors, meta, save=True)
            with torch.no_grad():
                z64, ld64 = chain64(x64)
                z32, ld32 = copy.deepcopy(chain64).float()(x64.float())
            ld64 = ld64 - const
            ld32 = ld32 - const

            def gap(a, want):
                return float((a.double().cpu() - want).abs().max()) / max(
                    1.0, float(want.abs().max()))
            rec = {'chain': name, 'rows': rows, 'd': n, 'hidden': 16,
                   'bins': 8, 'y_gap': gap(z, z64),
                   'logdet_gap': gap(ld, ld64),
                   'plain_f32_y_gap': gap(z32, z64),
                   'plain_f32_logdet_gap': gap(ld32, ld64),
                   'plan': sch.launch_plan(rows, n, 16, 8, False)}
            first = [z, ld]
            again = list(sch.forward_kernel(x, tensors, meta)[:2])
            ok = rec['y_gap'] <= max(CHAIN_TOL_Y,
                                     2.0 * rec['plain_f32_y_gap']) and \
                rec['logdet_gap'] <= max(CHAIN_TOL_LOGDET,
                                         2.0 * rec['plain_f32_logdet_gap'])
            if backward:
                gx, grads = sch.backward_kernel(saved, tensors, gz, gl, meta)
                want = chain_autograd(chain64, x64, gz64, gl64)
                rec['grad_gap'] = worst_gap([gx] + grads, want)
                rec['plain_f32_grad_gap'] = worst_gap(chain_autograd(
                    copy.deepcopy(chain64).float(), x64.float(),
                    gz64.float(), gl64.float()), want)
                sch.takes = lambda c, v: False
                try:
                    rec['card_plain_grad_gap'] = worst_gap(
                        chain_autograd(chain, x, gz, gl), want)
                finally:
                    sch.takes = takes
                rec['backward_plan'] = sch.launch_plan(rows, n, 16, 8, True)
                first += [gx] + grads
                gx2, grads2 = sch.backward_kernel(saved, tensors, gz, gl,
                                                  meta)
                again += [gx2] + grads2
                ok = ok and rec['grad_gap'] <= 2.0 * max(
                    rec['plain_f32_grad_gap'],
                    rec['card_plain_grad_gap']) + CHAIN_TOL_GRAD
            torch.cuda.synchronize()
            rec['bit_equal'] = all(torch.equal(a, b)
                                   for a, b in zip(first, again))
            if not (ok and rec['bit_equal']):
                raise AssertionError('spline chain pair off float64: %s'
                                     % rec)
            fwd_cost = chain_cost(rows, n, 16, 8, 3)
            rec['forward_ms'] = graph_time_ms(
                lambda: sch.forward_kernel(x, tensors, meta))
            rec['forward_eager_ms'] = cuda_time_ms(
                lambda: sch.forward_kernel(x, tensors, meta))
            rec['forward_bound_ms'], rec['forward_bound'] = bound_ms(
                *fwd_cost)
            with torch.no_grad():
                rec['forward_api_ms'] = graph_time_ms(lambda: chain(x),
                                                      calls=5)
                sch.takes = lambda c, v: False
                try:
                    rec['plain_forward_ms'] = graph_time_ms(
                        lambda: chain(x), calls=5)
                finally:
                    sch.takes = takes
            if backward:
                def bwd():
                    return sch.backward_kernel(saved, tensors, gz, gl, meta)
                rec['backward_ms'] = graph_time_ms(bwd)
                rec['backward_eager_ms'] = cuda_time_ms(bwd)
                rec['backward_bound_ms'], rec['backward_bound'] = bound_ms(
                    *chain_cost(rows, n, 16, 8, 3, backward=True))
                params = list(chain.parameters())

                def pair():
                    zz, ll = chain(x)
                    return torch.autograd.grad(
                        torch.sum(zz * gz) + torch.sum(ll * gl), params)
                rec['pair_ms'] = graph_time_ms(pair, calls=5)
                sch.takes = lambda c, v: False
                try:
                    rec['plain_pair_ms'] = graph_time_ms(pair, calls=5)
                finally:
                    sch.takes = takes
            out.append(rec)
            print('phase 20 (a): %s x %d: forward %.5f ms (bound %.6f, '
                  'module by module %.4f)%s' % (
                      name, rows, rec['forward_ms'],
                      rec['forward_bound_ms'], rec['plain_forward_ms'],
                      ', backward %.5f ms (bound %.6f), pair %.4f ms '
                      'against %.4f' % (rec['backward_ms'],
                                        rec['backward_bound_ms'],
                                        rec['pair_ms'], rec['plain_pair_ms'])
                      if backward else ''), flush=True)
    return out


def chain_step_turns():
    """Part (b): for each cell's flow, a captured training step before (the
    chain's pair off: each coupling half on its own pair, phase 18's
    ``fused``) and after (the chain's pair), in turns (pair, chain, chain,
    pair): a short training's counters (``train_step`` all ``fused``;
    ``spline_chain`` all ``plain`` before, all ``kernel`` after) and the
    chain's launches (0 before), then :func:`step_measures`."""
    from nnest_torch import Trainer
    from nnest_torch.ops import spline_chain as sch
    from nnest_torch.utils.profiling import recording
    takes = sch.takes
    out = {}
    try:
        for name, d, num_slow in TRAIN_FLOWS:
            g = torch.Generator().manual_seed(d)
            data = torch.randn(TRAIN_ROWS, d, generator=g).numpy()
            res = {'pair': [], 'chain': []}
            for mode in ('pair', 'chain', 'chain', 'pair'):
                sch.takes = takes if mode == 'chain' else (
                    lambda chain, x: False)
                t = Trainer(d, hidden_dim=16, num_slow=num_slow,
                            batch_size=TRAIN_BATCH, log=False, seed=d,
                            device='cuda')
                launches = sch.launches
                with recording() as rec:
                    t.train(data, max_iters=2, patience=50)
                torch.cuda.synchronize()
                counted = dict(rec.counters.get('train_step', {}))
                chains = dict(rec.counters.get('spline_chain', {}))
                launched = sch.launches - launches
                path = 'kernel' if mode == 'chain' else 'plain'
                if counted != {'fused': 2 * 9} or set(chains) != {path} or \
                        (launched > 0) != (mode == 'chain'):
                    raise AssertionError(
                        '%s %s training: train_step %s, spline_chain %s, %d '
                        'launches' % (name, mode, counted, chains, launched))
                res[mode].append({'launches_in_training': launched,
                                  'train_step_counter': counted,
                                  'spline_chain_counter': chains,
                                  **step_measures(t, d, data)})
            out[name] = res
            print('phase 20 (b): %s: kernels a step pair %s, chain %s; '
                  'step ms pair %s, chain %s; epoch ms pair %s, chain %s'
                  % (name, [r['kernels_a_step'] for r in res['pair']],
                     [r['kernels_a_step'] for r in res['chain']],
                     ['%.4f' % r['step_ms'] for r in res['pair']],
                     ['%.4f' % r['step_ms'] for r in res['chain']],
                     ['%.2f' % r['epoch_ms'] for r in res['pair']],
                     ['%.2f' % r['epoch_ms'] for r in res['chain']]),
                  flush=True)
    finally:
        sch.takes = takes
    return out


def phase_chain_kernels(record):
    """Phase 20: the build of ``csrc/spline_chain.cu`` with its
    ``-Xptxas -v`` report, (a) the spline chain's pair checked and timed at
    the cells' chains, (b) a captured training step's kernels and times
    with the chain's pair against each coupling half's, for the cells'
    three flows."""
    from nnest_torch.ops import spline_chain as sch
    t0 = time.time()
    sch.load_library()
    out = {'build_s': time.time() - t0,
           'ptxas': ptxas_report(sch.build_log)}
    before = sch.launches
    t0 = time.time()
    out['a'] = chain_kernel_turns()
    out['a_seconds'] = time.time() - t0
    t0 = time.time()
    out['b'] = chain_step_turns()
    out['b_seconds'] = time.time() - t0
    record['launches_by_path']['chain_kernel'] = sch.launches - before
    return out


def main():
    import argparse
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--baseline', metavar='SRC',
                        help='an earlier kernel source to time beside '
                             'this one in phase 2')
    parser.add_argument('--pool-baseline', metavar='SRC',
                        help='an earlier consume_pool source to hold to '
                             'the twin and time beside this one in phase 2')
    parser.add_argument('--phases', type=lambda v: {int(p) for p in
                                                    v.split(',')},
                        help='run only these phases (comma-separated '
                             'numbers; those that read phase 3\'s output '
                             'need 3 among them)')
    # one rank of phase 14 or 16, started by the script itself
    parser.add_argument('--mesh-part', choices=('a', 'b', 'd1', 'd2', 'tp'),
                        help=argparse.SUPPRESS)
    parser.add_argument('--mesh-dir', help=argparse.SUPPRESS)
    # one turn of phase 17 (a), started by the script itself
    parser.add_argument('--cold-turn', choices=('prewarm', 'plain'),
                        help=argparse.SUPPRESS)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print('chip_smoke: CUDA is not available', file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import nnest_torch  # noqa: F401  (fails outside a checkout of the repo)
    if args.cold_turn:
        return cold_turn_main(args)
    if args.mesh_part == 'tp':
        return tp_rank_main(args)
    if args.mesh_part:
        return mesh_rank_main(args)

    paths = ('mcmc', 'rejection_flow', 'density_flow', 'per_block', 'slice',
             'mcmc_sampler', 'ensemble', 'dynamic', 'host_likelihood',
             'derived', 'cli', 'mesh', 'prefetch', 'tp', 'prewarm',
             'cold_start')
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
        # no Pallas kernel behind it: the XLA lax.scan of nnest_tpu's
        # LatentKernels._consume_pool
        {'name': 'consume_pool', 'route': 'cuda',
         'source': 'nnest_torch/csrc/consume_pool.cu',
         'replaces': 'nnest_tpu/samplers/kernels.py:708',
         'launches': None, 'library_ms': None, 'launches_by_path': {}},
        # no TPU kernel behind it: the JAX package trains in plain XLA
        {'name': 'spline_coupling', 'route': 'cuda',
         'source': 'nnest_torch/csrc/spline_coupling.cu',
         'replaces': None, 'launches': None, 'library_ms': None,
         'launches_by_path': {'mcmc': 0, 'training': 0}},
        # no TPU kernel behind it: the JAX package runs NVP in plain XLA
        {'name': 'nvp_inverse', 'route': 'cuda',
         'source': 'nnest_torch/csrc/nvp_inverse.cu',
         'replaces': None, 'launches': None, 'library_ms': None,
         'launches_by_path': {'other_flows': 0, 'nvp_kernel': 0}},
        # no TPU kernel behind it: the JAX package trains in plain XLA
        {'name': 'spline_chain', 'route': 'cuda',
         'source': 'nnest_torch/csrc/spline_chain.cu',
         'replaces': None, 'launches': None, 'library_ms': None,
         'launches_by_path': {'mcmc': 0, 'chain_kernel': 0}},
    ]
    outputs = {}
    with tempfile.TemporaryDirectory(prefix='chip_smoke_') as log_dir:
        earlier = {}
        if args.baseline:
            earlier['spline'] = lambda: EarlierKernel(
                os.path.abspath(args.baseline), log_dir)
        if args.pool_baseline:
            earlier['pool'] = lambda: EarlierPool(
                os.path.abspath(args.pool_baseline), log_dir)
        for num, name, fn in (
                (1, 'device', lambda: phase_device(earlier)),
                (2, 'kernel', lambda: phase_kernel(
                    records, earlier.get('spline'), earlier.get('pool'))),
                (3, 'main_path', lambda: phase_main_path(records[0],
                                                         log_dir)),
                (4, 'correctness', lambda: phase_correctness(log_dir)),
                (5, 'per_block_entry',
                 lambda: phase_per_block_entry(records[1])),
                (6, 'flow_rejection',
                 lambda: phase_flow_rejection(records, log_dir)),
                (7, 'resume', lambda: phase_resume(log_dir)),
                (8, 'slice', lambda: phase_slice(records[0], log_dir)),
                (9, 'other_flows',
                 lambda: phase_other_flows(log_dir, records[4])),
                (10, 'mcmc_ensemble',
                 lambda: phase_mcmc_ensemble(records[0], log_dir)),
                (11, 'dynamic', lambda: phase_dynamic(records[0], log_dir)),
                (12, 'derived', lambda: phase_derived(records[0], log_dir)),
                (13, 'cli', lambda: phase_cli(records[0], log_dir)),
                (14, 'mesh', lambda: phase_mesh(records[0], log_dir,
                                                outputs[3])),
                (15, 'prefetch', lambda: phase_prefetch(records[0], log_dir,
                                                        outputs[3])),
                (16, 'tp_runtime', lambda: phase_tp_runtime(
                    records[0], log_dir, outputs)),
                (17, 'prewarm_trace_oracle',
                 lambda: phase_prewarm_trace_oracle(records[0], log_dir,
                                                    outputs[3])),
                (18, 'train_kernels',
                 lambda: phase_train_kernels(records[3])),
                (19, 'nvp_kernel', lambda: phase_nvp_kernel(records[4])),
                (20, 'chain_kernels',
                 lambda: phase_chain_kernels(records[5]))):
            if args.phases and num not in args.phases:
                continue
            t0 = time.time()
            out = outputs[num] = fn()
            emit({'phase': num, 'name': name,
                  'seconds': time.time() - t0, **out})
    records[2]['launches_by_path'] = dict(POOL_LAUNCHES)
    records[3]['launches_by_path'].update(COUPLING_LAUNCHES)
    records[5]['launches_by_path'].update(CHAIN_LAUNCHES)
    for rec in records:
        # launches on the paths that drive the kernel (phases 3, 5, 6, 8,
        # 10, 11, 12, 13, 14, 15, 16, 17; the coupling pair's: 3 and 18)
        rec['launches'] = sum(rec['launches_by_path'].values())
    emit({'kernels': records})
    emit({'ok': True, 'device': {'platform': 'gpu',
                                 'kind': torch.cuda.get_device_name(0),
                                 'count': torch.cuda.device_count()}})
    return 0


if __name__ == '__main__':
    sys.exit(main())
