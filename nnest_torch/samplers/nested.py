"""Nested sampler: evidence (logZ) and posterior samples.

Port of ``nnest_tpu/samplers/nested.py``, on one process or on the ranks
of a mesh (``mesh=``, ``nnest_torch.parallel``): the strategy
ladder over ``'rejection_prior'``, ``'rejection_flow'``, ``'density_flow'``,
``'mcmc'`` and ``'slice'`` with efficiency-based expiry (a rejection phase
expires once its likelihood calls per candidate pass those of the
downstream kernel: ``mcmc_steps``, or ``slice_steps * (1 +
slice_max_expand)`` for slice), the adaptive rejection trial
ladder, the NLL-gated flow retrain (which also invalidates the
flow-rejection envelope), candidate pool generations (up to
``mcmc_gen_batch`` or ``rejection_gen_batch`` a dispatch, below) consumed
across iterations, and the float64 host evidence (logz, h, logzerr). The
worst-point replacement loop stays on the host in float64; candidate
generation and flow training run on the sampler's device.

At the end of a run the diagnostics of the JAX package are computed: the
insertion-index KS test (whole run and rolling), the thread-bootstrap
logZ error, the kernel mixing ratios, the latent condition number and the
calibrated ``logzerr_adjusted``, with ``run_quality_flags``.

Artifacts under ``<log_dir>/runN/``: ``info/params.txt``,
``results/{results.csv,final.csv,diagnostics.json,insertion_ranks.npy,
threads.npz}``, ``chains/chain.txt`` (at the end of the run) and
``checkpoint/``. Checkpoints
follow a geometric cadence, written in this order: ``active_{u,v,logl,
derived}_<it>.npy`` and ``saved_{v,logl,logwt,slots,u}.npy``, then one
exact-state
file (``exact_state.pt``: the sampler's generator, the trainer snapshot,
the unconsumed pool, the ladder controller and the insertion ranks, all
stamped with ``it``; written to a temporary file and moved into place),
then the ``checkpoint_<it>.txt`` marker. With ``resume=True`` a run picks
up the newest valid checkpoint, falling back to an older one when a file
is corrupt; the continuation is bit-identical to the uninterrupted run on
the CPU when the exact state's stamp matches the marker, and statistically
exact (pool and controller dropped, a warning logged) otherwise. This
port reads only its own checkpoints.

Every flow of ``build_flow`` runs through it (``flow``, ``num_slow``,
``num_layers``, ``scale``, ``base_dist``); a fast-slow flow's Metropolis
proposals move the fast dims only with probability ``oversample_rate``,
and ``run_stats['total_fast_calls']`` counts their likelihood calls.

``prewarm(**run_kwargs)`` pays a run's one-time costs (the libraries'
builds, the card's start-up) with throwaway runs before ``run()``; the
sampler's ``timers`` (``nnest_torch.utils.StepTimer``, ``nnest_tpu``'s
phase names) are logged at the end of every run as ``Phase timers``.
``run_stats`` takes ``train_s`` and ``checkpoint_s`` from the phases'
own clocks, ``<stem>_s`` from the ``pool`` region (one pool refill), and
``train_epochs`` from the trainer's ``total_iters``. While the program
records (``utils/profiling.py``; a run under a ``torch.profiler`` records
itself), its spans are ``run``, ``loop`` (the evidence loop), ``pool``,
the phases, and inside them ``gen.prep``, ``gen.steps``, ``gen.consume``,
``gen.pull`` (``samplers/kernels.py``), ``gen.serve`` and ``io.drain``
(``samplers/base.py``).

``run(init_points=, birth_floor=, logl_ceiling=)`` are the hooks of the
dynamic sampler's batches (``samplers/dynamic.py``), which also reads
``saved_u``, the u-space points of the run (in the checkpoints as
``saved_u.npy`` and in ``threads.npz`` as ``u``).

Derived parameters (``num_derived``, a likelihood returning ``(logl,
derived)``) ride with every live point: the candidate pools carry them,
a replacement copies them, and every dead and final live point is saved
as ``v`` followed by its derived values, so ``samples`` and the rows of
``chain.txt`` have ``x_dim + num_derived`` parameter columns.

The run's file writes leave the sampling loop: each checkpoint is
snapshotted on the calling thread (copies of every array, the generator
and trainer states) and written by the background writer
(``utils/io_async.SerialWriter``, FIFO, so a checkpoint's files keep their
order), which also rewrites ``chain.txt`` at every checkpoint and logs the
``logz`` TensorBoard scalar of every iteration. ``run`` drains the writer
before it reads a checkpoint, and joins the trainer's plots and closes the
writer before the final results are written. ``run(show_progress=True)``
shows a tqdm bar (imported when asked for; without tqdm, no bar), closed
when the run raises.

Multi-generation prefetch (``run(mcmc_gen_batch=, rejection_gen_batch=,
mcmc_speculate=)``, ``nnest_tpu``'s): with a batch above 1 a dispatch runs
up to that many pool generations of the current strategy back to back on
the device, replaying the host's consumption of each pool on the device's
copy of the live set between them (``LatentKernels._consume_pool``, one
launch of ``csrc/consume_pool.cu`` on the card), so a generation starts
from the live set the previous one left without a round trip. The host
then replays the same consumption in float64 for the evidence and serves
each generation from its buffer (``mcmc_buf``, ``prior_buf``,
``flow_buf``) when its replay reaches it. The batch runners stop before a
generation the host might not run next: an ``update_interval`` crossing
(a possible retrain; Metropolis, slice and flow rejection), a change of
the trial ladder, the efficiency expiry's float32 proxy at 0.9x its
threshold, or two iterations before the volume switch (prior rejection).
With ``mcmc_speculate`` (and a ``retrain_nll_threshold``) the Metropolis
and slice batch runners run past crossings, betting that the NLL gate skips the
retrain; when it retrains after all, the buffered generations are dropped
and the generator is set back to the first one's state. Results are
those of one generation a dispatch, bit for bit, whenever every live logl
is a float32 value (the device replays in float32; a monotonic cast keeps
its min, argmin and compares the host's); otherwise, as under a mesh, a
generation a dispatch. The buffers ride in the checkpoints, so a resume
inside a buffer is bit-exact too. ``run_stats`` counts each strategy's
dispatches (``<stem>_dispatches``) beside its generations, the buffered
generations a retrain dropped (``speculation_losses``) and those left
unserved when the run ended (``generations_discarded``); for each
rejection strategy, its generations and the candidates they passed by
trial count (``<stem>_by_trials``).

Under a mesh (``mesh=``, :mod:`nnest_torch.parallel`) every rank runs this
loop in lockstep. A Metropolis or slice pool generation takes the
one-process route with the mesh passed down: every rank draws the same
starts and red-black split on the device (``LatentKernels.mcmc_from_live``
and ``slice_from_live``) and steps its share of the chains; the other
strategies run replicated. Rank 0 alone reads and writes checkpoints: on
resume it broadcasts its decision and its whole state (live and dead
points, the evidence, the controller, the pool, the insertion ranks, the
thread slots, the counters, the sampler's and the trainer's generators, the
trainer's flow, Adam moments and scalars) in one collective
(:meth:`Sampler._broadcast_resume`).
"""

from __future__ import annotations

import contextlib
import csv
import json
import logging
import os
import re
import time

import numpy as np
import torch

from nnest_torch import runtime
from nnest_torch.priors import UniformPrior
from nnest_torch.samplers.base import Sampler
from nnest_torch.utils.evaluation import (adjusted_logzerr,
                                          bootstrap_logz_error, insertion_ks,
                                          latent_cond_null,
                                          metropolis_mix_null,
                                          rolling_insertion_ks,
                                          slice_mix_null)
from nnest_torch.utils.profiling import (profiler_collecting, recording,
                                         span, timed)

# the strategy ladder's methods, in nnest_tpu's order
_METHODS = ('rejection_prior', 'rejection_flow', 'density_flow', 'mcmc',
            'slice')
# run_stats key stem of each candidate generator
_STAT_KEY = {'rejection_prior': 'rejection', 'rejection_flow':
             'rejection_flow', 'density_flow': 'density', 'mcmc': 'mcmc',
             'slice': 'slice'}
EXACT_STATE = 'exact_state.pt'


def _tensors(tree):
    """numpy arrays in ``tree`` as tensors (the exact-state file loads
    with ``weights_only=True``, which takes tensors and plain Python)."""
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(np.array(tree))
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tensors(v) for v in tree]
    return tree


def _arrays(tree):
    """Inverse of :func:`_tensors` (sequences come back as lists)."""
    if isinstance(tree, torch.Tensor):
        return tree.numpy()
    if isinstance(tree, dict):
        return {k: _arrays(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_arrays(v) for v in tree]
    return tree


def _f32_exact(logl):
    """Whether every value of ``logl`` is a float32 value: the condition
    under which the device's float32 replay of the consumption makes the
    host's float64 decisions (the prefetch's gate)."""
    return bool(np.all(logl.astype(np.float32).astype(np.float64) == logl))


def _check_sync(kind, g_it, g_loglstar, it, loglstar, g_trials=None,
                trials=None):
    """Raise when a buffered generation did not start where the host's
    replay is: the device and host consumption disagreed."""
    host = float(np.float32(loglstar))
    if g_it != it or g_loglstar != host or g_trials != trials:
        raise RuntimeError(
            '%s generation prefetch desync: device (it=%d, loglstar=%r, '
            'trials=%s) vs host (it=%d, loglstar=%r, trials=%s)' % (
                kind, g_it, g_loglstar, g_trials, it, host, trials))


class NestedSampler(Sampler):

    def __init__(self,
                 x_dim,
                 loglike,
                 transform=None,
                 append_run_num=True,
                 hidden_dim=0,
                 num_slow=0,
                 num_derived=0,
                 batch_size=100,
                 flow='spline',
                 num_blocks=3,
                 num_layers=1,
                 learning_rate=0.001,
                 log_dir='logs/test',
                 resume=True,
                 base_dist=None,
                 scale='',
                 trainer=None,
                 oversample_rate=-1,
                 log_level=logging.INFO,
                 param_names=None,
                 num_live_points=1000,
                 seed=0,
                 use_gpu=False,
                 device='cuda',
                 mesh=None):
        # The sampling unit cube is [-1, 1]^d; ``transform`` maps it to
        # physical space.
        prior = UniformPrior(x_dim, -1.0, 1.0)
        prior.seed(seed)
        self.sampler = 'nested'
        # Run diagnostics (populated by run()). The birth threshold of the
        # initial live set is -inf for a prior-seeded run.
        self.insertion_ranks = np.empty(0, dtype=np.int64)
        self.insertion_statistic = None
        self.insertion_p_value = None
        self.insertion_rolling_p_value = None
        self.logzerr_bootstrap = None
        self.thread_slots = None
        self.saved_u = None
        self._birth_floor = -np.inf
        super().__init__(
            x_dim, loglike, transform=transform, prior=prior,
            append_run_num=append_run_num, hidden_dim=hidden_dim,
            num_slow=num_slow, num_derived=num_derived,
            batch_size=batch_size, flow=flow,
            num_blocks=num_blocks, num_layers=num_layers,
            learning_rate=learning_rate, log_dir=log_dir, resume=resume,
            base_dist=base_dist, scale=scale, trainer=trainer,
            transform_prior=False, oversample_rate=oversample_rate,
            log_level=log_level, param_names=param_names, seed=seed,
            use_gpu=use_gpu, device=device, mesh=mesh)
        self.num_live_points = num_live_points
        self._save_params({'num_live_points': num_live_points})
        self.logger.info('Num live points [%d]' % self.num_live_points)
        if self.logs is not None:
            with open(os.path.join(self.logs['results'], 'results.csv'),
                      'w') as f:
                csv.writer(f).writerow(
                    ['step', 'acceptance', 'min_ess', 'max_ess',
                     'jump_distance', 'scale', 'loglstar', 'logz',
                     'fraction_remain', 'ncall'])

    def prewarm(self, strategy=None, max_iters_per_method=2, **run_kwargs):
        """Pay a run's one-time costs before ``run()`` does: one bounded
        throwaway run per strategy method (``strategy=[method]``,
        ``max_iters_per_method`` iterations, each in a temporary directory
        removed afterwards) on fresh samplers built from this sampler's
        constructor arguments, its likelihood and transform. Pass the
        ``run_kwargs`` you will pass to ``run()``. On a GPU the libraries a
        run loads at first use (the three kernels' and the host runtime's)
        are built first, side by side, one ``nvcc`` or ``g++`` process
        each, where the throwaway runs would build them one after another
        (the spline kernels' too when the flow does not use them).

        What carries over to this sampler's ``run()``: the kernel
        libraries, built by ``nvcc`` (the spline inverse, ``consume_pool``,
        the spline coupling's training pair) and ``g++`` (the host runtime)
        into the build directory and loaded in this process; the CUDA
        context, the cuBLAS handle and the caching allocator's pool, for
        the process. What does not: each ``Trainer`` captures its own CUDA
        graphs of the training step, and each flow packs its own kernel
        constants.

        This sampler is untouched: its generator and counters are not
        drawn from or advanced, and no global torch generator is used, so
        its ``run()`` equals that of a twin that never prewarmed. The user
        likelihood is called by the throwaway runs, and the kernels' launch
        counters (``spline_inverse.launches``, ``consume_pool.launches``)
        and the runtime's ``native_calls`` advance by theirs. ``device``
        and ``mesh`` pass through: a prewarm on the card warms the card,
        and under a mesh every rank calls it. A custom ``base_dist`` is
        not passed on.

        Returns {method: wall_seconds}, each method logged."""
        import inspect
        import shutil
        import tempfile

        strategy = list(strategy or ['rejection_prior', 'mcmc'])
        unknown = [m for m in strategy if m not in _METHODS]
        if unknown:
            raise ValueError('unknown strategy method(s) %s; choose from %s'
                             % (unknown, list(_METHODS)))
        kwargs = dict(run_kwargs)
        kwargs.pop('strategy', None)
        kwargs.pop('max_iters', None)
        # The throwaway samplers take every constructor argument of this
        # one (the constructor's signature, intersected with what was
        # captured) but its run's identity: directories, seed, resume and
        # logging.
        sig_params = set(inspect.signature(type(self).__init__).parameters)
        override = {'self', 'x_dim', 'loglike', 'transform', 'prior',
                    'trainer', 'base_dist', 'log_dir', 'append_run_num',
                    'resume', 'seed', 'log_level', 'mesh',
                    'num_live_points'}
        ctor = {k: v for k, v in self._init_args.items()
                if k in sig_params - override}
        # A sampler and its trainer set their module's logger to their own
        # level when built: this sampler's loggers are put back after each
        # throwaway run.
        loggers = [logging.getLogger(name) for name in (
            'nnest_torch.samplers.base', 'nnest_torch.training.trainer')]
        kept = [(lg, lg.level, lg.handlers[:]) for lg in loggers]
        if self.device.type == 'cuda':
            from concurrent.futures import ThreadPoolExecutor

            from nnest_torch.ops import (consume_pool, spline_coupling,
                                         spline_inverse)
            t0 = time.time()
            with ThreadPoolExecutor(4) as pool:
                for job in [pool.submit(m.load_library) for m in (
                        spline_inverse, consume_pool, spline_coupling,
                        runtime)]:
                    job.result()
            self.logger.info('Kernel and runtime libraries ready in %.1f s'
                             % (time.time() - t0))
        walls = {}
        tmp = tempfile.mkdtemp(prefix='nnest_prewarm_')
        try:
            for m in strategy:
                t0 = time.time()
                try:
                    s = type(self)(
                        self.x_dim, self._user_loglike,
                        transform=self._transform_fn,
                        num_live_points=self.num_live_points,
                        log_dir=os.path.join(tmp, m), append_run_num=False,
                        resume=False, log_level=logging.WARNING, seed=0,
                        mesh=self.mesh, **ctor)
                    s.run(strategy=[m], max_iters=max_iters_per_method,
                          **kwargs)
                finally:
                    for lg, level, handlers in kept:
                        lg.setLevel(level)
                        lg.handlers[:] = handlers
                walls[m] = round(time.time() - t0, 1)
                self.logger.info('Prewarmed %r in %.1f s' % (m, walls[m]))
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        return walls

    def run(self, *args, **kwargs):
        """Run the sampler; the arguments are :meth:`_run_impl`'s. This
        wrapper closes the progress bar when the run raises (a likelihood's
        exception, a keyboard interrupt), which would otherwise garble the
        log lines that follow. Under a collecting ``torch.profiler`` the run
        records its spans and counters (``utils/profiling.py``)."""
        self._run_pbar = None
        try:
            with (recording() if profiler_collecting()
                  else contextlib.nullcontext()), span('run'):
                return self._run_impl(*args, **kwargs)
        finally:
            if self._run_pbar is not None:
                self._run_pbar.close()
                self._run_pbar = None

    def _run_impl(self,
            strategy=None,
            mcmc_steps=0,
            mcmc_num_chains=None,
            mcmc_dynamic_step_size=True,
            max_iters=1000000,
            update_interval=None,
            log_interval=None,
            dlogz=0.5,
            train_iters=500,
            volume_switch=-1.0,
            step_size=0.0,
            jitter=-1.0,
            rejection_cache_interval=10,
            rejection_enlargement_factor=1.1,
            rejection_batch_size=512,
            rejection_max_trials=65536,
            rejection_adapt_trials=True,
            retrain_nll_threshold=0.5,
            mcmc_gen_batch=8,
            mcmc_speculate=False,
            mcmc_adapt='cov',
            rejection_gen_batch=8,
            slice_steps=0,
            slice_width=1.0,
            slice_max_expand=4,
            slice_max_shrink=10,
            slice_adapt='cov',
            init_points=None,
            birth_floor=None,
            logl_ceiling=None,
            show_progress=False):
        """Run to ``dlogz`` (or ``max_iters``). ``mcmc_gen_batch`` and
        ``rejection_gen_batch`` (integers >= 1) are the pool generations a
        dispatch runs and ``mcmc_speculate`` (a bool, in effect with a
        ``retrain_nll_threshold``) lets the Metropolis and slice batches run
        past retrain boundaries; none of them changes the results (module
        docstring). ``show_progress`` shows a tqdm bar. The dynamic-batch hooks
        (``samplers/dynamic.py``) default to a plain prior-seeded run:
        ``init_points`` a dict of live points already uniform within
        {logl > birth_floor} (``u`` (num_live_points, x_dim), ``logl``,
        optionally ``v`` and ``derived``), taken without evaluating them
        again;
        ``birth_floor`` the batch's birth threshold (recorded in
        ``threads.npz``); ``logl_ceiling`` ends the run once every live
        point exceeds it."""
        if birth_floor is not None:
            self._birth_floor = float(birth_floor)
        if strategy is None or len(strategy) == 0:
            strategy = ['rejection_prior', 'mcmc']
        unknown = [m for m in strategy if m not in _METHODS]
        if unknown:
            raise ValueError('unknown strategy method(s) %s; choose from %s'
                             % (unknown, list(_METHODS)))
        if mcmc_adapt not in ('cov', 'iso'):
            raise ValueError("mcmc_adapt must be 'cov' or 'iso'")
        for name, value in (('mcmc_gen_batch', mcmc_gen_batch),
                            ('rejection_gen_batch', rejection_gen_batch)):
            if not isinstance(value, (int, np.integer)) or \
                    isinstance(value, bool) or value < 1:
                raise ValueError('%s must be an integer >= 1, got %r'
                                 % (name, value))
        if not isinstance(mcmc_speculate, (bool, np.bool_)):
            raise ValueError('mcmc_speculate must be a bool, got %r'
                             % (mcmc_speculate,))

        if update_interval is None:
            update_interval = max(1, round(0.5 * self.num_live_points))
        else:
            update_interval = round(update_interval)
            if update_interval < 1:
                raise ValueError('update_interval must be >= 1')
        if log_interval is None:
            log_interval = max(1, round(0.2 * self.num_live_points))
        else:
            log_interval = round(log_interval)
            if log_interval < 1:
                raise ValueError('log_interval must be >= 1')
        if mcmc_num_chains is None:
            # 10 chains (the reference default) on the CPU; a GPU batches
            # wider chain sets for the same wall time.
            mcmc_num_chains = (10 if self.device.type == 'cpu'
                               else (256 if self.x_dim >= 8 else 128))
        if mcmc_steps <= 0:
            mcmc_steps = 5 * self.x_dim
            if self.x_dim >= 40:
                # The JAX package measured a +0.08-nat evidence systematic
                # on the 50-D Gaussian at 5*d steps that vanishes at 10*d
                # (BENCHMARKS.md round 5); logzerr_adjusted covers it.
                self.logger.info(
                    'mcmc_steps defaulted to 5*x_dim = %d. At x_dim >= '
                    '~40 this budget leaves a measured ~+0.1-nat '
                    'evidence systematic (endpoint-start correlation; '
                    'BENCHMARKS.md round 5) — mcmc_steps=%d removes it '
                    'at 2x the likelihood cost.'
                    % (mcmc_steps, 10 * self.x_dim))
        if step_size <= 0.0:
            step_size = 1.0 / self.x_dim ** 0.5
        if slice_steps <= 0:
            # one slice move decorrelates along one latent direction: ~2
            # passes over the basis
            slice_steps = 2 * self.x_dim
        if slice_adapt not in ('cov', 'iso'):
            raise ValueError("slice_adapt must be 'cov' or 'iso'")
        # Likelihood calls per accept of the downstream kernel when it is
        # 'slice': each step pays ~1 shrink hit and up to max_expand
        # stepping-out probes. The rejection phases expire past it.
        slice_calls = slice_steps * (1 + slice_max_expand)
        # Speculation wins only through the NLL retrain gate: without one
        # every boundary retrains and voids what was prefetched past it.
        mcmc_speculate = bool(mcmc_speculate
                              and retrain_nll_threshold is not None)
        rejection_max_trials = max(int(rejection_max_trials),
                                   rejection_batch_size)
        self.logger.info('MCMC steps [%d]' % mcmc_steps)
        self.logger.info('Initial scale [%5.4f]' % step_size)
        self.logger.info('Volume switch [%5.4f]' % volume_switch)

        # a previous run() of this sampler may still be writing
        self._drain_io()
        state = self._load_checkpoint()
        if state is not None and init_points is not None:
            raise ValueError(
                'init_points is for fresh dynamic batch runs; this log_dir '
                'has a resumable checkpoint (use resume=False or a fresh '
                'log_dir)')
        if state is not None:
            it = state['it']
            active_u, active_v = state['active_u'], state['active_v']
            active_logl = state['active_logl']
            active_derived = state['active_derived']
            saved_v, saved_logl = state['saved_v'], state['saved_logl']
            saved_logwt, saved_slots = state['saved_logwt'], state['slots']
            saved_u = state['saved_u']
            logz, h = state['logz'], state['h']
            logvol, fraction_remain = state['logvol'], state['fraction_remain']
            expired = list(state['expired'])
            controller, pool_state = state['controller'], state['pool']
            insertion_ranks = list(state['insertion_ranks'])
            self.logger.info('Resumed from checkpoint [%d]%s' % (
                it, ' (bit-exact)' if controller is not None else ''))
        else:
            if init_points is not None:
                # A dynamic batch: live points the caller refreshed (and
                # paid the likelihood calls of) within {logl > birth_floor}.
                active_u = np.array(init_points['u'], dtype=np.float64)
                if active_u.shape != (self.num_live_points, self.x_dim):
                    raise ValueError(
                        'init_points u must be (num_live_points, x_dim)')
                active_v = np.array(init_points['v'] if 'v' in init_points
                                    else self.transform(active_u),
                                    dtype=np.float64)
                active_logl = np.array(init_points['logl'], dtype=np.float64)
                active_derived = np.array(
                    init_points['derived'] if 'derived' in init_points
                    else np.zeros((self.num_live_points, self.num_derived)),
                    dtype=np.float64).reshape(self.num_live_points, -1)
                if not np.all(active_logl > self._birth_floor):
                    raise ValueError('init_points logl must all exceed '
                                     'birth_floor')
            else:
                active_u = np.asarray(self._user_prior.sample(
                    self.num_live_points), dtype=np.float64)
                active_v = self.transform(active_u)
                active_logl, active_derived = self.loglike(active_u)
            self.logger.info('Step [0] max logl [%5.4e] vol [1.0] ncalls '
                             '[%d]' % (np.max(active_logl), self.total_calls))
            saved_v, saved_logl, saved_logwt, saved_slots = [], [], [], []
            saved_u = []
            h = 0.0
            logz = -1e300
            logvol = float(np.log(1.0 - np.exp(-1.0 / self.num_live_points)))
            fraction_remain = 1.0
            it = 0
            expired = []
            controller = pool_state = None
            insertion_ranks = []
        # fresh mixing history per run() call
        for name in ('_mix_ratios', '_mix_ratios_eig', '_latent_conds',
                     '_mix_rels', '_cond_rels', '_cond_infl'):
            setattr(self, name, [])

        current_method = next(m for m in strategy if m not in expired)
        first_time = True
        last_trained_it = -1
        need_pool = True
        pool = None
        pool_pos = 0
        # prefetched generations: Metropolis or slice (buffer entries of
        # Sampler._gens_to_buffer), prior and flow rejection (compact dicts
        # of _compact_rejection_gen)
        mcmc_buf, prior_buf, flow_buf = [], [], []
        self._spec_losses = 0
        env_gens = 0   # flow-rejection generations since the envelope
        ncs = []
        mean_calls = 0.0
        mcmc_scale = step_size
        accept_point = True
        cur_trials = int(rejection_batch_size)
        trials_target = max(16, self.num_live_points // 8)
        last_io_it = it   # iteration of the last checkpoint
        if controller is not None:
            # Bit-exact resume: the ladder, envelope and proposal state as
            # the uninterrupted run had it when the checkpoint was written.
            current_method = controller['current_method']
            first_time = controller['first_time']
            last_trained_it = controller['last_trained_it']
            env_gens = controller['env_gens']
            self._max_log_det_j = controller['max_log_det_j']
            self._max_r = controller['max_r']
            ncs = list(controller['ncs'])
            mean_calls = controller['mean_calls']
            mcmc_scale = controller['mcmc_scale']
            cur_trials = controller['cur_trials']
            last_io_it = controller['last_io_it']
        if pool_state is not None:
            need_pool = pool_state['need_pool']
            pool = pool_state['pool']
            pool_pos = pool_state['pool_pos']
            # checkpoints written before the prefetch have no buffers
            mcmc_buf = [(g[0], g[1], g[2],
                         None if g[3] is None else torch.as_tensor(g[3]))
                        for g in pool_state.get('mcmc_buf', [])]
            prior_buf = list(pool_state.get('prior_buf', []))
            flow_buf = list(pool_state.get('flow_buf', []))

        def controller_snapshot():
            return {
                'current_method': current_method,
                'expired': list(expired),
                'first_time': bool(first_time),
                'last_trained_it': int(last_trained_it),
                'env_gens': int(env_gens),
                'max_log_det_j': (None if self._max_log_det_j is None
                                  else float(self._max_log_det_j)),
                'max_r': None if self._max_r is None else float(self._max_r),
                'ncs': [float(x) for x in ncs],
                'mean_calls': float(mean_calls),
                'mcmc_scale': float(mcmc_scale),
                'cur_trials': int(cur_trials),
                'last_io_it': int(last_io_it),
            }

        def pool_snapshot():
            return {'need_pool': bool(need_pool), 'pool': pool,
                    'pool_pos': int(pool_pos), 'mcmc_buf': list(mcmc_buf),
                    'prior_buf': list(prior_buf),
                    'flow_buf': list(flow_buf)}

        # counts, and host wall seconds of the phases (each ends in a device
        # to host copy, so the clock covers the device work)
        self.run_stats = {'trainings': 0, 'retrains_skipped': 0,
                          'train_s': 0.0, 'train_epochs': 0,
                          'checkpoints': 0, 'checkpoint_s': 0.0}
        for method, stem in _STAT_KEY.items():
            self.run_stats[stem + '_generations'] = 0
            self.run_stats[stem + '_dispatches'] = 0
            self.run_stats[stem + '_s'] = 0.0
            if method not in ('mcmc', 'slice'):
                # trial count -> [generations, candidates passed]
                self.run_stats[stem + '_by_trials'] = {}

        def checkpoint():
            if self.logs is None:
                return
            with self.timers.time('checkpoint_io') as phase:
                self._write_checkpoint(
                    it, active_u, active_v, active_logl, active_derived,
                    saved_v, saved_logl,
                    saved_logwt, saved_slots, saved_u, logz, h, logvol,
                    fraction_remain, strategy, expired, controller_snapshot(),
                    pool_snapshot(), insertion_ranks)
            self.run_stats['checkpoint_s'] += phase.seconds
            self.run_stats['checkpoints'] += 1

        if state is None:
            checkpoint()

        pbar = None
        if show_progress and self.single_or_primary_process:
            try:
                from tqdm import tqdm
            except ImportError:
                tqdm = None
            if tqdm is not None:
                pbar = self._run_pbar = tqdm(initial=it, unit='it',
                                             desc='nested',
                                             dynamic_ncols=True)

        # closed after the loop; on an exception the run span closes it
        loop = span('loop')
        loop.__enter__()
        while fraction_remain > dlogz and it <= max_iters and (
                logl_ceiling is None
                or float(np.min(active_logl)) <= logl_ceiling):
            worst = int(np.argmin(active_logl))
            logwt = logvol + active_logl[worst]
            loglstar = float(active_logl[worst])
            expected_vol = np.exp(-it / self.num_live_points)

            if accept_point:
                # Evidence and information update.
                logz_new = np.logaddexp(logz, logwt)
                h = (np.exp(logwt - logz_new) * active_logl[worst]
                     + np.exp(logz - logz_new) * (h + logz) - logz_new)
                logz = logz_new
                saved_v.append(self._saved_row(active_v[worst],
                                               active_derived[worst]))
                saved_logwt.append(logwt)
                saved_logl.append(active_logl[worst])
                if saved_slots is not None:
                    # The live-set slot of each death: the thread lineage
                    # the bootstrap error resamples.
                    saved_slots.append(worst)
                if saved_u is not None:
                    saved_u.append(np.array(active_u[worst], copy=True))
                accept_point = False

            # Strategy ladder: the first method not expired.
            old_method = current_method
            current_method = next(m for m in strategy if m not in expired)
            if current_method != old_method:
                need_pool = True
                cur_trials = int(rejection_batch_size)
            # The downstream within-shell kernel ('mcmc' or 'slice'; the
            # first not expired) and its likelihood calls per accept.
            mcmc_like = next((m for m in strategy if m in ('mcmc', 'slice')
                              and m not in expired), None)
            switch_calls = (slice_calls if mcmc_like == 'slice'
                            else mcmc_steps)

            if current_method != 'rejection_prior' and (
                    first_time or (it % update_interval == 0
                                   and it != last_trained_it)):
                last_trained_it = it
                # Conditional retrain: the latent kernels are exact for any
                # fixed flow, so when the flow still fits the live set (mean
                # NLL within retrain_nll_threshold of the last training's
                # best validation NLL) the retrain is skipped. The < 1e29
                # guard excludes the trainer's "never improved" sentinel.
                retrain = True
                if (not first_time and retrain_nll_threshold is not None
                        and self.trainer.best_validation_loss is not None
                        and self.trainer.best_validation_loss < 1e29):
                    with self.timers.time('retrain_check'):
                        nll_now = -float(np.mean(self.trainer.log_probs(
                            active_u.astype(np.float32), to_numpy=True)))
                    retrain = not (nll_now < self.trainer.best_validation_loss
                                   + retrain_nll_threshold)
                if retrain:
                    if mcmc_buf:
                        # A lost speculation: the buffered generations were
                        # made with the flow this retrain replaces, where
                        # one generation a dispatch would make them after
                        # it. Drop them and set the generator back to the
                        # first one's state, so they are made again from
                        # the same numbers. The generation being consumed
                        # stays: that route made it before the retrain too.
                        state0 = mcmc_buf[0][3]
                        if state0 is None:
                            raise RuntimeError(
                                'prefetched generations span a retrain '
                                'boundary but carry no generator state (a '
                                'batch run without speculation; did '
                                'update_interval change across a resume?)')
                        self._rewind_generator(state0)
                        self._spec_losses += len(mcmc_buf)
                        mcmc_buf = []
                    epochs0 = getattr(self.trainer, 'total_iters', 0)
                    with self.timers.time('flow_train') as phase:
                        self.trainer.train(active_u.astype(np.float32),
                                           max_iters=train_iters,
                                           jitter=jitter)
                    self.run_stats['train_s'] += phase.seconds
                    self.run_stats['trainings'] += 1
                    self.run_stats['train_epochs'] += getattr(
                        self.trainer, 'total_iters', 0) - epochs0
                    first_time = False
                    # The envelope is a function of the flow: a retrain
                    # invalidates it.
                    self._max_log_det_j = None
                else:
                    self.run_stats['retrains_skipped'] += 1

            if need_pool:
                stem = _STAT_KEY[current_method]
                # closed after the refill, as the loop span is
                refill = timed('pool', method=current_method)
                refill.__enter__()
                if current_method in ('mcmc', 'slice'):
                    is_slice = current_method == 'slice'
                    adapt_cov = (slice_adapt if is_slice
                                 else mcmc_adapt) == 'cov'
                    # 'mcmc' and 'slice' share the buffer: neither
                    # expires, so only the first in the strategy runs.
                    use_batch = self.mesh is None and mcmc_gen_batch > 1
                    if use_batch and not mcmc_buf:
                        use_batch = _f32_exact(active_logl)
                    if use_batch and not mcmc_buf:
                        self.run_stats[stem + '_dispatches'] += 1
                        if is_slice:
                            mcmc_buf = self._slice_generations_batch(
                                slice_steps, active_u, active_logl,
                                active_derived, mcmc_num_chains,
                                slice_width, it, update_interval,
                                mcmc_gen_batch, max_expand=slice_max_expand,
                                max_shrink=slice_max_shrink,
                                speculate=mcmc_speculate,
                                adapt_cov=adapt_cov)
                        else:
                            mcmc_buf = self._mcmc_generations_batch(
                                mcmc_steps, active_u, active_logl,
                                active_derived, mcmc_num_chains, step_size,
                                it, update_interval, mcmc_gen_batch,
                                dynamic_step_size=mcmc_dynamic_step_size,
                                speculate=mcmc_speculate,
                                adapt_cov=adapt_cov)
                    if use_batch and mcmc_buf:
                        out, g_lstar, g_it, _ = mcmc_buf.pop(0)
                        _check_sync(current_method, g_it, g_lstar, it,
                                    loglstar)
                        u_f, logl_f, d_f, moved, mcmc_scale, _, _ = \
                            self._consume_endpoint_out(
                                out,
                                mix_null=(
                                    slice_mix_null(slice_steps, self.x_dim)
                                    if is_slice else metropolis_mix_null(
                                        mcmc_steps, self.x_dim,
                                        adapt_cov=adapt_cov)),
                                cond_null=latent_cond_null(
                                    self.x_dim, mcmc_num_chains),
                                cond_inflates=not is_slice)
                    elif is_slice:
                        self.run_stats[stem + '_dispatches'] += 1
                        u_f, logl_f, d_f, moved, mcmc_scale, _, _ = \
                            self._slice_sample_live(
                                slice_steps, active_u, active_logl,
                                mcmc_num_chains, loglstar, slice_width,
                                max_expand=slice_max_expand,
                                max_shrink=slice_max_shrink,
                                adapt_cov=adapt_cov,
                                active_derived=active_derived)
                    else:
                        self.run_stats[stem + '_dispatches'] += 1
                        u_f, logl_f, d_f, moved, mcmc_scale, _, _ = \
                            self._mcmc_sample_live(
                                mcmc_steps, active_u, active_logl,
                                mcmc_num_chains, loglstar, step_size,
                                dynamic_step_size=mcmc_dynamic_step_size,
                                adapt_cov=adapt_cov,
                                active_derived=active_derived)
                    # Chain endpoints are the candidates: a chain that
                    # never moved contributes nothing.
                    pool = {'u': u_f[moved], 'logl': logl_f[moved],
                            'derived': d_f[moved],
                            'stats': self._last_kernel_stats}
                else:
                    # The rejection batch runners stop before any
                    # generation the host might not run next (module
                    # docstring); the gate and the buffers as for 'mcmc'.
                    served = False
                    use_batch = (self.mesh is None and rejection_gen_batch > 1
                                 and current_method != 'density_flow')
                    buf = (prior_buf if current_method == 'rejection_prior'
                           else flow_buf)
                    if use_batch and not buf:
                        use_batch = _f32_exact(active_logl)
                    can_double = cur_trials * 2 <= rejection_max_trials
                    can_halve = cur_trials >= 2 * rejection_batch_size
                    max_gens = min(rejection_gen_batch,
                                   max(1, 2 ** 18 // cur_trials))
                    recompute = (self._max_log_det_j is None
                                 or env_gens >= rejection_cache_interval)
                    if use_batch and not buf:
                        self.run_stats[stem + '_dispatches'] += 1
                        if current_method == 'rejection_prior':
                            # two iterations before the volume switch can
                            # fire; the expiry proxy at 0.9x its threshold
                            it_stop = (int(np.ceil(-self.num_live_points
                                                   * np.log(volume_switch)))
                                       - 2 if volume_switch > 0 else 2 ** 30)
                            thr = (0.9 * switch_calls
                                   if volume_switch < 0
                                   and mcmc_like is not None
                                   else np.float32(1e30))
                            gens = self._rejection_prior_generations_batch(
                                active_u, active_logl, active_derived, it,
                                it_stop, ncs, thr, trials_target, cur_trials,
                                max_gens, rejection_adapt_trials, can_double,
                                can_halve)
                        else:
                            thr = (0.9 * switch_calls
                                   if mcmc_like is not None
                                   else np.float32(1e30))
                            env_valid = self._max_log_det_j is not None
                            gens = self._rejection_flow_generations_batch(
                                active_u, active_logl, active_derived, it,
                                update_interval, ncs, thr, trials_target,
                                env_valid, env_gens,
                                self._max_log_det_j if env_valid else 0.0,
                                self._max_r if env_valid else 0.0,
                                rejection_cache_interval,
                                rejection_enlargement_factor, cur_trials,
                                max_gens, rejection_adapt_trials,
                                can_double, can_halve)
                        buf.extend(self._compact_rejection_gen(
                            out['x'], out['logl'],
                            out.get('derived', np.zeros(
                                (cur_trials, self.num_derived))),
                            out['ok'], out.get('n_evals'), out.get('mld'),
                            out.get('mr'), g_lstar, g_it, cur_trials)
                            for out, g_lstar, g_it, _ in gens)
                    if use_batch and buf:
                        g = buf.pop(0)
                        _check_sync(current_method, g['it'], g['loglstar'],
                                    it, loglstar, g['trials'], cur_trials)
                        nev = (g['trials'] if g['nev'] is None
                               else g['nev'])
                        if g['mld'] is not None:
                            self._max_log_det_j = g['mld']
                            self._max_r = g['mr']
                        self.total_calls += nev
                        nc = (nev / max(g['n_ok'], 1) if g['n_ok'] > 0
                              else max(nev, 1))
                        s, ll, ds = g['s'], g['ll'], g['ds']
                        served = True
                    elif current_method == 'rejection_prior':
                        self.run_stats[stem + '_dispatches'] += 1
                        with self.timers.time('candidate_kernel'):
                            s, ll, ds, nc = self._rejection_prior_sample(
                                loglstar, num_trials=cur_trials)
                    elif current_method == 'rejection_flow':
                        # A fresh envelope after a retrain or every
                        # rejection_cache_interval generations; in between
                        # the live set's values are max-folded into it.
                        self.run_stats[stem + '_dispatches'] += 1
                        with self.timers.time('candidate_kernel'):
                            s, ll, ds, nc = self._rejection_flow_sample(
                                active_u, loglstar, enlargement_factor=(
                                    rejection_enlargement_factor),
                                cache=not recompute, num_trials=cur_trials)
                    else:
                        self.run_stats[stem + '_dispatches'] += 1
                        with self.timers.time('candidate_kernel'):
                            s, ll, ds, nc = self._density_sample(
                                loglstar, num_trials=cur_trials)
                    rung = self.run_stats[stem + '_by_trials'].setdefault(
                        cur_trials, [0, 0])
                    rung[0] += 1
                    rung[1] += int(s.shape[0])
                    if current_method == 'rejection_flow':
                        env_gens = 0 if recompute else env_gens + 1
                    # The trial ladder and the efficiency window, mirrored
                    # by LatentKernels._ladder_window_update: a change to
                    # one must be made in the other.
                    if rejection_adapt_trials:
                        # Power-of-two trial ladder: keep candidates per
                        # generation near trials_target as the shell
                        # shrinks.
                        n_ok = int(s.shape[0])
                        if n_ok < trials_target // 2 and can_double:
                            cur_trials *= 2
                        elif n_ok > trials_target * 2 and can_halve:
                            cur_trials //= 2
                    # Efficiency window; each generation contributes at
                    # most 5 entries so the switch averages several
                    # generations.
                    ncs.extend([nc] * min(max(s.shape[0], 1), 5))
                    mean_calls = (float(np.mean(ncs[-20:])) if len(ncs) > 20
                                  else 0.0)
                    switch = (mean_calls > switch_calls
                              and mcmc_like is not None)
                    if current_method == 'rejection_prior':
                        switch = (0 <= volume_switch > expected_vol) or (
                            volume_switch < 0 and switch)
                    if switch:
                        self.logger.info('%s no longer efficient, switching '
                                         'sampling method' % current_method)
                        expired.append(current_method)
                        ncs = []
                    # The stop rules keep a batch from outrunning a ladder
                    # or expiry decision; a leftover here would mean numbers
                    # drawn for generations this route would not run.
                    if served and buf and (switch
                                           or buf[0]['trials'] != cur_trials):
                        raise RuntimeError(
                            'rejection generation prefetch outran a ladder '
                            'or expiry decision (switch=%s, trials %d -> %d)'
                            % (switch, buf[0]['trials'], cur_trials))
                    pool = {'u': s, 'logl': ll, 'derived': ds}
                refill.__exit__(None, None, None)
                self.run_stats[stem + '_s'] += refill.seconds
                self.run_stats[stem + '_generations'] += 1
                pool_pos = 0
                need_pool = False

            # Consume the candidate pool: candidates in order against the
            # current worst point; the first above it replaces it.
            if pool is not None:
                u = pool['u']
                n_rows = u.shape[0]
                while pool_pos < n_rows:
                    ib = pool_pos
                    pool_pos += 1
                    if pool_pos == n_rows:
                        need_pool = True
                    if pool['logl'][ib] > loglstar:
                        # Insertion rank of the replacement among the
                        # surviving n_live - 1 points (the -1 excludes the
                        # dead point): Uniform{0..n_live-1} under exact
                        # constrained sampling.
                        insertion_ranks.append(int(
                            np.sum(active_logl < pool['logl'][ib])) - 1)
                        active_u[worst] = u[ib, :]
                        active_v[worst] = self.transform(active_u[worst])[0]
                        active_logl[worst] = pool['logl'][ib]
                        if self.num_derived:
                            active_derived[worst] = pool['derived'][ib]
                        accept_point = True
                        break
                if n_rows == 0:
                    need_pool = True

            if accept_point:
                # Shrink the prior volume; termination on the remaining
                # evidence fraction.
                logvol -= 1.0 / self.num_live_points
                logz_remain = np.max(active_logl) - it / self.num_live_points
                fraction_remain = np.logaddexp(logz, logz_remain) - logz
                it += 1
                if pbar is not None:
                    pbar.update(1)
                    if it % log_interval == 0:
                        pbar.set_postfix(logz='%.3f' % logz,
                                         loglstar='%.3g' % loglstar,
                                         ncall=self.total_calls,
                                         refresh=False)
                if getattr(self.trainer, 'writes_events', False):
                    # the values bound now: the writer may run this later
                    self._submit_io(lambda v=float(logz), step=it:
                                    self.trainer.log_scalar('logz', v, step))
                if it % log_interval == 0:
                    self.logger.info(
                        'Step [%d] loglstar [%5.4e] maxlogl [%5.4e] logz '
                        '[%5.4e] vol [%6.5e] ncalls [%d] scale [%5.4f] mean '
                        'calls [%5.4f]' % (
                            it, loglstar, np.max(active_logl), logz,
                            expected_vol, self.total_calls, mcmc_scale,
                            mean_calls))
                    self._append_results_row(it, loglstar, logz,
                                             fraction_remain, mcmc_scale,
                                             pool)
                    # Checkpoints are O(saved rows): spacing keyed to the
                    # last write (~10% growth) keeps their total cost
                    # O(n log n).
                    if it - last_io_it >= max(log_interval,
                                              last_io_it // 10):
                        last_io_it = it
                        checkpoint()
                        if self.logs is not None:
                            # fresh host arrays: the writer rewrites
                            # chain.txt from them; the final write, after
                            # the writer is closed, comes last
                            self.samples = np.asarray(saved_v)
                            self.weights = np.exp(np.asarray(saved_logwt)
                                                  - logz)
                            self.loglikes = np.asarray(saved_logl)
                            with self.timers.time('chain_io'):
                                self._submit_io(
                                    lambda v=self.samples, ll=self.loglikes,
                                    w=self.weights:
                                    self._save_samples(v, ll, weights=w))

        loop.__exit__(None, None, None)
        if pbar is not None:
            pbar.close()
            self._run_pbar = None
        self.run_stats['speculation_losses'] = self._spec_losses
        self.run_stats['generations_discarded'] = (
            len(mcmc_buf) + len(prior_buf) + len(flow_buf))

        # Integrate the remaining live points.
        logvol = (-len(saved_v) / self.num_live_points
                  - np.log(self.num_live_points))
        for i in range(self.num_live_points):
            logwt = logvol + active_logl[i]
            logz_new = np.logaddexp(logz, logwt)
            h = (np.exp(logwt - logz_new) * active_logl[i]
                 + np.exp(logz - logz_new) * (h + logz) - logz_new)
            logz = logz_new
            saved_v.append(self._saved_row(active_v[i], active_derived[i]))
            saved_logwt.append(logwt)
            saved_logl.append(active_logl[i])
            if saved_slots is not None:
                saved_slots.append(i)   # slot i's final point closes thread i
            if saved_u is not None:
                saved_u.append(np.array(active_u[i]))

        # the queued writes and the trainer's plots land (and the
        # TensorBoard writer is flushed) before the run's results are
        # declared
        with self.timers.time('checkpoint_io') as phase:
            self._close_io()
        self.run_stats['checkpoint_s'] += phase.seconds
        self._join_plots()
        self.run_stats['total_fast_calls'] = self.total_fast_calls
        self.logz = logz
        self.h = h
        self.logzerr = float(np.sqrt(h / self.num_live_points))
        self.niter = it + 1
        self.samples = np.asarray(saved_v)
        self.weights = np.exp(np.asarray(saved_logwt) - logz)
        self.loglikes = np.asarray(saved_logl)
        # the u-space points aligned with loglikes and thread_slots, final
        # live points included: the dynamic sampler seeds batches from them
        self.saved_u = (None if saved_u is None
                        else np.asarray(saved_u).reshape(-1, self.x_dim))
        self._diagnose(insertion_ranks, saved_logl, saved_slots)
        if self.logs is not None:
            self._write_results(saved_logl, self.saved_u)
            with open(os.path.join(self.logs['results'], 'final.csv'),
                      'w') as f:
                w = csv.writer(f)
                w.writerow(['niter', 'ncall', 'logz', 'logzerr', 'h'])
                w.writerow([it + 1, self.total_calls, logz, self.logzerr, h])
            self._save_samples(self.samples, self.loglikes,
                               weights=self.weights)
        self.logger.info(
            'niter: %d\n ncall: %d\n nsamples: %d\n logz: %6.3f +/- '
            '%6.3f\n h: %6.3f' % (it + 1, self.total_calls, len(saved_v),
                                  logz, self.logzerr, h))
        self._log_diagnostics()
        return self.logz

    @staticmethod
    def _compact_rejection_gen(x, ll, ds, ok, nev, mld, mr, loglstar, it,
                               trials):
        """One rejection generation of a batch in the form the host
        serves: the passing trials' rows ``s`` (x as it came), ``ll`` and
        ``ds`` (float64), and the scalars ``n_ok``, ``nev`` (the likelihood
        calls, None for prior rejection, which pays ``trials``), the
        envelope ``mld`` and ``mr`` (None for prior rejection), the
        generation's start ``loglstar`` and ``it``, and ``trials``. A few
        KB a generation, so the buffer rides in the checkpoints."""
        ok = np.asarray(ok)
        return {
            's': np.asarray(x)[ok],
            'll': np.asarray(ll, dtype=np.float64)[ok],
            'ds': np.asarray(ds, dtype=np.float64)[ok],
            'n_ok': int(ok.sum()),
            'nev': None if nev is None else int(nev),
            'mld': None if mld is None else float(mld),
            'mr': None if mr is None else float(mr),
            'loglstar': float(loglstar),
            'it': int(it),
            'trials': int(trials),
        }

    def _saved_row(self, v, derived):
        """A saved point: ``v``, then its derived values when
        ``num_derived`` > 0 (a copy either way)."""
        if self.num_derived:
            return np.concatenate((v, derived))
        return np.array(v, copy=True)

    # ----------------------------------------------------------- diagnostics

    def _diagnose(self, insertion_ranks, saved_logl, saved_slots):
        """The end-of-run diagnostics of the JAX package's run():
        insertion KS (whole run and rolling), thread-bootstrap logZ error,
        kernel mixing medians, ``logzerr_adjusted`` and the quality
        flags."""
        self.insertion_ranks = np.asarray(insertion_ranks, dtype=np.int64)
        self.insertion_statistic, self.insertion_p_value = insertion_ks(
            self.insertion_ranks, self.num_live_points)
        self.insertion_rolling_p_value, _ = rolling_insertion_ks(
            self.insertion_ranks, self.num_live_points)
        self.thread_slots = (None if saved_slots is None
                             else np.asarray(saved_slots, dtype=np.int64))
        self.logzerr_bootstrap = None
        if saved_slots is not None:
            with self.timers.time('diagnostics'):
                self.logzerr_bootstrap = bootstrap_logz_error(
                    np.asarray(saved_logl), self.thread_slots,
                    self.num_live_points)

        def median(values):
            return float(np.median(values)) if values else None

        self.mixing_min_ratio = median(self._mix_ratios)
        self.mixing_min_ratio_eig = median(self._mix_ratios_eig)
        self.latent_cond_median = median(self._latent_conds)
        self.mixing_rel_ratio = median(self._mix_rels)
        self.latent_cond_rel = median(self._cond_rels)
        # The calibrated single-run bar: logzerr x max(1/R^2, cond_rel),
        # applied at x_dim >= 8 only (the calibration domain).
        self.logzerr_adjusted = adjusted_logzerr(
            self.logzerr, self._mix_rels, self.x_dim,
            cond_rels=self._cond_infl)
        flags = []
        if (self.mixing_rel_ratio is not None and self.x_dim >= 8
                and self.mixing_rel_ratio < 0.7):
            flags.append('under_mixed')
        if (self.latent_cond_rel is not None and self.x_dim >= 8
                and self.latent_cond_rel > 2.0):
            flags.append('structural_anisotropy')
        if (self.insertion_p_value < 0.01
                or self.insertion_rolling_p_value < 0.01):
            flags.append('nonuniform_insertion')
        if self.logzerr_bootstrap is not None:
            rb = self.logzerr_bootstrap / max(self.logzerr, 1e-12)
            if rb > 2.0 or rb < 0.5:
                flags.append('bootstrap_mismatch')
        self.run_quality_flags = flags

    def _write_results(self, saved_logl, saved_u):
        """``insertion_ranks.npy``, ``threads.npz`` (death logl, thread
        slot and, where recorded, u of every point: with ``n_live`` and
        ``birth_floor`` the run's full (birth, death) record) and
        ``diagnostics.json``."""
        res = self.logs['results']
        np.save(os.path.join(res, 'insertion_ranks.npy'),
                self.insertion_ranks.astype(np.uint32))
        if self.thread_slots is not None:
            np.savez(os.path.join(res, 'threads.npz'),
                     logl=np.asarray(saved_logl, np.float64),
                     slots=self.thread_slots.astype(np.uint32),
                     n_live=np.int64(self.num_live_points),
                     birth_floor=np.float64(self._birth_floor),
                     **({} if saved_u is None
                        else {'u': np.asarray(saved_u, np.float64)}))
        with open(os.path.join(res, 'diagnostics.json'), 'w') as f:
            json.dump({
                'insertion_D': self.insertion_statistic,
                'insertion_p': self.insertion_p_value,
                'insertion_rolling_p': self.insertion_rolling_p_value,
                'logzerr': self.logzerr,
                'logzerr_bootstrap': self.logzerr_bootstrap,
                'n_ranks': int(self.insertion_ranks.size),
                'mixing_min_ratio': self.mixing_min_ratio,
                'mixing_min_ratio_eig': self.mixing_min_ratio_eig,
                'mixing_rel_ratio': self.mixing_rel_ratio,
                'latent_cond_median': self.latent_cond_median,
                'latent_cond_rel': self.latent_cond_rel,
                'n_mix_windows': len(self._mix_ratios),
                'logzerr_adjusted': self.logzerr_adjusted,
                'quality_flags': self.run_quality_flags,
            }, f)

    def _log_diagnostics(self):
        self.logger.info(
            'Insertion-index KS: D [%5.4f] p [%5.4g] rolling p [%5.4g] over '
            '[%d] ranks%s' % (
                self.insertion_statistic, self.insertion_p_value,
                self.insertion_rolling_p_value, self.insertion_ranks.size,
                ' — WARNING: non-uniform insertion ranks suggest '
                'under-mixed constrained sampling; increase mcmc_steps'
                if self.insertion_p_value < 0.01 else ''))
        if self.logzerr_bootstrap is not None:
            ratio = self.logzerr_bootstrap / max(self.logzerr, 1e-12)
            self.logger.info(
                'Bootstrap logZ error (thread-resampled): %5.4f vs '
                'sqrt(h/N) %5.4f (ratio %4.2f)%s' % (
                    self.logzerr_bootstrap, self.logzerr, ratio,
                    ' — WARNING: bootstrap error far from the analytic '
                    'bar; the quoted logZ uncertainty is mis-calibrated'
                    if ratio > 2.0 or ratio < 0.5 else ''))
        if self.mixing_rel_ratio is not None:
            self.logger.info(
                'Kernel mixing (eigenbasis start decorrelation relative to '
                'healthy null): [%4.2f] over [%d] generations%s' % (
                    self.mixing_rel_ratio, len(self._mix_rels),
                    ' — WARNING: the slowest latent direction decorrelates '
                    'far below what a whitened run achieves at this step '
                    'budget (curved degeneracy / unwhitened slow mode); '
                    'logzerr likely UNDER-covers — use logzerr_adjusted, '
                    'and prefer more steps'
                    if (self.mixing_rel_ratio < 0.7 and self.x_dim >= 8)
                    else ''))
            if self.latent_cond_rel is not None:
                self.logger.info(
                    'Latent structure (chain-start condition number '
                    'relative to the healthy MP-floor null): [%4.2f]%s' % (
                        self.latent_cond_rel,
                        ' — WARNING: the live set is collectively '
                        'anisotropic beyond what the flow whitens (curved '
                        'degeneracy); between-thread start correlation '
                        'inflates the true logZ scatter at ANY step count '
                        '— use logzerr_adjusted and validate with a seed '
                        'sweep'
                        if (self.latent_cond_rel > 2.0 and self.x_dim >= 8)
                        else ''))
            if self.logzerr_adjusted > 1.5 * self.logzerr:
                self.logger.info(
                    'Mixing-adjusted logZ error: %5.4f (= logzerr x '
                    'max(1/R^2, cond_rel) with R the relative eigenbasis '
                    'mixing ratio and cond_rel the relative latent '
                    'condition number, calibrated in BENCHMARKS.md rounds '
                    '4-5; quoted logzerr keeps the sqrt(h/N) convention)'
                    % self.logzerr_adjusted)
        self.logger.info(
            'Run quality: %s' % (
                'ok (no single-run diagnostic fired)'
                if not self.run_quality_flags
                else 'SUSPECT [%s] — see the warnings above; prefer '
                     'logzerr_adjusted and validate with a seed sweep'
                     % ', '.join(self.run_quality_flags)))
        phases = self.timers.summary()
        if phases:
            d = {k: round(v['total_s'], 2) for k, v in phases.items()}
            plot_s = getattr(self.trainer, 'plot_seconds', 0.0)
            if plot_s:
                d['train_plot'] = round(plot_s, 2)
            self.logger.info('Phase timers: %s' % json.dumps(d))

    # ----------------------------------------------------------- artifacts

    def _append_results_row(self, it, loglstar, logz, fraction_remain,
                            scale, pool):
        if self.logs is None:
            return
        acceptance, ess_min, ess_max, jump = 0.0, 0.0, 0.0, 0.0
        total = self.total_accepted + self.total_rejected
        if total > 0:
            acceptance = self.total_accepted / total
        if pool is not None and 'stats' in pool:
            # statistics over all chains of the last MCMC generation
            st = pool['stats']
            acceptance = st['acceptance']
            jump = st['mean_jump']
            ess_min = float(np.min(st['ess']))
            ess_max = float(np.max(st['ess']))
        with open(os.path.join(self.logs['results'], 'results.csv'),
                  'a') as f:
            csv.writer(f).writerow(
                [it, acceptance, ess_min, ess_max, jump, scale, loglstar,
                 logz, fraction_remain, self.total_calls])

    # ---------------------------------------------------------- checkpoints

    def _write_checkpoint(self, it, active_u, active_v, active_logl,
                          active_derived, saved_v, saved_logl, saved_logwt,
                          saved_slots, saved_u, logz, h, logvol,
                          fraction_remain, strategy, expired, controller,
                          pool_state, insertion_ranks):
        """One checkpoint: a snapshot here (copies of every array, the
        generator and trainer states, the counters), then the files on the
        background writer, in the order that makes a crash at any point
        recoverable: the live and dead arrays, then the exact state
        (temporary file, then ``os.replace``: always one whole snapshot,
        stamped with ``it``), then the ``checkpoint_<it>.txt`` marker. The
        cumulative ``saved_*`` files may run ahead of an older marker; the
        loader cuts them to its iteration."""
        ck = self.logs['checkpoint']
        live = {'active_u': np.array(active_u), 'active_v': np.array(active_v),
                'active_logl': np.array(active_logl),
                'active_derived': np.array(active_derived)}
        saved = {'saved_v': np.asarray(saved_v),
                 'saved_logl': np.asarray(saved_logl),
                 'saved_logwt': np.asarray(saved_logwt)}
        if saved_slots is not None:
            saved['saved_slots'] = np.asarray(saved_slots, dtype=np.uint32)
        if saved_u is not None:
            saved['saved_u'] = np.asarray(saved_u, np.float64).reshape(
                -1, self.x_dim)
        exact = {
            'it': int(it),
            'generator': self.generator.get_state(),
            'trainer': self.trainer.snapshot_state(),
            'controller': controller,
            'pool': _tensors(pool_state),
            'insertion_ranks': torch.as_tensor(insertion_ranks,
                                               dtype=torch.int64),
        }
        meta = {'logz': float(logz), 'h': float(h), 'logvol': float(logvol),
                'ncall': self.total_calls,
                'fraction_remain': float(fraction_remain),
                'strategy': list(strategy),
                'expired_strategies': list(expired),
                'total_accepted': self.total_accepted,
                'total_rejected': self.total_rejected,
                'total_fast_calls': self.total_fast_calls}

        def write():
            for name, a in live.items():
                np.save(os.path.join(ck, '%s_%d.npy' % (name, it)), a)
            for name, a in saved.items():
                np.save(os.path.join(ck, name + '.npy'), a)
            path = os.path.join(ck, EXACT_STATE)
            torch.save(exact, path + '.tmp')
            os.replace(path + '.tmp', path)
            with open(os.path.join(ck, 'checkpoint_%d.txt' % it), 'w') as f:
                json.dump(meta, f)

        self._submit_io(write)

    def _load_checkpoint(self):
        """The newest valid checkpoint of this run directory, or None (no
        resume asked, a fresh directory, or no usable checkpoint). A
        corrupt checkpoint falls back to the next older one. With more than
        one rank, rank 0's (the only one with a run directory) is
        broadcast with the generators and the trainer
        (:meth:`Sampler._broadcast_resume`)."""
        state = self._load_checkpoint_local()
        if self.mpi_size > 1:
            state = self._broadcast_resume(state)
        return state

    def _load_checkpoint_local(self):
        """This rank's newest valid checkpoint (module docstring)."""
        if not self.resume or self.logs is None or self.logs['created']:
            return None
        ck = self.logs['checkpoint']
        its = sorted((int(m.group(1)) for m in (
            re.fullmatch(r'checkpoint_(\d+)\.txt', f) for f in os.listdir(ck))
            if m), reverse=True)
        for it in its:
            try:
                return self._load_one_checkpoint(ck, it)
            except Exception as e:  # any corrupt file: try an older one
                self.logger.warning('Checkpoint %d unusable (%r); trying an '
                                    'older one' % (it, e))
        return None

    def _load_one_checkpoint(self, ck, it):
        """Checkpoint ``it``'s marker and arrays, validated (raises on a
        missing or corrupt file or a short history), then the exact state
        (:meth:`_restore_exact_state`)."""
        with open(os.path.join(ck, 'checkpoint_%d.txt' % it)) as f:
            meta = json.load(f)
        active_u = np.load(os.path.join(ck, 'active_u_%d.npy' % it))
        active_logl = np.load(os.path.join(ck, 'active_logl_%d.npy' % it))
        active_derived = np.load(os.path.join(ck,
                                              'active_derived_%d.npy' % it))
        n = self.num_live_points
        if active_u.shape != (n, self.x_dim) or \
                active_logl.shape != (n,) or \
                active_derived.shape != (n, self.num_derived):
            raise ValueError('checkpoint %d: live arrays of shape %s, %s and '
                             '%s' % (it, active_u.shape, active_logl.shape,
                                     active_derived.shape))
        saved = {}
        for name in ('saved_v', 'saved_logl', 'saved_logwt'):
            a = np.load(os.path.join(ck, name + '.npy'))
            if len(a) < it:
                raise ValueError('checkpoint %d inconsistent: %d rows in %s'
                                 % (it, len(a), name))
            saved[name] = list(a[:it])
        # Thread slots: short or absent disables the bootstrap error.
        slots = None
        sl_path = os.path.join(ck, 'saved_slots.npy')
        if os.path.exists(sl_path):
            sl = np.load(sl_path)
            if len(sl) >= it:
                slots = [int(x) for x in sl[:it]]
        # The u-space dead points: short or absent disables saved_u.
        saved_u = None
        su_path = os.path.join(ck, 'saved_u.npy')
        if os.path.exists(su_path):
            su = np.load(su_path)
            if len(su) >= it:
                saved_u = [np.array(r) for r in su[:it]]
        self.total_calls = int(meta['ncall'])
        self.total_accepted = int(meta['total_accepted'])
        self.total_rejected = int(meta['total_rejected'])
        self.total_fast_calls = int(meta.get('total_fast_calls', 0))
        exact = self._restore_exact_state(ck, it)
        return {'it': it, 'active_u': active_u,
                'active_v': self.transform(active_u),
                'active_logl': active_logl, 'active_derived': active_derived,
                'saved_v': [np.asarray(r) for r in saved['saved_v']],
                'saved_logl': saved['saved_logl'],
                'saved_logwt': saved['saved_logwt'], 'slots': slots,
                'saved_u': saved_u,
                'logz': meta['logz'], 'h': meta['h'],
                'logvol': meta['logvol'],
                'fraction_remain': meta['fraction_remain'],
                'expired': (exact['controller']['expired']
                            if exact['controller'] is not None
                            else meta['expired_strategies']),
                **exact}

    def _restore_exact_state(self, ck, it):
        """Restore the sampler's generator and the trainer from the exact
        state and return ``{'controller', 'pool', 'insertion_ranks'}``.

        A stamp equal to ``it`` gives a bit-exact resume. A stamp from
        another iteration (a crash between the state's replace and its
        marker, or a fall back to an older marker) still restores the
        generator, the trainer and the first ``it`` insertion ranks, all
        valid states, but drops the controller and the pool: the resume is
        statistically exact. An unreadable state restores nothing."""
        lost = {'controller': None, 'pool': None, 'insertion_ranks': []}
        try:
            es = torch.load(os.path.join(ck, EXACT_STATE), map_location='cpu',
                            weights_only=True)
            self.trainer.restore_state(es['trainer'])
            self.generator.set_state(es['generator'])
            ranks = [int(x) for x in es['insertion_ranks'][:it]]
        except Exception as e:  # unreadable: keep the marker's arrays only
            self.logger.warning('Could not restore the exact state (%r); '
                                'resume is statistically (not bit-) exact'
                                % (e,))
            return lost
        if es['it'] != it:
            self.logger.warning(
                'Exact state is from iteration %s but the checkpoint is %d; '
                'resume is statistically (not bit-) exact' % (es['it'], it))
            return dict(lost, insertion_ranks=ranks)
        return {'controller': es['controller'], 'pool': _arrays(es['pool']),
                'insertion_ranks': ranks}
