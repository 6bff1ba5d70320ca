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
(``samplers/base.py``), and the loop counts ``evidence_side``: ``dead``
(the points that die in it), ``transform_calls`` (its calls of the sampler
transform, one a pool it takes a point from) and ``scalar_jobs`` (the
``logz`` batches it hands to the writer).

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
order), which also rewrites ``chain.txt`` at every checkpoint and writes the
``logz`` TensorBoard scalar of every iteration: the loop keeps each row
and hands a pool's rows over as one job (``Trainer.log_scalars``). ``run``
drains the writer before it reads a checkpoint, and joins the trainer's
plots and closes the writer before the final results are written.
``run(show_progress=True)`` shows a tqdm bar (imported when asked for;
without tqdm, no bar), closed when the run raises.

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
import types
from dataclasses import dataclass, field

import numpy as np
import torch

from nnest_torch import runtime
from nnest_torch.priors import UniformPrior
from nnest_torch.samplers.base import Sampler
from nnest_torch.samplers.kernels import trial_ladder
from nnest_torch.utils.evaluation import (adjusted_logzerr,
                                          bootstrap_logz_error, insertion_ks,
                                          latent_cond_null,
                                          metropolis_mix_null,
                                          rolling_insertion_ks,
                                          slice_mix_null)
from nnest_torch.utils.profiling import (count, profiler_collecting,
                                         recording, span, timed)

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


@dataclass
class _RunState:
    """What the evidence loop carries from one iteration to the next, made
    by :meth:`NestedSampler._fresh_state` or, on resume,
    :meth:`NestedSampler._load_one_checkpoint`. A checkpoint holds its
    arrays and evidence, and :meth:`controller` and :meth:`pool_state` in
    its exact state, which :meth:`restore` takes back."""

    # the live set
    active_u: np.ndarray
    active_v: np.ndarray
    active_logl: np.ndarray
    active_derived: np.ndarray
    # the dead rows; saved_slots and saved_u are None when a checkpoint's
    # were short or absent (no bootstrap error, no saved_u)
    saved_v: list = field(default_factory=list)
    saved_logl: list = field(default_factory=list)
    saved_logwt: list = field(default_factory=list)
    saved_slots: list | None = field(default_factory=list)
    saved_u: list | None = field(default_factory=list)
    insertion_ranks: list = field(default_factory=list)
    # the evidence; accept_point: the worst point was replaced, so the
    # next iteration records a death
    it: int = 0
    logz: float = -1e300
    h: float = 0.0
    logvol: float = 0.0
    fraction_remain: float = 1.0
    accept_point: bool = True
    # the strategy ladder's controller: current_method is None until
    # start() where no checkpoint's controller gave it; envelope is the
    # flow-rejection envelope (max_log_det_j, max_r) such a controller
    # carried, which the sampler holds while it runs
    current_method: str | None = None
    expired: list = field(default_factory=list)
    first_time: bool = True
    last_trained_it: int = -1
    env_gens: int = 0   # flow-rejection generations since the envelope
    ncs: list = field(default_factory=list)
    mean_calls: float = 0.0
    mcmc_scale: float = 0.0
    cur_trials: int = 0
    last_io_it: int = 0   # iteration of the last checkpoint
    envelope: tuple | None = None
    # the pool being consumed and the prefetched generations: Metropolis or
    # slice (entries of Sampler._gens_to_buffer), prior and flow rejection
    # (dicts of NestedSampler._compact_rejection_gen). A pool's 'v', its
    # rows in the likelihood's space, is made at its first accept and is
    # not checkpointed.
    need_pool: bool = True
    pool: dict | None = None
    pool_pos: int = 0
    mcmc_buf: list = field(default_factory=list)
    prior_buf: list = field(default_factory=list)
    flow_buf: list = field(default_factory=list)
    # the logz scalars not yet handed to the writer: (step, value, wall time)
    logz_rows: list = field(default_factory=list)

    def start(self, strategy, step_size, trials):
        """The controller's start where no checkpoint gave one."""
        if self.current_method is None:
            self.ladder(strategy, trials)
            self.mcmc_scale = step_size
            self.last_io_it = self.it

    def ladder(self, strategy, trials):
        """The strategy ladder: the first method not expired. A new one
        takes a fresh pool and the first rung of the trial ladder."""
        method = next(m for m in strategy if m not in self.expired)
        if method != self.current_method:
            self.current_method = method
            self.need_pool = True
            self.cur_trials = int(trials)

    def kill(self, i, logvol):
        """Live point ``i`` dies at log prior volume ``logvol``: the
        evidence and ``h`` take its weight, and the dead rows its v (then
        its derived values, if any), logl, weight, slot (the thread lineage
        the bootstrap error resamples) and u."""
        v, derived, logl = (self.active_v[i], self.active_derived[i],
                            self.active_logl[i])
        logwt = logvol + logl
        logz_new = np.logaddexp(self.logz, logwt)
        self.h = (np.exp(logwt - logz_new) * logl
                  + np.exp(self.logz - logz_new) * (self.h + self.logz)
                  - logz_new)
        self.logz = logz_new
        self.saved_v.append(np.concatenate((v, derived)) if derived.size
                            else np.array(v, copy=True))
        self.saved_logwt.append(logwt)
        self.saved_logl.append(logl)
        if self.saved_slots is not None:
            self.saved_slots.append(i)
        if self.saved_u is not None:
            self.saved_u.append(np.array(self.active_u[i]))

    def controller(self, max_log_det_j, max_r):
        """The exact state's ``controller``, with the sampler's envelope."""
        return {
            'current_method': self.current_method,
            'expired': list(self.expired),
            'first_time': bool(self.first_time),
            'last_trained_it': int(self.last_trained_it),
            'env_gens': int(self.env_gens),
            'max_log_det_j': (None if max_log_det_j is None
                              else float(max_log_det_j)),
            'max_r': None if max_r is None else float(max_r),
            'ncs': [float(x) for x in self.ncs],
            'mean_calls': float(self.mean_calls),
            'mcmc_scale': float(self.mcmc_scale),
            'cur_trials': int(self.cur_trials),
            'last_io_it': int(self.last_io_it),
        }

    def pool_state(self):
        """The exact state's ``pool``."""
        pool = self.pool
        if pool is not None and 'v' in pool:
            pool = {k: a for k, a in pool.items() if k != 'v'}
        return {'need_pool': bool(self.need_pool), 'pool': pool,
                'pool_pos': int(self.pool_pos),
                'mcmc_buf': list(self.mcmc_buf),
                'prior_buf': list(self.prior_buf),
                'flow_buf': list(self.flow_buf)}

    def restore(self, controller, pool):
        """Take a bit-exact checkpoint's ``controller`` and ``pool``: the
        ladder, envelope and proposal state and the pool as the
        uninterrupted run had them. Checkpoints written before the prefetch
        have no buffers."""
        self.envelope = (controller['max_log_det_j'], controller['max_r'])
        for name, value in {**controller, **pool}.items():
            if name not in ('max_log_det_j', 'max_r'):
                setattr(self, name, value)
        self.mcmc_buf = [(g[0], g[1], g[2],
                          None if g[3] is None else torch.as_tensor(g[3]))
                         for g in self.mcmc_buf]


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

            from nnest_torch.ops import (consume_pool, spline_chain,
                                         spline_coupling, spline_inverse)
            t0 = time.time()
            with ThreadPoolExecutor(5) as pool:
                for job in [pool.submit(m.load_library) for m in (
                        spline_inverse, consume_pool, spline_coupling,
                        spline_chain, runtime)]:
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
        point exceeds it.

        An iteration of the evidence loop (the ``loop`` span) runs the
        phases on the :class:`_RunState`: :meth:`_record_dead`, the
        strategy ladder, :meth:`_maybe_retrain`, :meth:`_refill_pool`,
        :meth:`_replace_worst` and :meth:`_advance`; then :meth:`_finish`."""
        # the options as one namespace, which the phases read
        opts = types.SimpleNamespace(**locals())
        del opts.self
        self._resolve_options(opts)
        # a previous run() of this sampler may still be writing
        self._drain_io()
        st = self._load_checkpoint()
        resumed = st is not None
        if resumed and opts.init_points is not None:
            raise ValueError(
                'init_points is for fresh dynamic batch runs; this log_dir '
                'has a resumable checkpoint (use resume=False or a fresh '
                'log_dir)')
        if resumed:
            self.logger.info('Resumed from checkpoint [%d]%s' % (
                st.it, '' if st.current_method is None else ' (bit-exact)'))
            if st.envelope is not None:
                self._max_log_det_j, self._max_r = st.envelope
        else:
            st = self._fresh_state(opts.init_points)
        st.start(opts.strategy, opts.step_size, opts.rejection_batch_size)
        # fresh mixing history per run() call
        for name in ('_mix_ratios', '_mix_ratios_eig', '_latent_conds',
                     '_mix_rels', '_cond_rels', '_cond_infl'):
            setattr(self, name, [])
        self._spec_losses = 0
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
        if not resumed:
            self._checkpoint(st, opts.strategy)
        if opts.show_progress and self.single_or_primary_process:
            with contextlib.suppress(ImportError):   # no tqdm, no bar
                from tqdm import tqdm
                self._run_pbar = tqdm(initial=st.it, unit='it',
                                      desc='nested', dynamic_ncols=True)

        with span('loop'):
            while (st.fraction_remain > opts.dlogz
                   and st.it <= opts.max_iters
                   and (opts.logl_ceiling is None
                        or float(np.min(st.active_logl))
                        <= opts.logl_ceiling)):
                worst, loglstar = self._record_dead(st)
                st.ladder(opts.strategy, opts.rejection_batch_size)
                self._maybe_retrain(st, opts)
                if st.need_pool:
                    self._refill_pool(st, opts, loglstar)
                self._replace_worst(st, worst, loglstar)
                if st.accept_point:
                    self._advance(st, opts, loglstar)
        if self._run_pbar is not None:
            self._run_pbar.close()
            self._run_pbar = None
        return self._finish(st)

    def _resolve_options(self, opts):
        """Check ``run()``'s options (a namespace), resolve their defaults
        in place and add the values derived from them: ``slice_calls`` and
        ``trials_target``."""
        if opts.birth_floor is not None:
            self._birth_floor = float(opts.birth_floor)
        if opts.strategy is None or len(opts.strategy) == 0:
            opts.strategy = ['rejection_prior', 'mcmc']
        unknown = [m for m in opts.strategy if m not in _METHODS]
        if unknown:
            raise ValueError('unknown strategy method(s) %s; choose from %s'
                             % (unknown, list(_METHODS)))
        if opts.mcmc_adapt not in ('cov', 'iso'):
            raise ValueError("mcmc_adapt must be 'cov' or 'iso'")
        for name in ('mcmc_gen_batch', 'rejection_gen_batch'):
            value = getattr(opts, name)
            if not isinstance(value, (int, np.integer)) or \
                    isinstance(value, bool) or value < 1:
                raise ValueError('%s must be an integer >= 1, got %r'
                                 % (name, value))
        if not isinstance(opts.mcmc_speculate, (bool, np.bool_)):
            raise ValueError('mcmc_speculate must be a bool, got %r'
                             % (opts.mcmc_speculate,))
        n, d = self.num_live_points, self.x_dim
        for name, share in (('update_interval', 0.5), ('log_interval', 0.2)):
            value = getattr(opts, name)
            if value is None:
                value = max(1, round(share * n))
            elif round(value) < 1:
                raise ValueError('%s must be >= 1' % name)
            setattr(opts, name, round(value))
        if opts.mcmc_num_chains is None:
            # 10 chains (the reference default) on the CPU; a GPU batches
            # wider chain sets for the same wall time.
            opts.mcmc_num_chains = (10 if self.device.type == 'cpu'
                                    else (256 if d >= 8 else 128))
        if opts.mcmc_steps <= 0:
            opts.mcmc_steps = 5 * d
            if d >= 40:
                # The JAX package measured a +0.08-nat evidence systematic
                # on the 50-D Gaussian at 5*d steps that vanishes at 10*d
                # (BENCHMARKS.md round 5); logzerr_adjusted covers it.
                self.logger.info(
                    'mcmc_steps defaulted to 5*x_dim = %d. At x_dim >= '
                    '~40 this budget leaves a measured ~+0.1-nat '
                    'evidence systematic (endpoint-start correlation; '
                    'BENCHMARKS.md round 5) — mcmc_steps=%d removes it '
                    'at 2x the likelihood cost.' % (opts.mcmc_steps, 10 * d))
        if opts.step_size <= 0.0:
            opts.step_size = 1.0 / d ** 0.5
        if opts.slice_steps <= 0:
            # one slice move decorrelates along one latent direction: ~2
            # passes over the basis
            opts.slice_steps = 2 * d
        if opts.slice_adapt not in ('cov', 'iso'):
            raise ValueError("slice_adapt must be 'cov' or 'iso'")
        # Likelihood calls per accept of the downstream kernel when it is
        # 'slice': each step pays ~1 shrink hit and up to max_expand
        # stepping-out probes. The rejection phases expire past it.
        opts.slice_calls = opts.slice_steps * (1 + opts.slice_max_expand)
        # Speculation wins only through the NLL retrain gate: without one
        # every boundary retrains and voids what was prefetched past it.
        opts.mcmc_speculate = bool(opts.mcmc_speculate and
                                   opts.retrain_nll_threshold is not None)
        opts.rejection_max_trials = max(int(opts.rejection_max_trials),
                                        opts.rejection_batch_size)
        opts.trials_target = max(16, n // 8)
        self.logger.info('MCMC steps [%d]' % opts.mcmc_steps)
        self.logger.info('Initial scale [%5.4f]' % opts.step_size)
        self.logger.info('Volume switch [%5.4f]' % opts.volume_switch)

    def _fresh_state(self, init_points):
        """The run state of a fresh run: the live points of a dynamic batch
        (``init_points``, refreshed and paid for by the caller within
        {logl > birth_floor}) or of the prior, and nothing dead yet."""
        n = self.num_live_points
        if init_points is not None:
            u = np.array(init_points['u'], dtype=np.float64)
            if u.shape != (n, self.x_dim):
                raise ValueError(
                    'init_points u must be (num_live_points, x_dim)')
            v = np.array(init_points['v'] if 'v' in init_points
                         else self.transform(u), dtype=np.float64)
            logl = np.array(init_points['logl'], dtype=np.float64)
            derived = np.array(
                init_points['derived'] if 'derived' in init_points
                else np.zeros((n, self.num_derived)),
                dtype=np.float64).reshape(n, -1)
            if not np.all(logl > self._birth_floor):
                raise ValueError('init_points logl must all exceed '
                                 'birth_floor')
        else:
            u = np.asarray(self._user_prior.sample(n), dtype=np.float64)
            v = self.transform(u)
            logl, derived = self.loglike(u)
        self.logger.info('Step [0] max logl [%5.4e] vol [1.0] ncalls '
                         '[%d]' % (np.max(logl), self.total_calls))
        return _RunState(u, v, logl, derived,
                         logvol=float(np.log(1.0 - np.exp(-1.0 / n))))

    def _record_dead(self, st):
        """The worst live point's index and logl. After an accept it dies
        here: the evidence, ``h`` and the dead rows take it."""
        worst = int(np.argmin(st.active_logl))
        if st.accept_point:
            st.kill(worst, st.logvol)
            st.accept_point = False
            count('evidence_side', 1, 'dead')
        return worst, float(st.active_logl[worst])

    def _maybe_retrain(self, st, opts):
        """The flow's retrain, at the first iteration of a flow method and
        then every ``update_interval``. Conditional: the latent kernels are
        exact for any fixed flow, so when the flow still fits the live set
        (mean NLL within ``retrain_nll_threshold`` of the last training's
        best validation NLL) the retrain is skipped. The < 1e29 guard
        excludes the trainer's "never improved" sentinel."""
        if st.current_method == 'rejection_prior' or not (
                st.first_time or (st.it % opts.update_interval == 0
                                  and st.it != st.last_trained_it)):
            return
        st.last_trained_it = st.it
        best = self.trainer.best_validation_loss
        if (not st.first_time and opts.retrain_nll_threshold is not None
                and best is not None and best < 1e29):
            with self.timers.time('retrain_check'):
                nll_now = -float(np.mean(self.trainer.log_probs(
                    st.active_u.astype(np.float32), to_numpy=True)))
            if nll_now < best + opts.retrain_nll_threshold:
                self.run_stats['retrains_skipped'] += 1
                return
        if st.mcmc_buf:
            # A lost speculation: the buffered generations were made with
            # the flow this retrain replaces, where one generation a
            # dispatch would make them after it. Drop them and set the
            # generator back to the first one's state, so they are made
            # again from the same numbers. The generation being consumed
            # stays: that route made it before the retrain too.
            state0 = st.mcmc_buf[0][3]
            if state0 is None:
                raise RuntimeError(
                    'prefetched generations span a retrain boundary but '
                    'carry no generator state (a batch run without '
                    'speculation; did update_interval change across a '
                    'resume?)')
            self._rewind_generator(state0)
            self._spec_losses += len(st.mcmc_buf)
            st.mcmc_buf = []
        epochs0 = getattr(self.trainer, 'total_iters', 0)
        with self.timers.time('flow_train') as phase:
            self.trainer.train(st.active_u.astype(np.float32),
                               max_iters=opts.train_iters, jitter=opts.jitter)
        self.run_stats['train_s'] += phase.seconds
        self.run_stats['trainings'] += 1
        self.run_stats['train_epochs'] += getattr(
            self.trainer, 'total_iters', 0) - epochs0
        st.first_time = False
        # The envelope is a function of the flow: a retrain invalidates it.
        self._max_log_det_j = None

    def _refill_pool(self, st, opts, loglstar):
        """A new candidate pool of the current method, timed as the
        ``pool`` region. The spent pool's ``logz`` scalars go to the writer
        first."""
        self._submit_logz(st)
        stem = _STAT_KEY[st.current_method]
        with timed('pool', method=st.current_method) as refill:
            if st.current_method in ('mcmc', 'slice'):
                st.pool = self._chain_pool(st, opts, loglstar)
            else:
                st.pool = self._rejection_pool(st, opts, loglstar)
        self.run_stats[stem + '_s'] += refill.seconds
        self.run_stats[stem + '_generations'] += 1
        st.pool_pos = 0
        st.need_pool = False

    def _chain_pool(self, st, opts, loglstar):
        """A Metropolis or slice generation's pool: the endpoints of the
        chains that moved. With the prefetch gate open it is served from
        ``st.mcmc_buf``, which a batch refills ('mcmc' and 'slice' share
        the buffer: neither expires, so only the first in the strategy
        runs); otherwise one generation is dispatched."""
        is_slice = st.current_method == 'slice'
        stem = _STAT_KEY[st.current_method]
        adapt_cov = (opts.slice_adapt if is_slice
                     else opts.mcmc_adapt) == 'cov'
        live = (st.active_u, st.active_logl, st.active_derived)
        use_batch = self.mesh is None and opts.mcmc_gen_batch > 1
        if use_batch and not st.mcmc_buf:
            use_batch = _f32_exact(st.active_logl)
        if use_batch and not st.mcmc_buf:
            self.run_stats[stem + '_dispatches'] += 1
            if is_slice:
                st.mcmc_buf = self._slice_generations_batch(
                    opts.slice_steps, *live, opts.mcmc_num_chains,
                    opts.slice_width, st.it, opts.update_interval,
                    opts.mcmc_gen_batch, max_expand=opts.slice_max_expand,
                    max_shrink=opts.slice_max_shrink,
                    speculate=opts.mcmc_speculate, adapt_cov=adapt_cov)
            else:
                st.mcmc_buf = self._mcmc_generations_batch(
                    opts.mcmc_steps, *live, opts.mcmc_num_chains,
                    opts.step_size, st.it, opts.update_interval,
                    opts.mcmc_gen_batch,
                    dynamic_step_size=opts.mcmc_dynamic_step_size,
                    speculate=opts.mcmc_speculate, adapt_cov=adapt_cov)
        if use_batch and st.mcmc_buf:
            out, g_lstar, g_it, _ = st.mcmc_buf.pop(0)
            _check_sync(st.current_method, g_it, g_lstar, st.it, loglstar)
            endpoints = self._consume_endpoint_out(
                out,
                mix_null=(slice_mix_null(opts.slice_steps, self.x_dim)
                          if is_slice else metropolis_mix_null(
                              opts.mcmc_steps, self.x_dim,
                              adapt_cov=adapt_cov)),
                cond_null=latent_cond_null(self.x_dim, opts.mcmc_num_chains),
                cond_inflates=not is_slice)
        elif is_slice:
            self.run_stats[stem + '_dispatches'] += 1
            endpoints = self._slice_sample_live(
                opts.slice_steps, st.active_u, st.active_logl,
                opts.mcmc_num_chains, loglstar, opts.slice_width,
                max_expand=opts.slice_max_expand,
                max_shrink=opts.slice_max_shrink, adapt_cov=adapt_cov,
                active_derived=st.active_derived)
        else:
            self.run_stats[stem + '_dispatches'] += 1
            endpoints = self._mcmc_sample_live(
                opts.mcmc_steps, st.active_u, st.active_logl,
                opts.mcmc_num_chains, loglstar, opts.step_size,
                dynamic_step_size=opts.mcmc_dynamic_step_size,
                adapt_cov=adapt_cov, active_derived=st.active_derived)
        u_f, logl_f, d_f, moved, st.mcmc_scale, _, _ = endpoints
        return {'u': u_f[moved], 'logl': logl_f[moved],
                'derived': d_f[moved], 'stats': self._last_kernel_stats}

    def _rejection_pool(self, st, opts, loglstar):
        """A prior, flow or density rejection generation's pool: the
        passing candidates, served from ``st.prior_buf`` or
        ``st.flow_buf`` under the same gate as :meth:`_chain_pool` (which
        :meth:`_rejection_batch` refills), otherwise dispatched one at a
        time. Then the trial ladder, the efficiency window and the
        expiry."""
        method = st.current_method
        stem = _STAT_KEY[method]
        buf = st.prior_buf if method == 'rejection_prior' else st.flow_buf
        # The downstream within-shell kernel ('mcmc' or 'slice', the first
        # not expired): a rejection phase expires past its calls per accept.
        kernel = next((m for m in opts.strategy if m in ('mcmc', 'slice')
                       and m not in st.expired), None)
        switch_calls = (None if kernel is None else opts.slice_calls
                        if kernel == 'slice' else opts.mcmc_steps)
        can_double = st.cur_trials * 2 <= opts.rejection_max_trials
        can_halve = st.cur_trials >= 2 * opts.rejection_batch_size
        recompute = (self._max_log_det_j is None
                     or st.env_gens >= opts.rejection_cache_interval)
        use_batch = (self.mesh is None and opts.rejection_gen_batch > 1
                     and method != 'density_flow')
        if use_batch and not buf:
            use_batch = _f32_exact(st.active_logl)
        if use_batch and not buf:
            self.run_stats[stem + '_dispatches'] += 1
            buf.extend(self._rejection_batch(st, opts, switch_calls,
                                             can_double, can_halve))
        served = use_batch and bool(buf)
        if served:
            g = buf.pop(0)
            _check_sync(method, g['it'], g['loglstar'], st.it, loglstar,
                        g['trials'], st.cur_trials)
            nev = g['trials'] if g['nev'] is None else g['nev']
            if g['mld'] is not None:
                self._max_log_det_j = g['mld']
                self._max_r = g['mr']
            self.total_calls += nev
            nc = nev / max(g['n_ok'], 1) if g['n_ok'] > 0 else max(nev, 1)
            s, ll, ds = g['s'], g['ll'], g['ds']
        else:
            self.run_stats[stem + '_dispatches'] += 1
            with self.timers.time('candidate_kernel'):
                if method == 'rejection_prior':
                    s, ll, ds, nc = self._rejection_prior_sample(
                        loglstar, num_trials=st.cur_trials)
                elif method == 'rejection_flow':
                    # A fresh envelope after a retrain or every
                    # rejection_cache_interval generations; in between the
                    # live set's values are max-folded into it.
                    s, ll, ds, nc = self._rejection_flow_sample(
                        st.active_u, loglstar, enlargement_factor=(
                            opts.rejection_enlargement_factor),
                        cache=not recompute, num_trials=st.cur_trials)
                else:
                    s, ll, ds, nc = self._density_sample(
                        loglstar, num_trials=st.cur_trials)
        n_ok = int(s.shape[0])
        rung = self.run_stats[stem + '_by_trials'].setdefault(
            st.cur_trials, [0, 0])
        rung[0] += 1
        rung[1] += n_ok
        if method == 'rejection_flow':
            st.env_gens = 0 if recompute else st.env_gens + 1
        move, pushes = trial_ladder(n_ok, opts.trials_target,
                                    opts.rejection_adapt_trials, can_double,
                                    can_halve)
        if move == 'double':
            st.cur_trials *= 2
        elif move == 'halve':
            st.cur_trials //= 2
        st.ncs.extend([nc] * pushes)
        st.mean_calls = (float(np.mean(st.ncs[-20:])) if len(st.ncs) > 20
                         else 0.0)
        switch = switch_calls is not None and st.mean_calls > switch_calls
        if method == 'rejection_prior':
            expected_vol = np.exp(-st.it / self.num_live_points)
            switch = (0 <= opts.volume_switch > expected_vol) or (
                opts.volume_switch < 0 and switch)
        if switch:
            self.logger.info('%s no longer efficient, switching sampling '
                             'method' % method)
            st.expired.append(method)
            st.ncs = []
        # The stop rules keep a batch from outrunning a ladder or expiry
        # decision; a leftover here would mean numbers drawn for
        # generations this route would not run.
        if served and buf and (switch or buf[0]['trials'] != st.cur_trials):
            raise RuntimeError(
                'rejection generation prefetch outran a ladder or expiry '
                'decision (switch=%s, trials %d -> %d)'
                % (switch, buf[0]['trials'], st.cur_trials))
        return {'u': s, 'logl': ll, 'derived': ds}

    def _rejection_batch(self, st, opts, switch_calls, can_double,
                         can_halve):
        """A prior or flow rejection batch's generations, compacted
        (:meth:`_compact_rejection_gen`). Beside the trial ladder, a batch
        stops at the expiry proxy at 0.9x its threshold and two iterations
        before the volume switch can fire (prior rejection) or at an
        ``update_interval`` crossing (flow rejection)."""
        max_gens = min(opts.rejection_gen_batch,
                       max(1, 2 ** 18 // st.cur_trials))
        live = (st.active_u, st.active_logl, st.active_derived, st.it)
        if st.current_method == 'rejection_prior':
            it_stop = (int(np.ceil(-self.num_live_points
                                   * np.log(opts.volume_switch))) - 2
                       if opts.volume_switch > 0 else 2 ** 30)
            thr = (0.9 * switch_calls
                   if opts.volume_switch < 0 and switch_calls is not None
                   else np.float32(1e30))
            gens = self._rejection_prior_generations_batch(
                *live, it_stop, st.ncs, thr, opts.trials_target,
                st.cur_trials, max_gens, opts.rejection_adapt_trials,
                can_double, can_halve)
        else:
            thr = (0.9 * switch_calls if switch_calls is not None
                   else np.float32(1e30))
            env_valid = self._max_log_det_j is not None
            gens = self._rejection_flow_generations_batch(
                *live, opts.update_interval, st.ncs, thr,
                opts.trials_target, env_valid, st.env_gens,
                self._max_log_det_j if env_valid else 0.0,
                self._max_r if env_valid else 0.0,
                opts.rejection_cache_interval,
                opts.rejection_enlargement_factor, st.cur_trials, max_gens,
                opts.rejection_adapt_trials, can_double, can_halve)
        return [self._compact_rejection_gen(
            out['x'], out['logl'],
            out.get('derived', np.zeros((st.cur_trials, self.num_derived))),
            out['ok'], out.get('n_evals'), out.get('mld'), out.get('mr'),
            g_lstar, g_it, st.cur_trials) for out, g_lstar, g_it, _ in gens]

    def _replace_worst(self, st, worst, loglstar):
        """Consume the pool: candidates in order against the current worst
        point; the first above it replaces it. A spent pool asks for a new
        one. The pool's rows go through the sampler transform in one call,
        at its first accept (a row-wise transform gives each row what a call
        on the row alone gives)."""
        pool = st.pool
        if pool is None:
            return
        u = pool['u']
        n_rows = u.shape[0]
        while st.pool_pos < n_rows:
            ib = st.pool_pos
            st.pool_pos += 1
            if st.pool_pos == n_rows:
                st.need_pool = True
            if pool['logl'][ib] > loglstar:
                # Insertion rank of the replacement among the surviving
                # n_live - 1 points (the -1 excludes the dead point):
                # Uniform{0..n_live-1} under exact constrained sampling.
                st.insertion_ranks.append(int(
                    np.sum(st.active_logl < pool['logl'][ib])) - 1)
                st.active_u[worst] = u[ib, :]
                if 'v' not in pool:
                    pool['v'] = self.transform(u)
                    count('evidence_side', 1, 'transform_calls')
                st.active_v[worst] = pool['v'][ib]
                st.active_logl[worst] = pool['logl'][ib]
                if self.num_derived:
                    st.active_derived[worst] = pool['derived'][ib]
                st.accept_point = True
                break
        if n_rows == 0:
            st.need_pool = True

    def _advance(self, st, opts, loglstar):
        """After an accept: shrink the prior volume, update the remaining
        evidence fraction (the stop rule) and ``it``; then the progress bar
        and the ``logz`` scalar's row (:meth:`_submit_logz` writes them),
        and every ``log_interval`` the log line, the ``results.csv`` row and
        the checkpoint cadence."""
        n = self.num_live_points
        expected_vol = np.exp(-st.it / n)
        st.logvol -= 1.0 / n
        logz_remain = np.max(st.active_logl) - st.it / n
        st.fraction_remain = np.logaddexp(st.logz, logz_remain) - st.logz
        st.it += 1
        it, logz = st.it, st.logz
        pbar = self._run_pbar
        if pbar is not None:
            pbar.update(1)
            if it % opts.log_interval == 0:
                pbar.set_postfix(logz='%.3f' % logz,
                                 loglstar='%.3g' % loglstar,
                                 ncall=self.total_calls, refresh=False)
        if getattr(self.trainer, 'writes_events', False):
            st.logz_rows.append((it, float(logz), time.time()))
        if it % opts.log_interval != 0:
            return
        self.logger.info(
            'Step [%d] loglstar [%5.4e] maxlogl [%5.4e] logz [%5.4e] vol '
            '[%6.5e] ncalls [%d] scale [%5.4f] mean calls [%5.4f]' % (
                it, loglstar, np.max(st.active_logl), logz, expected_vol,
                self.total_calls, st.mcmc_scale, st.mean_calls))
        self._append_results_row(it, loglstar, logz, st.fraction_remain,
                                 st.mcmc_scale, st.pool)
        # Checkpoints are O(saved rows): spacing keyed to the last write
        # (~10% growth) keeps their total cost O(n log n).
        if it - st.last_io_it < max(opts.log_interval, st.last_io_it // 10):
            return
        st.last_io_it = it
        self._checkpoint(st, opts.strategy)
        if self.logs is not None:
            # fresh host arrays: the writer rewrites chain.txt from them;
            # the final write, after the writer is closed, comes last
            self.samples = np.asarray(st.saved_v)
            self.weights = np.exp(np.asarray(st.saved_logwt) - logz)
            self.loglikes = np.asarray(st.saved_logl)
            with self.timers.time('chain_io'):
                self._submit_io(lambda v=self.samples, ll=self.loglikes,
                                w=self.weights:
                                self._save_samples(v, ll, weights=w))

    def _submit_logz(self, st):
        """The pending ``logz`` scalars as one job of the writer: when a
        pool is spent, before a checkpoint (so that they reach the disk
        before it) and at the run's end."""
        if not st.logz_rows:
            return
        rows, st.logz_rows = st.logz_rows, []
        count('evidence_side', 1, 'scalar_jobs')
        self._submit_io(lambda: self.trainer.log_scalars('logz', *zip(*rows)))

    def _checkpoint(self, st, strategy):
        """:meth:`_write_checkpoint`, timed as the ``checkpoint_io``
        phase, after the pending ``logz`` scalars; nothing without a run
        directory."""
        self._submit_logz(st)
        if self.logs is None:
            return
        with self.timers.time('checkpoint_io') as phase:
            self._write_checkpoint(st, strategy)
        self.run_stats['checkpoint_s'] += phase.seconds
        self.run_stats['checkpoints'] += 1

    def _finish(self, st):
        """After the loop: the remaining live points die at the final
        volume, in slot order (slot i's final point closes thread i); the
        queued writes land, then the results, the outputs and the
        diagnostics. Returns logz."""
        self.run_stats['speculation_losses'] = self._spec_losses
        self.run_stats['generations_discarded'] = (
            len(st.mcmc_buf) + len(st.prior_buf) + len(st.flow_buf))
        n = self.num_live_points
        logvol = -len(st.saved_v) / n - np.log(n)
        for i in range(n):
            st.kill(i, logvol)
        # the queued writes and the trainer's plots land (and the
        # TensorBoard writer is flushed) before the run's results are
        # declared
        self._submit_logz(st)
        with self.timers.time('checkpoint_io') as phase:
            self._close_io()
        self.run_stats['checkpoint_s'] += phase.seconds
        self._join_plots()
        self.run_stats['total_fast_calls'] = self.total_fast_calls
        self.logz = logz = st.logz
        self.h = h = st.h
        self.logzerr = float(np.sqrt(h / n))
        self.niter = st.it + 1
        self.samples = np.asarray(st.saved_v)
        self.weights = np.exp(np.asarray(st.saved_logwt) - logz)
        self.loglikes = np.asarray(st.saved_logl)
        # the u-space points aligned with loglikes and thread_slots, final
        # live points included: the dynamic sampler seeds batches from them
        self.saved_u = (None if st.saved_u is None
                        else np.asarray(st.saved_u).reshape(-1, self.x_dim))
        self._diagnose(st.insertion_ranks, st.saved_logl, st.saved_slots)
        if self.logs is not None:
            self._write_results(st.saved_logl, self.saved_u)
            with open(os.path.join(self.logs['results'], 'final.csv'),
                      'w') as f:
                w = csv.writer(f)
                w.writerow(['niter', 'ncall', 'logz', 'logzerr', 'h'])
                w.writerow([self.niter, self.total_calls, logz, self.logzerr,
                            h])
            self._save_samples(self.samples, self.loglikes,
                               weights=self.weights)
        self.logger.info(
            'niter: %d\n ncall: %d\n nsamples: %d\n logz: %6.3f +/- '
            '%6.3f\n h: %6.3f' % (self.niter, self.total_calls,
                                  len(st.saved_v), logz, self.logzerr, h))
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

    def _write_checkpoint(self, st, strategy):
        """One checkpoint of the run state ``st``: a snapshot here (copies
        of every array, the generator and trainer states, the counters),
        then the files on the background writer, in the order that makes a
        crash at any point recoverable: the live and dead arrays, then the
        exact state (temporary file, then ``os.replace``: always one whole
        snapshot, stamped with ``it``), then the ``checkpoint_<it>.txt``
        marker. The cumulative ``saved_*`` files may run ahead of an older
        marker; the loader cuts them to its iteration."""
        ck = self.logs['checkpoint']
        it = st.it
        live = {name: np.array(getattr(st, name)) for name in (
            'active_u', 'active_v', 'active_logl', 'active_derived')}
        saved = {name: np.asarray(getattr(st, name))
                 for name in ('saved_v', 'saved_logl', 'saved_logwt')}
        if st.saved_slots is not None:
            saved['saved_slots'] = np.asarray(st.saved_slots, dtype=np.uint32)
        if st.saved_u is not None:
            saved['saved_u'] = np.asarray(st.saved_u, np.float64).reshape(
                -1, self.x_dim)
        exact = {
            'it': int(it),
            'generator': self.generator.get_state(),
            'trainer': self.trainer.snapshot_state(),
            'controller': st.controller(self._max_log_det_j, self._max_r),
            'pool': _tensors(st.pool_state()),
            'insertion_ranks': torch.as_tensor(st.insertion_ranks,
                                               dtype=torch.int64),
        }
        meta = {'logz': float(st.logz), 'h': float(st.h),
                'logvol': float(st.logvol), 'ncall': self.total_calls,
                'fraction_remain': float(st.fraction_remain),
                'strategy': list(strategy),
                'expired_strategies': list(st.expired),
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
        (:meth:`_restore_exact_state`), as a :class:`_RunState`."""
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
        # Thread slots and u-space dead points: short or absent disables
        # the bootstrap error, or saved_u.
        for name, row in (('saved_slots', int), ('saved_u', np.array)):
            path = os.path.join(ck, name + '.npy')
            a = np.load(path) if os.path.exists(path) else None
            saved[name] = (None if a is None or len(a) < it
                           else [row(r) for r in a[:it]])
        self.total_calls = int(meta['ncall'])
        self.total_accepted = int(meta['total_accepted'])
        self.total_rejected = int(meta['total_rejected'])
        self.total_fast_calls = int(meta.get('total_fast_calls', 0))
        st = _RunState(
            active_u, self.transform(active_u), active_logl, active_derived,
            **saved, it=it, logz=meta['logz'], h=meta['h'],
            logvol=meta['logvol'], fraction_remain=meta['fraction_remain'],
            expired=list(meta['expired_strategies']))
        self._restore_exact_state(ck, st)
        return st

    def _restore_exact_state(self, ck, st):
        """Restore the sampler's generator and the trainer from the exact
        state, and the run state ``st``'s insertion ranks, controller and
        pool (:meth:`_RunState.restore`).

        A stamp equal to ``st.it`` gives a bit-exact resume. A stamp from
        another iteration (a crash between the state's replace and its
        marker, or a fall back to an older marker) still restores the
        generator, the trainer and the first ``st.it`` insertion ranks, all
        valid states, but drops the controller and the pool: the resume is
        statistically exact. An unreadable state restores nothing."""
        try:
            es = torch.load(os.path.join(ck, EXACT_STATE), map_location='cpu',
                            weights_only=True)
            self.trainer.restore_state(es['trainer'])
            self.generator.set_state(es['generator'])
            ranks = [int(x) for x in es['insertion_ranks'][:st.it]]
        except Exception as e:  # unreadable: keep the marker's arrays only
            self.logger.warning('Could not restore the exact state (%r); '
                                'resume is statistically (not bit-) exact'
                                % (e,))
            return
        st.insertion_ranks = ranks
        if es['it'] != st.it:
            self.logger.warning(
                'Exact state is from iteration %s but the checkpoint is %d; '
                'resume is statistically (not bit-) exact' % (es['it'], st.it))
            return
        st.restore(es['controller'], _arrays(es['pool']))
