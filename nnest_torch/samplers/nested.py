"""Nested sampler: evidence (logZ) and posterior samples.

Port of ``nnest_tpu/samplers/nested.py`` without meshes: the strategy
ladder over ``'rejection_prior'``, ``'rejection_flow'``, ``'density_flow'``,
``'mcmc'`` and ``'slice'`` with efficiency-based expiry (a rejection phase
expires once its likelihood calls per candidate pass those of the
downstream kernel: ``mcmc_steps``, or ``slice_steps * (1 +
slice_max_expand)`` for slice), the adaptive rejection trial
ladder, the NLL-gated flow retrain (which also invalidates the
flow-rejection envelope), one candidate pool generation per call consumed
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

``run(mcmc_gen_batch=, rejection_gen_batch=, mcmc_speculate=)`` are
accepted and checked: ``nnest_tpu`` prefetches that many generations a
dispatch, with results that do not depend on them; this port dispatches
one generation at a time for every value (the prefetch is ROADMAP A.6).
Meshes are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import csv
import json
import logging
import os
import re
import time

import numpy as np
import torch

from nnest_torch.priors import UniformPrior
from nnest_torch.samplers.base import Sampler
from nnest_torch.utils.evaluation import (adjusted_logzerr,
                                          bootstrap_logz_error, insertion_ks,
                                          rolling_insertion_ks)

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
    return tree


def _arrays(tree):
    """Inverse of :func:`_tensors`."""
    if isinstance(tree, torch.Tensor):
        return tree.numpy()
    if isinstance(tree, dict):
        return {k: _arrays(v) for k, v in tree.items()}
    return tree


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
                 device='cuda'):
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
            use_gpu=use_gpu, device=device)
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

    def run(self, *args, **kwargs):
        """Run the sampler; the arguments are :meth:`_run_impl`'s. This
        wrapper closes the progress bar when the run raises (a likelihood's
        exception, a keyboard interrupt), which would otherwise garble the
        log lines that follow."""
        self._run_pbar = None
        try:
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
        ``rejection_gen_batch`` (integers >= 1) and ``mcmc_speculate`` (a
        bool) are checked and change nothing here (module docstring);
        ``show_progress`` shows a tqdm bar. The dynamic-batch hooks
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
                    'pool_pos': int(pool_pos)}

        # counts, and host wall seconds of the phases (each ends in a device
        # to host copy, so the clock covers the device work)
        self.run_stats = {'trainings': 0, 'retrains_skipped': 0,
                          'train_s': 0.0, 'checkpoints': 0,
                          'checkpoint_s': 0.0}
        for stem in _STAT_KEY.values():
            self.run_stats[stem + '_generations'] = 0
            self.run_stats[stem + '_s'] = 0.0

        def checkpoint():
            if self.logs is None:
                return
            t0 = time.perf_counter()
            self._write_checkpoint(
                it, active_u, active_v, active_logl, active_derived,
                saved_v, saved_logl,
                saved_logwt, saved_slots, saved_u, logz, h, logvol,
                fraction_remain, strategy, expired, controller_snapshot(),
                pool_snapshot(), insertion_ranks)
            self.run_stats['checkpoint_s'] += time.perf_counter() - t0
            self.run_stats['checkpoints'] += 1

        if state is None:
            checkpoint()

        pbar = None
        if show_progress:
            try:
                from tqdm import tqdm
            except ImportError:
                tqdm = None
            if tqdm is not None:
                pbar = self._run_pbar = tqdm(initial=it, unit='it',
                                             desc='nested',
                                             dynamic_ncols=True)

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
                    nll_now = -float(np.mean(self.trainer.log_probs(
                        active_u.astype(np.float32), to_numpy=True)))
                    retrain = not (nll_now < self.trainer.best_validation_loss
                                   + retrain_nll_threshold)
                if retrain:
                    t0 = time.perf_counter()
                    self.trainer.train(active_u.astype(np.float32),
                                       max_iters=train_iters, jitter=jitter)
                    self.run_stats['train_s'] += time.perf_counter() - t0
                    self.run_stats['trainings'] += 1
                    first_time = False
                    # The envelope is a function of the flow: a retrain
                    # invalidates it.
                    self._max_log_det_j = None
                else:
                    self.run_stats['retrains_skipped'] += 1

            if need_pool:
                stem = _STAT_KEY[current_method]
                t0 = time.perf_counter()
                if current_method in ('mcmc', 'slice'):
                    if current_method == 'mcmc':
                        u_f, logl_f, d_f, moved, mcmc_scale, _, _ = \
                            self._mcmc_sample_live(
                                mcmc_steps, active_u, active_logl,
                                mcmc_num_chains, loglstar, step_size,
                                dynamic_step_size=mcmc_dynamic_step_size,
                                adapt_cov=mcmc_adapt == 'cov',
                                active_derived=active_derived)
                    else:
                        u_f, logl_f, d_f, moved, mcmc_scale, _, _ = \
                            self._slice_sample_live(
                                slice_steps, active_u, active_logl,
                                mcmc_num_chains, loglstar, slice_width,
                                max_expand=slice_max_expand,
                                max_shrink=slice_max_shrink,
                                adapt_cov=slice_adapt == 'cov',
                                active_derived=active_derived)
                    # Chain endpoints are the candidates: a chain that
                    # never moved contributes nothing.
                    pool = {'u': u_f[moved], 'logl': logl_f[moved],
                            'derived': d_f[moved],
                            'stats': self._last_kernel_stats}
                else:
                    if current_method == 'rejection_prior':
                        s, ll, ds, nc = self._rejection_prior_sample(
                            loglstar, num_trials=cur_trials)
                    elif current_method == 'rejection_flow':
                        # A fresh envelope after a retrain or every
                        # rejection_cache_interval generations; in between
                        # the live set's values are max-folded into it.
                        recompute = (self._max_log_det_j is None
                                     or env_gens >= rejection_cache_interval)
                        s, ll, ds, nc = self._rejection_flow_sample(
                            active_u, loglstar,
                            enlargement_factor=rejection_enlargement_factor,
                            cache=not recompute, num_trials=cur_trials)
                        env_gens = 0 if recompute else env_gens + 1
                    else:
                        s, ll, ds, nc = self._density_sample(
                            loglstar, num_trials=cur_trials)
                    if rejection_adapt_trials:
                        # Power-of-two trial ladder: keep candidates per
                        # generation near trials_target as the shell
                        # shrinks.
                        n_ok = int(s.shape[0])
                        if (n_ok < trials_target // 2
                                and cur_trials * 2 <= rejection_max_trials):
                            cur_trials *= 2
                        elif (n_ok > trials_target * 2
                                and cur_trials >= 2 * rejection_batch_size):
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
                    pool = {'u': s, 'logl': ll, 'derived': ds}
                self.run_stats[stem + '_s'] += time.perf_counter() - t0
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
                            self._submit_io(
                                lambda v=self.samples, ll=self.loglikes,
                                w=self.weights:
                                self._save_samples(v, ll, weights=w))

        if pbar is not None:
            pbar.close()
            self._run_pbar = None

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
        t0 = time.perf_counter()
        self._close_io()
        self.run_stats['checkpoint_s'] += time.perf_counter() - t0
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
        corrupt checkpoint falls back to the next older one."""
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
