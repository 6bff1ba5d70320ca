"""Nested sampler: evidence (logZ) and posterior samples.

Port of the main path of ``nnest_tpu/samplers/nested.py``: the strategy
ladder ``['rejection_prior', 'mcmc']`` with efficiency-based expiry, the
adaptive rejection trial ladder, the NLL-gated flow retrain, one candidate
pool generation per call consumed across iterations, and the float64 host
evidence (logz, h, logzerr). The worst-point replacement loop stays on the
host in float64; candidate generation (prior rejection, covariance-
preconditioned constrained latent MCMC) and flow training run on the
sampler's device.

Artifacts under ``<log_dir>/runN/``: ``info/params.txt``,
``results/results.csv``, ``results/final.csv``, ``chains/chain.txt``.

Not ported yet (ROADMAP.md): checkpoints and resume, meshes, the slice,
rejection-flow and density strategies, multi-generation prefetch and
speculation, dynamic-batch hooks, plots and TensorBoard, the insertion
KS test, the bootstrap error, ``adjusted_logzerr`` and
``diagnostics.json``.
"""

from __future__ import annotations

import csv
import logging
import os
import time

import numpy as np

from nnest_torch.priors import UniformPrior
from nnest_torch.samplers.base import Sampler

_PORTED_METHODS = ('rejection_prior', 'mcmc')


class NestedSampler(Sampler):

    def __init__(self,
                 x_dim,
                 loglike,
                 transform=None,
                 append_run_num=True,
                 hidden_dim=0,
                 batch_size=100,
                 flow='spline',
                 num_blocks=3,
                 learning_rate=0.001,
                 log_dir='logs/test',
                 trainer=None,
                 log_level=logging.INFO,
                 param_names=None,
                 num_live_points=1000,
                 seed=0,
                 device='cuda'):
        # The sampling unit cube is [-1, 1]^d; ``transform`` maps it to
        # physical space.
        prior = UniformPrior(x_dim, -1.0, 1.0)
        prior.seed(seed)
        self.sampler = 'nested'
        super().__init__(
            x_dim, loglike, transform=transform, prior=prior,
            append_run_num=append_run_num, hidden_dim=hidden_dim,
            batch_size=batch_size, flow=flow, num_blocks=num_blocks,
            learning_rate=learning_rate, log_dir=log_dir, trainer=trainer,
            log_level=log_level, param_names=param_names, seed=seed,
            device=device)
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

    def run(self,
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
            rejection_batch_size=512,
            rejection_max_trials=65536,
            rejection_adapt_trials=True,
            retrain_nll_threshold=0.5,
            mcmc_adapt='cov'):
        if strategy is None or len(strategy) == 0:
            strategy = ['rejection_prior', 'mcmc']
        unknown = [m for m in strategy if m not in _PORTED_METHODS]
        if unknown:
            raise ValueError('strategy method(s) %s are not ported; choose '
                             'from %s' % (unknown, list(_PORTED_METHODS)))
        if mcmc_adapt not in ('cov', 'iso'):
            raise ValueError("mcmc_adapt must be 'cov' or 'iso'")
        expired = []

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
        if step_size <= 0.0:
            step_size = 1.0 / self.x_dim ** 0.5
        rejection_max_trials = max(int(rejection_max_trials),
                                   rejection_batch_size)
        self.logger.info('MCMC steps [%d]' % mcmc_steps)
        self.logger.info('Initial scale [%5.4f]' % step_size)

        active_u = np.asarray(self._user_prior.sample(self.num_live_points),
                              dtype=np.float64)
        active_v = self.transform(active_u)
        active_logl = self.loglike(active_u)
        self.logger.info('Step [0] max logl [%5.4e] vol [1.0] ncalls [%d]'
                         % (np.max(active_logl), self.total_calls))

        saved_v, saved_logl, saved_logwt = [], [], []
        h = 0.0
        logz = -1e300
        logvol = float(np.log(1.0 - np.exp(-1.0 / self.num_live_points)))
        fraction_remain = 1.0
        it = 0
        first_time = True
        last_trained_it = -1
        need_pool = True
        pool = None
        pool_pos = 0
        ncs = []
        mean_calls = 0.0
        mcmc_scale = step_size
        accept_point = True
        cur_trials = int(rejection_batch_size)
        trials_target = max(16, self.num_live_points // 8)
        current_method = next(m for m in strategy if m not in expired)
        # counts, and host wall seconds of the phases (each ends in a device
        # to host copy, so the clock covers the device work)
        self.run_stats = {'rejection_generations': 0, 'mcmc_generations': 0,
                          'trainings': 0, 'retrains_skipped': 0,
                          'rejection_s': 0.0, 'mcmc_s': 0.0, 'train_s': 0.0}

        while fraction_remain > dlogz and it <= max_iters:
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
                saved_v.append(np.array(active_v[worst], copy=True))
                saved_logwt.append(logwt)
                saved_logl.append(active_logl[worst])
                accept_point = False

            # Strategy ladder: the first method not expired.
            old_method = current_method
            current_method = next(m for m in strategy if m not in expired)
            if current_method != old_method:
                need_pool = True
                cur_trials = int(rejection_batch_size)
            mcmc_like = 'mcmc' if 'mcmc' in strategy else None

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
                else:
                    self.run_stats['retrains_skipped'] += 1

            if current_method == 'rejection_prior' and need_pool:
                t0 = time.perf_counter()
                s, ll, nc = self._rejection_prior_sample(
                    loglstar, num_trials=cur_trials)
                self.run_stats['rejection_s'] += time.perf_counter() - t0
                self.run_stats['rejection_generations'] += 1
                if rejection_adapt_trials:
                    # Power-of-two trial ladder: keep candidates per
                    # generation near trials_target as the shell shrinks.
                    n_ok = int(s.shape[0])
                    if (n_ok < trials_target // 2
                            and cur_trials * 2 <= rejection_max_trials):
                        cur_trials *= 2
                    elif (n_ok > trials_target * 2
                            and cur_trials >= 2 * rejection_batch_size):
                        cur_trials //= 2
                # Efficiency window; each generation contributes at most 5
                # entries so the switch averages several generations.
                ncs.extend([nc] * min(max(s.shape[0], 1), 5))
                mean_calls = (float(np.mean(ncs[-20:])) if len(ncs) > 20
                              else 0.0)
                switch = (0 <= volume_switch > expected_vol) or (
                    volume_switch < 0 and mean_calls > mcmc_steps
                    and mcmc_like is not None)
                if switch:
                    self.logger.info('%s no longer efficient, switching '
                                     'sampling method' % current_method)
                    expired.append(current_method)
                    ncs = []
                pool = {'u': s, 'logl': ll}
                pool_pos = 0
                need_pool = False

            elif current_method == 'mcmc' and need_pool:
                t0 = time.perf_counter()
                u_f, logl_f, moved, mcmc_scale, _, _ = \
                    self._mcmc_sample_live(
                        mcmc_steps, active_u, active_logl, mcmc_num_chains,
                        loglstar, step_size,
                        dynamic_step_size=mcmc_dynamic_step_size,
                        adapt_cov=mcmc_adapt == 'cov')
                self.run_stats['mcmc_s'] += time.perf_counter() - t0
                self.run_stats['mcmc_generations'] += 1
                # Chain endpoints are the candidates: a chain that never
                # moved contributes nothing.
                pool = {'u': u_f[moved], 'logl': logl_f[moved],
                        'stats': self._last_kernel_stats}
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
                        active_u[worst] = u[ib, :]
                        active_v[worst] = self.transform(active_u[worst])[0]
                        active_logl[worst] = pool['logl'][ib]
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

        # Integrate the remaining live points.
        logvol = (-len(saved_v) / self.num_live_points
                  - np.log(self.num_live_points))
        for i in range(self.num_live_points):
            logwt = logvol + active_logl[i]
            logz_new = np.logaddexp(logz, logwt)
            h = (np.exp(logwt - logz_new) * active_logl[i]
                 + np.exp(logz - logz_new) * (h + logz) - logz_new)
            logz = logz_new
            saved_v.append(np.array(active_v[i]))
            saved_logwt.append(logwt)
            saved_logl.append(active_logl[i])

        self.logz = logz
        self.h = h
        self.logzerr = float(np.sqrt(h / self.num_live_points))
        self.niter = it + 1
        self.samples = np.asarray(saved_v)
        self.weights = np.exp(np.asarray(saved_logwt) - logz)
        self.loglikes = np.asarray(saved_logl)
        if self.logs is not None:
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
        return self.logz

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
