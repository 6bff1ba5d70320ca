"""Dynamic nested sampling: live points where the uncertainty is.

Port of ``nnest_tpu/samplers/dynamic.py``. The scheme of
Higson et al. 2019 (arXiv:1704.03459): a static pass first, then batches
of live points over the likelihood range that dominates the evidence or
posterior uncertainty; the combined run has varying live counts n(L), and
its evidence comes from the per-point (birth, death) record
(``utils/evaluation.merge_runs``).

- A batch above the floor L_lo starts from live points uniform in
  {logl > L_lo}: indices drawn with a seeded ``np.random.RandomState`` from
  the union of the points alive at L_lo (birth <= L_lo < death) across the
  runs so far, then refreshed by the constrained latent Metropolis kernel at
  ``loglstar = L_lo`` (``Sampler._mcmc_sample_final``), which runs the CUDA
  spline-chain inverse on the card like every nested generation.
- The batch is a ``NestedSampler`` run with ``init_points``,
  ``birth_floor`` and ``logl_ceiling`` (it stops once every live point
  exceeds L_hi); its final live points enter the merged record as
  ramp-down deaths. Above a floor, prior rejection is dropped from its
  strategy.
- All batches share one ``Trainer`` (one flow), so the NLL retrain gate
  skips training over territory the flow already fits.
- Derived parameters (``num_derived`` among the batches' keyword
  arguments) ride along: the seeds take theirs from the parts' samples
  (the columns after x_dim), and the merged ``samples`` keep them.

- ``mesh=`` passes to every batch (:mod:`nnest_torch.parallel`): the ranks
  run in lockstep, the batches' chains and the seed refresh dp-sharded.
  Rank 0 alone holds the run directory; it reads the resume bundle and
  looks for a batch's checkpoint, and broadcasts what it found.

The window [L_lo, L_hi] follows dynesty's ``weight_function``: I(i) =
(1 - G) Z_remain(i)/max + G w_i/max over the sorted deaths, the batch
spanning {i : I(i) > maxfrac max I} padded by one point; G = 0 targets the
evidence, G = 1 the posterior.
"""

from __future__ import annotations

import csv
import glob
import json
import logging
import os
import pickle

import numpy as np
import torch.distributed as dist

from nnest_torch.parallel.mesh import broadcast_exact
from nnest_torch.samplers.nested import NestedSampler
from nnest_torch.utils.device import resolve_device
from nnest_torch.utils.evaluation import merge_runs, thread_birth_logl
from nnest_torch.utils.logger import create_logger, get_or_create_run_dir


class DynamicNestedSampler:
    """Dynamic nested sampling over ``NestedSampler`` batches.

    The keyword arguments beyond these are passed to every batch's
    ``NestedSampler``; ``num_live_init`` is the static pass's live count,
    and batches take ``max(50, num_live_init // 5)`` by default. After
    :meth:`run`: ``logz``, ``logzerr``, ``h``, ``samples``, ``weights``,
    ``loglikes``, ``n_live`` (the live count at each death, ascending),
    ``total_calls``, ``niter``, ``insertion_p_value`` (the batches' KS
    p-values combined by Fisher's method) and :attr:`posterior_ess`.
    Artifacts: ``info/params.txt``, ``results/{diagnostics.json,final.csv,
    n_live.npy}`` and ``chains/chain.txt`` in the run directory, each
    batch's own tree under ``batches/``.

    With ``resume=True`` (which needs ``append_run_num=False``, so the run
    directory is pinned) ``checkpoint/dynamic_state.pkl`` is written
    atomically after every batch: the ingested batches, the RandomState of
    the seed draws, the counters, and the shared trainer's snapshot (the
    flow's ``state_dict``, the Adam state, the generator); every batch runs
    with its own exact checkpoints. A run killed between batches continues
    from the bundle; a batch killed mid-run continues from its own
    checkpoint, its seed draw replayed (so later batches see the same
    stream) and its seed refresh skipped (its checkpoint holds the state
    after it). The continued run equals the uninterrupted one.
    """

    def __init__(self,
                 x_dim,
                 loglike,
                 transform=None,
                 num_live_init=500,
                 log_dir='logs/dynamic',
                 append_run_num=True,
                 resume=False,
                 seed=0,
                 log_level=logging.INFO,
                 device='cuda',
                 mesh=None,
                 **sampler_kwargs):
        self.device = resolve_device(device)
        self._mesh = mesh
        # rank 0 alone owns the run directory
        self._ranks = (dist.get_world_size()
                       if dist.is_available() and dist.is_initialized()
                       else 1)
        if self._ranks > 1 and dist.get_rank() != 0:
            log_dir = None
        self.x_dim = x_dim
        self.num_live_init = int(num_live_init)
        self._loglike = loglike
        self._transform = transform
        self._seed = int(seed)
        self._sampler_kwargs = dict(sampler_kwargs)
        self._log_level = log_level
        self._resume = bool(resume)
        if self._resume and append_run_num:
            raise ValueError('resume=True needs append_run_num=False so '
                             'the run dir (and its checkpoint) is pinned')

        self.logs = (get_or_create_run_dir(log_dir, append_run_num)
                     if log_dir is not None else None)
        self.logger = create_logger(__name__, level=log_level)
        if self.logs is not None:
            with open(os.path.join(self.logs['info'], 'params.txt'),
                      'w') as f:
                json.dump({'x_dim': x_dim, 'sampler': 'dynamic',
                           'num_live_points': self.num_live_init,
                           'seed': seed}, f)

        # the batch-seed draws: seeded, so a rerun draws the same indices
        self._rng = np.random.RandomState(seed)
        self._parts = []          # per batch {logl, birth_logl, u, samples}
        self._trainer = None      # the flow all batches share
        self._pending_trainer = None   # a snapshot from a resume bundle

        # set by run()
        self.logz = None
        self.logzerr = None
        self.h = None
        self.samples = None
        self.weights = None
        self.loglikes = None
        self.n_live = None
        self.total_calls = 0
        self.niter = 0
        self.insertion_p_value = None

    # ------------------------------------------------------------ batches

    def _make_sampler(self, num_live, tag, seed):
        sub_dir = (os.path.join(self.logs['run_dir'], 'batches', tag)
                   if self.logs is not None else None)
        s = NestedSampler(
            self.x_dim, self._loglike, transform=self._transform,
            num_live_points=num_live, log_dir=sub_dir, append_run_num=False,
            resume=self._resume, seed=seed, trainer=self._trainer,
            log_level=max(self._log_level, logging.WARNING),
            device=self.device, mesh=self._mesh, **self._sampler_kwargs)
        if self._trainer is None:
            self._trainer = s.trainer
        if self._pending_trainer is not None:
            # The shared flow from the resume bundle, bound once the trainer
            # exists; a batch's own newer checkpoint overrides it in run().
            self._trainer.restore_state(self._pending_trainer)
            self._pending_trainer = None
        return s

    def _batch_has_checkpoint(self, s):
        """True when the batch's run directory holds a checkpoint: the batch
        was killed mid-run (or finished before its ingest reached the
        bundle), so ``s.run()`` continues from it and the seed refresh
        must not run again. Rank 0's answer on every rank."""
        found = s.logs is not None and bool(glob.glob(os.path.join(
            s.logs['checkpoint'], 'checkpoint_*.txt')))
        return broadcast_exact(found) if self._ranks > 1 else found

    def _ingest(self, s, tag):
        """Record a finished batch in (birth, death) form."""
        if s.saved_u is None or s.thread_slots is None:
            raise RuntimeError('batch run did not record saved_u/threads')
        logl = np.asarray(s.loglikes, np.float64)
        part = {
            'logl': logl,
            'birth_logl': thread_birth_logl(
                logl, s.thread_slots, s.num_live_points,
                birth_floor=s._birth_floor),
            'u': np.asarray(s.saved_u, np.float64),
            'samples': np.asarray(s.samples, np.float64),
            # for the merged run's diagnostics (merge_runs ignores them)
            'tag': tag,
            'logz': float(s.logz),
            'logzerr': float(s.logzerr),
            'ncall': int(s.total_calls),
            'insertion_p': (None if s.insertion_p_value is None
                            else float(s.insertion_p_value)),
        }
        self._parts.append(part)
        self.total_calls += int(s.total_calls)
        self.niter += int(s.niter)
        self._save_state()
        return part

    # ------------------------------------------------- checkpoint bundle

    def _state_path(self):
        return (None if self.logs is None else
                os.path.join(self.logs['checkpoint'], 'dynamic_state.pkl'))

    def _save_state(self):
        """The bundle after an ingested batch, written to a temporary file
        and moved into place (a crash mid-write keeps the previous bundle,
        and the newer batch continues from its own directory). Only with
        ``resume=True``: no later run could find it otherwise, and it
        grows with every point saved."""
        path = self._state_path()
        if path is None or not self._resume:
            return
        bundle = {
            'completed_batches': len(self._parts),
            'parts': self._parts,
            'rng_state': self._rng.get_state(),
            'total_calls': int(self.total_calls),
            'niter': int(self.niter),
            # the flow's state_dict, the Adam state and the generator
            'trainer_state': self._trainer.snapshot_state(),
        }
        with open(path + '.tmp', 'wb') as f:
            pickle.dump(bundle, f)
        os.replace(path + '.tmp', path)

    def _load_state(self):
        """The resume bundle, or None; rank 0's on every rank."""
        path = self._state_path()
        state = None
        if path is not None and os.path.exists(path):
            with open(path, 'rb') as f:
                state = pickle.load(f)
        return broadcast_exact(state) if self._ranks > 1 else state

    @staticmethod
    def batch_bounds(merged, parts, G=0.25, maxfrac=0.8):
        """dynesty's importance window for the next batch: ``(L_lo,
        L_hi)``, with ``L_lo = -inf`` to seed from the prior and ``L_hi =
        None`` to run to the batch's own ``dlogz`` (the window reaches the
        largest likelihood)."""
        logl = np.concatenate([p['logl'] for p in parts])
        order = merged['order']
        logl_s = logl[order]
        logwt_s = np.asarray(merged['logwt'], np.float64)[order]
        # Z_remain(i) = logsumexp(logwt[i:]), a reversed accumulate
        logz_remain = np.logaddexp.accumulate(logwt_s[::-1])[::-1]
        zimp = np.exp(logz_remain - logz_remain[0])          # 1 -> 0
        pimp = np.exp(logwt_s - np.max(logwt_s))             # max 1
        imp = (1.0 - G) * zimp + G * pimp
        sel = np.nonzero(imp > maxfrac * float(np.max(imp)))[0]
        lo, hi = int(sel[0]), int(sel[-1])
        # padded by one point each side, so the batch brackets the window
        L_lo = -np.inf if lo <= 1 else float(logl_s[lo - 1])
        L_hi = (None if hi >= logl_s.size - 2
                else float(logl_s[min(hi + 1, logl_s.size - 1)]))
        return L_lo, L_hi

    def _seed_batch(self, s, L_lo, num_live, mcmc_steps, refresh=True):
        """Live points for a batch above ``L_lo``: indices drawn from the
        union of the points alive at L_lo, then refreshed by constrained
        Metropolis at loglstar = L_lo (which decorrelates the draws with
        replacement and keeps them uniform in {logl > L_lo}).

        With ``refresh=False`` (the batch continues from its own
        checkpoint) only the index draw runs, so that ``self._rng`` moves
        as in the uninterrupted run; returns None then."""
        pool_u, pool_logl, pool_derived = [], [], []
        for p in self._parts:
            alive = (p['birth_logl'] <= L_lo) & (p['logl'] > L_lo)
            # strict float32 margin: the kernels compare f32(logl) >
            # f32(loglstar), and a start equal in float32 would stall
            alive &= p['logl'].astype(np.float32) > np.float32(L_lo)
            pool_u.append(p['u'][alive])
            pool_logl.append(p['logl'][alive])
            pool_derived.append(p['samples'][alive][:, s.x_dim:])
        pool_u = np.concatenate(pool_u)
        pool_logl = np.concatenate(pool_logl)
        pool_derived = np.concatenate(pool_derived)
        if pool_u.shape[0] == 0:
            raise RuntimeError('no live-at-threshold points above L_lo=%r '
                               'to seed the batch' % L_lo)
        idx = self._rng.randint(0, pool_u.shape[0], size=num_live)
        if not refresh:
            return None
        u, logl, derived, _, _, _, _ = s._mcmc_sample_final(
            mcmc_steps, init_samples=pool_u[idx],
            init_loglikes=pool_logl[idx], init_derived=pool_derived[idx],
            loglstar=float(L_lo), dynamic_step_size=True)
        return {'u': u, 'v': s.transform(u), 'logl': logl,
                'derived': derived}

    # ---------------------------------------------------------------- run

    def run(self,
            G=0.25,
            num_batches=4,
            num_live_batch=None,
            maxfrac=0.8,
            dlogz=0.5,
            seed_mcmc_steps=0,
            **run_kwargs):
        """The static pass and ``num_batches`` batches, then the merged
        evidence. ``G`` trades evidence (0) against posterior (1)
        precision; ``run_kwargs`` go to every batch's
        ``NestedSampler.run``. ``seed_mcmc_steps`` (default: the run's
        ``mcmc_steps``, else 5 x_dim) are the seed refresh's steps.

        With ``resume=True`` an earlier call's state continues (pass the
        same arguments): finished batches from ``dynamic_state.pkl``, the
        batch in flight from its own checkpoint."""
        num_live_batch = int(num_live_batch or
                             max(50, self.num_live_init // 5))
        if seed_mcmc_steps <= 0:
            seed_mcmc_steps = (run_kwargs.get('mcmc_steps', 0)
                               or 5 * self.x_dim)

        completed = 0
        if self._resume:
            state = self._load_state()
            if state is not None:
                self._parts = list(state['parts'])
                self._rng.set_state(state['rng_state'])
                self.total_calls = int(state['total_calls'])
                self.niter = int(state['niter'])
                completed = int(state['completed_batches'])
                self._pending_trainer = state['trainer_state']
                self.logger.info('Resumed dynamic run: %d batch(es) already '
                                 'ingested' % completed)

        if completed == 0:
            s0 = self._make_sampler(self.num_live_init, 'batch0', self._seed)
            s0.run(dlogz=dlogz, **run_kwargs)
            self._ingest(s0, 'batch0')
            completed = 1
            self.logger.info('Dynamic batch 0 (static, %d live): logz %.3f '
                             'ncall %d' % (self.num_live_init, s0.logz,
                                           s0.total_calls))

        for b in range(completed, int(num_batches) + 1):
            merged = merge_runs(self._parts)
            L_lo, L_hi = self.batch_bounds(merged, self._parts, G=G,
                                           maxfrac=maxfrac)
            s = self._make_sampler(num_live_batch, 'batch%d' % b,
                                   self._seed + 7919 * b)
            batch_kwargs = dict(run_kwargs)
            init_points = None    # prior-seeded, as a static run
            if np.isfinite(L_lo):
                init_points = self._seed_batch(
                    s, L_lo, num_live_batch, seed_mcmc_steps,
                    refresh=not self._batch_has_checkpoint(s))
                # Prior rejection above a floor accepts ~X(L_lo) of its
                # trials and would burn its whole ladder before expiring.
                st = [m for m in (batch_kwargs.get('strategy')
                                  or ['rejection_prior', 'mcmc'])
                      if m != 'rejection_prior']
                batch_kwargs['strategy'] = st or ['mcmc']
            s.run(dlogz=dlogz, init_points=init_points,
                  birth_floor=float(L_lo) if np.isfinite(L_lo) else None,
                  logl_ceiling=L_hi, **batch_kwargs)
            self._ingest(s, 'batch%d' % b)
            self.logger.info(
                'Dynamic batch %d (%d live, logl in [%s, %s]): ncall %d'
                % (b, num_live_batch,
                   '%.4g' % L_lo if np.isfinite(L_lo) else '-inf',
                   '%.4g' % L_hi if L_hi is not None else 'max',
                   s.total_calls))

        merged = merge_runs(self._parts)
        self.logz = float(merged['logz'])
        self.h = float(merged['h'])
        self.logzerr = float(merged['logzerr'])
        self.n_live = np.asarray(merged['n_live'])
        self.loglikes = np.concatenate([p['logl'] for p in self._parts])
        self.samples = np.concatenate([p['samples'] for p in self._parts])
        self.weights = np.exp(np.asarray(merged['logwt'], np.float64)
                              - merged['logz'])
        self.logger.info(
            'Dynamic run: logz %.4f +/- %.4f (h %.3f, ncall %d, %d points, '
            'peak n_live %d)' % (self.logz, self.logzerr, self.h,
                                 self.total_calls, self.loglikes.size,
                                 int(np.max(self.n_live))))

        # Each batch's insertion-rank KS p-value is Uniform(0, 1) under
        # exact constrained sampling: Fisher's method (chi2 with 2k dof on
        # -2 sum log p) combines them into the merged run's.
        pvals = [p['insertion_p'] for p in self._parts
                 if p.get('insertion_p') is not None]
        self.insertion_p_value = None
        if pvals:
            from scipy.stats import chi2
            stat = -2.0 * float(np.sum(np.log(np.clip(pvals, 1e-300, 1.0))))
            self.insertion_p_value = float(chi2.sf(stat, 2 * len(pvals)))
            if self.insertion_p_value < 0.01:
                self.logger.warning(
                    'Merged insertion-rank p = %.4g < 0.01: within-shell '
                    'sampling may be imperfect in one or more batches'
                    % self.insertion_p_value)

        if self.logs is not None:
            self._write_results()
        return self.logz

    def _write_results(self):
        """``diagnostics.json``, ``final.csv``, ``n_live.npy`` and
        ``chain.txt`` (rows: weight, -logl, the point, its derived
        values)."""
        with open(os.path.join(self.logs['results'], 'diagnostics.json'),
                  'w') as f:
            json.dump({
                'sampler': 'dynamic',
                'logz': self.logz, 'logzerr': self.logzerr, 'h': self.h,
                'ncall': int(self.total_calls), 'niter': int(self.niter),
                'posterior_ess': self.posterior_ess,
                'peak_n_live': int(np.max(self.n_live)),
                'insertion_p': self.insertion_p_value,
                'batches': [{k: p.get(k) for k in (
                    'tag', 'logz', 'logzerr', 'ncall', 'insertion_p')}
                    for p in self._parts],
            }, f, indent=1)
        with open(os.path.join(self.logs['results'], 'final.csv'), 'w') as f:
            w = csv.writer(f)
            w.writerow(['niter', 'ncall', 'logz', 'logzerr', 'h'])
            w.writerow([self.niter, self.total_calls, self.logz,
                        self.logzerr, self.h])
        rows = np.hstack([self.weights[:, None], -self.loglikes[:, None],
                          self.samples])
        np.savetxt(os.path.join(self.logs['chains'], 'chain.txt'), rows,
                   fmt='%.5E')
        np.save(os.path.join(self.logs['results'], 'n_live.npy'),
                self.n_live)

    @property
    def posterior_ess(self):
        """Kish's effective sample size of the merged weights."""
        w = np.asarray(self.weights, np.float64)
        return float(np.sum(w) ** 2 / np.sum(w ** 2))
