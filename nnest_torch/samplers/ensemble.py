"""Ensemble sampler: affine-invariant ensemble MCMC in the flow's latent
space.

Port of ``nnest_tpu/samplers/ensemble.py`` without meshes:

- :func:`real_space_stretch`: a Goodman-Weare stretch ensemble on any log
  density of (batch, d) tensors, the bootstrap's phase 0 (no flow);
- :meth:`EnsembleSampler.bootstrap`: phase 0, a real-space ensemble on
  loglike + prior (or the chain of an ``emcee.h5`` in the run directory),
  thinned by its integrated autocorrelation time; then phases 1 to
  ``iters``, each training the flow on the normalised training set (its
  de-normalisation becomes the sampler transform, the flow warm-starting
  from the previous phase's weights and Adam moments), running the latent
  ensemble and re-thinning its chains by a Bernoulli(1/thin) draw
  (getdist's ``makeSingleSamples`` on unit weights) from the sampler's
  generator;
- :meth:`EnsembleSampler.run`: normalise, train, one latent ensemble.

Both log the chain statistics of a latent ensemble of at least
``stats_interval`` steps and write its chains as ``chains/chain_<i>.txt``
when ``output_interval`` is given.

Checkpoints: each completed phase p writes ``checkpoint/bootstrap_<p>.pt``
(``torch.save`` to a temporary file, then ``os.replace``) with its chains,
the thinned training set, the sampler's generator state, ``total_calls``,
``total_accepted``, ``total_rejected`` and the trainer snapshot. With
``resume=True`` a bootstrap skips the completed phases: it restores the
newest readable checkpoint (a corrupt newest one falls back to the next
older; one that loads only partly changes nothing) and continues bit for
bit as the uninterrupted bootstrap would have, whatever the new sampler's
seed.
"""

from __future__ import annotations

import logging
import os
import re

import numpy as np
import torch

from nnest_torch.samplers.base import Sampler, _to_numpy
from nnest_torch.samplers.kernels import _accept_mask, _stretch_move
from nnest_torch.utils.evaluation import integrated_autocorr_time

BOOTSTRAP = 'bootstrap_%d.pt'


class Denormalise:
    """x = u * std + mean, the map from the training set's normalised
    coordinates back to the physical ones, computed in the dtype and on the
    device of ``u`` (float32 inside the kernels, float64 on the host)."""

    def __init__(self, mean, std):
        self.mean = np.asarray(mean, dtype=np.float64)
        self.std = np.asarray(std, dtype=np.float64)
        self._consts = {}

    def __call__(self, u):
        key = (u.dtype, str(u.device))
        if key not in self._consts:
            self._consts[key] = tuple(
                torch.as_tensor(a, dtype=u.dtype, device=u.device)
                for a in (self.std, self.mean))
        std, mean = self._consts[key]
        return u * std + mean


@torch.no_grad()
def real_space_stretch(log_prob_fn, generator, x0, mcmc_steps, a=2.0):
    """Goodman-Weare stretch ensemble on ``log_prob_fn`` (a (batch, d)
    tensor to (batch,) log density), red-black half updates from the
    walkers ``x0`` (an even count). The partner rows, stretch uniforms and
    accept uniforms of every step are drawn up front from ``generator``.
    Returns chains (walkers, steps + 1, d), their log densities (walkers,
    steps + 1) and the accepted moves (a 0-dim tensor)."""
    num_walkers = x0.shape[0]
    if num_walkers % 2:
        raise ValueError('the ensemble needs an even number of walkers, got '
                         '%d' % num_walkers)
    half = num_walkers // 2
    shape = (mcmc_steps, 2, half)
    device = x0.device
    idx = torch.randint(0, half, shape, generator=generator, device=device)
    zeta_u = torch.rand(shape, generator=generator, device=device)
    acc_u = torch.rand(shape, generator=generator, device=device)
    x, lp = x0, log_prob_fn(x0)
    xs, lps = [x], [lp]
    n_acc = torch.zeros((), dtype=torch.int64, device=device)
    for s in range(mcmc_steps):
        parts = []
        for h, (lo, hi) in enumerate(((0, half), (half, num_walkers))):
            other = x[half:] if h == 0 else parts[0][0]
            prop, extra = _stretch_move(x[lo:hi], other, idx[s, h, None],
                                        zeta_u[s, h], None, a)
            lp_prop = log_prob_fn(prop)
            acc = _accept_mask(acc_u[s, h], extra + lp_prop - lp[lo:hi])
            parts.append((torch.where(acc[:, None], prop, x[lo:hi]),
                          torch.where(acc, lp_prop, lp[lo:hi])))
            n_acc = n_acc + torch.sum(acc.to(torch.int64))
        x, lp = (torch.cat(t) for t in zip(*parts))
        xs.append(x)
        lps.append(lp)
    return torch.stack(xs, dim=1), torch.stack(lps, dim=1), n_acc


class EnsembleSampler(Sampler):

    def __init__(self,
                 x_dim,
                 loglike,
                 prior=None,
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
                 base_dist=None,
                 scale='',
                 trainer=None,
                 transform_prior=True,
                 oversample_rate=-1,
                 log_level=logging.INFO,
                 param_names=None,
                 seed=0,
                 use_gpu=False,
                 device='cuda'):
        if not hasattr(self, 'sampler'):
            self.sampler = 'ensemble'
        super().__init__(
            x_dim, loglike, prior=prior, append_run_num=append_run_num,
            hidden_dim=hidden_dim, num_slow=num_slow,
            num_derived=num_derived, batch_size=batch_size,
            flow=flow, num_blocks=num_blocks, num_layers=num_layers,
            learning_rate=learning_rate, log_dir=log_dir,
            base_dist=base_dist, scale=scale, trainer=trainer,
            transform_prior=transform_prior, oversample_rate=oversample_rate,
            log_level=log_level, param_names=param_names, seed=seed,
            use_gpu=use_gpu, device=device)
        self._save_params()

    def _train_normalised(self, training_samples, jitter, max_iters):
        """Make the de-normalisation of ``training_samples`` the sampler
        transform and train the flow on the normalised samples."""
        training_samples = np.asarray(training_samples, dtype=np.float64)
        mean = np.mean(training_samples, axis=0)
        std = np.std(training_samples, axis=0)
        self.set_transform(Denormalise(mean, std))
        self.trainer.train((training_samples - mean) / std,
                           max_iters=max_iters, jitter=jitter)

    # ------------------------------------------------------------ bootstrap

    def _bootstrap_save(self, phase, chains, training_samples):
        """Checkpoint a completed bootstrap phase (module docstring)."""
        if self.logs is None:
            return
        path = os.path.join(self.logs['checkpoint'], BOOTSTRAP % phase)
        torch.save({
            'chains': torch.from_numpy(np.array(chains, dtype=np.float64)),
            'training_samples': torch.from_numpy(
                np.array(training_samples, dtype=np.float64)),
            'generator': self.generator.get_state(),
            'total_calls': self.total_calls,
            'total_accepted': self.total_accepted,
            'total_rejected': self.total_rejected,
            'trainer': self.trainer.snapshot_state(),
        }, path + '.tmp')
        os.replace(path + '.tmp', path)

    def _bootstrap_load_latest(self, max_phase):
        """Restore the newest readable completed phase <= ``max_phase``
        (the generator, the counters and the trainer) and return (phase,
        training samples), or None. A file that cannot be read, or lacks a
        field, is skipped with a warning before anything is restored; a
        trainer snapshot that fails to restore is rolled back."""
        if self.logs is None:
            return None
        ck = self.logs['checkpoint']
        phases = sorted((int(m.group(1)) for m in (
            re.fullmatch(r'bootstrap_(\d+)\.pt', f) for f in os.listdir(ck))
            if m and int(m.group(1)) <= max_phase), reverse=True)
        for phase in phases:
            path = os.path.join(ck, BOOTSTRAP % phase)
            try:
                state = torch.load(path, map_location='cpu',
                                   weights_only=True)
                training = state['training_samples'].numpy()
                generator = state['generator']
                counts = [int(state[k]) for k in (
                    'total_calls', 'total_accepted', 'total_rejected')]
                snapshot = state['trainer']
                before = self.trainer.snapshot_state()
                try:
                    self.trainer.restore_state(snapshot)
                except Exception:
                    self.trainer.restore_state(before)
                    raise
            except Exception as e:  # any unusable file: try an older one
                self.logger.warning('Bootstrap checkpoint %s unusable (%r); '
                                    'trying an older phase' % (path, e))
                continue
            self.generator.set_state(generator)
            (self.total_calls, self.total_accepted,
             self.total_rejected) = counts
            return phase, np.array(training, dtype=np.float64)
        return None

    def _autocorr_thin(self, chains):
        """Drop twice the largest integrated autocorrelation time (at most
        half the chain) and keep every (half the smallest)-th step."""
        tau = integrated_autocorr_time(chains)
        discard = min(int(2 * np.max(tau)), chains.shape[1] // 2)
        step_thin = max(int(0.5 * np.min(tau)), 1)
        return chains[:, discard::step_thin, :].reshape(-1, self.x_dim)

    def bootstrap(self,
                  mcmc_steps,
                  num_walkers,
                  iters=1,
                  thin=10,
                  stats_interval=10,
                  output_interval=None,
                  initial_jitter=0.01,
                  final_jitter=0.01,
                  init_samples=None,
                  moves=None,
                  resume=False,
                  train_iters=10000):
        """Alternate the flow's training with latent ensemble runs from a
        real-space start (module docstring); returns the last phase's
        training set in physical coordinates. ``moves``: the ensemble's
        move zoo, {name: weight} ('stretch', 'de', 'snooker', 'kde');
        the jitter of phase it runs linearly from ``initial_jitter``
        (phase 1) to ``final_jitter`` (phase ``iters``); ``train_iters``
        caps each training's epochs. ``init_samples`` are phase 0's
        walkers, by default ``num_walkers`` prior draws. With ``resume``
        the completed phases in the run's checkpoints are skipped."""
        start_phase = -1
        training_samples = None
        if resume:
            loaded = self._bootstrap_load_latest(iters)
            if loaded is not None:
                start_phase, training_samples = loaded
                self.logger.info('Resumed bootstrap from phase [%d]'
                                 % start_phase)
                if start_phase >= iters:
                    return training_samples

        h5 = (os.path.join(self.log_dir, 'emcee.h5')
              if self.log_dir is not None else None)
        if start_phase < 0 and h5 is not None and os.path.isfile(h5):
            # an emcee HDF backend left in the run directory replaces
            # phase 0's run (no likelihood calls)
            chains = self._load_emcee_h5(h5)
            self.logger.info('Seeding phase 0 from emcee.h5 (%d walkers x %d '
                             'stored iterations)' % chains.shape[:2])
            self._chain_stats(chains)
            training_samples = self._autocorr_thin(chains)
            self._bootstrap_save(0, chains, training_samples)
            start_phase = 0

        if start_phase < 0:
            if init_samples is None:
                if self.sample_prior is None:
                    raise ValueError('Prior does not have sample method')
                init_samples = self.sample_prior(num_walkers)
            x0 = torch.as_tensor(np.asarray(init_samples, dtype=np.float32),
                                 device=self.device)
            num_walkers = x0.shape[0]
            # phase 0 runs in the likelihood's own coordinates
            self.set_transform(None)
            kern = self.kernels
            self.logger.info('Performing initial ensemble run with [%d] '
                             'walkers' % num_walkers)
            chains, _, n_acc = real_space_stretch(
                lambda x: kern.like_fn(x)[0] + kern.prior_fn(x),
                self.generator, x0, mcmc_steps)
            chains = _to_numpy(chains).astype(np.float64)
            self.total_calls += mcmc_steps * num_walkers
            self.logger.info('Initial acceptance [%5.4f]' % (
                int(n_acc) / max(mcmc_steps * num_walkers, 1)))
            self._chain_stats(chains)
            training_samples = self._autocorr_thin(chains)
            self._bootstrap_save(0, chains, training_samples)
            start_phase = 0

        for it in range(start_phase + 1, iters + 1):
            jitter = initial_jitter
            if iters > 1:
                jitter += (it - 1) * (final_jitter - initial_jitter) / (
                    iters - 1)
            self._train_normalised(training_samples, jitter, train_iters)
            samples = self._physical(self._ensemble_sample(
                mcmc_steps, num_walkers, output_interval=output_interval,
                moves=moves)[0])
            if mcmc_steps > 1 and mcmc_steps >= stats_interval:
                self._chain_stats(samples)
            training_samples = self._make_single_samples(samples, thin)
            self._bootstrap_save(it, samples, training_samples)
        self._join_plots()
        return training_samples

    def _load_emcee_h5(self, path):
        """An emcee ``HDFBackend`` file (group 'mcmc': dataset 'chain'
        (iteration, walkers, dim), attribute 'iteration') as chains
        (walkers, iterations, dim). Needs h5py, imported here only."""
        import h5py
        with h5py.File(path, 'r') as f:
            g = f['mcmc']
            n_it = int(g.attrs.get('iteration', g['chain'].shape[0]))
            chain = np.asarray(g['chain'][:n_it], np.float64)
        if n_it < 2 or chain.shape[0] < 2:
            raise ValueError(
                'emcee.h5 at %s holds %d completed iterations: nothing to '
                'seed from (delete it to run phase 0)' % (path, n_it))
        if chain.ndim != 3 or chain.shape[2] != self.x_dim:
            raise ValueError('emcee.h5 chain shape %r does not match x_dim=%d'
                             % (chain.shape, self.x_dim))
        return np.transpose(chain, (1, 0, 2))

    def _make_single_samples(self, chains, thin):
        """The re-thin between phases: every row of the flattened chains
        kept with probability 1/thin (getdist's ``makeSingleSamples`` on
        unit weights), the uniforms drawn from the sampler's generator so
        that a resumed bootstrap draws the same rows. Fewer than 2 x_dim
        rows fall back to every thin-th step of each chain."""
        flat = chains.reshape(-1, self.x_dim)
        u = torch.rand(flat.shape[0], generator=self.generator,
                       device=self.device, dtype=torch.float64)
        out = flat[_to_numpy(u <= 1.0 / max(int(thin), 1))]
        if out.shape[0] < 2 * self.x_dim:
            return chains[:, ::thin, :].reshape(-1, self.x_dim)
        return out

    # ------------------------------------------------------------------ run

    def run(self,
            mcmc_steps,
            num_walkers,
            training_samples,
            stats_interval=10,
            output_interval=None,
            initial_jitter=0.01,
            final_jitter=0.01,
            init_samples=None,
            train_iters=10000):
        """Train on ``training_samples`` (physical coordinates), then one
        latent ensemble of ``num_walkers`` walkers for ``mcmc_steps``
        steps. Sets and returns ``samples`` (walkers, steps + 1, x_dim +
        num_derived): the physical coordinates, then the derived
        parameters; sets ``latent_samples`` and ``loglikes``. The chain
        statistics read the x_dim columns. ``final_jitter`` is accepted
        and unused, as in ``nnest_tpu`` (there is one training)."""
        del final_jitter
        self._train_normalised(training_samples, initial_jitter,
                               train_iters)
        samples, latent, derived, loglikes, _ = self._ensemble_sample(
            mcmc_steps, num_walkers, init_samples=init_samples,
            output_interval=output_interval)
        samples = self._physical(samples)
        if mcmc_steps > 1 and mcmc_steps >= stats_interval:
            self._chain_stats(samples)
        self._join_plots()
        self.samples = np.concatenate((samples, derived), axis=2)
        self.latent_samples = latent
        self.loglikes = loglikes
        self.logger.info('ncall: %d' % self.total_calls)
        return self.samples
