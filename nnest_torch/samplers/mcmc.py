"""MCMC sampler: flow-guided Metropolis chains for posterior sampling.

Port of ``nnest_tpu/samplers/mcmc.py``: train the flow on the normalised
training samples (their de-normalisation becomes the sampler transform),
then run full Metropolis-Hastings chains in the flow's latent space with a
dynamic step size, the whole trajectory on the device
(``LatentKernels.mcmc`` in collect-chains mode: one launch of the spline
inverse a step for a single-speed spline flow, and one a call). The chain
statistics are logged, and the first chain's trace plotted, as in
``nnest_tpu``. ``mesh=`` (among the keyword arguments, passed to
:class:`~nnest_torch.samplers.ensemble.EnsembleSampler`) dp-shards the
chains over the ranks of a process group; a mesh with tp > 1 also shards
the flow's wide conditioner weights over its tp group (tensor
parallelism; the spline kernel then packs the whole weights, gathered once
a call).
"""

from __future__ import annotations

import numpy as np

from nnest_torch.samplers.ensemble import EnsembleSampler


class MCMCSampler(EnsembleSampler):

    def __init__(self, x_dim, loglike, prior=None, **kwargs):
        self.sampler = 'mcmc'
        super().__init__(x_dim, loglike, prior=prior, **kwargs)

    def run(self,
            mcmc_steps,
            mcmc_num_chains,
            training_samples,
            mcmc_dynamic_step_size=True,
            stats_interval=100,
            output_interval=None,
            initial_jitter=0.01,
            final_jitter=0.01,
            init_samples=None,
            train_iters=10000):
        """Train on ``training_samples`` (physical coordinates), then
        ``mcmc_num_chains`` chains of ``mcmc_steps`` full-MH steps from
        base draws (or from ``init_samples``, in normalised coordinates).
        Sets and returns ``samples`` (chains, steps + 1, x_dim +
        num_derived): the physical coordinates, then the derived
        parameters (the chain statistics read the x_dim columns); sets
        ``latent_samples``, ``loglikes`` and
        ``scale`` (the proposal scale at the end, adapted toward 50%
        acceptance when ``mcmc_dynamic_step_size``). ``output_interval``
        writes the chains as ``chains/chain_<i>.txt``; the statistics are
        logged once, when ``mcmc_steps`` >= ``stats_interval`` (and > 1);
        the first chain's trace goes to ``plots/trace.png``. ``final_jitter``
        is accepted and unused, as in ``nnest_tpu`` (there is one
        training)."""
        del final_jitter
        self._train_normalised(training_samples, initial_jitter,
                               train_iters)
        samples, latent, derived, loglikes, self.scale, _ = \
            self._mcmc_sample(mcmc_steps, num_chains=mcmc_num_chains,
                              dynamic_step_size=mcmc_dynamic_step_size,
                              output_interval=output_interval,
                              init_samples=init_samples)
        samples = self._physical(samples)
        if mcmc_steps > 1 and mcmc_steps >= stats_interval:
            self._chain_stats(samples)
        self._plot_trace(samples, latent)
        self._join_plots()
        self.samples = np.concatenate((samples, derived), axis=2)
        self.latent_samples = latent
        self.loglikes = loglikes
        self.logger.info('ncall: %d' % self.total_calls)
        return self.samples
