"""What the benchmark reads from the program's timed path, through the
program's own Python entries, which it wraps without editing them:

- ``nnest_torch.ops.spline_inverse.spline_inverse`` (every hot inverse a
  Metropolis step runs through a single-speed spline flow): calls and rows
  counted; a sample of the calls, drawn from the job's seed, kept with the
  flow's parameters at that call for the reference; in the traced job each
  call's rows;
- ``nnest_torch.samplers.kernels.LatentKernels._hot_inverse``: for a flow
  that ``fused_spline.is_fusable_spline`` refuses, whose steps take the
  flow's own ``inverse``, the callable it returns, counted and sampled the
  same way;
- ``nnest_torch.samplers.kernels.consume_pool`` (the device's replay of a
  pool's consumption), traced runs only: each call's live logl, flags and
  candidates' logl in the traced job, for the consumption's counts;
- host spans (named ``pb.*``, on the wall clock the profiler stamps the
  device's events with) around the sampler's pool dispatches, training,
  checkpoints and end-of-run work, in the traced job only, with the
  Metropolis steps each dispatch ran.

With ``control='tf32'`` the hot inverse's place is taken by the plain
reference inverse of the configuration's flow (``reference``) in float32
with TF32 matmuls: the control, which has to come out not correct."""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

# The sampler's entries each span wraps, by span name (``Trainer.train``
# is ``pb.train``).
SPANNED = {
    'pb.mcmc_dispatch': ('_mcmc_generations_batch', '_mcmc_sample_live'),
    'pb.prior_dispatch': ('_rejection_prior_generations_batch',
                          '_rejection_prior_sample'),
    'pb.checkpoint': ('_write_checkpoint', '_close_io'),
    'pb.end_of_run': ('_diagnose', '_write_results', '_save_samples'),
}


class Hooks:
    def __init__(self, stride, control, reference):
        self.stride = int(stride)
        self.control = control
        self.reference = reference  # the flow reference's inverse
        self.model = None       # the flow of the job running now
        self.traced = False     # inside the traced job
        self.inverse_calls = 0
        self.inverse_rows = 0
        self.samples = []       # (job, z, x, logdet, state) at sampled calls
        self.traced_inverse_rows = []
        self.pool_calls = 0
        self.traced_pools = []  # (n, m, d, k, live logl, flags, cand logl)
        self.traced_steps = 0   # Metropolis steps of the traced dispatches
        self.spans = []         # (start ns, end ns, name) in the traced job
        self.profiler = None    # the traced job's torch.profiler.profile
        self.traced_epochs = 10
        # (start ns, end ns, epochs run) of each training's stretch with
        # the trace off, and (start ns, end ns) of its traced epochs
        self.untraced = []
        self.epochs = []
        self._epochs = 0
        self._epoch_end = None
        self._off_at = None
        self._job = None
        self._offset = 0
        self._job_calls = 0
        self._undo = []

    def begin_job(self, job, seed, model):
        self._job, self.model, self._job_calls = job, model, 0
        self._offset = int(np.random.default_rng(seed).integers(self.stride))

    # ------------------------------------------------------------ inverse

    def _inverse(self, real):
        def spline_inverse(z, packed):
            if self.control == 'tf32':
                with torch.no_grad():
                    x, logdet = self.reference(self.model.state_dict(), z)
            else:
                x, logdet = real(z, packed)
            self._count(self.model, z, x, logdet)
            return x, logdet
        return spline_inverse

    def _hot(self, real, fusable):
        def _hot_inverse(kernels):
            inverse = real(kernels)
            if fusable(kernels.model):
                return inverse      # through the sampled spline kernel
            model = kernels.model

            def hot_inverse(z):
                if self.control == 'tf32':
                    with torch.no_grad():
                        x, logdet = self.reference(model.state_dict(), z)
                else:
                    x, logdet = inverse(z)
                self._count(model, z, x, logdet)
                return x, logdet
            return hot_inverse
        return _hot_inverse

    def _count(self, model, z, x, logdet):
        """One hot-inverse call counted, and kept with ``model``'s
        parameters where the job's stride samples it."""
        self.inverse_calls += 1
        self.inverse_rows += z.shape[0]
        if self.traced:
            self.traced_inverse_rows.append(int(z.shape[0]))
        if (self._job_calls + self._offset) % self.stride == 0:
            with torch.no_grad():
                state = {k: v.detach().clone()
                         for k, v in model.state_dict().items()}
            self.samples.append((self._job, z.detach().clone(),
                                 x.detach().clone(),
                                 logdet.detach().clone(), state))
        self._job_calls += 1

    # ------------------------------------------------------------ pools

    def _consume(self, real):
        def consume_pool(au, al, ad, it, flags, cand_logl, cand_x,
                         cand_derived, update_interval=None):
            self.pool_calls += 1
            if self.traced:
                self.traced_pools.append((
                    int(au.shape[0]), int(flags.shape[0]), int(au.shape[1]),
                    0 if ad is None else int(ad.shape[1]), al.clone(),
                    flags.clone(), cand_logl.clone()))
            return real(au, al, ad, it, flags, cand_logl, cand_x,
                        cand_derived, update_interval=update_interval)
        return consume_pool

    # ------------------------------------------------------------ spans

    @contextlib.contextmanager
    def span(self, name):
        """A host span of the traced job, on the clock the profiler's
        device events are stamped with (ns since the epoch)."""
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.spans.append((t0, time.time_ns(), name))

    def _device_trace(self, enable):
        from torch.profiler import ProfilerActivity
        self.profiler.toggle_collection_dynamic(enable,
                                                [ProfilerActivity.CUDA])

    def _train(self, real):
        """``Trainer.train`` in a ``pb.train`` span; in the traced job the
        device trace is off from its ``traced_epochs``-th epoch to its end
        (a training step is a CUDA graph of some 2000 kernels: whole
        trainings would make millions of events). That stretch stays in
        the traced window, with the epochs it ran, and each traced epoch's
        span (from the end of the one before, or the training's start:
        the epoch's shuffle and noise with it) is kept, so that the trace's
        reading can count the stretch's device time from them."""
        def train(*args, **kwargs):
            if not self.traced:
                return real(*args, **kwargs)
            self._epochs = 0
            self._epoch_end = time.time_ns()
            with self.span('pb.train'):
                try:
                    return real(*args, **kwargs)
                finally:
                    if self._off_at is not None:
                        self._device_trace(True)
                        self.untraced.append((
                            self._off_at, time.time_ns(),
                            self._epochs - self.traced_epochs))
                        self._off_at = None
        return train

    def _epoch(self, real):
        def train_epoch(*args, **kwargs):
            if not (self.traced and self.profiler is not None):
                return real(*args, **kwargs)
            if self._epochs == self.traced_epochs:
                # between epochs: the last one ended in a host read
                self._off_at = time.time_ns()
                self._device_trace(False)
            self._epochs += 1
            out = real(*args, **kwargs)
            if self._epochs <= self.traced_epochs:
                # an epoch ends in a host read of its validation loss
                end = time.time_ns()
                self.epochs.append((self._epoch_end, end))
                self._epoch_end = end
            return out
        return train_epoch

    def _spanned(self, name, real, steps=False):
        def wrapped(*args, **kwargs):
            if not self.traced:
                return real(*args, **kwargs)
            with self.span(name):
                out = real(*args, **kwargs)
            if steps:
                # (mcmc_steps, ...) -> a buffer of generations, or one
                gens = len(out) if isinstance(out, list) else 1
                self.traced_steps += gens * int(args[1])
            return out
        return wrapped

    # ------------------------------------------------------------ install

    def _patch(self, owner, name, value):
        own = name in vars(owner)
        self._undo.append((owner, name, getattr(owner, name), own))
        setattr(owner, name, value)

    def install(self, trace):
        from nnest_torch.ops import spline_inverse as si
        from nnest_torch.ops.fused_spline import is_fusable_spline
        from nnest_torch.samplers import kernels
        from nnest_torch.samplers.nested import NestedSampler
        from nnest_torch.training.trainer import Trainer
        self._patch(si, 'spline_inverse', self._inverse(si.spline_inverse))
        self._patch(kernels.LatentKernels, '_hot_inverse',
                    self._hot(kernels.LatentKernels._hot_inverse,
                              is_fusable_spline))
        if not trace:
            return
        self._patch(kernels, 'consume_pool', self._consume(
            kernels.consume_pool))
        for span, names in SPANNED.items():
            for name in names:
                self._patch(NestedSampler, name, self._spanned(
                    span, getattr(NestedSampler, name),
                    steps=span == 'pb.mcmc_dispatch'))
        self._patch(Trainer, 'train', self._train(Trainer.train))
        self._patch(Trainer, '_train_epoch', self._epoch(Trainer._train_epoch))

    def uninstall(self):
        while self._undo:
            owner, name, value, own = self._undo.pop()
            if own:
                setattr(owner, name, value)
            else:
                delattr(owner, name)

    @contextlib.contextmanager
    def installed(self, trace):
        self.install(trace)
        try:
            yield self
        finally:
            self.uninstall()
