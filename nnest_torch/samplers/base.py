"""Sampler base: user-callable wrapping, trainer, kernels, artifacts.

Port of ``nnest_tpu/samplers/base.py``:

- two likelihood conventions, told apart once when the sampler is built
  (the JAX package's split between traced and ``io_callback``
  likelihoods, ``_build_kernels``): a *tensor likelihood* returns a
  ``torch.Tensor``, or a tuple whose first element is one, for a (2, d)
  float32 tensor on the sampler's device and is called on (batch, d)
  float32 tensors there; any other callable (one that raises on a tensor,
  or returns numpy) is a *host likelihood* and receives the transformed
  points as (batch, d) float64 numpy, its result copied back to the device
  as float32 for the kernels. Both return a (batch,) log likelihood, or
  ``(logl, derived)`` with derived parameters of shape (batch,
  num_derived) (zeros when a likelihood returns logl alone). The host
  wrapper :meth:`Sampler.loglike` (numpy in, float64 ``(logl, derived)``
  out, non-finite logl clamped to -1e100, derived shapes checked, calls
  counted) and the device function used inside the kernels (non-finite
  logl sanitized to ``LOG_NEG``, derived float32) both call it; the probe
  that tells the two apart is not counted, and checks a tensor
  likelihood's derived shape once. A transform that does not return a
  tensor for a tensor is a host transform in the same way, and a prior
  without ``logpdf`` is called once a point on float64 numpy (the JAX
  package's ``safe_prior``), inside the kernels too;
- one sampler transform, set in one place (:meth:`Sampler.set_transform`;
  the MCMC and ensemble samplers' ``run`` make it the de-normalisation of
  their training set): the device likelihood, the device prior (on the
  transformed point when ``transform_prior``), the host ``loglike`` and
  ``prior`` and :meth:`Sampler.transform` all read it;
- capacity autoscale of the conditioner width (16/32/64 by dimension);
- the flows of ``build_flow`` (``flow``, ``num_slow``, ``num_layers``,
  ``scale``, ``base_dist``), and the fast-slow Metropolis proposal with
  ``oversample_rate`` (default: the fast dims' share) and the
  ``total_fast_calls`` counter;
- the endpoint MCMC and slice pool generations from the live set, with the
  host eigenbasis mixing ratio and latent condition number of each
  generation (the inputs of ``adjusted_logzerr``);
- batched prior rejection, flow rejection inside the cached Jacobian
  envelope and flow-density draws, with their counters;
- the posterior samplers' entry points: ``_mcmc_sample`` (full-MH or
  constrained Metropolis chains with their trajectories) and
  ``_ensemble_sample`` (the latent ensemble), both started by ``_mcmc_init``
  style starts (given points re-projected through forward and inverse, or
  base draws until prior and likelihood are finite), and the chain
  statistics of ``utils/evaluation.py``;
- derived parameters carried beside every point the kernels return
  (float32 on the device, float64 on the host, as in the JAX package);
- getdist-style ``chain.txt`` (``chain_<i>.txt`` a chain for trajectories;
  rows ``weight -logl params derived`` under the ``param_names`` header),
  written by the native runtime (``nnest_torch.runtime``), and
  ``params.txt``;
- ``timers``, a ``StepTimer`` of the host wall seconds of the named
  phases (``mcmc_init``, ``mcmc_kernel``, ``candidate_kernel`` here; the
  nested sampler adds its own), as ``nnest_tpu``'s;
- the run's tooling: the default trainer writes into the run directory
  (``models/``, ``data/``, ``plots/``, TensorBoard), ``_plot_trace`` draws
  the first chain's trace (``plots/trace.png``, matplotlib's Agg canvas,
  imported when used), and ``_submit_io`` queues file writes on one
  background thread (``utils/io_async.SerialWriter``) that ``_drain_io``
  and ``_close_io`` wait for.

``use_gpu`` is accepted and ignored, as in ``nnest_tpu``: ``device``
decides placement.

Multi-process runs (``mesh=``, a :class:`nnest_torch.parallel.Mesh`): every
rank runs the same host loop from the same seed. ``mpi_size``,
``mpi_rank``, ``use_mpi`` and ``single_or_primary_process`` come from the
``torch.distributed`` process group (rank 0 of 1 without one); rank 0 alone
owns the run directory, so ``logs``, ``log_dir``, the trainer's files,
TensorBoard, plots, the background writer and the progress bar exist there
only. The Metropolis and slice chains of ``_mcmc_sample_live``,
``_slice_sample_live``, ``_mcmc_sample_final``, ``_slice_sample_final``
and ``_mcmc_sample`` are dp-sharded
(``LatentKernels.mcmc`` and ``slice_body`` with ``mesh``); their starts are
computed whole on every rank and each rank steps its share. The flow
strategies and the ensemble run replicated. A host likelihood, prior or
transform called inside a replicated kernel is a *farm* (the JAX package's
``shard_map`` callback, the reference's MPI likelihood farm): each rank
evaluates its rows of the batch, padded to a multiple of dp by repeating
row 0, and the results are gathered; inside a sharded kernel the rows are
already the rank's own. Padded rows are never counted in ``total_calls``.
A mesh with tp > 1 (tensor parallelism: the trainer's flow sharded over the
tp group, ``nnest_torch.parallel``) serves ``MCMCSampler``, whose chains are
dp-sharded and each dp shard's stepped by its tp replicas alike; nested and
ensemble runs take tp = 1, as in ``nnest_tpu``.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os

import numpy as np
import torch
import torch.distributed as dist

from nnest_torch import runtime as _runtime
from nnest_torch.parallel.mesh import (broadcast_exact, gather_columns,
                                       shard_batch)
from nnest_torch.priors import UniformPrior
from nnest_torch.samplers.kernels import LatentKernels
from nnest_torch.training.trainer import Trainer
from nnest_torch.utils.device import resolve_device
from nnest_torch.utils.evaluation import (acceptance_rate,
                                          effective_sample_size,
                                          eig_mix_from_moments,
                                          gelman_rubin_diagnostic,
                                          latent_cond_null,
                                          mean_jump_distance,
                                          metropolis_mix_null, slice_mix_null)
from nnest_torch.utils.io_async import SerialWriter
from nnest_torch.utils.logger import create_logger, get_or_create_run_dir
from nnest_torch.utils.profiling import StepTimer, span


def _to_numpy(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _pull(tensors):
    """Host numpy copies of ``tensors`` in one device-to-host copy: the
    bytes of each, padded to 8, concatenated on the device, copied once,
    then viewed back with their dtypes and shapes. CPU tensors are viewed
    as they are."""
    if not tensors or tensors[0].device.type == 'cpu':
        return [t.detach().numpy() for t in tensors]
    parts, layout = [], []
    for t in tensors:
        b = t.detach().contiguous().reshape(-1).view(torch.uint8)
        layout.append((b.numel(), torch.empty(0, dtype=t.dtype).numpy().dtype,
                       tuple(t.shape)))
        parts.append(b)
        if b.numel() % 8:
            parts.append(b.new_zeros(8 - b.numel() % 8))
    host = torch.cat(parts).cpu().numpy()
    out, offset = [], 0
    for nbytes, dtype, shape in layout:
        out.append(host[offset:offset + nbytes].view(dtype).reshape(shape))
        offset += -(-nbytes // 8) * 8
    return out


def _window(ncs):
    """The host's efficiency window as the rejection batch runners' ring: (the
    last 20 values as float32 at their absolute index modulo 20, the
    count)."""
    vals = np.zeros(20, np.float32)
    for i in range(max(0, len(ncs) - 20), len(ncs)):
        vals[i % 20] = np.float32(ncs[i])
    return vals, len(ncs)


def _identity(u):
    return u


def _probe(fn, x_dim, device):
    """``fn`` of a (2, x_dim) float32 zero tensor on ``device``, or None
    when it raises."""
    try:
        with torch.no_grad():
            return fn(torch.zeros(2, x_dim, device=device))
    except Exception:
        return None


def _is_tensor_result(out):
    """A tensor, or a tuple whose first element is one (``(logl,
    derived)``)."""
    if isinstance(out, tuple) and out:
        out = out[0]
    return isinstance(out, torch.Tensor)


def _returns_tensor(fn, x_dim, device):
    """True when ``fn`` returns a tensor, or a tuple whose first element is
    a tensor, for a (2, x_dim) float32 tensor on ``device``: the probe that
    tells a tensor callable from a host one."""
    return _is_tensor_result(_probe(fn, x_dim, device))


def _check_derived(derived, num_derived):
    """The JAX package's two checks of a likelihood's derived values."""
    if derived.ndim == 1:
        raise ValueError('Derived should have dimensions (batch, num_derived)')
    if derived.shape[1] != num_derived:
        raise ValueError('Is the number of derived parameters correct?')


class Sampler:

    def __init__(self,
                 x_dim,
                 loglike,
                 transform=None,
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
                 resume=True,
                 base_dist=None,
                 scale='',
                 trainer=None,
                 transform_prior=True,
                 oversample_rate=-1,
                 log_level=logging.INFO,
                 param_names=None,
                 seed=0,
                 use_gpu=False,
                 device='cuda',
                 mesh=None):
        self.device = resolve_device(device)
        if mesh is not None and mesh.tp > 1 and \
                getattr(self, 'sampler', '') != 'mcmc':
            raise ValueError('tensor parallelism (tp > 1) serves '
                             'MCMCSampler; nested and ensemble runs take '
                             'tp = 1, as in nnest_tpu')
        self.mesh = mesh
        # one rank of the process group, or rank 0 of 1 without one
        grouped = dist.is_available() and dist.is_initialized()
        self.mpi_size = dist.get_world_size() if grouped else 1
        self.mpi_rank = dist.get_rank() if grouped else 0
        self.use_mpi = self.mpi_size > 1
        self.single_or_primary_process = self.mpi_rank == 0
        self._rows_local = False   # inside a dp-sharded kernel call
        self.x_dim = x_dim
        self.num_derived = int(num_derived)
        self.num_params = x_dim + self.num_derived
        self.resume = resume
        self.param_names = param_names
        if param_names is not None and len(param_names) != self.num_params:
            raise ValueError('param_names must have x_dim + num_derived '
                             'entries')
        if not 0 <= num_slow < x_dim:
            raise ValueError('num_slow must be in [0, x_dim)')
        # Fast-slow proposals: the share of Metropolis proposals that move
        # the fast dims only, by default the fast dims' share of x_dim.
        self.num_slow = num_slow
        self.num_fast = x_dim - num_slow
        self.oversample_rate = (oversample_rate if oversample_rate > 0
                                else self.num_fast / x_dim)
        # Capacity autoscale: hidden_dim=0 derives the conditioner width
        # from x_dim; an explicit hidden_dim always wins.
        if not hidden_dim:
            hidden_dim = 16 if x_dim < 16 else (32 if x_dim < 32 else 64)

        self._user_loglike = loglike
        probe = _probe(loglike, x_dim, self.device)
        self._host_loglike = not _is_tensor_result(probe)
        if not self._host_loglike and isinstance(probe, tuple):
            # a tensor likelihood's derived shape, checked once here
            _check_derived(torch.as_tensor(probe[1]), self.num_derived)
        self._user_prior = prior
        self._host_prior = (prior is not None
                            and not callable(getattr(prior, 'logpdf', None)))
        # the prior is of transform(u) (the MCMC and ensemble samplers'
        # physical points), else of u itself (the nested sampler's cube)
        self._transform_prior = transform_prior
        self.sample_prior = getattr(prior, 'sample', None)
        if not callable(self.sample_prior):
            self.sample_prior = None
        self.set_transform(transform)
        self.generator = torch.Generator(device=self.device).manual_seed(
            int(seed))

        args = {k: v for k, v in locals().items()
                if k not in ('self', 'loglike', 'transform', 'prior',
                             'trainer', 'probe', 'grouped', 'mesh')}
        args['sampler'] = getattr(self, 'sampler', '')
        self._init_args = args

        # rank 0 alone owns the run directory
        if log_dir is not None and self.single_or_primary_process:
            self.logs = get_or_create_run_dir(log_dir,
                                              append_run_num=append_run_num)
            self.log_dir = self.logs['run_dir']
        else:
            self.logs = None
            self.log_dir = None
        # the other ranks log warnings only
        if not self.single_or_primary_process:
            log_level = max(log_level, logging.WARNING)
        self.logger = create_logger(__name__, level=log_level)

        self.trainer = trainer if trainer is not None else Trainer(
            x_dim, hidden_dim=hidden_dim, num_slow=num_slow,
            batch_size=batch_size, flow=flow, scale=scale,
            num_blocks=num_blocks, num_layers=num_layers,
            base_dist=base_dist, learning_rate=learning_rate,
            log_dir=self.log_dir, log=self.single_or_primary_process,
            log_level=log_level, seed=seed + 1, device=self.device,
            mesh=mesh)
        self.logger.info('Num params [%d]' % self.x_dim)

        self.total_accepted = 0
        self.total_rejected = 0
        self.total_calls = 0
        # likelihood calls of fast-only Metropolis proposals
        self.total_fast_calls = 0
        self._last_kernel_stats = None
        # Per-generation mixing history of the current run() (see
        # _consume_endpoint_out) and the flow-rejection envelope cache.
        self._mix_ratios = []
        self._mix_ratios_eig = []
        self._latent_conds = []
        self._mix_rels = []
        self._cond_rels = []
        self._cond_infl = []
        self._max_log_det_j = None
        self._max_r = None
        self._io_writer = None   # the background writer, made when used
        # host wall seconds of the named phases, over the sampler's runs
        self.timers = StepTimer()

    # ------------------------------------------------------------ wrappers

    def _save_params(self, extra=None):
        if self.logs is None:
            return
        d = dict(self._init_args)
        if extra:
            d.update(extra)
        with open(os.path.join(self.logs['info'], 'params.txt'), 'w') as f:
            json.dump({k: str(v) for k, v in d.items()}, f, indent=4)

    def set_transform(self, transform):
        """Make ``transform`` the sampler transform, the map from the space
        the chains move in to the likelihood's: a function of a (batch, d)
        tensor that keeps its dtype and device, a host function of (batch,
        d) float64 numpy (one that does not return a tensor for a tensor),
        or None for the identity. It is kept here only: the device
        likelihood, the device prior (when ``transform_prior``), the host
        :meth:`loglike`, :meth:`prior` and :meth:`transform` all read it,
        so they cannot disagree. The cached kernels are dropped."""
        self._transform_fn = transform if transform is not None else (
            _identity)
        self._host_transform = (transform is not None and not _returns_tensor(
            transform, self.x_dim, self.device))
        self.invalidate_kernels()

    def invalidate_kernels(self):
        """Drop the cached :class:`LatentKernels`; the next use builds them
        anew on the trainer's flow."""
        self._kernels = None

    def transform(self, u):
        """Points of the chains' space (numpy) → the likelihood's space
        (numpy float64, computed in float64)."""
        u = np.atleast_2d(np.asarray(u, dtype=np.float64))
        if self._host_transform:
            return np.asarray(self._transform_fn(u), dtype=np.float64)
        u = torch.as_tensor(u, device=self.device)
        return np.asarray(_to_numpy(self._transform_fn(u)),
                          dtype=np.float64)

    def _device_transform(self, u):
        """The sampler transform of a (batch, d) tensor, as a tensor of its
        dtype on its device (a host transform through float64 numpy, a
        farm under a mesh)."""
        if not self._host_transform:
            return self._transform_fn(u)
        v, = self._farmed(lambda a: (self.transform(a),), _to_numpy(u))
        return torch.as_tensor(v, dtype=u.dtype, device=u.device)

    def _farmed(self, fn, u):
        """``fn`` (float64 numpy rows to a tuple of arrays, rows first) of
        the rows ``u``. Under a mesh, outside a dp-sharded kernel, each
        rank evaluates only its rows (padded to a multiple of dp by
        repeating row 0) and the results are gathered in one collective,
        the pad dropped; otherwise ``fn(u)``."""
        u = np.asarray(u, dtype=np.float64)
        if self.mesh is None or self._rows_local or u.shape[0] == 0:
            return fn(u)
        mine, _ = shard_batch(u, self.mesh)
        outs = [torch.from_numpy(np.asarray(o, dtype=np.float64))
                for o in fn(mine)]
        return tuple(o.numpy() for o in gather_columns(outs, self.mesh,
                                                        u.shape[0]))

    def _broadcast_resume(self, state):
        """Rank 0's resume decision and ``state`` on every rank, in one
        broadcast: the other ranks have no run directory, and ranks that
        disagreed on resuming would draw other numbers and deadlock at the
        next collective. It also carries what rank 0's load restored in
        place (the counters, the sampler's generator and the trainer's
        snapshot: its flow, Adam moments, generator and scalars), which
        the other ranks take. Returns the state, or None."""
        payload = None
        if state is not None:
            payload = {
                'state': state,
                'counters': (self.total_calls, self.total_accepted,
                             self.total_rejected, self.total_fast_calls),
                'generator': self.generator.get_state(),
                'trainer': self.trainer.snapshot_state(),
            }
        payload = broadcast_exact(payload)
        if payload is None:
            return None
        if not self.single_or_primary_process:
            (self.total_calls, self.total_accepted, self.total_rejected,
             self.total_fast_calls) = payload['counters']
            self.generator.set_state(payload['generator'])
            self.trainer.restore_state(payload['trainer'])
        return payload['state']

    @contextlib.contextmanager
    def _local_rows(self):
        """Mark a dp-sharded kernel call: the host callables see this
        rank's rows only, so they are not farmed again."""
        self._rows_local = True
        try:
            yield
        finally:
            self._rows_local = False

    def _loglike_of_host(self, u):
        """A host likelihood of float64 numpy points ``u`` (before the
        transform): (logl, derived) in float64, logl (batch,) with
        non-finite values clamped to -1e100, derived (batch, num_derived)
        (zeros when the likelihood returns logl alone)."""
        res = self._user_loglike(self.transform(u))
        if isinstance(res, tuple):
            logl, derived = res
            derived = np.asarray(derived, dtype=np.float64)
            _check_derived(derived, self.num_derived)
        else:
            logl = res
            derived = np.zeros((u.shape[0], self.num_derived))
        logl = np.array(logl, dtype=np.float64).reshape(-1)
        logl[~np.isfinite(logl)] = -1e100
        return logl, derived

    def _device_loglike(self, u):
        """(batch, d) float32 tensor → float32 (logl, derived) on its device:
        logl (batch,), derived (batch, num_derived), zeros when the
        likelihood returns logl alone. A host likelihood's values pass
        through float32 once."""
        f32 = torch.float32
        if self._host_loglike:
            logl, derived = self._farmed(self._loglike_of_host, _to_numpy(u))
            return (torch.as_tensor(logl, dtype=f32, device=u.device),
                    torch.as_tensor(derived, dtype=f32, device=u.device))
        res = self._user_loglike(self._device_transform(u))
        if isinstance(res, tuple):
            logl, derived = res
            derived = torch.as_tensor(derived, dtype=f32, device=u.device)
        else:
            logl = res
            derived = torch.zeros((u.shape[0], self.num_derived),
                                  device=u.device)
        return torch.as_tensor(logl, dtype=f32, device=u.device), derived

    def loglike(self, u):
        """Host wrapper: numpy in (a list or a single point too), float64
        numpy ``(logl, derived)`` out, non-finite logl clamped to -1e100,
        derived (batch, num_derived) checked, calls counted."""
        u = np.atleast_2d(np.asarray(u, dtype=np.float64))
        if self._host_loglike:
            logl, derived = self._loglike_of_host(u)
        else:
            with torch.no_grad():
                logl, derived = self._device_loglike(torch.as_tensor(
                    u.astype(np.float32), device=self.device))
            logl = np.asarray(_to_numpy(logl), dtype=np.float64).reshape(-1)
            logl[~np.isfinite(logl)] = -1e100
            derived = np.asarray(_to_numpy(derived), dtype=np.float64)
            _check_derived(derived, self.num_derived)
        self.total_calls += u.shape[0]
        return logl, derived

    def _device_prior(self, u):
        """(batch, d) tensor → (batch,) log prior, of ``transform(u)`` when
        ``transform_prior``."""
        if self._user_prior is None:
            return torch.zeros(u.shape[0], dtype=u.dtype, device=u.device)
        if self._host_prior:
            lp, = self._farmed(lambda a: (self.prior(a),), _to_numpy(u))
            return torch.as_tensor(lp, dtype=u.dtype, device=u.device)
        if self._transform_prior:
            u = self._device_transform(u)
        return self._user_prior.logpdf(u)

    def prior(self, u):
        """Host log prior: numpy points in (computed in float64), float64
        out; a prior without ``logpdf`` is called once a point."""
        u = np.atleast_2d(np.asarray(u, dtype=np.float64))
        if self._host_prior:
            if self._transform_prior:
                u = self.transform(u)
            return np.asarray([float(self._user_prior(p)) for p in u])
        u = torch.as_tensor(u, device=self.device)
        with torch.no_grad():
            lp = self._device_prior(u)
        return np.asarray(_to_numpy(lp), dtype=np.float64).reshape(-1)

    @property
    def kernels(self) -> LatentKernels:
        if self._kernels is None:
            # the flat prior (none given) and the library's box prior of
            # the points themselves go to the kernels as such: their
            # captured step loop (samplers/kernels.py) runs them
            prior = self._user_prior
            if prior is not None and (self._transform_prior
                                      or type(prior) is not UniformPrior):
                prior = self._device_prior
            self._kernels = LatentKernels(
                self.trainer.model, self._device_loglike, prior,
                num_slow=self.num_slow, oversample_rate=self.oversample_rate,
                num_derived=self.num_derived,
                graphs=self.trainer.mcmc_graphs)
        return self._kernels

    # -------------------------------------------------------------- MCMC

    def _consume_endpoint_out(self, out, mix_null=None, cond_null=None,
                              cond_inflates=False):
        """Counters and chain statistics of one endpoint kernel output;
        returns host (u, logl, derived, moved, scale, mean_jump, ncall),
        derived (chains, num_derived) float64 (no columns, and no device
        tensor behind them, when num_derived is 0).

        The eigenbasis mixing ratio and latent condition number come from
        the kernel's ``mix_cov``/``mix_msd`` in float64 on the host. With
        ``mix_null`` (the healthy ratio at this step budget) the relative
        ratio is recorded, the kinetic term of ``adjusted_logzerr``; with
        ``cond_null`` the relative condition number, which also feeds the
        structural term when ``cond_inflates`` (Metropolis generations)."""
        with span('gen.serve'):
            out = {k: _to_numpy(v) for k, v in out.items()}
            self.total_calls += int(out['ncall'])
            self.total_fast_calls += int(out['fast_calls'])
            self.total_accepted += int(out['accepted'])
            self.total_rejected += int(out['rejected'])
            mix = float(out['mix_ratio'])
            self._mix_ratios.append(mix)
            mix_eig, latent_cond = eig_mix_from_moments(out['mix_cov'],
                                                        out['mix_msd'])
            self._mix_ratios_eig.append(mix_eig)
            self._latent_conds.append(latent_cond)
            if mix_null is not None:
                self._mix_rels.append(mix_eig / max(mix_null, 1e-6))
            if cond_null is not None:
                self._cond_rels.append(latent_cond / max(cond_null, 1e-6))
                if cond_inflates:
                    self._cond_infl.append(self._cond_rels[-1])
            self._last_kernel_stats = {
                'ess': np.asarray(out['ess'], dtype=np.float64),
                'acceptance': float(out['acceptance']),
                'mean_jump': float(out['mean_jump']),
                'mix_ratio': mix,
                'mix_ratio_eig': mix_eig,
                'latent_cond': latent_cond,
            }
            u = np.asarray(out['final_x'], dtype=np.float64)
            return (u, np.asarray(out['final_logl'], dtype=np.float64),
                    self._host_derived(out.get('final_derived'), u.shape[0]),
                    np.asarray(out['moved'], dtype=bool),
                    float(out['scale']), float(out['mean_jump']),
                    int(out['ncall']))

    def _host_derived(self, derived, n):
        """A kernel's derived values (a tensor, or None when num_derived is
        0) as (n, num_derived) float64 numpy."""
        if derived is None:
            return np.zeros((n, self.num_derived))
        return np.asarray(_to_numpy(derived), dtype=np.float64).reshape(
            n, self.num_derived)

    def _device_derived(self, derived):
        """Host derived rows as a float32 device tensor, or None when
        num_derived is 0 (the kernels then carry no derived tensor)."""
        if not self.num_derived:
            return None
        return torch.as_tensor(np.asarray(derived, dtype=np.float32),
                               device=self.device)

    def _mcmc_sample_live(self, mcmc_steps, active_u, active_logl,
                          num_chains, loglstar, step_size,
                          dynamic_step_size=False, prior_volume_steps=1,
                          adapt_cov=False, active_derived=None):
        """One MCMC pool generation from the live set (``active_derived``
        its (n_live, num_derived) derived values, needed when num_derived
        > 0). Under a mesh every rank draws the whole batch of starts and
        steps its share of the chains; a host prior of the starts is then
        evaluated whole on every rank, not farmed.

        Returns (u, logl, derived, moved, scale, mean_jump, ncall)."""
        if step_size <= 0.0:
            step_size = 2.0 / self.x_dim ** 0.5
        self.trainer.ensure_init()
        au, al, ad = self._live_tensors(active_u, active_logl, active_derived)
        with self.timers.time('mcmc_kernel', generations=1,
                              steps=mcmc_steps), torch.no_grad(), \
                self._local_rows():
            out = self.kernels.mcmc_from_live(
                self.generator, au, al, active_derived=ad,
                num_chains=num_chains, loglstar=loglstar,
                step_size=step_size, mcmc_steps=mcmc_steps,
                dynamic_step_size=dynamic_step_size,
                prior_volume_steps=prior_volume_steps, adapt_cov=adapt_cov,
                mesh=self.mesh)
        return self._consume_endpoint_out(
            out, mix_null=metropolis_mix_null(mcmc_steps, self.x_dim,
                                              adapt_cov=adapt_cov),
            cond_null=latent_cond_null(self.x_dim, num_chains),
            cond_inflates=True)

    def _slice_sample_live(self, slice_steps, active_u, active_logl,
                           num_chains, loglstar, width, max_expand=4,
                           max_shrink=10, adapt_cov=False,
                           active_derived=None):
        """One slice pool generation from the live set; the slice
        analogue of :meth:`_mcmc_sample_live`. Its latent condition number
        is recorded but does not inflate ``logzerr_adjusted`` (the JAX
        package's calibration: the slice kernel's kinetic term alone
        covers curved degeneracies). Sharded under a mesh as
        :meth:`_mcmc_sample_live` is.

        Returns (u, logl, derived, moved, scale, mean_jump, ncall)."""
        self.trainer.ensure_init()
        au, al, ad = self._live_tensors(active_u, active_logl, active_derived)
        with self.timers.time('mcmc_kernel', generations=1,
                              steps=slice_steps), torch.no_grad(), \
                self._local_rows():
            out = self.kernels.slice_from_live(
                self.generator, au, al, active_derived=ad,
                num_chains=num_chains, loglstar=loglstar, width=width,
                slice_steps=slice_steps, max_expand=max_expand,
                max_shrink=max_shrink, adapt_cov=adapt_cov, mesh=self.mesh)
        return self._consume_endpoint_out(
            out, mix_null=slice_mix_null(slice_steps, self.x_dim),
            cond_null=latent_cond_null(self.x_dim, num_chains))

    # ------------------------------------------- multi-generation prefetch

    def _live_tensors(self, active_u, active_logl, active_derived):
        """The live set as float32 device tensors, fresh copies (the
        prefetch batch runners update them in place), derived None when
        num_derived is 0."""
        def dev(a):
            return torch.tensor(np.asarray(a, dtype=np.float32),
                                device=self.device)
        return (dev(active_u), dev(active_logl),
                dev(active_derived) if self.num_derived else None)

    def _mcmc_generations_batch(self, mcmc_steps, active_u, active_logl,
                                active_derived, num_chains, step_size, it,
                                update_interval, max_gens,
                                dynamic_step_size=False, speculate=False,
                                adapt_cov=False):
        """Up to ``max_gens`` Metropolis pool generations in one dispatch
        and one pull (:meth:`LatentKernels.mcmc_pool_generations`), the
        consumption replayed on the device between them: the generations
        the one-generation route would run from this live set, drawn from
        the sampler's generator in its order. The host feeds each through
        :meth:`_consume_endpoint_out` when its replay reaches it; one it
        never reaches is never counted. Returns :meth:`_gens_to_buffer`'s
        list."""
        if step_size <= 0.0:
            step_size = 2.0 / self.x_dim ** 0.5
        self.trainer.ensure_init()
        with self.timers.time('mcmc_kernel', steps=mcmc_steps) as phase, \
                torch.no_grad():
            res = self.kernels.mcmc_pool_generations(
                self.generator,
                *self._live_tensors(active_u, active_logl, active_derived),
                it, step_size, update_interval, num_chains=num_chains,
                mcmc_steps=mcmc_steps, max_gens=max_gens,
                dynamic_step_size=dynamic_step_size, speculate=speculate,
                adapt_cov=adapt_cov)
            phase.attrs['generations'] = res[2]
            return self._gens_to_buffer(*res)

    def _slice_generations_batch(self, slice_steps, active_u, active_logl,
                                 active_derived, num_chains, width, it,
                                 update_interval, max_gens, max_expand=4,
                                 max_shrink=10, speculate=False,
                                 adapt_cov=False):
        """The slice analogue of :meth:`_mcmc_generations_batch`
        (:meth:`LatentKernels.slice_pool_generations`)."""
        self.trainer.ensure_init()
        with self.timers.time('mcmc_kernel', steps=slice_steps) as phase, \
                torch.no_grad():
            res = self.kernels.slice_pool_generations(
                self.generator,
                *self._live_tensors(active_u, active_logl, active_derived),
                it, width, update_interval, num_chains=num_chains,
                slice_steps=slice_steps, max_gens=max_gens,
                max_expand=max_expand, max_shrink=max_shrink,
                speculate=speculate, adapt_cov=adapt_cov)
            phase.attrs['generations'] = res[2]
            return self._gens_to_buffer(*res)

    def _rejection_prior_generations_batch(self, active_u, active_logl,
                                           active_derived, it, it_stop, ncs,
                                           expiry_thr, trials_target,
                                           num_trials, max_gens,
                                           adapt_trials, can_double,
                                           can_halve):
        """Up to ``max_gens`` prior-rejection generations in one dispatch
        and one pull (:meth:`LatentKernels.rejection_prior_generations`).
        ``ncs`` is the host's float64 efficiency window; its last 20 values
        go to the batch runner's float32 ring keyed on the absolute index.
        Returns :meth:`_gens_to_buffer`'s list (outputs x, logl, ok and
        derived when num_derived > 0)."""
        with self.timers.time('candidate_kernel'), torch.no_grad():
            res = self.kernels.rejection_prior_generations(
                self._user_prior, self.generator,
                *self._live_tensors(active_u, active_logl, active_derived),
                it, it_stop, *_window(ncs), expiry_thr, trials_target,
                num_trials=num_trials, max_gens=max_gens,
                adapt_trials=adapt_trials, can_double=can_double,
                can_halve=can_halve)
            return self._gens_to_buffer(*res)

    def _rejection_flow_generations_batch(self, active_u, active_logl,
                                          active_derived, it,
                                          update_interval, ncs, expiry_thr,
                                          trials_target, env_valid, env_gens,
                                          max_log_det_j, max_r,
                                          cache_interval, enlargement_factor,
                                          num_trials, max_gens, adapt_trials,
                                          can_double, can_halve):
        """The flow-rejection analogue of
        :meth:`_rejection_prior_generations_batch`
        (:meth:`LatentKernels.rejection_flow_generations`, the envelope
        carried on the device); the outputs add n_evals, mld and mr."""
        self.trainer.ensure_init()
        with self.timers.time('candidate_kernel'), torch.no_grad():
            res = self.kernels.rejection_flow_generations(
                self.generator,
                *self._live_tensors(active_u, active_logl, active_derived),
                it, update_interval, *_window(ncs), expiry_thr,
                trials_target, env_valid, env_gens, max_log_det_j, max_r,
                cache_interval, enlargement_factor, num_trials=num_trials,
                max_gens=max_gens, adapt_trials=adapt_trials,
                can_double=can_double, can_halve=can_halve)
            return self._gens_to_buffer(*res)

    @staticmethod
    def _gens_to_buffer(bufs, meta, n_gens):
        """A batch runner's stacked outputs as buffer entries, pulled to
        the host in one copy: ``(out, start_loglstar, start_it,
        gen_state)`` a generation, ``out`` a dict of numpy arrays,
        ``gen_state`` the generator's state before it (None unless the
        batch runner speculated)."""
        keys = list(bufs)
        with span('gen.pull'):
            host = _pull([bufs[k] for k in keys]
                         + [meta['start_loglstar'], meta['start_it']])
        lstars, its = host[-2], host[-1]
        states = meta['gen_state']
        # np.array: a 0-dim array, not a numpy scalar, for a 1-D output
        # (the exact-state file takes arrays, as tensors, and plain Python)
        return [({k: np.array(host[j][g]) for j, k in enumerate(keys)},
                 float(lstars[g]), int(its[g]),
                 None if states is None else states[g])
                for g in range(n_gens)]

    def _rewind_generator(self, state):
        """Set the sampler's generator back to ``state`` (a buffer entry's
        ``gen_state``): ``nnest_tpu``'s ``_rewind_key``."""
        self.generator.set_state(state)

    # ------------------------------------------- posterior chains, ensemble

    def _mcmc_init(self, num_chains, init_samples, init_loglikes,
                   max_start_tries, init_derived=None):
        """Latent chain starts: given points ``init_samples`` re-projected
        through forward then inverse (numerical consistency), with their
        host log likelihoods unless ``init_loglikes`` gives them (and
        ``init_derived`` their derived values, when num_derived > 0); else
        base draws through the flow's inverse until every start has a
        finite prior and likelihood (``max_start_tries`` tries, then a
        RuntimeError). Returns (z0, logl0, derived0, logl_prior0, the
        likelihood calls this paid), the first four as float32 tensors
        (derived0 None when num_derived is 0)."""
        self.trainer.ensure_init()
        model = self.trainer.model
        f32 = torch.float32
        ncall = 0
        with torch.no_grad():
            if init_samples is not None:
                z, _ = model(torch.as_tensor(
                    np.asarray(init_samples, dtype=np.float32),
                    device=self.device))
                x, _ = model.inverse(z)
                lp_prior = self._device_prior(x)
                if init_loglikes is None or (self.num_derived
                                             and init_derived is None):
                    logl, derived = self.loglike(_to_numpy(x))
                    ncall += z.shape[0]
                else:
                    logl, derived = np.asarray(init_loglikes), init_derived
            else:
                for i in range(max_start_tries):
                    z = model.sample_base(num_chains, self.generator)
                    x = _to_numpy(model.inverse(z)[0])
                    logl, derived = self.loglike(x)
                    ncall += num_chains
                    lp_prior = self.prior(x)
                    if np.all(logl > -1e30) and np.all(lp_prior > -1e30):
                        break
                    if i == max_start_tries - 1:
                        raise RuntimeError('Could not find starting value')
        return (z, torch.as_tensor(logl, dtype=f32, device=self.device),
                self._device_derived(derived),
                torch.as_tensor(lp_prior, dtype=f32, device=self.device),
                ncall)

    def _mcmc_sample_final(self, mcmc_steps, init_samples,
                           init_loglikes=None, loglstar=None,
                           dynamic_step_size=False, cov_from=None,
                           cov_mask=None, init_derived=None):
        """Endpoint-only Metropolis from explicit starts, the dynamic
        sampler's seed refresh: one chain a row of ``init_samples``,
        started by :meth:`_mcmc_init` (re-projected, with ``init_loglikes``
        and ``init_derived`` when given), constrained by ``loglstar`` when
        given; ``cov_from``
        (live rows as a float32 tensor, the ``cov_mask`` half of them when
        given) enables the covariance-preconditioned proposal. The step
        size starts at 2/sqrt(x_dim). Under a mesh the chains are
        dp-sharded.

        Returns (u, logl, derived, moved, scale, mean_jump, ncall);
        ``ncall`` includes the starts' likelihood calls."""
        num_chains = init_samples.shape[0]
        with self.timers.time('mcmc_init'):
            z0, logl0, derived0, lp_prior0, ncall_init = self._mcmc_init(
                num_chains, init_samples, init_loglikes, 1, init_derived)
        with self.timers.time('mcmc_kernel', generations=1,
                              steps=mcmc_steps), self._local_rows():
            out = self.kernels.mcmc(
                self.generator, z0, logl0, lp_prior0, derived0=derived0,
                loglstar=loglstar,
                step_size=2.0 / self.x_dim ** 0.5, mcmc_steps=mcmc_steps,
                dynamic_step_size=dynamic_step_size, cov_from=cov_from,
                cov_mask=cov_mask, mesh=self.mesh)
        *head, ncall = self._consume_endpoint_out(
            out, mix_null=metropolis_mix_null(mcmc_steps, self.x_dim,
                                              adapt_cov=cov_from is not None),
            cond_null=latent_cond_null(self.x_dim, num_chains),
            cond_inflates=True)
        return (*head, ncall + ncall_init)

    def _slice_sample_final(self, slice_steps, width, init_samples,
                            init_loglikes=None, loglstar=None, max_expand=4,
                            max_shrink=10, stat_moments=None, cov_from=None,
                            cov_mask=None, init_derived=None):
        """Endpoint-only slice sampling from explicit starts, the slice
        analogue of :meth:`_mcmc_sample_final`: :meth:`_mcmc_init`, then
        :meth:`LatentKernels.slice_draws` and ``slice_body``, the chains
        dp-sharded under a mesh.

        Returns (u, logl, derived, moved, scale, mean_jump, ncall);
        ``ncall`` includes the starts' likelihood calls."""
        num_chains = init_samples.shape[0]
        with self.timers.time('mcmc_init'):
            z0, logl0, derived0, _, ncall_init = self._mcmc_init(
                num_chains, init_samples, init_loglikes, 1, init_derived)
        with self.timers.time('mcmc_kernel', generations=1,
                              steps=slice_steps), self._local_rows():
            draws = self.kernels.slice_draws(self.generator, slice_steps,
                                             num_chains, self.x_dim,
                                             max_expand, max_shrink)
            out = self.kernels.slice_body(
                draws, z0, logl0, loglstar=loglstar, width=width,
                max_expand=max_expand, stat_moments=stat_moments,
                cov_from=cov_from, cov_mask=cov_mask, derived0=derived0,
                mesh=self.mesh)
        *head, ncall = self._consume_endpoint_out(
            out, mix_null=slice_mix_null(slice_steps, self.x_dim),
            cond_null=latent_cond_null(self.x_dim, num_chains))
        return (*head, ncall + ncall_init)

    def _mcmc_sample(self, mcmc_steps, step_size=0.0,
                     dynamic_step_size=False, num_chains=1,
                     init_samples=None, init_loglikes=None, loglstar=None,
                     max_start_tries=100, output_interval=None,
                     stats_interval=None, plot_trace=False,
                     prior_volume_steps=1):
        """Metropolis chains in the latent space, with their trajectories:
        full MH, or constrained by ``loglstar``; starts from
        :meth:`_mcmc_init`, step size 2/sqrt(x_dim) unless given;
        dp-sharded under a mesh. The whole trajectory stays on the device
        and is fetched once at the end. With ``output_interval`` (any
        value) the transformed chains are written as
        ``chains/chain_<i>.txt``; with ``stats_interval`` at most
        ``mcmc_steps`` their statistics are logged; ``plot_trace`` draws
        the first chain (:meth:`_plot_trace`).

        Returns (samples, latent, derived, loglikes, scale, ncall): samples
        and latent (chains, steps + 1, x_dim), derived (chains, steps + 1,
        num_derived) and loglikes (chains, steps + 1) in float64, samples
        in the chains' space (before the transform); ncall includes the
        starts' likelihood calls."""
        if step_size <= 0.0:
            step_size = 2.0 / self.x_dim ** 0.5
        z0, logl0, derived0, lp_prior0, ncall_init = self._mcmc_init(
            num_chains, init_samples, init_loglikes, max_start_tries)
        with self._local_rows():
            out = self.kernels.mcmc(
                self.generator, z0, logl0, lp_prior0, derived0=derived0,
                loglstar=loglstar,
                step_size=step_size, mcmc_steps=mcmc_steps,
                dynamic_step_size=dynamic_step_size,
                prior_volume_steps=prior_volume_steps, collect_chains=True,
                mesh=self.mesh)
        out = {k: _to_numpy(v) for k, v in out.items()}
        samples = out['samples'].astype(np.float64)
        loglikes = out['loglikes'].astype(np.float64)
        derived = self._trajectory_derived(out, loglikes.shape)
        self.total_calls += int(out['ncall'])
        self.total_fast_calls += int(out['fast_calls'])
        self.total_accepted += int(out['accepted'])
        self.total_rejected += int(out['rejected'])
        latent = out['latent'].astype(np.float64)
        self._trajectory_outputs(samples, latent, loglikes, derived,
                                 output_interval, stats_interval, plot_trace)
        return (samples, latent, derived, loglikes, float(out['scale']),
                int(out['ncall']) + ncall_init)

    def _trajectory_outputs(self, samples, latent, loglikes, derived,
                            output_interval, stats_interval, plot_trace):
        """The chain files, statistics and trace plot of a trajectory
        (samples before the transform)."""
        if output_interval is not None:
            self._save_samples(self._physical(samples), loglikes,
                               derived_samples=derived)
        if stats_interval is not None and samples.shape[1] - 1 >= \
                stats_interval:
            self._chain_stats(self._physical(samples))
        if plot_trace:
            self._plot_trace(samples, latent)

    def _trajectory_derived(self, out, shape):
        """A collect-chains output's derived trajectory (chains, steps + 1,
        num_derived) in float64; no columns when num_derived is 0."""
        flat = self._host_derived(out.get('derived'), shape[0] * shape[1])
        return flat.reshape(shape + (self.num_derived,))

    def _ensemble_sample(self, mcmc_steps, num_walkers, init_samples=None,
                         loglstar=None, max_start_tries=100,
                         output_interval=None, stats_interval=None,
                         plot_trace=False, moves=None):
        """The latent ensemble (:meth:`LatentKernels.stretch`) with the
        move zoo: ``moves`` a dict {name: weight} or (name, weight) pairs,
        by default the stretch move alone. The walkers start at the
        forward images of ``init_samples``, or at base draws through the
        inverse once all lie inside the prior. ``output_interval``,
        ``stats_interval`` and ``plot_trace`` as in :meth:`_mcmc_sample`.

        Returns (samples, latent, derived, loglikes, ncall): samples and
        latent (walkers, steps + 1, x_dim), derived (walkers, steps + 1,
        num_derived) and loglikes (walkers, steps + 1) in float64, samples
        before the transform."""
        if moves is None:
            moves = (('stretch', 1.0),)
        elif isinstance(moves, dict):
            moves = tuple(moves.items())
        else:
            moves = tuple(moves)
        self.trainer.ensure_init()
        model = self.trainer.model
        with torch.no_grad():
            if init_samples is not None:
                z, _ = model(torch.as_tensor(
                    np.asarray(init_samples, dtype=np.float32),
                    device=self.device))
            else:
                for i in range(max_start_tries):
                    z = model.sample_base(num_walkers, self.generator)
                    x = _to_numpy(model.inverse(z)[0])
                    if np.all(self.prior(x) > -1e30):
                        break
                    if i == max_start_tries - 1:
                        raise RuntimeError('Could not find starting value')
        out = self.kernels.stretch(self.generator, z, mcmc_steps=mcmc_steps,
                                   loglstar=loglstar, moves=moves)
        out = {k: _to_numpy(v) for k, v in out.items()}
        samples = out['samples'].astype(np.float64)
        loglikes = out['loglikes'].astype(np.float64)
        ncall = int(out['ncall'])
        self.total_calls += ncall
        self.total_accepted += int(out['accepted'])
        self.total_rejected += int(out['rejected'])
        latent = out['latent'].astype(np.float64)
        derived = self._trajectory_derived(out, loglikes.shape)
        self._trajectory_outputs(samples, latent, loglikes, derived,
                                 output_interval, stats_interval, plot_trace)
        return samples, latent, derived, loglikes, ncall

    def _physical(self, samples):
        """Chains (chains, steps, x_dim) through the sampler transform."""
        return self.transform(samples.reshape(-1, self.x_dim)).reshape(
            samples.shape)

    def _chain_stats(self, samples):
        """Log the acceptance, ESS range, mean jump and largest R-hat of
        chains (chains, steps, dim); returns (acceptance, ess, jump)."""
        flat = samples.reshape(-1, samples.shape[2])
        ess = effective_sample_size(samples, np.mean(flat, axis=0),
                                    np.std(flat, axis=0) ** 2)
        acceptance = acceptance_rate(samples)
        jump = mean_jump_distance(samples)
        rhat = (float(np.max(gelman_rubin_diagnostic(samples)))
                if samples.shape[0] > 1 else float('nan'))
        self.logger.info(
            'Acceptance [%5.4f] min ESS [%5.4f] max ESS [%5.4f] average '
            'jump [%5.4f] max R-hat [%5.4f]' % (
                acceptance, np.min(ess), np.max(ess), jump, rhat))
        return acceptance, ess, jump

    # --------------------------------------------------------- rejection

    def _rejection_prior_sample(self, loglstar, num_trials=512):
        """Batched prior rejection. Returns (samples, loglikes, derived,
        effective_ncall) with the successful trials only (may be empty)."""
        trials = int(num_trials)
        x, logl, derived, ok = self.kernels.rejection_prior(
            self._user_prior, self.generator, loglstar, trials)
        return self._candidates(x, logl, derived, ok, trials)

    def _candidates(self, x, logl, derived, ok, n_evals):
        """Counters of one rejection or flow-density generation (``n_evals``
        likelihood calls); returns the passing trials (u, logl, derived) in
        float64 and the likelihood calls per passing trial."""
        ok = _to_numpy(ok)
        n_evals = int(n_evals)
        self.total_calls += n_evals
        n_ok = int(ok.sum())
        nc = n_evals / max(n_ok, 1) if n_ok > 0 else max(n_evals, 1)
        return (_to_numpy(x)[ok].astype(np.float64),
                _to_numpy(logl).astype(np.float64)[ok],
                self._host_derived(derived, ok.shape[0])[ok], nc)

    def _rejection_flow_sample(self, init_samples, loglstar,
                               enlargement_factor=1.1, cache=False,
                               num_trials=512):
        """Batched flow rejection: the envelope from the live set
        ``init_samples`` (max-folded into the cached one when ``cache`` and
        a cached one exists, else replacing it), then one generation of
        ``num_trials`` trials in the latent ball. Returns (samples,
        loglikes, derived, effective_ncall) of the passing trials. Under a
        mesh every rank computes the envelope and all trials on the same
        replicated inputs (the JAX package's two-dispatch mesh route; in
        eager PyTorch the envelope and the draw are separate steps on every
        route), a host likelihood farmed over the ranks."""
        self.trainer.ensure_init()
        fold = bool(cache and self._max_log_det_j is not None)
        x, logl, derived, ok, n_evals, mld, mr = \
            self.kernels.rejection_flow_live(
                self.generator, loglstar,
                torch.as_tensor(np.asarray(init_samples, dtype=np.float32),
                                device=self.device),
                self._max_log_det_j if fold else 0.0,
                self._max_r if fold else 0.0, fold, enlargement_factor,
                int(num_trials))
        self._max_log_det_j = float(mld)
        self._max_r = float(mr)
        return self._candidates(x, logl, derived, ok, n_evals)

    def _density_sample(self, loglstar, num_trials=512):
        """Batched flow-density draws: ``num_trials`` base draws through
        the flow's inverse. Returns (samples, loglikes, derived,
        effective_ncall) of the passing draws."""
        self.trainer.ensure_init()
        return self._candidates(*self.kernels.density(
            self.generator, loglstar, int(num_trials)))

    # ---------------------------------------------------------------- io

    def _save_samples(self, samples, loglikes, weights=None,
                      derived_samples=None, min_weight=1e-30,
                      outfile='chain'):
        """getdist/CosmoMC text chain: rows of `weight -loglike params
        [derived]`, the derived columns from ``derived_samples`` (shaped
        like ``samples`` but for the last axis) when given. Samples
        (chains, steps, dim) write one file a chain, ``<outfile>_<i>.txt``
        with i from 1. Each file is written by the native runtime
        (``runtime.write_chain``), by ``np.savetxt`` where the machine has
        no ``g++``: the same bytes."""
        if self.logs is None:
            return
        if weights is None:
            weights = np.ones_like(loglikes)
        header = ''
        if self.param_names is not None:
            header = 'weight minusloglike ' + ' '.join(self.param_names)

        def write(name, s, ll, w, d):
            path = os.path.join(self.logs['chains'], name + '.txt')
            if _runtime.write_chain(path, w, ll, s, derived=d,
                                    min_weight=min_weight, header=header):
                return
            cols = [np.maximum(w, min_weight)[:, None],
                    -np.asarray(ll)[:, None], s]
            if d is not None:
                cols.append(d)
            np.savetxt(path, np.hstack(cols), fmt='%.5E', header=header,
                       comments='#' if header else '')

        if samples.ndim == 2:
            write(outfile, samples, loglikes, weights, derived_samples)
        else:
            for i in range(samples.shape[0]):
                write('%s_%d' % (outfile, i + 1), samples[i], loglikes[i],
                      weights[i], None if derived_samples is None
                      else derived_samples[i])

    def _plot_trace(self, samples, latent_samples):
        """The first chain's trace, each dim in the chains' space (left)
        and the latent space (right, first 1000 steps), to
        ``plots/trace.png``; nothing without matplotlib or a run
        directory."""
        if self.log_dir is None:
            return
        # one matplotlib user at a time: join the trainer's render first
        self._join_plots()
        try:
            from matplotlib.backends.backend_agg import FigureCanvasAgg
            from matplotlib.figure import Figure
        except ImportError:
            return
        fig = Figure(figsize=(10, max(self.x_dim, 2)))
        FigureCanvasAgg(fig)
        ax = np.atleast_2d(fig.subplots(self.x_dim, 2, sharex=True))
        for i in range(self.x_dim):
            ax[i, 0].plot(samples[0, :, i])
            ax[i, 1].plot(latent_samples[0, :1000, i])
        fig.savefig(os.path.join(self.log_dir, 'plots', 'trace.png'))

    # ------------------------------------------------------------ background

    def _submit_io(self, job):
        """Queue a file-IO closure on the background writer. The caller
        snapshots the state first: the closure may run while the main
        thread changes the live arrays."""
        if self._io_writer is None:
            self._io_writer = SerialWriter()
        self._io_writer.submit(job)

    def _drain_io(self):
        """Block until the queued writes are on disk; re-raise the first
        failure."""
        if self._io_writer is not None:
            with span('io.drain'):
                self._io_writer.drain()

    def _close_io(self):
        """Drain and stop the background writer (a later ``run()`` makes a
        new one)."""
        if self._io_writer is not None:
            writer, self._io_writer = self._io_writer, None
            with span('io.drain'):
                writer.close()

    def _join_plots(self):
        """Join the trainer's in-flight triptych render (a user's trainer
        without ``finish_plots`` is left alone)."""
        finish = getattr(self.trainer, 'finish_plots', None)
        if finish is not None:
            finish()
