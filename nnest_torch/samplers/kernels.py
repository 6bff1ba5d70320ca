"""Latent-space sampling kernels on the sampler's device.

Port of ``nnest_tpu/samplers/kernels.py``:
constrained (nested) and full Metropolis-Hastings latent MCMC with the
covariance-preconditioned proposal, dynamic step size and the fast-slow
proposal mask, in endpoint or collect-chains mode, constrained latent
slice sampling (stepping-out and shrinkage to acceptance, with
covariance-adapted directions), the red-black chain starts drawn from the
live set, the latent ensemble (red-black half updates with the stretch,
DE, DE-snooker and KDE moves), batched prior rejection, flow rejection
inside the Jacobian envelope (in the latent ball, or in the base's box
where it has ``usample``), flow-density draws, and the on-device chain
diagnostics (ESS, start decorrelation, second moments). With ``mesh`` the
Metropolis and slice bodies shard their chain axis over the ranks of a
process group (:class:`_Rows`); the live-set generations that call them
pass the mesh on, their starts drawn whole on every rank.

The JAX ``lax.scan`` becomes a Python loop over steps with the chains as
the batch dimension; accept/reject stay masks (``torch.where``) and every
counter stays a device tensor, so a Metropolis or ensemble step never
waits on the host (a slice step reads one flag a shrinkage iteration to
stop the loop; an ensemble call reads its moves once). Random numbers come
from the caller's ``torch.Generator``; the slice, ensemble and
flow-rejection kernels draw them in one function and take them as tensors
in a deterministic body. Every flow inverse inside a step, and the one
inverse of all trials of a flow-rejection or flow-density generation or of
an ensemble's trajectory, goes through :meth:`LatentKernels._hot_inverse`,
which for a single-speed spline flow on the GPU is the hand-written CUDA
kernel (``ops/spline_inverse.py``), for a fast-slow flow of two spline
chains that kernel once a chain, and for a single-speed NVP flow the NVP
kernel (``ops/nvp_inverse.py``).

On a card, without a mesh, and with the flat prior or the library's box
prior, the Metropolis step loop replays CUDA graphs of the step's own
tensor work (:class:`_StepGraphs`: the proposal, the prior and Jacobian
screen, the accept, the state update and the step's counters) around the
calls that stay Python calls: the draws from the caller's generator, the
hot inverse and the likelihood. Its draws, their stream and its results
are the eager loop's, bit for bit; a step makes about a dozen host
launches in place of 120 to 140.

The multi-generation batch runners
(:meth:`LatentKernels.mcmc_pool_generations`, ``slice_pool_generations``,
``rejection_prior_generations`` and ``rejection_flow_generations``) run
several pool generations back to back, replaying the host's consumption of
each pool on the device's live set in between
(:meth:`LatentKernels._consume_pool`: one launch of the port's own kernel
``csrc/consume_pool.cu`` on the card, its twin on the CPU), drawing from
the caller's generator in the one-generation route's order; they read one
stop flag a generation to the host, none when speculating.

Derived parameters ride beside the points as in the JAX package: the
likelihood returns ``(logl, derived)``, and every body keeps the derived
values of the point it keeps, by the same masks. With ``num_derived`` 0 no
derived tensor is made or carried, so a step launches the same device work
as without them.
"""

from __future__ import annotations

import contextlib
import functools
import math
import threading

import numpy as np
import torch

from nnest_torch.ops import fused_spline
from nnest_torch.ops.consume_pool import consume_pool
from nnest_torch.ops.nvp_inverse import is_fusable_nvp, nvp_inverse_fn
from nnest_torch.ops.spline_inverse import (fast_slow_inverse_fn,
                                             fused_inverse_fn)
from nnest_torch.parallel.mesh import (all_reduce_sum, batch_sharding,
                                       gather_columns, pad_rows, real_rows)
from nnest_torch.priors import UniformPrior
from nnest_torch.utils.profiling import count, span

# Finite sentinel for impossible log-densities (keeps ±inf/NaN out of the
# chain arithmetic; < -1e30 so the `> -1e30` validity checks keep working).
LOG_NEG = -1e31


def sanitize_log_density(lp):
    """Map NaN/±inf/very-negative log-densities to the finite LOG_NEG."""
    lp = torch.where(torch.isfinite(lp), lp, torch.full_like(lp, LOG_NEG))
    return torch.clamp(lp, min=LOG_NEG)


def trial_ladder(n_ok, trials_target, adapt_trials, can_double, can_halve):
    """The rejection strategies' trial ladder, for the host's loop
    (``samplers/nested.py``) and the batch runners' replica
    (:meth:`LatentKernels._ladder_window_update`) alike. A generation that
    passed ``n_ok`` candidates moves the power-of-two trial count toward
    ``trials_target`` candidates a generation as the shell shrinks: it
    doubles below half of it and halves above twice it (with
    ``adapt_trials``, where ``can_double`` or ``can_halve`` allows), and it
    pushes its likelihood calls per candidate min(max(n_ok, 1), 5) times
    onto the efficiency window, so that the expiry averages several
    generations. Returns (``'double'``, ``'halve'`` or None, pushes)."""
    move = None
    if adapt_trials:
        if n_ok < trials_target // 2 and can_double:
            move = 'double'
        elif n_ok > trials_target * 2 and can_halve:
            move = 'halve'
    return move, min(max(n_ok, 1), 5)


def _accept_mask(u, log_ratio):
    """Metropolis accept on given uniforms ``u``: u < exp(min(lr, 0))."""
    return u < torch.exp(torch.clamp(log_ratio, max=0.0))


def ess_device(chains, mu, var):
    """Truncated-autocorrelation ESS per dimension.

    chains: (num_chains, t, dim); mu/var: (dim,) normalising moments. The
    autocorrelation comes from one FFT over the step axis; lags contribute
    2 rho_s (1 - s/t) while any dim has rho_s > 0.05, as in the JAX
    package (and the reference's lag loop)."""
    b, t, d = chains.shape
    var = torch.clamp(var, min=1e-12)
    y = chains - mu[None, None, :]
    nfft = 1 << (2 * t - 1).bit_length()
    fy = torch.fft.rfft(y, n=nfft, dim=1)
    acf = torch.fft.irfft(fy * torch.conj(fy), n=nfft, dim=1)[:, :t, :]
    lags = torch.arange(1, t, device=chains.device, dtype=chains.dtype)
    rho = (torch.sum(acf, dim=0)[1:]
           / (b * (t - lags)[:, None] * var[None, :]))
    active = rho > 0.05
    inactive = ~torch.any(active, dim=1)
    s_break = torch.where(torch.any(inactive),
                          torch.argmax(inactive.to(torch.int32)),
                          torch.full((), t - 1, device=chains.device))
    within = (torch.arange(t - 1, device=chains.device) < s_break)[:, None]
    contrib = torch.where(active & within, 2.0 * rho * (1.0 - lags[:, None] / t),
                          torch.zeros_like(rho))
    return t / (1.0 + torch.sum(contrib, dim=0))


def mix_ratio_device(z_end, z0):
    """Min over latent dims of the chains' mean-square displacement from
    their starts over twice the start population's variance (~1 when the
    endpoints have forgotten their starts)."""
    dz = z_end - z0
    ref = 2.0 * torch.var(z0, dim=0, unbiased=False) + 1e-12
    return torch.min(torch.mean(dz * dz, dim=0) / ref)


def mix_moments_device(z_end, z0):
    """(cov, msd): the start population's latent covariance and the
    displacement second moment, for the host's eigenbasis diagnostic."""
    n = float(z0.shape[0])
    zc = z0 - torch.mean(z0, dim=0, keepdim=True)
    dz = z_end - z0
    return zc.T @ zc / n, dz.T @ dz / n


class LatentKernels:
    """Kernels bound to a flow model and device likelihood/prior functions.

    ``like_fn`` maps a (batch, dim) float32 tensor to a (batch,) log
    likelihood, or to ``(logl, derived)`` with derived (batch,
    num_derived), on the same device; ``prior_fn`` to a (batch,) log prior,
    or it is None (the flat prior) or a ``priors.UniformPrior`` (the box,
    by its ``logpdf``): those two the captured step loop runs
    (:meth:`mcmc`), whose graphs live in the dict ``graphs`` (a new one
    when None).
    :attr:`like_fn` returns ``(logl, derived)`` with logl sanitized and
    derived None when ``num_derived`` is 0 (zeros when ``like_fn`` returns
    logl alone); :attr:`prior_fn` is sanitized. ``num_slow`` and
    ``oversample_rate`` enable the fast-slow Metropolis proposal: with
    probability ``oversample_rate`` a proposal moves the fast latent dims
    [num_slow:] only.
    """

    def __init__(self, model, like_fn, prior_fn, num_slow=0,
                 oversample_rate=1.0, num_derived=0, graphs=None):
        if not callable(getattr(model, 'inverse', None)):
            raise ValueError('LatentKernels needs a flow model with an '
                             'inverse (build_flow); got %s'
                             % type(model).__name__)
        self.model = model
        self.num_derived = int(num_derived)

        def raw_like(u):
            res = like_fn(u)
            logl, derived = res if isinstance(res, tuple) else (res, None)
            return logl, self._derived_start(derived, u.shape[0], u.device)

        def safe_like(u):
            logl, derived = raw_like(u)
            return sanitize_log_density(logl), derived

        self._raw_like = raw_like
        self.like_fn = safe_like
        self.prior_fn = _log_prior(prior_fn)
        # the prior's key among the step graphs' (None: code of the
        # caller's, which the graphs do not capture)
        self._prior_key = (
            ('flat',) if prior_fn is None
            else ('box', tuple(prior_fn.minimum.tolist()),
                  tuple(prior_fn.maximum.tolist()))
            if type(prior_fn) is UniformPrior else None)
        self.num_slow = int(num_slow)
        self.oversample_rate = float(oversample_rate)
        self._fusable = fused_spline.is_fusable_spline(model)
        self._fast_slow = fused_spline.is_fusable_fast_slow(model)
        self._nvp = is_fusable_nvp(model)
        # 1 on the fast dims, 0 on the slow ones: dz times this freezes
        # the slow block for a fast-only move.
        self._fast_mask = torch.ones(
            model.dim, device=next(model.parameters()).device)
        self._fast_mask[:self.num_slow] = 0.0
        self._graphs = {} if graphs is None else graphs

    def _derived_start(self, derived0, n, device):
        """The starts' derived values: ``derived0``, zeros when it is None,
        or None when ``num_derived`` is 0."""
        if not self.num_derived:
            return None
        if derived0 is None:
            return torch.zeros(n, self.num_derived, device=device)
        return derived0

    def _hot_inverse(self):
        """Flow inverse for use inside chain steps, on one of four paths:

        - ``spline``, a single-speed spline flow: the parameter-only work
          (1x1-conv inverses, constant logdet) is packed once per kernel
          invocation, and each call runs the whole-chain inverse kernel
          (the JAX package's Pallas kernel ``pallas_inverse_from_consts``);
        - ``fast_slow``, a fast-slow flow of two spline chains: both chains
          packed once the same way, and each call runs the combine
          coupling's inverse in plain PyTorch, then the kernel on the slow
          chain and on the fast chain (``ops.spline_inverse.
          fast_slow_inverse``). It stands for the JAX package's plain
          ``FastSlowFlowModel.inverse``, which no Pallas kernel covers; two
          launches and the coupling's ~30 small launches bound it;
        - ``nvp``, a single-speed NVP flow (``ops.nvp_inverse.
          is_fusable_nvp``): every coupling's parameters packed once, and
          each call runs the whole chain's inverse as one launch of the
          NVP kernel (``ops.nvp_inverse.nvp_inverse``). It stands for the
          JAX package's plain NVP inverse, which no Pallas kernel covers;
          the kernel's latency bounds it;
        - ``plain``, every other flow (Cholesky, a fast-slow NVP flow): its
          own ``inverse`` in plain PyTorch, as in the JAX package.

        Each call of the returned callable counts once under the recorder's
        ``hot_inverse`` counter, by path."""
        if self._fusable:
            path, inverse = 'spline', fused_inverse_fn(self.model)
        elif self._fast_slow:
            path, inverse = 'fast_slow', fast_slow_inverse_fn(self.model)
        elif self._nvp:
            path, inverse = 'nvp', nvp_inverse_fn(self.model)
        else:
            path, inverse = 'plain', self.model.inverse

        def hot_inverse(z):
            count('hot_inverse', key=path)
            return inverse(z)
        return hot_inverse

    # ------------------------------------------------------------- MCMC

    def _latent_cov_chol(self, live_u, mask=None, n_masked=None):
        """Cholesky factor of the live set's latent covariance, from the
        rows in ``mask`` only when given (the red-black half the chain
        starts were not drawn from). A tiny relative jitter keeps it PD; a
        failed or NaN factor falls back to the diagonal scales."""
        with torch.no_grad():
            z, _ = self.model(live_u)
        if mask is None:
            n = float(z.shape[0])
            zc = z - torch.mean(z, dim=0, keepdim=True)
        else:
            n = float(n_masked)
            w = mask.to(z.dtype)[:, None]
            mean = torch.sum(z * w, dim=0, keepdim=True) / n
            zc = (z - mean) * w
        cov = zc.T @ zc / n
        dim = cov.shape[0]
        eps = 1e-6 * (torch.trace(cov) / dim + 1e-12)
        cov = cov + eps * torch.eye(dim, dtype=cov.dtype, device=cov.device)
        chol, info = torch.linalg.cholesky_ex(cov)
        fallback = torch.diag(torch.sqrt(torch.clamp(torch.diagonal(cov),
                                                     min=1e-12)))
        bad = (info != 0) | torch.any(torch.isnan(chol))
        return torch.where(bad, fallback, chol)

    def _cov_factor(self, cov_from, cov_mask):
        """The covariance factor of the live rows ``cov_from`` (the
        ``cov_mask`` half of them when given), or None without them."""
        if cov_from is None:
            return None
        return self._latent_cov_chol(
            cov_from, cov_mask,
            None if cov_mask is None
            else cov_from.shape[0] - cov_from.shape[0] // 2)

    # The Metropolis step in three pure pieces around the two calls that
    # stay Python calls (the flow's inverse and the likelihood): the eager
    # loop (:meth:`step`) and the captured graphs (:class:`_StepGraphs`)
    # both run these, so the maths has one definition.

    def _propose(self, z, dz, u_fast, scale, cov_chol, fast_mask):
        """A proposal from ``z``: dz (times ``cov_chol``' transpose when
        given) times ``scale``, the slow dims frozen by ``fast_mask`` when
        the fast-move uniform ``u_fast`` (None: a single-speed move) is
        below ``oversample_rate``."""
        if cov_chol is not None:
            dz = dz @ cov_chol.T
        dz = dz * scale
        if u_fast is not None:
            dz = torch.where(u_fast < self.oversample_rate, dz * fast_mask,
                             dz)
        return z + dz

    @staticmethod
    def _screen(state, carry, z_prop, x_prop, ldj_prop, u, prior_fn):
        """Constrained mode's prior+Jacobian test of one proposal, folded
        into ``carry`` = (z, x, ldj, passed) of the proposals tested so far
        this step (None: the state's point, none passed): a proposal that
        passes takes the carry's place."""
        z, x, ldj = state[:3]
        if carry is None:
            carry = (z, x, ldj, torch.zeros(z.shape[0], dtype=torch.bool,
                                            device=z.device))
        z_pr, x_pr, ldj_pr, mask1 = carry
        m = (_accept_mask(u, ldj_prop - ldj)
             & (prior_fn(x_prop) > -1e30))
        mcol = m[:, None]
        return (torch.where(mcol, z_prop, z_pr),
                torch.where(mcol, x_prop, x_pr),
                torch.where(m, ldj_prop, ldj_pr), mask1 | m)

    @staticmethod
    def _settle(state, prop, logl_prop, derived_prop, u, loglstar, real,
                prior_fn):
        """The accept and the new state, given the likelihood (sanitized)
        at ``prop`` = (z, x, ldj, passed): constrained mode's carry
        (:meth:`_screen`), accepted where it passed and logl > loglstar;
        in full MH the proposal with passed None, accepted on the ratio of
        logl + log prior (``prior_fn``) + log|dx/dz| with the uniforms
        ``u``. Returns (new state, accept, the proposal's x, the
        likelihood-call count)."""
        z, x, ldj, logl, logl_prior, derived = state
        z_new, x_new, ldj_new, mask1 = prop
        lp_prior_new = prior_fn(x_new)
        if loglstar is not None:
            n_evals = _count(mask1, real)
            accept = (mask1 & torch.isfinite(logl_prop)
                      & (logl_prop > loglstar))
        else:
            log_ratio = ((ldj_new - ldj) + (logl_prop - logl)
                         + (lp_prior_new - logl_prior))
            accept = _accept_mask(u, log_ratio)
            n_evals = z.shape[0] if real is None else _count(real, None)
        acol = accept[:, None]
        new_state = (torch.where(acol, z_new, z), torch.where(acol, x_new, x),
                     torch.where(accept, ldj_new, ldj),
                     torch.where(accept, logl_prop, logl),
                     torch.where(accept, lp_prior_new, logl_prior),
                     None if derived is None
                     else torch.where(acol, derived_prop, derived))
        return new_state, accept, x_new, n_evals

    def _tally(self, tally, accept, n_evals, u_fast, x_new, x_old, rows, *,
               collect_chains, dynamic_step_size):
        """A step's counters: ``tally`` (ncall, fast_calls, total_acc,
        moved, jump, acc_ctr, rej_ctr, scale) after the step; endpoint mode
        keeps ``moved`` and ``jump``, and ``dynamic_step_size`` adapts the
        scale toward 50% acceptance of all chains (``rows.total``)."""
        ncall, fast_calls, total_acc, moved, jump, acc_ctr, rej_ctr, scale = \
            tally
        ncall = ncall + n_evals
        if self.num_slow > 0:
            # the calls of a step whose (last) proposal moved the fast
            # dims only
            fast_calls = fast_calls + torch.where(
                u_fast < self.oversample_rate, n_evals, 0)
        n_acc = _count(accept, rows.real)
        total_acc = total_acc + n_acc
        if not collect_chains:
            moved = moved | accept
            jump = jump + torch.sum(torch.where(
                _real(accept, rows.real),
                torch.linalg.norm(x_new - x_old, dim=-1),
                torch.zeros_like(jump)))
        if dynamic_step_size:
            win = 2 * rows.total(n_acc) > rows.n
            acc_ctr = acc_ctr + win.to(acc_ctr.dtype)
            rej_ctr = rej_ctr + (~win).to(rej_ctr.dtype)
            scale = torch.where(
                acc_ctr > rej_ctr,
                scale * torch.exp(1.0 / (1.0 + acc_ctr)), scale)
            scale = torch.where(
                acc_ctr < rej_ctr,
                scale / torch.exp(1.0 / (1.0 + rej_ctr)), scale)
        return ncall, fast_calls, total_acc, moved, jump, acc_ctr, rej_ctr, \
            scale

    def step(self, state, inverse, draws, *, loglstar, scale, cov_chol,
             real=None):
        """One Metropolis step (constrained when ``loglstar`` is not None).

        ``state`` is (z, x, ldj, logl, logl_prior, derived), derived None
        when ``num_derived`` is 0; ``draws`` yields one
        (dz, u, u_fast) triple per proposal (``prior_volume_steps`` of
        them in constrained mode, one in full MH): standard normals,
        accept uniforms and the 0-dim fast-move uniform (None for a
        single-speed flow).
        ``real`` (chains,) bool marks the chains that count (a dp shard's
        pad rows do not), None all of them.
        Returns the new state, the accept mask, the proposal's x and the
        likelihood-call count (a tensor in constrained mode, the chain
        count as an int in full MH: a step makes no host tensor)."""
        if loglstar is None and len(draws) != 1:
            raise ValueError('a full Metropolis-Hastings step takes one '
                             'proposal, got %d' % len(draws))
        prop = None
        for dz, u, u_fast in draws:
            z_prop = self._propose(state[0], dz, u_fast, scale, cov_chol,
                                   self._fast_mask)
            x_prop, ldj_prop = inverse(z_prop)
            prop = ((z_prop, x_prop, ldj_prop, None) if loglstar is None
                    else self._screen(state, prop, z_prop, x_prop, ldj_prop,
                                      u, self.prior_fn))
        logl_prop, derived_prop = self.like_fn(prop[1])
        return self._settle(state, prop, logl_prop, derived_prop, u,
                            loglstar, real, self.prior_fn)

    @contextlib.contextmanager
    def _step_graphs(self, device, mesh, **shape):
        """The captured step loop (:class:`_StepGraphs`) for a generation
        of this shape (:meth:`_held_graphs`), held for the block; None
        where the loop runs eagerly: off a CUDA device, under a ``mesh``
        (the dynamic step size's all-reduce is eager), with a prior other
        than the flat one or the library's box (code of the caller's), or
        with no step."""
        if (device.type != 'cuda' or mesh is not None
                or self._prior_key is None or shape['mcmc_steps'] < 1):
            yield None
            return
        with self._held_graphs(device, **shape) as graphs:
            yield graphs

    @contextlib.contextmanager
    def _held_graphs(self, device, *, num_chains, dim, dtype, n_draws,
                     constrained, collect_chains, mcmc_steps,
                     dynamic_step_size, cov):
        """The step graphs of this shape from the ``graphs`` dict the
        kernels were given (samplers pass their trainer's, so the jobs
        sharing a trainer capture once), captured on first use and held
        for the block; None while another thread holds them."""
        key = (device, num_chains, dim, dtype, n_draws, self.num_derived,
               constrained, collect_chains, mcmc_steps, dynamic_step_size,
               cov, self.num_slow, self.oversample_rate, self._prior_key)
        graphs = self._graphs.get(key)
        if graphs is None:
            graphs = self._graphs[key] = _StepGraphs(self, key)
        if not graphs.lock.acquire(blocking=False):
            yield None
            return
        try:
            yield graphs
        finally:
            graphs.lock.release()

    @torch.no_grad()
    def mcmc(self, generator, z0, logl0, logl_prior0, *, derived0=None,
             loglstar=None, step_size, mcmc_steps, dynamic_step_size=False,
             prior_volume_steps=1, stat_moments=None, cov_from=None,
             cov_mask=None, collect_chains=False, draws=None, mesh=None):
        """Multi-chain latent Metropolis. Constrained (nested) mode when
        ``loglstar`` is given: accept on the prior+Jacobian ratio, then
        require logl > loglstar; full Metropolis-Hastings otherwise (the
        ratio of logl + log prior + log|dx/dz|). ``cov_from``/``cov_mask``
        enable the proposal dz ~ N(0, scale^2 C) with C from the masked
        live rows.

        Endpoint mode returns each chain's final state, a per-chain
        ``moved`` flag and statistics over all chains and steps (ESS,
        acceptance, mean jump, start decorrelation). ``collect_chains``
        returns the trajectories instead, stacked (chains, steps + 1, .)
        with the start first: ``samples`` (x), ``latent`` (z) and
        ``loglikes``; they stay on the device until the caller fetches
        them. Both return ``scale``, ``ncall``, ``fast_calls``,
        ``accepted`` and ``rejected``. With ``num_derived`` > 0 the starts'
        derived values ``derived0`` (chains, num_derived; zeros when None)
        ride along, and the output adds ``final_derived`` (endpoint mode)
        or the ``derived`` trajectory (collect-chains mode).

        The step loop reads nothing back to the host. Each step draws its
        (dz, u, u_fast) triples from ``generator`` (one triple per
        proposal, see :meth:`step`); ``draws``, a list of one such list a
        step, replaces them (the tests feed the JAX package's numbers).
        On a card without a mesh, with the flat or the box prior, the loop
        replays captured CUDA graphs of the step's own tensor work around
        the eager draws, inverse and likelihood calls (:meth:`_step_graphs`),
        with the eager loop's draws, stream and results bit for bit; the
        counter ``mcmc_graph`` (``graph_steps``, ``eager_steps``,
        ``captures``) records which loop ran.

        With ``mesh`` (:mod:`nnest_torch.parallel.mesh`) the chain axis is
        dp-sharded: every rank passes the whole batch of starts and draws
        the whole batch's numbers, steps its own chains, and the outputs
        are gathered, so every rank returns the same whole-batch result.
        The dynamic step size decides on the acceptances of all chains:
        one all-reduce a step. The trajectories are gathered for the
        statistics."""
        constrained = loglstar is not None
        device = z0.device
        num_chains, dim = z0.shape
        rows = _Rows(mesh, num_chains, device)
        ll_star = None if not constrained else _f32(loglstar, z0)
        with self._step_graphs(
                device, mesh, num_chains=num_chains, dim=dim,
                dtype=z0.dtype,
                n_draws=prior_volume_steps if constrained else 1,
                constrained=constrained, collect_chains=collect_chains,
                mcmc_steps=mcmc_steps, dynamic_step_size=dynamic_step_size,
                cov=cov_from is not None) as graphs:
            count('mcmc_graph', mcmc_steps,
                  key='eager_steps' if graphs is None else 'graph_steps')
            # the generation's eager work before its step loop
            with span('gen.prep'):
                inverse = self._hot_inverse()
                cov_chol = self._cov_factor(cov_from, cov_mask)
                z_start = rows.local(z0)
                x0, ldj0 = inverse(z_start)
                derived0 = rows.local(self._derived_start(
                    derived0, num_chains, device))
                state = (z_start, x0, ldj0,
                         sanitize_log_density(rows.local(logl0)),
                         sanitize_log_density(rows.local(logl_prior0)),
                         derived0)
                if graphs is not None:
                    graphs.start(state, step_size, cov_chol, ll_star)
                else:
                    tally = _tally_start(z_start.shape[0], step_size, device)
            with span('gen.steps'):
                if graphs is not None:
                    for s in range(mcmc_steps):
                        graphs.step(generator,
                                    None if draws is None else draws[s],
                                    inverse, self._raw_like)
                else:
                    state, tally, trajectories = self._eager_steps(
                        generator, state, tally, inverse, draws, rows,
                        cov_chol=cov_chol, loglstar=ll_star,
                        n_draws=prior_volume_steps if constrained else 1,
                        mcmc_steps=mcmc_steps, collect_chains=collect_chains,
                        dynamic_step_size=dynamic_step_size)
            if graphs is not None:
                state, tally, trajectories = graphs.result()

        ncall, fast_calls, total_acc, moved, jump, _, _, scale = tally
        ncall, fast_calls, total_acc, jump = rows.totals(
            ncall, fast_calls, total_acc, jump)
        common = {'scale': scale, 'ncall': ncall, 'fast_calls': fast_calls,
                  'accepted': total_acc,
                  'rejected': mcmc_steps * num_chains - total_acc}
        chains = trajectories[0]
        if collect_chains:
            samples, latent, loglikes, *derived = rows.gather(trajectories)
            if derived:
                common['derived'] = derived[0]
            return dict(common, samples=samples, latent=latent,
                        loglikes=loglikes)
        z_end, x_end, _, logl_end, _, d_end = state
        chains, z_end, x_end, logl_end, moved, *d_end = rows.gather(
            [chains, z_end, x_end, logl_end, moved]
            + ([d_end] if self.num_derived else []))
        if self.num_derived:
            common['final_derived'] = d_end[0]
        if stat_moments is None:
            mu = torch.mean(chains, dim=(0, 1))
            var = torch.var(chains, dim=(0, 1), unbiased=False)
        else:
            mu, var = stat_moments
        mix_cov, mix_msd = mix_moments_device(z_end, z0)
        return dict(common, **{
            'final_x': x_end, 'final_z': z_end, 'final_logl': logl_end,
            'moved': moved,
            'mean_jump': jump / torch.clamp(total_acc, min=1),
            'mix_ratio': mix_ratio_device(z_end, z0),
            'mix_cov': mix_cov, 'mix_msd': mix_msd,
            'ess': ess_device(chains, mu, var),
            'acceptance': total_acc / float(mcmc_steps * num_chains),
        })

    def _eager_steps(self, generator, state, tally, inverse, draws, rows,
                     *, cov_chol, loglstar, n_draws, mcmc_steps,
                     collect_chains, dynamic_step_size):
        """The step loop of :meth:`mcmc`, one launch at a time, from
        ``state`` and ``tally`` (:meth:`_tally`): (the final state, the
        final tally, the trajectories (x, then z, logl and derived in
        collect-chains mode) stacked (chains, steps + 1, .), the start
        first)."""
        device = state[0].device
        num_chains, dim = rows.n, state[0].shape[1]
        xs, zs, logls, ds = [state[1]], [state[0]], [state[3]], [state[5]]
        for s in range(mcmc_steps):
            step_draws = draws[s] if draws is not None else [
                (torch.randn(num_chains, dim, generator=generator,
                             device=device),
                 torch.rand(num_chains, generator=generator, device=device),
                 torch.rand((), generator=generator, device=device)
                 if self.num_slow > 0 else None)
                for _ in range(n_draws)]
            step_draws = [(rows.local(dz), rows.local(u), u_fast)
                          for dz, u, u_fast in step_draws]
            x_old = state[1]
            state, accept, x_new, n_evals = self.step(
                state, inverse, step_draws, loglstar=loglstar,
                scale=tally[7], cov_chol=cov_chol, real=rows.real)
            tally = self._tally(
                tally, accept, n_evals, step_draws[-1][2], x_new, x_old, rows,
                collect_chains=collect_chains,
                dynamic_step_size=dynamic_step_size)
            xs.append(state[1])
            if collect_chains:
                zs.append(state[0])
                logls.append(state[3])
                ds.append(state[5])
        trajectories = [torch.stack(xs, dim=1)]
        if collect_chains:
            trajectories += [torch.stack(zs, dim=1), torch.stack(logls, dim=1)]
            if self.num_derived:
                trajectories.append(torch.stack(ds, dim=1))
        return state, tally, trajectories

    @staticmethod
    def _red_black_split(generator, n_live):
        """Random half split of the live set: (start-half indices
        (n_live//2,), complement mask (n_live,) bool) — the complement
        carries the covariance estimate, independent of every start."""
        perm = torch.randperm(n_live, generator=generator,
                              device=generator.device)
        idx_a = perm[: n_live // 2]
        mask_a = torch.zeros(n_live, dtype=torch.bool,
                             device=generator.device)
        mask_a.index_fill_(0, idx_a, True)
        return idx_a, ~mask_a

    @torch.no_grad()
    def _live_starts(self, idx, active_u, active_logl, active_derived=None):
        """Chain starts at live rows ``idx``: (z0, logl0, derived0,
        logl_prior0, mu, var), with the numerical re-projection x -> z ->
        x; derived0 the rows of ``active_derived``, None when
        ``num_derived`` is 0."""
        x0 = active_u[idx]
        logl0 = active_logl[idx]
        derived0 = active_derived[idx] if self.num_derived else None
        z0, _ = self.model(x0)
        x0p, _ = self.model.inverse(z0)
        lp_prior0 = self.prior_fn(x0p)
        mu = torch.mean(active_u, dim=0)
        var = torch.var(active_u, dim=0, unbiased=False)
        return z0, logl0, derived0, lp_prior0, mu, var

    def live_split(self, generator, n_live, num_chains):
        """The red-black start and covariance split of a pool generation
        (:meth:`_chain_starts` with ``adapt_cov``): (start indices
        (num_chains,), covariance mask (n_live,) bool), for a caller that
        starts chains from explicit points."""
        idx_a, cov_mask = self._red_black_split(generator, n_live)
        idx = idx_a[torch.randint(0, n_live // 2, (num_chains,),
                                  generator=generator,
                                  device=generator.device)]
        return idx, cov_mask

    def _chain_starts(self, generator, active_u, active_logl, num_chains,
                      adapt_cov, active_derived=None):
        """Uniform chain starts drawn from the live set, from a random half
        when ``adapt_cov`` (the complement mask is returned for the
        covariance): (z0, logl0, derived0, logl_prior0, mu, var,
        cov_mask)."""
        n_live = active_u.shape[0]
        cov_mask = None
        if adapt_cov:
            idx, cov_mask = self.live_split(generator, n_live, num_chains)
        else:
            idx = torch.randint(0, n_live, (num_chains,),
                                generator=generator, device=generator.device)
        return self._live_starts(idx, active_u, active_logl,
                                 active_derived) + (cov_mask,)

    def mcmc_from_live(self, generator, active_u, active_logl, *,
                       num_chains, loglstar, step_size, mcmc_steps,
                       dynamic_step_size=False, prior_volume_steps=1,
                       adapt_cov=False, active_derived=None, mesh=None):
        """Constrained endpoint-mode Metropolis started from the live set:
        uniform chain starts (from a random half when ``adapt_cov``, whose
        complement gives the proposal covariance), re-projection, chains.
        ``active_derived`` (n_live, num_derived) is needed when
        ``num_derived`` > 0. With ``mesh`` every rank draws and re-projects
        the whole batch of starts, then :meth:`mcmc` steps its share."""
        with span('gen.prep'):
            z0, logl0, derived0, lp_prior0, mu, var, cov_mask = \
                self._chain_starts(generator, active_u, active_logl,
                                   num_chains, adapt_cov, active_derived)
        return self.mcmc(
            generator, z0, logl0, lp_prior0, derived0=derived0,
            loglstar=loglstar,
            step_size=step_size, mcmc_steps=mcmc_steps,
            dynamic_step_size=dynamic_step_size,
            prior_volume_steps=prior_volume_steps, stat_moments=(mu, var),
            cov_from=active_u if adapt_cov else None, cov_mask=cov_mask,
            mesh=mesh)

    # ------------------------------------------------------------ slice

    @staticmethod
    def slice_draws(generator, slice_steps, num_chains, dim, max_expand=4,
                    max_shrink=10):
        """Every random draw of one slice generation, as a dict: ``d``
        (steps, chains, dim) direction normals, ``h`` (steps, chains)
        height uniforms, ``v`` (steps, chains) bracket-position uniforms,
        ``jmax`` (steps, chains) the expansions apportioned to the left
        end (integers in [0, max_expand)), and ``shrink`` (steps,
        max_shrink + 40, chains) the shrinkage uniforms, one row for each
        iteration up to the safety bound."""
        device = generator.device
        shape = (slice_steps, num_chains)
        d = torch.randn(shape + (dim,), generator=generator, device=device)
        h = torch.rand(shape, generator=generator, device=device)
        v = torch.rand(shape, generator=generator, device=device)
        jmax = (torch.randint(0, max_expand, shape, generator=generator,
                              device=device) if max_expand > 0
                else torch.zeros(shape, dtype=torch.int64, device=device))
        shrink = torch.rand((slice_steps, max_shrink + 40, num_chains),
                            generator=generator, device=device)
        return {'d': d, 'h': h, 'v': v, 'jmax': jmax, 'shrink': shrink}

    @torch.no_grad()
    def slice_body(self, draws, z0, logl0, *, loglstar, width, max_expand=4,
                   stat_moments=None, cov_from=None, cov_mask=None,
                   derived0=None, mesh=None):
        """Constrained latent slice sampling (Neal 2003) on given draws
        (:meth:`slice_draws`): one move per chain and step, all chains
        batched. The target is the flow-pushforward prior restricted to
        the shell, f(z) = |J(z)| 1[prior ok] 1[logl > loglstar], the
        constrained Metropolis kernel's.

        Per step: the direction d = n / |n|, times the covariance factor
        of the masked live rows ``cov_from`` when given (cov directions);
        the height logy = ldj + log1p(-h); the bracket [-width v,
        width (1 - v)] stepped out for ``max_expand`` iterations, ``jmax``
        of them for the left end and the rest for the right, both ends
        in one inverse of 2N stacked rows; then shrinkage to acceptance:
        t uniform in the bracket is taken if in the slice (height test
        ``ldj >= logy``, the prior box, logl > loglstar), else the bracket
        shrinks to t. The bracket always holds t = 0, whose height test
        ``>=`` passes, so every lane accepts; the loop stops when all have
        accepted, or at the ``max_shrink + 40`` rows of ``draws['shrink']``
        (an f32-collapse safety bound). Once a lane has accepted, its
        iterations change nothing; the host reads ``acc.all()`` after
        every iteration, since an iteration is a stream of small launches
        (the generation is host-bound) and costs more than the read.

        ``ncall`` counts the evaluations a sequential sampler would pay:
        lanes still active whose geometry test (prior box and height)
        passed. Returns the endpoint dict of :meth:`mcmc` (``scale`` is
        ``width``; ``fast_calls`` is 0), with the accepted points' derived
        values as ``final_derived`` when ``num_derived`` > 0 (the starts'
        are ``derived0``, zeros when None).

        With ``mesh`` the chain axis is dp-sharded as in :meth:`mcmc`
        (whole-batch starts and draws, this rank's chains, gathered
        outputs); the shrinkage loop stops when every lane of every rank
        has accepted (one all-reduce an iteration), so the ranks leave it
        together."""
        inverse = self._hot_inverse()
        device = z0.device
        num_chains = z0.shape[0]
        rows = _Rows(mesh, num_chains, device)
        slice_steps = draws['d'].shape[0]
        hard_cap = draws['shrink'].shape[1]
        ll_star = _f32(loglstar, z0)
        width = _f32(width, z0)
        cov_chol = self._cov_factor(cov_from, cov_mask)
        z_start = rows.local(z0)
        x0, ldj0 = inverse(z_start)
        z, x, ldj, logl = (z_start, x0, ldj0,
                           sanitize_log_density(rows.local(logl0)))
        der = rows.local(self._derived_start(derived0, num_chains, device))
        m = z.shape[0]
        zeros_b = torch.zeros(m, dtype=torch.bool, device=device)
        ncall = torch.zeros((), dtype=torch.int64, device=device)
        total_acc = torch.zeros((), dtype=torch.int64, device=device)
        moved = zeros_b
        jump = torch.zeros((), device=device)
        xs = [x0]

        def count(mask):
            return _count(mask, rows.real)

        for s in range(slice_steps):
            d = rows.local(draws['d'][s])
            d = d / torch.clamp(torch.linalg.norm(d, dim=-1, keepdim=True),
                                min=1e-12)
            if cov_chol is not None:
                d = d @ cov_chol.T
            logy = ldj + torch.log1p(-rows.local(draws['h'][s]))
            left = -width * rows.local(draws['v'][s])
            right = left + width
            jmax = rows.local(draws['jmax'][s])
            kmax = (max_expand - 1) - jmax
            done_l = done_r = zeros_b
            logy2 = torch.cat([logy, logy])
            for i in range(max_expand):
                geom, full, _, _, _, _ = self._in_slice(
                    inverse, torch.cat([z + left[:, None] * d,
                                        z + right[:, None] * d]),
                    logy2, ll_star)
                act_l = ~done_l & (i < jmax)
                act_r = ~done_r & (i < kmax)
                ncall = ncall + count(act_l & geom[:m]) \
                    + count(act_r & geom[m:])
                in_l, in_r = full[:m], full[m:]
                left = torch.where(act_l & in_l, left - width, left)
                right = torch.where(act_r & in_r, right + width, right)
                done_l = done_l | (act_l & ~in_l)
                done_r = done_r | (act_r & ~in_r)

            acc = zeros_b
            z_n, x_n, ldj_n, logl_n, der_n = z, x, ldj, logl, der
            for i in range(hard_cap):
                t = left + (right - left) * rows.local(draws['shrink'][s, i])
                zc = z + t[:, None] * d
                geom, ok, xc, ldjc, loglc, derc = self._in_slice(
                    inverse, zc, logy, ll_star)
                act = ~acc
                ncall = ncall + count(act & geom)
                take = act & ok
                tcol = take[:, None]
                z_n = torch.where(tcol, zc, z_n)
                x_n = torch.where(tcol, xc, x_n)
                ldj_n = torch.where(take, ldjc, ldj_n)
                logl_n = torch.where(take, loglc, logl_n)
                if der is not None:
                    der_n = torch.where(tcol, derc, der_n)
                acc = acc | take
                shr = act & ~ok
                left = torch.where(shr & (t < 0), t, left)
                right = torch.where(shr & (t >= 0), t, right)
                if rows.all_true(acc):
                    break

            total_acc = total_acc + count(acc)
            moved = moved | acc
            jump = jump + torch.sum(torch.where(
                _real(acc, rows.real), torch.linalg.norm(x_n - x, dim=-1),
                torch.zeros_like(ldj)))
            z, x, ldj, logl, der = z_n, x_n, ldj_n, logl_n, der_n
            xs.append(x)

        ncall, total_acc, jump = rows.totals(ncall, total_acc, jump)
        chains, z, x, logl, moved, *der = rows.gather(
            [torch.stack(xs, dim=1), z, x, logl, moved]
            + ([der] if der is not None else []))
        der = der[0] if der else None
        if stat_moments is None:
            mu = torch.mean(chains, dim=(0, 1))
            var = torch.var(chains, dim=(0, 1), unbiased=False)
        else:
            mu, var = stat_moments
        mix_cov, mix_msd = mix_moments_device(z, z0)
        return {
            **({'final_derived': der} if der is not None else {}),
            'final_x': x, 'final_z': z, 'final_logl': logl,
            'moved': moved, 'scale': width, 'ncall': ncall,
            'fast_calls': torch.zeros((), dtype=torch.int64, device=device),
            'mean_jump': jump / torch.clamp(total_acc, min=1),
            'mix_ratio': mix_ratio_device(z, z0),
            'mix_cov': mix_cov, 'mix_msd': mix_msd,
            'ess': ess_device(chains, mu, var),
            'acceptance': total_acc / float(slice_steps * num_chains),
            'accepted': total_acc,
            'rejected': slice_steps * num_chains - total_acc,
        }

    def _in_slice(self, inverse, zc, logy, loglstar):
        """The slice test of latent points ``zc`` at log heights ``logy``:
        (geom, full, x, ldj, logl, derived), where geom is the prior box
        and the height test ``ldj >= logy`` (no likelihood call needed) and
        full
        adds the hard constraint logl > loglstar. ``>=``, not ``>``: a
        bracket collapsed onto the current point must accept it, even
        where log1p(-h) vanishes against a large |ldj| in float32."""
        xc, ldjc = inverse(zc)
        geom = (self.prior_fn(xc) > -1e30) & (ldjc >= logy)
        loglc, derc = self.like_fn(xc)
        return geom, geom & (loglc > loglstar), xc, ldjc, loglc, derc

    def slice_from_live(self, generator, active_u, active_logl, *,
                        num_chains, loglstar, width, slice_steps,
                        max_expand=4, max_shrink=10, adapt_cov=False,
                        active_derived=None, mesh=None):
        """One slice pool generation started from the live set: the chain
        starts and red-black split of :meth:`mcmc_from_live`, then
        :meth:`slice_draws` and :meth:`slice_body` (cov directions from
        the complement half when ``adapt_cov``; with ``mesh`` the chains
        dp-sharded)."""
        z0, logl0, derived0, _, mu, var, cov_mask = self._chain_starts(
            generator, active_u, active_logl, num_chains, adapt_cov,
            active_derived)
        draws = self.slice_draws(generator, slice_steps, num_chains,
                                 self.model.dim, max_expand, max_shrink)
        return self.slice_body(
            draws, z0, logl0, loglstar=loglstar, width=width,
            max_expand=max_expand, stat_moments=(mu, var),
            cov_from=active_u if adapt_cov else None, cov_mask=cov_mask,
            derived0=derived0, mesh=mesh)

    # ------------------------------------------- multi-generation prefetch

    @staticmethod
    def _consume_pool(au, al, ad, it, accept_flags, cand_logl, cand_x,
                      cand_derived, update_interval=None):
        """The host's pool consumption replayed on the device's live set
        (``nnest_tpu``'s ``LatentKernels._consume_pool``): candidates in
        order against the current worst point (argmin, the first index on a
        tie); one whose flag is set and whose logl is strictly above it
        replaces it (x row, logl, derived row) and advances ``it``. Updates
        ``au``, ``al`` and ``ad`` (None without derived values) in place.
        Returns (au, al, ad, it, crossed), ``crossed`` whether an accept
        landed on ``it % update_interval == 0``. One launch of
        ``csrc/consume_pool.cu`` on the card (``ops/consume_pool.py``)."""
        with span('gen.consume'):
            return consume_pool(au, al, ad, it, accept_flags, cand_logl,
                                cand_x, cand_derived, update_interval)

    @staticmethod
    def _ladder_window_update(n_ok, nc, wvals, wcount, expiry_thr,
                              trials_target, adapt_trials, can_double,
                              can_halve):
        """The rejection batch runners' replica of the host's ``ncs``
        efficiency window, with the trial ladder's decisions from
        :func:`trial_ladder`. ``wvals`` is the window's last 20 values as
        float32, a ring keyed on the absolute push index ``wcount``; a
        generation pushes ``nc`` as many times as the ladder says. The expiry
        proxy is the ring's float32 sum, added in index order and times
        float32(0.05), the arithmetic XLA gives ``nnest_tpu``'s ``sum / 20``;
        it must stay below ``expiry_thr`` (0.9 x the host's float64
        threshold), so the host's expiry cannot fire inside a prefetched
        batch. Runs on the host with the generation's ``n_ok``. Returns
        (ladder_or_expiry_stop, wvals, wcount)."""
        n_ok = int(n_ok)
        nc = np.float32(nc)
        wvals = np.array(wvals, dtype=np.float32)
        wcount = int(wcount)
        move, pushes = trial_ladder(n_ok, trials_target, adapt_trials,
                                    can_double, can_halve)
        for _ in range(pushes):
            wvals[wcount % 20] = nc
            wcount += 1
        proxy = np.float32(0.0)
        if wcount > 20:
            total = np.float32(0.0)
            for v in wvals:
                total = np.float32(total + v)
            proxy = np.float32(total * np.float32(0.05))
        return (move is not None or bool(proxy > np.float32(expiry_thr)),
                wvals, wcount)

    @staticmethod
    def _host_ints(*tensors):
        """0-dim device tensors as Python ints, in one device-to-host copy
        (the one read a generation that a stop rule needs)."""
        with span('gen.pull'):
            return torch.stack([t.reshape(()).to(torch.int64)
                                for t in tensors]).tolist()

    def _pool_generations(self, core, generator, active_u, active_logl,
                          active_derived, it0, update_interval, max_gens,
                          speculate=False):
        """The endpoint kernels' multi-generation batch runner (``nnest_tpu``'s
        ``_pool_generations``): up to ``max_gens`` generations of ``core``
        (a live-set generation drawing from ``generator`` in the order of
        the one-generation route), each launched from the live set the
        previous one's consumption (:meth:`_consume_pool`) left on the
        device, so consecutive generations need nothing from the host. The
        live set ``active_u``/``active_logl``/``active_derived`` (float32
        device tensors, derived None without derived values) is updated in
        place.

        Without ``speculate`` the batch runner stops after a generation whose
        consumption crosses an ``update_interval`` boundary, where the host
        may retrain the flow; it reads that one flag a generation. With
        ``speculate`` it reads nothing and runs on past boundaries, and
        ``meta['gen_state']`` holds the generator's state before each
        generation, to rewind to when the host retrains after all. The
        host's ``max_iters`` is not a stop rule: generations past it are
        discarded unconsumed, which changes nothing the run returns.

        Returns (bufs, meta, n_gens): ``bufs`` each output of ``core``
        stacked over the generations run, ``meta`` their ``start_loglstar``
        and ``start_it`` (stacked device tensors) and ``gen_state``."""
        au, al, ad = active_u, active_logl, active_derived
        it = torch.tensor(int(it0), dtype=torch.int32, device=au.device)
        outs, lstars, its, states = [], [], [], []
        for _ in range(max_gens):
            if speculate:
                states.append(generator.get_state())
            loglstar = torch.min(al)
            out = core(generator, au, al, ad, loglstar)
            lstars.append(loglstar)
            its.append(it)
            au, al, ad, it, crossed = self._consume_pool(
                au, al, ad, it, out['moved'], out['final_logl'],
                out['final_x'], out.get('final_derived'),
                update_interval=update_interval)
            outs.append(out)
            if not speculate and self._host_ints(crossed)[0]:
                break
        return _stacked(outs, lstars, its, states if speculate else None)

    def mcmc_pool_generations(self, generator, active_u, active_logl,
                              active_derived, it, step_size, update_interval,
                              *, num_chains, mcmc_steps, max_gens,
                              dynamic_step_size=False, prior_volume_steps=1,
                              speculate=False, adapt_cov=False):
        """Up to ``max_gens`` Metropolis pool generations from the live set
        (:meth:`mcmc_from_live` each, ``loglstar`` the device live set's
        minimum), with the consumption replayed on the device between them
        (:meth:`_pool_generations`). Under ``adapt_cov`` each generation's
        proposal covariance comes from the evolving device live set: the
        live set the one-generation route would pass."""
        def core(generator, au, al, ad, loglstar):
            return self.mcmc_from_live(
                generator, au, al, num_chains=num_chains, loglstar=loglstar,
                step_size=step_size, mcmc_steps=mcmc_steps,
                dynamic_step_size=dynamic_step_size,
                prior_volume_steps=prior_volume_steps, adapt_cov=adapt_cov,
                active_derived=ad)

        return self._pool_generations(core, generator, active_u, active_logl,
                                      active_derived, it, update_interval,
                                      max_gens, speculate)

    def slice_pool_generations(self, generator, active_u, active_logl,
                               active_derived, it, width, update_interval, *,
                               num_chains, slice_steps, max_gens,
                               max_expand=4, max_shrink=10, speculate=False,
                               adapt_cov=False):
        """The slice analogue of :meth:`mcmc_pool_generations`
        (:meth:`slice_from_live` each; the same stop rules and generator
        discipline)."""
        def core(generator, au, al, ad, loglstar):
            return self.slice_from_live(
                generator, au, al, num_chains=num_chains, loglstar=loglstar,
                width=width, slice_steps=slice_steps, max_expand=max_expand,
                max_shrink=max_shrink, adapt_cov=adapt_cov,
                active_derived=ad)

        return self._pool_generations(core, generator, active_u, active_logl,
                                      active_derived, it, update_interval,
                                      max_gens, speculate)

    def rejection_prior_generations(self, prior, generator, active_u,
                                    active_logl, active_derived, it, it_stop,
                                    window_vals, window_count, expiry_thr,
                                    trials_target, *, num_trials, max_gens,
                                    adapt_trials, can_double, can_halve):
        """Up to ``max_gens`` prior-rejection generations
        (:meth:`rejection_prior` each) with the consumption replayed on the
        device between them. The batch runner stops after a generation the
        host's replay might not follow with another of the same kind, so the
        generator's stream stays that of one generation a dispatch: the
        ladder would change the trial count, or the expiry proxy passes
        ``expiry_thr`` (:meth:`_ladder_window_update`, on the host from the
        generation's ``n_ok``), or ``it`` reached ``it_stop`` (two
        iterations before the volume switch can fire). It reads
        (``n_ok``, ``it``) once a generation.

        Returns (bufs, meta, n_gens): ``bufs`` x, logl, derived (when
        ``num_derived`` > 0) and ok stacked over the generations run."""
        au, al, ad = active_u, active_logl, active_derived
        it_t = torch.tensor(int(it), dtype=torch.int32, device=au.device)
        wvals, wcount = window_vals, window_count
        outs, lstars, its = [], [], []
        for _ in range(max_gens):
            loglstar = torch.min(al)
            x, logl, derived, ok = self.rejection_prior(
                prior, generator, loglstar, num_trials)
            lstars.append(loglstar)
            its.append(it_t)
            au, al, ad, it_t, _ = self._consume_pool(au, al, ad, it_t, ok,
                                                     logl, x, derived)
            outs.append(_rejection_out(x, logl, derived, ok))
            n_ok, it2 = self._host_ints(torch.sum(ok), it_t)
            nc = (np.float32(num_trials) / np.float32(max(n_ok, 1))
                  if n_ok > 0 else np.float32(num_trials))
            stop, wvals, wcount = self._ladder_window_update(
                n_ok, nc, wvals, wcount, expiry_thr, trials_target,
                adapt_trials, can_double, can_halve)
            if stop or it2 >= it_stop:
                break
        return _stacked(outs, lstars, its, None)

    def rejection_flow_generations(self, generator, active_u, active_logl,
                                   active_derived, it, update_interval,
                                   window_vals, window_count, expiry_thr,
                                   trials_target, env_valid, env_gens,
                                   max_log_det_j, max_r, cache_interval,
                                   enlargement_factor, *, num_trials,
                                   max_gens, adapt_trials, can_double,
                                   can_halve):
        """Up to ``max_gens`` flow-rejection generations
        (:meth:`rejection_flow_live` each) with the consumption replayed on
        the device between them and the Jacobian envelope carried on the
        device: each generation recomputes it from the device live set and
        max-folds it into the carried maxima, or replaces them when it is
        not valid yet or after ``cache_interval`` generations (the host's
        ``env_gens`` counter, kept here in the same integers). The stop
        rules are :meth:`rejection_prior_generations`'s ladder and expiry
        proxy plus an ``update_interval`` crossing (a retrain invalidates
        the flow and the envelope); it reads (``n_ok``, ``n_evals``, ``it``,
        ``crossed``) once a generation.

        Returns (bufs, meta, n_gens): ``bufs`` x, logl, derived (when
        ``num_derived`` > 0), ok, n_evals and each generation's envelope
        ``mld`` and ``mr``."""
        au, al, ad = active_u, active_logl, active_derived
        it_t = torch.tensor(int(it), dtype=torch.int32, device=au.device)
        mld = _f32(max_log_det_j, au)
        mr = _f32(max_r, au)
        wvals, wcount = window_vals, window_count
        outs, lstars, its = [], [], []
        for _ in range(max_gens):
            loglstar = torch.min(al)
            recompute = not env_valid or env_gens >= cache_interval
            x, logl, derived, ok, n_evals, mld, mr = self.rejection_flow_live(
                generator, loglstar, au, mld, mr, not recompute,
                enlargement_factor, num_trials)
            env_gens = 0 if recompute else env_gens + 1
            env_valid = True
            lstars.append(loglstar)
            its.append(it_t)
            au, al, ad, it_t, crossed = self._consume_pool(
                au, al, ad, it_t, ok, logl, x, derived,
                update_interval=update_interval)
            outs.append(dict(_rejection_out(x, logl, derived, ok),
                             n_evals=n_evals, mld=mld, mr=mr))
            n_ok, nev, crossed = self._host_ints(torch.sum(ok), n_evals,
                                                 crossed)
            nc = (np.float32(nev) / np.float32(max(n_ok, 1)) if n_ok > 0
                  else max(np.float32(nev), np.float32(1.0)))
            stop, wvals, wcount = self._ladder_window_update(
                n_ok, nc, wvals, wcount, expiry_thr, trials_target,
                adapt_trials, can_double, can_halve)
            if stop or crossed:
                break
        return _stacked(outs, lstars, its, None)

    # --------------------------------------------------------- ensemble

    def latent_log_prob(self, z, loglstar=None, inverse=None):
        """The ensemble's latent target at z, with x = flow^-1(z): (log
        prob, logl, derived), derived None when ``num_derived`` is 0. The
        log prob is logl(x) + log|dx/dz| + log prior(x);
        with ``loglstar`` (a 0-dim tensor) it is the constrained variant,
        log|dx/dz| + log prior(x) where logl > loglstar and ``LOG_NEG``
        elsewhere."""
        if inverse is None:
            inverse = self._hot_inverse()
        x, ldj = inverse(z)
        logl, derived = self.like_fn(x)
        lp_prior = self.prior_fn(x)
        if loglstar is not None:
            lp = torch.where(logl > loglstar, ldj + lp_prior,
                             torch.full_like(ldj, LOG_NEG))
        else:
            lp = logl + ldj + lp_prior
        return lp, logl, derived

    @staticmethod
    def stretch_draws(generator, mcmc_steps, num_walkers, dim,
                      moves=(('stretch', 1.0),)):
        """Every random draw of one ensemble call, as a dict: ``move``
        (steps,) the index into ``moves`` of each step's move, drawn by
        weight; then, for each step and half-update (half 0 moves the
        first n = num_walkers / 2 walkers, half 1 the rest): ``idx``
        (steps, 2, 3, n) partner rows of the other half (stretch and kde
        take the first, de two, snooker three), ``zeta`` (steps, 2, n) the
        stretch factor's uniforms, ``normal`` (steps, 2, n, dim) the de and
        kde noise and ``accept`` (steps, 2, n) the accept uniforms. A
        step's unused draws are drawn all the same."""
        if num_walkers % 2:
            raise ValueError('the ensemble needs an even number of walkers, '
                             'got %d' % num_walkers)
        device = generator.device
        half = num_walkers // 2
        weights = torch.tensor([float(w) for _, w in moves], device=device)
        move = (torch.multinomial(weights, mcmc_steps, replacement=True,
                                  generator=generator) if mcmc_steps > 0
                else torch.zeros(0, dtype=torch.int64, device=device))
        shape = (mcmc_steps, 2)
        return {
            'move': move,
            'idx': torch.randint(0, half, shape + (3, half),
                                 generator=generator, device=device),
            'zeta': torch.rand(shape + (half,), generator=generator,
                               device=device),
            'normal': torch.randn(shape + (half, dim), generator=generator,
                                  device=device),
            'accept': torch.rand(shape + (half,), generator=generator,
                                 device=device),
        }

    @torch.no_grad()
    def stretch_body(self, draws, z0, *, loglstar=None, a=2.0,
                     moves=(('stretch', 1.0),)):
        """Affine-invariant ensemble sampling in the latent space on given
        draws (:meth:`stretch_draws`): red-black half-ensemble updates, the
        first half against the second, then the second against the first
        half's new positions, with one move a step from the zoo of
        ``moves`` ((name, weight) pairs): 'stretch' (Goodman & Weare, scale
        ``a``), 'de' (differential evolution), 'snooker' (DE-snooker) and
        'kde' (an independence proposal from the other half's Gaussian KDE
        with a diagonal Scott's-rule bandwidth, the JAX package's
        documented departure from scipy's full-covariance KDE).

        The move indices are copied to the host once, so each step's move
        is a Python branch with no device read; every half-update is one
        launch of the hot inverse, and one more inverse over the whole
        latent trajectory ((steps + 1) x walkers rows) gives the samples.

        Returns ``samples`` and ``latent`` (walkers, steps + 1, dim),
        ``loglikes`` and ``log_probs`` (walkers, steps + 1), ``ncall``
        (steps x walkers, an int), ``accepted`` and ``rejected``; with
        ``num_derived`` > 0 also ``derived`` (walkers, steps + 1,
        num_derived), split and rejoined across the half-updates as the
        walkers are."""
        names = [name.lower() for name, _ in moves]
        unknown = sorted(set(names) - set(_MOVES))
        if unknown:
            raise ValueError('unknown ensemble move(s) %s; choose from %s'
                             % (unknown, list(_MOVES)))
        num_walkers, dim = z0.shape
        half = num_walkers // 2
        steps = draws['move'].shape[0]
        ll_star = None if loglstar is None else _f32(loglstar, z0)
        inverse = self._hot_inverse()
        lp, logl, der = self.latent_log_prob(z0, ll_star, inverse)
        z = z0
        zs, logls, lps, ders = [z0], [logl], [lp], [der]
        total_acc = torch.zeros((), dtype=torch.int64, device=z0.device)
        # the call's one device-to-host read: every step's move
        for s, m in enumerate(draws['move'].tolist()):
            propose = _MOVES[names[m]]
            parts = []
            for h, (lo, hi) in enumerate(((0, half), (half, num_walkers))):
                other = z[half:] if h == 0 else parts[0][0]
                prop, extra = propose(z[lo:hi], other, draws['idx'][s, h],
                                      draws['zeta'][s, h],
                                      draws['normal'][s, h], a)
                lp_prop, logl_prop, der_prop = self.latent_log_prob(
                    prop, ll_star, inverse)
                acc = _accept_mask(draws['accept'][s, h],
                                   extra + lp_prop - lp[lo:hi])
                acol = acc[:, None]
                part = (torch.where(acol, prop, z[lo:hi]),
                        torch.where(acc, lp_prop, lp[lo:hi]),
                        torch.where(acc, logl_prop, logl[lo:hi]))
                if der is not None:
                    part += (torch.where(acol, der_prop, der[lo:hi]),)
                parts.append(part)
                total_acc = total_acc + torch.sum(acc.to(torch.int64))
            z, lp, logl, *rest = (torch.cat(t) for t in zip(*parts))
            if der is not None:
                der, = rest
                ders.append(der)
            zs.append(z)
            lps.append(lp)
            logls.append(logl)
        latent = torch.stack(zs, dim=1)
        samples, _ = inverse(latent.reshape(-1, dim))
        return {**({'derived': torch.stack(ders, dim=1)}
                   if der is not None else {}),
                'samples': samples.reshape(latent.shape), 'latent': latent,
                'loglikes': torch.stack(logls, dim=1),
                'log_probs': torch.stack(lps, dim=1),
                'ncall': steps * num_walkers, 'accepted': total_acc,
                'rejected': steps * num_walkers - total_acc}

    def stretch(self, generator, z0, *, mcmc_steps, loglstar=None, a=2.0,
                moves=(('stretch', 1.0),)):
        """One ensemble call from the walkers' latent starts ``z0``:
        :meth:`stretch_draws`, then :meth:`stretch_body`."""
        draws = self.stretch_draws(generator, mcmc_steps, z0.shape[0],
                                   z0.shape[1], moves)
        return self.stretch_body(draws, z0, loglstar=loglstar, a=a,
                                 moves=moves)

    # -------------------------------------------------------- rejection

    @torch.no_grad()
    def rejection_prior(self, prior, generator, loglstar, num_trials):
        """Batched rejection from the prior: ``num_trials`` prior draws,
        all evaluated; returns (x, logl, derived, ok)."""
        x = prior.sample_torch(num_trials, generator)
        logl, derived = self.like_fn(x)
        ok = torch.isfinite(logl) & (logl > _f32(loglstar, x))
        return x, logl, derived, ok

    # --------------------------------------------------- rejection/flow

    @torch.no_grad()
    def envelope(self, live_u, enlargement_factor=1.1):
        """Jacobian envelope of flow rejection: ``enlargement_factor`` times
        the largest ``-log|det dz/dx|`` over the live set (the flow's
        forward), and the largest latent radius. Returns two 0-dim
        tensors (max_log_det_j, max_r)."""
        z, ldj = self.model(live_u)
        return (enlargement_factor * torch.max(-ldj),
                torch.max(torch.linalg.norm(z, dim=1)))

    def rejection_flow_draws(self, generator, num_trials, dim):
        """The random draws of one flow-rejection generation, (g, r, u):
        standard normals g (num_trials, dim) for the direction, uniforms r
        (num_trials, 1) for the radius and uniforms u (num_trials,) for
        the Jacobian accept. A base distribution with ``usample`` (the
        generalised normal) gives g uniform in its box [-1, 1]^dim
        instead, and r None."""
        device = generator.device
        base = self.model.base_dist
        if getattr(base, 'has_usample', False):
            g, r = base.usample(num_trials, generator), None
        else:
            g = torch.randn(num_trials, dim, generator=generator,
                            device=device)
            r = torch.rand(num_trials, 1, generator=generator, device=device)
        u = torch.rand(num_trials, generator=generator, device=device)
        return g, r, u

    @torch.no_grad()
    def rejection_flow_body(self, g, r, u, loglstar, max_log_det_j, max_r,
                            enlargement_factor):
        """Flow rejection on given draws (:meth:`rejection_flow_draws`):
        z uniform in the latent ball of radius ``enlargement_factor *
        max_r`` (direction g/|g|, radius r^(1/dim)), or z =
        ``enlargement_factor * g`` for the box draw (r None); x =
        flow^-1(z) in one call of the hot inverse over all trials, then
        the Jacobian accept u < exp(min(ldj - max_log_det_j, 0)), the
        prior box and logl > loglstar. Returns (x, logl, derived, ok,
        n_evals);
        ``n_evals`` counts the trials that passed the prior and the
        Jacobian accept (only those cost a likelihood call)."""
        if r is None:
            z = enlargement_factor * g
        else:
            r = r ** (1.0 / g.shape[1])
            g = g / torch.linalg.norm(g, dim=1, keepdim=True)
            z = enlargement_factor * max_r * g * r
        x, ldj = self._hot_inverse()(z)
        ok_prior = self.prior_fn(x) > -1e30
        evaluated = ok_prior & _accept_mask(u, ldj - max_log_det_j)
        logl, derived = self.like_fn(x)
        ok = evaluated & torch.isfinite(logl) & (logl > _f32(loglstar, x))
        return x, logl, derived, ok, torch.sum(evaluated.to(torch.int64))

    def rejection_flow_live(self, generator, loglstar, live_u, prev_mld,
                            prev_mr, fold, enlargement_factor, num_trials):
        """The envelope from the live set, max-folded into the carried
        maxima when ``fold`` (else it replaces them), then one
        flow-rejection generation in the ball enlarged by
        ``enlargement_factor``. Returns (x, logl, derived, ok, n_evals,
        max_log_det_j, max_r)."""
        mld, mr = self.envelope(live_u, enlargement_factor)
        if fold:
            mld = torch.maximum(_f32(prev_mld, mld), mld)
            mr = torch.maximum(_f32(prev_mr, mr), mr)
        draws = self.rejection_flow_draws(generator, num_trials,
                                          self.model.dim)
        return self.rejection_flow_body(*draws, loglstar, mld, mr,
                                        enlargement_factor) + (mld, mr)

    # ---------------------------------------------------------- density

    @torch.no_grad()
    def density_body(self, z, loglstar):
        """Flow-density sampling on given base draws ``z``: x = flow^-1(z)
        in one call of the hot inverse, kept when inside the prior box
        with logl > loglstar. Returns (x, logl, derived, ok, n_evals);
        ``n_evals`` counts the draws inside the prior box."""
        x, _ = self._hot_inverse()(z)
        ok_prior = self.prior_fn(x) > -1e30
        logl, derived = self.like_fn(x)
        ok = ok_prior & torch.isfinite(logl) & (logl > _f32(loglstar, x))
        return x, logl, derived, ok, torch.sum(ok_prior.to(torch.int64))

    def density(self, generator, loglstar, num_trials):
        """One flow-density generation: ``num_trials`` draws from the
        flow's base distribution; returns (x, logl, derived, ok,
        n_evals)."""
        return self.density_body(
            self.model.base_dist.sample(num_trials, generator), loglstar)


def _f32(value, like):
    """``value`` as a float32 tensor on ``like``'s device."""
    return torch.as_tensor(value, dtype=torch.float32, device=like.device)


def _rejection_out(x, logl, derived, ok):
    """One rejection generation's outputs as a dict (derived only when the
    kernels carry it)."""
    out = {'x': x, 'logl': logl, 'ok': ok}
    if derived is not None:
        out['derived'] = derived
    return out


def _stacked(outs, lstars, its, states):
    """A batch runner's per-generation outputs and starts as (bufs, meta,
    n_gens), every output stacked over the generations (a leading axis)."""
    bufs = {k: torch.stack([torch.as_tensor(o[k]) for o in outs])
            for k in outs[0]}
    meta = {'start_loglstar': torch.stack(lstars),
            'start_it': torch.stack(its), 'gen_state': states}
    return bufs, meta, len(outs)


def _flat_prior(u):
    """The flat log prior of the kernels made without one: zeros."""
    return torch.zeros(u.shape[0], dtype=u.dtype, device=u.device)


def _log_prior(prior):
    """The sanitized log prior of a batch: zeros for ``prior`` None, the
    library's box prior's ``logpdf`` for a ``priors.UniformPrior``, else
    the function ``prior`` itself."""
    if prior is None:
        return _flat_prior
    logpdf = prior.logpdf if type(prior) is UniformPrior else prior
    return lambda u: sanitize_log_density(logpdf(u))


def _tally_start(n, step_size, device):
    """A generation's counters before its first step
    (:meth:`LatentKernels._tally` for n chains): ncall, fast_calls and
    total_acc (int64), moved (n,) bool, jump, acc_ctr and rej_ctr
    (float32) at zero, and the scale at ``step_size``."""
    def zero(dtype=torch.float32):
        return torch.zeros((), dtype=dtype, device=device)
    return (zero(torch.int64), zero(torch.int64), zero(torch.int64),
            torch.zeros(n, dtype=torch.bool, device=device), zero(), zero(),
            zero(), torch.full((), step_size, dtype=torch.float32,
                               device=device))


def _fill(dst, src):
    """Copy each tensor of ``src`` into its place in ``dst`` (None, where
    there is no tensor, on both sides)."""
    for d, s in zip(dst, src):
        if d is not None:
            d.copy_(s)


class _StepGraphs:
    """The step loop of :meth:`LatentKernels.mcmc` for one shape as CUDA
    graphs of the kernels' own tensor work, between the calls that stay
    Python calls: a step draws its numbers eagerly from the generator into
    static buffers (the eager loop's calls, in its order: the same stream),
    then for each proposal replays P (:meth:`LatentKernels._propose`),
    calls the inverse on P's output and, in constrained mode, replays M
    (:meth:`LatentKernels._screen`), then calls the likelihood and
    replays U (:meth:`LatentKernels._settle`, ``_tally`` and the write of
    the step's x, and in collect-chains mode z, logl and derived, at a
    step index held on the device). The inverse and likelihood outputs
    are copied into static buffers; the state, counters, scale and
    trajectories are static buffers updated in place. Nothing in a graph
    reads the host, the flow or the likelihood, so one set of graphs
    serves every kernels object of the same key.

    ``key`` is :meth:`LatentKernels._held_graphs`'; the graphs are
    captured now (:meth:`_capture`), with a lock that one generation at a
    time holds."""

    def __init__(self, kern, key):
        (device, num_chains, dim, dtype, n_draws, num_derived, constrained,
         collect_chains, mcmc_steps, dynamic_step_size, cov, num_slow, _,
         prior_key) = key
        self.lock = threading.Lock()
        self.constrained = constrained
        self.collect_chains = collect_chains

        def buf(*shape, dtype=dtype):
            return torch.zeros(shape, dtype=dtype, device=device)

        nd = num_derived
        self.state = [buf(num_chains, dim), buf(num_chains, dim),
                      buf(num_chains), buf(num_chains), buf(num_chains),
                      buf(num_chains, nd) if nd else None]
        self.tally = list(_tally_start(num_chains, 0.0, device))
        self.cov = buf(dim, dim) if cov else None
        self.loglstar = buf() if constrained else None
        self.fast_mask = kern._fast_mask.to(device=device, copy=True)
        # the graphs' own prior (the box's bounds are tensors the graphs
        # read): the kernels' by value
        self.prior_fn = _log_prior(
            None if prior_key[0] == 'flat'
            else UniformPrior(dim, list(prior_key[1]), list(prior_key[2])))
        self.draws = [(buf(num_chains, dim), buf(num_chains),
                       buf() if num_slow > 0 else None)
                      for _ in range(n_draws)]
        self.prop = [buf(num_chains, dim), buf(num_chains, dim),
                     buf(num_chains)]
        self.carry = ([buf(num_chains, dim), buf(num_chains, dim),
                       buf(num_chains), buf(num_chains, dtype=torch.bool)]
                      if constrained else None)
        self.logl_prop = buf(num_chains)
        self.derived_prop = buf(num_chains, nd) if nd else None
        self.index = buf(1, dtype=torch.int64)
        steps = mcmc_steps + 1
        self.trajectories = [buf(num_chains, steps, dim)]
        if collect_chains:
            self.trajectories += [buf(num_chains, steps, dim),
                                  buf(num_chains, steps)]
            if nd:
                self.trajectories.append(buf(num_chains, steps, nd))

        # the graphs' bodies: the kernels' pieces on these buffers (``kern``
        # is read while capturing only; the graphs read none of its
        # tensors)
        def propose(k):
            dz, _, u_fast = self.draws[k]
            self.prop[0].copy_(kern._propose(
                self.state[0], dz, u_fast, self.tally[7], self.cov,
                self.fast_mask))

        def screen(k):
            _fill(self.carry, kern._screen(
                self.state, self.carry if k else None, *self.prop,
                self.draws[k][1], self.prior_fn))

        def update():
            prop = self.carry if constrained else self.prop + [None]
            x_old = self.state[1]
            state, accept, x_new, n_evals = kern._settle(
                self.state, prop, sanitize_log_density(self.logl_prop),
                self.derived_prop, self.draws[-1][1], self.loglstar, None,
                self.prior_fn)
            tally = kern._tally(
                self.tally, accept, n_evals, self.draws[-1][2], x_new, x_old,
                _Rows(None, num_chains, device),
                collect_chains=collect_chains,
                dynamic_step_size=dynamic_step_size)
            self._write_step(state)
            _fill(self.state, state)
            _fill(self.tally, tally)
            self.index.add_(1)

        bodies = [functools.partial(propose, k) for k in range(n_draws)]
        if constrained:
            bodies += [functools.partial(screen, k) for k in range(n_draws)]
        graphs = self._capture(bodies + [update])
        self.graph_p = graphs[:n_draws]
        self.graph_m = graphs[n_draws:-1]
        self.graph_u = graphs[-1]

    def _write_step(self, state):
        """The state's entries of the trajectories at the step index."""
        parts = [state[1]]
        if self.collect_chains:
            parts += [state[0], state[3], state[5]]
        for traj, part in zip(self.trajectories, parts):
            traj.index_copy_(1, self.index, part.unsqueeze(1))

    def _capture(self, bodies):
        """One CUDA graph of each of ``bodies``, in one memory pool, after
        three warm-up rounds on a side stream (the warm-up a capture
        needs; it writes only these buffers, which every generation
        fills before its first step)."""
        with torch.cuda.device(self.index.device):
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                for _ in range(3):
                    self.index.zero_()
                    for body in bodies:
                        body()
            torch.cuda.current_stream().wait_stream(side)
            pool = torch.cuda.graph_pool_handle()
            graphs = []
            for body in bodies:
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph, pool=pool,
                                      capture_error_mode='thread_local'):
                    body()
                graphs.append(graph)
                count('mcmc_graph', 1, key='captures')
        return graphs

    # a generation

    def start(self, state, step_size, cov_chol, loglstar):
        """Fill the buffers for a generation from ``state`` (the starts),
        the step size, the covariance factor (None without one) and the
        likelihood bound (None in full MH)."""
        _fill(self.state, state)
        for t in self.tally[:7]:
            t.zero_()
        self.tally[7].fill_(step_size)
        if cov_chol is not None:
            self.cov.copy_(cov_chol)
        if loglstar is not None:
            self.loglstar.copy_(loglstar)
        self.index.zero_()
        self._write_step(self.state)
        self.index.fill_(1)

    def step(self, generator, draws, inverse, like):
        """One step: its numbers drawn from ``generator`` (or copied from
        ``draws``, one (dz, u, u_fast) triple a proposal), the replays and
        the eager calls of ``inverse`` and ``like`` (the kernels'
        likelihood before sanitizing, which the update graph does)."""
        if draws is None:
            for dz, u, u_fast in self.draws:
                torch.randn(dz.shape, generator=generator, out=dz)
                torch.rand(u.shape, generator=generator, out=u)
                if u_fast is not None:
                    torch.rand((), generator=generator, out=u_fast)
        else:
            for bufs, given in zip(self.draws, draws):
                _fill(bufs, given)
        for k, graph in enumerate(self.graph_p):
            graph.replay()
            _fill(self.prop[1:], inverse(self.prop[0]))
            if self.constrained:
                self.graph_m[k].replay()
        logl, derived = like(
            (self.carry if self.constrained else self.prop)[1])
        self.logl_prop.copy_(logl)
        if derived is not None:
            self.derived_prop.copy_(derived)
        self.graph_u.replay()

    def result(self):
        """The generation's final state, tally and trajectories, as copies
        (the buffers are the next generation's)."""
        def copy(ts):
            return [None if t is None else t.clone() for t in ts]
        return (tuple(copy(self.state)), tuple(copy(self.tally)),
                copy(self.trajectories))


def _real(mask, real):
    """``mask`` on the rows that count (``real`` None: all of them)."""
    return mask if real is None else mask & real


def _count(mask, real):
    """The rows of ``mask`` that count, as a 0-dim int64 tensor."""
    return torch.sum(_real(mask, real).to(torch.int64))


class _Rows:
    """This rank's share of an ``n``-chain batch under ``mesh``
    (:mod:`nnest_torch.parallel.mesh`): the rows of the batch padded to a
    multiple of dp by repeating row 0, ``real`` the mask of the rows that
    are not pad (None when there is no pad). Without a mesh every method
    is the identity, so the unsharded kernels run exactly as written."""

    def __init__(self, mesh, n, device):
        self.mesh, self.n, self.real = mesh, n, None
        if mesh is not None:
            self.rows, self.pad = batch_sharding(mesh, n)
            if self.pad:
                self.real = real_rows(mesh, n, device)

    def local(self, x):
        """This rank's rows of a whole-batch tensor (None passes)."""
        if self.mesh is None or x is None:
            return x
        return pad_rows(x, self.pad)[self.rows]

    def total(self, x):
        """``x`` summed over the ranks."""
        return x if self.mesh is None else all_reduce_sum(x, self.mesh)

    def totals(self, *xs):
        """0-dim counters summed over the ranks in one collective (float64
        carries the integer counts exactly)."""
        if self.mesh is None:
            return xs
        flat = all_reduce_sum(torch.stack([x.to(torch.float64) for x in xs]),
                              self.mesh)
        return tuple(f.to(x.dtype) for f, x in zip(flat, xs))

    def all_true(self, mask):
        """Whether ``mask`` holds on every real row of every rank."""
        if self.mesh is None:
            return bool(mask.all())
        return int(self.total(_count(~mask, self.real))) == 0

    def gather(self, xs):
        """Whole-batch tensors from this rank's rows of each of ``xs``
        (float32 or bool, rows first), in one collective; the pad
        dropped."""
        if self.mesh is None:
            return xs
        return gather_columns(xs, self.mesh, self.n)


# The ensemble's moves: each maps (the moving walkers, the other half, the
# step's partner rows, stretch uniforms, normals, a) to (proposal, log of
# the MH factor), the proposal algorithms emcee implements.

def _stretch_move(z, other, idx, zeta_u, normal, a):
    """Goodman & Weare: z' = p + zeta (z - p), g(zeta) ~ 1/sqrt(zeta) on
    [1/a, a], factor zeta^(dim - 1)."""
    zeta = ((a - 1.0) * zeta_u + 1.0) ** 2 / a
    partner = other[idx[0]]
    return (partner + zeta[:, None] * (z - partner),
            (z.shape[1] - 1.0) * torch.log(zeta))


def _de_move(z, other, idx, zeta_u, normal, a):
    """Differential evolution: z' = z + g0 (p1 - p2) + 1e-5 n, g0 =
    2.38 / sqrt(2 dim); symmetric."""
    g0 = 2.38 / math.sqrt(2.0 * z.shape[1])
    return (z + g0 * (other[idx[0]] - other[idx[1]]) + 1e-5 * normal,
            torch.zeros_like(zeta_u))


def _snooker_move(z, other, idx, zeta_u, normal, a):
    """DE-snooker (ter Braak & Vrugt 2008): along u = (z - p1)/|z - p1|,
    z' = z + 1.7 ((p2 - p3) . u) u, factor (|z' - p1| / |z - p1|)^(dim-1)."""
    p1, p2, p3 = other[idx[0]], other[idx[1]], other[idx[2]]
    d_vec = z - p1
    norm = torch.clamp(torch.linalg.norm(d_vec, dim=1, keepdim=True),
                       min=1e-12)
    d_hat = d_vec / norm
    proj = torch.sum((p2 - p3) * d_hat, dim=1, keepdim=True)
    prop = z + 1.7 * proj * d_hat
    norm_new = torch.clamp(torch.linalg.norm(prop - p1, dim=1), min=1e-12)
    return prop, (z.shape[1] - 1.0) * (torch.log(norm_new)
                                       - torch.log(norm[:, 0]))


def _kde_logq(pts, other, h):
    """Log density at ``pts`` of the Gaussian KDE of ``other`` with the
    diagonal bandwidth ``h``: pairwise |p|^2 + |o|^2 - 2 p.o (scaled by
    h), clamped at 0, then logsumexp."""
    m, dim = other.shape
    ph, oh = pts / h, other / h
    d2 = (torch.sum(ph ** 2, dim=1)[:, None] + torch.sum(oh ** 2, dim=1)[None]
          - 2.0 * (ph @ oh.T))
    return (torch.logsumexp(-0.5 * torch.clamp(d2, min=0.0), dim=1)
            - math.log(m) - torch.sum(torch.log(h))
            - 0.5 * dim * math.log(2.0 * math.pi))


def _kde_move(z, other, idx, zeta_u, normal, a):
    """Independence proposal from the other half's KDE (Scott's-rule
    diagonal bandwidth): z' = p + h n, factor q(z) / q(z')."""
    m, dim = other.shape
    h = ((torch.std(other, dim=0, unbiased=False) + 1e-6)
         * m ** (-1.0 / (dim + 4)))
    prop = other[idx[0]] + h * normal
    return prop, _kde_logq(z, other, h) - _kde_logq(prop, other, h)


_MOVES = {'stretch': _stretch_move, 'de': _de_move,
          'snooker': _snooker_move, 'kde': _kde_move}
