"""Latent-space sampling kernels on the sampler's device.

Port of the single-device part of ``nnest_tpu/samplers/kernels.py``:
constrained (nested) and full Metropolis-Hastings latent MCMC with the
covariance-preconditioned proposal, dynamic step size and the fast-slow
proposal mask, constrained latent slice sampling (stepping-out and
shrinkage to acceptance, with covariance-adapted directions), the
red-black chain starts drawn from the live set, batched prior rejection,
flow rejection inside the Jacobian envelope (in the latent ball, or in the
base's box where it has ``usample``), flow-density draws, and the
on-device chain diagnostics (ESS, start decorrelation, second moments).

The JAX ``lax.scan`` becomes a Python loop over steps with the chains as
the batch dimension; accept/reject stay masks (``torch.where``) and every
counter stays a device tensor, so a Metropolis step never waits on the
host (a slice step reads one flag a shrinkage iteration to stop the loop).
Random numbers come from the caller's ``torch.Generator``; the slice and
flow-rejection kernels draw them in one function and take them as tensors
in a deterministic body. Every flow inverse inside a step, and the one
inverse of all trials of a flow-rejection or flow-density generation, goes
through :meth:`LatentKernels._hot_inverse`, which for a single-speed
spline flow on the GPU is the hand-written CUDA kernel
(``ops/spline_inverse.py``).
"""

from __future__ import annotations

import torch

from nnest_torch.ops import fused_spline
from nnest_torch.ops.spline_inverse import spline_inverse

# Finite sentinel for impossible log-densities (keeps ±inf/NaN out of the
# chain arithmetic; < -1e30 so the `> -1e30` validity checks keep working).
LOG_NEG = -1e31


def sanitize_log_density(lp):
    """Map NaN/±inf/very-negative log-densities to the finite LOG_NEG."""
    lp = torch.where(torch.isfinite(lp), lp, torch.full_like(lp, LOG_NEG))
    return torch.clamp(lp, min=LOG_NEG)


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
                          torch.tensor(t - 1, device=chains.device))
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

    ``like_fn`` and ``prior_fn`` map a (batch, dim) float32 tensor to a
    (batch,) log density on the same device; both are sanitized here.
    ``num_slow`` and ``oversample_rate`` enable the fast-slow Metropolis
    proposal: with probability ``oversample_rate`` a proposal moves the
    fast latent dims [num_slow:] only.
    """

    def __init__(self, model, like_fn, prior_fn, num_slow=0,
                 oversample_rate=1.0):
        if not callable(getattr(model, 'inverse', None)):
            raise ValueError('LatentKernels needs a flow model with an '
                             'inverse (build_flow); got %s'
                             % type(model).__name__)
        self.model = model
        self.like_fn = lambda u: sanitize_log_density(like_fn(u))
        self.prior_fn = lambda u: sanitize_log_density(prior_fn(u))
        self.num_slow = int(num_slow)
        self.oversample_rate = float(oversample_rate)
        self._fusable = fused_spline.is_fusable_spline(model)
        # 1 on the fast dims, 0 on the slow ones: dz times this freezes
        # the slow block for a fast-only move.
        self._fast_mask = torch.ones(
            model.dim, device=next(model.parameters()).device)
        self._fast_mask[:self.num_slow] = 0.0

    def _hot_inverse(self):
        """Flow inverse for use inside chain steps. For a single-speed
        spline flow the parameter-only work (1x1-conv inverses, constant
        logdet) is packed once per kernel invocation, and each call runs
        the whole-chain inverse kernel; every other flow (NVP, Cholesky,
        fast-slow) takes its own ``inverse`` in plain PyTorch, as in the
        JAX package, where no Pallas kernel covers them."""
        if not self._fusable:
            return self.model.inverse
        packed = fused_spline.pack_inverse_consts(self.model)
        return lambda z: spline_inverse(z, packed)

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

    def step(self, state, inverse, draws, *, loglstar, scale, cov_chol):
        """One Metropolis step (constrained when ``loglstar`` is not None).

        ``state`` is (z, x, ldj, logl, logl_prior); ``draws`` yields one
        (dz, u, u_fast) triple per proposal (``prior_volume_steps`` of
        them in constrained mode): standard normals, accept uniforms and
        the 0-dim fast-move uniform (None for a single-speed flow).
        Returns the new state, the accept mask, the proposal's x and the
        likelihood-call count."""
        z, x, ldj, logl, logl_prior = state

        def propose(dz, u_fast):
            if cov_chol is not None:
                dz = dz @ cov_chol.T
            dz = dz * scale
            if u_fast is not None:
                dz = torch.where(u_fast < self.oversample_rate,
                                 dz * self._fast_mask, dz)
            return z + dz

        if loglstar is not None:
            # Find a move passing prior+Jacobian among the proposals, then
            # one likelihood check against the hard constraint.
            z_pr, x_pr, ldj_pr = z, x, ldj
            mask1 = torch.zeros(z.shape[0], dtype=torch.bool, device=z.device)
            for dz, u, u_fast in draws:
                z_prop = propose(dz, u_fast)
                x_prop, ldj_prop = inverse(z_prop)
                m = (_accept_mask(u, ldj_prop - ldj)
                     & (self.prior_fn(x_prop) > -1e30))
                mcol = m[:, None]
                z_pr = torch.where(mcol, z_prop, z_pr)
                x_pr = torch.where(mcol, x_prop, x_pr)
                ldj_pr = torch.where(m, ldj_prop, ldj_pr)
                mask1 = mask1 | m
            logl_prop = self.like_fn(x_pr)
            lp_prior_new = self.prior_fn(x_pr)
            n_evals = torch.sum(mask1.to(torch.int64))
            accept = mask1 & torch.isfinite(logl_prop) & (logl_prop > loglstar)
            z_new, x_new, ldj_new = z_pr, x_pr, ldj_pr
        else:
            (dz, u, u_fast), = draws
            z_new = propose(dz, u_fast)
            x_new, ldj_new = inverse(z_new)
            logl_prop = self.like_fn(x_new)
            lp_prior_new = self.prior_fn(x_new)
            log_ratio = ((ldj_new - ldj) + (logl_prop - logl)
                         + (lp_prior_new - logl_prior))
            accept = _accept_mask(u, log_ratio)
            n_evals = torch.tensor(z.shape[0], device=z.device)

        acol = accept[:, None]
        new_state = (torch.where(acol, z_new, z), torch.where(acol, x_new, x),
                     torch.where(accept, ldj_new, ldj),
                     torch.where(accept, logl_prop, logl),
                     torch.where(accept, lp_prior_new, logl_prior))
        return new_state, accept, x_new, n_evals

    @torch.no_grad()
    def mcmc(self, generator, z0, logl0, logl_prior0, *, loglstar=None,
             step_size, mcmc_steps, dynamic_step_size=False,
             prior_volume_steps=1, stat_moments=None, cov_from=None,
             cov_mask=None):
        """Multi-chain latent Metropolis, endpoint mode: returns each
        chain's final state, a per-chain ``moved`` flag and statistics over
        all chains and steps (ESS, acceptance, mean jump, start
        decorrelation). Constrained (nested) mode when ``loglstar`` is
        given: accept on the prior+Jacobian ratio, then require
        logl > loglstar. ``cov_from``/``cov_mask`` enable the proposal
        dz ~ N(0, scale^2 C) with C from the masked live rows."""
        constrained = loglstar is not None
        device = z0.device
        num_chains, dim = z0.shape
        ll_star = (None if not constrained else
                   torch.tensor(loglstar, dtype=torch.float32, device=device))
        inverse = self._hot_inverse()
        cov_chol = self._cov_factor(cov_from, cov_mask)
        x0, ldj0 = inverse(z0)
        state = (z0, x0, ldj0, sanitize_log_density(logl0),
                 sanitize_log_density(logl_prior0))
        scale = torch.tensor(step_size, dtype=torch.float32, device=device)
        acc_ctr = torch.zeros((), device=device)
        rej_ctr = torch.zeros((), device=device)
        ncall = torch.zeros((), dtype=torch.int64, device=device)
        fast_calls = torch.zeros((), dtype=torch.int64, device=device)
        total_acc = torch.zeros((), dtype=torch.int64, device=device)
        moved = torch.zeros(num_chains, dtype=torch.bool, device=device)
        jump = torch.zeros((), device=device)
        xs = [x0]
        n_draws = prior_volume_steps if constrained else 1
        for _ in range(mcmc_steps):
            draws = [(torch.randn(num_chains, dim, generator=generator,
                                  device=device),
                      torch.rand(num_chains, generator=generator,
                                 device=device),
                      torch.rand((), generator=generator, device=device)
                      if self.num_slow > 0 else None)
                     for _ in range(n_draws)]
            x_old = state[1]
            state, accept, x_new, n_evals = self.step(
                state, inverse, draws, loglstar=ll_star, scale=scale,
                cov_chol=cov_chol)
            ncall = ncall + n_evals
            if self.num_slow > 0:
                # the calls of a step whose (last) proposal moved the fast
                # dims only
                fast_calls = fast_calls + torch.where(
                    draws[-1][2] < self.oversample_rate, n_evals,
                    torch.zeros_like(n_evals))
            n_acc = torch.sum(accept.to(torch.int64))
            total_acc = total_acc + n_acc
            moved = moved | accept
            jump = jump + torch.sum(torch.where(
                accept, torch.linalg.norm(x_new - x_old, dim=-1),
                torch.zeros_like(jump)))
            xs.append(state[1])
            if dynamic_step_size:
                # adapt toward 50% acceptance
                win = 2 * n_acc > num_chains
                acc_ctr = acc_ctr + win.to(acc_ctr.dtype)
                rej_ctr = rej_ctr + (~win).to(rej_ctr.dtype)
                scale = torch.where(acc_ctr > rej_ctr,
                                    scale * torch.exp(1.0 / (1.0 + acc_ctr)),
                                    scale)
                scale = torch.where(acc_ctr < rej_ctr,
                                    scale / torch.exp(1.0 / (1.0 + rej_ctr)),
                                    scale)

        z_end, x_end, _, logl_end, _ = state
        chains = torch.stack(xs, dim=1)
        if stat_moments is None:
            mu = torch.mean(chains, dim=(0, 1))
            var = torch.var(chains, dim=(0, 1), unbiased=False)
        else:
            mu, var = stat_moments
        mix_cov, mix_msd = mix_moments_device(z_end, z0)
        return {
            'final_x': x_end, 'final_z': z_end, 'final_logl': logl_end,
            'moved': moved, 'scale': scale, 'ncall': ncall,
            'fast_calls': fast_calls,
            'mean_jump': jump / torch.clamp(total_acc, min=1),
            'mix_ratio': mix_ratio_device(z_end, z0),
            'mix_cov': mix_cov, 'mix_msd': mix_msd,
            'ess': ess_device(chains, mu, var),
            'acceptance': total_acc / float(mcmc_steps * num_chains),
            'accepted': total_acc,
            'rejected': mcmc_steps * num_chains - total_acc,
        }

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
        mask_a[idx_a] = True
        return idx_a, ~mask_a

    @torch.no_grad()
    def _live_starts(self, idx, active_u, active_logl):
        """Chain starts at live rows ``idx``: (z0, logl0, logl_prior0, mu,
        var), with the numerical re-projection x -> z -> x."""
        x0 = active_u[idx]
        logl0 = active_logl[idx]
        z0, _ = self.model(x0)
        x0p, _ = self.model.inverse(z0)
        lp_prior0 = self.prior_fn(x0p)
        mu = torch.mean(active_u, dim=0)
        var = torch.var(active_u, dim=0, unbiased=False)
        return z0, logl0, lp_prior0, mu, var

    def _chain_starts(self, generator, active_u, active_logl, num_chains,
                      adapt_cov):
        """Uniform chain starts drawn from the live set, from a random half
        when ``adapt_cov`` (the complement mask is returned for the
        covariance): (z0, logl0, logl_prior0, mu, var, cov_mask)."""
        n_live = active_u.shape[0]
        cov_mask = None
        if adapt_cov:
            idx_a, cov_mask = self._red_black_split(generator, n_live)
            idx = idx_a[torch.randint(0, n_live // 2, (num_chains,),
                                      generator=generator,
                                      device=generator.device)]
        else:
            idx = torch.randint(0, n_live, (num_chains,),
                                generator=generator, device=generator.device)
        return self._live_starts(idx, active_u, active_logl) + (cov_mask,)

    def mcmc_from_live(self, generator, active_u, active_logl, *,
                       num_chains, loglstar, step_size, mcmc_steps,
                       dynamic_step_size=False, prior_volume_steps=1,
                       adapt_cov=False):
        """Constrained endpoint-mode Metropolis started from the live set:
        uniform chain starts (from a random half when ``adapt_cov``, whose
        complement gives the proposal covariance), re-projection, chains."""
        z0, logl0, lp_prior0, mu, var, cov_mask = self._chain_starts(
            generator, active_u, active_logl, num_chains, adapt_cov)
        return self.mcmc(
            generator, z0, logl0, lp_prior0, loglstar=loglstar,
            step_size=step_size, mcmc_steps=mcmc_steps,
            dynamic_step_size=dynamic_step_size,
            prior_volume_steps=prior_volume_steps, stat_moments=(mu, var),
            cov_from=active_u if adapt_cov else None, cov_mask=cov_mask)

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
                   stat_moments=None, cov_from=None, cov_mask=None):
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
        ``width``; ``fast_calls`` is 0)."""
        inverse = self._hot_inverse()
        device = z0.device
        num_chains = z0.shape[0]
        slice_steps = draws['d'].shape[0]
        hard_cap = draws['shrink'].shape[1]
        ll_star = _f32(loglstar, z0)
        width = _f32(width, z0)
        cov_chol = self._cov_factor(cov_from, cov_mask)
        x0, ldj0 = inverse(z0)
        z, x, ldj, logl = z0, x0, ldj0, sanitize_log_density(logl0)
        zeros_b = torch.zeros(num_chains, dtype=torch.bool, device=device)
        ncall = torch.zeros((), dtype=torch.int64, device=device)
        total_acc = torch.zeros((), dtype=torch.int64, device=device)
        moved = zeros_b
        jump = torch.zeros((), device=device)
        xs = [x0]

        def count(mask):
            return torch.sum(mask.to(torch.int64))

        for s in range(slice_steps):
            d = draws['d'][s]
            d = d / torch.clamp(torch.linalg.norm(d, dim=-1, keepdim=True),
                                min=1e-12)
            if cov_chol is not None:
                d = d @ cov_chol.T
            logy = ldj + torch.log1p(-draws['h'][s])
            left = -width * draws['v'][s]
            right = left + width
            jmax = draws['jmax'][s]
            kmax = (max_expand - 1) - jmax
            done_l = done_r = zeros_b
            logy2 = torch.cat([logy, logy])
            for i in range(max_expand):
                geom, full, _, _, _ = self._in_slice(
                    inverse, torch.cat([z + left[:, None] * d,
                                        z + right[:, None] * d]),
                    logy2, ll_star)
                act_l = ~done_l & (i < jmax)
                act_r = ~done_r & (i < kmax)
                ncall = ncall + count(act_l & geom[:num_chains]) \
                    + count(act_r & geom[num_chains:])
                in_l, in_r = full[:num_chains], full[num_chains:]
                left = torch.where(act_l & in_l, left - width, left)
                right = torch.where(act_r & in_r, right + width, right)
                done_l = done_l | (act_l & ~in_l)
                done_r = done_r | (act_r & ~in_r)

            acc = zeros_b
            z_n, x_n, ldj_n, logl_n = z, x, ldj, logl
            for i in range(hard_cap):
                t = left + (right - left) * draws['shrink'][s, i]
                zc = z + t[:, None] * d
                geom, ok, xc, ldjc, loglc = self._in_slice(
                    inverse, zc, logy, ll_star)
                act = ~acc
                ncall = ncall + count(act & geom)
                take = act & ok
                tcol = take[:, None]
                z_n = torch.where(tcol, zc, z_n)
                x_n = torch.where(tcol, xc, x_n)
                ldj_n = torch.where(take, ldjc, ldj_n)
                logl_n = torch.where(take, loglc, logl_n)
                acc = acc | take
                shr = act & ~ok
                left = torch.where(shr & (t < 0), t, left)
                right = torch.where(shr & (t >= 0), t, right)
                if bool(acc.all()):
                    break

            total_acc = total_acc + count(acc)
            moved = moved | acc
            jump = jump + torch.sum(torch.where(
                acc, torch.linalg.norm(x_n - x, dim=-1),
                torch.zeros_like(ldj)))
            z, x, ldj, logl = z_n, x_n, ldj_n, logl_n
            xs.append(x)

        chains = torch.stack(xs, dim=1)
        if stat_moments is None:
            mu = torch.mean(chains, dim=(0, 1))
            var = torch.var(chains, dim=(0, 1), unbiased=False)
        else:
            mu, var = stat_moments
        mix_cov, mix_msd = mix_moments_device(z, z0)
        return {
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
        (geom, full, x, ldj, logl), where geom is the prior box and the
        height test ``ldj >= logy`` (no likelihood call needed) and full
        adds the hard constraint logl > loglstar. ``>=``, not ``>``: a
        bracket collapsed onto the current point must accept it, even
        where log1p(-h) vanishes against a large |ldj| in float32."""
        xc, ldjc = inverse(zc)
        geom = (self.prior_fn(xc) > -1e30) & (ldjc >= logy)
        loglc = self.like_fn(xc)
        return geom, geom & (loglc > loglstar), xc, ldjc, loglc

    def slice_from_live(self, generator, active_u, active_logl, *,
                        num_chains, loglstar, width, slice_steps,
                        max_expand=4, max_shrink=10, adapt_cov=False):
        """One slice pool generation started from the live set: the chain
        starts and red-black split of :meth:`mcmc_from_live`, then
        :meth:`slice_draws` and :meth:`slice_body` (cov directions from
        the complement half when ``adapt_cov``)."""
        z0, logl0, _, mu, var, cov_mask = self._chain_starts(
            generator, active_u, active_logl, num_chains, adapt_cov)
        draws = self.slice_draws(generator, slice_steps, num_chains,
                                 self.model.dim, max_expand, max_shrink)
        return self.slice_body(
            draws, z0, logl0, loglstar=loglstar, width=width,
            max_expand=max_expand, stat_moments=(mu, var),
            cov_from=active_u if adapt_cov else None, cov_mask=cov_mask)

    # -------------------------------------------------------- rejection

    @torch.no_grad()
    def rejection_prior(self, prior, generator, loglstar, num_trials):
        """Batched rejection from the prior: ``num_trials`` prior draws,
        all evaluated; returns (x, logl, ok)."""
        x = prior.sample_torch(num_trials, generator)
        logl = self.like_fn(x)
        ok = torch.isfinite(logl) & (logl > torch.tensor(
            loglstar, dtype=torch.float32, device=x.device))
        return x, logl, ok

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
        prior box and logl > loglstar. Returns (x, logl, ok, n_evals);
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
        logl = self.like_fn(x)
        ok = evaluated & torch.isfinite(logl) & (logl > _f32(loglstar, x))
        return x, logl, ok, torch.sum(evaluated.to(torch.int64))

    def rejection_flow_live(self, generator, loglstar, live_u, prev_mld,
                            prev_mr, fold, enlargement_factor, num_trials):
        """The envelope from the live set, max-folded into the carried
        maxima when ``fold`` (else it replaces them), then one
        flow-rejection generation in the ball enlarged by
        ``enlargement_factor``. Returns (x, logl, ok, n_evals,
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
        with logl > loglstar. Returns (x, logl, ok, n_evals); ``n_evals``
        counts the draws inside the prior box."""
        x, _ = self._hot_inverse()(z)
        ok_prior = self.prior_fn(x) > -1e30
        logl = self.like_fn(x)
        ok = ok_prior & torch.isfinite(logl) & (logl > _f32(loglstar, x))
        return x, logl, ok, torch.sum(ok_prior.to(torch.int64))

    def density(self, generator, loglstar, num_trials):
        """One flow-density generation: ``num_trials`` draws from the
        flow's base distribution; returns (x, logl, ok, n_evals)."""
        return self.density_body(
            self.model.base_dist.sample(num_trials, generator), loglstar)


def _f32(value, like):
    """``value`` as a float32 tensor on ``like``'s device."""
    return torch.as_tensor(value, dtype=torch.float32, device=like.device)
