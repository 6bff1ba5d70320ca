"""Chain and run diagnostics, in host numpy (float64).

The port's own copy of the diagnostic functions of
``nnest_tpu/utils/evaluation.py`` (the port imports nothing from the JAX
package):

- the chain diagnostics of the MCMC and ensemble samplers, on chains shaped
  (num_chains, num_steps, dim): :func:`auto_correlation_time`,
  :func:`effective_sample_size`, :func:`acceptance_rate`,
  :func:`mean_jump_distance`, :func:`gelman_rubin_diagnostic` and
  :func:`integrated_autocorr_time` (the bootstrap's thinning). As in
  ``nnest_tpu``, the ESS, the acceptance and the jump run in the native
  runtime (:mod:`nnest_torch.runtime`) first; their numpy twins
  (:func:`effective_sample_size_numpy`, :func:`acceptance_rate_numpy`,
  :func:`mean_jump_distance_numpy`) serve a machine without ``g++``;
- the insertion-index uniformity test (Fowlie, Handley & Su 2020,
  arXiv:2006.03371): :func:`kolmogorov_pvalue`, :func:`insertion_ks`,
  :func:`rolling_insertion_ks`;
- the thread-bootstrap logZ error (Higson et al. 2019,
  arXiv:1804.06406): :func:`bootstrap_logz_error`;
- the calibrated single-run error bar: the healthy-run nulls
  :func:`metropolis_mix_null` and :func:`latent_cond_null`,
  :func:`eig_mix_from_moments` (the eigenbasis mixing ratio and latent
  condition number of one MCMC generation), :func:`slice_mix_null` and
  :func:`adjusted_logzerr`;
- the (birth, death) representation of nested runs (Higson et al. 2019,
  arXiv:1704.03459), which merges runs and carries dynamic batches:
  :func:`thread_birth_logl`, :func:`merged_run_evidence`,
  :func:`load_threads_npz` and :func:`merge_runs`.
"""

from __future__ import annotations

import numpy as np

from nnest_torch import runtime as _native


def auto_correlation_time(x, s, mu, var):
    """Lag-s autocorrelation per dim, averaged over chains and steps."""
    x = np.asarray(x)
    y = x - mu
    p, n = y[:, :-s, :], y[:, s:, :]
    return np.mean(p * n, axis=(0, 1)) / var


def effective_sample_size(x, mu, var):
    """Truncated-autocorrelation ESS per dim (per chain): accumulate
    2 rho_s (1 - s/t) over the dims with rho_s > 0.05 while any has it,
    then ESS = t / (1 + sum)."""
    native = _native.ess(x, mu, var)
    return native if native is not None else effective_sample_size_numpy(
        x, mu, var)


def effective_sample_size_numpy(x, mu, var):
    """:func:`effective_sample_size` in numpy."""
    x = np.asarray(x)
    _, t, d = x.shape
    ess = np.ones(d)
    for s in range(1, t):
        p = auto_correlation_time(x, s, mu, var)
        active = p > 0.05
        if not np.any(active):
            break
        ess[active] += 2.0 * p[active] * (1.0 - float(s) / t)
    return t / ess


def acceptance_rate(x):
    """Fraction of steps in which a chain moved."""
    native = _native.acceptance_rate(x)
    return native if native is not None else acceptance_rate_numpy(x)


def acceptance_rate_numpy(x):
    """:func:`acceptance_rate` in numpy."""
    x = np.asarray(x)
    moved = np.any(x[:, 1:, :] != x[:, :-1, :], axis=-1)
    return float(np.mean(moved))


def mean_jump_distance(x):
    """Mean Euclidean length of a step, moves and stays alike."""
    native = _native.mean_jump(x)
    return native if native is not None else mean_jump_distance_numpy(x)


def mean_jump_distance_numpy(x):
    """:func:`mean_jump_distance` in numpy."""
    x = np.asarray(x)
    jumps = np.linalg.norm(x[:, 1:, :] - x[:, :-1, :], axis=-1)
    return float(np.mean(jumps))


def gelman_rubin_diagnostic(x, mu=None):
    """Gelman-Rubin R-hat per dim (with the reference's 1e-5
    regularizer in the within-chain term)."""
    x = np.asarray(x)
    m, n = x.shape[0], x.shape[1]
    theta = np.mean(x, axis=1)
    sigma = np.var(x, axis=1)
    theta_m = mu if mu is not None else np.mean(theta, axis=0)
    b = float(n) / float(m - 1) * np.sum((theta - theta_m) ** 2, axis=0)
    w = 1.0 / (float(m) * np.sum(sigma, axis=0) + 1e-5)
    v = float(n - 1) / float(n) * w + float(m + 1) / float(m * n) * b
    return np.sqrt(v / w)


def integrated_autocorr_time(x, c: float = 5.0):
    """Integrated autocorrelation time per dim, emcee's estimator: the
    chain-averaged normalised autocorrelation from one FFT a chain, then
    Sokal's window (the first lag M with M >= c tau(M)); at least 1."""
    x = np.asarray(x, dtype=np.float64)
    m, t, d = x.shape
    taus = np.empty(d)
    for j in range(d):
        f = np.zeros(t)
        for i in range(m):
            y = x[i, :, j] - np.mean(x[i, :, j])
            n = 1 << (2 * t - 1).bit_length()
            fy = np.fft.fft(y, n=n)
            acf = np.fft.ifft(fy * np.conjugate(fy))[:t].real
            if acf[0] > 0:
                f += acf / acf[0]
        f /= m
        taus_cum = 2.0 * np.cumsum(f) - 1.0
        window = np.arange(len(taus_cum)) >= c * taus_cum
        idx = np.argmax(window) if np.any(window) else len(taus_cum) - 1
        taus[j] = max(taus_cum[idx], 1.0)
    return taus


def kolmogorov_pvalue(d, n):
    """Asymptotic two-sided Kolmogorov-Smirnov p-value for statistic ``d``
    over ``n`` samples, with Stephens' small-sample correction."""
    n = int(n)
    if n <= 0 or d <= 0.0:
        return 1.0
    lam = (np.sqrt(n) + 0.12 + 0.11 / np.sqrt(n)) * float(d)
    k = np.arange(1, 101)
    p = 2.0 * np.sum((-1.0) ** (k - 1) * np.exp(-2.0 * (k * lam) ** 2))
    return float(min(max(p, 0.0), 1.0))


def insertion_ks(ranks, n_live):
    """Insertion-index uniformity test. Under exact constrained sampling
    the rank of each replacement among the surviving ``n_live - 1`` live
    points is Uniform{0, ..., n_live-1}; under-mixed proposals skew it.

    Returns ``(D, p)``: the KS distance of ``(ranks + 0.5) / n_live``
    from U[0,1] and its asymptotic p-value."""
    r = np.asarray(ranks, dtype=np.float64)
    n = r.size
    if n == 0:
        return 0.0, 1.0
    u = np.sort((r + 0.5) / float(n_live))
    i = np.arange(1, n + 1)
    d = float(np.max(np.maximum(i / n - u, u - (i - 1) / n)))
    return d, kolmogorov_pvalue(d, n)


def rolling_insertion_ks(ranks, n_live, block=None):
    """The insertion test on each consecutive block of ``block`` ranks
    (default ``n_live``), the smallest p Bonferroni-corrected: it catches
    a failure confined to one likelihood regime that the whole-run test
    averages away. Returns ``(min_corrected_p, n_blocks)``."""
    r = np.asarray(ranks, dtype=np.float64)
    if block is None:
        block = int(n_live)
    block = max(int(block), 1)
    n_blocks = max(r.size // block, 1)
    pmin = 1.0
    for b in range(n_blocks):
        chunk = r[b * block:(b + 1) * block] if b < n_blocks - 1 \
            else r[(n_blocks - 1) * block:]
        _, p = insertion_ks(chunk, n_live)
        pmin = min(pmin, p)
    return float(min(pmin * n_blocks, 1.0)), n_blocks


def bootstrap_logz_error(saved_logl, slots, n_live, n_boot=200, seed=0):
    """Single-run thread-bootstrap logZ error. A run with in-place
    replacement decomposes into ``n_live`` single-live-point threads (the
    live-set slots in ``slots``); resampling whole threads with
    replacement and re-running the constant-N evidence sum estimates the
    run's sampling error. ``saved_logl``/``slots`` cover the whole run,
    the final live points included. Deterministic (fixed ``seed``, its
    own numpy generator). Returns the std of logZ over ``n_boot``
    replicates."""
    saved_logl = np.asarray(saved_logl, dtype=np.float64)
    slots = np.asarray(slots)
    groups = [saved_logl[slots == k] for k in range(n_live)]
    rng = np.random.RandomState(seed)
    shell = np.log1p(-np.exp(-1.0 / n_live))
    zs = np.empty(n_boot)
    for b in range(n_boot):
        pick = rng.randint(0, n_live, size=n_live)
        logls = np.concatenate([groups[k] for k in pick])
        logls.sort()
        # ascending-logl deaths: the i-th death leaves log-volume -i/N
        logwt = logls + shell - np.arange(logls.size) / n_live
        m = logwt.max()
        zs[b] = m + np.log(np.sum(np.exp(logwt - m)))
    return float(np.std(zs))


def metropolis_mix_null(steps, dim, adapt_cov=False):
    """Expected healthy eigenbasis mixing ratio of the constrained
    Metropolis kernel at this step budget: 0.31 steps / dim^1.35 for the
    covariance-preconditioned proposal, 1.4 steps / dim^2 for the
    isotropic one, never below its value at the default 5*dim steps
    (a starved kernel must lower the ratio, not relax the bar)."""
    if adapt_cov:
        return min(1.0, 0.31 * max(steps, 5 * dim) / float(dim) ** 1.35)
    return min(1.0, 1.4 * max(steps, 5 * dim) / float(dim) ** 2)


def slice_mix_null(steps, dim):
    """Expected healthy eigenbasis mixing ratio of the latent slice kernel:
    1 - exp(-1.3 steps / dim^1.6), never below its value at the default
    2*dim moves (a starved kernel must lower the ratio, not relax the
    bar)."""
    return min(1.0, 1.0 - float(
        np.exp(-1.3 * max(steps, 2 * dim) / float(dim) ** 1.6)))


def latent_cond_null(dim, n_chains):
    """Healthy-run latent condition number of a chain-start population:
    the Marchenko-Pastur edge ratio of a d-variate, n-sample
    identity-covariance estimate, to the power 1.25."""
    q = min(float(dim) / float(max(n_chains, dim + 1)), 0.98)
    edge = ((1.0 + q ** 0.5) / (1.0 - q ** 0.5)) ** 2
    return edge ** 1.25


def adjusted_logzerr(logzerr, mix_rels, x_dim, cond_rels=None):
    """Calibrated single-run logZ uncertainty: ``logzerr`` times the
    larger of 1/R^2 (R the median relative eigenbasis mixing ratio, the
    kinetic term) and the median relative latent condition number of
    Metropolis generations (the structural term), clipped to [1, 100].
    Applied only at ``x_dim >= 8`` and only when a chain kernel ran."""
    if not mix_rels or x_dim < 8:
        return float(logzerr)
    r = float(np.median(mix_rels))
    inflation = max(1.0, r ** -2)
    if cond_rels:
        inflation = max(inflation, float(np.median(cond_rels)))
    return float(logzerr) * min(100.0, inflation)


def eig_mix_from_moments(cov, msd):
    """Eigenbasis mixing ratio and latent condition number from one
    generation's start covariance C and displacement second moment M
    (``samplers/kernels.mix_moments_device``), in float64:
    r_eig = min_i (v_i^T M v_i) / (2 lambda_i) over eigenpairs of C, and
    cond = lambda_max / lambda_min. Returns ``(r_eig, cond)``."""
    c = np.asarray(cov, dtype=np.float64)
    m = np.asarray(msd, dtype=np.float64)
    dim = c.shape[0]
    eps = 1e-6 * (np.trace(c) / dim + 1e-12)
    c = c + eps * np.eye(dim)
    w, v = np.linalg.eigh(c)
    ratio = np.einsum('ij,jk,ki->i', v.T, m, v) / (2.0 * w + 1e-12)
    cond = float(w[-1] / max(w[0], 1e-30))
    return float(np.min(ratio)), cond


def thread_birth_logl(saved_logl, slots, n_live, birth_floor=-np.inf):
    """Per-point birth log likelihood from the slot (thread) record.

    Under in-place replacement the point in slot ``k`` was born at the
    threshold of the previous death in slot ``k``; the first occupant of
    each slot was born at ``birth_floor`` (-inf for a prior-seeded run, the
    batch floor for a dynamic batch). Returns float64 births aligned with
    ``saved_logl``."""
    saved_logl = np.asarray(saved_logl, dtype=np.float64)
    slots = np.asarray(slots)
    births = np.full(saved_logl.shape, float(birth_floor), np.float64)
    for k in range(int(n_live)):
        idx = np.nonzero(slots == k)[0]
        if idx.size > 1:
            births[idx[1:]] = saved_logl[idx[:-1]]
    return births


def merged_run_evidence(logl, birth_logl):
    """Evidence and weights of a (merged or dynamic) nested run from each
    point's death and birth log likelihoods.

    The live count at the i-th death (ascending) is ``#{birth_j < logl_i}
    - #{death_j < logl_i}``; the volume shrinks by ``E[ln t] = -1/n_i`` a
    death and each point takes the mass difference ``X_{i-1} - X_i``. The
    final live points appear as deaths with the live count ramping down,
    and the logZ variance is ``sum_i dh_i / n_i`` (h/N at constant N).

    Returns a dict: ``logz``, ``h``, ``logzerr``, ``logwt`` (in the input
    order), ``n_live`` (per death, ascending) and ``order`` (the
    ascending-death permutation)."""
    logl = np.asarray(logl, dtype=np.float64)
    birth = np.asarray(birth_logl, dtype=np.float64)
    if logl.shape != birth.shape:
        raise ValueError('logl and birth_logl must align')
    order = np.argsort(logl, kind='stable')
    l_sorted = logl[order]
    births_sorted = np.sort(birth)
    n_alive = (np.searchsorted(births_sorted, l_sorted, side='left')
               - np.searchsorted(l_sorted, l_sorted, side='left'))
    n_alive = np.maximum(n_alive, 1)
    dln = 1.0 / n_alive
    ln_x_prev = np.concatenate(([0.0], -np.cumsum(dln)[:-1]))
    logwt_sorted = l_sorted + ln_x_prev + np.log(-np.expm1(-dln))
    finite = np.isfinite(logwt_sorted)
    if not np.any(finite):
        return {'logz': -np.inf, 'h': 0.0, 'logzerr': 0.0,
                'logwt': logwt_sorted.copy(), 'n_live': n_alive,
                'order': order}
    m = np.max(logwt_sorted[finite])
    w = np.where(finite, np.exp(logwt_sorted - m), 0.0)
    a_cum = np.cumsum(w)
    b_cum = np.cumsum(np.where(finite, w * l_sorted, 0.0))
    logz_cum = m + np.log(np.maximum(a_cum, 1e-300))
    h_cum = np.where(a_cum > 0, b_cum / np.maximum(a_cum, 1e-300)
                     - logz_cum, 0.0)
    dh = np.diff(np.concatenate(([0.0], h_cum)))
    logzvar = float(np.sum(dh * dln))
    logwt = np.empty_like(logwt_sorted)
    logwt[order] = logwt_sorted
    return {'logz': float(logz_cum[-1]), 'h': float(h_cum[-1]),
            'logzerr': float(np.sqrt(max(logzvar, 0.0))),
            'logwt': logwt, 'n_live': n_alive, 'order': order}


def load_threads_npz(path):
    """A run's ``results/threads.npz`` as the ``{'logl', 'birth_logl'}``
    dict :func:`merge_runs` takes (births per slot from the saved birth
    floor)."""
    rec = np.load(path)
    logl = np.asarray(rec['logl'], np.float64)
    floor = float(rec['birth_floor']) if 'birth_floor' in rec else -np.inf
    return {'logl': logl,
            'birth_logl': thread_birth_logl(
                logl, np.asarray(rec['slots']), int(rec['n_live']),
                birth_floor=floor)}


def merge_runs(runs):
    """Merge nested runs of one likelihood and prior into one combined run:
    concatenate the (death, birth) pairs and recompute the evidence with
    per-death live counts (the constituents' live counts add wherever both
    are alive).

    ``runs``: dicts with ``logl`` and ``birth_logl``. Returns the
    :func:`merged_run_evidence` dict plus ``run_index`` and
    ``point_index``, which map each merged point back to its run and
    row."""
    if not runs:
        raise ValueError('no runs to merge')
    logl = np.concatenate([np.asarray(r['logl'], np.float64)
                           for r in runs])
    birth = np.concatenate([np.asarray(r['birth_logl'], np.float64)
                            for r in runs])
    out = merged_run_evidence(logl, birth)
    out['run_index'] = np.concatenate(
        [np.full(len(np.asarray(r['logl'])), i, np.int32)
         for i, r in enumerate(runs)])
    out['point_index'] = np.concatenate(
        [np.arange(len(np.asarray(r['logl'])), dtype=np.int64)
         for r in runs])
    return out
