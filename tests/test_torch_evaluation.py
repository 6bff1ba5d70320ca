"""nnest_torch's run diagnostics against nnest_tpu's on the same numbers:
the numpy copies in ``nnest_torch/utils/evaluation.py`` to 1e-12
relative (the merged-run functions on ``tests/test_merge.py``'s exact
nested-sampling simulation, a batch above a birth floor included), and the
per-generation mixing fields the sampler records from one MCMC
generation's second moments."""

import numpy as np
import pytest
import torch

from nnest_tpu.utils import evaluation as je
from nnest_torch.likelihoods import Gaussian
from nnest_torch.samplers.nested import NestedSampler
from nnest_torch.utils import evaluation as te
from tests.test_merge import _logl_of_vol, simulate_run

# One intra-op thread a process: the suite runs in parallel workers that
# share the cores.
torch.set_num_threads(1)

RTOL = 1e-12


def _ranks(kind, n_live, rs):
    if kind == 'empty':
        return np.empty(0, np.int64)
    if kind == 'one':
        return np.array([3])
    if kind == 'constant':      # every replacement at the same rank
        return np.full(250, 7)
    if kind == 'skewed':        # under-mixed: ranks pile up low
        return (n_live * rs.uniform(size=900) ** 3).astype(np.int64)
    return rs.randint(0, n_live, size=1234)


@pytest.mark.parametrize('kind', ['empty', 'one', 'constant', 'skewed',
                                  'uniform'])
def test_insertion_tests_match_jax(kind):
    n_live = 50
    r = _ranks(kind, n_live, np.random.RandomState(1))
    for block in (None, 100, 1):
        got = te.rolling_insertion_ks(r, n_live, block)
        want = je.rolling_insertion_ks(r, n_live, block)
        assert got[1] == want[1]
        np.testing.assert_allclose(got[0], want[0], rtol=RTOL)
    np.testing.assert_allclose(te.insertion_ks(r, n_live),
                               je.insertion_ks(r, n_live), rtol=RTOL)
    for d, n in ((0.0, 10), (0.05, 0), (0.03, 400), (0.5, 3), (2.0, 1000)):
        np.testing.assert_allclose(te.kolmogorov_pvalue(d, n),
                                   je.kolmogorov_pvalue(d, n), rtol=RTOL)


@pytest.mark.parametrize('n_live', [1, 4, 30])
def test_bootstrap_logz_error_matches_jax(n_live):
    rs = np.random.RandomState(n_live)
    n_dead = 6 * n_live
    logl = np.sort(rs.normal(size=n_dead + n_live)) * 3.0
    slots = np.concatenate([rs.randint(0, n_live, size=n_dead),
                            np.arange(n_live)])
    for seed, n_boot in ((0, 200), (5, 17)):
        np.testing.assert_allclose(
            te.bootstrap_logz_error(logl, slots, n_live, n_boot, seed),
            je.bootstrap_logz_error(logl, slots, n_live, n_boot, seed),
            rtol=RTOL)


def test_nulls_and_adjusted_logzerr_match_jax():
    for steps, dim in ((0, 2), (10, 2), (80, 16), (250, 50), (5, 100)):
        for cov in (False, True):
            np.testing.assert_allclose(
                te.metropolis_mix_null(steps, dim, adapt_cov=cov),
                je.metropolis_mix_null(steps, dim, adapt_cov=cov), rtol=RTOL)
    for dim, chains in ((2, 10), (16, 256), (50, 10), (100, 101)):
        np.testing.assert_allclose(te.latent_cond_null(dim, chains),
                                   je.latent_cond_null(dim, chains),
                                   rtol=RTOL)
    rs = np.random.RandomState(3)
    rels = list(rs.uniform(0.2, 1.5, size=7))
    conds = list(rs.uniform(0.5, 9.0, size=5))
    for mix, dim, cond in ((rels, 16, conds), (rels, 16, None),
                           (rels, 7, conds), ([], 16, conds),
                           ([0.001], 30, None), ([2.0], 8, [0.5])):
        np.testing.assert_allclose(
            te.adjusted_logzerr(0.13, mix, dim, cond_rels=cond),
            je.adjusted_logzerr(0.13, mix, dim, cond_rels=cond), rtol=RTOL)


@pytest.mark.parametrize('case', ['random', 'degenerate', 'identity'])
def test_eig_mix_from_moments_matches_jax(case):
    rs = np.random.RandomState(4)
    d = 6
    if case == 'identity':
        cov, msd = np.eye(d), 2.0 * np.eye(d)
    else:
        a = rs.normal(size=(40, d))
        if case == 'degenerate':   # rank-deficient start covariance
            a[:, -2:] = a[:, :2]
        cov = a.T @ a / 40
        b = rs.normal(size=(40, d))
        msd = b.T @ b / 40
    got = te.eig_mix_from_moments(cov.astype(np.float32),
                                  msd.astype(np.float32))
    want = je.eig_mix_from_moments(cov.astype(np.float32),
                                   msd.astype(np.float32))
    np.testing.assert_allclose(got, want, rtol=RTOL)


def test_sampler_records_eigenbasis_mixing_of_a_generation():
    """One MCMC generation through ``_mcmc_sample_live``: the fields it
    appends equal nnest_tpu's eigenbasis function on the kernel's own
    mix_cov/mix_msd, divided by nnest_tpu's nulls."""
    d, chains, steps = 3, 12, 6
    sampler = NestedSampler(d, Gaussian(d, 0.0), num_live_points=40,
                            log_dir=None, seed=2, device='cpu')
    kernels = sampler.kernels
    outs = []
    real = kernels.mcmc_from_live

    def capture(*args, **kwargs):
        outs.append(real(*args, **kwargs))
        return outs[-1]

    kernels.mcmc_from_live = capture
    u = np.random.RandomState(5).uniform(-0.5, 0.5, size=(40, d))
    logl, _ = sampler.loglike(u)
    for adapt in (True, False):
        sampler._mcmc_sample_live(steps, u, logl, chains, float(logl.min()),
                                  0.5, adapt_cov=adapt)
        out = outs[-1]
        r_eig, cond = je.eig_mix_from_moments(out['mix_cov'].numpy(),
                                              out['mix_msd'].numpy())
        mix_null = je.metropolis_mix_null(steps, d, adapt_cov=adapt)
        cond_null = je.latent_cond_null(d, chains)
        assert sampler._mix_ratios_eig[-1] == pytest.approx(r_eig, rel=RTOL)
        assert sampler._latent_conds[-1] == pytest.approx(cond, rel=RTOL)
        assert sampler._mix_rels[-1] == pytest.approx(r_eig / mix_null,
                                                      rel=RTOL)
        assert sampler._cond_rels[-1] == pytest.approx(cond / cond_null,
                                                       rel=RTOL)
        assert sampler._cond_infl[-1] == sampler._cond_rels[-1]
        assert sampler._last_kernel_stats['mix_ratio_eig'] == \
            sampler._mix_ratios_eig[-1]
    assert len(sampler._mix_rels) == len(sampler._cond_infl) == 2


def _chains(kind, rs):
    """(chains, steps, dim) test chains: iid normals, AR(1) walks with
    rho 0.9, or Metropolis-like chains that stay put on 60% of steps."""
    b, t, d = 6, 300, 3
    if kind == 'iid':
        return rs.normal(size=(b, t, d))
    x = np.zeros((b, t, d))
    for s in range(1, t):
        if kind == 'ar':
            x[:, s] = 0.9 * x[:, s - 1] + rs.normal(size=(b, d))
        else:
            stay = rs.uniform(size=(b, 1)) < 0.6
            x[:, s] = np.where(stay, x[:, s - 1],
                               0.5 * x[:, s - 1] + rs.normal(size=(b, d)))
    return x


@pytest.mark.parametrize('kind', ['iid', 'ar', 'sticky'])
def test_chain_statistics_match_jax(kind):
    """The MCMC and ensemble samplers' chain statistics: ESS (and the lag
    autocorrelation under it), acceptance, mean jump, R-hat and the
    bootstrap's integrated autocorrelation time."""
    x = _chains(kind, np.random.RandomState(3))
    mu, var = x.mean(axis=(0, 1)), x.var(axis=(0, 1))
    for s in (1, 5, 40):
        np.testing.assert_allclose(te.auto_correlation_time(x, s, mu, var),
                                   je.auto_correlation_time(x, s, mu, var),
                                   rtol=RTOL)
    pairs = [(te.effective_sample_size(x, mu, var),
              je.effective_sample_size(x, mu, var)),
             (te.acceptance_rate(x), je.acceptance_rate(x)),
             (te.mean_jump_distance(x), je.mean_jump_distance(x)),
             (te.gelman_rubin_diagnostic(x), je.gelman_rubin_diagnostic(x)),
             (te.gelman_rubin_diagnostic(x, mu=np.zeros(3)),
              je.gelman_rubin_diagnostic(x, mu=np.zeros(3))),
             (te.integrated_autocorr_time(x), je.integrated_autocorr_time(x)),
             (te.integrated_autocorr_time(x, c=2.0),
              je.integrated_autocorr_time(x, c=2.0))]
    for got, ref in pairs:
        np.testing.assert_allclose(got, ref, rtol=RTOL)
    if kind == 'sticky':
        assert 0.3 < te.acceptance_rate(x) < 0.5
    if kind == 'ar':   # correlated chains: a smaller ESS, a longer tau
        assert np.all(te.effective_sample_size(x, mu, var) < 100)
        assert np.all(te.integrated_autocorr_time(x) > 5)


def _floor_batch(n_live, n_iter, x_star, seed):
    """A simulated batch of ``n_live`` threads born at volume ``x_star``:
    (logl, slots, floor), the sampler's saved order."""
    rng = np.random.RandomState(seed)
    vols = rng.uniform(size=n_live) * x_star
    logl, slots = [], []
    for _ in range(n_iter):
        worst = int(np.argmax(vols))
        logl.append(_logl_of_vol(vols[worst]))
        slots.append(worst)
        vols[worst] = rng.uniform() * vols[worst]
    for i in range(n_live):
        logl.append(_logl_of_vol(vols[i]))
        slots.append(i)
    return np.asarray(logl), np.asarray(slots), _logl_of_vol(x_star)


def _merge_parts(floor_first):
    """A static run and a birth-floor batch in (logl, slots, n_live,
    floor) form."""
    logl, slots = simulate_run(100, 3000, seed=7)
    blogl, bslots, floor = _floor_batch(60, 1500, np.exp(-2.0), seed=8)
    parts = [(logl, slots, 100, -np.inf), (blogl, bslots, 60, floor)]
    return parts[::-1] if floor_first else parts


def _assert_same(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=0)


def test_thread_birth_logl_matches_jax():
    logl = np.array([1.0, 2.0, 3.0, 4.0, 5.0])
    slots = np.array([0, 1, 0, 0, 1])
    for floor in (-np.inf, -7.5):
        np.testing.assert_array_equal(
            te.thread_birth_logl(logl, slots, 2, birth_floor=floor),
            je.thread_birth_logl(logl, slots, 2, birth_floor=floor))
    for logl, slots, n_live, floor in _merge_parts(False):
        got = te.thread_birth_logl(logl, slots, n_live, birth_floor=floor)
        want = je.thread_birth_logl(logl, slots, n_live, birth_floor=floor)
        assert got.dtype == want.dtype == np.float64
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('floor_first', [False, True])
def test_merged_run_evidence_and_merge_runs_match_jax(floor_first):
    runs = [{'logl': logl,
             'birth_logl': je.thread_birth_logl(logl, slots, n,
                                                birth_floor=floor)}
            for logl, slots, n, floor in _merge_parts(floor_first)]
    for r in runs:
        _assert_same(te.merged_run_evidence(r['logl'], r['birth_logl']),
                     je.merged_run_evidence(r['logl'], r['birth_logl']))
    got, want = te.merge_runs(runs), je.merge_runs(runs)
    _assert_same(got, want)
    # the batch adds its live points inside its interval only
    assert np.max(got['n_live']) == 160
    # no finite weight: the degenerate case of both
    _assert_same(te.merged_run_evidence([-np.inf] * 3, [-np.inf] * 3),
                 je.merged_run_evidence([-np.inf] * 3, [-np.inf] * 3))
    for mod in (te, je):
        with pytest.raises(ValueError):
            mod.merge_runs([])
        with pytest.raises(ValueError):
            mod.merged_run_evidence([1.0, 2.0], [0.0])


def test_load_threads_npz_matches_jax(tmp_path):
    for i, (logl, slots, n_live, floor) in enumerate(_merge_parts(False)):
        path = str(tmp_path / ('threads%d.npz' % i))
        extra = {} if i == 0 else {'birth_floor': np.float64(floor)}
        np.savez(path, logl=logl, slots=slots.astype(np.uint32),
                 n_live=np.int64(n_live), **extra)
        _assert_same(te.load_threads_npz(path), je.load_threads_npz(path))
