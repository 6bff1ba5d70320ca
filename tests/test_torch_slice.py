"""The slice strategy against nnest_tpu on the same parameters and draws.

The reference's draws are rebuilt with ``jax.random`` from the key splits
of ``nnest_tpu.samplers.kernels._slice_impl``: ``split(key, steps)``, then
``kd, kh, kv, kj, kshr = split(k, 5)`` a step and ``kk, kt = split(kk)`` a
shrinkage iteration. The port's deterministic ``slice_body`` takes them as
tensors, with the same converted flow and starts, and must end where
nnest_tpu's ``LatentKernels.slice_`` ends: z, x and logl within 1e-5,
``ncall``, ``accepted`` and ``moved`` equal. A chain is excluded only when
one of its decisions (an active lane's slice test in the port's run) lies
within tolerance of its threshold: a log Jacobian within 1e-4 of the
height logy, an x within 2e-5 of the prior box, or a logl within 1e-4 of
loglstar; ``ncall`` may then differ by at most the excluded chains'
active evaluations. With these seeds no chain is excluded (the test counts
them and allows at most a quarter). Then ``slice_mix_null`` on a grid, and
the strategy end to end on the 2-D Gaussian's analytic evidence."""

import jax
import numpy as np
import pytest
import torch

from nnest_tpu.utils import evaluation as je
from nnest_torch import NestedSampler
from nnest_torch.likelihoods import Gaussian
from nnest_torch.utils import evaluation as te
from tests.test_torch_kernels import BOX, kernel_pair  # noqa: F401

# One intra-op thread a process: the suite runs in parallel workers that
# share the cores.
torch.set_num_threads(1)

TOL_Z = 1e-5
TOL_X = 2e-5
TOL_LDJ = 1e-4
CHAINS, STEPS, MAX_EXPAND, MAX_SHRINK = 16, 3, 4, 10


def _jax_draws(key, dim, chains=CHAINS, steps=STEPS):
    """The draws of ``_slice_impl`` on ``key``, in slice_draws' layout."""
    hard_cap = MAX_SHRINK + 40
    out = {k: [] for k in ('d', 'h', 'v', 'jmax', 'shrink')}
    for k in jax.random.split(key, steps):
        kd, kh, kv, kj, kshr = jax.random.split(k, 5)
        out['d'].append(jax.random.normal(kd, (chains, dim)))
        out['h'].append(jax.random.uniform(kh, (chains,)))
        out['v'].append(jax.random.uniform(kv, (chains,)))
        out['jmax'].append(jax.random.randint(kj, (chains,), 0, MAX_EXPAND))
        rows, kk = [], kshr
        for _ in range(hard_cap):
            kk, kt = jax.random.split(kk)
            rows.append(jax.random.uniform(kt, (chains,)))
        out['shrink'].append(np.stack(rows))
    return {k: torch.from_numpy(np.array(np.stack(v))) for k, v in out.items()}


def _near_chains(calls, draws, loglstar):
    """(excluded chain mask, active evaluations a chain): replays the
    port's recorded slice tests, step by step, to find the active lanes
    and flags a chain when an active decision sits within tolerance."""
    steps, chains = draws['h'].shape
    near = np.zeros(chains, bool)
    active_evals = np.zeros(chains, np.int64)
    step, i = -1, 0
    while i < len(calls):
        step += 1
        jmax = draws['jmax'][step].numpy()
        kmax = MAX_EXPAND - 1 - jmax
        done = np.zeros((2, chains), bool)
        acts = []
        for e in range(MAX_EXPAND):   # the 2N-row expansion tests
            rec = calls[i + e]
            act = np.stack([~done[0] & (e < jmax), ~done[1] & (e < kmax)])
            full = rec['full'].reshape(2, chains)
            done |= act & ~full
            acts.append((rec, act.reshape(-1)))
        i += MAX_EXPAND
        acc = np.zeros(chains, bool)
        while i < len(calls) and len(calls[i]['logy']) == chains:
            rec = calls[i]
            acts.append((rec, ~acc))
            acc |= rec['full']
            i += 1
        for rec, act in acts:
            lanes = np.arange(len(act)) % chains
            close = ((np.abs(rec['ldj'] - rec['logy']) <= TOL_LDJ)
                     | np.any(np.abs(np.abs(rec['x']) - BOX) <= TOL_X, axis=1)
                     | (np.abs(rec['logl'] - loglstar) <= TOL_LDJ))
            near[lanes[act & close]] = True
            np.add.at(active_evals, lanes[act], 1)
    assert step == steps - 1
    return near, active_evals


@pytest.mark.parametrize('adapt_cov', [False, True])
def test_slice_body_matches_jax(kernel_pair, adapt_cov):
    jkern, params, tkern, tm = kernel_pair
    rs = np.random.RandomState(2)
    live = rs.uniform(-0.9, 0.9, size=(60, 3)).astype(np.float32)
    logl_live = -0.5 * np.sum(live ** 2, axis=1)
    loglstar = np.float32(-0.6)
    x0 = live[logl_live > loglstar][:CHAINS]
    assert x0.shape == (CHAINS, 3)
    with torch.no_grad():
        z0 = tm(torch.from_numpy(x0))[0].numpy()
    logl0 = (-0.5 * np.sum(x0 ** 2, axis=1)).astype(np.float32)
    cov_mask = rs.permutation(60) < 30
    cov = dict(cov_from=live, cov_mask=cov_mask) if adapt_cov else {}
    key = jax.random.PRNGKey(21)
    ref = jkern.slice_(params, key, z0, logl0, np.zeros((CHAINS, 0),
                                                        np.float32),
                       loglstar=loglstar, width=1.0, slice_steps=STEPS,
                       max_expand=MAX_EXPAND, max_shrink=MAX_SHRINK, **cov)
    ref = {k: np.asarray(v) for k, v in ref.items()}

    calls = []
    real = tkern._in_slice

    def recording(inverse, zc, logy, ll_star):
        out = real(inverse, zc, logy, ll_star)
        calls.append({'logy': logy.numpy().copy(),
                      'full': out[1].numpy().copy(), 'x': out[2].numpy(),
                      'ldj': out[3].numpy(), 'logl': out[4].numpy()})
        return out

    draws = _jax_draws(key, 3)
    tkern._in_slice = recording
    try:
        got = tkern.slice_body(
            draws, torch.from_numpy(z0), torch.from_numpy(logl0),
            loglstar=float(loglstar), width=1.0, max_expand=MAX_EXPAND,
            **{k: torch.from_numpy(v) for k, v in cov.items()})
    finally:
        del tkern._in_slice
    got = {k: v.numpy() for k, v in got.items()}
    assert set(got) == set(ref) - {'final_derived', 'diag_chains'}

    near, active_evals = _near_chains(calls, draws, float(loglstar))
    keep = ~near
    assert near.sum() <= CHAINS // 4, near.sum()
    for k, tol in (('final_z', TOL_Z), ('final_x', TOL_Z),
                   ('final_logl', TOL_Z)):
        np.testing.assert_allclose(got[k][keep], ref[k][keep], rtol=0,
                                   atol=tol, err_msg=k)
    np.testing.assert_array_equal(got['moved'], ref['moved'])
    assert int(got['accepted']) == int(ref['accepted']) == STEPS * CHAINS
    assert int(got['rejected']) == int(ref['rejected']) == 0
    assert abs(int(got['ncall']) - int(ref['ncall'])) <= int(
        active_evals[near].sum())
    assert int(got['fast_calls']) == 0 and float(got['scale']) == 1.0
    if not near.any():
        assert int(got['ncall']) == int(ref['ncall'])
        for k in ('mean_jump', 'mix_ratio', 'mix_cov', 'mix_msd', 'ess',
                  'acceptance'):
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, atol=1e-6,
                                       err_msg=k)
    # both ends of an expansion go through one inverse of 2N stacked rows
    assert sum(len(c['logy']) == 2 * CHAINS for c in calls) \
        == STEPS * MAX_EXPAND
    # the shells are hit and stepped out: the draws reach both branches
    assert 0 < int(ref['ncall']) and np.all(got['final_logl'] > loglstar)


def test_slice_draws_shapes_and_from_live(kernel_pair):
    """``slice_from_live`` is the chain starts, ``slice_draws`` and
    ``slice_body`` on one generator, in that order."""
    _, _, tkern, _ = kernel_pair
    rs = np.random.RandomState(6)
    au = torch.from_numpy(rs.uniform(-0.9, 0.9, size=(40, 3)).astype(
        np.float32))
    al = -0.5 * torch.sum(au ** 2, dim=1)
    loglstar = float(torch.min(al))
    out = tkern.slice_from_live(torch.Generator().manual_seed(3), au, al,
                                num_chains=8, loglstar=loglstar, width=0.8,
                                slice_steps=2, adapt_cov=True)
    g = torch.Generator().manual_seed(3)
    z0, logl0, d0, _, mu, var, cov_mask = tkern._chain_starts(g, au, al, 8,
                                                              True)
    assert d0 is None
    draws = tkern.slice_draws(g, 2, 8, 3, 4, 10)
    assert draws['d'].shape == (2, 8, 3) and draws['shrink'].shape == (2, 50,
                                                                       8)
    assert draws['jmax'].min() >= 0 and draws['jmax'].max() < 4
    body = tkern.slice_body(draws, z0, logl0, loglstar=loglstar, width=0.8,
                            stat_moments=(mu, var), cov_from=au,
                            cov_mask=cov_mask)
    for k in out:
        assert torch.equal(out[k], body[k]), k
    assert bool((out['final_logl'] > loglstar).all())
    assert bool(out['moved'].all())


def test_slice_mix_null_matches_jax():
    for dim in (2, 3, 5, 10, 16, 30, 50):
        for steps in (0, 1, dim, 2 * dim, 5 * dim, 400):
            assert te.slice_mix_null(steps, dim) == pytest.approx(
                je.slice_mix_null(steps, dim), rel=1e-12)


def test_slice_strategy_gives_the_analytic_evidence(tmp_path):
    like = Gaussian(2, 0.0, lim=3)
    analytic = like.analytic_logz([-3.0, -3.0], [3.0, 3.0])
    s = NestedSampler(2, like, transform=lambda u: 3.0 * u,
                      num_live_points=100, log_dir=str(tmp_path), seed=3,
                      device='cpu')
    s.run(strategy=['rejection_prior', 'slice'], train_iters=30,
          mcmc_num_chains=10, volume_switch=0.5, dlogz=0.5)
    assert s.run_stats['slice_generations'] > 0
    assert s.run_stats['mcmc_generations'] == 0
    assert abs(s.logz - analytic) <= max(3.0 * s.logzerr, 0.15)
    # slice generations record the mixing diagnostics but do not inflate
    # the error bar by the structural term
    assert s.mixing_rel_ratio is not None and s._cond_infl == []
    with pytest.raises(ValueError, match="slice_adapt must be 'cov' or"):
        s.run(strategy=['slice'], slice_adapt='full')


def test_slice_sample_final_from_explicit_starts():
    """Slice chains from explicit starts (``_slice_sample_final``, the
    slice counterpart of the seed refresh's Metropolis): one chain a start,
    every end above loglstar with its likelihood recomputed, the starts'
    given likelihoods not paid again, and the generation's mixing ratio
    against the slice null; with cov directions from the given rows too."""
    s = NestedSampler(2, Gaussian(2, 0.0, lim=3),
                      transform=lambda u: 3.0 * u, num_live_points=50,
                      log_dir=None, seed=2, device='cpu', log_level=30)
    u0 = np.random.RandomState(0).uniform(-0.3, 0.3, size=(20, 2))
    logl0, _ = s.loglike(u0)
    loglstar = float(np.min(logl0)) - 1e-3
    for cov_from in (None, torch.tensor(u0, dtype=torch.float32)):
        calls = s.total_calls
        u, logl, derived, moved, scale, jump, ncall = s._slice_sample_final(
            3, 1.0, u0, init_loglikes=logl0, loglstar=loglstar,
            cov_from=cov_from)
        assert u.shape == (20, 2) and logl.shape == (20,)
        assert derived.shape == (20, 0) and moved.any()
        assert np.all(logl > loglstar) and np.all(np.abs(u) <= 1.0)
        np.testing.assert_allclose(logl, s.loglike(u)[0], rtol=1e-5)
        assert ncall >= 3 * 20 and s.total_calls == calls + ncall + 20
        assert s._mix_rels[-1] == s._mix_ratios_eig[-1] / te.slice_mix_null(
            3, 2)
