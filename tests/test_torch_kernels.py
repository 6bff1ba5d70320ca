"""nnest_torch's latent kernels against nnest_tpu's on the same numbers.

Deterministic pieces get the same numpy inputs (and the same normal and
uniform draws) on both sides: sanitizing, the accept mask and the red-black
live-start selection must agree exactly, one constrained Metropolis step
must give the same accept mask and latent state, and the covariance factor
and chain diagnostics must agree within f32 rounding. The stochastic
kernels are checked statistically, as tests/test_kernels.py checks JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnest_tpu.samplers import kernels as jk
from nnest_torch.priors import UniformPrior
from nnest_torch.samplers import kernels as tk
from tests.test_torch_flows import flow_pair

# One intra-op thread a process: the suite runs in parallel workers that
# share the cores.
torch.set_num_threads(1)

BOX = 2.0


def _jax_like(u):
    return -0.5 * jnp.sum(u ** 2, axis=-1), jnp.zeros((u.shape[0], 0))


def _jax_prior(u):
    return jnp.where(jnp.all(jnp.abs(u) <= BOX, axis=-1), 0.0, -jnp.inf)


def _port_like(u):
    return -0.5 * torch.sum(u ** 2, dim=-1)


def _port_prior(u):
    return torch.where(torch.all(u.abs() <= BOX, dim=-1),
                       torch.zeros_like(u[:, 0]),
                       torch.full_like(u[:, 0], -np.inf))


@pytest.fixture(scope='module')
def kernel_pair():
    jm, params, tm = flow_pair(3)
    return (jk.LatentKernels(jm, _jax_like, _jax_prior), params,
            tk.LatentKernels(tm, _port_like, _port_prior), tm)


def test_sanitize_matches_jax():
    lp = np.array([np.nan, np.inf, -np.inf, -3e38, -1e32, -1e31, -5.0, 0.0,
                   7.5], np.float32)
    np.testing.assert_array_equal(
        tk.sanitize_log_density(torch.from_numpy(lp)).numpy(),
        np.asarray(jk.sanitize_log_density(jnp.asarray(lp))))


def test_accept_mask_matches_jax_on_the_same_uniforms():
    rs = np.random.RandomState(0)
    log_ratio = rs.normal(scale=2.0, size=512).astype(np.float32)
    log_ratio[:4] = [0.0, -np.inf, 50.0, -1e31]
    key = jax.random.PRNGKey(3)
    u = np.array(jax.random.uniform(key, log_ratio.shape))
    mask_j = np.asarray(jk._accept_mask(key, jnp.asarray(log_ratio)))
    mask_t = tk._accept_mask(torch.from_numpy(u), torch.from_numpy(log_ratio))
    np.testing.assert_array_equal(mask_t.numpy(), mask_j)
    assert 0 < mask_j.sum() < mask_j.size


def test_latent_kernels_refuse_a_flow_the_kernel_cannot_invert():
    with pytest.raises(ValueError, match='flow model with an inverse'):
        tk.LatentKernels(torch.nn.Linear(2, 2), _port_like, _port_prior)


def test_constrained_step_matches_jax(kernel_pair):
    """One constrained step with prior_volume_steps=2 from the same state,
    the same dz and uniforms: the JAX step is assembled from nnest_tpu's
    hot inverse, sanitized densities and accept rule."""
    jkern, params, tkern, _ = kernel_pair
    rs = np.random.RandomState(5)
    n, d, scale = 64, 3, np.float32(0.8)
    z0 = rs.normal(size=(n, d)).astype(np.float32)
    draws = [(rs.normal(size=(n, d)).astype(np.float32),
              rs.uniform(size=n).astype(np.float32)) for _ in range(2)]
    loglstar = np.float32(-1.5)

    inv_j = jkern._hot_inverse(params)
    x, ldj = inv_j(jnp.asarray(z0))
    z_pr, x_pr, ldj_pr = jnp.asarray(z0), x, ldj
    mask1 = jnp.zeros(n, bool)
    for dz, u in draws:
        z_prop = jnp.asarray(z0) + jnp.asarray(dz) * scale
        x_prop, ldj_prop = inv_j(z_prop)
        m = (jnp.asarray(u) < jnp.exp(jnp.minimum(ldj_prop - ldj, 0.0))) \
            & (jkern.prior_fn(x_prop) > -1e30)
        z_pr = jnp.where(m[:, None], z_prop, z_pr)
        x_pr = jnp.where(m[:, None], x_prop, x_pr)
        mask1 = mask1 | m
    logl_prop = jkern.like_fn(x_pr)[0]
    accept_j = np.asarray(mask1 & jnp.isfinite(logl_prop)
                          & (logl_prop > loglstar))
    z_j = np.asarray(jnp.where(jnp.asarray(accept_j)[:, None], z_pr, z0))

    inv_t = tkern._hot_inverse()
    zt = torch.from_numpy(z0)
    x0, ldj0 = inv_t(zt)
    logl0, derived0 = tkern.like_fn(x0)
    assert derived0 is None   # no derived parameters: none carried
    state = (zt, x0, ldj0, logl0, tkern.prior_fn(x0), derived0)
    (z_t, x_t, _, _, _, d_t), accept_t, _, n_evals = tkern.step(
        state, inv_t,
        [(torch.from_numpy(dz), torch.from_numpy(u), None)
         for dz, u in draws],
        loglstar=torch.tensor(loglstar), scale=torch.tensor(scale),
        cov_chol=None)
    np.testing.assert_array_equal(accept_t.numpy(), accept_j)
    np.testing.assert_array_equal(z_t.numpy(), z_j)
    assert d_t is None
    assert int(n_evals) == int(np.asarray(mask1).sum())
    assert 0 < accept_j.sum() < n
    np.testing.assert_allclose(
        x_t.numpy(), np.asarray(jnp.where(jnp.asarray(accept_j)[:, None],
                                          x_pr, x)), rtol=1e-5, atol=1e-5)


def test_live_starts_and_red_black_split(kernel_pair):
    jkern, params, tkern, _ = kernel_pair
    rs = np.random.RandomState(7)
    n_live, chains = 40, 16
    au = rs.uniform(-0.9, 0.9, size=(n_live, 3)).astype(np.float32)
    al = (-0.5 * np.sum(au ** 2, axis=1)).astype(np.float32)
    al[4] = -np.inf  # a failed likelihood, as the host clamps it
    key = jax.random.PRNGKey(11)
    idx = np.array(jax.random.randint(key, (chains,), 0, n_live))
    z0j, l0j, _, lp0j, muj, varj, _ = jkern._live_starts(
        params, key, jnp.asarray(au), jnp.asarray(al),
        jnp.zeros((n_live, 0)), chains)
    z0t, l0t, d0t, lp0t, mut, vart = tkern._live_starts(
        torch.from_numpy(idx), torch.from_numpy(au), torch.from_numpy(al))
    np.testing.assert_array_equal(l0t.numpy(), np.asarray(l0j))
    assert d0t is None
    np.testing.assert_array_equal(lp0t.numpy(), np.asarray(lp0j))
    np.testing.assert_allclose(z0t.numpy(), np.asarray(z0j), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(mut.numpy(), np.asarray(muj), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(vart.numpy(), np.asarray(varj), rtol=1e-5)

    g = torch.Generator().manual_seed(0)
    idx_a, cov_mask = tk.LatentKernels._red_black_split(g, n_live)
    assert idx_a.shape == (n_live // 2,)
    assert len(set(idx_a.tolist())) == n_live // 2
    assert not cov_mask[idx_a].any()
    assert int(cov_mask.sum()) == n_live - n_live // 2


def test_latent_cov_chol_matches_jax(kernel_pair):
    """Within f32 rounding: both sides factor the covariance of latents
    that agree to 1e-5, so the factors agree to ~1e-5 relative."""
    jkern, params, tkern, _ = kernel_pair
    rs = np.random.RandomState(9)
    live = rs.uniform(-0.9, 0.9, size=(50, 3)).astype(np.float32)
    mask = np.zeros(50, bool)
    mask[rs.permutation(50)[:25]] = True
    for m in (None, mask):
        cj = jkern._latent_cov_chol(
            params, jnp.asarray(live), None if m is None else jnp.asarray(m),
            None if m is None else 25)
        ct = tkern._latent_cov_chol(
            torch.from_numpy(live), None if m is None else torch.from_numpy(m),
            None if m is None else 25)
        np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=1e-4,
                                   atol=1e-6)
    # identical live rows: the jitter floor keeps both factors finite
    flat = np.repeat(live[:1], 50, axis=0)
    cj = jkern._latent_cov_chol(params, jnp.asarray(flat))
    ct = tkern._latent_cov_chol(torch.from_numpy(flat))
    assert np.all(np.isfinite(ct.numpy()))
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=1e-3,
                               atol=1e-6)


def test_chain_diagnostics_match_jax():
    rs = np.random.RandomState(4)
    b, t, d = 8, 60, 3
    chains = np.zeros((b, t, d), np.float32)
    for s in range(1, t):  # AR(1) chains with rho 0.7
        chains[:, s] = 0.7 * chains[:, s - 1] + rs.normal(size=(b, d))
    mu = chains.mean(axis=(0, 1))
    var = chains.var(axis=(0, 1))
    ess_j = jk.ess_device(jnp.asarray(chains), jnp.asarray(mu),
                          jnp.asarray(var))
    ess_t = tk.ess_device(torch.from_numpy(chains), torch.from_numpy(mu),
                          torch.from_numpy(var))
    np.testing.assert_allclose(ess_t.numpy(), np.asarray(ess_j), rtol=1e-4)
    z0, z1 = chains[:, 0] + rs.normal(size=(b, d)), chains[:, -1]
    z0, z1 = z0.astype(np.float32), z1.astype(np.float32)
    np.testing.assert_allclose(
        float(tk.mix_ratio_device(torch.from_numpy(z1), torch.from_numpy(z0))),
        float(jk.mix_ratio_device(jnp.asarray(z1), jnp.asarray(z0))),
        rtol=1e-5)
    for a, r in zip(tk.mix_moments_device(torch.from_numpy(z1),
                                          torch.from_numpy(z0)),
                    jk.mix_moments_device(jnp.asarray(z1), jnp.asarray(z0))):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-6)


def _starts(tkern, n, seed, loglstar=None):
    g = torch.Generator().manual_seed(seed)
    z0 = 0.3 * torch.randn(n, 3, generator=g)
    x0, _ = tkern._hot_inverse()(z0)
    logl0, _ = tkern.like_fn(x0)
    if loglstar is not None:
        assert bool((logl0 > loglstar).all())
    return g, z0, logl0, tkern.prior_fn(x0)


def test_constrained_mcmc_respects_loglstar(kernel_pair):
    _, _, tkern, _ = kernel_pair
    loglstar, chains, steps = -2.0, 32, 40
    g, z0, logl0, lp0 = _starts(tkern, chains, 1, loglstar)
    out = tkern.mcmc(g, z0, logl0, lp0, loglstar=loglstar, step_size=0.5,
                     mcmc_steps=steps, prior_volume_steps=2)
    assert bool((out['final_logl'] > loglstar).all())
    np.testing.assert_allclose(out['final_logl'].numpy(),
                               _port_like(out['final_x']).numpy(), rtol=1e-6)
    assert int(out['accepted']) > 0 and bool(out['moved'].any())
    assert 0 < int(out['ncall']) <= chains * steps
    assert out['ess'].shape == (3,) and bool(torch.isfinite(out['ess']).all())


def test_full_mh_targets_gaussian(kernel_pair):
    """Unconstrained Metropolis on a standard normal likelihood inside the
    ±2 box: after burn-in, chain endpoints have the truncated normal's
    moments (per-dim std 0.880 for a ±2 truncation)."""
    _, _, tkern, _ = kernel_pair
    g, z0, logl0, lp0 = _starts(tkern, 2000, 2)
    out = tkern.mcmc(g, z0, logl0, lp0, step_size=1.0, mcmc_steps=150,
                     dynamic_step_size=True)
    x = out['final_x'].numpy()
    assert np.all(np.abs(x) <= BOX)
    assert np.all(np.abs(x.mean(axis=0)) < 0.08)
    assert np.all(np.abs(x.std(axis=0) - 0.880) < 0.05)
    assert int(out['ncall']) == 2000 * 150


def test_rejection_prior_returns_valid_candidates(kernel_pair):
    _, _, tkern, _ = kernel_pair
    prior = UniformPrior(3, -1.0, 1.0)
    g = torch.Generator().manual_seed(3)
    x, logl, derived, ok = tkern.rejection_prior(prior, g, -0.3, 512)
    assert derived is None
    assert x.shape == (512, 3) and bool((x.abs() <= 1.0).all())
    assert bool((logl[ok] > -0.3).all()) and bool((logl[~ok] <= -0.3).all())
    assert 0 < int(ok.sum()) < 512
