"""Flow rejection and flow-density draws against nnest_tpu on the same
parameters and the same random draws.

The reference's draws are rebuilt with ``jax.random`` from the key splits
of ``nnest_tpu.samplers.kernels._rejection_flow_impl`` (direction normals,
radius uniforms, accept uniforms) and ``_density_impl`` (the base normals)
and fed to the port's deterministic bodies as numpy. x must agree within
2e-5. A row's accept may differ only where the reference's own values sit
within the stated tolerances of a decision: a Jacobian accept uniform
within 1e-4 (the logdet tolerance) of exp(min(ldj - max_log_det_j, 0)) in
log, an x within 2e-5 of the prior box, or a logl within 1e-4 of
loglstar. The test counts those rows and allows only them."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tests.test_torch_kernels import BOX, kernel_pair  # noqa: F401

# One intra-op thread a process: the suite runs in parallel workers that
# share the cores.
torch.set_num_threads(1)

TOL_X = 2e-5
TOL_LDJ = 1e-4


def _live(n=60, seed=3):
    return np.random.RandomState(seed).uniform(
        -0.9, 0.9, size=(n, 3)).astype(np.float32)


def test_envelope_matches_jax(kernel_pair):
    jkern, params, tkern, _ = kernel_pair
    live = _live()
    for ef in (1.0, 1.7):
        mld_j, mr_j = jkern._envelope(params, live, np.float32(ef))
        mld_t, mr_t = tkern.envelope(torch.from_numpy(live), ef)
        assert abs(float(mld_t) - float(mld_j)) <= TOL_LDJ
        assert abs(float(mr_t) - float(mr_j)) <= 1e-5


def _near(jkern, params, z, x_ref, logl_ref, loglstar, u=None, mld=None):
    """Rows where a decision of the reference lies within tolerance."""
    near = np.any(np.abs(np.abs(x_ref) - BOX) <= TOL_X, axis=1)
    near |= np.abs(logl_ref - loglstar) <= TOL_LDJ
    if u is not None:
        _, ldj = jax.jit(jkern._hot_inverse(params))(jnp.asarray(z))
        log_ratio = np.minimum(np.asarray(ldj) - mld, 0.0)
        near |= np.abs(np.log(u) - log_ratio) <= TOL_LDJ
    return near


def _check(got, ref, near):
    x_t, logl_t, d_t, ok_t, nev_t = got
    assert d_t is None   # no derived parameters: none made
    x_t, logl_t, ok_t, nev_t = (a.numpy() for a in (x_t, logl_t, ok_t,
                                                    nev_t))
    x_j, logl_j, _, ok_j, nev_j = (np.asarray(a) for a in ref)
    np.testing.assert_allclose(x_t, x_j, rtol=0, atol=TOL_X)
    differ = ok_t != ok_j
    assert not np.any(differ & ~near), np.nonzero(differ & ~near)
    assert abs(int(nev_t) - int(nev_j)) <= int(near.sum())
    return differ.sum(), near.sum()


def test_rejection_flow_body_matches_jax(kernel_pair):
    """The envelope of a live set well inside the ±2 prior box, drawn
    with enlargement 2.5 so that some trials land outside it."""
    jkern, params, tkern, _ = kernel_pair
    n = 2048
    mld, mr = (np.float32(v) for v in jkern._envelope(
        params, _live(seed=10), np.float32(1.1)))
    ef = np.float32(2.5)
    loglstar = np.float32(-1.2)
    key = jax.random.PRNGKey(0)
    ref = jkern._rejection_flow(params, key, loglstar, mld, mr, ef,
                                num_trials=n, use_usample=False)
    kz, ku, kr = jax.random.split(key, 3)
    g = np.array(jax.random.normal(kz, (n, 3)))
    r = np.array(jax.random.uniform(kr, (n, 1)))
    u = np.array(jax.random.uniform(ku, (n,)))
    got = tkern.rejection_flow_body(
        torch.from_numpy(g), torch.from_numpy(r), torch.from_numpy(u),
        float(loglstar), torch.tensor(mld), torch.tensor(mr), float(ef))
    gd = jnp.asarray(g) / jnp.linalg.norm(jnp.asarray(g), axis=1,
                                          keepdims=True)
    z = ef * mr * gd * jnp.asarray(r) ** (1.0 / 3)
    near = _near(jkern, params, z, np.asarray(ref[0]), np.asarray(ref[1]),
                 loglstar, u, mld)
    _check(got, ref, near)
    x_j, ok_j = np.asarray(ref[0]), np.asarray(ref[3])
    outside = np.any(np.abs(x_j) > BOX, axis=1)
    # the draw reaches outside the prior box, and both accept and reject
    assert outside.sum() > 0 and 0 < ok_j.sum() < n
    assert not np.any(got[3].numpy() & outside)
    assert bool((got[1][got[3]] > loglstar).all())


def test_density_body_matches_jax(kernel_pair):
    jkern, params, tkern, _ = kernel_pair
    n, loglstar = 3000, np.float32(-1.5)
    key = jax.random.PRNGKey(4)
    ref = jkern._density(params, key, loglstar, num_trials=n)
    z = np.array(jkern.model.base_dist.sample(key, n))
    got = tkern.density_body(torch.from_numpy(z), float(loglstar))
    near = _near(jkern, params, z, np.asarray(ref[0]), np.asarray(ref[1]),
                 loglstar)
    _check(got, ref, near)
    assert np.any(np.abs(np.asarray(ref[0])) > BOX)
    assert 0 < int(np.asarray(ref[3]).sum()) < n


def test_fused_live_envelope_folds_and_draws(kernel_pair):
    """``rejection_flow_live`` equals the envelope, the fold and the body
    on draws from the same generator state."""
    _, _, tkern, _ = kernel_pair
    live = torch.from_numpy(_live())
    mld, mr = tkern.envelope(live, 1.1)
    for fold, prev in ((False, (1e3, 1e3)), (True, (1e3, 1e3)),
                       (True, (-1e3, 0.0))):
        out = tkern.rejection_flow_live(
            torch.Generator().manual_seed(5), -1.0, live, *prev, fold, 1.1,
            300)
        want_mld = max(prev[0], float(mld)) if fold else float(mld)
        want_mr = max(prev[1], float(mr)) if fold else float(mr)
        assert float(out[5]) == want_mld and float(out[6]) == want_mr
        draws = tkern.rejection_flow_draws(torch.Generator().manual_seed(5),
                                           300, 3)
        body = tkern.rejection_flow_body(*draws, -1.0, out[5], out[6], 1.1)
        assert out[2] is None and body[2] is None
        for a, b in zip(out[:5], body):
            assert a is b or torch.equal(a, b)
