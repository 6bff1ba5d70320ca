"""The NVP, Cholesky and fast-slow flows against nnest_tpu on the same
parameters.

The port's flow is initialised on a data batch, moved off its init values
by seeded noise (the Cholesky and scale layers start at the identity) and
carried to nnest_tpu's layout by ``nnest_torch.flows.convert``, whose tree
must have the shapes of nnest_tpu's own init; both flows see the same
numpy inputs: x within 1e-5, logdet within 1e-4 (a sum of f32 logs over
dims and blocks). A fast-only latent move, and a fast-only
Metropolis step and chain, leave the slow half of x bit-exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnest_tpu import distributions as jd
from nnest_tpu.flows import build_flow as jax_build_flow
from nnest_torch import distributions as td
from nnest_torch.flows import (FastSlowFlowModel, build_flow,
                               params_from_jax, params_to_jax)
from nnest_torch.samplers import kernels as tk
from tests.test_torch_kernels import _port_like, _port_prior

# One intra-op thread a process: the suite runs in parallel workers that
# share the cores.
torch.set_num_threads(1)

TOL_X = 1e-5
TOL_LOGDET = 1e-4
# tests/test_flows.py's (num_slow, num_fast) pairs
FAST_SLOW = [(2, 2), (2, 3), (3, 2), (3, 5), (5, 4)]
# (flow, dim, num_slow, scale)
CASES = ([('nvp', 3, 0, s) for s in ('', 'translate', 'constant')]
         + [('cholesky', 3, 0, ''), ('choleksy', 3, 0, '')]
         + [(f, ns + nf, ns, '') for f in ('spline', 'nvp')
            for ns, nf in FAST_SLOW])


def _perturbed(tree, rs):
    """``tree`` with seeded noise on every leaf but the 1x1 convs' fixed
    permutation ``_P``."""
    if isinstance(tree, dict):
        return {k: v if k == '_P' else _perturbed(v, rs)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_perturbed(v, rs) for v in tree)
    a = np.asarray(tree, np.float32)
    return (a + 0.1 * rs.normal(size=a.shape)).astype(np.float32)


def other_flow_pair(d, flow, num_slow=0, scale='', base=None, seed=0):
    """(JAX model, JAX params, port model with the same params): the
    port's flow, initialised on a data batch and perturbed, and its params
    in the JAX layout."""
    jm = jax_build_flow(d, flow=flow, hidden_dim=16, num_slow=num_slow,
                        scale=scale, base_dist=None if base is None
                        else getattr(jd, base)(dim=d))
    tm = build_flow(d, flow=flow, hidden_dim=16, num_slow=num_slow,
                    scale=scale, base_dist=None if base is None
                    else getattr(td, base)(d), seed=seed, device='cpu')
    rs = np.random.RandomState(seed)
    tm.data_init(torch.from_numpy(rs.normal(size=(64, d)).astype(
        np.float32)))
    params = _perturbed(params_to_jax(tm), rs)
    params_from_jax(tm, params)
    return jm, jax.tree.map(jnp.asarray, params), tm


def _close(port, ref, tol):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize('flow,d,num_slow,scale', CASES)
def test_flow_matches_jax(flow, d, num_slow, scale):
    jm, params, tm = other_flow_pair(d, flow, num_slow, scale)
    assert isinstance(tm, FastSlowFlowModel) == (num_slow > 0)
    z = (2.0 * np.random.RandomState(1).normal(size=(32, d))).astype(
        np.float32)
    zj, zt = jnp.asarray(z), torch.from_numpy(z)
    with torch.no_grad():
        for jax_fn, port_fn in ((jm.forward, tm.forward),
                                (jm.inverse, tm.inverse)):
            yj, ldj = jax_fn(params, zj)
            yt, ldt = port_fn(zt)
            _close(yt, yj, TOL_X)
            _close(ldt, ldj, TOL_LOGDET)
        _close(tm.log_prob(zt), jm.log_prob(params, zj), TOL_LOGDET)
    # the layouts round-trip leaf by leaf, and match nnest_tpu's
    back = params_to_jax(tm)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, np.asarray(b))
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jax.ShapeDtypeStruct((8, d), jnp.float32))
    assert jax.tree.map(lambda a: a.shape, shapes) == jax.tree.map(
        lambda a: a.shape, params)


@pytest.mark.parametrize('flow', ['spline', 'nvp'])
def test_slow_dims_are_bit_exact_under_fast_moves(flow):
    """A fast-only latent move (tests/test_flows.py:64-72), a fast-only
    constrained Metropolis step and a chain of fast-only steps leave the
    slow half of x bit-exact; with oversample_rate 0 a step moves it."""
    num_slow, d = 3, 5
    tm = build_flow(d, flow=flow, num_slow=num_slow, seed=4, device='cpu')
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.normal(size=(10, d)).astype(np.float32))
    tm.data_init(x)
    with torch.no_grad():
        z, _ = tm(x)
        dz = torch.from_numpy(0.01 * rs.normal(size=z.shape).astype(
            np.float32))
        dz[:, :num_slow] = 0.0
        x0, _ = tm.inverse(z)
        x1, _ = tm.inverse(z + dz)
    assert torch.equal(x0[:, :num_slow], x1[:, :num_slow])
    assert not torch.equal(x0[:, num_slow:], x1[:, num_slow:])

    n = 64
    z0 = torch.from_numpy(0.3 * rs.normal(size=(n, d)).astype(np.float32))
    for rate, fast in ((1.0, True), (1e-9, False)):
        kern = tk.LatentKernels(tm, _port_like, _port_prior,
                                num_slow=num_slow, oversample_rate=rate)
        inverse = kern._hot_inverse()
        xs, ldj = inverse(z0)
        state = (z0, xs, ldj, kern.like_fn(xs)[0], kern.prior_fn(xs), None)
        draws = [(torch.from_numpy(rs.normal(size=(n, d)).astype(
            np.float32)), torch.full((n,), 0.5), torch.tensor(0.5))]
        (_, x_new, _, _, _, _), accept, x_prop, _ = kern.step(
            state, inverse, draws, loglstar=torch.tensor(-3.0),
            scale=torch.tensor(0.5), cov_chol=None)
        assert bool(accept.any())
        assert torch.equal(x_prop[:, :num_slow], xs[:, :num_slow]) == fast
        if fast:
            assert torch.equal(x_new[:, :num_slow], xs[:, :num_slow])
        out = kern.mcmc(torch.Generator().manual_seed(2), z0,
                        kern.like_fn(xs)[0], kern.prior_fn(xs), loglstar=-3.0,
                        step_size=0.5, mcmc_steps=5)
        assert int(out['accepted']) > 0
        assert int(out['fast_calls']) == (int(out['ncall']) if fast else 0)
        assert torch.equal(out['final_x'][:, :num_slow],
                           xs[:, :num_slow]) == fast
