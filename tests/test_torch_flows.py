"""nnest_torch's spline flow against nnest_tpu's on the same parameters.

JAX params are initialised by nnest_tpu, carried across as numpy leaves by
``nnest_torch.flows.convert`` and both flows see the same numpy inputs.
Tolerances: x within 1e-5 (the repo's f32 contract); logdet within 1e-4,
because it is a sum of f32 logs over every dim and every block, so its
rounding grows with their count where x's does not.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnest_tpu.bijectors.rqs import rqs as jax_rqs
from nnest_tpu.flows import build_flow as jax_build_flow
from nnest_torch.bijectors.rqs import knots, rqs
from nnest_torch.flows import build_flow, params_from_jax, params_to_jax

# One intra-op thread a process: the suite runs in parallel workers that
# share the cores.
torch.set_num_threads(1)

TOL_X = 1e-5
TOL_LOGDET = 1e-4
# An input exactly on a knot: the two frameworks round the knot apart by an
# ulp, so they may pick neighbouring bins, and at the top of a bin the
# inverse's quadratic loses ~4 digits (root = 1 - O(1e-4)). The output is
# continuous there; the logdet is continuous in exact arithmetic only.
TOL_LOGDET_KNOT = 1e-3


def flow_pair(d, hidden=16, seed=0):
    """(JAX model, JAX params, port model with the same params)."""
    jm = jax_build_flow(d, flow='spline', hidden_dim=hidden)
    x = np.random.RandomState(seed).normal(size=(64, d)).astype(np.float32)
    params = jm.init(jax.random.PRNGKey(seed), jnp.asarray(x))
    tm = build_flow(d, hidden_dim=hidden, device='cpu')
    params_from_jax(tm, jax.tree.map(np.asarray, params))
    return jm, params, tm


def _close(port, ref, tol):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize('d', [2, 3, 5])
def test_flow_matches_jax(d):
    jm, params, tm = flow_pair(d)
    # scale 2 puts some inputs beyond the tail bound 3
    z = (2.0 * np.random.RandomState(1).normal(size=(48, d))).astype(
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


@pytest.mark.parametrize('d', [2, 3, 5, 7])
def test_roundtrip_and_logdet_antisymmetry(d):
    """The tests/test_flows.py contract on the port: x -> z -> x within
    1e-5 and forward/inverse logdets summing to 0 within 1e-5."""
    tm = build_flow(d, seed=d, device='cpu')
    x = torch.from_numpy(
        np.random.RandomState(0).normal(size=(10, d)).astype(np.float32))
    tm.data_init(x)
    with torch.no_grad():
        z, ld_f = tm(x)
        x2, ld_i = tm.inverse(z)
        lp = tm.log_prob(x)
    assert z.shape == x.shape and ld_f.shape == (10,)
    assert float((x2 - x).abs().max()) <= 1e-5
    assert float((ld_f + ld_i).abs().max()) <= 1e-5
    assert torch.isfinite(lp).all()


def test_rqs_edges_match_jax():
    """Tails (identity, logdet 0), inputs exactly at ±B and exactly on the
    spline's knots, in both directions, against nnest_tpu's rqs."""
    rs = np.random.RandomState(3)
    K, B, batch, d = 8, 3.0, 5, 3
    W = rs.normal(size=(batch, d, K)).astype(np.float32)
    H = rs.normal(size=(batch, d, K)).astype(np.float32)
    D = rs.normal(size=(batch, d, K - 1)).astype(np.float32)
    Wt, Ht, Dt = map(torch.from_numpy, (W, H, D))
    cw, ch = knots(Wt, Ht, B)
    for inverse, kn in ((False, cw), (True, ch)):
        cols = [(np.full((batch, d), v, np.float32), TOL_LOGDET)
                for v in (-5.0, -B, -B + 1e-6, 0.0, B - 1e-6, B, 4.0)]
        cols += [(kn[..., k].numpy(), TOL_LOGDET_KNOT) for k in range(K + 1)]
        for y, tol_ld in cols:
            out_j, ld_j = jax_rqs(jnp.asarray(y), W, H, D, inverse=inverse,
                                  tail_bound=B)
            out_t, ld_t = rqs(torch.from_numpy(y), Wt, Ht, Dt,
                              inverse=inverse, tail_bound=B)
            assert torch.isfinite(out_t).all() and torch.isfinite(ld_t).all()
            _close(out_t, out_j, TOL_X)
            _close(ld_t, ld_j, tol_ld)
        outside = torch.full((batch, d), 5.0)
        out_t, ld_t = rqs(outside, Wt, Ht, Dt, inverse=inverse, tail_bound=B)
        assert torch.equal(out_t, outside) and torch.all(ld_t == 0.0)


def test_convert_roundtrip():
    _, params, tm = flow_pair(5)
    back = params_to_jax(tm)
    leaves, ref = jax.tree.leaves(back), jax.tree.leaves(params)
    assert len(leaves) == len(ref)
    for a, b in zip(leaves, ref):
        np.testing.assert_array_equal(a, np.asarray(b))
