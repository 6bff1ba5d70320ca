"""Every port flow's analytic logdet against the brute-force Jacobian
determinant of ``nnest_torch.flows.testing``: the counterpart of
tests/test_logdet_oracle.py, at its flows, dims, rows and tolerances
(rtol 1e-3, atol 1e-3).

- The single-speed flows (``'choleksy'``, the reference's spelling, NVP
  and spline) at dims 2, 3 and 5, forward and inverse, on flows
  initialised on the data batch; the fast-slow spline at dim 5 with 2 slow
  dims, forward and inverse.
- The oracle itself: on the same weights (``flows/convert.py``) the port's
  brute-force logdets equal ``nnest_tpu.flows.testing``'s within 1e-4
  (the spline's inverse at dim 3, the fast-slow spline's forward at dim 5),
  and on the spline flow in float64 each row's log|det| equals that of
  ``torch.autograd.functional.jacobian`` within 1e-10, so the oracle
  cannot become ``vmap(jacfwd(...))``, which gives a wrong Jacobian there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnest_torch.flows import build_flow
from nnest_torch.flows.testing import (brute_force_forward_logdet,
                                       brute_force_logdet)
from tests.test_torch_other_flows import other_flow_pair

# One intra-op thread a process: the suite runs in parallel workers that
# share the cores.
torch.set_num_threads(1)


def _check_flow(model, x):
    z, logdet_fwd = model(x)
    np.testing.assert_allclose(
        logdet_fwd.detach().numpy(),
        brute_force_forward_logdet(model, x).detach().numpy(),
        rtol=1e-3, atol=1e-3)
    _, logdet_inv = model.inverse(z.detach())
    np.testing.assert_allclose(
        logdet_inv.detach().numpy(),
        brute_force_logdet(model, z.detach()).detach().numpy(),
        rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize('flow', ['choleksy', 'nvp', 'spline'])
@pytest.mark.parametrize('dims', [2, 3, 5])
def test_logdet_matches_jacobian(flow, dims):
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.normal(size=(6, dims)).astype(np.float32))
    model = build_flow(dims, flow=flow, device='cpu')
    model.data_init(x)
    _check_flow(model, x)


def test_fast_slow_logdet_matches_jacobian():
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.normal(size=(4, 5)).astype(np.float32))
    model = build_flow(5, flow='spline', num_slow=2, device='cpu')
    model.data_init(x)
    _check_flow(model, x)


@pytest.mark.parametrize('d,num_slow,direction', [(3, 0, 'inverse'),
                                               (5, 2, 'forward')])
def test_oracle_matches_nnest_tpu(d, num_slow, direction):
    from nnest_tpu.flows import testing as jax_testing
    jm, params, tm = other_flow_pair(d, 'spline', num_slow=num_slow, seed=3)
    x = np.random.RandomState(4).normal(size=(4, d)).astype(np.float32)
    if direction == 'inverse':
        x = tm(torch.from_numpy(x))[0].detach().numpy()
        port = brute_force_logdet(tm, torch.from_numpy(x))
        ref = jax_testing.brute_force_logdet
    else:
        port = brute_force_forward_logdet(tm, torch.from_numpy(x))
        ref = jax_testing.brute_force_forward_logdet
    # jitted: one compile, not an eager dispatch of every traced operation
    want = jax.jit(lambda p, v: ref(jm, p, v))(params, jnp.asarray(x))
    np.testing.assert_allclose(port.detach(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_oracle_matches_autograd_jacobian_on_the_spline():
    model = build_flow(3, flow='spline', device='cpu').double()
    z = torch.from_numpy(np.random.RandomState(5).normal(size=(4, 3)))
    model.data_init(z)

    def inv(v):
        return model.inverse(v[None, :])[0][0]

    want = torch.stack([torch.linalg.slogdet(
        torch.autograd.functional.jacobian(inv, row))[1] for row in z])
    np.testing.assert_allclose(brute_force_logdet(model, z).detach(), want,
                               rtol=0, atol=1e-10)
    # and the analytic logdet the oracle is held to
    np.testing.assert_allclose(model.inverse(z)[1].detach(), want,
                               rtol=0, atol=1e-10)
