"""The spline-inverse kernel's plain twin and wrapper against nnest_tpu.

``nnest_torch.ops.fused_spline._inverse_body`` is the CPU path of the
kernel wrapper and the oracle the CUDA kernel is held to on the card. It
must match nnest_tpu's XLA body within the tests/test_fused.py bounds
(2e-5 x, 2e-4 logdet) and the Pallas kernel in interpret mode within the
tests/test_pallas_spline.py bounds (3e-5 x, 3e-4 logdet). The kernel
itself needs a GPU and nvcc: it is tested in tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnest_tpu.ops import fused_spline as jax_fused
from nnest_tpu.ops.pallas_spline import make_pallas_inverse
from nnest_torch.flows import build_flow
from nnest_torch.ops import spline_inverse as si
from nnest_torch.ops.fused_spline import (
    _inverse_body, is_fusable_spline, pack_inverse_consts)
from tests.test_torch_flows import flow_pair


def _z(n, d, seed=1):
    return (2.0 * np.random.RandomState(seed).normal(size=(n, d))).astype(
        np.float32)


@pytest.mark.parametrize('d', [4, 5, 16])
def test_inverse_body_matches_jax(d):
    jm, params, tm = flow_pair(d, hidden=32 if d >= 16 else 16)
    z = _z(32, d)
    xj, ldj = jax_fused._inverse_body(
        jnp.asarray(z), jax_fused.pack_inverse_consts(jm, params), jm)
    xt, ldt = _inverse_body(torch.from_numpy(z), pack_inverse_consts(tm))
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(ldt.numpy(), np.asarray(ldj), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize('d', [5, 16])
def test_inverse_body_matches_pallas_interpret(d):
    jm, params, tm = flow_pair(d)
    z = _z(70, d)  # 70 rows at tile 32: the Pallas pad path
    xj, ldj = make_pallas_inverse(jm, tile=32, interpret=True)(
        params, jnp.asarray(z))
    xt, ldt = si.spline_inverse(torch.from_numpy(z), pack_inverse_consts(tm))
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=3e-5,
                               atol=3e-5)
    np.testing.assert_allclose(ldt.numpy(), np.asarray(ldj), rtol=3e-4,
                               atol=3e-4)


def test_wrapper_uses_twin_on_cpu_without_launching():
    _, _, tm = flow_pair(5)
    packed = pack_inverse_consts(tm)
    z = torch.from_numpy(_z(16, 5))
    before = si.launches
    x1, ld1 = si.spline_inverse(z, packed)
    x2, ld2 = _inverse_body(z, packed)
    assert torch.equal(x1, x2) and torch.equal(ld1, ld2)
    assert si.launches == before
    with pytest.raises(ValueError, match='CUDA tensor'):
        si._launch(z, packed, 0, 3, True)


@pytest.mark.parametrize('d', [2, 5])
def test_kernel_param_layout(d):
    """The flat buffer follows the layout csrc/spline_inverse.cu reads:
    per block s, t, W^-1, then f2 and f1 as (w, b) x 4 with JAX's
    (n_in, n_out) weights, then the constant logdet."""
    tm = build_flow(d, hidden_dim=16, device='cpu')
    packed = pack_inverse_consts(tm)
    flat = si.pack_kernel_params(packed)
    pos = 0

    def take(t):
        nonlocal pos
        n = t.numel()
        assert torch.equal(flat[pos:pos + n], t.reshape(-1))
        pos += n

    cut = d - d // 2
    for blk in packed['blocks']:
        take(blk['s'])
        take(blk['t'])
        take(blk['winv'])
        sc = blk['sc']
        for net, n_in, n_out in ((sc.f2, d - cut, cut * 23),
                                 (sc.f1, cut, (d - cut) * 23)):
            assert net.sizes == (n_in, 16, 16, 16, n_out)
            for w, b in zip(net.w, net.b):
                take(w)
                take(b)
    take(packed['const_logdet'].reshape(1))
    assert pos == flat.numel()
    assert si.rows_per_block(256, 50, 64, 8) >= 1


def test_is_fusable():
    assert is_fusable_spline(build_flow(4, device='cpu'))
    assert not is_fusable_spline(torch.nn.Linear(2, 2))
