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
from nnest_tpu.ops.pallas_spline import (
    make_pallas_inverse, pack_pallas_consts, pallas_inverse_per_block)
from nnest_torch.flows import build_flow
from nnest_torch.ops import spline_inverse as si
from nnest_torch.ops.fused_spline import (
    _inverse_body, is_fusable_spline, pack_inverse_consts)
from tests.test_torch_flows import flow_pair

# One intra-op thread a process: the suite runs in parallel workers that
# share the cores.
torch.set_num_threads(1)


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


@pytest.mark.parametrize('d', [5, 16])
def test_per_block_matches_pallas_interpret(d):
    """The per-block wrapper's CPU twin against pallas_inverse_per_block
    (one Pallas launch per flow block, chained) in interpret mode."""
    jm, params, tm = flow_pair(d)
    z = _z(70, d)  # 70 rows at tile 32: the Pallas pad path
    consts, meta = pack_pallas_consts(jm, params)
    xj, ldj = pallas_inverse_per_block(consts, meta, jnp.asarray(z),
                                       tile=32, interpret=True)
    before = si.launches_per_block
    xt, ldt = si.spline_inverse_per_block(torch.from_numpy(z),
                                          pack_inverse_consts(tm))
    assert si.launches_per_block == before
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=3e-5,
                               atol=3e-5)
    np.testing.assert_allclose(ldt.numpy(), np.asarray(ldj), rtol=3e-4,
                               atol=3e-4)


@pytest.mark.parametrize('d', [2, 5])
def test_kernel_param_layout(d):
    """The flat buffer follows the padded layout csrc/spline_inverse.cu
    reads: per block f2 and f1 as (w, b) x 4 with JAX's (n_in, n_out)
    weights, then W^-1, t, s; every weight row and every array padded with
    zeros to a multiple of 4 floats; then the constant logdet, padded."""
    tm = build_flow(d, hidden_dim=16, device='cpu')
    packed = pack_inverse_consts(tm)
    flat = si.pack_kernel_params(packed)
    layers, bfloats = si.kernel_layout(d, 16, 8)
    pos = 0

    def take(t, n4):
        """A (rows, n) array at pos, each row padded with zeros to n4."""
        nonlocal pos
        assert pos % 4 == 0 and n4 % 4 == 0 and n4 - 4 < t.shape[-1] <= n4
        t = t.reshape(-1, t.shape[-1])
        got = flat[pos:pos + t.shape[0] * n4].view(t.shape[0], n4)
        assert torch.equal(got[:, :t.shape[1]], t)
        assert torch.count_nonzero(got[:, t.shape[1]:]) == 0
        pos += t.shape[0] * n4

    cut = d - d // 2
    for b, blk in enumerate(packed['blocks']):
        sc = blk['sc']
        mats = []
        for net, n_in, n_out in ((sc.f2, d - cut, cut * 23),
                                 (sc.f1, cut, (d - cut) * 23)):
            assert net.sizes == (n_in, 16, 16, 16, n_out)
            mats += [(w, [bias]) for w, bias in zip(net.w, net.b)]
        mats.append((blk['winv'], [blk['t'], blk['s']]))
        assert len(mats) == len(layers)
        for l, (w, tails) in zip(layers, mats):
            assert pos == b * bfloats + l['w']
            take(w, l['n4'])
            assert pos == b * bfloats + l['tail']
            for t in tails:
                take(t.reshape(1, -1), l['n4'])
        assert pos == (b + 1) * bfloats
    take(packed['const_logdet'].reshape(1, 1), 4)
    assert pos == flat.numel()


def test_is_fusable():
    assert is_fusable_spline(build_flow(4, device='cpu'))
    assert not is_fusable_spline(torch.nn.Linear(2, 2))
