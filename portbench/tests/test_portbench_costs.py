"""The frozen cost functions against chip_smoke.py's, at the shapes of the
kernel tables in PERF.md."""

import pytest

import chip_smoke
from harness import costs


@pytest.mark.parametrize('n,d,h', [(256, 16, 32), (512, 16, 32),
                                   (4096, 16, 32), (128, 2, 16),
                                   (256, 50, 64), (4096, 50, 64),
                                   (65536, 16, 32), (16, 16, 256)])
def test_inverse_cost(n, d, h):
    assert costs.inverse_cost(n, d, h) == chip_smoke.inverse_cost(n, d, h, 8,
                                                                  3)
    got = costs.bound_s(*costs.inverse_cost(n, d, h))
    want = chip_smoke.bound_ms(*chip_smoke.inverse_cost(n, d, h, 8, 3))
    assert got[0] * 1e3 == pytest.approx(want[0], rel=1e-12)
    assert got[1] == want[1]


@pytest.mark.parametrize('args', [(1000, 256, 16, 0, 230, 32, 219, 209),
                                  (100, 10, 2, 0, 9, 2, 8, 8),
                                  (1000, 65536, 16, 0, 66, 60, 46, 44),
                                  (60000, 256, 2, 3, 230, 32, 229, 228)])
def test_pool_cost(args):
    assert costs.pool_cost(*args) == chip_smoke.pool_cost(*args)


def test_peaks():
    assert costs.PEAK_F32_FLOPS == chip_smoke.PEAK_F32_FLOPS
    assert costs.PEAK_BYTES_PER_S == chip_smoke.PEAK_BYTES_PER_S
    assert costs.rqs_inverse_ops(8) == chip_smoke.rqs_inverse_ops(8)


def test_forward_and_likelihood_ops():
    # per row: more than the inverse's spline work less the solve, linear
    # in the rows of an epoch
    assert costs.likelihood_ops(16) == 2 * 16 * 16 + 32
    fwd = costs.flow_forward_ops(16, 32)
    assert 0 < fwd < costs.inverse_cost(1, 16, 32)[0] + 3 * 2 * 16 * 16
    assert costs.training_epoch_ops(1000, 16, 32) == 3 * fwd * 900 + fwd * 100
