"""The fast-slow spline flow's hot inverse on the spline kernel.

``ops.spline_inverse.fast_slow_inverse`` runs the combine coupling's
inverse in plain PyTorch and then each chain through the spline kernel's
entry (``_launch`` on a card, each chain's twin ``_inverse_body`` on the
CPU). On the CPU, on seeded weights moved off their ``data_init`` values,
at d 5 with 2 slow dims:

- it matches the flow's own ``inverse`` within the fused tolerance (2e-5
  in x, 2e-4 in logdet, as tests/test_torch_fused.py holds the twin);
- both match the benchmark's float64 reference of the flow
  (``portbench/reference/flows/fastslow_spline.py``, which imports nothing
  of the port);
- ``is_fusable_fast_slow`` is true for two spline chains of two dims or
  more and false for every other layout;
- ``LatentKernels._hot_inverse`` takes the path and counts each call
  under the recorder's ``hot_inverse`` counter by path (that it leaves the
  slow dims of x bit for bit under fast-only moves on the CPU is
  tests/test_torch_other_flows.py's
  ``test_slow_dims_are_bit_exact_under_fast_moves``, whose spline flow now
  takes this path).

The ``cuda`` case needs a card: the kernel, two launches a call and no
twin call, the slow dims bit for bit under fast-only moves, also at
another batch size. Run it with ``python -m pytest --noconftest -m cuda
tests/test_torch_fast_slow_fused.py``; this file never imports JAX."""

import os
import sys

import pytest
import torch

from nnest_torch.flows import build_flow
from nnest_torch.ops import fused_spline
from nnest_torch.ops import spline_inverse as si
from nnest_torch.ops.fused_spline import (is_fusable_fast_slow,
                                          is_fusable_spline,
                                          pack_fast_slow_consts)
from nnest_torch.samplers.kernels import LatentKernels
from nnest_torch.utils.profiling import recording

# One intra-op thread a process: the suite runs in parallel workers that
# share the cores.
torch.set_num_threads(1)

PORTBENCH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'portbench')
TOL_X = 2e-5
TOL_LOGDET = 2e-4


def _reference():
    if PORTBENCH not in sys.path:
        sys.path.append(PORTBENCH)
    from reference.flows import fastslow_spline
    return fastslow_spline


def _flow(d=5, num_slow=2, seed=3, device='cpu'):
    model = build_flow(d, num_slow=num_slow, hidden_dim=16, seed=seed,
                       device='cpu')
    g = torch.Generator().manual_seed(seed)
    model.data_init(0.7 * torch.randn(256, d, generator=g) + 0.3)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=g))
    return model.to(device)


def _z(n, d, seed=1, device='cpu'):
    g = torch.Generator().manual_seed(seed)
    return (2.0 * torch.randn(n, d, generator=g)).to(device)


def _like(x):
    return -0.5 * torch.sum(x * x, dim=-1)


@pytest.mark.parametrize('flow,d,num_slow,want', [
    ('spline', 5, 2, True), ('spline', 30, 2, True), ('spline', 6, 3, True),
    ('spline', 5, 1, False), ('spline', 3, 2, False),
    ('nvp', 5, 2, False), ('spline', 5, 0, False), ('cholesky', 5, 0, False)])
def test_is_fusable_fast_slow_by_layout(flow, d, num_slow, want):
    model = build_flow(d, flow=flow, num_slow=num_slow, device='cpu')
    assert is_fusable_fast_slow(model) == want
    # the single-speed test refuses every fast-slow flow, as before
    assert is_fusable_spline(model) == (flow == 'spline' and not num_slow)


def test_composed_inverse_matches_the_flows_inverse():
    model = _flow()
    z = _z(100, 5)
    calls = fused_spline.calls
    with torch.no_grad():
        x0, ld0 = model.inverse(z)
    x1, ld1 = si.fast_slow_inverse(z, pack_fast_slow_consts(model))
    assert fused_spline.calls == calls + 2      # one twin call a chain
    assert float(torch.max(torch.abs(x1 - x0))) <= TOL_X
    assert float(torch.max(torch.abs(ld1 - ld0))) <= TOL_LOGDET
    # the combine coupling passes the slow dims through: the slow chain's
    # twin sees z's slow dims as they are
    xs, _ = fused_spline._inverse_body(
        z[:, :2].contiguous(), pack_fast_slow_consts(model)['slow'])
    assert torch.equal(x1[:, :2], xs)


def test_both_inverses_match_the_float64_reference():
    ref = _reference()
    model = _flow()
    z = _z(100, 5, seed=2)
    state = {k: v.double() for k, v in model.state_dict().items()}
    with torch.no_grad():
        xr, ldr = ref.inverse(state, z.double())
        x0, ld0 = model.inverse(z)
    x1, ld1 = si.fast_slow_inverse_fn(model)(z)
    for x, ld in ((x0, ld0), (x1, ld1)):
        assert float(torch.max(torch.abs(x.double() - xr))) <= TOL_X
        assert float(torch.max(torch.abs(ld.double() - ldr))) <= TOL_LOGDET


@pytest.mark.parametrize('flow,num_slow,path', [
    ('spline', 2, 'fast_slow'), ('spline', 0, 'spline'),
    ('nvp', 2, 'plain'), ('nvp', 0, 'nvp')])
def test_hot_inverse_takes_its_path_and_counts_it(flow, num_slow, path):
    model = build_flow(5, flow=flow, num_slow=num_slow, seed=1,
                       device='cpu')
    kern = LatentKernels(model, _like, None, num_slow=num_slow)
    z = _z(16, 5)
    with torch.no_grad():
        want = model.inverse(z)
    with recording() as rec, torch.no_grad():
        inverse = kern._hot_inverse()
        for _ in range(3):
            x, ld = inverse(z)
    assert rec.counters['hot_inverse'] == {path: 3}
    tol = 0.0 if path == 'plain' else TOL_X
    assert float(torch.max(torch.abs(x - want[0]))) <= tol
    assert float(torch.max(torch.abs(ld - want[1]))) <= 10 * tol


@pytest.mark.cuda
@pytest.mark.parametrize('d', [5, 30])
def test_kernel_path_on_the_card(d):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA GPU: the kernel has no CPU mode')
    model = _flow(d, device='cuda')
    kern = LatentKernels(model, _like, None, num_slow=2)
    inverse = kern._hot_inverse()
    z = _z(256, d, device='cuda')
    launches, calls = si.launches, fused_spline.calls
    with recording() as rec:
        x0, ld0 = inverse(z)
        dz = 0.3 * _z(256, d, seed=9, device='cuda') * kern._fast_mask
        x1, _ = inverse(z + dz)
        # another batch size: each row on its own
        x2, _ = inverse((z + dz)[:77].contiguous())
    torch.cuda.synchronize()
    assert si.launches == launches + 6
    assert fused_spline.calls == calls
    assert rec.counters['hot_inverse'] == {'fast_slow': 3}
    with torch.no_grad():
        xm, ldm = model.inverse(z)
    assert float(torch.max(torch.abs(x0 - xm))) <= 3e-5
    assert float(torch.max(torch.abs(ld0 - ldm))) <= 3e-4
    assert torch.equal(x0[:, :2], x1[:, :2])
    assert torch.equal(x0[:77, :2], x2[:, :2])
    assert not torch.equal(x0[:, 2:], x1[:, 2:])
