"""The single-speed NVP flow's hot inverse: the NVP kernel's twin, packing
and launch plan on the CPU, the kernel on the card.

``ops.nvp_inverse.nvp_inverse`` launches ``csrc/nvp_inverse.cu`` for a
CUDA tensor and runs the plain twin ``nvp_inverse_twin`` (which reads the
same packed buffer with the same offsets) for a CPU tensor. On the CPU, at
d 5 and 6 (both parities of the last coupling's mask), hidden 8, 3 and 4
blocks, ``scale`` '', ``'translate'`` and ``'constant'``, on seeded
weights moved off their init:

- the twin matches the flow's own ``inverse`` within the fused tolerance
  (2e-5 in x, 2e-4 in logdet, as tests/test_torch_fused.py holds the
  spline twin: float32 products summed in another order on the card);
- both match the benchmark's float64 reference of the flow
  (``portbench/reference/flows/nvp.py``, which imports nothing of the
  port) within the same tolerance: float32 against float64;
- ``is_fusable_nvp`` is true for the layouts the kernel takes and false
  for every other;
- ``LatentKernels._hot_inverse`` takes the ``nvp`` path and counts each
  call under the recorder's ``hot_inverse`` counter;
- the launch plan fits a block's shared memory at every width the kernel
  takes.

The ``cuda`` cases need a card: the kernel against its twin at d 50,
hidden 16 and 64, at 1, 256 and 4097 rows, one launch a call and no twin
call, each row bit for bit the same at a second batch size; within the
kernel's contract on the card (3e-5 in x, 3e-4 in logdet, as
chip_smoke.py holds the spline kernel to its twin, relative to
max(1, |value|)). Run them with
``python -m pytest --noconftest -m cuda tests/test_torch_nvp_inverse.py``;
this file never imports JAX."""

import os
import sys

import pytest
import torch

from nnest_torch.flows import build_flow
from nnest_torch.ops import nvp_inverse as nv
from nnest_torch.samplers.kernels import LatentKernels
from nnest_torch.utils.profiling import recording

# One intra-op thread a process: the suite runs in parallel workers that
# share the cores.
torch.set_num_threads(1)

PORTBENCH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'portbench')
TOL_X = 2e-5
TOL_LOGDET = 2e-4
# The kernel against its twin on the card: the spline kernel's contract
# there (chip_smoke.py's), float32 products and sums in the kernel's order
# against cuBLAS's, on weights moved by N(0, 0.1^2) as chip_smoke.py moves
# them; relative to max(1, |value|), since an NVP flow's x is unbounded
# (|x| reaches 30 at hidden 64) and float32 keeps a relative precision.
CARD_X, CARD_LOGDET, CARD_SPREAD = 3e-5, 3e-4, 0.1
LAYOUTS = [(d, blocks, scale) for d in (5, 6) for blocks in (3, 4)
           for scale in ('', 'translate', 'constant')]


def _reference():
    if PORTBENCH not in sys.path:
        sys.path.append(PORTBENCH)
    from reference.flows import nvp
    return nvp


def _flow(d=5, blocks=3, scale='', hidden=8, seed=3, device='cpu',
          spread=0.3):
    model = build_flow(d, flow='nvp', hidden_dim=hidden, num_blocks=blocks,
                       scale=scale, seed=seed, device='cpu')
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(spread * torch.randn(p.shape, generator=g))
    return model.to(device)


def _z(n, d, seed=1, device='cpu'):
    g = torch.Generator().manual_seed(seed)
    return (2.0 * torch.randn(n, d, generator=g)).to(device)


def _gap(a, b):
    return float(torch.max(torch.abs(a.double() - b.double())))


def _rel_gap(a, b):
    """The widest gap of ``a`` from ``b`` relative to max(1, |b|)."""
    b = b.double()
    return float(torch.max(torch.abs(a.double() - b)
                           / torch.clamp(torch.abs(b), min=1.0)))


def _like(x):
    return -0.5 * torch.sum(x * x, dim=-1)


@pytest.mark.parametrize('d,blocks,scale', LAYOUTS)
def test_twin_matches_the_flows_inverse(d, blocks, scale):
    model = _flow(d, blocks, scale)
    z = _z(100, d)
    calls, launches = nv.calls, nv.launches
    with torch.no_grad():
        x0, ld0 = model.inverse(z)
    x1, ld1 = nv.nvp_inverse(z, nv.pack_nvp_consts(model))
    # a CPU tensor runs the twin, once, and launches nothing
    assert (nv.calls, nv.launches) == (calls + 1, launches)
    assert _gap(x1, x0) <= TOL_X
    assert _gap(ld1, ld0) <= TOL_LOGDET
    if scale == 'translate':
        assert torch.equal(ld1, torch.zeros_like(ld1))


@pytest.mark.parametrize('d,blocks,scale', LAYOUTS)
def test_both_inverses_match_the_float64_reference(d, blocks, scale):
    ref = _reference()
    model = _flow(d, blocks, scale, seed=5)
    z = _z(100, d, seed=2)
    state = {k: v.double() for k, v in model.state_dict().items()}
    with torch.no_grad():
        xr, ldr = ref.inverse(state, z.double())
        x0, ld0 = model.inverse(z)
    x1, ld1 = nv.nvp_inverse_fn(model)(z)
    for x, ld in ((x0, ld0), (x1, ld1)):
        assert _gap(x, xr) <= TOL_X
        assert _gap(ld, ldr) <= TOL_LOGDET


@pytest.mark.parametrize('d,kw,want', [
    (5, {}, True), (6, {}, True), (50, {}, True), (64, {}, True),
    (5, {'scale': 'translate'}, True), (5, {'scale': 'constant'}, True),
    (6, {'num_blocks': 4, 'scale': 'constant'}, True),
    (50, {'hidden_dim': 64}, True), (50, {'hidden_dim': 32}, True),
    (2, {}, True), (65, {}, False), (50, {'hidden_dim': 65}, False),
    (5, {'num_layers': 2}, False), (5, {'num_slow': 2}, False),
    (5, {'flow': 'spline'}, False), (5, {'flow': 'cholesky'}, False)])
def test_is_fusable_nvp_by_layout(d, kw, want):
    kw = dict({'flow': 'nvp'}, **kw)
    model = build_flow(d, device='cpu', **kw)
    assert nv.is_fusable_nvp(model) == want


def test_the_packing_is_one_segment_a_coupling_last_first():
    model = _flow(6, 4, 'constant')
    packed = nv.pack_nvp_consts(model)
    off, seg = nv.segment_layout(6, 8, 1)
    assert seg % 4 == 0 and off['scale'] < seg
    assert packed['flat'].numel() == 4 * seg
    assert (packed['d'], packed['hidden'], packed['nets'],
            packed['couplings'], packed['scale']) == (6, 8, 1, 4, True)
    bijs = model.chain.bijectors
    for c in range(4):
        p = packed['flat'][c * seg:(c + 1) * seg]
        coupling, scale = bijs[2 * (3 - c)], bijs[2 * (3 - c) + 1]
        assert torch.equal(p[:6], coupling.mask)
        assert torch.equal(p[off['w02']:off['w02'] + 8 * 6],
                           coupling.t_net.w[2].detach().reshape(-1))
        assert float(p[off['scale']]) == float(scale.s.detach())
        assert torch.equal(p[off['scale'] + 1:],
                           torch.zeros(seg - off['scale'] - 1))


@pytest.mark.parametrize('scale', ['', 'translate', 'constant'])
def test_hot_inverse_takes_the_nvp_path_and_counts_it(scale):
    model = _flow(6, 3, scale, seed=1)
    kern = LatentKernels(model, _like, None)
    z = _z(16, 6)
    with torch.no_grad():
        want = model.inverse(z)
    calls = nv.calls
    with recording() as rec, torch.no_grad():
        inverse = kern._hot_inverse()
        for _ in range(3):
            x, ld = inverse(z)
    assert rec.counters['hot_inverse'] == {'nvp': 3}
    assert nv.calls == calls + 3
    assert _gap(x, want[0]) <= TOL_X
    assert _gap(ld, want[1]) <= TOL_LOGDET


@pytest.mark.parametrize('n,d,hidden', [
    (1, 50, 16), (256, 50, 16), (4097, 50, 16), (256, 50, 64),
    (4097, 64, 64), (65536, 64, 64), (77, 2, 1)])
def test_the_launch_plan_fits_a_block(n, d, hidden):
    for nets in (1, 2):
        plan = nv.launch_plan(n, d, hidden, nets, 3)
        rows = plan['rows']
        assert rows & (rows - 1) == 0 and rows <= nv.MAX_ROWS
        assert plan['grid'] * rows >= n > (plan['grid'] - 1) * rows
        assert 1 <= plan['stages'] <= 3
        assert plan['smem_bytes'] <= nv.MAX_SHARED_BYTES
        assert plan['smem_bytes'] == 4 * (
            plan['stages'] * plan['segment_floats']
            + rows * nv.row_floats(d, hidden))
    # the cell's shape: 128 blocks of 2 rows, every coupling staged at once
    plan = nv.launch_plan(256, 50, 16, 2, 3)
    assert (plan['rows'], plan['grid'], plan['stages']) == (2, 128, 3)


def test_the_kernel_refuses_what_it_does_not_take():
    packed = nv.pack_nvp_consts(_flow(5))
    with pytest.raises(ValueError, match='float32'):
        nv._launch(_z(4, 5).double(), packed)
    with pytest.raises(ValueError, match=r'\(n, 5\)'):
        nv._launch(_z(4, 6), packed)
    with pytest.raises(ValueError, match='contiguous'):
        nv._launch(_z(5, 4).t(), packed)


# ------------------------------------------------------------------ card

def _card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA GPU: the kernel has no CPU mode')
    return torch.device('cuda')


@pytest.mark.cuda
@pytest.mark.parametrize('hidden', [16, 64])
def test_kernel_matches_its_twin_on_the_card(hidden):
    device = _card()
    model = _flow(50, 3, '', hidden=hidden, seed=11, device=device,
                  spread=CARD_SPREAD)
    packed = nv.pack_nvp_consts(model)
    for n in (1, 256, 4097):
        z = _z(n, 50, seed=n, device=device)
        launches, calls = nv.launches, nv.calls
        x, ld = nv.nvp_inverse(z, packed)
        torch.cuda.synchronize()
        assert (nv.launches, nv.calls) == (launches + 1, calls)
        xt, ldt = nv.nvp_inverse_twin(z, packed)
        assert _rel_gap(x, xt) <= CARD_X
        assert _rel_gap(ld, ldt) <= CARD_LOGDET
        if n > 77:
            # another batch size: each row on its own
            x2, ld2 = nv.nvp_inverse(z[:77].contiguous(), packed)
            assert torch.equal(x2, x[:77]) and torch.equal(ld2, ld[:77])


@pytest.mark.cuda
@pytest.mark.parametrize('scale', ['translate', 'constant'])
def test_kernel_takes_every_scale_on_the_card(scale):
    device = _card()
    model = _flow(50, 3, scale, hidden=16, seed=12, device=device,
                  spread=CARD_SPREAD)
    z = _z(256, 50, device=device)
    with recording() as rec:
        x, ld = LatentKernels(model, _like, None)._hot_inverse()(z)
    torch.cuda.synchronize()
    assert rec.counters['hot_inverse'] == {'nvp': 1}
    with torch.no_grad():
        xm, ldm = model.inverse(z)
    assert _rel_gap(x, xm) <= CARD_X
    assert _rel_gap(ld, ldm) <= CARD_LOGDET
