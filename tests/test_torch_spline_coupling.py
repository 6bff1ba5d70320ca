"""The spline coupling's training transform (``ops/spline_coupling.py``).

On the CPU: the hand-derived backward's plain twin against autograd through
the coupling's plain code in float64, at the benchmark cells' half-shapes
(100 rows x 8, 25, 1 and 14 dims) and K 5 and 8, with inputs in both tails,
exactly at +-B, on interior knots and at theta's clamp bounds; a CPU
``SplineCoupling.forward`` bit for bit the plain code it was; the wrappers'
refusals; the trainer's ``train_step`` counter on the CPU.

On a card (``cuda`` marker; run with ``python -m pytest --noconftest -m
cuda tests/test_torch_spline_coupling.py``): the kernel pair against the
plain version and float64 autograd, two launches bit-equal, a graphed
training step bit-equal to the same step run eagerly, a short training all
``fused``, and the Jacobian oracle on a card flow.
"""

import math

import pytest
import torch

from nnest_torch.bijectors import SplineCoupling
from nnest_torch.bijectors.rqs import conditioner_knots, knots, rqs
from nnest_torch.ops import spline_coupling as sc

# One intra-op thread a process: the suite runs in parallel workers that
# share the cores.
torch.set_num_threads(1)

B = 3.0
SHAPES = [(100, 8), (100, 25), (100, 1), (100, 14)]
BINS = [5, 8]


def _inputs(rows, n, K, seed, dtype=torch.float64, device='cpu'):
    """Raw conditioner outputs at the scale of an MLP's and x (rows, n)
    with rows in both tails, at -B and B, on interior knots and the rest
    within the bound. Returns (raw, x, knot_rows)."""
    g = torch.Generator().manual_seed(seed)
    raw = 0.7 * torch.randn(rows, n * (3 * K - 1), generator=g,
                            dtype=torch.float64)
    x = 2.0 * torch.randn(rows, n, generator=g, dtype=torch.float64)
    x[0], x[1] = 3.5, -4.0          # the tails
    x[2], x[3] = B, -B              # the bounds: theta 1 and 0
    cw, _ = knots(*conditioner_knots(raw.reshape(rows, n, 3 * K - 1), K, B)
                  [:2], B)
    x[4] = cw[4, :, 1]              # interior knots: theta 0 in their bin
    x[5] = cw[5, :, K - 1]
    x[6] = cw[6, :, K // 2]
    return (raw.to(device=device, dtype=dtype),
            x.to(device=device, dtype=dtype), [4, 5, 6])


def _autograd(raw, x, gy, gl, K):
    raw = raw.detach().double().requires_grad_()
    x = x.detach().double().requires_grad_()
    y, ld = sc.coupling_rqs_plain(raw, x, K, B)
    return torch.autograd.grad(
        torch.sum(y * gy.double()) + torch.sum(ld * gl.double()), (raw, x))


@pytest.mark.parametrize('rows,n', SHAPES)
@pytest.mark.parametrize('K', BINS)
def test_backward_twin_matches_autograd(K, rows, n):
    raw, x, _ = _inputs(rows, n, K, seed=10 * K + n)
    g = torch.Generator().manual_seed(n)
    gy = torch.randn(rows, n, generator=g, dtype=torch.float64)
    gl = torch.randn(rows, generator=g, dtype=torch.float64)
    want_raw, want_x = _autograd(raw, x, gy, gl, K)
    got_raw, got_x = sc.coupling_rqs_backward_plain(raw, x, gy, gl, K, B)
    assert got_raw.shape == raw.shape and got_x.shape == x.shape
    torch.testing.assert_close(got_raw, want_raw, rtol=0, atol=1e-12)
    torch.testing.assert_close(got_x, want_x, rtol=0, atol=1e-12)
    # the tails: d/dx is gy and the conditioner gets nothing
    per = 3 * K - 1
    assert torch.equal(got_x[:2], gy[:2])
    assert not got_raw[:2].any()
    # inside, every raw output of a dim gets a gradient (the derivatives'
    # only where the bin's two knots are interior: not checked here)
    assert got_raw.reshape(rows, n, per)[2:, :, :2 * K].abs().sum() > 0


def _plain_forward(coupling, x):
    """``SplineCoupling.forward`` as the plain code wrote it."""
    lower, upper = coupling._split(x)
    W, H, D = coupling.knots(coupling.f1, lower, upper.shape[1])
    upper, ld1 = rqs(upper, W, H, D, inverse=False,
                     tail_bound=coupling.tail_bound)
    W, H, D = coupling.knots(coupling.f2, upper, lower.shape[1])
    lower, ld2 = rqs(lower, W, H, D, inverse=False,
                     tail_bound=coupling.tail_bound)
    return (torch.cat([lower, upper], dim=1),
            torch.sum(ld1, dim=-1) + torch.sum(ld2, dim=-1))


@pytest.mark.parametrize('d,K', [(16, 8), (50, 8), (2, 8), (28, 5)])
def test_cpu_coupling_forward_is_the_plain_code_bit_for_bit(d, K):
    coupling = SplineCoupling(d, num_bins=K, hidden=16,
                              generator=torch.Generator().manual_seed(d))
    x = 2.0 * torch.randn(100, d, generator=torch.Generator().manual_seed(1))
    x[0, 0], x[1, -1] = 4.0, -B
    before = sc.launches
    outs, grads = [], []
    for fn in (coupling.forward, lambda v: _plain_forward(coupling, v)):
        xg = x.clone().requires_grad_()
        y, ld = fn(xg)
        coupling.zero_grad()
        (torch.sum(y ** 2) + torch.sum(ld)).backward()
        outs.append((y.detach(), ld.detach()))
        grads.append([xg.grad] + [p.grad.clone()
                                  for p in coupling.parameters()])
    assert sc.launches == before
    for a, b in zip(outs[0] + tuple(grads[0]), outs[1] + tuple(grads[1])):
        assert torch.equal(a, b)


def _f32(rows=4, n=3, K=8):
    return (torch.zeros(rows, n * (3 * K - 1)), torch.zeros(rows, n))


@pytest.mark.parametrize('case,match', [
    ('bins_low', 'bins'), ('bins_high', 'bins'), ('dtype_raw', 'float32'),
    ('dtype_x', 'float32'), ('raw_width', 'raw'), ('rows', 'raw'),
    ('x_1d', 'raw'), ('raw_layout', 'contiguous'), ('x_layout', 'rows'),
    ('too_wide', 'at most'), ('device', 'CUDA')])
def test_wrappers_refuse_what_the_kernels_do_not_take(case, match):
    raw, x, K = *_f32(), 8
    if case == 'bins_low':
        raw, x, K = *_f32(K=1), 1
    elif case == 'bins_high':
        raw, x, K = *_f32(K=17), 17
    elif case == 'dtype_raw':
        raw = raw.double()
    elif case == 'dtype_x':
        x = x.half()
    elif case == 'raw_width':
        raw = raw[:, :-1].contiguous()
    elif case == 'rows':
        raw = raw[:-1]
    elif case == 'x_1d':
        x = x[:, 0]
    elif case == 'raw_layout':
        raw = torch.zeros(raw.shape[1], raw.shape[0]).t()
    elif case == 'x_layout':
        x = torch.zeros(x.shape[1], x.shape[0]).t()
    elif case == 'too_wide':
        raw, x = _f32(rows=1, n=sc.MAX_DIMS + 1)
    with pytest.raises(ValueError, match=match):
        sc.forward_kernel(raw, x, K, B)
    if x.dim() == 2:
        gl = torch.zeros(raw.shape[0])
        with pytest.raises(ValueError, match=match):
            sc.backward_kernel(raw, x, torch.zeros_like(x), gl, K, B)


def test_backward_wrapper_refuses_a_wrong_gradient():
    raw, x = _f32()
    with pytest.raises(ValueError, match='gl'):
        sc.backward_kernel(raw, x, torch.zeros_like(x), torch.zeros(5), 8, B)
    with pytest.raises(ValueError, match='gy'):
        sc.backward_kernel(raw, x, torch.zeros(4, 3).double(),
                           torch.zeros(4), 8, B)


def test_torch_func_refuses_the_kernel_pair():
    """The Jacobian oracle (``flows/testing.py``, ``torch.func.jacrev``)
    cannot batch the pair's backward, which reads raw pointers: torch.func
    refuses the Function before its forward runs, with a clear error."""
    raw, x = _f32(rows=1, n=1)
    with pytest.raises(RuntimeError, match='autograd.Function'):
        torch.func.jacrev(
            lambda v: sc._CouplingRQS.apply(raw, v, 8, B)[0])(x)


def test_cpu_training_counts_its_steps_plain():
    from nnest_torch import Trainer
    from nnest_torch.utils.profiling import recording
    x = torch.randn(95, 4, generator=torch.Generator().manual_seed(2))
    t = Trainer(4, hidden_dim=16, batch_size=20, log=False, seed=3,
                device='cpu')
    before = sc.launches
    with recording() as rec:
        t.train(x.numpy(), max_iters=3, patience=50)
    # 85 training rows at batch 20: 5 steps an epoch
    assert rec.counters['train_step'] == {'plain': 3 * 5}
    assert sc.launches == before


# ------------------------------------------------------------------ card

def _needs_gpu():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA GPU: the kernel pair has no CPU mode')


@pytest.mark.cuda
@pytest.mark.parametrize('rows,n', SHAPES)
@pytest.mark.parametrize('K', BINS)
def test_kernel_pair_matches_the_plain_version(K, rows, n):
    _needs_gpu()
    raw, x, knot_rows = _inputs(rows, n, K, seed=K + n, dtype=torch.float32,
                                device='cuda')
    y_p, ld_p = sc.coupling_rqs_plain(raw, x, K, B)
    before = sc.launches
    y_k, ld_k = sc.forward_kernel(raw, x, K, B)
    g = torch.Generator(device='cuda').manual_seed(n)
    gy = torch.randn(rows, n, generator=g, device='cuda')
    gl = torch.randn(rows, generator=g, device='cuda')
    graw, gx = sc.backward_kernel(raw, x, gy, gl, K, B)
    torch.cuda.synchronize()
    assert sc.launches == before + 2
    # the spline inverse kernel's allowances against its twin
    # (test_torch_cuda.py): in a steep bin float32's rounding of the knots
    # moves y by ~1e-5 in the plain version and the kernel alike, and at an
    # exact knot the two may take neighbouring bins, where the logdet's
    # slope jumps (~2e-4 at K = 5)
    assert float((y_k - y_p).abs().max()) <= 3e-5
    assert float((ld_k - ld_p).abs().max()) <= 3e-4
    want_raw, want_x = _autograd(raw.cpu(), x.cpu(), gy.cpu(), gl.cpu(), K)
    # off the knots, where float32 and float64 may pick neighbouring bins
    # (the logdet's gradient jumps there)
    keep = torch.ones(rows, dtype=torch.bool)
    keep[knot_rows] = False
    for got, want in ((graw, want_raw), (gx, want_x)):
        got, want = got.cpu().double()[keep], want[keep]
        assert float((got - want).abs().max()) <= \
            1e-4 * float(want.abs().max())


@pytest.mark.cuda
def test_two_launches_are_bit_equal():
    _needs_gpu()
    raw, x, _ = _inputs(100, 25, 8, seed=3, dtype=torch.float32,
                        device='cuda')
    gy, gl = torch.ones_like(x), torch.ones(100, device='cuda')
    first = sc.forward_kernel(raw, x, 8, B) + \
        sc.backward_kernel(raw, x, gy, gl, 8, B)
    second = sc.forward_kernel(raw, x, 8, B) + \
        sc.backward_kernel(raw, x, gy, gl, 8, B)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_graphed_step_is_bit_equal_to_the_eager_step():
    _needs_gpu()
    from nnest_torch import Trainer
    x = torch.randn(300, 16, generator=torch.Generator().manual_seed(4))
    trainers = []
    for graphs in (True, False):
        t = Trainer(16, hidden_dim=16, batch_size=100, log=False, seed=5)
        t._use_graphs = graphs
        t.ensure_init(x.numpy())
        trainers.append(t)
    batch = x[:100].cuda()
    w = torch.ones(100, device='cuda')
    # a training kernel pair: the spline chain's, or the coupling's
    from nnest_torch.training.trainer import _launches
    before = _launches()
    graphed = trainers[0]._graphed_step(100, 1e-3)
    assert graphed.path == 'fused' and _launches() > before
    for _ in range(2):
        nll_g = graphed(batch, w)
        nll_e = trainers[1]._step(batch, w, 1e-3)
        assert torch.equal(nll_g, nll_e)
    for a, b in zip(trainers[0].model.parameters(),
                    trainers[1].model.parameters()):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_short_training_on_the_card_is_fused():
    _needs_gpu()
    from nnest_torch import Trainer
    from nnest_torch.utils.profiling import recording
    x = torch.randn(500, 30, generator=torch.Generator().manual_seed(6))
    t = Trainer(30, hidden_dim=16, batch_size=100, log=False, seed=7,
                num_slow=2)
    # a training kernel pair: the spline chain's, or the coupling's
    from nnest_torch.training.trainer import _launches
    before = _launches()
    with recording() as rec:
        t.train(x.numpy(), max_iters=3, patience=50)
    assert _launches() > before
    assert rec.counters['train_step'] == {'fused': 3 * 5}


@pytest.mark.cuda
def test_jacobian_oracle_on_a_card_flow_matches_or_refuses():
    _needs_gpu()
    from nnest_torch.flows import build_flow
    from nnest_torch.flows.testing import brute_force_forward_logdet
    model = build_flow(3, hidden_dim=16, seed=0, device='cpu')
    x = 1.5 * torch.randn(4, 3, generator=torch.Generator().manual_seed(8))
    want = brute_force_forward_logdet(model, x)
    try:
        got = brute_force_forward_logdet(model.to('cuda'), x.cuda())
    except RuntimeError as e:
        assert 'autograd.Function' in str(e)
        return
    assert math.isclose(float((got.cpu() - want).abs().max()), 0.0,
                        abs_tol=1e-3)
