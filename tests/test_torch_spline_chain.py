"""A spline chain's training forward as one kernel pair
(``ops/spline_chain.py``, ``csrc/spline_chain.cu``).

On the CPU: the hand-derived backward (``chain_backward_plain``) against
float64 autograd through the plain chain, every gradient (each block's s,
t, assembled W, conditioner weights and biases) and d/dx, at d 2, 16 and 50,
the fast-slow flow's chains (2 dims: 1-dim halves; 28 dims), hidden 16, 32
and 64, K 2, 8 and 16, 1 and 100 rows, with rows far beyond the tail
bound; the autograd binding with its kernels replaced by their plain
versions against autograd through the plain chain (parameters, the conv's
L, U and S through W, and x); the predicate and the launch plan; the
``spline_chain`` counter on a CPU forward and the trainer's path labels.

On a card (``cuda`` marker; run with ``python -m pytest --noconftest -m
cuda tests/test_torch_spline_chain.py``): the kernel pair against the plain
chain and float64 autograd at the cells' shapes (the gradients no farther
from float64 than twice float32's own distance, autograd through the plain
chain in float32 on the CPU and on the card), two launches bit-equal, and
a short training whose captured steps launch the chain's pair.
"""

import copy

import pytest
import torch

from nnest_torch.flows import build_flow
from nnest_torch.ops import spline_chain as sch
from nnest_torch.ops import spline_coupling as sc
from nnest_torch.training import trainer as trainer_mod
from nnest_torch.utils.profiling import recording

# One intra-op thread a process: the suite runs in parallel workers that
# share the cores.
torch.set_num_threads(1)


def _chain(d, hidden, K, seed, num_slow=0, part='slow', dtype=torch.float64,
           device='cpu'):
    """A spline flow's chain (a fast-slow flow's ``part`` chain where
    ``num_slow``), every parameter moved by N(0, 0.1^2) off its init."""
    model = build_flow(d, hidden_dim=hidden, num_bins=K, num_slow=num_slow,
                       seed=seed, device='cpu')
    chain = copy.deepcopy(getattr(model, part) if num_slow else model.chain)
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for p in chain.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=g))
    return chain.to(device=device, dtype=dtype)


def _inputs(rows, d, seed, dtype=torch.float64):
    """x ~ N(0, 2^2) with rows far beyond the tail bound (+-9), dL/dz and
    dL/d row logdet ~ N(0, 1)."""
    g = torch.Generator().manual_seed(seed)
    x = 2.0 * torch.randn(rows, d, generator=g, dtype=torch.float64)
    x[0] = 9.0
    if rows > 1:
        x[1] = -9.0
    gz = torch.randn(rows, d, generator=g, dtype=torch.float64)
    gl = torch.randn(rows, generator=g, dtype=torch.float64)
    return x.to(dtype), gz.to(dtype), gl.to(dtype)


def _autograd(chain, x, gz, gl):
    """Autograd through the plain chain of sum(z gz) + sum(rqs logdet gl),
    each block's assembled W a leaf: (d x, [each tensor's gradient, table
    order])."""
    chain = copy.deepcopy(chain)
    for _, conv, _ in sch._blocks(chain):
        W = conv.assemble().detach().requires_grad_()
        conv.assemble = (lambda W=W: W)
    x = x.clone().requires_grad_()
    tensors = sch.chain_tensors(chain)
    z, logdet = chain(x)
    rqs = logdet - sch.const_logdet(chain)
    got = torch.autograd.grad(torch.sum(z * gz) + torch.sum(rqs * gl),
                              [x] + tensors)
    return got[0], list(got[1:])


# (d, hidden, K, rows, num_slow, part): the cells' shapes (d 16 and 50, the
# fast-slow flow's 2-dim and 28-dim chains at hidden 16, K 8, 100 rows),
# then the other widths, bins and row counts
CASES = [(16, 16, 8, 100, 0, None), (50, 16, 8, 100, 0, None),
         (30, 16, 8, 100, 2, 'slow'), (30, 16, 8, 100, 2, 'fast'),
         (2, 16, 8, 1, 0, None), (16, 32, 2, 1, 0, None),
         (16, 64, 16, 7, 0, None), (50, 16, 16, 1, 0, None),
         (5, 32, 2, 100, 0, None)]


@pytest.mark.parametrize('d,hidden,K,rows,num_slow,part', CASES)
def test_backward_plain_matches_float64_autograd(d, hidden, K, rows,
                                                 num_slow, part):
    chain = _chain(d, hidden, K, seed=d + K, num_slow=num_slow, part=part)
    n = chain.bijectors[0].dim
    x, gz, gl = _inputs(rows, n, seed=rows + n)
    want_x, want = _autograd(chain, x, gz, gl)
    got_x, got = sch.chain_backward_plain(chain, x, gz, gl)
    assert len(got) == len(want) == sch.TENSORS * 3
    for i, (a, b) in enumerate(zip([got_x] + got, [want_x] + want)):
        assert a.shape == b.shape, i
        scale = max(float(b.abs().max()), 1e-12)
        assert float((a - b).detach().abs().max()) <= 1e-9 * scale, i


@pytest.mark.parametrize('d,num_slow,part', [(16, 0, None), (30, 2, 'slow')])
def test_forward_plain_is_the_chain(d, num_slow, part):
    """The kernels' plain forward on their table of tensors: the chain's
    z exactly, and its logdet less the constant."""
    chain = _chain(d, 16, 8, seed=3, num_slow=num_slow, part=part)
    x, _, _ = _inputs(20, chain.bijectors[0].dim, seed=4)
    with torch.no_grad():
        z, logdet = chain(x)
        z2, ld2, inputs = sch.chain_forward_plain(
            sch.chain_tensors(chain), x, sch._shape(chain))
        gap = float((ld2 + sch.const_logdet(chain) - logdet).abs().max())
    assert torch.equal(z, z2) and len(inputs) == 3 and gap <= 1e-12


def _plain_kernels(monkeypatch):
    """The autograd binding's two kernels replaced by their plain versions
    on the kernels' table of tensors, so the CPU runs ``_ChainFn``."""
    def forward(x, tensors, meta, save=False):
        z, logdet, inputs = sch.chain_forward_plain(list(tensors), x, meta)
        return z, logdet, torch.stack(inputs) if save else None

    def backward(saved, tensors, gz, gl, meta, need_x=True):
        gx, grads = sch.backward_plain(list(tensors), saved[0], gz, gl, meta)
        return (gx if need_x else None), grads

    monkeypatch.setattr(sch, 'forward_kernel', forward)
    monkeypatch.setattr(sch, 'backward_kernel', backward)


@pytest.mark.parametrize('d,rows', [(16, 30), (3, 1)])
def test_autograd_binding_gives_autograds_gradients(monkeypatch, d, rows):
    """``_ChainFn`` (its kernels plain) under a loss of z and the whole
    logdet: every parameter's gradient, the conv's L, U and S through the
    assembled W and the constant logdet among them, and d/dx, as autograd
    gives them through the plain chain."""
    chain = _chain(d, 16, 8, seed=d)
    x, gz, gl = _inputs(rows, d, seed=5)
    params = list(chain.parameters())

    def grads(forward):
        xl = x.clone().requires_grad_()
        z, logdet = forward(xl)
        loss = torch.sum(z * gz) + torch.sum(logdet * gl)
        return torch.autograd.grad(loss, [xl] + params)

    want = grads(chain)
    _plain_kernels(monkeypatch)
    # the binding returns the RQS logdet; the constant is the caller's
    got = grads(lambda v: (lambda z, ld: (z, ld + sch.const_logdet(chain)))(
        *sch._ChainFn.apply(v, sch._shape(chain),
                            *sch.chain_tensors(chain))))
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) <= \
            1e-10 * max(1.0, float(b.abs().max()))


def test_torch_func_refuses_the_chain_pair():
    chain = _chain(3, 16, 8, seed=1, dtype=torch.float32)
    x = torch.randn(1, 3)
    with pytest.raises(RuntimeError, match='autograd.Function'):
        torch.func.jacrev(lambda v: sch._ChainFn.apply(
            v, sch._shape(chain), *sch.chain_tensors(chain))[0])(x)


def _sharded(chain):
    chain.bijectors[2].f1.w[3].tp_shard = object()
    return chain


def _wide_blocks(chain):
    chain.bijectors.extend(copy.deepcopy(list(chain.bijectors)) * 2)
    return chain


# (what, flow keywords, the chain, then a change): in, or refused by the
# kernels' limits
PREDICATE = [
    ('d 16', dict(x_dim=16), 'chain', None, True),
    ('d 50', dict(x_dim=50), 'chain', None, True),
    ('fast-slow slow', dict(x_dim=30, num_slow=2), 'slow', None, True),
    ('fast-slow fast', dict(x_dim=30, num_slow=2), 'fast', None, True),
    ('hidden 128, K 16', dict(x_dim=8, hidden_dim=128, num_bins=16),
     'chain', None, True),
    ('a 1-dim chain', dict(x_dim=30, num_slow=1), 'slow', None, False),
    ('K 17', dict(x_dim=16, num_bins=17), 'chain', None, False),
    ('d 129', dict(x_dim=129), 'chain', None, False),
    ('hidden 129', dict(x_dim=16, hidden_dim=129), 'chain', None, False),
    ('9 blocks', dict(x_dim=16), 'chain', _wide_blocks, False),
    ('tp-sharded', dict(x_dim=16), 'chain', _sharded, False),
    ('float64', dict(x_dim=16), 'chain', lambda c: c.double(), False),
]


@pytest.mark.parametrize('what,kw,part,change,fits', PREDICATE,
                         ids=[p[0] for p in PREDICATE])
def test_predicate_takes_spline_chains_within_the_limits(what, kw, part,
                                                         change, fits):
    model = build_flow(seed=0, device='cpu', **kw)
    chain = getattr(model, part)
    if change is not None:
        chain = change(chain)
    assert sch.chain_fits(chain, torch.device('cpu')) is fits
    # a CPU batch always takes the module-by-module forward
    x = torch.zeros(2, chain.bijectors[0].dim)
    assert sch.path(chain, x) == 'plain'
    assert not sch.takes(chain, x)


@pytest.mark.parametrize('flow', ['nvp', 'cholesky'])
def test_other_flows_have_no_spline_chain(flow):
    model = build_flow(16, flow=flow, seed=0, device='cpu')
    assert sch.path(model.chain, torch.zeros(2, 16)) is None
    with recording() as rec:
        model.log_prob(torch.zeros(2, 16))
    assert 'spline_chain' not in rec.counters


def test_cpu_forward_counts_its_chains_plain():
    x = torch.randn(5, 30, generator=torch.Generator().manual_seed(1))
    single = build_flow(30, seed=0, device='cpu')
    fast_slow = build_flow(30, num_slow=2, seed=0, device='cpu')
    with recording() as rec:
        single.log_prob(x)
        fast_slow.log_prob(x)
    assert rec.counters['spline_chain'] == {'plain': 3}


@pytest.mark.parametrize('n,d,hidden,K,backward,rows,grid', [
    (100, 16, 16, 8, True, 1, 100), (100, 50, 16, 8, True, 1, 100),
    (100, 16, 16, 8, False, 1, 100), (1000, 50, 16, 8, False, 8, 125),
    (1000, 50, 16, 8, True, 8, 125), (3, 16, 16, 8, True, 1, 3),
    (256, 2, 16, 8, False, 2, 128), (1000, 128, 128, 16, True, 4, 250),
    (1000, 128, 128, 16, False, 4, 250)])
def test_launch_plan(n, d, hidden, K, backward, rows, grid):
    plan = sch.launch_plan(n, d, hidden, K, backward)
    assert (plan['rows'], plan['grid']) == (rows, grid)
    assert plan['smem_bytes'] == \
        4 * rows * sch.row_floats(d, hidden, K, backward)
    assert plan['smem_bytes'] <= sch.MAX_SHARED_BYTES


@pytest.mark.parametrize('d,hidden,K', [(16, 16, 8), (3, 32, 2), (50, 16, 5)])
def test_tensor_shapes_are_the_chains(d, hidden, K):
    chain = build_flow(d, hidden_dim=hidden, num_bins=K, seed=0,
                       device='cpu').chain
    shapes = [tuple(t.shape) for t in sch.chain_tensors(chain)]
    assert shapes == sch.tensor_shapes(d, hidden, K) * 3


@pytest.mark.parametrize('case,match', [
    ('cpu', 'on one card'), ('float64', 'float32'), ('width', r'\(rows, 16\)'),
    ('tensors', 'tensors a block'), ('shape', 'tensor 3 of block 0')])
def test_wrapper_refuses_what_the_kernels_do_not_take(case, match):
    chain = build_flow(16, seed=0, device='cpu').chain
    tensors = sch.chain_tensors(chain)
    x = torch.zeros(4, 16)
    if case == 'float64':
        x = x.double()
    elif case == 'width':
        x = torch.zeros(4, 15)
    elif case == 'tensors':
        tensors = tensors[:-1]
    elif case == 'shape':
        tensors[3] = tensors[3][:, :3]
    with pytest.raises(ValueError, match=match):
        sch.forward_kernel(x, tensors, sch._shape(chain))


def test_trainer_path_labels_either_pair_fused(monkeypatch):
    before = trainer_mod._launches()
    assert trainer_mod._path(before) == 'plain'
    monkeypatch.setattr(sch, 'launches', sch.launches + 3)
    assert trainer_mod._path(before) == 'fused'
    before = trainer_mod._launches()
    monkeypatch.setattr(sc, 'launches', sc.launches + 2)
    assert trainer_mod._path(before) == 'fused'


# ------------------------------------------------------------------ card

def _needs_gpu():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA GPU: the chain pair has no CPU mode')


def _flat(grads):
    return [grads[0]] + list(grads[1])


def _worst_gap(got, want):
    """The largest gap of any gradient from float64's, relative to that
    gradient's largest magnitude."""
    return max(float((a.detach().double().cpu() - w).abs().max())
               / float(w.abs().max()) for a, w in zip(got, want))


# the cells' chains: (d, hidden, num_slow, part), 100 rows
CARD = [(16, 16, 0, None), (50, 16, 0, None), (30, 16, 2, 'slow'),
        (30, 16, 2, 'fast')]


@pytest.mark.cuda
@pytest.mark.parametrize('d,hidden,num_slow,part', CARD)
def test_kernel_pair_matches_the_plain_chain(d, hidden, num_slow, part,
                                            monkeypatch):
    _needs_gpu()
    chain64 = _chain(d, hidden, 8, seed=d, num_slow=num_slow, part=part)
    n = chain64.bijectors[0].dim
    x64, gz64, gl64 = _inputs(100, n, seed=d)
    chain = copy.deepcopy(chain64).to(device='cuda', dtype=torch.float32)
    x, gz, gl = (t.to(device='cuda', dtype=torch.float32)
                 for t in (x64, gz64, gl64))
    assert sch.takes(chain, x)
    meta = sch._shape(chain)
    tensors = [t.detach() for t in sch.chain_tensors(chain)]
    before = sch.launches
    z, ld, saved = sch.forward_kernel(x, tensors, meta, save=True)
    gx, grads = sch.backward_kernel(saved, tensors, gz, gl, meta)
    again = (sch.forward_kernel(x, tensors, meta, save=True)[:2]
             + (sch.backward_kernel(saved, tensors, gz, gl, meta)[0],))
    torch.cuda.synchronize()
    assert sch.launches == before + 6
    with torch.no_grad():
        z_p, ld_p = chain64(x64)
    ld_p = ld_p - sch.const_logdet(chain64)
    assert float((z.double().cpu() - z_p).abs().max()) <= 1.5e-5 * max(
        1.0, float(z_p.abs().max()))
    assert float((ld.double().cpu() - ld_p).abs().max()) <= 3e-5 * max(
        1.0, float(ld_p.abs().max()))
    want = _flat(_autograd(chain64, x64, gz64, gl64))
    # float32 alone is off float64 by ~1e-4 (d 16) to ~3e-3 (d 50) of the
    # largest gradient on these inputs, its forward's rounding amplified
    # through three blocks: the plain chain's own distance in float32,
    # under autograd on the CPU and on the card (each coupling half on its
    # own pair), is the yardstick
    plain = [_flat(_autograd(copy.deepcopy(chain64).float(), x64.float(),
                             gz64.float(), gl64.float()))]
    monkeypatch.setattr(sch, 'takes', lambda c, v: False)
    plain.append(_flat(_autograd(chain, x, gz, gl)))
    assert _worst_gap([gx] + grads, want) <= \
        2.0 * max(_worst_gap(p, want) for p in plain) + 1e-5
    for a, b in zip((z, ld, gx), again):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_short_training_launches_the_chain_pair():
    _needs_gpu()
    from nnest_torch import Trainer
    x = torch.randn(500, 30, generator=torch.Generator().manual_seed(6))
    t = Trainer(30, hidden_dim=16, batch_size=100, log=False, seed=7,
                num_slow=2)
    before = sch.launches
    with recording() as rec:
        t.train(x.numpy(), max_iters=3, patience=50)
    assert sch.launches > before
    assert rec.counters['train_step'] == {'fused': 3 * 5}
    # ActNorm's data init runs the chains block by block (Chain.data_init),
    # every other forward through the chain's kernel
    assert set(rec.counters['spline_chain']) == {'kernel'}
