"""The Metropolis step loop of ``LatentKernels.mcmc`` as CUDA graphs
(``samplers/kernels.py``: ``_step_graphs``, ``_StepGraphs``).

- The selector: on the CPU, and under a mesh, every step runs eagerly and
  the ``mcmc_graph`` counter says so (``eager_steps``; no ``graph_steps``,
  no ``captures``); the one-rank mesh gives the results of no mesh.
- The graphed loop's buffers and bodies, their replays run as plain calls
  on the CPU, give the eager loop's generation bit for bit in every mode:
  constrained and full Metropolis-Hastings, the dynamic step size, two
  proposals a step, derived values, the fast-slow proposal, a flow other
  than the spline, the trajectories of collect-chains mode; the generator
  ends in the eager loop's state, and a second generation of the same
  shape captures nothing.
- On a card (``cuda`` marker; ``python -m pytest --noconftest -m cuda
  tests/test_torch_mcmc_graph.py``), the same with the captured graphs,
  and a prior of the caller's or a one-rank mesh runs eagerly.
"""

import contextlib

import pytest
import torch

from nnest_torch.flows import build_flow
from nnest_torch.parallel import get_mesh
from nnest_torch.priors import UniformPrior
from nnest_torch.samplers import kernels as tk
from nnest_torch.utils import profiling

# One intra-op thread a process: the suite runs in parallel workers that
# share the cores.
torch.set_num_threads(1)

CHAINS, STEPS, DIM = 32, 7, 5

# name: (mcmc options, LatentKernels options, build_flow options); the
# prior flat but where the options give the library's box
CASES = {
    'constrained': (dict(constrained=True, dynamic_step_size=True,
                         cov=True), {}, {}),
    'constrained_static_step': (dict(constrained=True), {}, {}),
    'prior_volume_steps_2': (dict(constrained=True, prior_volume_steps=2,
                                  dynamic_step_size=True, cov=True), {}, {}),
    'full_mh': (dict(dynamic_step_size=True), {}, {}),
    'full_mh_collect': (dict(collect_chains=True), {}, {}),
    'constrained_collect': (dict(constrained=True, collect_chains=True,
                                 prior_volume_steps=2), {}, {}),
    'derived': (dict(constrained=True, dynamic_step_size=True, cov=True),
                dict(num_derived=2), {}),
    'derived_collect': (dict(collect_chains=True, dynamic_step_size=True),
                        dict(num_derived=2), {}),
    'fast_slow': (dict(constrained=True, dynamic_step_size=True),
                  dict(num_slow=2, oversample_rate=0.5),
                  dict(flow='nvp', num_slow=2)),
    'fast_slow_full_mh': (dict(collect_chains=True),
                          dict(num_slow=2, oversample_rate=0.5),
                          dict(flow='nvp', num_slow=2)),
    'nvp': (dict(constrained=True, cov=True), {}, dict(flow='nvp')),
    'box_prior': (dict(constrained=True, dynamic_step_size=True, cov=True),
                  dict(prior_fn=UniformPrior(DIM, -1.5, 1.5)), {}),
    'box_prior_full_mh': (dict(collect_chains=True, dynamic_step_size=True),
                          dict(prior_fn=UniformPrior(DIM, -1.5, 1.5),
                               num_derived=2), {}),
}


def _like(x):
    return -0.5 * torch.sum(x * x, dim=-1) / 0.3


def _like_derived(x):
    return _like(x), torch.stack([torch.sum(x, dim=-1), 2.0 * x[:, 0]], -1)


def _kernels(case, device, **kw):
    _, kern_kw, flow_kw = CASES[case]
    kern_kw = {'prior_fn': None, **kern_kw, **kw}
    model = build_flow(DIM, hidden_dim=16, seed=3, device=device, **flow_kw)
    model.data_init(0.7 * torch.randn(
        256, DIM, generator=torch.Generator().manual_seed(4)).to(device)
        + 0.3)
    like = _like_derived if kern_kw.get('num_derived') else _like
    return tk.LatentKernels(model, like, **kern_kw)


def _generation(kern, case, seed, generator=None):
    """One generation of ``case`` from starts and a live set drawn from
    ``seed``; the chains' numbers from ``generator`` (made from ``seed``
    when None)."""
    opts = dict(CASES[case][0])
    constrained = opts.pop('constrained', False)
    cov = opts.pop('cov', False)
    device = kern._fast_mask.device
    g = torch.Generator().manual_seed(seed)
    z0 = (0.6 * torch.randn(CHAINS, DIM, generator=g)).to(device)
    live = (0.5 * torch.randn(64, DIM, generator=g)).to(device)
    with torch.no_grad():
        x0, _ = kern._hot_inverse()(z0)
        logl0, derived0 = kern.like_fn(x0)
        lp0 = kern.prior_fn(x0)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(seed)
    return kern.mcmc(
        generator, z0, logl0, lp0, derived0=derived0,
        loglstar=float(torch.quantile(logl0, 0.2)) if constrained else None,
        step_size=0.6, mcmc_steps=STEPS, stat_moments=None,
        cov_from=live if cov else None, **opts)


def _assert_equal(a, b):
    assert set(a) == set(b)
    for key in a:
        x, y = torch.as_tensor(a[key]), torch.as_tensor(b[key])
        assert x.dtype == y.dtype and x.shape == y.shape, key
        assert torch.equal(x, y), key


def _recorded(fn):
    with profiling.recording() as rec:
        out = fn()
    return out, rec.counters.get('mcmc_graph', {})


def _eager(kern):
    """``kern`` with its step loop always eager."""
    kern._step_graphs = lambda *args, **kw: contextlib.nullcontext()
    return kern


class _Replay:
    """A graph whose replay calls its body."""

    def __init__(self, body):
        self.replay = body


def _replayed(monkeypatch, kern):
    """``kern`` with the graphed loop on any device, its graphs' bodies
    replayed as plain calls (the captures counted as the real ones are)."""
    def capture(self, bodies):
        profiling.count('mcmc_graph', len(bodies), key='captures')
        return [_Replay(body) for body in bodies]
    monkeypatch.setattr(tk._StepGraphs, '_capture', capture)
    kern._step_graphs = lambda device, mesh, **shape: kern._held_graphs(
        device, **shape)
    return kern


def test_cpu_and_mesh_run_the_eager_loop():
    kern = _kernels('constrained', 'cpu')
    out, counts = _recorded(lambda: _generation(kern, 'constrained', 5))
    assert counts == {'eager_steps': STEPS}
    assert not kern._graphs
    opts = dict(CASES['constrained'][0], mesh=get_mesh())
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(CASES, 'constrained', (opts, {}, {}))
        meshed, counts = _recorded(lambda: _generation(kern, 'constrained',
                                                       5))
    assert counts == {'eager_steps': STEPS}
    _assert_equal(out, meshed)


@pytest.mark.parametrize('case', sorted(CASES))
def test_replayed_graph_bodies_equal_the_eager_loop(case, monkeypatch):
    """The graphed loop on the CPU, each replay a plain call of its body:
    the eager loop's results and generator state, bit for bit, in two
    generations; the second captures nothing."""
    eager, graphed = _kernels(case, 'cpu'), _kernels(case, 'cpu')
    _eager(eager)
    _replayed(monkeypatch, graphed)
    g_eager = torch.Generator().manual_seed(11)
    g_graphed = torch.Generator().manual_seed(11)
    n_graphs = None
    for seed in (5, 6):
        want = _generation(eager, case, seed, g_eager)
        got, counts = _recorded(lambda: _generation(graphed, case, seed,
                                                    g_graphed))
        _assert_equal(got, want)
        assert torch.equal(g_graphed.get_state(), g_eager.get_state())
        assert counts.get('graph_steps') == STEPS
        assert 'eager_steps' not in counts
        if n_graphs is None:
            n_graphs = counts['captures']
            assert n_graphs >= 2
        else:
            assert 'captures' not in counts
    assert len(graphed._graphs) == 1


def test_replayed_graphs_take_given_draws(monkeypatch):
    """Draws given a step (the tests' route) fill the same buffers."""
    case = 'prior_volume_steps_2'
    kern = _replayed(monkeypatch, _kernels(case, 'cpu'))
    eager = _eager(_kernels(case, 'cpu'))
    g = torch.Generator().manual_seed(2)
    draws = [[(torch.randn(CHAINS, DIM, generator=g),
               torch.rand(CHAINS, generator=g), None) for _ in range(2)]
             for _ in range(STEPS)]
    with pytest.MonkeyPatch.context() as mp:
        opts = dict(CASES[case][0], draws=draws)
        mp.setitem(CASES, case, (opts, {}, {}))
        _assert_equal(_generation(kern, case, 4), _generation(eager, case, 4))


# ----------------------------------------------------------------- card

def _needs_gpu():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA GPU: CUDA graphs have no CPU mode')


@pytest.mark.cuda
@pytest.mark.parametrize('case', sorted(CASES))
def test_captured_graphs_equal_the_eager_loop_on_the_card(case):
    """The captured graphs against the eager loop on the card, from the
    same generator seed: every output bit for bit (the trajectories of
    collect-chains mode among them), the generator's state after each of
    two generations, and no capture in the second."""
    _needs_gpu()
    eager = _eager(_kernels(case, 'cuda'))
    graphed = _kernels(case, 'cuda')
    g_eager = torch.Generator(device='cuda').manual_seed(11)
    g_graphed = torch.Generator(device='cuda').manual_seed(11)
    for seed in (5, 6):
        want = _generation(eager, case, seed, g_eager)
        got, counts = _recorded(lambda: _generation(graphed, case, seed,
                                                    g_graphed))
        torch.cuda.synchronize()
        _assert_equal(got, want)
        assert torch.equal(g_graphed.get_state(), g_eager.get_state())
        assert counts.get('graph_steps') == STEPS, counts
        assert 'eager_steps' not in counts
        assert ('captures' in counts) == (seed == 5), counts
    assert len(graphed._graphs) == 1


@pytest.mark.cuda
def test_user_prior_and_mesh_run_eagerly_on_the_card():
    _needs_gpu()
    case = 'constrained'
    kern = _kernels(case, 'cuda')
    flat, counts = _recorded(lambda: _generation(kern, case, 5))
    assert counts.get('graph_steps') == STEPS
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(CASES, case, (dict(CASES[case][0], mesh=get_mesh()), {},
                                 {}))
        meshed, counts = _recorded(lambda: _generation(kern, case, 5))
    assert counts == {'eager_steps': STEPS}
    _assert_equal(meshed, flat)
    user = _kernels(case, 'cuda', prior_fn=lambda u: torch.zeros(
        u.shape[0], device=u.device))
    _, counts = _recorded(lambda: _generation(user, case, 5))
    assert counts == {'eager_steps': STEPS}
    assert not user._graphs
