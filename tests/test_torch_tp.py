"""Tensor parallelism (tp > 1) of nnest_torch.parallel against nnest_tpu's.

- The sharding tree of a 4-D spline flow at hidden 256, 2 blocks, tp = 2
  names the leaves nnest_tpu's ``params_sharding_tree`` shards over 'tp'
  (the port's tree in the JAX layout of ``flows/convert.py``), at least 4 of
  them; at hidden 32 it names none.
- One spawn of 4 gloo CPU ranks on a (dp = 2, tp = 2) mesh, against
  nnest_tpu on a (dp = 4, tp = 2) mesh of this process's 8 virtual devices
  and against the port unsharded, the flows converted from one JAX
  initialisation (tests/test_tp_sharding.py's model and tolerances):
  ``log_prob`` within atol 2e-5; the NLL gradients within rtol 1e-4, atol
  1e-5 (the frozen permutation ``_P`` apart: the port holds it as a buffer
  without a gradient); 5 Adam steps of ``make_sharded_train_step`` with the
  L2 term, their NLLs within rtol 1e-4; ``make_sharded_mcmc`` (16 chains,
  10 full-MH steps with the dynamic step size, on numpy draws) within 1e-5
  of the unsharded kernel. The ranks hold the same bits, and their
  ``params_to_jax`` (gathered over tp) equals the unsharded flow's.
- On one process: the tree helpers on a dict of arrays; a d = 8 flow with
  its 1x1-conv matrices sharded too (min_dim 8), the other tp rank's
  columns standing in for the group, equal to the unsharded flow.

The ranks are this file run as a script (``__main__``), one subprocess a
rank (tests/test_torch_multiprocess.py's launcher).
"""

import argparse
import json
import os

import numpy as np
import pytest
import torch

from tests.test_torch_multiprocess import launch

# One intra-op thread a process: the suite runs in parallel workers that
# share the cores.
torch.set_num_threads(1)

DIM, HIDDEN, BLOCKS, ROWS = 4, 256, 2, 64
STEPS, LR, L2, JITTER = 5, 1e-3, 1e-4, 0.01
CHAINS, MCMC_STEPS = 16, 10
DP, TP = 2, 2


def _jax_trainer(hidden=HIDDEN):
    """nnest_tpu's Trainer (Adam with the permutation masked, no weight
    decay) initialised on the test data, and the data."""
    from nnest_tpu.training.trainer import Trainer as JaxTrainer
    x = np.random.RandomState(1).normal(size=(ROWS, DIM)).astype(np.float32)
    ref = JaxTrainer(DIM, hidden_dim=hidden, num_blocks=BLOCKS,
                     learning_rate=LR, weight_decay=0.0, log=False,
                     log_dir=None, seed=0)
    ref.ensure_init(x)
    return ref, x


def _port_flow(params=None, hidden=HIDDEN):
    from nnest_torch.flows import build_flow, params_from_jax
    model = build_flow(DIM, hidden_dim=hidden, num_blocks=BLOCKS,
                       device='cpu')
    if params is not None:
        import jax
        params_from_jax(model, jax.tree.map(np.asarray, params))
    return model


def _like(u):
    return -0.5 * torch.sum(u ** 2, dim=-1)


def _prior(u):
    return torch.zeros(u.shape[0], dtype=u.dtype)


def _by_path(tree):
    """{JAX key path: numpy leaf}, the permutation ``_P`` left out."""
    import jax
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]
            if '_P' not in jax.tree_util.keystr(p)}


@pytest.mark.parametrize('hidden', [HIDDEN, 32])
def test_sharding_tree_names_nnest_tpu_leaves(hidden):
    import jax
    from nnest_torch.parallel import Mesh, params_sharding_tree
    from nnest_tpu.parallel import get_mesh as jax_mesh
    from nnest_tpu.parallel.mesh import params_sharding_tree as jax_tree
    ref, _ = _jax_trainer(hidden)
    mesh = Mesh(1, TP, None, 'gloo', 'cpu', 0)   # tp rank 0, no group
    port = jax.tree_util.tree_flatten_with_path(
        params_sharding_tree(_port_flow(ref.params, hidden), mesh),
        is_leaf=lambda l: isinstance(l, slice) or (
            isinstance(l, tuple) and isinstance(l[0], slice)))[0]
    want = jax.tree_util.tree_flatten_with_path(
        jax_tree(ref.params, jax_mesh(jax.devices()[:8], tp=TP)),
        is_leaf=lambda l: hasattr(l, 'spec'))[0]
    assert [p for p, _ in port] == [p for p, _ in want]
    got = [p for p, s in port if s != slice(None)]
    assert got == [p for p, s in want if 'tp' in str(s.spec)]
    if hidden == HIDDEN:
        assert len(got) >= 4
        # tp rank 0 holds the first half of each sharded output
        assert {s for _, s in port if s != slice(None)} == {
            (slice(None), slice(0, HIDDEN // 2))}
    else:
        assert got == []


def test_tree_helpers_take_this_ranks_columns():
    from nnest_torch.parallel import (Mesh, params_sharding_tree,
                                      shard_params, unshard)
    mesh = Mesh(1, TP, None, 'gloo', 'cpu', 1)   # tp rank 1
    tree = {'w': np.arange(2 * 256.0).reshape(2, 256), 'b': np.ones(256),
            'small': [np.ones((3, 4))]}
    assert params_sharding_tree(tree, mesh) == {
        'w': (slice(None), slice(128, 256)), 'b': slice(None),
        'small': [slice(None)]}
    assert params_sharding_tree(tree, mesh, min_dim=512)['w'] == slice(None)
    local = shard_params(tree, mesh)
    np.testing.assert_array_equal(local['w'], tree['w'][:, 128:])
    assert local['b'] is tree['b'] and local['small'][0] is tree['small'][0]
    # a flow with nothing sharded is its own whole view
    model = _port_flow()
    assert unshard(model) is model


class _PairShard:
    """A stand-in for a ColumnShard of tp rank 1 in a one-process test:
    the tp group's other member's columns (rank 0's) are held here, so a
    gather rebuilds the whole tensor."""

    def __init__(self, shard, other):
        self.lo, self.hi, self.cols = shard.lo, shard.hi, shard.cols
        self.index, self.other = shard.index, other

    def gather(self, x):
        return torch.cat([self.other.to(x.dtype), x], dim=-1)

    def matmul(self, x, w):
        return torch.cat([x @ self.other, x @ w], dim=-1)


def test_sharded_flow_sees_whole_weights():
    """A d = 8 flow sharded with min_dim 8, so that its 1x1-conv matrices
    and permutation are sharded as well as its conditioners: its forward,
    inverse, log_prob, packed inverse and exported tree equal the unsharded
    flow's when a gather rebuilds each tensor from this rank's columns and
    the other rank's."""
    from nnest_torch.flows import build_flow, params_to_jax
    from nnest_torch.flows.convert import param_tensors
    from nnest_torch.ops import fused_inverse_fn
    from nnest_torch.parallel import Mesh, shard_params, unshard
    d = 8
    plain = build_flow(d, hidden_dim=16, num_blocks=2, device='cpu', seed=4)
    x = torch.randn(32, d, generator=torch.Generator().manual_seed(1))
    plain.data_init(x)
    model = build_flow(d, hidden_dim=16, num_blocks=2, device='cpu', seed=4)
    model.load_state_dict(plain.state_dict())
    whole = [t.detach().clone() for t in param_tensors(model)]
    shard_params(model, Mesh(1, TP, None, 'gloo', 'cpu', 1), min_dim=d)
    names = {n for n, t in model.named_buffers()
             if getattr(t, 'tp_shard', None) is not None}
    assert names == {'chain.bijectors.1._P', 'chain.bijectors.4._P'}
    for t, full in zip(param_tensors(model), whole):
        if getattr(t, 'tp_shard', None) is not None:
            assert t.shape[1] == full.shape[1] // 2
            t.tp_shard = _PairShard(t.tp_shard,
                                    full[:, :full.shape[1] // 2])
    with torch.no_grad():
        for got, want in ((model(x), plain(x)),
                          (model.inverse(x), plain.inverse(x)),
                          (fused_inverse_fn(model)(x),
                           fused_inverse_fn(plain)(x))):
            torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    import jax
    for a, b in zip(jax.tree.leaves(params_to_jax(model)),
                    jax.tree.leaves(params_to_jax(plain))):
        np.testing.assert_array_equal(a, b)
    copy = unshard(model)
    assert all(getattr(t, 'tp_shard', None) is None
               for t in list(copy.parameters()) + list(copy.buffers()))
    torch.testing.assert_close(copy.log_prob(x), plain.log_prob(x),
                               rtol=0, atol=0)
    # the gradient of a sharded weight is its columns of the whole one
    lp = model.log_prob(x).sum()
    lp.backward()
    plain.log_prob(x).sum().backward()
    w, w_plain = model.chain.bijectors[2].f1.w[1], \
        plain.chain.bijectors[2].f1.w[1]
    torch.testing.assert_close(w.grad, w_plain.grad[:, 8:], rtol=1e-5,
                               atol=1e-6)


# ------------------------------------------------------- the 4-rank spawn

def _problem(tmp_path):
    """nnest_tpu's trainer and data, the port's flow from the same
    parameters, the jittered batches of the training steps and the MCMC
    starts and draws; saved for the ranks."""
    ref, x = _jax_trainer()
    model = _port_flow(ref.params)
    rs = np.random.RandomState(2)
    batches = [x + JITTER * rs.normal(size=x.shape).astype(np.float32)
               for _ in range(STEPS)]
    z0 = rs.normal(size=(CHAINS, DIM)).astype(np.float32)
    with torch.no_grad():
        x0, _ = model.inverse(torch.from_numpy(z0))
    draws = [[(torch.from_numpy(rs.normal(size=(CHAINS, DIM)).astype(
        np.float32)), torch.from_numpy(rs.uniform(size=CHAINS).astype(
            np.float32)), None)] for _ in range(MCMC_STEPS)]
    problem = {'flow': model.state_dict(), 'x': x, 'batches': batches,
               'z0': z0, 'logl0': _like(x0).numpy(),
               'lp0': np.zeros(CHAINS, np.float32), 'draws': draws}
    path = str(tmp_path / 'problem.pt')
    torch.save(problem, path)
    return ref, problem, path


def _grads_tree(model):
    """The NLL gradient of each leaf in the JAX layout (the gradient of a
    sharded leaf gathered over tp)."""
    from nnest_torch.flows.convert import model_tree

    def grad(t):
        g = torch.zeros_like(t) if t.grad is None else t.grad
        shard = getattr(t, 'tp_shard', None)
        return (g if shard is None else shard.gather(g)).numpy().copy()

    return model_tree(model, grad)


def _port_run(model, mesh, problem):
    """On ``mesh`` (a one-rank mesh: unsharded) from the problem's flow:
    log_prob of the data, the NLL gradients, the flow in the JAX layout,
    the NLLs of the training steps; then the sharded Metropolis kernel's
    trajectories on the problem's flow again."""
    from nnest_torch.flows import params_to_jax
    from nnest_torch.parallel import (gather_rows, make_sharded_mcmc,
                                      make_sharded_train_step, shard_batch,
                                      shard_params)
    from nnest_torch.parallel.sharded import (all_reduce_grads, dp_backward,
                                              dp_rows)
    from nnest_torch.samplers.kernels import LatentKernels
    x = torch.from_numpy(problem['x'])
    shard_params(model, mesh)
    out = {'whole': params_to_jax(model)}
    with torch.no_grad():
        rows, _ = shard_batch(x, mesh)
        out['log_prob'] = gather_rows(model.log_prob(rows), mesh,
                                      ROWS).numpy()
    opt = torch.optim.Adam(model.parameters(), lr=LR)
    rows, w_rows = dp_rows(mesh, x, torch.ones(ROWS))
    dp_backward(model, opt, mesh, rows, w_rows, torch.tensor(float(ROWS)),
                0.0, [])
    all_reduce_grads(model.parameters(), mesh)
    out['grads'] = _grads_tree(model)
    step = make_sharded_train_step(model, opt, mesh, l2_norm=L2)
    out['losses'] = [float(step(torch.from_numpy(b)))
                     for b in problem['batches']]

    model = _port_flow()
    model.load_state_dict(problem['flow'])
    run = make_sharded_mcmc(LatentKernels(model, _like, _prior), mesh)
    res = run(None, *(torch.from_numpy(problem[k])
                      for k in ('z0', 'logl0', 'lp0')),
              loglstar=None, step_size=0.5, mcmc_steps=MCMC_STEPS,
              dynamic_step_size=True, collect_chains=True,
              draws=problem['draws'])
    out['mcmc'] = {k: v.numpy() for k, v in res.items()}
    return out


def _jax_run(ref, problem):
    """nnest_tpu on its (dp = 4, tp = 2) mesh: log_prob, the NLL
    gradients, and each training step's loss less its L2 term (the
    problem's jittered batches, the JAX step drawing no jitter)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec
    from nnest_tpu.parallel import get_mesh as jax_mesh
    from nnest_tpu.parallel import make_sharded_train_step as jax_step
    from nnest_tpu.parallel.mesh import params_sharding_tree
    mesh = jax_mesh(jax.devices()[:8], tp=TP)
    model = ref.model
    params = jax.device_put(ref.params,
                            params_sharding_tree(ref.params, mesh))
    x = jax.device_put(jnp.asarray(problem['x']),
                       NamedSharding(mesh, PartitionSpec('dp')))
    out = {'log_prob': np.asarray(jax.jit(model.log_prob)(params, x)),
           'grads': jax.device_get(jax.jit(jax.grad(
               lambda p, b: -jnp.mean(model.log_prob(p, b))))(params, x))}
    run = jax_step(model, ref._opt, mesh, l2_norm=L2)
    params, opt_state, losses = ref.params, ref._opt_state, []
    for b in problem['batches']:
        l2 = sum(float(np.sum(np.asarray(leaf, np.float64) ** 2))
                 for leaf in jax.tree.leaves(params))
        params, opt_state, loss = run(params, opt_state,
                                      jax.random.PRNGKey(0), jnp.asarray(b))
        losses.append(float(loss) - L2 * l2)
    out['losses'] = losses
    return out


@pytest.fixture(scope='module')
def tp_runs(tmp_path_factory):
    """The 4 ranks' results (rank 0's in full), the port unsharded and
    nnest_tpu, on one problem."""
    from nnest_torch.parallel import get_mesh
    tmp = tmp_path_factory.mktemp('tp')
    ref, problem, path = _problem(tmp)
    out = str(tmp / 'ranks.pt')
    ranks = launch(os.path.abspath(__file__), DP * TP,
                   ['--problem', path, '--out', out], timeout=300)
    plain = _port_flow()
    plain.load_state_dict(problem['flow'])
    return {'ranks': ranks, 'tp': torch.load(out, weights_only=False),
            'plain': _port_run(plain, get_mesh(), problem),
            'jax': _jax_run(ref, problem)}


def test_tp_ranks_hold_the_same_bits(tp_runs):
    ranks = tp_runs['ranks']
    assert [(r['dp_rank'], r['tp_rank']) for r in ranks] == [
        (0, 0), (0, 1), (1, 0), (1, 1)]
    for key in ('log_prob', 'losses', 'samples'):
        assert all(r[key] == ranks[0][key] for r in ranks), key
    # each rank gathered the whole flow, and it is the unsharded one
    import jax
    for a, b in zip(jax.tree.leaves(tp_runs['tp']['whole']),
                    jax.tree.leaves(tp_runs['plain']['whole'])):
        np.testing.assert_array_equal(a, b)


def test_tp_log_prob(tp_runs):
    got = tp_runs['tp']['log_prob']
    np.testing.assert_allclose(got, tp_runs['plain']['log_prob'], rtol=0,
                               atol=2e-5)
    np.testing.assert_allclose(got, tp_runs['jax']['log_prob'], rtol=0,
                               atol=2e-5)


def test_tp_gradients(tp_runs):
    got = _by_path(tp_runs['tp']['grads'])
    for other in ('plain', 'jax'):
        want = _by_path(tp_runs[other]['grads'])
        assert sorted(got) == sorted(want)
        for path in got:
            np.testing.assert_allclose(got[path], want[path], rtol=1e-4,
                                       atol=1e-5, err_msg=other + path)


def test_tp_training_losses(tp_runs):
    got = tp_runs['tp']['losses']
    np.testing.assert_allclose(got, tp_runs['plain']['losses'], rtol=1e-4)
    np.testing.assert_allclose(got, tp_runs['jax']['losses'], rtol=1e-4)
    assert got[-1] < got[0]


def test_tp_sharded_mcmc(tp_runs):
    got, want = tp_runs['tp']['mcmc'], tp_runs['plain']['mcmc']
    for name in ('samples', 'latent', 'loglikes'):
        np.testing.assert_allclose(got[name], want[name], rtol=1e-5,
                                   atol=1e-5, err_msg=name)
    for name in ('accepted', 'ncall'):
        assert int(got[name]) == int(want[name]), name
    np.testing.assert_allclose(got['scale'], want['scale'], rtol=1e-5)
    assert got['samples'].shape == (CHAINS, MCMC_STEPS + 1, DIM)


# ---------------------------------------------------------------- ranks

def _rank_main():
    p = argparse.ArgumentParser()
    p.add_argument('--rank', type=int, required=True)
    p.add_argument('--world', type=int, required=True)
    p.add_argument('--port', type=int, required=True)
    p.add_argument('--problem', required=True)
    p.add_argument('--out', required=True)
    a = p.parse_args()
    torch.set_num_threads(1)
    import torch.distributed as dist
    from nnest_torch.parallel import get_mesh, initialize_distributed
    initialize_distributed(device='cpu',
                           init_method='tcp://localhost:%d' % a.port,
                           world_size=a.world, rank=a.rank, timeout_s=120)
    mesh = get_mesh(dp=DP, tp=TP)
    problem = torch.load(a.problem, weights_only=False)
    model = _port_flow()
    model.load_state_dict(problem['flow'])
    res = _port_run(model, mesh, problem)
    if a.rank == 0:
        torch.save(res, a.out)
    print('RESULT ' + json.dumps({
        'dp_rank': mesh.dp_rank, 'tp_rank': mesh.tp_rank,
        'log_prob': res['log_prob'].tolist(), 'losses': res['losses'],
        'samples': res['mcmc']['samples'].ravel().tolist()}), flush=True)
    dist.destroy_process_group()


if __name__ == '__main__':
    _rank_main()
