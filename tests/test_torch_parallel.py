"""nnest_torch.parallel against nnest_tpu.parallel.

- ``broadcast_exact`` across a real 2-rank gloo group on the tree of
  tests/test_parallel.py (counters above 2^24, int64 2^62 + 3, uint64, a
  0-d float64, an empty (0, 5) leaf): every leaf exact.
- The dp-sharded latent Metropolis kernel on 2 ranks against the port's
  unsharded kernel and against nnest_tpu's ``make_sharded_mcmc`` on this
  process's 8-device virtual mesh: the same 4-D Cholesky flow (converted by
  ``flows/convert.py``), the same starts and the same draws (rebuilt from
  JAX's key), 16 chains and 10 steps, rtol and atol 1e-5 as in
  tests/test_parallel.py; with the dynamic step size and without.
- dp training on 2 ranks against one process on the data of
  tests/test_trainer_mesh.py (320 rows, 3 Adam steps an epoch): nnest_tpu
  asserts equality; the port sums its gradients over ranks in another
  order. After 10 epochs the parameters are held to 1e-5 (measured:
  1.8e-7). Over the 25 epochs of tests/test_trainer_mesh.py the training
  amplifies float rounding: one process fed each batch's rows in reverse
  order, the same loss, ends 6.4e-4 from itself, and the 2 ranks end
  5.6e-4 from one process; there the validation loss is held to 1e-4
  relative and the parameters to 5e-3 (the differences are printed).
  ``make_sharded_train_step`` on 2 ranks against the one-rank mesh and
  against nnest_tpu's ``make_sharded_train_step`` from the same flow on
  the same jittered batches: 3 Adam steps with the L2 term (over every
  leaf of the parameter tree, the frozen permutation included), the
  parameters within 1e-5.
- The host-likelihood farm: each of 2 ranks evaluates its half of a batch.
- On one process: the one-rank mesh without a process group gives the
  results of ``mesh=None`` (a nested run with Metropolis or slice
  generations), ``tp > 1`` without a process group raises, ranks on cards
  must give their host's
  layout, the shard helpers pad by repeating row 0,
  and the package exports ``nnest_tpu.parallel``'s names.

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

CHAINS, STEPS, DIM = 16, 10, 4


def _tree():
    return {
        'big_int_as_f64': np.float64(2 ** 53 - 1) * np.ones(3),
        'ncall': np.asarray([16_777_217.0], np.float64),   # 2^24 + 1
        'logl': np.array([-89.72310918473, 1e-300, -1e300], np.float64),
        'key': np.arange(4, dtype=np.uint32),
        'f32': np.asarray([1.5, 2.5], np.float32),
        'empty': np.zeros((0, 5), np.float64),
        'i64': np.asarray([2 ** 62 + 3, -7], np.int64),
        'u64': np.asarray([2 ** 63 + 11], np.uint64),
        'scalar_f64': np.float64(16_777_217.0),             # 0-d leaf
        'ncall_int': 2 ** 24 + 1,
    }


def _run(nproc, *args):
    return launch(os.path.abspath(__file__), nproc, list(args), timeout=240)


def test_broadcast_exact_two_ranks():
    results = _run(2, '--mode', 'broadcast')
    assert [r['exact'] for r in results] == [True, True]


def _mcmc_problem(tmp_path):
    """The JAX flow and kernels, the port's kernels on the converted flow,
    the starts and JAX's draws; the port's flow saved for the ranks."""
    import jax
    import jax.numpy as jnp
    from nnest_torch.flows import build_flow
    from nnest_torch.flows.convert import params_from_jax
    from nnest_torch.samplers import kernels as tk
    from nnest_tpu.flows import build_flow as jax_build_flow
    from nnest_tpu.samplers.kernels import LatentKernels
    from tests.test_torch_mcmc_sampler import _jax_draws

    jm = jax_build_flow(DIM, flow='cholesky')
    x = jnp.asarray(np.random.RandomState(0).normal(size=(CHAINS, DIM)),
                    jnp.float32)
    params = jm.init(jax.random.PRNGKey(0), x)

    def jax_like(u):
        return -0.5 * jnp.sum(u ** 2, -1), jnp.zeros((u.shape[0], 0))

    jkern = LatentKernels(jm, jax_like, lambda u: jnp.zeros(u.shape[0]))
    tm = build_flow(DIM, flow='cholesky', device='cpu')
    params_from_jax(tm, jax.tree.map(np.asarray, params))
    tkern = tk.LatentKernels(tm, _port_like, _port_prior)
    z0 = np.array(jax.random.normal(jax.random.PRNGKey(1), (CHAINS, DIM)))
    x0, _ = jm.inverse(params, jnp.asarray(z0))
    logl0 = np.array(jax_like(x0)[0])
    lp0 = np.zeros(CHAINS, np.float32)
    key = jax.random.PRNGKey(2)
    draws = _jax_draws(key, False, 1, chains=CHAINS, steps=STEPS, dim=DIM)
    path = str(tmp_path / 'problem.pt')
    torch.save({'flow': tm.state_dict(), 'z0': z0, 'logl0': logl0,
                'lp0': lp0, 'draws': draws}, path)
    return jkern, params, key, tkern, z0, logl0, lp0, draws, path


def _port_like(u):
    return -0.5 * torch.sum(u ** 2, dim=-1)


def _port_prior(u):
    return torch.zeros(u.shape[0], dtype=u.dtype)


@pytest.mark.parametrize('dynamic', [True, False])
def test_sharded_mcmc_matches_unsharded_and_jax(tmp_path, dynamic):
    from nnest_tpu.parallel import get_mesh as jax_mesh
    from nnest_tpu.parallel import make_sharded_mcmc as jax_sharded

    (jkern, params, key, tkern, z0, logl0, lp0, draws,
     path) = _mcmc_problem(tmp_path)
    kw = dict(loglstar=None, step_size=0.5, mcmc_steps=STEPS,
              dynamic_step_size=dynamic)
    ref = jax_sharded(jkern, jax_mesh(tp=1))(
        params, key, z0, logl0, np.zeros((CHAINS, 0), np.float32), lp0,
        **kw)
    plain = tkern.mcmc(None, torch.from_numpy(z0), torch.from_numpy(logl0),
                       torch.from_numpy(lp0), collect_chains=True,
                       draws=draws, **kw)
    out = str(tmp_path / 'sharded.pt')
    _run(2, '--mode', 'mcmc', '--problem', path, '--out', out,
         '--dynamic', str(int(dynamic)))
    got = torch.load(out, weights_only=False)
    for name in ('samples', 'latent', 'loglikes'):
        np.testing.assert_allclose(got[name], plain[name].numpy(),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got[name], np.asarray(ref[name]),
                                   rtol=1e-5, atol=1e-5)
    for name in ('accepted', 'ncall'):
        assert int(got[name]) == int(plain[name]) == int(ref[name]), name
    np.testing.assert_allclose(got['scale'], float(ref['scale']),
                               rtol=1e-6)
    # the endpoint mode gathers the trajectories' last state
    np.testing.assert_array_equal(got['final_x'], got['samples'][:, -1])
    assert got['ess'].shape == (DIM,) and np.all(np.isfinite(got['ess']))
    if dynamic:
        assert float(got['scale']) != pytest.approx(0.5)


def _ring_data(n=320):
    """tests/test_trainer_mesh.py's training set."""
    rng = np.random.RandomState(0)
    theta = rng.uniform(0, 2 * np.pi, n)
    return np.stack([2 * np.cos(theta), 2 * np.sin(theta)], 1) \
        + 0.1 * rng.normal(size=(n, 2))


TRAIN_EPOCHS = (10, 25)


def _train(mesh, epochs, reverse_rows=False):
    """(flow parameters, best validation loss) after ``epochs`` epochs;
    ``reverse_rows`` feeds each batch's rows in reverse order (the same
    loss, summed in another order)."""
    from nnest_torch import Trainer
    t = Trainer(2, flow='spline', log_dir=None, log=False,
                learning_rate=1e-3, seed=0, mesh=mesh, device='cpu')
    if reverse_rows:
        step = t._step
        t._step = lambda x, w, l2: step(x.flip(0), w.flip(0), l2)
    t.train(_ring_data(), max_iters=epochs, patience=100, jitter=0.01)
    return t.model.state_dict(), t.best_validation_loss


# the rows divide the JAX mesh's 8 devices and the ranks' 2
STEP_L2, STEP_LR, STEP_JITTER, STEP_ROWS = 1e-4, 1e-3, 0.01, 96


def _step_problem(tmp_path):
    """nnest_tpu's flow and optimizer (Adam with its frozen buffers masked,
    as its Trainer builds it, no weight decay) initialised on the ring
    data, and the port's flow with the same parameters, saved for the
    ranks."""
    import jax
    from nnest_torch import Trainer
    from nnest_torch.flows import params_from_jax
    from nnest_tpu.training.trainer import Trainer as JaxTrainer
    data = _ring_data()
    ref = JaxTrainer(2, hidden_dim=16, learning_rate=STEP_LR,
                     weight_decay=0.0, log=False, log_dir=None, seed=0)
    ref.ensure_init(data)
    port = Trainer(2, hidden_dim=16, log=False, seed=0, device='cpu')
    port.ensure_init(data)
    params_from_jax(port.model, jax.tree.map(np.asarray, ref.params))
    path = str(tmp_path / 'step_problem.pt')
    torch.save(port.model.state_dict(), path)
    return ref, path


def _sharded_steps(mesh, problem, steps=3):
    """The flow after ``steps`` of ``make_sharded_train_step`` (Adam, the
    L2 term on) on the ring data's first rows, from the flow saved in
    ``problem``, jittered from a seeded generator; and the NLLs."""
    from nnest_torch import Trainer
    from nnest_torch.parallel import make_sharded_train_step
    t = Trainer(2, hidden_dim=16, log=False, seed=0, device='cpu')
    batch = torch.as_tensor(_ring_data()[:STEP_ROWS], dtype=torch.float32)
    t.ensure_init(batch)
    t.model.load_state_dict(torch.load(problem))
    opt = torch.optim.Adam(t.model.parameters(), lr=STEP_LR)
    step = make_sharded_train_step(t.model, opt, mesh, l2_norm=STEP_L2)
    g = torch.Generator().manual_seed(1)
    losses = [float(step(batch, jitter=STEP_JITTER, generator=g))
              for _ in range(steps)]
    return t.model.state_dict(), losses


def _jax_steps(ref, steps=3):
    """nnest_tpu's ``make_sharded_train_step`` on this process's virtual
    mesh from ``ref``'s flow and optimizer, on the batches
    :func:`_sharded_steps` makes (its jitter added here, so the JAX step
    draws none): (leaves after the steps, each step's loss less its L2
    term)."""
    import jax
    import jax.numpy as jnp
    from nnest_tpu.parallel import get_mesh as jax_mesh
    from nnest_tpu.parallel import make_sharded_train_step as jax_step
    run = jax_step(ref.model, ref._opt, jax_mesh(tp=1), l2_norm=STEP_L2)
    batch = torch.as_tensor(_ring_data()[:STEP_ROWS], dtype=torch.float32)
    g = torch.Generator().manual_seed(1)
    params, opt_state, nlls = ref.params, ref._opt_state, []
    for _ in range(steps):
        jittered = batch + STEP_JITTER * torch.randn(batch.shape,
                                                     generator=g)
        l2 = sum(float(np.sum(np.asarray(leaf, np.float64) ** 2))
                 for leaf in jax.tree.leaves(params))
        params, opt_state, loss = run(params, opt_state,
                                      jax.random.PRNGKey(0),
                                      jnp.asarray(jittered.numpy()))
        nlls.append(float(loss) - STEP_L2 * l2)
    return [np.asarray(leaf) for leaf in jax.tree.leaves(params)], nlls


def test_dp_training_matches_one_process(tmp_path):
    jax_ref, problem = _step_problem(tmp_path)
    out = str(tmp_path / 'trained_%d.pt')
    _run(2, '--mode', 'train', '--out', out, '--problem', problem)
    ranks = [torch.load(out % r) for r in (0, 1)]
    for epochs, tol in zip(TRAIN_EPOCHS, (1e-5, 5e-3)):
        (got, got_val), (other, other_val) = (r[epochs] for r in ranks)
        ref, ref_val = _train(None, epochs)
        # lockstep: both ranks hold the same bits
        assert got_val == other_val
        worst = 0.0
        for name in ref:
            assert torch.equal(got[name], other[name]), name
            np.testing.assert_allclose(got[name].numpy(), ref[name].numpy(),
                                       rtol=tol, atol=tol, err_msg=name)
            worst = max(worst, float((got[name] - ref[name]).abs().max()))
        assert got_val == pytest.approx(ref_val, rel=1e-4)
        flipped, _ = _train(None, epochs, reverse_rows=True)
        print('dp training, %d epochs on 2 ranks vs one process: max '
              '|dparam| %.3g, validation loss %r vs %r; one process with '
              'its rows reversed vs itself: max |dparam| %.3g'
              % (epochs, worst, got_val, ref_val,
                 max(float((flipped[k] - ref[k]).abs().max())
                     for k in ref)))
    # make_sharded_train_step: 2 ranks against the one-rank mesh and
    # against nnest_tpu's step (the L2 term over every leaf, _P included)
    import jax
    from nnest_torch import Trainer
    from nnest_torch.flows import params_to_jax
    from nnest_torch.parallel import get_mesh
    (got, got_losses), (ref, ref_losses) = ranks[0]['step'], _sharded_steps(
        get_mesh(), problem)
    assert ranks[1]['step'][1] == got_losses
    np.testing.assert_allclose(got_losses, ref_losses, rtol=1e-6)
    for name in ref:
        np.testing.assert_allclose(got[name].numpy(), ref[name].numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    jax_leaves, jax_nlls = _jax_steps(jax_ref)
    np.testing.assert_allclose(got_losses, jax_nlls, rtol=1e-5)
    t = Trainer(2, hidden_dim=16, log=False, seed=0, device='cpu')
    t.ensure_init(_ring_data()[:STEP_ROWS])
    t.model.load_state_dict(got)
    leaves = jax.tree.leaves(params_to_jax(t.model))
    assert len(leaves) == len(jax_leaves)
    for a, b in zip(leaves, jax_leaves):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    print('make_sharded_train_step, 2 ranks vs nnest_tpu: max |dparam| %.3g'
          % max(float(np.max(np.abs(a - b)))
                for a, b in zip(leaves, jax_leaves)))


def test_host_likelihood_farm_splits_rows():
    results = _run(2, '--mode', 'farm')
    assert [r['rows_seen'] for r in results] == [5, 5]
    assert all(r['exact'] for r in results)


# ---------------------------------------------------------- one process

def test_exports_match_nnest_tpu():
    import nnest_torch.parallel as tp
    from nnest_tpu import parallel as jp
    assert set(jp.__all__) | {'broadcast_exact'} <= set(tp.__all__)


def test_one_rank_mesh_and_tensor_parallel_refusal():
    from nnest_torch.parallel import (broadcast_exact, get_mesh,
                                      params_sharding_tree, shard_params)
    mesh = get_mesh()
    assert (mesh.dp, mesh.tp, mesh.group) == (1, 1, None)
    # tp > 1 needs a process group of dp * tp ranks
    with pytest.raises(ValueError, match='world size'):
        get_mesh(tp=2)
    tree = _tree()
    assert broadcast_exact(tree) is tree
    params = {'w': torch.ones(2, 3), 'b': [torch.zeros(3)]}
    assert params_sharding_tree(params, mesh) == {'w': slice(None),
                                                  'b': [slice(None)]}
    assert shard_params(params, mesh) is params


def test_shard_batch_pads_with_row_zero():
    from nnest_torch.parallel import Mesh, batch_sharding, shard_batch
    from nnest_torch.parallel.mesh import real_rows
    x = np.arange(14.0).reshape(7, 2)
    for rank, rows in ((0, [0, 1, 2]), (1, [3, 4, 5]), (2, [6, 0, 0])):
        mesh = Mesh(3, 1, None, 'gloo', 'cpu', rank)
        got, pad = shard_batch(x, mesh)
        assert pad == 2
        np.testing.assert_array_equal(got, x[rows])
        t, _ = shard_batch(torch.from_numpy(x), mesh)
        np.testing.assert_array_equal(t.numpy(), x[rows])
        assert batch_sharding(mesh, 7)[0] == slice(3 * rank, 3 * rank + 3)
        assert real_rows(mesh, 7).tolist() == [3 * rank + i < 7
                                               for i in range(3)]


def test_backend_choice(monkeypatch):
    from nnest_torch.parallel.mesh import _choose, initialize_distributed
    assert _choose('cpu', 1, 2) == ('gloo', torch.device('cpu'))
    # ranks on cards decide the backend from their host's layout
    for var in ('LOCAL_RANK', 'LOCAL_WORLD_SIZE'):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(ValueError, match='local_world_size'):
        initialize_distributed(device='cuda', init_method='tcp://x:1',
                               world_size=2, rank=0)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='CUDA is not available'):
            _choose('cuda', 0, 2)


@pytest.mark.parametrize('method', ['mcmc', 'slice'])
def test_one_rank_mesh_equals_no_mesh(method):
    """A nested run on a one-rank mesh (the mesh passed down to the
    sharded kernels) gives the run of ``mesh=None`` exactly."""
    from nnest_torch import NestedSampler
    from nnest_torch.likelihoods import Gaussian
    from nnest_torch.parallel import get_mesh
    runs = []
    for mesh in (None, get_mesh()):
        s = NestedSampler(2, Gaussian(2, 0.0, lim=3),
                          transform=lambda x: 3 * x, num_live_points=60,
                          log_dir=None, seed=3, device='cpu', mesh=mesh,
                          log_level=30)
        s.run(train_iters=10, dlogz=0.5, mcmc_num_chains=8,
              strategy=['rejection_prior', method], volume_switch=0.3)
        assert s.run_stats[method + '_generations'] > 0
        runs.append((s.logz, s.h, s.total_calls, s.niter))
    assert runs[0] == runs[1]


# ---------------------------------------------------------------- ranks

def _rank_main():
    p = argparse.ArgumentParser()
    p.add_argument('--rank', type=int, required=True)
    p.add_argument('--world', type=int, required=True)
    p.add_argument('--port', type=int, required=True)
    p.add_argument('--mode', required=True,
                   choices=('broadcast', 'mcmc', 'train', 'farm'))
    p.add_argument('--problem')
    p.add_argument('--out')
    p.add_argument('--dynamic', type=int, default=1)
    a = p.parse_args()
    torch.set_num_threads(1)
    from nnest_torch.parallel import (broadcast_exact, get_mesh,
                                      initialize_distributed)
    initialize_distributed(device='cpu',
                           init_method='tcp://localhost:%d' % a.port,
                           world_size=a.world, rank=a.rank, timeout_s=120)
    mesh = get_mesh()
    out = {'rank': a.rank}
    if a.mode == 'broadcast':
        tree = _tree()
        sent = tree if a.rank == 0 else {k: None for k in tree}
        got = broadcast_exact(sent, mesh)
        out['exact'] = all(
            np.asarray(got[k]).dtype == np.asarray(tree[k]).dtype
            and np.asarray(got[k]).shape == np.asarray(tree[k]).shape
            and np.array_equal(got[k], tree[k]) for k in tree)
    elif a.mode == 'mcmc':
        from nnest_torch.flows import build_flow
        from nnest_torch.parallel import make_sharded_mcmc
        from nnest_torch.samplers.kernels import LatentKernels
        prob = torch.load(a.problem, weights_only=False)
        tm = build_flow(DIM, flow='cholesky', device='cpu')
        tm.load_state_dict(prob['flow'])
        run = make_sharded_mcmc(LatentKernels(tm, _port_like, _port_prior),
                                mesh)
        args = [torch.from_numpy(prob[k]) for k in ('z0', 'logl0', 'lp0')]
        kw = dict(loglstar=None, step_size=0.5, mcmc_steps=STEPS,
                  dynamic_step_size=bool(a.dynamic), draws=prob['draws'])
        res = {k: v.numpy() if isinstance(v, torch.Tensor) else v
               for k, v in run(None, *args, collect_chains=True,
                               **kw).items()}
        end = run(None, *args, **kw)
        res.update(final_x=end['final_x'].numpy(), ess=end['ess'].numpy())
        if a.rank == 0:
            torch.save(res, a.out)
    elif a.mode == 'train':
        torch.save({**{e: _train(mesh, e) for e in TRAIN_EPOCHS},
                    'step': _sharded_steps(mesh, a.problem)}, a.out % a.rank)
    else:
        from nnest_torch import NestedSampler
        seen = []

        def like(x):   # a host likelihood: numpy in, numpy out
            seen.append(len(x))
            return -0.5 * np.sum(np.asarray(x) ** 2, axis=1)

        s = NestedSampler(2, like, num_live_points=10, log_dir=None,
                          device='cpu', mesh=mesh, log_level=30)
        u = np.random.RandomState(0).uniform(-1, 1, size=(10, 2))
        seen.clear()
        logl, _ = s._device_loglike(torch.as_tensor(u, dtype=torch.float32))
        ref = -0.5 * np.sum(u.astype(np.float32).astype(np.float64) ** 2, 1)
        out['rows_seen'] = sum(seen)
        out['exact'] = bool(np.array_equal(logl.numpy(),
                                           ref.astype(np.float32)))
    print('RESULT ' + json.dumps(out), flush=True)
    import torch.distributed as dist
    dist.destroy_process_group()


if __name__ == '__main__':
    _rank_main()
