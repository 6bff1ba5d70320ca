"""The trainer's persistence: a snapshot restored before ``train()`` gives
bit-identical parameters and bookkeeping on the CPU, in the same trainer
and in one built from another seed; ``save``/``load`` round-trips the
flow; the transport API and one training epoch against nnest_tpu's."""

import numpy as np
import pytest
import torch

from nnest_torch import Trainer

# One intra-op thread a process: the suite runs in parallel workers that
# share the cores.
torch.set_num_threads(1)


def _trainer(seed):
    return Trainer(2, batch_size=20, learning_rate=1e-2, log=False,
                   seed=seed, device='cpu')


def _state(t):
    return ({k: v.clone() for k, v in t.model.state_dict().items()},
            (t.total_iters, t.best_validation_loss, t.best_validation_epoch,
             t.last_training_jitter))


def _assert_same(a, b):
    assert a[1] == b[1]
    assert a[0].keys() == b[0].keys()
    for k in a[0]:
        assert torch.equal(a[0][k], b[0][k]), k


def test_snapshot_restore_gives_a_bit_identical_train():
    x = np.random.RandomState(1).normal(size=(90, 2)).astype(np.float32)
    t = _trainer(3)
    t.train(x, max_iters=4, jitter=-1.0)   # Adam moments are non-zero
    snap = t.snapshot_state()
    t.train(x + 0.1, max_iters=5, jitter=-1.0)
    first = _state(t)
    assert first[1][0] == 9

    t.restore_state(snap)
    t.train(x + 0.1, max_iters=5, jitter=-1.0)
    _assert_same(_state(t), first)

    other = _trainer(11)   # other flow weights and generator
    other.restore_state(snap)
    other.train(x + 0.1, max_iters=5, jitter=-1.0)
    _assert_same(_state(other), first)

    fresh = _trainer(4).snapshot_state()   # never trained: no optimizer
    assert fresh['optimizer'] is None and not fresh['initialized']
    other.restore_state(fresh)
    assert other.optimizer is None and not other.initialized


def test_save_load_round_trip(tmp_path):
    x = np.random.RandomState(2).normal(size=(60, 2)).astype(np.float32)
    t = _trainer(3)
    t.train(x, max_iters=3)
    path = str(tmp_path / 'flow.pt')
    t.save(path)
    u = _trainer(8)
    u.load(path)
    assert u.initialized and u.optimizer is not None
    np.testing.assert_array_equal(u.log_probs(x, to_numpy=True),
                                  t.log_probs(x, to_numpy=True))


def _trainer_pair(d=3):
    """nnest_tpu's Trainer and the port's on the same flow parameters,
    carried across by ``flows/convert.py``."""
    import jax
    from nnest_torch.flows import params_from_jax
    from nnest_tpu.training.trainer import Trainer as JaxTrainer
    x = np.random.RandomState(5).normal(size=(64, d)).astype(np.float32)
    ref = JaxTrainer(d, hidden_dim=16, log=False, log_dir=None, seed=2)
    ref.ensure_init(x)
    port = Trainer(d, hidden_dim=16, log=False, seed=9, device='cpu')
    port.ensure_init(x)
    params_from_jax(port.model, jax.tree.map(np.asarray, ref.params))
    return ref, port


def test_transport_api_matches_jax():
    """forward, inverse and log_probs equal nnest_tpu's to 1e-5 (inputs
    beyond the spline's tail bound included); a 1-D input is one row; the
    parameter count and the base distribution's names agree."""
    ref, port = _trainer_pair()
    z = (2.0 * np.random.RandomState(1).normal(size=(40, 3))).astype(
        np.float32)
    for name in ('forward', 'inverse'):
        got = getattr(port, name)(z, to_numpy=True)
        want = getattr(ref, name)(z, to_numpy=True)
        for g, w in zip(got, want):
            assert isinstance(g, np.ndarray) and g.dtype == np.float32
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
        one = getattr(port, name)(z[0])
        assert one[0].shape == (1, 3) and one[1].shape == (1,)
        np.testing.assert_allclose(one[0].numpy()[0], got[0][0], rtol=1e-6,
                                   atol=1e-6)
    np.testing.assert_allclose(port.log_probs(z, to_numpy=True),
                               ref.log_probs(z, to_numpy=True), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(port.get_latent_samples(z, to_numpy=True),
                               ref.get_latent_samples(z, to_numpy=True),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(port.get_samples(z, to_numpy=True),
                               ref.get_samples(z, to_numpy=True), rtol=1e-5,
                               atol=1e-5)
    assert port.num_params() == ref.num_params()
    assert type(port.base_dist).__name__ == type(ref.base_dist).__name__


def test_transport_draws_shapes_and_to_numpy():
    """Base draws and synthetic samples from the trainer's generator: a
    second trainer with the same seed draws the same, the synthetic
    samples are the inverse of the base draws, and the results are
    tensors unless ``to_numpy``."""
    a, b = _trainer(3), _trainer(3)
    x = np.random.RandomState(4).normal(size=(50, 2)).astype(np.float32)
    for t in (a, b):
        t.ensure_init(x)
    prior = a.get_prior_samples(7)
    assert isinstance(prior, torch.Tensor) and prior.shape == (7, 2)
    synth = a.get_synthetic_samples(7, to_numpy=True)
    assert isinstance(synth, np.ndarray) and synth.shape == (7, 2)
    np.testing.assert_array_equal(b.get_prior_samples(7, to_numpy=True),
                                  prior.numpy())
    np.testing.assert_array_equal(
        synth, b.get_samples(b.get_prior_samples(7), to_numpy=True))
    z, logdet = a.forward(torch.from_numpy(x))
    assert isinstance(z, torch.Tensor) and logdet.shape == (50,)
    back, inv_logdet = a.inverse(z)
    np.testing.assert_allclose(back.numpy(), x, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(inv_logdet.numpy(), -logdet.numpy(),
                               rtol=1e-4, atol=1e-4)
    assert a.base_dist is a.model.base_dist


@pytest.mark.parametrize('l2_norm', [0.0, 1e-3])
def test_one_epoch_loss_trace_matches_jax(l2_norm):
    """One epoch of the port's trainer on nnest_tpu's row order and noise
    (what its ``one_epoch`` draws from the key: ``split``, ``permutation``,
    ``split(knoise, nb)``, ``normal``) from the same flow parameters, data
    and validation split, against ``_make_train_fn(..., max_iters=1)``:
    the mean train NLL and the validation loss to 1e-4 relative, the
    parameters after the epoch to 1e-3 of Adam's reach. Adam moves a
    coordinate by about lr (1e-4) a step, so nb = 5 steps by at most
    nb * lr = 5e-4; two runs that part by rounding alone stay within a
    thousandth of that, atol 5e-7."""
    import jax
    import jax.numpy as jnp
    from nnest_torch.flows import params_from_jax, params_to_jax
    from nnest_tpu.training.trainer import Trainer as JaxTrainer
    rs = np.random.RandomState(5)
    x = (rs.normal(size=(95, 2)) * [1.0, 0.5] + [0.3, -0.2]).astype(
        np.float32)
    order = rs.permutation(95)
    valid, train = x[order[:10]], x[order[10:]]
    n_train, bs, jitter, lr = 85, 20, 0.05, 1e-4
    nb = -(-n_train // bs)   # 5 batches, the last padded with 15 rows
    ref = JaxTrainer(2, hidden_dim=16, batch_size=bs, learning_rate=lr,
                     log=False, log_dir=None, seed=2)
    ref.ensure_init(x)
    port = Trainer(2, hidden_dim=16, batch_size=bs, learning_rate=lr,
                   log=False, seed=9, device='cpu')
    port.ensure_init(x)
    params_from_jax(port.model, jax.tree.map(np.asarray, ref.params))

    key = jax.random.PRNGKey(7)
    (params, _, _, _, _, epochs, train_trace, val_trace) = \
        ref._make_train_fn(n_train, 10, l2_norm, 1)(
            ref.params, ref._opt_state, key, jnp.asarray(train),
            jnp.asarray(valid), np.float32(jitter), np.int32(50))
    assert int(epochs) == 1
    # the draws of train_fn's first epoch
    _, kep = jax.random.split(key)
    kperm, knoise = jax.random.split(kep)
    perm = np.array(jax.random.permutation(kperm, n_train))
    noise = np.stack([np.asarray(jax.random.normal(k, (bs, 2)))
                      for k in jax.random.split(knoise, nb)])

    train_loss, val_loss = port._train_epoch(
        torch.from_numpy(train), torch.from_numpy(valid),
        torch.from_numpy(perm), torch.from_numpy(noise), jitter, l2_norm)
    assert float(train_loss) == pytest.approx(float(train_trace[0]),
                                              rel=1e-4)
    assert val_loss == pytest.approx(float(val_trace[0]), rel=1e-4)
    moved = max(float(np.max(np.abs(np.asarray(a) - np.asarray(b))))
                for a, b in zip(jax.tree.leaves(ref.params),
                                jax.tree.leaves(params)))
    assert moved == pytest.approx(nb * lr, rel=0.1)   # the epoch did move
    for got, want in zip(jax.tree.leaves(params_to_jax(port.model)),
                         jax.tree.leaves(params)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=0,
                                   atol=1e-3 * nb * lr)
