"""The trainer's persistence: a snapshot restored before ``train()`` gives
bit-identical parameters and bookkeeping on the CPU, in the same trainer
and in one built from another seed; ``save``/``load`` round-trips the
flow."""

import numpy as np
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
