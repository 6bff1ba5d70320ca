"""The plain reference against the port on the CPU, and against faults."""

import logging

import numpy as np
import pytest
import torch

from reference import consume, evidence, flow, replay
from reference.likelihood import Gaussian as Gaussian64

torch.set_num_threads(1)


def _tiny_run(tmp_path, seed=3, **run_kw):
    from harness.likelihood import Gaussian, Scale
    from nnest_torch.samplers.nested import NestedSampler
    like = Gaussian(2, 0.5, 'cpu')
    s = NestedSampler(2, like, transform=Scale(3.0), num_live_points=50,
                      hidden_dim=16, log_dir=str(tmp_path / 'run'),
                      append_run_num=False, resume=False, seed=seed,
                      device='cpu', log_level=logging.WARNING)
    s.run(max_iters=150, train_iters=10, **run_kw)
    return s


def test_evidence_against_a_tiny_run_of_the_port(tmp_path):
    s = _tiny_run(tmp_path)
    dead = len(s.loglikes) - 50
    logz, h = evidence.band_evidence(s.loglikes[:dead], s.loglikes[dead:],
                                     50)
    assert logz == pytest.approx(s.logz, abs=1e-10)
    assert h == pytest.approx(s.h, abs=1e-10)
    order, contour = replay.replay(s.saved_u, s.loglikes, s.thread_slots, 50)
    assert (order, contour) == (0, 0)
    # the reference's likelihood at the run's points (float32 on the card)
    ref = Gaussian64(2, 0.5)
    assert np.max(np.abs(ref(3.0 * s.saved_u) - s.loglikes)) < 1e-5


def test_replay_catches_a_wrong_order_and_a_birth_below_its_contour(
        tmp_path):
    s = _tiny_run(tmp_path, seed=4)
    u, logl, slots = s.saved_u.copy(), s.loglikes.copy(), s.thread_slots
    # two deaths swapped
    u[[3, 4]], logl[[3, 4]] = u[[4, 3]], logl[[4, 3]]
    assert replay.replay(u, logl, slots, 50)[0] > 0
    u, logl = s.saved_u.copy(), s.loglikes.copy()
    # a birth put outside the box
    dead = len(logl) - 50
    later = [j for j in range(1, len(logl)) if slots[j] in slots[:j]]
    u[later[0], 0] = 1.5
    assert replay.replay(u, logl, slots, 50)[1] > 0 or \
        replay.replay(u, logl, slots, 50)[0] > 0
    assert dead > 0


@pytest.mark.parametrize('d,hidden', [(16, 32), (5, 16), (50, 64)])
def test_flow_inverse_against_the_port(d, hidden):
    from nnest_torch.flows import build_flow
    model = build_flow(d, hidden_dim=hidden, seed=1, device='cpu').double()
    g = torch.Generator().manual_seed(2)
    model.data_init(0.7 * torch.randn(256, d, generator=g,
                                      dtype=torch.float64) + 0.3)
    z = 2.0 * torch.randn(200, d, generator=g, dtype=torch.float64)
    z[0] = 3.0
    z[1] = -3.0
    z[2] = 4.5
    with torch.no_grad():
        want_x, want_ld = model.inverse(z)
        got_x, got_ld = flow.inverse(model.state_dict(), z)
    assert torch.max(torch.abs(got_x - want_x)) < 1e-10
    assert torch.max(torch.abs(got_ld - want_ld)) < 1e-9


def test_consumption_counts_against_the_port_twin():
    from nnest_torch.ops.consume_pool import consume_pool_twin
    g = torch.Generator().manual_seed(5)
    n, m, d = 200, 512, 3
    al = torch.round(torch.randn(n, generator=g) * 100) / 100
    cl = torch.round((torch.randn(m, generator=g) + 0.5) * 100) / 100
    flags = torch.rand(m, generator=g) < 0.6
    au, cx = torch.randn(n, d, generator=g), torch.randn(m, d, generator=g)
    it = torch.tensor(0, dtype=torch.int32)
    flagged, sectors, accepts, slots = consume.consumption_counts(
        al.numpy(), flags.numpy(), cl.numpy())
    out = consume_pool_twin(au.clone(), al.clone(), None, it, flags, cl, cx,
                            None)
    assert accepts == int(out[3])
    assert slots == int((out[1] != al).sum())
    assert flagged == int(flags.sum())
    assert sectors == int(np.any(np.pad(flags.numpy(), (0, -m % 8))
                                 .reshape(-1, 8), axis=1).sum())
