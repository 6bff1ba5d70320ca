"""The spline-inverse kernel's launch plan and copy schedule (CPU).

``ops.spline_inverse.launch_plan`` decides how the CUDA kernel covers N
rows and streams the packed weights through shared memory (pieces of
layers, grouped into bulk copies); the kernel
follows it without checking more than the shared-memory total. These tests
hold the plan to what the kernel and the hardware need: 16-byte aligned
bulk copies that fit their stage, pieces that tile every layer exactly,
at most 232,448 bytes of shared memory a block, and a grid that covers N.
"""

import re

import pytest
import torch

from nnest_torch.ops import spline_inverse as si

# One intra-op thread a process: the suite runs in parallel workers that
# share the cores.
torch.set_num_threads(1)

K = 8


def _layer_of(layers, off):
    for l in layers:
        if l['w'] <= off < l['tail']:
            return l
    raise AssertionError('chunk at %d lies in no weight array' % off)


@pytest.mark.parametrize('n', [1, 128, 256, 4096])
@pytest.mark.parametrize('hidden', [16, 32, 64])
@pytest.mark.parametrize('d', [2, 5, 16, 50, 100])
def test_plan_pieces_tile_layers_and_copies_fit(d, hidden, n):
    plan = si.launch_plan(n, d, hidden, K)
    layers, bfloats = si.kernel_layout(d, hidden, K)
    stage = plan['stage_floats']
    pieces, copies = plan['pieces'], plan['copies']
    assert bfloats % 4 == 0 and stage % 4 == 0
    # Every piece: whole weight rows of one layer; a layer's last piece
    # carries its tail.
    for off, floats, k0, k1 in pieces:
        assert off % 4 == 0 and floats % 4 == 0 and 0 < floats <= stage
        l = _layer_of(layers, off)
        tail = l['tails'] * l['n4'] if k1 == l['n_in'] else 0
        assert k1 > k0 and floats == (k1 - k0) * l['n4'] + tail
        assert off == l['w'] + k0 * l['n4']
    # The pieces tile each layer's floats exactly, in order: its weight
    # rows, then (with the last rows) its tail.
    pos = 0
    for l in layers:
        mine = [p for p in pieces if l['w'] <= p[0] < l['tail']]
        assert mine[0][2] == 0 and mine[-1][3] == l['n_in']
        assert all(a[3] == b[2] and a[0] + a[1] == b[0]
                   for a, b in zip(mine, mine[1:]))
        assert l['w'] == pos and l['n4'] % 4 == 0
        assert l['n4'] - 4 < l['n_out'] <= l['n4']
        assert l['tail'] == l['w'] + l['n_in'] * l['n4']
        pos = l['tail'] + l['tails'] * l['n4']
        assert mine[-1][0] + mine[-1][1] == pos
    assert pos == bfloats
    # Every copy: a legal 1-D bulk copy (16-byte aligned, a multiple of 16
    # bytes) of consecutive whole pieces that fits its stage; the copies
    # tile the block.
    pos, first = 0, 0
    for off, floats, p0, count in copies:
        assert off % 4 == 0 and floats % 4 == 0 and 0 < floats <= stage
        assert off == pos == pieces[p0][0] and p0 == first and count >= 1
        assert floats == sum(p[1] for p in pieces[p0:p0 + count])
        pos, first = off + floats, p0 + count
    assert pos == bfloats and first == len(pieces)
    # Shared memory: within a block's limit, and the sum the kernel makes.
    assert plan['smem_bytes'] <= si.MAX_SHARED_BYTES
    assert plan['smem_bytes'] == (
        si.BARRIER_BYTES + 4 * plan['stages'] * stage
        + 16 * (len(pieces) + len(copies))
        + plan['rows'] * 4 * si.row_floats(d, hidden, K))
    assert plan['stages'] == 0 or 2 <= plan['stages'] <= si.MAX_STAGES
    # The main path's shapes all keep the weights in the ring.
    assert plan['stages'] >= 2
    # The grid covers N, and no block is empty.
    assert plan['grid'] * plan['rows'] >= n > (plan['grid'] - 1) * plan['rows']


@pytest.mark.parametrize('n,rows', [(256, 2), (4096, 32), (128, 1),
                                    (1000, 8)])
def test_plan_keeps_the_sms_busy(n, rows):
    """About 132 blocks in flight (one an SM) where N allows."""
    plan = si.launch_plan(n, 16, 32, K)
    assert plan['rows'] == rows
    assert plan['grid'] >= min(n, 125)


def test_plan_beyond_the_ring_reads_weights_from_global():
    """Where one row leaves no room for two stages the kernel streams
    nothing and reads the weights through L1/L2 (stages = 0); where one
    row does not fit at all the plan refuses."""
    plan = si.launch_plan(256, 2000, 64, K)
    assert plan['stages'] == 0 and plan['rows'] == 1
    assert plan['smem_bytes'] <= si.MAX_SHARED_BYTES
    with pytest.raises(ValueError, match='shared memory'):
        si.launch_plan(256, 5000, 64, K)
    with pytest.raises(ValueError, match='shared memory'):
        si.launch_plan(256, 16, 32, K, rows=1000)


def test_plan_constants_match_the_kernel_source():
    with open(si.SOURCE) as f:
        src = f.read()

    def const(name):
        return int(re.search(r'constexpr int %s = ([^;]+);' % name,
                             src).group(1).split()[0])

    assert const('kMaxStages') == si.MAX_STAGES
    assert const('kBarrierBytes') == si.BARRIER_BYTES
    assert 2 * si.MAX_STAGES * 8 <= si.BARRIER_BYTES
