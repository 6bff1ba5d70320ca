"""The two facts the pool-consumption kernel's design rests on, on the CPU.

``csrc/consume_pool.cu`` pre-filters the candidates against the FIRST worst
live value, then walks the survivors with one warp over a 32-ary min-tree
of the live logl. Here (a) the twin over only the survivors equals the twin
over every candidate, and (b) a numpy model of the kernel's tree walk (its
keys, its two-stage warp minimum, the worst slot's siblings' minima, its
batches of 32 and its deferred row copies) equals both the twin and
``nnest_tpu``'s ``_consume_pool`` on the same numpy inputs, ties at the
minimum and signed zeros included. The kernel itself is held against the
twin on the card (``tests/test_torch_cuda.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnest_tpu.samplers import kernels as jk
from nnest_torch.ops.consume_pool import consume_pool_twin

# One intra-op thread a process: the suite runs in parallel workers that
# share the cores.
torch.set_num_threads(1)

EMPTY = np.uint32(0xFFFFFFFF)


def _pool(case, n, m, seed, d=3, k=2):
    """(au, al, ad, it, flags, cand_logl, cand_x, cand_derived,
    update_interval) as numpy: logl rounded so that ties occur; 'ties' puts
    a multi-way tie at the minimum across 32-groups (and, with signed
    zeros, -0.0 and +0.0 as the minimum), 'many' flags most candidates."""
    rs = np.random.RandomState(seed)
    al = np.round(rs.normal(-0.5, 1.0, size=n), 1).astype(np.float32)
    cl = np.round(rs.normal(0.3, 1.0, size=m), 1).astype(np.float32)
    share = 0.9 if case == 'many' else 0.5
    flags = rs.uniform(size=m) < share
    if case in ('ties', 'zeros'):
        low = np.float32(0.0) if case == 'zeros' else al.min()
        at = np.unique(rs.randint(0, n, size=max(1, n // 20)))
        al = np.abs(al) if case == 'zeros' else al
        al[at] = low
        if case == 'zeros':
            al[at[::2]] = np.float32(-0.0)
            cl[rs.uniform(size=m) < 0.2] = np.float32(-0.0)
            cl[rs.uniform(size=m) < 0.2] = np.float32(0.0)
        cl[rs.uniform(size=m) < 0.2] = low
    au = rs.normal(size=(n, d)).astype(np.float32)
    ad = rs.normal(size=(n, k)).astype(np.float32)
    cx = rs.normal(size=(m, d)).astype(np.float32)
    cd = rs.normal(size=(m, k)).astype(np.float32)
    return au, al, ad, 11, flags, cl, cx, cd, 5


def _torch(au, al, ad, it, flags, cl, cx, cd):
    t = (lambda a: torch.from_numpy(a.copy()))
    return (t(au), t(al), t(ad), torch.tensor(it, dtype=torch.int32),
            t(flags), t(cl), t(cx), t(cd))


def _assert_same(got, want):
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        # signed zeros too: the same bits
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
    assert int(got[3]) == int(want[3])
    assert bool(got[4]) == bool(want[4])


# ------------------------------------------------ (a) the pre-filter

@pytest.mark.parametrize('case', ['random', 'ties', 'zeros', 'many'])
@pytest.mark.parametrize('seed', [0, 1, 2])
def test_prefilter_against_first_worst_is_exact(case, seed):
    """Candidates unflagged or not above the initial minimum can never be
    accepted: the twin over the rest equals the twin over all."""
    au, al, ad, it, flags, cl, cx, cd, ui = _pool(case, 100, 400, seed)
    keep = flags & (cl > al.min())
    full = consume_pool_twin(*_torch(au, al, ad, it, flags, cl, cx, cd),
                             update_interval=ui)
    part = consume_pool_twin(*_torch(au, al, ad, it, flags[keep], cl[keep],
                                     cx[keep], cd[keep]), update_interval=ui)
    _assert_same(part, full)
    assert int(full[3]) > it


# ------------------------------------- (b) the kernel's tree walk in numpy

def _keys(v):
    """The kernel's ord_of: unsigned keys ordering floats as the float
    compare does, -0.0 and +0.0 one key."""
    u = np.asarray(v, np.float32).view(np.uint32).copy()
    u[(u << np.uint32(1)) == 0] = 0
    return np.where(u & np.uint32(0x80000000), ~u,
                    u | np.uint32(0x80000000)).astype(np.uint32)


def _warp_min(keys, idx):
    """The kernel's warp_min over 32 lanes (rows of 32 here): the least key,
    then the least index among the lanes that hold it."""
    k = keys.min(axis=-1)
    i = np.where(keys == k[..., None], idx, EMPTY).min(axis=-1)
    return k, i


def _group(level, g):
    keys, idx = level
    sl = slice(32 * g, 32 * g + 32)
    kk = np.full(32, EMPTY, np.uint32)
    ii = np.full(32, EMPTY, np.uint32)
    kk[:len(keys[sl])], ii[:len(idx[sl])] = keys[sl], idx[sl]
    return kk, ii


def _tree(al):
    """Levels of (keys, indices), the leaves first and the root last; at
    least one level above the leaves."""
    levels = [(_keys(al), np.arange(al.shape[0], dtype=np.uint32))]
    while len(levels) == 1 or levels[-1][0].shape[0] > 1:
        keys, idx = levels[-1]
        c = -(-keys.shape[0] // 32)
        kk = np.full(32 * c, EMPTY, np.uint32)
        ii = np.full(32 * c, EMPTY, np.uint32)
        kk[:keys.shape[0]], ii[:idx.shape[0]] = keys, idx
        levels.append(_warp_min(kk.reshape(c, 32), ii.reshape(c, 32)))
    return levels


def _path(levels, slot):
    """The kernel's load_siblings and reduce_path: at each level the least
    pair among the slot's path node's 31 siblings, and the least of those
    (the tree without the slot)."""
    sib = []
    for lv in range(len(levels) - 1):
        node = slot >> (5 * lv)
        kk, ii = _group(levels[lv], node // 32)
        kk[node % 32] = ii[node % 32] = EMPTY
        sib.append(_warp_min(kk, ii))
    return sib, min(sib)


def _tree_walk(au, al, ad, it, flags, cl, cx, cd, ui):
    """The kernel's algorithm on numpy: the tree, the pre-filter against
    the root's value, the survivors 32 to a batch against the root's key;
    an accept's new root is the lesser of its pair and the worst slot's
    rest of the tree, the slot's path is rewritten from its siblings'
    minima, and the accept is logged with its slot's last accept; then the
    rows of each slot's last accept."""
    au, al, ad = au.copy(), al.copy(), ad.copy()
    levels = _tree(al)
    root, slot = levels[-1][0][0], int(levels[-1][1][0])
    sib, rest = _path(levels, slot)
    surv = np.nonzero(flags & (cl > al[slot]))[0]
    log, last, crossed = [], {}, False
    for pos in range(0, surv.shape[0], 32):
        batch = surv[pos:pos + 32]
        keys = _keys(cl[batch])
        start = 0
        while True:
            hits = np.nonzero(keys[start:] > root)[0]
            if hits.shape[0] == 0:
                break
            f = start + hits[0]
            cand, c = batch[f], (keys[f], np.uint32(slot))
            top = min(c, rest)
            for lv in range(len(levels) - 2):
                c = min(c, sib[lv])
                node = slot >> (5 * (lv + 1))
                levels[lv + 1][0][node], levels[lv + 1][1][node] = c
            levels[0][0][slot] = keys[f]
            al[slot] = cl[cand]
            last[slot] = len(log)
            log.append((cand, slot))
            root, slot = top[0], int(top[1])
            sib, rest = _path(levels, slot)
            it += 1
            crossed |= it % ui == 0
            start = f + 1
    for e, (cand, slot) in enumerate(log):
        if last[slot] == e:
            au[slot], ad[slot] = cx[cand], cd[cand]
    return au, al, ad, it, crossed


@pytest.mark.parametrize('n', [1, 31, 33, 1000])
@pytest.mark.parametrize('case', ['ties', 'zeros'])
def test_tree_walk_model_equals_twin_and_jax(n, case):
    """The first index wins a tie at every level of the 32-ary tree: the
    model equals the twin and the JAX package's scan, bit for bit."""
    pool = _pool(case, n, 3 * n + 40, seed=n)
    au, al, ad, it, flags, cl, cx, cd, ui = pool
    model = _tree_walk(*pool)
    twin = consume_pool_twin(*_torch(au, al, ad, it, flags, cl, cx, cd),
                             update_interval=ui)
    want = jk.LatentKernels._consume_pool(
        None, jnp.asarray(au), jnp.asarray(al), jnp.asarray(ad),
        jnp.int32(it), jnp.asarray(flags), jnp.asarray(cl), jnp.asarray(cx),
        jnp.asarray(cd), update_interval=ui)
    _assert_same(model, twin)
    _assert_same(model, want)
    assert model[3] > it
