"""The pool-consumption replay: build, bind, launch, and its plain twin.

``consume_pool(au, al, ad, it, flags, cand_logl, cand_x, cand_derived,
update_interval)`` replays the nested sampler's consumption of one candidate
pool on the device's copy of the live set (the JAX package's
``LatentKernels._consume_pool``, an XLA ``lax.scan``; there is no Pallas
kernel behind it). For a CUDA tensor it launches the hand-written kernel in
``csrc/consume_pool.cu`` (one thread block: a pre-filter of the candidates
against the first worst value, then one warp's walk over a 32-ary min-tree
of the live logl; the source's header has the design); for a CPU tensor it
runs the plain PyTorch twin :func:`consume_pool_twin`. There is no fallback
between the two: a CUDA tensor launches the kernel or raises.

Both update ``au``, ``al`` and ``ad`` in place and return them with the new
iteration count and the boundary flag as 0-dim tensors; the work is
compares and selects, so the kernel equals the twin bit for bit.

The source is compiled at first use with ``nvcc`` for ``sm_90a`` into
``csrc/build/`` (one shared library per source hash, the ``-Xptxas -v``
report kept beside it and in :data:`build_log`) and bound with ``ctypes``,
as ``ops/spline_inverse.py`` builds its kernel.
"""

from __future__ import annotations

import ctypes
import os
import threading

import torch

from nnest_torch.ops.spline_inverse import BUILD_DIR, build

SOURCE = os.path.join(os.path.dirname(BUILD_DIR), 'consume_pool.cu')

# Kernel launches since import (or since a caller reset it), and the twin's
# calls: chip_smoke.py sets both to 0, drives the sampler and reads them.
launches = 0
twin_calls = 0
# nvcc's output for the loaded library, -Xptxas -v report included.
build_log = None

_lib = None
_lock = threading.Lock()


def load_library():
    """Build (once per source hash) and load the kernel library."""
    global _lib, build_log
    with _lock:
        if _lib is not None:
            return _lib
        so, build_log = build(SOURCE, 'consume_pool')
        _lib = bind(so)
        return _lib


def bind(so):
    """The kernel library at ``so``, its C entries typed."""
    lib = ctypes.CDLL(so)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.nnest_consume_pool.argtypes = [vp] * 10 + [ci] * 5 + [vp, vp]
    lib.nnest_consume_pool.restype = ci
    lib.nnest_consume_pool_shared_capacity.argtypes = []
    lib.nnest_consume_pool_shared_capacity.restype = ci
    lib.nnest_consume_pool_scratch_bytes.argtypes = [ci, ci]
    lib.nnest_consume_pool_scratch_bytes.restype = ctypes.c_longlong
    return lib


def consume_pool_twin(au, al, ad, it, flags, cand_logl, cand_x, cand_derived,
                      update_interval=None):
    """The plain PyTorch version of the kernel, on any device: the
    candidates in order against the current worst live point (the first
    index of ``argmin`` on a tie); the first candidate whose flag is set
    and whose logl is strictly above it replaces it, and the walk goes on
    from the next candidate against the new worst point. The candidates in
    between fail against the current worst value, which an accept could
    only raise, so each pass of the loop is one accept and the last finds
    none. ``ad`` and ``cand_derived`` may be None (no derived values)."""
    global twin_calls
    twin_calls += 1
    it = int(it)
    crossed = False
    pos, m = 0, cand_logl.shape[0]
    worst = int(torch.argmin(al))
    while pos < m:
        passing = flags[pos:] & (cand_logl[pos:] > al[worst])
        if not bool(passing.any()):
            break
        i = pos + int(torch.argmax(passing.to(torch.uint8)))
        au[worst] = cand_x[i]
        al[worst] = cand_logl[i]
        if ad is not None:
            ad[worst] = cand_derived[i]
        it += 1
        if update_interval and it % update_interval == 0:
            crossed = True
        pos = i + 1
        worst = int(torch.argmin(al))
    return (au, al, ad, torch.tensor(it, dtype=torch.int32, device=al.device),
            torch.tensor(crossed, device=al.device))


def _check(au, al, ad, it, flags, cand_logl, cand_x, cand_derived):
    n, d = au.shape
    m = cand_logl.shape[0]
    k = 0 if ad is None else ad.shape[1]
    want = [('au', au, torch.float32, (n, d)), ('al', al, torch.float32, (n,)),
            ('it', it, torch.int32, None),
            ('flags', flags, torch.bool, (m,)),
            ('cand_logl', cand_logl, torch.float32, (m,)),
            ('cand_x', cand_x, torch.float32, (m, d))]
    if k:
        want += [('ad', ad, torch.float32, (n, k)),
                 ('cand_derived', cand_derived, torch.float32, (m, k))]
    for name, t, dtype, shape in want:
        if t.device != au.device:
            raise ValueError('%s is on %s, au on %s' % (name, t.device,
                                                        au.device))
        if t.dtype != dtype:
            raise ValueError('%s must be %s, got %s' % (name, dtype, t.dtype))
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError('%s must be %s, got %s' % (name, shape,
                                                        tuple(t.shape)))
        if not t.is_contiguous():
            raise ValueError('%s must be contiguous' % name)
    if it.numel() != 1:
        raise ValueError('it must hold one int32, got %s' % tuple(it.shape))
    if n < 1:
        raise ValueError('the live set is empty')
    return n, d, k, m


def consume_pool(au, al, ad, it, flags, cand_logl, cand_x, cand_derived,
                 update_interval=None):
    """Replay one pool's consumption on the live set ``au`` (n, d), ``al``
    (n,) and ``ad`` (n, k) or None, in place: candidates ``flags`` (m,)
    bool, ``cand_logl`` (m,), ``cand_x`` (m, d) and ``cand_derived`` (m, k)
    or None, from the iteration count ``it`` (an int32 tensor). Returns
    (au, al, ad, it, crossed), ``it`` and ``crossed`` 0-dim tensors
    (int32, bool); ``crossed`` says whether an accept landed on a multiple
    of ``update_interval`` (never, when it is None). One kernel launch for
    CUDA tensors, :func:`consume_pool_twin` for CPU tensors."""
    global launches
    if not isinstance(it, torch.Tensor):
        it = torch.tensor(int(it), dtype=torch.int32, device=al.device)
    if au.device.type == 'cpu':
        return consume_pool_twin(au, al, ad, it, flags, cand_logl, cand_x,
                                 cand_derived, update_interval)
    if au.device.type != 'cuda':
        raise ValueError('consume_pool takes CPU or CUDA tensors, got %s'
                         % au.device)
    n, d, k, m = _check(au, al, ad, it, flags, cand_logl, cand_x,
                        cand_derived)
    lib = load_library()
    it_out = torch.empty((), dtype=torch.int32, device=au.device)
    crossed = torch.empty((), dtype=torch.bool, device=au.device)
    # the kernel's device scratch (each slot's last accept; the survivor
    # list and the tree's inner nodes where they outgrow shared memory)
    scratch = torch.empty(lib.nnest_consume_pool_scratch_bytes(n, m),
                          dtype=torch.uint8, device=au.device)
    args = (au.data_ptr(), al.data_ptr(), ad.data_ptr() if k else None,
            it.data_ptr(), it_out.data_ptr(), crossed.data_ptr(),
            flags.data_ptr(),
            cand_logl.data_ptr(), cand_x.data_ptr(),
            cand_derived.data_ptr() if k else None, n, d, k, m,
            int(update_interval or 0), scratch.data_ptr(),
            torch.cuda.current_stream(au.device).cuda_stream)
    with torch.cuda.device(au.device):
        err = lib.nnest_consume_pool(*args)
    if err != 0:
        raise RuntimeError('consume_pool kernel launch failed: cudaError %d'
                           % err)
    launches += 1
    return au, al, ad, it_out, crossed
