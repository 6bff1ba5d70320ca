"""The spline-flow inverse kernel: layout, launch plan, build, bind, launch.

``spline_inverse(z, packed)`` is the hot inverse every MCMC proposal runs
(``samplers/kernels.LatentKernels._hot_inverse``); ``spline_inverse_per_block``
computes the same function with one launch per flow block. For a CUDA
tensor both launch the hand-written kernel in ``csrc/spline_inverse.cu``,
which replaces the JAX package's Pallas TPU kernels
``nnest_tpu/ops/pallas_spline.py::pallas_inverse_from_consts`` and
``::pallas_inverse_per_block``. For a CPU tensor they run the plain PyTorch
twin ``ops.fused_spline._inverse_body``. There is no fallback between the
two: a CUDA tensor launches the kernel or raises.

``fast_slow_inverse(z, packed)`` is the hot inverse of a fast-slow flow
whose two chains have the spline layout: the combine coupling's inverse in
plain PyTorch, then the slow chain and the fast chain, each one launch of
the same kernel (each chain's twin on a CPU tensor). ``nnest_tpu`` has no
Pallas kernel for it: it stands for the JAX package's
``FastSlowFlowModel.inverse`` (``nnest_tpu/flows/model.py``), which that
package runs as plain XLA inside the chain steps. What bounds it is the
kernel's latency twice (two launches of a 3-block chain, d 2 and d 28 at
the upstream fast-slow example's widths) plus about thirty small plain
launches of the combine coupling's two MLPs, its masks and the
concatenation; not the operations, which are ~1e5 a row.

The kernel source is compiled at first use with ``nvcc`` for ``sm_90a``
into ``csrc/build/`` (one shared library per source hash, with the
``-Xptxas -v`` register/spill/shared-memory report kept beside it in a
``.log`` file and in :data:`build_log`) and bound with ``ctypes``.
The packed layout (:func:`kernel_layout`), the pieces and copies the
kernel streams through shared memory and the rows a thread block owns
(:func:`launch_plan`) are plain Python, so the CPU tests reach them; what
bounds the kernel and how it is designed is in the source's header.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading

import torch

from nnest_torch.ops.fused_spline import (_inverse_body,
                                          pack_fast_slow_consts,
                                          pack_inverse_consts)

SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), 'csrc', 'spline_inverse.cu')
BUILD_DIR = os.path.join(os.path.dirname(SOURCE), 'build')
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-O3',
              '-std=c++17', '-shared', '-Xcompiler', '-fPIC',
              '-Xptxas', '-v')
# Shared memory one thread block may use on Hopper (bytes).
MAX_SHARED_BYTES = 232448
SUPPORTED_BINS = (8,)
# The kernel's constants (csrc/spline_inverse.cu): at most 4 ring stages,
# and room for their 2 x 4 mbarriers ahead of the stages.
MAX_STAGES = 4
BARRIER_BYTES = 128
# A piece of a layer is at most 32 KB (or one row and a tail where that is
# longer); a stage, and so one bulk copy, at most 80 KB.
PIECE_CAP_FLOATS = 8192
STAGE_CAP_FLOATS = 20480
# Blocks the plan aims to keep in flight (the H100 has 132 SMs) and the
# most rows one block takes.
TARGET_BLOCKS = 132
MAX_ROWS = 64

# Kernel launches since import (or since a caller reset them), one count
# per wrapper: chip_smoke.py sets them to 0, drives the sampler and reads
# them back.
launches = 0
launches_per_block = 0
# nvcc's output for the loaded library, -Xptxas -v report included.
build_log = None

_lib = None
_lock = threading.Lock()
# launch plans by (device, n, d, hidden, bins, rows, stages): the piece
# and copy table on the device and the kernel's plan arguments
_plans = {}


def _ceil4(v):
    return -(-v // 4) * 4


def kernel_layout(d, hidden, num_bins):
    """The padded layout of one flow block, in the order the kernel uses it:
    f2 layers 0-3, f1 layers 0-3, then the affine (W^-1, t, s).

    Returns ``(layers, block_floats)``; each layer is a dict with ``name``,
    ``n_in``, ``n_out``, ``n4`` (the padded row length), ``w`` (float
    offset of the first weight row within the block) and ``tail`` (offset
    of the bias, or of t then s for the affine, ``tails`` arrays of ``n4``
    floats). Every offset and length is a multiple of 4 floats."""
    per = 3 * num_bins - 1
    cut = d - d // 2
    up = d - cut
    layers, pos = [], 0

    def add(name, n_in, n_out, tails):
        nonlocal pos
        n4 = _ceil4(n_out)
        layers.append({'name': name, 'n_in': n_in, 'n_out': n_out, 'n4': n4,
                       'w': pos, 'tail': pos + n_in * n4, 'tails': tails})
        pos += (n_in + tails) * n4

    for net, n_in, n_out in (('f2', up, cut * per), ('f1', cut, up * per)):
        sizes = (n_in, hidden, hidden, hidden, n_out)
        for i in range(4):
            add('%s.%d' % (net, i), sizes[i], sizes[i + 1], 1)
    add('affine', d, d, 2)
    return layers, pos


def piece_schedule(d, hidden, num_bins):
    """One block's pieces, each ``(offset, floats, k0, k1)`` = weight rows
    [k0, k1) of a layer, whole rows only; the last piece of a layer ends at
    its last row and carries the layer's tail (bias, or t and s) after it,
    so the pieces of a layer tile its floats exactly. A piece is at most
    ``PIECE_CAP_FLOATS``, or one row and a tail where that is longer."""
    layers, _ = kernel_layout(d, hidden, num_bins)
    cap = max([PIECE_CAP_FLOATS]
              + [(1 + l['tails']) * l['n4'] for l in layers])
    pieces = []
    for l in layers:
        n4, k0 = l['n4'], 0
        while True:
            rest = l['n_in'] - k0
            if (rest + l['tails']) * n4 <= cap:
                pieces.append((l['w'] + k0 * n4, (rest + l['tails']) * n4,
                               k0, l['n_in']))
                break
            k1 = k0 + min(cap // n4, rest - 1)
            pieces.append((l['w'] + k0 * n4, (k1 - k0) * n4, k0, k1))
            k0 = k1
    return pieces


def copy_schedule(pieces, stage_floats):
    """Consecutive pieces grouped greedily into bulk copies of at most
    ``stage_floats``: each ``(offset, floats, first piece, pieces)``."""
    copies = []
    for i, (off, floats, _, _) in enumerate(pieces):
        if copies and copies[-1][1] + floats <= stage_floats:
            o, f, first, count = copies[-1]
            copies[-1] = (o, f + floats, first, count + 1)
        else:
            copies.append((off, floats, i, 1))
    return copies


def row_floats(d, hidden, num_bins):
    """Shared floats of one row's state: z, the affine output and the
    per-dim logdets, two activation buffers, the conditioner output, the
    running logdet."""
    cut = d - d // 2
    return (3 * _ceil4(d) + 2 * _ceil4(hidden)
            + _ceil4(cut * (3 * num_bins - 1)) + 1)


def launch_plan(n, d, hidden, num_bins, rows=None, stages=None):
    """How the kernel covers ``n`` rows: rows a thread block, grid, ring
    stages and their floats, the pieces and copies of one block's weights
    and the shared bytes a block needs (the C entry point checks the last
    against its own sum).

    By default a block takes the power of two of rows that keeps about
    ``TARGET_BLOCKS`` blocks in flight (at most ``MAX_ROWS``), halved until
    two stages of the largest piece fit beside the rows' state. A stage
    holds a whole flow block's weights where that is at most
    ``STAGE_CAP_FLOATS`` (one copy a block), else ``STAGE_CAP_FLOATS``,
    shrunk until two fit; the ring takes up to ``MAX_STAGES``. Where even
    one row leaves no room for two stages of the largest piece, stages is 0
    and the kernel reads the weights from global memory. ``rows`` and
    ``stages`` override the choice (a sweep)."""
    pieces = piece_schedule(d, hidden, num_bins)
    _, block_floats = kernel_layout(d, hidden, num_bins)
    biggest = max(p[1] for p in pieces)
    per_row = 4 * row_floats(d, hidden, num_bins)
    # The table holds the pieces and at most as many copies.
    fixed = BARRIER_BYTES + 32 * len(pieces)

    def room(r):
        return MAX_SHARED_BYTES - fixed - r * per_row

    if rows is None:
        want = -(-n // TARGET_BLOCKS)
        rows = 1
        while rows < min(want, MAX_ROWS):
            rows *= 2
        while rows > 1 and room(rows) < 8 * biggest:
            rows //= 2
    rows = int(rows)
    stage = max(biggest, min(block_floats, STAGE_CAP_FLOATS,
                             room(rows) // 8 // 4 * 4))
    top = min(MAX_STAGES, room(rows) // (4 * stage))
    if stages is None:
        stages = top if top >= 2 else 0
    if room(rows) < 0 or stages > top or stages == 1:
        raise ValueError('spline inverse kernel: %d rows and %d stages need '
                         'more shared memory than a block has'
                         % (rows, stages))
    if stages == 0:
        stage = biggest
    copies = copy_schedule(pieces, stage)
    return {'rows': rows, 'grid': -(-n // rows), 'stages': stages,
            'stage_floats': stage, 'pieces': pieces, 'copies': copies,
            'smem_bytes': (BARRIER_BYTES + 16 * (len(pieces) + len(copies))
                           + 4 * stages * stage + rows * per_row)}


def _find_nvcc():
    candidates = [shutil.which('nvcc')]
    for root in (os.environ.get('CUDA_HOME'), '/usr/local/cuda'):
        if root:
            candidates.append(os.path.join(root, 'bin', 'nvcc'))
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError('nvcc not found (PATH, $CUDA_HOME/bin, '
                       '/usr/local/cuda/bin): the CUDA spline inverse '
                       'cannot be built')


def _source_bytes(source):
    """The bytes of ``source`` and of every header it includes by
    ``#include "..."`` from its own directory (recursively, each once)."""
    seen, out, todo = set(), [], [source]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.add(path)
        with open(path, 'rb') as f:
            text = f.read()
        out.append(text)
        todo += [os.path.join(os.path.dirname(path), m.decode())
                 for m in re.findall(rb'^#include "([^"]+)"', text, re.M)]
    return b''.join(out)


def build(source, stem, flags=()):
    """Compile ``source`` with ``nvcc`` (and the extra ``flags``) into
    ``BUILD_DIR/lib<stem>_<hash>.so`` unless that library (one per hash of
    the source, the headers it includes and the flags) and its log are
    there; returns the library's path and nvcc's output, the ``-Xptxas
    -v`` report included. Each process writes a file of its own and renames
    it into place, so concurrent builds never see half a library."""
    flags = NVCC_FLAGS + tuple(flags)
    tag = hashlib.sha256(_source_bytes(source)
                         + ' '.join(flags).encode()).hexdigest()[:16]
    so = os.path.join(BUILD_DIR, 'lib%s_%s.so' % (stem, tag))
    log_path = so + '.log'
    if not (os.path.exists(so) and os.path.exists(log_path)):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = '%s.%d.tmp' % (so, os.getpid())
        proc = subprocess.run([_find_nvcc(), *flags, '-o', tmp, source],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError('nvcc failed (exit %d):\n%s%s' % (
                proc.returncode, proc.stdout, proc.stderr))
        with open(log_path, 'w') as f:
            f.write(proc.stdout + proc.stderr)
        os.replace(tmp, so)
    with open(log_path) as f:
        return so, f.read()


def load_library():
    """Build (once per source hash) and load the kernel library."""
    global _lib, build_log
    with _lock:
        if _lib is not None:
            return _lib
        so, build_log = build(SOURCE, 'spline_inverse')
        lib = ctypes.CDLL(so)
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.nnest_spline_inverse.argtypes = (
            [vp] * 5 + [ci] * 8 + [ctypes.c_float] + [ci] * 6 + [vp])
        lib.nnest_spline_inverse.restype = ci
        lib.nnest_spline_block_floats.argtypes = [ci, ci, ci]
        lib.nnest_spline_block_floats.restype = ci
        _lib = lib
        return lib


@torch.no_grad()
def pack_kernel_params(packed):
    """Flatten packed inverse consts into the kernel's padded layout
    (:func:`kernel_layout`): per block f2 and f1 as (w, b) x 4 with JAX's
    (n_in, n_out) weights, then W^-1, t, s, every row and array padded with
    zeros to a multiple of 4 floats; then the constant logdet, padded."""
    blocks = packed['blocks']
    sc = blocks[0]['sc']
    d, hidden, num_bins = sc.dim, sc.hidden, sc.num_bins
    layers, bfloats = kernel_layout(d, hidden, num_bins)
    ref = blocks[0]['s']
    flat = torch.zeros(len(blocks) * bfloats + 4, dtype=torch.float32,
                       device=ref.device)
    for b, blk in enumerate(blocks):
        base = b * bfloats
        mats = []
        for net in (blk['sc'].f2, blk['sc'].f1):
            mats += [(w, [bias]) for w, bias in zip(net.w, net.b)]
        mats.append((blk['winv'], [blk['t'], blk['s']]))
        for l, (w, tails) in zip(layers, mats):
            n_in, n_out, n4 = l['n_in'], l['n_out'], l['n4']
            if tuple(w.shape) != (n_in, n_out):
                raise ValueError('layer %s is %s, the kernel takes (%d, %d) '
                                 '(conditioners must be 4-layer MLPs of one '
                                 'width)' % (l['name'], tuple(w.shape), n_in,
                                             n_out))
            flat[base + l['w']:l['tail'] + base].view(n_in, n4)[
                :, :n_out] = w.detach().float()
            for i, t in enumerate(tails):
                o = base + l['tail'] + i * n4
                flat[o:o + n_out] = t.detach().reshape(-1).float()
    flat[len(blocks) * bfloats] = packed['const_logdet'].detach().float()
    return flat


def _shape(packed):
    shapes = {(b['sc'].dim, b['sc'].hidden, b['sc'].num_bins,
               b['sc'].tail_bound) for b in packed['blocks']}
    if len(shapes) != 1:
        raise ValueError('all flow blocks must share dim, width, bins and '
                         'tail bound, got %s' % sorted(shapes))
    return shapes.pop()


def _prepared(packed, device):
    """The kernel's per-flow state, made once and kept in ``packed``: the
    shape and the padded parameters on ``device``."""
    prep = packed.get('kernel')
    if prep is not None and prep['device'] == device:
        return prep
    d, hidden, num_bins, tail_bound = _shape(packed)
    if num_bins not in SUPPORTED_BINS:
        raise ValueError('spline inverse kernel is built for num_bins in %s, '
                         'got %d' % (SUPPORTED_BINS, num_bins))
    lib = load_library()
    total = len(packed['blocks'])
    flat = pack_kernel_params(packed).to(device)
    expected = total * lib.nnest_spline_block_floats(d, hidden, num_bins) + 4
    if flat.numel() != expected:
        raise ValueError('packed kernel params hold %d floats, expected %d'
                         % (flat.numel(), expected))
    prep = packed['kernel'] = {
        'device': device, 'lib': lib, 'd': d, 'hidden': hidden,
        'num_bins': num_bins, 'tail_bound': float(tail_bound),
        'total': total, 'flat': flat}
    return prep


def _launch(z, packed, first_block, num_blocks, include_const, rows=None,
            stages=None):
    """Launch the kernel on blocks [first_block, first_block + num_blocks).
    ``rows`` and ``stages`` override the launch plan's (a sweep)."""
    if z.device.type != 'cuda':
        raise ValueError('spline inverse kernel needs a CUDA tensor, got %s'
                         % z.device)
    if z.dtype != torch.float32:
        raise ValueError('spline inverse kernel takes float32, got %s'
                         % z.dtype)
    prep = _prepared(packed, z.device)
    d = prep['d']
    if z.dim() != 2 or z.shape[1] != d:
        raise ValueError('z must be (n, %d), got %s' % (d, tuple(z.shape)))
    if not z.is_contiguous():
        raise ValueError('z must be contiguous')
    n = z.shape[0]
    x = torch.empty_like(z)
    logdet = torch.empty(n, dtype=torch.float32, device=z.device)
    if n == 0:
        return x, logdet
    # The launch plans depend on the shape alone, so they outlive a packing
    # of the flow (one a generation): their tables are copied to the card
    # once, not a generation (each copy a host wait).
    key = (z.device, n, d, prep['hidden'], prep['num_bins'], rows, stages)
    plan = _plans.get(key)
    if plan is None:
        p = launch_plan(n, d, prep['hidden'], prep['num_bins'], rows, stages)
        table = torch.tensor(p['pieces'] + p['copies'], dtype=torch.int32,
                             device=z.device)
        plan = _plans[key] = (
            table, (p['rows'], p['stages'], p['stage_floats'],
                    len(p['pieces']), len(p['copies']), p['smem_bytes']))
    table, plan_args = plan
    args = (z.data_ptr(), prep['flat'].data_ptr(), table.data_ptr(),
            x.data_ptr(), logdet.data_ptr(), n, d, prep['hidden'],
            prep['num_bins'], prep['total'], first_block, num_blocks,
            int(include_const), prep['tail_bound'], *plan_args,
            torch.cuda.current_stream(z.device).cuda_stream)
    if z.device.index == torch.cuda.current_device():
        err = prep['lib'].nnest_spline_inverse(*args)
    else:
        with torch.cuda.device(z.device):
            err = prep['lib'].nnest_spline_inverse(*args)
    if err != 0:
        raise RuntimeError('spline inverse kernel launch failed: '
                           'cudaError %d' % err)
    return x, logdet


def spline_inverse(z, packed):
    """Whole-chain inverse ``z -> (x, logdet)`` with consts from
    ``ops.fused_spline.pack_inverse_consts``: one kernel launch for a CUDA
    tensor, the plain twin for a CPU tensor."""
    global launches
    if z.device.type == 'cpu':
        return _inverse_body(z, packed)
    out = _launch(z, packed, 0, len(packed['blocks']), True)
    launches += 1
    return out


def fused_inverse_fn(model):
    """The single-speed spline flow's inverse ``z -> (x, logdet)`` through
    :func:`spline_inverse`, its constants packed once, now (the counterpart
    of ``nnest_tpu``'s ``fused_inverse_fn``, which packs inside the traced
    call)."""
    packed = pack_inverse_consts(model)
    return lambda z: spline_inverse(z, packed)


@torch.no_grad()
def fast_slow_inverse(z, packed):
    """A fast-slow spline flow's inverse ``z -> (x, logdet)`` with the
    packing of ``ops.fused_spline.pack_fast_slow_consts``: the combine
    coupling's inverse, then each chain's whole-chain inverse (one kernel
    launch each for a CUDA tensor, each chain's twin for a CPU tensor),
    concatenated, the three logdets summed as ``FastSlowFlowModel.inverse``
    sums them (the chains' constant logdets inside theirs). The combine
    coupling passes z's slow dims through unchanged and the kernel
    computes each row on its own, so a latent move of the fast dims only
    leaves x's slow dims bit for bit."""
    global launches
    k = packed['num_slow']
    h, ld_c = packed['combine'].inverse(z)
    out = []
    for chain, v in ((packed['slow'], h[:, :k]), (packed['fast'], h[:, k:])):
        if z.device.type == 'cpu':
            out.append(_inverse_body(v, chain))
        else:
            out.append(_launch(v.contiguous(), chain, 0,
                               len(chain['blocks']), True))
            launches += 1
    (x_s, ld_s), (x_f, ld_f) = out
    return torch.cat([x_s, x_f], dim=1), ld_s + ld_f + ld_c


def fast_slow_inverse_fn(model):
    """The fast-slow spline flow's inverse through
    :func:`fast_slow_inverse`, its chains' constants packed once, now."""
    packed = pack_fast_slow_consts(model)
    return lambda z: fast_slow_inverse(z, packed)


def spline_inverse_per_block(z, packed):
    """The same inverse as ``spline_inverse`` with one launch per flow
    block, last to first, without the constant, then the blocks' logdets
    summed plus ``const_logdet`` (``pallas_inverse_per_block``'s order).
    A CPU tensor takes the plain twin over the same block ranges."""
    global launches_per_block
    logdet = torch.zeros(z.shape[0], dtype=torch.float32, device=z.device)
    for b in reversed(range(len(packed['blocks']))):
        if z.device.type == 'cpu':
            z, ld = _inverse_body(z, packed, b, 1, include_const=False)
        else:
            z, ld = _launch(z, packed, b, 1, False)
            launches_per_block += 1
        logdet = logdet + ld
    return z, logdet + packed['const_logdet']
