"""The spline-flow inverse kernel: build, bind, launch.

``spline_inverse(z, packed)`` is the hot inverse every MCMC proposal runs
(``samplers/kernels.LatentKernels._hot_inverse``). For a CUDA tensor it
launches the hand-written kernel in ``csrc/spline_inverse.cu``, which
replaces the JAX package's Pallas TPU kernel
``nnest_tpu/ops/pallas_spline.py::pallas_inverse_from_consts`` and its XLA
twin ``nnest_tpu/ops/fused_spline.py::_inverse_body``. For a CPU tensor it
runs the plain PyTorch twin ``ops.fused_spline._inverse_body``. There is no
fallback between the two: a CUDA tensor launches the kernel or raises.

The kernel source is compiled at first use with ``nvcc`` for ``sm_90a``
into ``csrc/build/`` (one shared library per source hash, with the
``-Xptxas -v`` register/spill/shared-memory report kept beside it in a
``.log`` file and in :data:`build_log`) and bound with ``ctypes``.
What bounds it and how it is laid out is in the source's header.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import torch

from nnest_torch.ops.fused_spline import _inverse_body

SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), 'csrc', 'spline_inverse.cu')
BUILD_DIR = os.path.join(os.path.dirname(SOURCE), 'build')
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-O3',
              '-std=c++17', '-shared', '-Xcompiler', '-fPIC',
              '-Xptxas', '-v')
# Shared memory one thread block may use on Hopper (bytes).
MAX_SHARED_BYTES = 232448
SUPPORTED_BINS = (8,)

# Kernel launches since import (or since a caller reset it): chip_smoke.py
# sets it to 0, drives the sampler and reads it back.
launches = 0
# nvcc's output for the loaded library, -Xptxas -v report included.
build_log = None

_lib = None
_lock = threading.Lock()


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


def load_library():
    """Build (once per source hash) and load the kernel library."""
    global _lib, build_log
    with _lock:
        if _lib is not None:
            return _lib
        with open(SOURCE, 'rb') as f:
            tag = hashlib.sha256(
                f.read() + ' '.join(NVCC_FLAGS).encode()).hexdigest()[:16]
        so = os.path.join(BUILD_DIR, 'libspline_inverse_%s.so' % tag)
        log_path = so + '.log'
        if not (os.path.exists(so) and os.path.exists(log_path)):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = '%s.%d.tmp' % (so, os.getpid())
            proc = subprocess.run([_find_nvcc(), *NVCC_FLAGS, '-o', tmp,
                                   SOURCE], capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError('nvcc failed (exit %d):\n%s%s' % (
                    proc.returncode, proc.stdout, proc.stderr))
            with open(log_path, 'w') as f:
                f.write(proc.stdout + proc.stderr)
            os.replace(tmp, so)
        with open(log_path) as f:
            build_log = f.read()
        lib = ctypes.CDLL(so)
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.nnest_spline_inverse.argtypes = (
            [vp] * 4 + [ci] * 8 + [ctypes.c_float, ci, vp])
        lib.nnest_spline_inverse.restype = ci
        lib.nnest_spline_block_floats.argtypes = [ci, ci, ci]
        lib.nnest_spline_block_floats.restype = ci
        _lib = lib
        return lib


@torch.no_grad()
def pack_kernel_params(packed):
    """Flatten packed inverse consts into the kernel's parameter layout:
    per block ``s t winv f2 f1`` (each MLP as w0 b0 ... w3 b3), then the
    constant logdet."""
    parts = []
    for blk in packed['blocks']:
        parts += [blk['s'], blk['t'], blk['winv']]
        for net in (blk['sc'].f2, blk['sc'].f1):
            for w, b in zip(net.w, net.b):
                parts += [w, b]
    parts.append(packed['const_logdet'])
    return torch.cat([p.detach().reshape(-1).float() for p in parts])


def rows_per_block(n, d, hidden, num_bins):
    """Rows one thread block inverts: enough blocks to cover the SMs at the
    chain counts of the main path, at most 16 rows, and within shared
    memory."""
    per_row = 3 * d + 2 * hidden + (d - d // 2) * (3 * num_bins - 1) + 1
    fit = MAX_SHARED_BYTES // (4 * per_row)
    if fit < 1:
        raise ValueError('spline inverse kernel: one row needs %d bytes of '
                         'shared memory, more than a block has'
                         % (4 * per_row))
    return max(1, min(16, fit, -(-n // 264)))


def _shape(packed):
    shapes = {(b['sc'].dim, b['sc'].hidden, b['sc'].num_bins,
               b['sc'].tail_bound) for b in packed['blocks']}
    if len(shapes) != 1:
        raise ValueError('all flow blocks must share dim, width, bins and '
                         'tail bound, got %s' % sorted(shapes))
    return shapes.pop()


def _launch(z, packed, first_block, num_blocks, include_const):
    """Launch the kernel on blocks [first_block, first_block + num_blocks)."""
    global launches
    d, hidden, num_bins, tail_bound = _shape(packed)
    if z.device.type != 'cuda':
        raise ValueError('spline inverse kernel needs a CUDA tensor, got %s'
                         % z.device)
    if z.dtype != torch.float32:
        raise ValueError('spline inverse kernel takes float32, got %s'
                         % z.dtype)
    if z.dim() != 2 or z.shape[1] != d:
        raise ValueError('z must be (n, %d), got %s' % (d, tuple(z.shape)))
    if not z.is_contiguous():
        raise ValueError('z must be contiguous')
    if num_bins not in SUPPORTED_BINS:
        raise ValueError('spline inverse kernel is built for num_bins in %s, '
                         'got %d' % (SUPPORTED_BINS, num_bins))
    total = len(packed['blocks'])
    lib = load_library()
    flat = packed.get('kernel_params')
    if flat is None:
        flat = packed['kernel_params'] = pack_kernel_params(packed)
    expected = total * lib.nnest_spline_block_floats(d, hidden, num_bins) + 1
    if flat.numel() != expected:
        raise ValueError('packed kernel params hold %d floats, expected %d '
                         '(conditioners must be 4-layer MLPs)'
                         % (flat.numel(), expected))
    if flat.device != z.device or not flat.is_contiguous():
        raise ValueError('kernel params must be contiguous on %s' % z.device)
    n = z.shape[0]
    x = torch.empty_like(z)
    logdet = torch.empty(n, dtype=torch.float32, device=z.device)
    if n == 0:
        return x, logdet
    with torch.cuda.device(z.device):
        stream = torch.cuda.current_stream(z.device).cuda_stream
        err = lib.nnest_spline_inverse(
            z.data_ptr(), flat.data_ptr(), x.data_ptr(), logdet.data_ptr(),
            n, d, hidden, num_bins, total, first_block, num_blocks,
            int(include_const), float(tail_bound),
            rows_per_block(n, d, hidden, num_bins), stream)
    if err != 0:
        raise RuntimeError('spline inverse kernel launch failed: '
                           'cudaError %d' % err)
    launches += 1
    return x, logdet


def spline_inverse(z, packed):
    """Whole-chain inverse ``z -> (x, logdet)`` with consts from
    ``ops.fused_spline.pack_inverse_consts``: the CUDA kernel for a CUDA
    tensor, the plain twin for a CPU tensor."""
    if z.device.type == 'cpu':
        return _inverse_body(z, packed)
    return _launch(z, packed, 0, len(packed['blocks']), True)
