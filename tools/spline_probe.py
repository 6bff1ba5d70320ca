#!/usr/bin/env python3
"""Where the time of the CUDA spline inverse goes, on one GPU.

Run from the repository root on a machine with an NVIDIA GPU and nvcc:
``python3 tools/spline_probe.py``. The card offers no hardware profiler
here, so the probe builds edited copies of ``nnest_torch/csrc/spline_inverse.cu``
into a temporary directory and reads them two ways:

- ablations, timed with CUDA-graph replay (``chip_smoke.graph_time_ms``)
  at the main path's shapes: the kernel as it is; without its dense work
  (every dense stage keeps its waits and barriers but computes nothing);
  without its six RQS stages; without both (what is left is the weight
  pipeline, the barriers and the launch). The ablated kernels compute
  wrong values: they are for timing only;
- a stage split: ``clock64`` stamps of thread 0 of block 0, summed over
  one launch in shared-memory counters, for the weight wait, the dense
  work, the stage's release, the barrier after each layer, the RQS stages
  and the whole kernel (cycles).

Every edit is checked against the source and fails loudly when the source
no longer has the text it edits. Each result is one JSON line, with the
card's name and power limit first.
"""

import ctypes
import json
import os
import subprocess
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from nnest_torch.ops import spline_inverse as si  # noqa: E402
from nnest_torch.ops.fused_spline import pack_inverse_consts  # noqa: E402

SHAPES = (16, 256), (16, 4096), (2, 128), (50, 256), (50, 4096)


def edit(src, old, new):
    if src.count(old) != 1:
        raise SystemExit('spline_probe: the kernel source no longer has %r'
                         % old[:60])
    return src.replace(old, new)


def no_dense(src):
    return edit(src, 'const int items = (R / RT) * cq;',
                'const int items = 0;')


def no_rqs(src):
    return edit(src, '        rqs_half<K>(sm + zs,', '        if (0) rqs_half<K>(sm + zs,')


def stage_split(src):
    """Shared-memory cycle counters around the parts of a stage."""
    src = edit(src, 'namespace {\n', (
        'namespace {\n__device__ unsigned long long g_probe[8];\n'
        '__shared__ unsigned long long s_probe[8];\n'
        '#define STAMP(i) if (blockIdx.x == 0 && threadIdx.x == 0) '
        '{ long long t_ = clock64(); s_probe[i] += t_ - t_last; '
        't_last = t_; }\n'))
    src = edit(src, '''  for (;;) {
    const int4 ch = pipe.pieces[c];''', '''  long long t_last = clock64();
  for (;;) {
    const int4 ch = pipe.pieces[c];''')
    src = edit(src, '''      const int w = pipe.piece(c, ch);
''', '''      const int w = pipe.piece(c, ch);
      STAMP(0);
''')
    src = edit(src, '''      pipe.done(c);
    } else {''', '''      STAMP(1);
      pipe.done(c);
      STAMP(2);
    } else {''')
    src = edit(src, '''    if (last) break;
  }
  consumer_sync();
}''', '''    if (last) break;
  }
  consumer_sync();
  STAMP(3);
}''')
    src = edit(src, '''        rqs_half<K>(sm + zs,''', '''        long long t_rqs = clock64();
        rqs_half<K>(sm + zs,''')
    src = edit(src, '''                    sm + cond, c4, sm + lds, R, B);
''', '''                    sm + cond, c4, sm + lds, R, B);
        if (blockIdx.x == 0 && tid == 0) s_probe[4] += clock64() - t_rqs;
''')
    src = edit(src, '''  for (int i = tid; i < npieces + ncopies; i += kThreads) table[i] = tables[i];''',
               '''  const long long t_begin = clock64();
  if (tid < 8) s_probe[tid] = 0;
  for (int i = tid; i < npieces + ncopies; i += kThreads) table[i] = tables[i];''')
    src = edit(src, '''  const float cst = include_const''', '''  if (blockIdx.x == 0 && tid == 0) {
    s_probe[5] = clock64() - t_begin;
    for (int i = 0; i < 8; ++i) g_probe[i] = s_probe[i];
  }
  const float cst = include_const''')
    return src + ('\nextern "C" int probe_read(unsigned long long* out) {\n'
                  '  return (int)cudaMemcpyFromSymbol(out, g_probe, '
                  'sizeof(g_probe));\n}\n')


def load(src, build_dir, name):
    """Build ``src`` and make ``ops.spline_inverse`` launch it."""
    cu = os.path.join(build_dir, name + '.cu')
    so = os.path.join(build_dir, name + '.so')
    with open(cu, 'w') as f:
        f.write(src)
    subprocess.run([si._find_nvcc(), *si.NVCC_FLAGS, '-o', so, cu],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(so)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.nnest_spline_inverse.argtypes = (
        [vp] * 5 + [ci] * 8 + [ctypes.c_float] + [ci] * 6 + [vp])
    lib.nnest_spline_inverse.restype = ci
    lib.nnest_spline_block_floats.argtypes = [ci, ci, ci]
    lib.nnest_spline_block_floats.restype = ci
    si._lib = lib
    return lib


def main():
    if not torch.cuda.is_available():
        print('spline_probe: CUDA is not available', file=sys.stderr)
        return 2
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(json.dumps({'gpu': smi}), flush=True)
    with open(si.SOURCE) as f:
        src = f.read()
    cases = []
    for d, n in SHAPES:
        model = cs.random_flow(d, seed=1, device='cuda')
        cases.append((d, n, pack_inverse_consts(model),
                      cs.kernel_inputs(model, n, seed=2, device='cuda')))
    variants = {'as_is': src, 'no_dense': no_dense(src),
                'no_rqs': no_rqs(src), 'neither': no_rqs(no_dense(src))}
    with tempfile.TemporaryDirectory(prefix='spline_probe_') as build_dir:
        for name, text in variants.items():
            load(text, build_dir, name)
            for d, n, packed, z in cases:
                packed.pop('kernel', None)
                ms = cs.graph_time_ms(lambda: si.spline_inverse(z, packed))
                print(json.dumps({'variant': name, 'd': d, 'n': n,
                                  'ms': ms}), flush=True)
        lib = load(stage_split(src), build_dir, 'stage_split')
        buf = (ctypes.c_ulonglong * 8)()
        for d, n, packed, z in cases:
            packed.pop('kernel', None)
            try:
                si.spline_inverse(z, packed)
            except RuntimeError:
                # The counters' static shared memory does not fit beside
                # a plan that fills the block's shared memory.
                print(json.dumps({'stage_cycles': {
                    'd': d, 'n': n, 'not measured': 'no room for the '
                    'counters'}}), flush=True)
                continue
            torch.cuda.synchronize()
            lib.probe_read(buf)
            print(json.dumps({'stage_cycles': {
                'd': d, 'n': n, 'wait': buf[0], 'dense': buf[1],
                'release': buf[2], 'barrier': buf[3], 'rqs': buf[4],
                'whole': buf[5]}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
