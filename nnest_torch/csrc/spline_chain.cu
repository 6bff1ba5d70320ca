// A spline chain's forward in training, and its backward, on Hopper
// (sm_90a): [ActNorm, Invertible1x1Conv, SplineCoupling] x blocks in one
// launch each way, plus one launch that sums the weight gradients.
//
// Replaces no TPU kernel. The JAX package trains in plain XLA
// (nnest_tpu/training/trainer.py), which fuses the chain's small products
// and elementwise work itself. PyTorch runs a training step of such a chain
// as ~690 launches (each coupling half's 4-layer conditioner MLP as cuBLAS
// products, split-K reductions, bias adds and LeakyReLUs, forward and
// backward, ActNorm, the conv's product, and the RQS pair of
// spline_coupling.cu), each bound by launch latency at the training batch
// of 100 rows. The plain PyTorch versions are in
// nnest_torch/ops/spline_chain.py: the forward is Chain.forward, module by
// module; chain_backward_plain is the backward derived by hand, line for
// line as this file derives it, held to autograd on the CPU.
//
// For each row x in R^d and each flow block b (first to last):
//   1. ActNorm: a = x * exp(s) + t;
//   2. the conv: c = a @ W, W = P L (U + diag S) assembled by the caller
//      (plain PyTorch; so is the parameter-only logdet sum(s) +
//      sum(log|S|));
//   3. f1, a 4-layer LeakyReLU(0.2) MLP, on the lower half c[:cut] gives
//      the upper half's knots; the upper half takes the RQS forward
//      (rqs_device.cuh), u = RQS(c[cut:]);
//   4. f2 on u gives the lower half's knots; the lower half takes the RQS;
//      the block's output is [RQS(c[:cut]) | u].
// The row logdet is the RQS terms summed (upper half, then lower, block by
// block). Where a gradient is wanted the forward also saves each row's
// record of each block: the block's input and every activation its
// backward reads (blocks x rows x record_floats). The backward runs the
// blocks from last to first, each from its records, stage by stage back to
// the block's input: d/dx of every row, and each parameter's gradient
// summed over the thread block's rows. No atomics: every thread block
// writes its partial gradients to its own slice of a scratch buffer, and
// one reduction launch sums the slices in thread-block order, so two
// launches on the same inputs give the same bits.
//
// Bound. At the training shapes (100 rows, d 2..50, hidden 16, K 8, 3
// blocks) the forward is ~2e7 f32 operations and ~0.3 MB of weights, the
// backward about three times that: microseconds at the H100's f32 rate and
// HBM bandwidth. What bounds the pair is the chain's depth: ~36 dependent
// stages a forward and ~40 a backward, each ending in a barrier of the
// thread block (the RQS stages the longest: each lane one thread's serial
// chain), against the ~690 launches it replaces.
//
// Design against that:
//   - A thread block owns `rows` whole rows (the plan in ops/spline_chain.py
//     keeps at most ~132 blocks in flight: one row a block at the training
//     batch), and takes them through every flow block; a row's state lives
//     in shared memory.
//   - Each stage spreads its (row, output) items over the block's 256
//     threads; the products are f32 FMA, their k-loops in order.
//   - Parameters are read where they live (pointers in the kernel's
//     arguments, one table a launch), so a CUDA graph captured once stays
//     valid while Adam updates them in place; nothing is repacked. They are
//     read through the read-only cache. The inverse kernel's TMA ring
//     (spline_inverse.cu) needs its padded packing (every row a multiple of
//     16 bytes), which reading in place rules out; at 100 rows a weight
//     read feeds few rows and the stages' latency, not the bytes, costs.
//   - The LeakyReLU's pre-activations are kept, so the backward takes the
//     slope (1 or 0.2) where autograd takes it, at the pre-activation's
//     sign.
//   - f32 throughout: no tensor cores (TF32), no fast-math intrinsics.

#include <cuda_runtime.h>
#include <stddef.h>

#include "rqs_device.cuh"

namespace {

using nnest_rqs::Lane;

constexpr int kThreads = 256;
// ops/spline_chain.py's MIN_BINS, MAX_BINS, MAX_BLOCKS, MAX_DIM and
// MAX_HIDDEN.
constexpr int kMinBins = 2;
constexpr int kMaxBins = 16;
constexpr int kMaxBlocks = 8;
constexpr int kMaxDim = 128;
constexpr int kMaxHidden = 128;
// Dynamic shared memory a thread block may take: the H100's 227 KB less
// room for the static table below.
constexpr int kMaxSharedBytes = 230400;
// A flow block's tensors, in the order of the table: ActNorm's s and t,
// the assembled W, then f1's and f2's (w, b) for layers 0..3 (weights in
// JAX's (n_in, n_out) layout).
constexpr int kTensors = 19;
constexpr int kS = 0, kT = 1, kW = 2, kF1 = 3, kF2 = 11;

struct Table {
  const float* p[kMaxBlocks * kTensors];
};

// The launch's table, copied into shared memory at the start: every index
// into the kernel's argument is a constant (an argument indexed at run time
// would be copied to each thread's local memory).
__device__ inline const float* const* load_table(const Table& tab) {
  __shared__ const float* stab[kMaxBlocks * kTensors];
#pragma unroll
  for (int i = 0; i < kMaxBlocks * kTensors; ++i)
    if (threadIdx.x == i % kThreads) stab[i] = tab.p[i];
  return stab;
}

struct Dims {
  int n, d, cut, up, h, rows;
  float B;
};

// Floats of tensor i of a block (the layout of the gradients too: a
// block's tensors one after another in table order, block after block).
__host__ __device__ inline int tensor_floats(int i, int d, int h, int P) {
  const int cut = d - d / 2, up = d - cut;
  if (i == kS || i == kT) return d;
  if (i == kW) return d * d;
  const bool f1 = i < kF2;
  const int m = i - (f1 ? kF1 : kF2);
  const int sizes[5] = {f1 ? cut : up, h, h, h, (f1 ? up : cut) * P};
  return m % 2 ? sizes[m / 2 + 1] : sizes[m / 2] * sizes[m / 2 + 1];
}

__host__ __device__ inline int block_floats(int d, int h, int P) {
  int f = 0;
  for (int i = 0; i < kTensors; ++i) f += tensor_floats(i, d, h, P);
  return f;
}

// A thread block's shared state, `rows` rows of each buffer. Forward (and
// the backward, loaded from the records): the block's input x, ActNorm's
// output a, the conv's output c, the upper half after its RQS u, f1's and
// f2's pre-activations (3 hidden layers each), their raw outputs, the
// per-dim logdets and the row logdet. Backward adds d/d raw, two hidden
// gradients, d/d (block output, c, a, u) and dL/d row logdet.
struct Tile {
  float *x, *a, *c, *u, *h1, *h2, *raw1, *raw2, *ldl, *ld;
  float *graw, *gh, *gz, *gc, *ga, *gu, *gl;
};

// Floats of a row's record of one flow block, which the forward saves for
// the backward: x, a, c, u, f1's and f2's pre-activations (3 h each),
// raw1, raw2 (the tile's buffers in that order, one row of each).
__host__ __device__ inline int record_floats(int d, int h, int P) {
  const int cut = d - d / 2, up = d - cut;
  return 3 * d + up + 6 * h + d * P;
}

__host__ __device__ inline int row_floats(int d, int h, int P,
                                          bool backward) {
  const int cut = d - d / 2, up = d - cut;
  int f = 3 * d + up + 6 * h + d * P + cut + 1;
  if (backward) f += cut * P + 2 * h + 3 * d + up + 1;
  return f;
}

__device__ inline Tile make_tile(float* sm, const Dims& D, int P,
                                 bool backward) {
  const int R = D.rows;
  Tile T = {};
  float* q = sm;
  auto take = [&](int per_row) {
    float* out = q;
    q += R * per_row;
    return out;
  };
  T.x = take(D.d);
  T.a = take(D.d);
  T.c = take(D.d);
  T.u = take(D.up);
  T.h1 = take(3 * D.h);
  T.h2 = take(3 * D.h);
  T.raw1 = take(D.up * P);
  T.raw2 = take(D.cut * P);
  T.ldl = take(D.cut);
  T.ld = take(1);
  if (backward) {
    T.graw = take(D.cut * P);
    T.gh = take(2 * D.h);
    T.gz = take(D.d);
    T.gc = take(D.d);
    T.ga = take(D.d);
    T.gu = take(D.up);
    T.gl = take(1);
  }
  return T;
}

// The tile's rows to their records (kSave) or back, fields [first, last)
// (0: x, ..., 7: raw2). rec: the first row's record; a record is
// record_floats long.
template <bool kSave>
__device__ void records(const Tile& T, const Dims& D, int P, float* rec,
                        int first, int last, int nr) {
  const int rf = record_floats(D.d, D.h, P);
  float* const tiles[8] = {T.x, T.a, T.c, T.u, T.h1, T.h2, T.raw1, T.raw2};
  const int widths[8] = {D.d, D.d, D.d, D.up, D.h, D.h, D.up * P,
                         D.cut * P};
  const int layers[8] = {1, 1, 1, 1, 3, 3, 1, 1};
  int off = 0;
  for (int f = 0; f < 8; ++f) {
    const int w = widths[f], lw = layers[f] * w;
    if (f >= first && f < last)
      for (int i = threadIdx.x; i < nr * lw; i += kThreads) {
        const int r = i / lw, m = i - r * lw, l = m / w;
        float* t = tiles[f] + (l * D.rows + r) * w + (m - l * w);
        float* g = rec + (size_t)r * rf + off + m;
        if (kSave)
          *g = *t;
        else
          *t = *g;
      }
    off += lw;
  }
}

template <bool kLeaky>
__device__ inline float act(float v) {
  return kLeaky ? (v >= 0.0f ? v : 0.2f * v) : v;
}

// out[r][j] = sum_k act(in[r][k]) w[k][j] (+ b[j]) for the tile's nr rows:
// one (row, column) a thread, the k-loop in order.
// A thread's items (a, b) of an a x n grid, `stride` apart in row-major
// order: the next item without a division.
struct Walk {
  int a, b, da, db, n;
  __device__ inline Walk(int first, int n_, int stride = kThreads) : n(n_) {
    a = first / n;
    b = first - a * n;
    da = stride / n;
    db = stride - da * n;
  }
  __device__ inline void next() {
    a += da;
    b += db;
    if (b >= n) {
      b -= n;
      ++a;
    }
  }
};

template <bool kLeakyIn>
__device__ void dense(const float* in, int is, int n_in,
                      const float* __restrict__ w,
                      const float* __restrict__ b, int n_out, float* out,
                      int os, int nr) {
  for (Walk it(threadIdx.x, n_out); it.a < nr; it.next()) {
    const int r = it.a, j = it.b;
    const float* v = in + r * is;
    float acc = 0.0f;
    for (int k = 0; k < n_in; ++k)
      acc = fmaf(act<kLeakyIn>(v[k]), __ldg(w + (size_t)k * n_out + j), acc);
    out[r * os + j] = b ? acc + __ldg(b + j) : acc;
  }
}

// Lanes that share one d/d in item of dense_backward (its n_out-long sum
// split, then added over the lanes by shuffles in a fixed order).
constexpr int kSplit = 8;

// The backward of dense<kLeakyIn> from gout = dL/d out: d/d in (times the
// LeakyReLU's slope at in, the pre-activation, where kLeakyIn; plus add
// where given) into gin, and the weight and bias gradients summed over the
// rows in order into pw and pb (pb may be null: no bias). The d/d in items
// come first: they are the longest (an n_out-long sum each, kSplit lanes
// an item).
template <bool kLeakyIn>
__device__ void dense_backward(const float* in, int is, int n_in,
                               const float* gout, int gs, int n_out,
                               const float* __restrict__ w, float* pw,
                               float* pb, float* gin, int gis,
                               const float* add, int as, int nr) {
  // one walk over the items: d/d in (kSplit lanes each, whole groups of
  // lanes in one warp), then the weights, then the biases
  const int ng = nr * n_in * kSplit, nw = n_in * n_out, nb = pb ? n_out : 0;
  const int lane = threadIdx.x % kSplit;
  const unsigned group = 0xFFu << (threadIdx.x % 32 - lane);
  int i = threadIdx.x;
  for (Walk it(i / kSplit, n_in, kThreads / kSplit); i < ng;
       i += kThreads, it.next()) {
    const int r = it.a, k = it.b;
    const float* g = gout + r * gs;
    const float* wk = w + (size_t)k * n_out;
    float acc = 0.0f;
    for (int j = lane; j < n_out; j += kSplit)
      acc = fmaf(g[j], __ldg(wk + j), acc);
#pragma unroll
    for (int o = kSplit / 2; o > 0; o /= 2)
      acc += __shfl_xor_sync(group, acc, o, kSplit);
    if (lane == 0) {
      if (kLeakyIn && !(in[r * is + k] >= 0.0f)) acc = 0.2f * acc;
      gin[r * gis + k] = add ? add[r * as + k] + acc : acc;
    }
  }
  for (Walk it(i - ng, n_out); i < ng + nw; i += kThreads, it.next()) {
    const int k = it.a, j = it.b;
    float acc = 0.0f;
    for (int r = 0; r < nr; ++r)
      acc = fmaf(act<kLeakyIn>(in[r * is + k]), gout[r * gs + j], acc);
    pw[i - ng] = acc;
  }
  for (; i < ng + nw + nb; i += kThreads) {
    const int j = i - ng - nw;
    float acc = 0.0f;
    for (int r = 0; r < nr; ++r) acc += gout[r * gs + j];
    pb[j] = acc;
  }
}

// A conditioner MLP: in (n_in a row) -> three hidden pre-activations in H
// (rows x h each) -> raw (n_out a row). wb: w0, b0, ..., w3, b3.
__device__ void mlp_forward(const float* in, int is, int n_in,
                            const float* const* wb, int h, float* H, int R,
                            float* raw, int n_out, int nr) {
  dense<false>(in, is, n_in, wb[0], wb[1], h, H, h, nr);
  __syncthreads();
  dense<true>(H, h, h, wb[2], wb[3], h, H + R * h, h, nr);
  __syncthreads();
  dense<true>(H + R * h, h, h, wb[4], wb[5], h, H + 2 * R * h, h, nr);
  __syncthreads();
  dense<true>(H + 2 * R * h, h, h, wb[6], wb[7], n_out, raw, n_out, nr);
  __syncthreads();
}

// Its backward from graw = dL/d raw: the partial gradients of w0..b3 into
// pwb[0..7], and d/d in (plus add) into gin. gh: two hidden gradients.
__device__ void mlp_backward(const float* in, int is, int n_in,
                             const float* H, int h, int R, const float* graw,
                             int n_out, const float* const* wb,
                             float* const* pwb, float* gh, float* gin,
                             int gis, const float* add, int as, int nr) {
  dense_backward<true>(H + 2 * R * h, h, h, graw, n_out, n_out, wb[6],
                       pwb[6], pwb[7], gh, h, nullptr, 0, nr);
  __syncthreads();
  dense_backward<true>(H + R * h, h, h, gh, h, h, wb[4], pwb[4], pwb[5],
                       gh + R * h, h, nullptr, 0, nr);
  __syncthreads();
  dense_backward<true>(H, h, h, gh + R * h, h, h, wb[2], pwb[2], pwb[3], gh,
                       h, nullptr, 0, nr);
  __syncthreads();
  dense_backward<false>(in, is, n_in, gh, h, h, wb[0], pwb[0], pwb[1], gin,
                        gis, add, as, nr);
  __syncthreads();
}

// Each row's per-dim logdets (n of them) added to its row logdet in order.
__device__ inline void row_sums(const Tile& T, int n, int cut, int nr) {
  for (int r = threadIdx.x; r < nr; r += kThreads) {
    float s = 0.0f;
    for (int j = 0; j < n; ++j) s += T.ldl[r * cut + j];
    T.ld[r] += s;
  }
}

// One flow block forward on the tile's rows, from T.x: the block's output
// back into T.x and the RQS logdets into T.ld. With rec, each row's record
// (the block's input x and every activation the backward reads) goes
// there.
template <int K>
__device__ void block_forward(const float* const* p, const Dims& D,
                              const Tile& T, int nr, float* rec) {
  constexpr int P = 3 * K - 1;
  const int d = D.d, cut = D.cut, up = D.up;
  if (rec) records<true>(T, D, P, rec, 0, 1, nr);
  for (int i = threadIdx.x; i < nr * d; i += kThreads)
    T.a[i] = T.x[i] * expf(__ldg(p[kS] + i % d)) + __ldg(p[kT] + i % d);
  __syncthreads();
  dense<false>(T.a, d, d, p[kW], nullptr, d, T.c, d, nr);
  __syncthreads();
  mlp_forward(T.c, d, cut, p + kF1, D.h, T.h1, D.rows, T.raw1, up * P, nr);
  for (int i = threadIdx.x; i < nr * up; i += kThreads) {
    const int r = i / up, j = i - r * up;
    const float v = T.c[r * d + cut + j];
    Lane<K> lane;
    lane.make(T.raw1 + (size_t)i * P, v, D.B);
    const float y = lane.y(v);
    T.u[i] = y;
    T.x[r * d + cut + j] = y;
    T.ldl[r * cut + j] = lane.logdet();
  }
  __syncthreads();
  row_sums(T, up, cut, nr);
  mlp_forward(T.u, up, up, p + kF2, D.h, T.h2, D.rows, T.raw2, cut * P, nr);
  for (int i = threadIdx.x; i < nr * cut; i += kThreads) {
    const int r = i / cut, j = i - r * cut;
    const float v = T.c[r * d + j];
    Lane<K> lane;
    lane.make(T.raw2 + (size_t)i * P, v, D.B);
    T.x[r * d + j] = lane.y(v);
    T.ldl[i] = lane.logdet();
  }
  __syncthreads();
  row_sums(T, cut, cut, nr);
  if (rec) {
    records<true>(T, D, P, rec, 1, 8, nr);
    __syncthreads();
  }
}

// dL/d raw and d/d x of one RQS lane into graw (P floats) and gx.
template <int K>
__device__ inline void rqs_backward(const float* o, float x, float gy,
                                    float gl, float B, float* graw,
                                    float* gx) {
  constexpr int P = 3 * K - 1;
  Lane<K> lane;
  lane.make(o, x, B);
  float g[P];
  *gx = lane.grad(o, gy, gl, B, g);
#pragma unroll
  for (int k = 0; k < P; ++k) graw[k] = g[k];
}

// One flow block backward, on the tile its records filled: from T.gz (dL/d
// the block's output) and T.gl, d/d the block's input into T.gz and the
// block's partial gradients into part (table order).
template <int K>
__device__ void block_backward(const float* const* p, const Dims& D,
                               const Tile& T, int nr, float* part) {
  constexpr int P = 3 * K - 1;
  const int d = D.d, cut = D.cut, up = D.up, h = D.h;
  float* pt[kTensors];
  float* q = part;
  for (int i = 0; i < kTensors; ++i) {
    pt[i] = q;
    q += tensor_floats(i, d, h, P);
  }
  // the lower half's RQS
  for (int i = threadIdx.x; i < nr * cut; i += kThreads) {
    const int r = i / cut, j = i - r * cut;
    rqs_backward<K>(T.raw2 + (size_t)i * P, T.c[r * d + j], T.gz[r * d + j],
                    T.gl[r], D.B, T.graw + (size_t)i * P, T.gc + r * d + j);
  }
  __syncthreads();
  // f2, which read u: d/du joins dL/du from the block's output
  mlp_backward(T.u, up, up, T.h2, h, D.rows, T.graw, cut * P, p + kF2,
               pt + kF2, T.gh, T.gu, up, T.gz + cut, d, nr);
  // the upper half's RQS
  for (int i = threadIdx.x; i < nr * up; i += kThreads) {
    const int r = i / up, j = i - r * up;
    rqs_backward<K>(T.raw1 + (size_t)i * P, T.c[r * d + cut + j], T.gu[i],
                    T.gl[r], D.B, T.graw + (size_t)i * P,
                    T.gc + r * d + cut + j);
  }
  __syncthreads();
  // f1, which read c's lower half: d/dc there joins the lower RQS's d/dx
  mlp_backward(T.c, d, cut, T.h1, h, D.rows, T.graw, up * P, p + kF1,
               pt + kF1, T.gh, T.gc, d, T.gc, d, nr);
  // the conv: dL/dW = a^T dL/dc, dL/da = dL/dc W^T
  dense_backward<false>(T.a, d, d, T.gc, d, d, p[kW], pt[kW], nullptr, T.ga,
                        d, nullptr, 0, nr);
  __syncthreads();
  // ActNorm: dL/ds = sum_r (dL/da x) exp(s), dL/dt = sum_r dL/da,
  // dL/dx = dL/da exp(s)
  for (int i = threadIdx.x; i < nr * d + d; i += kThreads) {
    if (i < nr * d) {
      T.gz[i] = T.ga[i] * expf(__ldg(p[kS] + i % d));
    } else {
      const int k = i - nr * d;
      float gs = 0.0f, gt = 0.0f;
      for (int r = 0; r < nr; ++r) {
        const float g = T.ga[r * d + k];
        gs = fmaf(g, T.x[r * d + k], gs);
        gt += g;
      }
      pt[kS][k] = gs * expf(__ldg(p[kS] + k));
      pt[kT][k] = gt;
    }
  }
  __syncthreads();
}

template <int K>
__global__ void __launch_bounds__(kThreads)
    chain_forward_kernel(Table tab, int blocks, const float* __restrict__ x,
                         float* __restrict__ z, float* __restrict__ logdet,
                         float* __restrict__ saved, Dims D) {
  extern __shared__ float sm[];
  const Tile T = make_tile(sm, D, 3 * K - 1, false);
  const float* const* tp = load_table(tab);
  const int r0 = blockIdx.x * D.rows;
  const int nr = min(D.rows, D.n - r0);
  const size_t base = (size_t)r0 * D.d;
  for (int i = threadIdx.x; i < nr * D.d; i += kThreads) T.x[i] = x[base + i];
  for (int r = threadIdx.x; r < nr; r += kThreads) T.ld[r] = 0.0f;
  __syncthreads();
  const int rf = record_floats(D.d, D.h, 3 * K - 1);
  for (int b = 0; b < blocks; ++b)
    block_forward<K>(tp + b * kTensors, D, T, nr,
                     saved ? saved + ((size_t)b * D.n + r0) * rf : nullptr);
  __syncthreads();
  for (int i = threadIdx.x; i < nr * D.d; i += kThreads) z[base + i] = T.x[i];
  for (int r = threadIdx.x; r < nr; r += kThreads) logdet[r0 + r] = T.ld[r];
}

template <int K>
__global__ void __launch_bounds__(kThreads)
    chain_backward_kernel(Table tab, int blocks,
                          const float* __restrict__ saved,
                          const float* __restrict__ gz,
                          const float* __restrict__ gl, float* gx,
                          float* __restrict__ partial, int total, Dims D) {
  extern __shared__ float sm[];
  const Tile T = make_tile(sm, D, 3 * K - 1, true);
  const float* const* tp = load_table(tab);
  const int r0 = blockIdx.x * D.rows;
  const int nr = min(D.rows, D.n - r0);
  const size_t base = (size_t)r0 * D.d;
  const int bf = total / blocks;
  for (int i = threadIdx.x; i < nr * D.d; i += kThreads)
    T.gz[i] = gz[base + i];
  for (int r = threadIdx.x; r < nr; r += kThreads) T.gl[r] = gl[r0 + r];
  float* part = partial + (size_t)blockIdx.x * total;
  const int rf = record_floats(D.d, D.h, 3 * K - 1);
  for (int b = blocks - 1; b >= 0; --b) {
    records<false>(T, D, 3 * K - 1,
                   const_cast<float*>(saved) + ((size_t)b * D.n + r0) * rf, 0,
                   8, nr);
    __syncthreads();
    block_backward<K>(tp + b * kTensors, D, T, nr, part + (size_t)b * bf);
  }
  if (gx)
    for (int i = threadIdx.x; i < nr * D.d; i += kThreads)
      gx[base + i] = T.gz[i];
}

// out[p] = sum over thread blocks g = 0, 1, ... of partial[g][p].
__global__ void __launch_bounds__(kThreads)
    chain_reduce_kernel(const float* __restrict__ partial, int grid,
                        int total, float* __restrict__ out) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= total) return;
  float acc = 0.0f;
  for (int g = 0; g < grid; ++g) acc += partial[(size_t)g * total + p];
  out[p] = acc;
}

// Lets `kernel` take up to the card's shared memory, once per device.
template <typename F>
cudaError_t allow_shared(F kernel, bool* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxSharedBytes);
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

bool make_args(const void* const* tensors, int blocks, int n, int d,
               int hidden, int num_bins, float tail_bound, int rows,
               bool backward, Table* tab, Dims* D, size_t* smem) {
  if (blocks < 1 || blocks > kMaxBlocks || n < 1 || d < 2 || d > kMaxDim ||
      hidden < 1 || hidden > kMaxHidden || num_bins < kMinBins ||
      num_bins > kMaxBins || !(tail_bound > 0.0f) || rows < 1)
    return false;
  *smem = sizeof(float) * (size_t)rows *
          row_floats(d, hidden, 3 * num_bins - 1, backward);
  if (*smem > (size_t)kMaxSharedBytes) return false;
  for (int b = 0; b < blocks; ++b)
    for (int i = 0; i < kTensors; ++i) {
      tab->p[b * kTensors + i] =
          static_cast<const float*>(tensors[b * kTensors + i]);
      if (!tab->p[b * kTensors + i]) return false;
    }
  const int cut = d - d / 2;
  *D = Dims{n, d, cut, d - cut, hidden, rows, tail_bound};
  return true;
}

template <int K>
int forward(const Table& tab, int blocks, const float* x, float* z,
            float* logdet, float* saved, const Dims& D, size_t smem,
            cudaStream_t s) {
  static bool done[64] = {};
  cudaError_t err = allow_shared(chain_forward_kernel<K>, done);
  if (err != cudaSuccess) return (int)err;
  const int grid = (D.n + D.rows - 1) / D.rows;
  chain_forward_kernel<K><<<grid, kThreads, smem, s>>>(tab, blocks, x, z,
                                                       logdet, saved, D);
  return (int)cudaGetLastError();
}

template <int K>
int backward(const Table& tab, int blocks, const float* saved,
             const float* gz, const float* gl, float* gx, float* partial,
             int total, const Dims& D, size_t smem, cudaStream_t s) {
  static bool done[64] = {};
  cudaError_t err = allow_shared(chain_backward_kernel<K>, done);
  if (err != cudaSuccess) return (int)err;
  const int grid = (D.n + D.rows - 1) / D.rows;
  chain_backward_kernel<K><<<grid, kThreads, smem, s>>>(
      tab, blocks, saved, gz, gl, gx, partial, total, D);
  return (int)cudaGetLastError();
}

}  // namespace

// One bin count a library (ops/spline_chain.py builds one a count, with
// -DNNEST_CHAIN_BINS=K): the fifteen instantiations together take nvcc
// about two minutes, one about a fifteenth of that.
#ifndef NNEST_CHAIN_BINS
#error "build with -DNNEST_CHAIN_BINS=<bins>"
#endif
static_assert(NNEST_CHAIN_BINS >= kMinBins && NNEST_CHAIN_BINS <= kMaxBins,
              "NNEST_CHAIN_BINS out of range");

extern "C" {

// Floats of a row's record of one flow block (the wrapper checks its saved
// buffer against this).
int nnest_chain_record_floats(int d, int hidden, int num_bins) {
  return record_floats(d, hidden, 3 * num_bins - 1);
}

// x (n x d) -> z (n x d) and the RQS row logdet (n), through `blocks` flow
// blocks of NNEST_CHAIN_BINS bins whose tensors are `tensors` (kTensors a
// block, table order), with `rows` rows a thread block, on `stream`.
// `saved` (blocks x n x nnest_chain_record_floats), if not null, takes each
// row's record of each block. Returns the launch's cudaError_t; arguments
// it does not take give cudaErrorInvalidValue.
int nnest_chain_forward(const void* const* tensors, int blocks,
                        const float* x, float* z, float* logdet, float* saved,
                        int n, int d, int hidden, int num_bins,
                        float tail_bound, int rows, void* stream) {
  Table tab;
  Dims D;
  size_t smem;
  if (!make_args(tensors, blocks, n, d, hidden, num_bins, tail_bound, rows,
                 false, &tab, &D, &smem) || !x || !z || !logdet)
    return (int)cudaErrorInvalidValue;
  if (num_bins != NNEST_CHAIN_BINS) return (int)cudaErrorInvalidValue;
  return forward<NNEST_CHAIN_BINS>(tab, blocks, x, z, logdet, saved, D, smem,
                                   static_cast<cudaStream_t>(stream));
}

// From the forward's `saved` and dL/dz (n x d) and dL/d row logdet (n):
// dL/dx into gx (n x d; skipped if null) and each thread block's partial
// gradients into partial (grid x total floats, total = blocks x a block's
// tensors' floats, table order), grid = ceil(n / rows).
int nnest_chain_backward(const void* const* tensors, int blocks,
                         const float* saved, const float* gz, const float* gl,
                         float* gx, float* partial, int total, int n, int d,
                         int hidden, int num_bins, float tail_bound, int rows,
                         void* stream) {
  Table tab;
  Dims D;
  size_t smem;
  if (!make_args(tensors, blocks, n, d, hidden, num_bins, tail_bound, rows,
                 true, &tab, &D, &smem) || !saved || !gz || !gl ||
      !partial || total != blocks * block_floats(d, hidden, 3 * num_bins - 1))
    return (int)cudaErrorInvalidValue;
  if (num_bins != NNEST_CHAIN_BINS) return (int)cudaErrorInvalidValue;
  return backward<NNEST_CHAIN_BINS>(tab, blocks, saved, gz, gl, gx, partial,
                                    total, D, smem,
                                    static_cast<cudaStream_t>(stream));
}

// out (total) = the sum of partial's grid slices, in slice order.
int nnest_chain_reduce(const float* partial, int grid, int total, float* out,
                       void* stream) {
  if (!partial || !out || grid < 1 || total < 1)
    return (int)cudaErrorInvalidValue;
  chain_reduce_kernel<<<(total + kThreads - 1) / kThreads, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(partial, grid,
                                                             total, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
