// The spline coupling's transform in training: RQS forward and its
// backward on Hopper (sm_90a).
//
// Replaces no TPU kernel. The JAX package trains in plain XLA
// (nnest_tpu/training/trainer.py), which fuses the transform's elementwise
// work itself; PyTorch runs it as ~200 small kernels a coupling half
// forward and ~260 backward (the knots' two normalisations, the cumsums,
// the one-hot bin selection, the RQS and their gradients), each over
// 100 x 1 to 100 x 25 lanes in a training step. This pair computes the
// same function in one launch each. The plain PyTorch versions are in
// nnest_torch/ops/spline_coupling.py: the forward is bijectors/rqs.py's
// knots + rqs(inverse=False) + row sum, the backward a hand-derived twin
// held to autograd on the CPU.
//
// For each (row, dim) of a coupling half, with o = the conditioner MLP's
// raw output for that dim ([K widths | K heights | K-1 derivatives]) and x
// the value transformed, the RQS forward and its backward are
// rqs_device.cuh's (shared with the whole chain's pair, spline_chain.cu):
//   - forward: y, and each row's logdet summed over its dims in order;
//   - backward: from the same inputs recomputed (nothing else is saved),
//     d/d raw (3K-1 a dim) and d/dx.
//
// Bound. At the training shapes (100 rows x 1..25 dims, K = 8) a launch
// moves ~10-60 KB and computes ~1e5-1e6 f32 operations: under a
// microsecond of HBM or FMA time. What bounds it is launch latency, and
// what the pair saves is the ~450 launches a coupling half it replaces.
//
// Design against that: every intermediate lives in registers (K is a
// template argument, so the per-bin arrays are unrolled); a thread owns a
// (row, dim); the forward's row sums go through shared memory in a fixed
// order, one thread a row, so a thread block owns whole rows; the backward
// needs no reduction (each dim's raw outputs are its own). No atomics, so
// the same inputs give the same bits on every launch. f32 throughout, no
// fast-math intrinsics.

#include <cuda_runtime.h>

#include "rqs_device.cuh"

namespace {

using nnest_rqs::Lane;

constexpr int kThreads = 256;
// Bin counts taken (one instantiation each; ops/spline_coupling.py's
// MIN_BINS and MAX_BINS). One bin is left out: the plain code then has no
// boundary derivatives (its pins are slices of an empty tensor) and is no
// spline.
constexpr int kMinBins = 2;
constexpr int kMaxBins = 16;
// Most dims a half may have (MAX_DIMS): one row's logdets fill at most
// 48 KB of shared memory.
constexpr int kMaxDims = 12288;
// Forward: a block owns `rows_per_block` whole rows; each thread walks
// their (row, dim) lanes, then one thread a row sums its logdets in order.
template <int K>
__global__ void __launch_bounds__(kThreads)
    coupling_forward_kernel(const float* __restrict__ raw,
                            const float* __restrict__ x, int x_stride,
                            float* __restrict__ y, float* __restrict__ logdet,
                            int rows, int n, int rows_per_block, float B) {
  extern __shared__ float lds[];
  const int r0 = blockIdx.x * rows_per_block;
  const int nr = min(rows_per_block, rows - r0);
  const int lanes = nr * n;
  for (int i = threadIdx.x; i < lanes; i += blockDim.x) {
    const int r = r0 + i / n;
    const int j = i % n;
    const float xv = x[(size_t)r * x_stride + j];
    Lane<K> lane;
    lane.make(raw + ((size_t)r * n + j) * (3 * K - 1), xv, B);
    y[(size_t)r * n + j] = lane.y(xv);
    lds[i] = lane.logdet();
  }
  __syncthreads();
  for (int r = threadIdx.x; r < nr; r += blockDim.x) {
    float sum = 0.0f;
    for (int j = 0; j < n; ++j) sum += lds[r * n + j];
    logdet[r0 + r] = sum;
  }
}

// Backward: one thread a (row, dim), no reduction.
template <int K>
__global__ void __launch_bounds__(kThreads)
    coupling_backward_kernel(const float* __restrict__ raw,
                             const float* __restrict__ x, int x_stride,
                             const float* __restrict__ gy, int gy_stride,
                             const float* __restrict__ gl,
                             float* __restrict__ graw,
                             float* __restrict__ gx, int rows, int n,
                             float B) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)rows * n) return;
  const int r = (int)(i / n);
  const int j = (int)(i % n);
  const float xv = x[(size_t)r * x_stride + j];
  const float* o = raw + (size_t)i * (3 * K - 1);
  Lane<K> lane;
  lane.make(o, xv, B);
  float g[3 * K - 1];
  gx[i] = lane.grad(o, gy[(size_t)r * gy_stride + j], gl[r], B, g);
  float* out = graw + (size_t)i * (3 * K - 1);
#pragma unroll
  for (int k = 0; k < 3 * K - 1; ++k) out[k] = g[k];
}

int rows_per_block(int n) { return n >= kThreads ? 1 : kThreads / n; }

template <int K>
int forward(const float* raw, const float* x, int x_stride, float* y,
            float* logdet, int rows, int n, float B, cudaStream_t s) {
  const int rpb = rows_per_block(n);
  const int grid = (rows + rpb - 1) / rpb;
  const size_t smem = sizeof(float) * (size_t)rpb * n;
  coupling_forward_kernel<K><<<grid, kThreads, smem, s>>>(
      raw, x, x_stride, y, logdet, rows, n, rpb, B);
  return (int)cudaGetLastError();
}

template <int K>
int backward(const float* raw, const float* x, int x_stride, const float* gy,
             int gy_stride, const float* gl, float* graw, float* gx, int rows,
             int n, float B, cudaStream_t s) {
  const long long lanes = (long long)rows * n;
  const int grid = (int)((lanes + kThreads - 1) / kThreads);
  coupling_backward_kernel<K><<<grid, kThreads, 0, s>>>(
      raw, x, x_stride, gy, gy_stride, gl, graw, gx, rows, n, B);
  return (int)cudaGetLastError();
}

bool valid(int rows, int n, int num_bins, float B) {
  return rows >= 1 && n >= 1 && n <= kMaxDims && num_bins >= kMinBins &&
         num_bins <= kMaxBins && B > 0.0f;
}

}  // namespace

#define NNEST_BINS(X) \
  X(2) X(3) X(4) X(5) X(6) X(7) X(8) X(9) X(10) X(11) X(12) X(13) \
  X(14) X(15) X(16)

extern "C" {

// raw (rows x n x (3 num_bins - 1)) and x (rows x n, rows x_stride apart)
// -> y (rows x n) and logdet (rows), on `stream`. Returns the launch's
// cudaError_t (0 on success); arguments it does not take give
// cudaErrorInvalidValue.
int nnest_coupling_forward(const float* raw, const float* x, int x_stride,
                           float* y, float* logdet, int rows, int n,
                           int num_bins, float tail_bound, void* stream) {
  if (!valid(rows, n, num_bins, tail_bound) || x_stride < n)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (num_bins) {
#define NNEST_CASE(K) \
  case K:             \
    return forward<K>(raw, x, x_stride, y, logdet, rows, n, tail_bound, s);
    NNEST_BINS(NNEST_CASE)
#undef NNEST_CASE
  }
  return (int)cudaErrorInvalidValue;
}

// The backward from the same raw and x and the gradients of y (rows x n,
// rows gy_stride apart) and of logdet (rows): graw (rows x n x
// (3 num_bins - 1)) and gx (rows x n).
int nnest_coupling_backward(const float* raw, const float* x, int x_stride,
                            const float* gy, int gy_stride, const float* gl,
                            float* graw, float* gx, int rows, int n,
                            int num_bins, float tail_bound, void* stream) {
  if (!valid(rows, n, num_bins, tail_bound) || x_stride < n ||
      gy_stride < n)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (num_bins) {
#define NNEST_CASE(K)                                                      \
  case K:                                                                  \
    return backward<K>(raw, x, x_stride, gy, gy_stride, gl, graw, gx, rows, \
                       n, tail_bound, s);
    NNEST_BINS(NNEST_CASE)
#undef NNEST_CASE
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
