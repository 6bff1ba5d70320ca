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
// the value transformed:
//   - the reference's pre-normalisation (bijectors/spline.py): widths and
//     heights 2B * softmax, derivatives softplus;
//   - rqs's own: softmax again, sizes floored at 1e-3, cumulated to knots
//     with the ends pinned to -B and B; end derivatives pinned to 1 through
//     the softplus-inverse constant, 1e-3 + softplus of the interior ones;
//   - the bin from the same edge comparisons (last edge + 1e-6), theta
//     clamped to [0, 1], the RQS value and log-derivative, identity tails
//     outside [-B, B];
//   - forward: y, and each row's logdet summed over its dims in order;
//   - backward: from the same inputs recomputed (nothing else is saved),
//     d/d raw (3K-1 a dim) and d/dx, the gradients autograd gives through
//     the plain code: zero through the clamp where theta is clamped, only
//     d/dx = 1 in the tails, nothing through the bin selection.
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

namespace {

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
constexpr float kMinBinWidth = 1e-3f;
constexpr float kMinBinHeight = 1e-3f;
constexpr float kMinDerivative = 1e-3f;
// log(exp(1 - min_derivative) - 1), rounded to float as rqs.py rounds it.
constexpr float kPin = 0.5397424172369522f;

// jax.nn.softplus: log1p(exp(-|x|)) + max(x, 0).
__device__ inline float softplus(float v) {
  return log1pf(expf(-fabsf(v))) + fmaxf(v, 0.0f);
}

// What autograd gives for that form: -sgn(v) e / (1 + e) + [v >= 0] with
// e = exp(-|v|) (so 1 at v == 0).
__device__ inline float softplus_grad(float v) {
  const float e = expf(-fabsf(v));
  const float sgn = v > 0.0f ? 1.0f : (v < 0.0f ? -1.0f : 0.0f);
  return (v >= 0.0f ? 1.0f : 0.0f) - sgn * (e / (1.0f + e));
}

template <int K>
__device__ inline void softmax(const float* a, float* p) {
  float m = a[0];
#pragma unroll
  for (int k = 1; k < K; ++k) m = fmaxf(m, a[k]);
  float sum = 0.0f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    p[k] = expf(a[k] - m);
    sum += p[k];
  }
#pragma unroll
  for (int k = 0; k < K; ++k) p[k] = p[k] / sum;
}

// dL/da of p = softmax(a) from dL/dp (in place): p (g - sum(g p)).
template <int K>
__device__ inline void softmax_grad(const float* p, float* g) {
  float dot = 0.0f;
#pragma unroll
  for (int k = 0; k < K; ++k) dot += g[k] * p[k];
#pragma unroll
  for (int k = 0; k < K; ++k) g[k] = p[k] * (g[k] - dot);
}

// One side of the knots (widths or heights): p = softmax(raw), n = 2B p
// (the reference's pre-normalisation), s = softmax(n), then the K+1 edges
// 2B cumsum(min + scale s) - B with the ends pinned.
template <int K>
struct Side {
  float p[K], s[K], e[K + 1];

  __device__ inline void make(const float* raw, float min_size, float B) {
    const float two_b = 2.0f * B;
    const float scale = 1.0f - min_size * K;
    float n[K];
    softmax<K>(raw, p);
#pragma unroll
    for (int k = 0; k < K; ++k) n[k] = two_b * p[k];
    softmax<K>(n, s);
    float cum = 0.0f;
    e[0] = -B;
#pragma unroll
    for (int k = 0; k < K - 1; ++k) {
      cum += min_size + scale * s[k];
      e[k + 1] = two_b * cum - B;
    }
    e[K] = B;
  }

  // dL/draw from dL/de (the interior edges; the pinned ends take none).
  __device__ inline void grad(const float* ge, float min_size, float B,
                              float* graw) const {
    const float two_b = 2.0f * B;
    const float scale = 1.0f - min_size * K;
    float g[K];
    // reverse cumsum of 2B dL/de over the sizes feeding each edge
    float acc = 0.0f;
    g[K - 1] = 0.0f;
#pragma unroll
    for (int k = K - 2; k >= 0; --k) {
      acc += two_b * ge[k + 1];
      g[k] = scale * acc;
    }
    softmax_grad<K>(s, g);
#pragma unroll
    for (int k = 0; k < K; ++k) g[k] = two_b * g[k];
    softmax_grad<K>(p, g);
#pragma unroll
    for (int k = 0; k < K; ++k) graw[k] = g[k];
  }
};

// Everything of one (row, dim) that the forward computes and the backward
// reads again.
template <int K>
struct Lane {
  Side<K> w, h;
  float d[K + 1];
  int bin;
  bool inside;
  float xc, theta_raw, theta, icw, ibw, ich, ih, delta, id, id1, d_sum,
      t1mt, num, den, poly, dnum;

  __device__ inline void make(const float* o, float x, float B) {
    w.make(o, kMinBinWidth, B);
    h.make(o + K, kMinBinHeight, B);
    d[0] = d[K] = kMinDerivative + softplus(kPin);
#pragma unroll
    for (int k = 1; k < K; ++k)
      d[k] = kMinDerivative + softplus(softplus(o[2 * K + k - 1]));
    inside = (x >= -B) && (x <= B);
    xc = fminf(fmaxf(x, -B), B);
    // how many of edges 1..K (the last bumped by 1e-6) xc has passed;
    // edge 0 is -B <= xc
    bin = 0;
#pragma unroll
    for (int k = 1; k <= K; ++k)
      bin += xc >= (k == K ? w.e[K] + 1e-6f : w.e[k]) ? 1 : 0;
    bin = min(bin, K - 1);
    icw = w.e[0];
    float icw1 = w.e[1];
    ich = h.e[0];
    float ich1 = h.e[1];
    id = d[0];
    id1 = d[1];
#pragma unroll
    for (int k = 1; k < K; ++k) {
      if (bin == k) {
        icw = w.e[k];
        icw1 = w.e[k + 1];
        ich = h.e[k];
        ich1 = h.e[k + 1];
        id = d[k];
        id1 = d[k + 1];
      }
    }
    ibw = icw1 - icw;
    ih = ich1 - ich;
    delta = ih / ibw;
    d_sum = id + id1 - 2.0f * delta;
    theta_raw = (xc - icw) / ibw;
    theta = fminf(fmaxf(theta_raw, 0.0f), 1.0f);
    t1mt = theta * (1.0f - theta);
    num = ih * (delta * theta * theta + id * t1mt);
    den = delta + d_sum * t1mt;
    const float omt = 1.0f - theta;
    poly = id1 * theta * theta + 2.0f * delta * t1mt + id * omt * omt;
    dnum = delta * delta * poly;
  }

  __device__ inline float y(float x) const {
    return inside ? ich + num / den : x;
  }

  __device__ inline float logdet() const {
    return inside ? logf(dnum) - 2.0f * logf(den) : 0.0f;
  }

  // d/d raw (3K-1 floats) and d/dx, from dL/dy and dL/dlogdet (o: the
  // raw outputs make() read).
  __device__ inline float grad(const float* o, float gy, float gl, float B,
                               float* graw) const {
    if (!inside) {
#pragma unroll
      for (int k = 0; k < 3 * K - 1; ++k) graw[k] = 0.0f;
      return gy;
    }
    // y = ich + num / den, logdet = log(dnum) - 2 log(den)
    const float g_num = gy / den;
    const float g_den = -gy * num / (den * den) - 2.0f * gl / den;
    const float g_dnum = gl / dnum;
    float g_delta = 0.0f, g_theta = 0.0f, g_t1mt = 0.0f, g_id = 0.0f,
          g_id1 = 0.0f, g_ih = 0.0f;
    // dnum = delta^2 poly, poly = id1 th^2 + 2 delta t1mt + id (1-th)^2
    const float omt = 1.0f - theta;
    const float g_poly = g_dnum * delta * delta;
    g_delta += g_dnum * poly * 2.0f * delta;
    g_id1 += g_poly * theta * theta;
    g_theta += g_poly * id1 * 2.0f * theta;
    g_delta += g_poly * 2.0f * t1mt;
    g_t1mt += g_poly * 2.0f * delta;
    g_id += g_poly * omt * omt;
    g_theta -= g_poly * id * 2.0f * omt;
    // den = delta + d_sum t1mt
    g_delta += g_den;
    const float g_dsum = g_den * t1mt;
    g_t1mt += g_den * d_sum;
    // num = ih (delta th^2 + id t1mt)
    g_ih += g_num * (delta * theta * theta + id * t1mt);
    const float g_in = g_num * ih;
    g_delta += g_in * theta * theta;
    g_theta += g_in * delta * 2.0f * theta;
    g_id += g_in * t1mt;
    g_t1mt += g_in * id;
    // t1mt = th (1 - th)
    g_theta += g_t1mt * (1.0f - 2.0f * theta);
    // d_sum = id + id1 - 2 delta
    g_id += g_dsum;
    g_id1 += g_dsum;
    g_delta -= 2.0f * g_dsum;
    // theta = clamp(theta_raw, 0, 1), theta_raw = (xc - icw) / ibw
    const float g_raw_t =
        (theta_raw >= 0.0f && theta_raw <= 1.0f) ? g_theta : 0.0f;
    const float g_xc = g_raw_t / ibw;
    float g_ibw = -g_raw_t * (xc - icw) / (ibw * ibw);
    // delta = ih / ibw
    g_ih += g_delta / ibw;
    g_ibw -= g_delta * ih / (ibw * ibw);

    // onto the edges: icw = e[bin], ibw = e[bin+1] - e[bin], the same for
    // the heights with ich = gy
    float gw[K + 1], gh[K + 1];
#pragma unroll
    for (int k = 0; k <= K; ++k) {
      gw[k] = 0.0f;
      gh[k] = 0.0f;
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (bin == k) {
        gw[k] = -g_raw_t / ibw - g_ibw;
        gw[k + 1] = g_ibw;
        gh[k] = gy - g_ih;
        gh[k + 1] = g_ih;
      }
    }
    w.grad(gw, kMinBinWidth, B, graw);
    h.grad(gh, kMinBinHeight, B, graw + K);
    // the interior derivatives: d[k] = min + softplus(softplus(raw))
#pragma unroll
    for (int k = 1; k < K; ++k) {
      const float g_d = bin == k ? g_id : (bin + 1 == k ? g_id1 : 0.0f);
      const float r = o[2 * K + k - 1];
      graw[2 * K + k - 1] =
          g_d * softplus_grad(softplus(r)) * softplus_grad(r);
    }
    return g_xc;
  }
};

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
