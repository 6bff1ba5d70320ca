// Whole single-speed spline-flow inverse on Hopper (sm_90a).
//
// Replaces nnest_tpu/ops/pallas_spline.py::pallas_inverse_from_consts (the
// Pallas TPU kernel) and its production XLA twin
// nnest_tpu/ops/fused_spline.py::_inverse_body. The plain PyTorch twin is
// nnest_torch/ops/fused_spline.py::_inverse_body; the wrapper and the launch
// counter are in nnest_torch/ops/spline_inverse.py.
//
// For every row z in R^d and every flow block b, walked from last to first
// (first_block + num_blocks - 1 down to first_block):
//   1. lower half (cut = ceil(d/2) dims) <- RQS^-1 with knots from MLP f2 on
//      the upper half;
//   2. upper half <- RQS^-1 with knots from MLP f1 on the new lower half;
//   3. z <- z @ W^-1, then (z - t) * exp(-s).
// logdet accumulates the per-dim RQS terms; with include_const it also gets
// the data-independent -sum(s) - sum(log|S|) packed after the last block.
//
// Design. A thread block owns rows_per_block rows and keeps everything for
// them in shared memory: the state, the MLP activations (two ping-pong
// buffers of width `hidden`), the conditioner outputs and the per-dim
// logdets. A dense layer assigns one (row, output column) pair per thread
// and accumulates in f32 FMA, reading the weights through the read-only
// path: at d = 50, hidden 64 the six conditioners are ~1.1 MB, far more
// than shared memory holds, while a block's 1-16 rows reuse each weight
// from L1/L2. The RQS inverse runs one (row, dim) pair per thread in
// registers: double softmax / softplus, the bin pick by the comparisons
// y >= edge_k (last edge + 1e-6) as a one-hot sum, and the quadratic root
// with the reference's clamp, 1e-12 guard and clip. The Mosaic-only
// segment matrices of the Pallas kernel have no counterpart here.
//
// Bound. At the main path's shapes (d = 16, hidden 32, 256 rows) the work is
// ~1e5 f32 operations per row against ~0.2 MB of weights, so the f32 rate
// (67 TFLOP/s), not the 3.35 TB/s of HBM, sets the least time; the kernel
// itself is latency-bound (a chain of dependent layers per row), which is
// why a block takes few rows and the grid is sized to cover the SMs.
//
// Parameter layout (float32, per block, blocks back to back, then one float
// holding the constant logdet):
//   s[d] t[d] winv[d*d] f2 f1
// with each MLP (n_in -> hidden -> hidden -> hidden -> n_out, weights in
// (n_in, n_out) row-major order) stored as w0 b0 w1 b1 w2 b2 w3 b3.
// f2 reads the d - cut upper dims and writes cut*(3K-1) outputs; f1 reads
// the cut lower dims and writes (d - cut)*(3K-1). Output columns per dim
// are [K widths | K heights | K-1 derivatives].

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 128;
constexpr double kMinBinWidth = 1e-3;
constexpr double kMinBinHeight = 1e-3;
constexpr double kMinDerivative = 1e-3;
// log(exp(1 - kMinDerivative) - 1), rounded to float as rqs.py rounds it.
constexpr float kPin = 0.5397424172369522f;

__host__ __device__ inline int mlp_floats(int n_in, int hidden, int n_out) {
  return n_in * hidden + hidden + 2 * (hidden * hidden + hidden) +
         hidden * n_out + n_out;
}

__host__ __device__ inline int block_floats(int d, int hidden, int per) {
  const int cut = d - d / 2;
  const int up = d - cut;
  return 2 * d + d * d + mlp_floats(up, hidden, cut * per) +
         mlp_floats(cut, hidden, up * per);
}

// out[r, j] = act(sum_k in[r, k] * w[k, j] + b[j]) for r < rows, j < n_out.
__device__ void dense(const float* __restrict__ w, const float* __restrict__ b,
                      const float* in, int in_stride, int n_in, float* out,
                      int n_out, int rows, bool leaky) {
  for (int idx = threadIdx.x; idx < rows * n_out; idx += blockDim.x) {
    const int r = idx / n_out;
    const int j = idx - r * n_out;
    const float* xr = in + r * in_stride;
    float acc = 0.0f;
    for (int k = 0; k < n_in; ++k) {
      acc = fmaf(xr[k], __ldg(w + k * n_out + j), acc);
    }
    acc += __ldg(b + j);
    if (leaky) acc = acc >= 0.0f ? acc : 0.2f * acc;
    out[r * n_out + j] = acc;
  }
  __syncthreads();
}

// The 4-layer LeakyReLU(0.2) conditioner; result in `out` (rows x n_out).
__device__ void mlp(const float* p, const float* in, int in_stride, int n_in,
                    int hidden, int n_out, float* ha, float* hb, float* out,
                    int rows) {
  const float* w0 = p;
  const float* b0 = w0 + n_in * hidden;
  const float* w1 = b0 + hidden;
  const float* b1 = w1 + hidden * hidden;
  const float* w2 = b1 + hidden;
  const float* b2 = w2 + hidden * hidden;
  const float* w3 = b2 + hidden;
  const float* b3 = w3 + hidden * n_out;
  dense(w0, b0, in, in_stride, n_in, ha, hidden, rows, true);
  dense(w1, b1, ha, hidden, hidden, hb, hidden, rows, true);
  dense(w2, b2, hb, hidden, hidden, ha, hidden, rows, true);
  dense(w3, b3, ha, hidden, hidden, out, n_out, rows, false);
}

// jax.nn.softplus: log1p(exp(-|x|)) + max(x, 0).
__device__ inline float softplus(float v) {
  return log1pf(expf(-fabsf(v))) + fmaxf(v, 0.0f);
}

// In-place softmax of a[0..K).
template <int K>
__device__ inline void softmax(float* a) {
  float m = a[0];
#pragma unroll
  for (int k = 1; k < K; ++k) m = fmaxf(m, a[k]);
  float sum = 0.0f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    a[k] = expf(a[k] - m);
    sum += a[k];
  }
#pragma unroll
  for (int k = 0; k < K; ++k) a[k] = a[k] / sum;
}

// Knots from the conditioner's (already 2B * softmax) sizes: normalise
// again, floor at the minimum size, cumulate to [-B, B] with the ends pinned.
template <int K>
__device__ inline void edges(float* a, float min_size, float scale, float B,
                             float* e) {
  softmax<K>(a);
  const float two_b = 2.0f * B;
  float cum = 0.0f;
  e[0] = -B;
#pragma unroll
  for (int k = 0; k < K - 1; ++k) {
    cum += min_size + scale * a[k];
    e[k + 1] = two_b * cum - B;
  }
  e[K] = B;
}

// RQS inverse of one value y with the conditioner outputs o[0..3K-1).
// The one-hot selection forms seven weighted sums over all K bins, about
// 18K operations more than picking the chosen bin after the K comparisons
// would take; chip_smoke.py's bound counts only what the function needs.
template <int K>
__device__ inline float rqs_inverse(float y, const float* o, float B,
                                    float* logabsdet) {
  const float two_b = 2.0f * B;
  float w[K], h[K], cw[K + 1], ch[K + 1], dv[K + 1];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    w[k] = o[k];
    h[k] = o[K + k];
  }
  // The reference's pre-normalisation (spline.py): 2B * softmax, softplus.
  softmax<K>(w);
  softmax<K>(h);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    w[k] = two_b * w[k];
    h[k] = two_b * h[k];
  }
  edges<K>(w, (float)kMinBinWidth, (float)(1.0 - kMinBinWidth * K), B, cw);
  edges<K>(h, (float)kMinBinHeight, (float)(1.0 - kMinBinHeight * K), B, ch);
  // Boundary derivatives pinned to 1: softplus(kPin) + min_derivative == 1.
  const float min_d = (float)kMinDerivative;
  const float pin = kPin;
  dv[0] = min_d + softplus(pin);
  dv[K] = dv[0];
#pragma unroll
  for (int k = 0; k < K - 1; ++k) {
    dv[k + 1] = min_d + softplus(softplus(o[2 * K + k]));
  }

  const float x = fminf(fmaxf(y, -B), B);
  // One-hot bin selection over the height knots, last knot bumped by 1e-6.
  float in_cw = 0.0f, in_w = 0.0f, in_ch = 0.0f, in_h = 0.0f;
  float in_delta = 0.0f, in_d = 0.0f, in_d1 = 0.0f;
  float ge_prev = x >= ch[0] ? 1.0f : 0.0f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float edge = (k + 1 == K) ? ch[K] + 1e-6f : ch[k + 1];
    const float ge_next = x >= edge ? 1.0f : 0.0f;
    const float oh = ge_prev - ge_next;
    const float wk = cw[k + 1] - cw[k];
    const float hk = ch[k + 1] - ch[k];
    in_cw += cw[k] * oh;
    in_w += wk * oh;
    in_ch += ch[k] * oh;
    in_h += hk * oh;
    in_delta += (hk / wk) * oh;
    in_d += dv[k] * oh;
    in_d1 += dv[k + 1] * oh;
    ge_prev = ge_next;
  }

  const float d_sum = in_d + in_d1 - 2.0f * in_delta;
  const float y_rel = x - in_ch;
  const float a = in_h * (in_delta - in_d) + y_rel * d_sum;
  const float b = in_h * in_d - y_rel * d_sum;
  const float c = -in_delta * y_rel;
  const float disc = fmaxf(b * b - 4.0f * a * c, 0.0f);
  const float denom = -b - sqrtf(disc);
  float root = fabsf(denom) > 1e-12f ? 2.0f * c / denom : 0.0f;
  root = fminf(fmaxf(root, 0.0f), 1.0f);
  const float out = root * in_w + in_cw;
  const float t1mt = root * (1.0f - root);
  const float omr = 1.0f - root;
  const float den = in_delta + d_sum * t1mt;
  const float dnum = in_delta * in_delta *
                     (in_d1 * root * root + 2.0f * in_delta * t1mt +
                      in_d * omr * omr);
  const bool inside = (y >= -B) && (y <= B);
  *logabsdet = inside ? -(logf(dnum) - 2.0f * logf(den)) : 0.0f;
  return inside ? out : y;
}

// RQS inverse of dims [off, off + n_dims) of every row, in place; the
// per-dim logdets go to lds (rows x d).
template <int K>
__device__ void rqs_half(float* zs, int d, int off, int n_dims,
                         const float* cond, float* lds, int rows, float B) {
  constexpr int P = 3 * K - 1;
  for (int idx = threadIdx.x; idx < rows * n_dims; idx += blockDim.x) {
    const int r = idx / n_dims;
    const int j = idx - r * n_dims;
    float* y = zs + r * d + off + j;
    float la;
    *y = rqs_inverse<K>(*y, cond + (r * n_dims + j) * P, B, &la);
    lds[r * d + off + j] = la;
  }
  __syncthreads();
}

template <int K>
__global__ void __launch_bounds__(kThreads)
spline_inverse_kernel(const float* __restrict__ z,
                      const float* __restrict__ params, float* __restrict__ x,
                      float* __restrict__ logdet, int n, int d, int hidden,
                      int first_block, int num_blocks, int include_const,
                      float B, int rows_per_block, int const_offset) {
  constexpr int P = 3 * K - 1;
  const int cut = d - d / 2;
  const int up = d - cut;
  const int T = rows_per_block;
  const size_t row0 = (size_t)blockIdx.x * T;
  const int rows = min(T, (int)(n - row0));

  extern __shared__ float smem[];
  float* zs = smem;                    // T*d: the state
  float* tmp = zs + T * d;             // T*d: conv output
  float* lds = tmp + T * d;            // T*d: per-dim RQS logdets
  float* ha = lds + T * d;             // T*hidden
  float* hb = ha + T * hidden;         // T*hidden
  float* cond = hb + T * hidden;       // T*cut*P: conditioner outputs
  float* ldrow = cond + T * cut * P;   // T: running logdet

  for (int i = threadIdx.x; i < rows * d; i += blockDim.x) {
    zs[i] = z[row0 * d + i];
  }
  for (int r = threadIdx.x; r < rows; r += blockDim.x) ldrow[r] = 0.0f;
  __syncthreads();

  const int bsize = block_floats(d, hidden, P);
  for (int blk = first_block + num_blocks - 1; blk >= first_block; --blk) {
    const float* s = params + (size_t)blk * bsize;
    const float* t = s + d;
    const float* winv = t + d;
    const float* f2 = winv + d * d;
    const float* f1 = f2 + mlp_floats(up, hidden, cut * P);

    mlp(f2, zs + cut, d, up, hidden, cut * P, ha, hb, cond, rows);
    rqs_half<K>(zs, d, 0, cut, cond, lds, rows, B);
    mlp(f1, zs, d, cut, hidden, up * P, ha, hb, cond, rows);
    rqs_half<K>(zs, d, cut, up, cond, lds, rows, B);

    for (int r = threadIdx.x; r < rows; r += blockDim.x) {
      float lo = 0.0f, hi = 0.0f;
      for (int j = 0; j < cut; ++j) lo += lds[r * d + j];
      for (int j = cut; j < d; ++j) hi += lds[r * d + j];
      ldrow[r] += lo + hi;
    }
    for (int idx = threadIdx.x; idx < rows * d; idx += blockDim.x) {
      const int r = idx / d;
      const int j = idx - r * d;
      float acc = 0.0f;
      for (int k = 0; k < d; ++k) {
        acc = fmaf(zs[r * d + k], __ldg(winv + k * d + j), acc);
      }
      tmp[idx] = (acc - __ldg(t + j)) * expf(-__ldg(s + j));
    }
    __syncthreads();
    float* swap = zs;
    zs = tmp;
    tmp = swap;
  }

  const float c = include_const ? __ldg(params + const_offset) : 0.0f;
  for (int i = threadIdx.x; i < rows * d; i += blockDim.x) {
    x[row0 * d + i] = zs[i];
  }
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    logdet[row0 + r] = ldrow[r] + c;
  }
}

template <int K>
int launch(const float* z, const float* params, float* x, float* logdet,
           int n, int d, int hidden, int total_blocks, int first_block,
           int num_blocks, int include_const, float tail_bound,
           int rows_per_block, cudaStream_t stream) {
  constexpr int P = 3 * K - 1;
  const int cut = d - d / 2;
  const size_t smem =
      sizeof(float) * ((size_t)rows_per_block * (3 * d + 2 * hidden + cut * P) +
                       rows_per_block);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        spline_inverse_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int grid = (n + rows_per_block - 1) / rows_per_block;
  const int const_offset = total_blocks * block_floats(d, hidden, P);
  spline_inverse_kernel<K><<<grid, kThreads, smem, stream>>>(
      z, params, x, logdet, n, d, hidden, first_block, num_blocks,
      include_const, tail_bound, rows_per_block, const_offset);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Floats of packed parameters for one flow block (the wrapper checks its
// packing against this).
int nnest_spline_block_floats(int d, int hidden, int num_bins) {
  return block_floats(d, hidden, 3 * num_bins - 1);
}

// Inverts blocks [first_block, first_block + num_blocks) of a
// total_blocks-block flow for n rows of z (n x d, row-major) into x (n x d)
// and logdet (n). Launches on `stream` and returns the cudaError_t of the
// launch (0 on success); invalid arguments give cudaErrorInvalidValue.
int nnest_spline_inverse(const float* z, const float* params, float* x,
                         float* logdet, int n, int d, int hidden,
                         int num_bins, int total_blocks, int first_block,
                         int num_blocks, int include_const, float tail_bound,
                         int rows_per_block, void* stream) {
  if (n < 1 || d < 2 || hidden < 1 || rows_per_block < 1 || first_block < 0 ||
      num_blocks < 1 || first_block + num_blocks > total_blocks) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (num_bins) {
    case 8:
      return launch<8>(z, params, x, logdet, n, d, hidden, total_blocks,
                       first_block, num_blocks, include_const, tail_bound,
                       rows_per_block, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
