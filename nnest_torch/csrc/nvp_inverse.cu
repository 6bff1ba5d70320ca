// Single-speed RealNVP-flow inverse on Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package runs the NVP flow's inverse as
// plain XLA inside its chain steps (nnest_tpu/flows/model.py). It was added
// for launch count: PyTorch runs the chain's inverse as ~80 small launches a
// call, on the host's path between a Metropolis step's graphs. The plain
// PyTorch twin is nnest_torch/ops/nvp_inverse.py::nvp_inverse_twin, which
// reads the same packed buffer; the wrapper, the packing and the launch
// plan are in that module.
//
// For every row z in R^d and every coupling, the chain's last first, with
// mask m (1 on the dims the coupling passes through):
//   0. with a ScaleLayer after the coupling: z <- z exp(-s),
//      logdet -= d s;
//   1. t = t_net(z m) (1 - m), log_s = s_net(z m) (1 - m), each net a
//      3-layer MLP [d, h, h, d] (x @ W + b, ReLU for t_net and tanh for
//      s_net between the layers); no s_net when translation-only;
//   2. z <- (z - t) exp(-log_s), logdet -= sum(log_s) (z - t when
//      translation-only).
//
// Bound. At the benchmark's shapes (d 50, hidden 16, 3 couplings, 256 rows)
// a call is ~5.7 MFLOP (0.09 us at the f32 rate) and ~150 KB (z and x, the
// ~47 KB of weights: 0.05 us at HBM's rate), so neither bounds it. What it
// pays is latency: each coupling is a chain of 3 dependent dense layers and
// an affine, each ending in a barrier of the block, ~12 barriers a call.
//
// Design against that chain:
//   - One launch a call, every intermediate in shared memory. A thread
//     block owns `rows` rows (the plan picks them so that ~132 blocks are in
//     flight), so every weight read from shared memory feeds all of them.
//   - Weights staged whole, a coupling at a time. Each coupling's packed
//     segment (mask, t_net, s_net, the scale) goes into one of `stages`
//     shared buffers by 16-byte cp.async copies, all threads issuing. Where
//     every coupling fits (hidden 16 at d 50: 47 KB), all are loaded up
//     front; else (hidden 64: 85 KB a coupling at d 50) up to 4 stages
//     ring, the next coupling's copies in flight while one is computed.
//   - Each dense layer spreads its nets x rows x outputs over the block's
//     256 threads, consecutive groups on consecutive output columns (the
//     input is a broadcast); g lanes of a warp split each output's k-loop
//     (at least 4 products a lane: g 8 at n_in 50, 4 at 16) and sum by
//     shuffles. g follows from n_in alone, so a row's sums are taken in
//     the same order whatever the rows of the call: each row's result is
//     bit for bit the same at any batch size.
//   - The row sums of log_s: one warp a row, by shuffles. No atomics, so a
//     launch is deterministic.
//   - No tensor cores, no --use_fast_math: f32 FMA with expf and tanhf, as
//     the twin computes; the contract against the twin on the card is the
//     spline kernel's, 3e-5 in x and 3e-4 in logdet.
//
// Parameter layout (float32), one segment a coupling, in the order the
// kernel consumes them (the chain's last coupling first): the mask (d),
// then for t_net and, unless translation-only, s_net, each layer's W
// (n_in x n_out, JAX's (n_in, n_out) order) then its bias; then the
// ScaleLayer's s (0 without one); zero padding to a multiple of 4 floats.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxStages = 4;
constexpr int kMaxDim = 64;
constexpr int kMaxHidden = 64;

__host__ __device__ inline int ceil4(int v) { return (v + 3) & ~3; }

// Float offsets within one coupling's segment (ops/nvp_inverse.py::
// segment_layout computes the same).
struct Layout {
  int w[2][3];
  int b[2][3];
  int scale;
  int floats;
};

__host__ __device__ inline Layout segment_layout(int d, int h, int nets) {
  Layout l = {};
  int pos = d;  // the mask first
  for (int n = 0; n < nets; ++n) {
    for (int i = 0; i < 3; ++i) {
      const int n_in = i == 0 ? d : h;
      const int n_out = i == 2 ? d : h;
      l.w[n][i] = pos;
      pos += n_in * n_out;
      l.b[n][i] = pos;
      pos += n_out;
    }
  }
  l.scale = pos;
  l.floats = ceil4(pos + 1);
  return l;
}

// Floats of per-row state: z, the masked input, the nets' two hidden
// activations (h each a net), their outputs (d each a net), the logdet.
__host__ __device__ inline int row_floats(int d, int h) {
  return 4 * d + 4 * h + 1;
}

// ---------------------------------------------------------------- PTX

// 16 bytes from global `src` to shared `dst`, both 16-byte aligned.
__device__ inline void cp_async16(float* dst, const float* src) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ inline void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ inline void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Wait until at most `pending` (< kMaxStages) of this thread's copy groups
// are in flight.
__device__ inline void cp_async_wait_pending(int pending) {
  switch (pending) {
    case 0:
      cp_async_wait<0>();
      break;
    case 1:
      cp_async_wait<1>();
      break;
    case 2:
      cp_async_wait<2>();
      break;
    default:
      cp_async_wait<3>();
      break;
  }
}

// ---------------------------------------------------------------- stages

// One dense layer of `nets` nets over `rows` rows:
//   out[(n rows + r) n_out + j] = f_n(sum_k in[n in_net + r n_in + k]
//                                     W_n[k n_out + j] + b_n[j])
// with f_n ReLU (n 0) or tanh (n 1) for a hidden layer, and the product by
// the keep mask 1 - m[j] for the last. g lanes of a warp split an output's
// k-loop, g set by n_in alone (a row's sum in one order at any batch
// size); every thread runs the same number of rounds, so each shuffle has
// its whole warp.
__device__ void dense(const float* seg, const Layout& L, int layer, int nets,
                      int rows, const float* in, int in_net, int n_in,
                      float* out, int n_out, bool hidden) {
  const int outputs = nets * rows * n_out;
  int g = 1;
  while (g < 32 && 8 * g <= n_in) g *= 2;
  const int per = kThreads / g;
  const int part = threadIdx.x % g;
  for (int base = 0; base < outputs; base += per) {
    const int o = base + (int)threadIdx.x / g;
    const bool live = o < outputs;
    int n = 0, r = 0, j = 0;
    float acc = 0.0f;
    if (live) {
      j = o % n_out;
      const int q = o / n_out;
      r = q % rows;
      n = q / rows;
      const float* w = seg + L.w[n][layer] + j;
      const float* v = in + n * in_net + r * n_in;
      for (int k = part; k < n_in; k += g) acc = fmaf(v[k], w[k * n_out], acc);
    }
    for (int s = g >> 1; s > 0; s >>= 1) {
      acc += __shfl_xor_sync(0xffffffffu, acc, s);
    }
    if (live && part == 0) {
      float y = acc + seg[L.b[n][layer] + j];
      if (hidden) {
        y = n == 0 ? (y < 0.0f ? 0.0f : y) : tanhf(y);
      } else {
        y *= 1.0f - seg[j];
      }
      out[(n * rows + r) * n_out + j] = y;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    nvp_inverse_kernel(const float* __restrict__ z,
                       const float* __restrict__ params, float* __restrict__ x,
                       float* __restrict__ logdet, int n, int d, int h,
                       int nets, int couplings, int has_scale, int rows,
                       int stages) {
  extern __shared__ __align__(16) float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const Layout L = segment_layout(d, h, nets);
  const int seg = L.floats;
  float* zs = sm + stages * seg;      // rows x d
  float* vs = zs + rows * d;          // rows x d: z m
  float* as = vs + rows * d;          // nets x rows x h
  float* bs = as + 2 * rows * h;      // nets x rows x h
  float* os = bs + 2 * rows * h;      // nets x rows x d: t, log_s
  float* ld = os + 2 * rows * d;      // rows
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int row0 = blockIdx.x * rows;
  const int nrows = min(rows, n - row0);

  // coupling c's segment into stage c % stages, one copy group a thread
  auto issue = [&](int c) {
    float* dst = sm + (c % stages) * seg;
    const float* src = params + (size_t)c * seg;
    for (int i = tid; i < seg / 4; i += kThreads) {
      cp_async16(dst + 4 * i, src + 4 * i);
    }
    cp_async_commit();
  };
  for (int c = 0; c < stages; ++c) issue(c);
  for (int i = tid; i < rows * d; i += kThreads) {
    zs[i] = i < nrows * d ? z[(size_t)row0 * d + i] : 0.0f;
  }
  for (int r = tid; r < rows; r += kThreads) ld[r] = 0.0f;

  for (int c = 0; c < couplings; ++c) {
    cp_async_wait_pending(min(couplings, stages + c) - c - 1);
    __syncthreads();
    const float* w = sm + (c % stages) * seg;
    // each thread owns the same z entries throughout: no barrier between
    // the scale, the masked input and the affine's writes of its own
    if (has_scale) {
      const float s = w[L.scale];
      const float es = expf(-s);
      for (int i = tid; i < rows * d; i += kThreads) zs[i] *= es;
      for (int r = tid; r < rows; r += kThreads) ld[r] += -(float)d * s;
    }
    for (int i = tid; i < rows * d; i += kThreads) vs[i] = zs[i] * w[i % d];
    __syncthreads();
    dense(w, L, 0, nets, rows, vs, 0, d, as, h, true);
    __syncthreads();
    dense(w, L, 1, nets, rows, as, rows * h, h, bs, h, true);
    __syncthreads();
    dense(w, L, 2, nets, rows, bs, rows * h, h, os, d, false);
    __syncthreads();
    const float* ls = os + rows * d;
    for (int i = tid; i < rows * d; i += kThreads) {
      zs[i] = nets == 2 ? (zs[i] - os[i]) * expf(-ls[i]) : zs[i] - os[i];
    }
    if (nets == 2) {
      for (int r = warp; r < rows; r += kWarps) {
        float s = 0.0f;
        for (int k = lane; k < d; k += 32) s += ls[r * d + k];
        for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
        if (lane == 0) ld[r] += -s;
      }
    }
    __syncthreads();
    if (c + stages < couplings) issue(c + stages);
  }

  for (int i = tid; i < nrows * d; i += kThreads) {
    x[(size_t)row0 * d + i] = zs[i];
  }
  for (int r = tid; r < nrows; r += kThreads) logdet[row0 + r] = ld[r];
}

}  // namespace

extern "C" {

// Floats of one coupling's packed segment (the wrapper checks its packing
// against this).
int nnest_nvp_segment_floats(int d, int hidden, int nets) {
  return segment_layout(d, hidden, nets).floats;
}

// Inverts the whole chain for n rows of z (n x d, row-major) into x (n x d)
// and logdet (n). `params` holds `couplings` segments; the launch plan comes
// from ops/nvp_inverse.py::launch_plan: rows a thread block and weight
// stages, with the shared memory they add up to. Launches on `stream` and
// returns the cudaError_t of the launch (0 on success); an invalid argument
// or a plan that disagrees with the layout gives cudaErrorInvalidValue.
int nnest_nvp_inverse(const float* z, const float* params, float* x,
                      float* logdet, int n, int d, int hidden, int nets,
                      int couplings, int has_scale, int rows, int stages,
                      int smem_bytes, void* stream) {
  if (n < 1 || d < 2 || d > kMaxDim || hidden < 1 || hidden > kMaxHidden ||
      nets < 1 || nets > 2 || couplings < 1 || rows < 1 || stages < 1 ||
      stages > kMaxStages || stages > couplings) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem =
      4 * ((size_t)stages * segment_layout(d, hidden, nets).floats +
           (size_t)rows * row_floats(d, hidden));
  if (smem != (size_t)smem_bytes) return (int)cudaErrorInvalidValue;
  // The shared-memory ceiling set so far, per device.
  static size_t configured[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64 || smem > configured[dev]) {
    err = cudaFuncSetAttribute(nvp_inverse_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) configured[dev] = smem;
  }
  const int grid = (n + rows - 1) / rows;
  nvp_inverse_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(
                                                 stream)>>>(
      z, params, x, logdet, n, d, hidden, nets, couplings, has_scale, rows,
      stages);
  return (int)cudaGetLastError();
}

}  // extern "C"
