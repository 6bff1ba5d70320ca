// Pool consumption replay on Hopper (sm_90a).
//
// A kernel of the port without a Pallas counterpart: it stands for the XLA
// lax.scan of nnest_tpu/samplers/kernels.py::LatentKernels._consume_pool
// (:708-742), which the JAX package's multi-generation batch runners run
// between pool generations. The plain PyTorch twin is nnest_torch/ops/
// consume_pool.py::consume_pool_twin; the wrapper is ::consume_pool.
//
// It replays the nested sampler's host consumption of one candidate pool on
// the device's copy of the live set: candidates are taken in order against
// the CURRENT worst live point (argmin, the first index winning a tie); a
// candidate whose flag is set and whose logl is strictly above that point's
// replaces it (its row of x, its logl, its derived values) and advances the
// iteration counter; a candidate that fails changes nothing. With
// update_interval > 0 the kernel also reports whether an accept landed on
// it % update_interval == 0 (a retrain boundary of the host loop).
//
// Bound. The work is compares and selects, no arithmetic: it must equal the
// twin bit for bit. The bytes it must move are the candidates' flags and
// logl (5 bytes a candidate), the live logl (4 bytes a point, read once),
// and one row of x and derived read and written per accept; at the paths'
// shapes (1000 live points x 256 Metropolis candidates at d = 16; 100 x 10
// at d = 2; 1000 x 65536 rejection trials with few flags set) that is
// 5-330 KB, well under a microsecond at HBM's rate. What the kernel pays
// instead is a dependent chain: every accept changes the worst point, so
// the next candidate's test needs a fresh argmin of the live set. The walk
// is sequential by definition; one thread block does it.
//
// Design against that chain:
//   - One block of kThreads threads. The live logl sit in shared memory
//     when they fit (n * 4 bytes <= kSharedBytes, ~50000 points), else the
//     block works on them in global memory, where it is their only writer.
//   - Candidates are tested a chunk of kThreads at a time against the
//     current worst value; a warp ballot and one pass over the warps' first
//     hits give the first passing index of the chunk. The candidates before
//     it failed against the current worst point, which an accept could only
//     raise, so skipping them is exact. A chunk without a hit costs one
//     barrier; an accept costs the row copy and one block-wide argmin.
//   - Argmin: each thread scans a strided share of the live set keeping
//     (value, index) with the smaller index on a tie, then warp shuffles and
//     one warp over the warps' results, with the same rule.
//   - The iteration counter is read from device memory and written, with
//     the boundary flag, to device outputs, so the host reads nothing
//     between generations unless it wants a stop flag.
//
// Live logl are finite (the samplers sanitize them to >= -1e31), so no NaN
// reaches the compares; +0.0 and -0.0 compare equal and the first index
// wins, as in jnp.argmin and torch.argmin.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kSharedBytes = 200 * 1024;

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v < bv || (v == bv && i < bi);
}

struct Scratch {
  float warp_v[kWarps];
  int warp_i[kWarps];
  int warp_first[kWarps];
  float min_v;
  int min_i;
};

// Block-wide (min, first argmin) of vals[0..n).
__device__ void block_argmin(const float* vals, int n, Scratch& s,
                             float& out_v, int& out_i) {
  float bv = __int_as_float(0x7f800000);  // +inf
  int bi = INT_MAX;
  for (int j = threadIdx.x; j < n; j += kThreads) {
    float v = vals[j];
    if (better(v, j, bv, bi)) {
      bv = v;
      bi = j;
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    float ov = __shfl_down_sync(0xffffffffu, bv, off);
    int oi = __shfl_down_sync(0xffffffffu, bi, off);
    if (better(ov, oi, bv, bi)) {
      bv = ov;
      bi = oi;
    }
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    s.warp_v[warp] = bv;
    s.warp_i[warp] = bi;
  }
  __syncthreads();
  if (warp == 0) {
    bv = lane < kWarps ? s.warp_v[lane] : __int_as_float(0x7f800000);
    bi = lane < kWarps ? s.warp_i[lane] : INT_MAX;
    for (int off = 16; off > 0; off >>= 1) {
      float ov = __shfl_down_sync(0xffffffffu, bv, off);
      int oi = __shfl_down_sync(0xffffffffu, bi, off);
      if (better(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if (lane == 0) {
      s.min_v = bv;
      s.min_i = bi;
    }
  }
  __syncthreads();
  out_v = s.min_v;
  out_i = s.min_i;
}

__global__ void __launch_bounds__(kThreads)
    consume_pool_kernel(float* __restrict__ au, float* __restrict__ al,
                        float* __restrict__ ad, const int* __restrict__ it_in,
                        int* __restrict__ it_out,
                        uint8_t* __restrict__ crossed_out,
                        const uint8_t* __restrict__ flags,
                        const float* __restrict__ cand_logl,
                        const float* __restrict__ cand_x,
                        const float* __restrict__ cand_d, int n, int d, int k,
                        int m, int update_interval, int use_shared) {
  extern __shared__ float s_vals[];
  __shared__ Scratch s;
  float* vals = al;
  if (use_shared) {
    for (int j = threadIdx.x; j < n; j += kThreads) s_vals[j] = al[j];
    __syncthreads();
    vals = s_vals;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int it = *it_in;
  int crossed = 0;
  float min_v;
  int min_i;
  block_argmin(vals, n, s, min_v, min_i);
  int base = 0;
  while (base < m) {
    const int i = base + threadIdx.x;
    const bool pass = i < m && flags[i] != 0 && cand_logl[i] > min_v;
    const unsigned hits = __ballot_sync(0xffffffffu, pass);
    if (lane == 0)
      s.warp_first[warp] =
          hits ? base + warp * 32 + __ffs(hits) - 1 : INT_MAX;
    __syncthreads();
    int first = INT_MAX;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) first = min(first, s.warp_first[w]);
    __syncthreads();  // warp_first is rewritten by the next chunk
    if (first == INT_MAX) {
      base += kThreads;
      continue;
    }
    for (int j = threadIdx.x; j < d; j += kThreads)
      au[(size_t)min_i * d + j] = cand_x[(size_t)first * d + j];
    for (int j = threadIdx.x; j < k; j += kThreads)
      ad[(size_t)min_i * k + j] = cand_d[(size_t)first * k + j];
    if (threadIdx.x == 0) {
      const float v = cand_logl[first];
      vals[min_i] = v;
      if (use_shared) al[min_i] = v;
    }
    ++it;
    if (update_interval > 0 && it % update_interval == 0) crossed = 1;
    __syncthreads();  // the new value is visible before the argmin
    block_argmin(vals, n, s, min_v, min_i);
    base = first + 1;
  }
  if (threadIdx.x == 0) {
    *it_out = it;
    *crossed_out = (uint8_t)crossed;
  }
}

}  // namespace

// The most live points whose logl the kernel holds in shared memory.
extern "C" int nnest_consume_pool_shared_capacity() {
  return kSharedBytes / (int)sizeof(float);
}

// One launch of a single block on `stream`. au (n, d), al (n,) and ad (n, k)
// are updated in place (ad may be null when k == 0); it_in points at the
// int32 iteration count; it_out (int32) and crossed_out (a bool byte)
// receive the new count and the boundary flag.
// Returns cudaGetLastError() after the launch.
extern "C" int nnest_consume_pool(void* au, void* al, void* ad,
                                  const void* it_in, void* it_out,
                                  void* crossed_out,
                                  const void* flags, const void* cand_logl,
                                  const void* cand_x, const void* cand_d,
                                  int n, int d, int k, int m,
                                  int update_interval, void* stream) {
  static bool attribute_set = false;
  if (!attribute_set) {
    cudaError_t e = cudaFuncSetAttribute(
        consume_pool_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSharedBytes);
    if (e != cudaSuccess) return (int)e;
    attribute_set = true;
  }
  const int use_shared = (size_t)n * sizeof(float) <= (size_t)kSharedBytes;
  const size_t smem = use_shared ? (size_t)n * sizeof(float) : 0;
  consume_pool_kernel<<<1, kThreads, smem, (cudaStream_t)stream>>>(
      (float*)au, (float*)al, (float*)ad, (const int*)it_in, (int*)it_out,
      (uint8_t*)crossed_out,
      (const uint8_t*)flags, (const float*)cand_logl, (const float*)cand_x,
      (const float*)cand_d, n, d, k, m, update_interval, use_shared);
  return (int)cudaGetLastError();
}
