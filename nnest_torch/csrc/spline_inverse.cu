// Single-speed spline-flow inverse on Hopper (sm_90a).
//
// Replaces both TPU kernels of nnest_tpu/ops/pallas_spline.py: the whole
// chain, pallas_inverse_from_consts (:338, also reached by
// make_pallas_inverse :286), and the chain with one launch per flow block,
// pallas_inverse_per_block (:346), which is this kernel over a one-block
// range. The plain PyTorch twin is nnest_torch/ops/fused_spline.py::
// _inverse_body; the wrappers, the launch plan and the packed layout are in
// nnest_torch/ops/spline_inverse.py.
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
// Bound. At the main path's shapes (d = 16, hidden 32, K = 8, 3 blocks,
// N = 256; d = 2..50 with hidden 16/32/64) the chain needs ~1e5 f32
// operations a row against ~0.2-1.2 MB of weights, so by chip_smoke.py's
// inverse_cost the f32 rate (67 TFLOP/s), not HBM, sets the least time:
// ~0.45 us at N = 256, ~7 us at N = 4096. What the kernel pays instead is
// latency: every row runs a chain of 33 dependent stages (24 dense layers,
// 6 RQS stages, 3 W^-1 products), each ending in a barrier of the block.
// PERF.md has the measured split (tools/spline_probe.py).
//
// Design against that chain:
//   - Multi-row tiles. A thread block owns `rows` rows (the launch plan
//     picks them so that ~132 blocks are in flight), so every weight read
//     from shared memory feeds all of them.
//   - Weights staged ahead. One producer thread (a ninth warp) streams the
//     packed parameters, in the order the chain consumes them, into a ring
//     of `stages` shared-memory buffers with 1-D TMA bulk copies
//     (cp.async.bulk, completion on an mbarrier), while eight consumer
//     warps compute. A layer is cut into pieces of whole weight rows (its
//     partial sums kept in the output buffer between pieces); consecutive
//     pieces travel together in copies of up to a stage, so at d = 16 a
//     whole flow block is one copy. Where two stages do not fit beside the
//     rows' state (very large d), the plan sets stages = 0 and the
//     consumers read the weights from global memory through L1/L2.
//   - Each stage spreads over all eight warps. Giving each warp its own
//     rows through the whole chain, with no block barrier, measured slower:
//     most warps then idle while one runs a long dependent chain.
//   - Register tiles and unrolled k-loops. Each consumer thread owns a
//     (RT rows x 4 columns) tile of f32 accumulators; weights come as
//     float4 loads from shared memory (consecutive threads, consecutive
//     16 bytes: no bank conflict), activations as broadcasts. The hidden
//     width H is a template argument (16, 32, 64; 0 = any other width at
//     run time), so the H-deep k-loops of the square layers unroll. Each
//     kind of stage is called from one place, so each variant exists once
//     in the binary.
//   - RQS: the bin index from the K comparisons x >= edge_k (last edge +
//     1e-6), then the chosen bin's knots selected and its two derivatives
//     read from the conditioner output by index. One (row, dim) pair a
//     thread; where the pairs are few (small N), one pair an 8-lane group,
//     a bin a lane, which cuts the instructions each warp issues about
//     six-fold. Every other numeric detail is the reference's: the double
//     softmax, the pinned end derivatives, the softplus form, the clamp,
//     the discriminant clamp, the 1e-12 guard, the root clip and the
//     identity tails. A NaN input clamps to -B, picks bin 0 and leaves
//     through the identity tail as NaN with a zero logdet, as the twin's
//     one-hot sum does; the index is clamped, so no read leaves the row.
//   - No tensor cores. The contract is 3e-5 in x and 3e-4 in logdet
//     against the f32 twin, and TF32 keeps ~3 digits; the products are
//     ~31 M operations at N = 256 (0.46 us at the f32 rate), so FFMA
//     throughput is not what costs. Products are f32 FMA with the k-loop in
//     order; no --use_fast_math.
//
// Parameter layout (float32; every array and weight row padded with zeros
// to a multiple of 4 floats so that every copy is a legal bulk copy:
// 16-byte aligned, a multiple of 16 bytes). Per flow block, in the order
// the chain uses it: f2 layers 0..3, f1 layers 0..3, then the affine
// "layer"; each MLP layer is W (n_in rows of ceil4(n_out) floats, JAX's
// (n_in, n_out) order) then its bias (ceil4(n_out)); the affine is W^-1
// (d rows of ceil4(d)) then t and s (ceil4(d) each). f2 reads the d - cut
// upper dims and writes cut*(3K-1) outputs; f1 reads the cut lower dims
// and writes (d - cut)*(3K-1). Output columns per dim are [K widths | K
// heights | K-1 derivatives]. After the last block: the constant logdet,
// padded to 4.
//
// The tables (from the plan; every flow block has the same ones): pieces,
// int4 (float offset within the block, floats, first and one-past-last
// weight row; a layer's last piece carries its tail), then copies, int4
// (float offset, floats, first piece, pieces).

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kConsumers = 256;
constexpr int kThreads = kConsumers + 32;
constexpr int kMaxStages = 4;
constexpr int kBarrierBytes = 128;  // full[kMaxStages], empty[kMaxStages]
constexpr double kMinBinWidth = 1e-3;
constexpr double kMinBinHeight = 1e-3;
constexpr double kMinDerivative = 1e-3;
// log(exp(1 - kMinDerivative) - 1), rounded to float as rqs.py rounds it.
constexpr float kPin = 0.5397424172369522f;

enum Mode { kLeaky = 0, kLinear = 1, kAffine = 2 };

__host__ __device__ inline int ceil4(int v) { return (v + 3) & ~3; }

__host__ __device__ inline int layer_floats(int n_in, int n_out, int tails) {
  return (n_in + tails) * ceil4(n_out);
}

__host__ __device__ inline int mlp_floats(int n_in, int hidden, int n_out) {
  return layer_floats(n_in, hidden, 1) + 2 * layer_floats(hidden, hidden, 1) +
         layer_floats(hidden, n_out, 1);
}

__host__ __device__ inline int block_floats(int d, int hidden, int per) {
  const int cut = d - d / 2;
  const int up = d - cut;
  return mlp_floats(up, hidden, cut * per) + mlp_floats(cut, hidden, up * per) +
         layer_floats(d, d, 2);
}

// Floats of per-row state: z, the affine output and the per-dim logdets
// (ceil4(d) each), two activation buffers (ceil4(hidden) each), the
// conditioner output (ceil4(cut*(3K-1))) and the running logdet.
__host__ __device__ inline int row_floats(int d, int hidden, int per) {
  return 3 * ceil4(d) + 2 * ceil4(hidden) + ceil4((d - d / 2) * per) + 1;
}

__host__ __device__ inline size_t shared_bytes(int d, int hidden, int per,
                                               int rows, int stages,
                                               int stage_floats, int entries) {
  return (size_t)kBarrierBytes + 4 * (size_t)stages * stage_floats +
         16 * (size_t)entries + 4 * (size_t)rows * row_floats(d, hidden, per);
}

// The block's dynamic shared memory. Buffers are addressed by float
// offsets into it, so every access compiles to a shared-memory load or
// store that the compiler may schedule freely (a pointer that could be
// global or shared compiles to a slower generic access).
extern __shared__ __align__(128) float4 dsm4[];

__device__ inline float* dsm() { return reinterpret_cast<float*>(dsm4); }

// ---------------------------------------------------------------- PTX

__device__ inline uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ inline void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ inline void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ inline void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Wait for the completion of the barrier's phase with this parity.
__device__ inline void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "bra WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// 1-D TMA: `bytes` (a multiple of 16) from global `src` to shared `dst`
// (both 16-byte aligned), completing on `bar`.
__device__ inline void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                 uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Barrier of the consumer warps only (the producer warp never joins it).
__device__ inline void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// ------------------------------------------------------- weight pipeline

// The consumers' side of the ring. Copy i of the launch (copy j of the
// current flow block) sits in stage i % stages and fills it for the
// (i / stages)-th time; its pieces are consecutive in the piece table.
struct Pipe {
  uint64_t* full;
  uint64_t* empty;
  int stage0;  // float offset of stage 0
  const int4* pieces;
  const int4* copies;
  int ncopies;
  int stages;
  int stage_floats;
  int i;
  int j;
  int base;  // float offset of copy i's stage
  int4 cp;   // copies[j], kept in registers

  // The float offset of the first weight row of piece c (= pieces[c]);
  // waits for its copy to land when c is the copy's first piece.
  __device__ int piece(int c, const int4& ch) {
    if (c == cp.z) {
      const int s = i % stages;
      mbar_wait(&full[s], (uint32_t)((i / stages) & 1));
      base = stage0 + s * stage_floats;
    }
    return base + ch.x - cp.x;
  }

  // Gives the stage back after the last piece of its copy.
  __device__ void done(int c) {
    if (c == cp.z + cp.w - 1) {
      mbar_arrive(&empty[i % stages]);
      ++i;
      j = j + 1 == ncopies ? 0 : j + 1;
      cp = copies[j];
    }
  }
};

// Weight rows as float4: from a ring stage (shared, float offset w) or,
// with no ring, from global memory (wg) through the read-only path.
template <bool kShared>
__device__ inline float4 load_w(const float* wg, int w, int idx4) {
  if (kShared) return dsm4[(w >> 2) + idx4];
  return __ldg(reinterpret_cast<const float4*>(wg) + idx4);
}

// Weight rows [0, kc) of a piece (row stride n4) applied to in[:, 0:kc)
// (row stride is) for all R rows; in and out are float offsets into shared
// memory, and out keeps the partial sums between a layer's pieces. The
// last piece carries the tail (bias, or t then s) right after its rows and
// adds it with the activation. Each thread owns (RT rows x 4 columns)
// tiles; KN > 0 is a piece depth known at compile time.
template <int KN, int RT, bool kShared>
__device__ void dense_piece(const float* wg, int w, int kc, int in, int is,
                            int out, int os, int n4, int R, bool first,
                            bool last, int mode) {
  const int cq = n4 >> 2;
  const float* sm = dsm();
  const int items = (R / RT) * cq;
  const int depth = KN > 0 ? KN : kc;
  for (int it = threadIdx.x; it < items; it += kConsumers) {
    const int q = it % cq;
    const int r0 = (it / cq) * RT;
    float4 acc[RT];
#pragma unroll
    for (int rr = 0; rr < RT; ++rr) {
      acc[rr] = first ? make_float4(0.f, 0.f, 0.f, 0.f)
                      : dsm4[((out + (r0 + rr) * os) >> 2) + q];
    }
    const float* xr = sm + in + r0 * is;
#pragma unroll 8
    for (int k = 0; k < depth; ++k) {
      const float4 wv = load_w<kShared>(wg, w, k * cq + q);
#pragma unroll
      for (int rr = 0; rr < RT; ++rr) {
        const float a = xr[rr * is + k];
        acc[rr].x = fmaf(a, wv.x, acc[rr].x);
        acc[rr].y = fmaf(a, wv.y, acc[rr].y);
        acc[rr].z = fmaf(a, wv.z, acc[rr].z);
        acc[rr].w = fmaf(a, wv.w, acc[rr].w);
      }
    }
    if (last) {
      const float4 b = load_w<kShared>(wg, w, depth * cq + q);
      const float4 s =
          mode == kAffine ? load_w<kShared>(wg, w, (depth + 1) * cq + q) : b;
#pragma unroll
      for (int rr = 0; rr < RT; ++rr) {
        float4& v = acc[rr];
        if (mode == kAffine) {
          v.x = (v.x - b.x) * expf(-s.x);
          v.y = (v.y - b.y) * expf(-s.y);
          v.z = (v.z - b.z) * expf(-s.z);
          v.w = (v.w - b.w) * expf(-s.w);
        } else {
          v.x += b.x;
          v.y += b.y;
          v.z += b.z;
          v.w += b.w;
          if (mode == kLeaky) {
            v.x = v.x >= 0.0f ? v.x : 0.2f * v.x;
            v.y = v.y >= 0.0f ? v.y : 0.2f * v.y;
            v.z = v.z >= 0.0f ? v.z : 0.2f * v.z;
            v.w = v.w >= 0.0f ? v.w : 0.2f * v.w;
          }
        }
      }
    }
#pragma unroll
    for (int rr = 0; rr < RT; ++rr) {
      dsm4[((out + (r0 + rr) * os) >> 2) + q] = acc[rr];
    }
  }
}

// Tile height: as many rows a thread as still leaves every consumer a tile.
template <int KN, bool kShared>
__device__ void dense(const float* wg, int w, int kc, int in, int is, int out,
                      int os, int n4, int R, bool first, bool last, int mode) {
  const int cq = n4 >> 2;
  if (R % 4 == 0 && (R / 4) * cq >= kConsumers) {
    dense_piece<KN, 4, kShared>(wg, w, kc, in, is, out, os, n4, R, first,
                                last, mode);
  } else if (R % 2 == 0 && (R / 2) * cq >= kConsumers) {
    dense_piece<KN, 2, kShared>(wg, w, kc, in, is, out, os, n4, R, first,
                                last, mode);
  } else {
    dense_piece<KN, 1, kShared>(wg, w, kc, in, is, out, os, n4, R, first,
                                last, mode);
  }
}

// One dense layer of a flow block (in and out: float offsets into shared
// memory).
struct Layer {
  int in;
  int is;
  int n_in;
  int out;
  int os;
  int n4;
  int mode;
};

// One layer: its pieces (pieces[c], pieces[c + 1], ... up to the one that
// ends at row n_in), each read from the ring (or, with no ring, in place).
// H > 0 is the compile-time hidden width: a piece of exactly H rows runs
// the fixed-depth loop.
template <int H>
__device__ void layer(Pipe& pipe, int& c, const float* base, const Layer& L,
                      int R) {
  for (;;) {
    const int4 ch = pipe.pieces[c];
    const int kc = ch.w - ch.z;
    const bool first = ch.z == 0;
    const bool last = ch.w == L.n_in;
    const int in = L.in + ch.z;
    if (pipe.stages > 0) {
      const int w = pipe.piece(c, ch);
      if (H > 0 && kc == H) {
        dense<H, true>(nullptr, w, kc, in, L.is, L.out, L.os, L.n4, R, first,
                       last, L.mode);
      } else {
        dense<0, true>(nullptr, w, kc, in, L.is, L.out, L.os, L.n4, R, first,
                       last, L.mode);
      }
      pipe.done(c);
    } else {
      dense<0, false>(base + ch.x, 0, kc, in, L.is, L.out, L.os, L.n4, R,
                      first, last, L.mode);
    }
    ++c;
    if (last) break;
  }
  consumer_sync();
}

// ------------------------------------------------------------------ RQS

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

// Derivative at knot `knot` (0..K) of the bin: pinned to 1 at the ends
// (softplus(kPin) + min_derivative == 1), else min + softplus of the
// reference's softplus-ed conditioner output for interior knot knot - 1.
template <int K>
__device__ inline float knot_derivative(const float* o, int knot) {
  const float min_d = (float)kMinDerivative;
  if (knot <= 0 || knot >= K) return min_d + softplus(kPin);
  return min_d + softplus(softplus(o[2 * K + knot - 1]));
}

// The inverse within the chosen bin (knots in_cw..in_cw1 by in_ch..in_ch1,
// end derivatives in_d, in_d1) of y clamped to x: the quadratic's root with
// the reference's discriminant clamp, 1e-12 guard and clip, the logdet, and
// the identity tails outside [-B, B].
__device__ inline float rqs_root(float y, float x, float in_cw, float in_cw1,
                                 float in_ch, float in_ch1, float in_d,
                                 float in_d1, float B, float* logabsdet) {
  const float in_w = in_cw1 - in_cw;
  const float in_h = in_ch1 - in_ch;
  const float in_delta = in_h / in_w;

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

// RQS inverse of one value y with the conditioner outputs o[0..3K-1)
// (shared memory).
template <int K>
__device__ inline float rqs_inverse(float y, const float* o, float B,
                                    float* logabsdet) {
  const float two_b = 2.0f * B;
  float w[K], h[K], cw[K + 1], ch[K + 1];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    w[k] = o[k];
    h[k] = o[K + k];
  }
  // The reference's pre-normalisation (spline.py): 2B * softmax.
  softmax<K>(w);
  softmax<K>(h);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    w[k] = two_b * w[k];
    h[k] = two_b * h[k];
  }
  edges<K>(w, (float)kMinBinWidth, (float)(1.0 - kMinBinWidth * K), B, cw);
  edges<K>(h, (float)kMinBinHeight, (float)(1.0 - kMinBinHeight * K), B, ch);

  const float x = fminf(fmaxf(y, -B), B);
  // The bin: how many of the height knots 1..K (the last bumped by 1e-6)
  // x has passed; knot 0 is -B <= x.
  int bin = 0;
#pragma unroll
  for (int k = 1; k <= K; ++k) {
    const float edge = (k == K) ? ch[K] + 1e-6f : ch[k];
    bin += x >= edge ? 1 : 0;
  }
  bin = min(bin, K - 1);
  float in_cw = cw[0], in_cw1 = cw[1], in_ch = ch[0], in_ch1 = ch[1];
#pragma unroll
  for (int k = 1; k < K; ++k) {
    if (bin == k) {
      in_cw = cw[k];
      in_cw1 = cw[k + 1];
      in_ch = ch[k];
      in_ch1 = ch[k + 1];
    }
  }
  const float in_d = knot_derivative<K>(o, bin);
  const float in_d1 = knot_derivative<K>(o, bin + 1);
  return rqs_root(y, x, in_cw, in_cw1, in_ch, in_ch1, in_d, in_d1, B,
                  logabsdet);
}

// The same inverse with one value spread over the 8 lanes of a group
// (lane k owns bin k): the softmaxes reduce and the knots cumulate by
// shuffles, the bin is a ballot of the lanes' comparisons, lanes 0 and 1
// take the two derivatives. About a sixth of the instructions per warp of
// the one-lane version, for launches whose few values would leave most
// warps idle. Every lane of the warp must call it.
template <int K>
__device__ inline float rqs_inverse_lanes(float y, const float* o, float B,
                                          float* logabsdet) {
  static_assert(K == 8, "one lane a bin: the group is 8 lanes");
  const unsigned all = 0xffffffffu;
  const int k = threadIdx.x & 7;
  const float two_b = 2.0f * B;
  float w = o[k];
  float h = o[K + k];
  // softmax over the group, twice for each (the reference's
  // pre-normalisation, then the knots' own).
  auto softmax8 = [&](float& v) {
    float m = v;
    for (int s = 1; s < 8; s <<= 1) m = fmaxf(m, __shfl_xor_sync(all, m, s, 8));
    const float e = expf(v - m);
    float sum = e;
    for (int s = 1; s < 8; s <<= 1) sum += __shfl_xor_sync(all, sum, s, 8);
    v = e / sum;
  };
  softmax8(w);
  softmax8(h);
  w = two_b * w;
  h = two_b * h;
  softmax8(w);
  softmax8(h);
  // Knot k + 1 on lane k: the cumulated floored sizes, the last pinned
  // to B.
  float cw = (float)kMinBinWidth + (float)(1.0 - kMinBinWidth * K) * w;
  float ch = (float)kMinBinHeight + (float)(1.0 - kMinBinHeight * K) * h;
  for (int s = 1; s < 8; s <<= 1) {
    const float uw = __shfl_up_sync(all, cw, s, 8);
    const float uh = __shfl_up_sync(all, ch, s, 8);
    if (k >= s) {
      cw += uw;
      ch += uh;
    }
  }
  cw = k == K - 1 ? B : two_b * cw - B;
  ch = k == K - 1 ? B : two_b * ch - B;

  const float x = fminf(fmaxf(y, -B), B);
  const bool ge = x >= (k == K - 1 ? ch + 1e-6f : ch);
  const unsigned votes = __ballot_sync(all, ge) >> (threadIdx.x & 24);
  const int bin = min(__popc(votes & 0xffu), K - 1);
  // Shuffles run on every lane (the mask is the whole warp); the ends
  // are selected after.
  const float lo_cw = __shfl_sync(all, cw, max(bin - 1, 0), 8);
  const float lo_ch = __shfl_sync(all, ch, max(bin - 1, 0), 8);
  const float in_cw = bin == 0 ? -B : lo_cw;
  const float in_ch = bin == 0 ? -B : lo_ch;
  const float in_cw1 = __shfl_sync(all, cw, bin, 8);
  const float in_ch1 = __shfl_sync(all, ch, bin, 8);
  const float dv = knot_derivative<K>(o, bin + (k & 1));
  const float in_d = __shfl_sync(all, dv, 0, 8);
  const float in_d1 = __shfl_sync(all, dv, 1, 8);
  return rqs_root(y, x, in_cw, in_cw1, in_ch, in_ch1, in_d, in_d1, B,
                  logabsdet);
}

// RQS inverse of dims [off, off + n_dims) of every row, in place; the
// per-dim logdets go to lds. One (row, dim) pair a thread, or, where the
// pairs are few (at most two rounds of 8-lane groups), one pair a group.
template <int K>
__device__ void rqs_half(float* zs, int d4, int off, int n_dims,
                         const float* cond, int c4, float* lds, int R,
                         float B) {
  constexpr int P = 3 * K - 1;
  const int items = R * n_dims;
  if (items * 8 <= 2 * kConsumers) {
    // Each warp takes 4 pairs a round, so its lanes loop together.
    for (int first = (threadIdx.x >> 5) * 4; first < items;
         first += kConsumers / 8) {
      const int idx = min(first + ((threadIdx.x >> 3) & 3), items - 1);
      const int r = idx / n_dims;
      const int j = idx - r * n_dims;
      float* y = zs + r * d4 + off + j;
      float la;
      const float v = rqs_inverse_lanes<K>(*y, cond + r * c4 + j * P, B, &la);
      if ((threadIdx.x & 7) == 0 && first + ((threadIdx.x >> 3) & 3) < items) {
        *y = v;
        lds[r * d4 + off + j] = la;
      }
    }
  } else {
    for (int idx = threadIdx.x; idx < items; idx += kConsumers) {
      const int r = idx / n_dims;
      const int j = idx - r * n_dims;
      float* y = zs + r * d4 + off + j;
      float la;
      *y = rqs_inverse<K>(*y, cond + r * c4 + j * P, B, &la);
      lds[r * d4 + off + j] = la;
    }
  }
  consumer_sync();
}

// --------------------------------------------------------------- kernel

// One block an SM is the plan's intent (its shared memory is sized so),
// which leaves ptxas the registers to keep the tiles without spilling.
template <int K, int H>
__global__ void __launch_bounds__(kThreads, 1)
spline_inverse_kernel(const float* __restrict__ z,
                      const float* __restrict__ params,
                      const int4* __restrict__ tables, float* __restrict__ x,
                      float* __restrict__ logdet, int n, int d, int hidden,
                      int first_block, int num_blocks, int include_const,
                      float B, int R, int stages, int stage_floats, int npieces,
                      int ncopies, int bfloats, int const_offset) {
  constexpr int P = 3 * K - 1;
  const int hid = H > 0 ? H : hidden;
  const int cut = d - d / 2;
  const int up = d - cut;
  const int d4 = ceil4(d);
  const int h4 = ceil4(hid);
  const int c4 = ceil4(cut * P);
  const int tid = threadIdx.x;
  const size_t row0 = (size_t)blockIdx.x * R;
  const int nrows = min(R, (int)(n - row0));

  // Shared memory, in floats: the mbarriers, the ring, the piece and copy
  // tables, then per-row state.
  float* const sm = dsm();
  uint64_t* full = reinterpret_cast<uint64_t*>(dsm4);
  uint64_t* empty = full + kMaxStages;
  const int stage0 = kBarrierBytes / 4;
  int4* table =
      reinterpret_cast<int4*>(dsm4 + (stage0 + stages * stage_floats) / 4);
  int zs = stage0 + stages * stage_floats + 4 * (npieces + ncopies);
  int tmp = zs + R * d4;
  const int lds = tmp + R * d4;
  const int ha = lds + R * d4;
  const int hb = ha + R * h4;
  const int cond = hb + R * h4;
  float* ldrow = sm + cond + R * c4;

  for (int i = tid; i < npieces + ncopies; i += kThreads) table[i] = tables[i];
  if (tid == kConsumers && stages > 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (tid < kConsumers) {
    // Rows past n are zeros, so every tile computes on defined values.
    for (int i = tid; i < R * d4; i += kConsumers) {
      const int r = i / d4;
      const int j = i - r * d4;
      sm[zs + i] = (r < nrows && j < d) ? z[(row0 + r) * d + j] : 0.0f;
    }
    for (int r = tid; r < R; r += kConsumers) ldrow[r] = 0.0f;
  }
  __syncthreads();

  const int last_block = first_block + num_blocks - 1;
  if (tid >= kConsumers) {
    // Producer: one thread issues the copies in the consumers' order.
    if (tid == kConsumers && stages > 0) {
      int i = 0;
      for (int blk = last_block; blk >= first_block; --blk) {
        const float* base = params + (size_t)blk * bfloats;
        for (int c = 0; c < ncopies; ++c, ++i) {
          const int s = i % stages;
          if (i >= stages) {
            mbar_wait(&empty[s], (uint32_t)(((i / stages) - 1) & 1));
          }
          const int4 ch = table[npieces + c];
          mbar_expect_tx(&full[s], (uint32_t)ch.y * 4u);
          bulk_copy(sm + stage0 + s * stage_floats, base + ch.x,
                    (uint32_t)ch.y * 4u, &full[s]);
        }
      }
    }
    return;
  }

  Pipe pipe{full,   empty,  stage0,       table, table + npieces,
            ncopies, stages, stage_floats, 0,     0,
            0,       table[npieces]};
  for (int blk = last_block; blk >= first_block; --blk) {
    const float* base = params + (size_t)blk * bfloats;
    int c = 0;
    // Layers 0-3: f2 on the upper half -> knots of the lower half; 4-7: f1
    // on the new lower half -> knots of the upper half; 8: z @ W^-1, then
    // (z - t) * exp(-s). One call site for each kind of stage.
    for (int l = 0; l < 9; ++l) {
      const int j = l & 3;
      Layer L;
      if (l == 8) {
        // The block's logdet (lower half, then upper), beside z @ W^-1.
        for (int r = tid; r < R; r += kConsumers) {
          float lo = 0.0f, hi = 0.0f;
          for (int k = 0; k < cut; ++k) lo += sm[lds + r * d4 + k];
          for (int k = cut; k < d; ++k) hi += sm[lds + r * d4 + k];
          ldrow[r] += lo + hi;
        }
        L = {zs, d4, d, tmp, d4, d4, kAffine};
      } else if (j == 0) {
        L = {l == 0 ? zs + cut : zs, d4, l == 0 ? up : cut, ha, h4, h4, kLeaky};
      } else if (j < 3) {
        L = {j == 1 ? ha : hb, h4, hid, j == 1 ? hb : ha, h4, h4, kLeaky};
      } else {
        L = {ha, h4, hid, cond, c4, ceil4((l == 3 ? cut : up) * P), kLinear};
      }
      layer<H>(pipe, c, base, L, R);
      if (j == 3 && l < 8) {
        rqs_half<K>(sm + zs, d4, l == 3 ? 0 : cut, l == 3 ? cut : up,
                    sm + cond, c4, sm + lds, R, B);
      }
    }
    const int swap = zs;
    zs = tmp;
    tmp = swap;
  }

  const float cst = include_const ? __ldg(params + const_offset) : 0.0f;
  for (int i = tid; i < nrows * d; i += kConsumers) {
    const int r = i / d;
    x[row0 * d + i] = sm[zs + r * d4 + (i - r * d)];
  }
  for (int r = tid; r < nrows; r += kConsumers) logdet[row0 + r] = ldrow[r] + cst;
}

template <int K, int H>
int launch(const float* z, const float* params, const int4* tables, float* x,
           float* logdet, int n, int d, int hidden, int total_blocks,
           int first_block, int num_blocks, int include_const,
           float tail_bound, int rows, int stages, int stage_floats,
           int npieces, int ncopies, size_t smem, cudaStream_t stream) {
  auto kernel = spline_inverse_kernel<K, H>;
  // The shared-memory ceiling set so far, per device, for this kernel.
  static size_t configured[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64 || smem > configured[dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) configured[dev] = smem;
  }
  constexpr int P = 3 * K - 1;
  const int bfloats = block_floats(d, hidden, P);
  const int grid = (n + rows - 1) / rows;
  kernel<<<grid, kThreads, smem, stream>>>(
      z, params, tables, x, logdet, n, d, hidden, first_block, num_blocks,
      include_const, tail_bound, rows, stages, stage_floats, npieces, ncopies,
      bfloats, total_blocks * bfloats);
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
// and logdet (n). The launch plan comes from
// ops/spline_inverse.py::launch_plan: rows a thread block, ring stages and
// their floats, and `tables`, one block's pieces_per_block pieces then its
// copies_per_block copies (int4 each), with the shared memory it all adds
// up to. Launches on `stream` and returns the cudaError_t of the launch (0
// on success); an invalid argument or a plan that disagrees with the
// layout gives cudaErrorInvalidValue.
int nnest_spline_inverse(const float* z, const float* params,
                         const void* tables, float* x, float* logdet, int n,
                         int d, int hidden, int num_bins, int total_blocks,
                         int first_block, int num_blocks, int include_const,
                         float tail_bound, int rows_per_block, int stages,
                         int stage_floats, int pieces_per_block,
                         int copies_per_block, int smem_bytes, void* stream) {
  if (n < 1 || d < 2 || hidden < 1 || rows_per_block < 1 || first_block < 0 ||
      num_blocks < 1 || first_block + num_blocks > total_blocks ||
      stages < 0 || stages > kMaxStages || stage_floats % 4 != 0 ||
      pieces_per_block < 1 || copies_per_block < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = shared_bytes(d, hidden, 3 * num_bins - 1,
                                   rows_per_block, stages, stage_floats,
                                   pieces_per_block + copies_per_block);
  if (smem != (size_t)smem_bytes) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int4* table = static_cast<const int4*>(tables);
#define NNEST_LAUNCH(H)                                                     \
  launch<8, H>(z, params, table, x, logdet, n, d, hidden, total_blocks,     \
               first_block, num_blocks, include_const, tail_bound,          \
               rows_per_block, stages, stage_floats, pieces_per_block,      \
               copies_per_block, smem, s)
  if (num_bins != 8) return (int)cudaErrorInvalidValue;
  switch (hidden) {
    case 16:
      return NNEST_LAUNCH(16);
    case 32:
      return NNEST_LAUNCH(32);
    case 64:
      return NNEST_LAUNCH(64);
    default:
      return NNEST_LAUNCH(0);
  }
#undef NNEST_LAUNCH
}

}  // extern "C"
