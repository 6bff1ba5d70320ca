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
// twin bit for bit. The bytes it must move are the candidates' flags (a
// byte each), the logl of the flagged ones (in 32-byte sectors), the live
// logl (4 bytes a point, read once), and for each slot replaced its row of
// x and derived read and written and its logl: under 1 KB to about 450 KB
// at the paths' shapes, well under a microsecond at HBM's rate. What
// bounds the kernel is a dependent chain instead: every accept changes the
// worst point, and the next candidate's test needs the new one. The design
// cuts the cost of each link of that chain; it stays far above the byte
// bound.
//
// Design (one block of kThreads threads, one launch, no host read):
//   1. A 32-ary min-tree of the live logl, built once by the whole block:
//      node p of level l holds the least (key, index) pair of its 32
//      children, the smaller index on a tie, so the root is the element
//      torch.argmin and jnp.argmin pick. Keys are order-preserving unsigned
//      images of the values (ord_of: -0.0 and +0.0 one key), so a pair is
//      one 64-bit integer and a warp reduces 32 of them with two redux.sync
//      minima (the key, then the index among the lanes holding it). Inner
//      nodes live in shared memory; the leaves' keys too while n live points
//      fit (nnest_consume_pool_shared_capacity), else the leaves stay in
//      `al`, whose only writer the kernel is. 1000 points: 2 levels; 60000: 4.
//   2. Pre-filter. The worst value only rises during a consumption, so a
//      candidate that is unflagged, or whose logl is not above the FIRST
//      worst value, is never accepted. The block streams all m candidates
//      once to count each warp's survivors (each warp owns a contiguous
//      segment, 4 candidates a lane), then, after one barrier, again to
//      write the survivors' (logl, index) in order to a compact list: in
//      shared memory when it fits, else in the wrapper's scratch.
//   3. One warp walks the survivors, 32 to a ballot against the root's key,
//      with no block barrier per accept. For the current worst slot it holds
//      the least pair among each path node's 31 siblings and the least of
//      those, the tree's minimum without the slot: one reduction a level,
//      the levels independent of each other. An accept then needs no
//      reduction: the new root is the lesser of the candidate's pair and
//      that minimum, and the slot's path is rewritten from the siblings'
//      pairs with 64-bit minima. The lane that owns a node (index mod 32) is
//      the only one that writes or reads it, so no __syncwarp is needed. The
//      accepted (candidate, slot) pairs are logged over the consumed part of
//      the survivor list, with each slot's last accept.
//   4. After two barriers the whole block copies the rows (x, derived, and
//      the logl when the leaves' keys were in shared memory) of each slot's
//      last accept, so no row copy sits on the chain.
//
// Live logl are finite (the samplers sanitize them to >= -1e31); a flagged
// candidate's logl is tested with the float compare (a NaN never passes),
// survivors then by key, which orders every non-NaN float as the float
// compare does with +0.0 == -0.0; the first index wins a tie.

#include <climits>
#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
// 32^7 > INT_MAX: at most 7 inner levels above the leaves
constexpr int kMaxLevels = 7;
// dynamic shared memory at most (the block's static share fits beside it)
constexpr size_t kSmemBytes = 226 * 1024;
constexpr unsigned kFull = 0xffffffffu;
// the pair of an empty child: above every pair of a finite value or inf
constexpr uint64_t kEmpty = ~0ull;
// a logged accept that a later one to its slot overwrites
constexpr unsigned kStale = 0xffffffffu;

// Where everything lives, from (n, m) alone.
struct Plan {
  int levels;                   // inner levels; level `levels` is the root
  int count[kMaxLevels + 1];    // nodes a level; count[0] = n leaves
  int offset[kMaxLevels + 1];   // a level's start in the node array
  int inner;                    // inner nodes in all
  int nodes_shared;             // inner nodes in shared memory
  int leaves_shared;            // leaves' keys in shared memory (else `al`)
  int last_shared;              // each slot's last accept in shared memory
  int list_cap;                 // survivors the shared list holds
  size_t last_off, list_off;    // byte offsets in shared memory
  size_t smem;                  // dynamic shared bytes
  size_t scratch_list;          // survivor list when it outgrows shared
  size_t scratch_last;          // each slot's last accept, when not shared
  size_t scratch_nodes;         // inner nodes when they outgrow shared
  size_t scratch_bytes;
};

Plan make_plan(int n, int m) {
  Plan p = {};
  p.count[0] = n;
  int c = n;
  do {
    c = (c + 31) / 32;
    ++p.levels;
    p.offset[p.levels] = p.inner;
    p.count[p.levels] = c;
    p.inner += c;
  } while (c > 1);
  const size_t nodes_b = (size_t)p.inner * 8, leaves_b = (size_t)n * 4;
  size_t used = 0;
  p.nodes_shared = nodes_b <= kSmemBytes;
  if (p.nodes_shared) used = nodes_b;
  p.leaves_shared = p.nodes_shared && used + leaves_b <= kSmemBytes;
  if (p.leaves_shared) used += leaves_b;
  p.last_off = used;
  p.last_shared = p.leaves_shared && used + leaves_b <= kSmemBytes;
  if (p.last_shared) used += leaves_b;
  p.list_off = (used + 7) & ~(size_t)7;
  const size_t cap = (kSmemBytes - p.list_off) / 8;
  p.list_cap = (int)(cap < (size_t)m ? cap : (size_t)m);
  p.smem = p.list_off + (size_t)p.list_cap * 8;
  size_t s = 0;
  p.scratch_list = s;
  if (m > p.list_cap) s += (size_t)m * 8;
  p.scratch_last = s;
  if (!p.last_shared) s += (leaves_b + 7) & ~(size_t)7;
  p.scratch_nodes = s;
  if (!p.nodes_shared) s += nodes_b;
  p.scratch_bytes = s;
  return p;
}

// An unsigned key that orders non-NaN floats as the float compare does,
// -0.0 and +0.0 one key.
__device__ __forceinline__ unsigned ord_of(unsigned u) {
  if ((u << 1) == 0) u = 0;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float float_of(unsigned key) {
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7fffffffu) : ~key);
}

__device__ __forceinline__ uint64_t pair(unsigned key, unsigned idx) {
  return ((uint64_t)key << 32) | idx;
}

__device__ __forceinline__ uint64_t lesser(uint64_t a, uint64_t b) {
  return a < b ? a : b;
}

// The least of the warp's 32 pairs (the smaller index on a tie), in every
// lane.
__device__ __forceinline__ uint64_t warp_min(uint64_t p) {
  const unsigned key = (unsigned)(p >> 32);
  const unsigned k = __reduce_min_sync(kFull, key);
  return pair(k, __reduce_min_sync(kFull, key == k ? (unsigned)p : UINT_MAX));
}

// Candidates i..i+3 (those below hi): their flags (a byte each) and logl.
struct Four {
  unsigned flags;
  float v[4];
};

__device__ __forceinline__ Four load4(const uint8_t* __restrict__ flags,
                                      const float* __restrict__ logl, int i,
                                      int hi, bool aligned) {
  Four c = {0u, {0.f, 0.f, 0.f, 0.f}};
  if (aligned && i + 3 < hi) {
    c.flags = *reinterpret_cast<const unsigned*>(flags + i);
    const float4 q = *reinterpret_cast<const float4*>(logl + i);
    c.v[0] = q.x;
    c.v[1] = q.y;
    c.v[2] = q.z;
    c.v[3] = q.w;
  } else {
#pragma unroll
    for (int s = 0; s < 4; ++s)
      if (i + s < hi) {
        c.flags |= (unsigned)flags[i + s] << (8 * s);
        c.v[s] = logl[i + s];
      }
  }
  return c;
}

// Which of the four survive the pre-filter (bit s for i + s).
__device__ __forceinline__ unsigned pass4(const Four& c, float thr) {
  unsigned pass = 0;
#pragma unroll
  for (int s = 0; s < 4; ++s)
    if (((c.flags >> (8 * s)) & 0xffu) != 0 && c.v[s] > thr) pass |= 1u << s;
  return pass;
}

// The leaves: their keys in shared memory, or the live logl themselves in
// global memory (`al`, whose only writer the kernel is).
template <bool kShared>
struct Leaves;

template <>
struct Leaves<true> {
  unsigned* key;
  __device__ unsigned load(int j) const { return key[j]; }
  __device__ void store(int j, unsigned k, unsigned) const { key[j] = k; }
};

template <>
struct Leaves<false> {
  float* al;
  __device__ unsigned load(int j) const {
    return ord_of(__float_as_uint(al[j]));
  }
  __device__ void store(int j, unsigned, unsigned bits) const {
    al[j] = __uint_as_float(bits);
  }
};

// The worst slot's path: at each level the least pair among the path
// node's siblings, and the least of those (the tree without the slot).
template <int L>
struct Path {
  uint64_t sib[L];
  uint64_t rest;
};

// Lane j's sibling at each level of slot's path (child j of the path node's
// parent; empty for the path node itself and past the level's end).
template <int L, typename Lv, typename Nodes>
__device__ __forceinline__ void load_siblings(const Plan& plan,
                                              const Lv& leaves, Nodes nodes,
                                              unsigned slot, int lane,
                                              uint64_t (&v)[L]) {
#pragma unroll
  for (int l = 0; l < L; ++l) {
    const int node = (int)(slot >> (5 * l));
    const int j = (node & ~31) + lane;
    v[l] = kEmpty;
    if (j < plan.count[l] && lane != (node & 31))
      v[l] = l == 0 ? pair(leaves.load(j), (unsigned)j)
                    : nodes[plan.offset[l] + j];
  }
}

template <int L>
__device__ __forceinline__ void reduce_path(const uint64_t (&v)[L],
                                            Path<L>& p) {
  p.rest = kEmpty;
#pragma unroll
  for (int l = 0; l < L; ++l) {
    p.sib[l] = warp_min(v[l]);
    p.rest = lesser(p.rest, p.sib[l]);
  }
}

// Step 3: warp 0 walks the `total` survivors of `list`, logging accept e as
// list[e] = (candidate, slot) and last[slot] = e; returns the accepts.
template <int L, typename List, typename Lv, typename Nodes>
__device__ __forceinline__ int walk(const Plan& plan, List list, int total,
                                   const Lv& leaves, Nodes nodes, int* last,
                                   uint64_t root0) {
  const int lane = threadIdx.x & 31;
  unsigned root = (unsigned)(root0 >> 32), slot = (unsigned)root0;
  Path<L> p;
  uint64_t v[L];
  load_siblings<L>(plan, leaves, nodes, slot, lane, v);
  reduce_path<L>(v, p);
  int acc = 0;
  uint2 cur = lane < total ? list[lane] : make_uint2(0u, 0u);
  for (int pos = 0; pos < total; pos += 32) {
    // the next batch lies past every entry the log can reach in this one
    const int nx = pos + 32 + lane;
    const uint2 next = nx < total ? list[nx] : make_uint2(0u, 0u);
    // key 0 is below every survivor's (and never above the root's)
    const unsigned ckey = pos + lane < total ? ord_of(cur.x) : 0u;
    // the first hit's lane and its candidate, shuffled to every lane
    unsigned hits = __ballot_sync(kFull, ckey > root);
    int f = __ffs(hits) - 1;
    unsigned vkey = __shfl_sync(kFull, ckey, f & 31);
    unsigned vbits = __shfl_sync(kFull, cur.x, f & 31);
    unsigned cand = __shfl_sync(kFull, cur.y, f & 31);
    while (hits) {
      // the candidate's pair takes the slot's leaf: the new root is the
      // lesser of it and the rest of the tree
      uint64_t c = pair(vkey, slot);
      const uint64_t top = lesser(c, p.rest);
#pragma unroll
      for (int l = 0; l + 1 < L; ++l) {   // the slot's path, level by level
        c = lesser(c, p.sib[l]);
        const unsigned node = slot >> (5 * (l + 1));
        if (lane == (int)(node & 31)) nodes[plan.offset[l + 1] + node] = c;
      }
      if (lane == (int)(slot & 31)) leaves.store(slot, vkey, vbits);
      if (lane == 0) {
        list[acc] = make_uint2(cand, slot);
        last[slot] = acc;
      }
      ++acc;
      root = (unsigned)(top >> 32);
      slot = (unsigned)top;
      // the next path's loads, the next hit's ballot and shuffles, then
      // the path's reductions: each waits beside the others
      load_siblings<L>(plan, leaves, nodes, slot, lane, v);
      hits = __ballot_sync(kFull, ckey > root) &
             (f == 31 ? 0u : kFull << (f + 1));
      f = __ffs(hits) - 1;
      vkey = __shfl_sync(kFull, ckey, f & 31);
      vbits = __shfl_sync(kFull, cur.x, f & 31);
      cand = __shfl_sync(kFull, cur.y, f & 31);
      reduce_path<L>(v, p);
    }
    cur = next;
  }
  return acc;
}

// Whether an iteration in (it0, it0 + accepts] is a multiple of interval.
__device__ __forceinline__ bool crosses(int it0, int accepts, int interval) {
  if (interval <= 0 || accepts == 0) return false;
  const long long a = it0, b = (long long)it0 + accepts, q = interval;
  const long long fa = a >= 0 ? a / q : -((-a + q - 1) / q);
  const long long fb = b >= 0 ? b / q : -((-b + q - 1) / q);
  return fb > fa;
}

// The rows (width w) of each slot's last accept, from src to dst.
__device__ __forceinline__ void copy_rows(float* __restrict__ dst,
                                          const float* __restrict__ src,
                                          int w, const uint2* list,
                                          int accepts) {
  constexpr int U = 8;   // entries in flight a thread
  if (w <= 0) return;
  if (w <= kThreads) {   // kThreads / w rows a pass, a thread a column
    const int per = kThreads / w, r = threadIdx.x / w;
    const int j = threadIdx.x - r * w;
    if (r >= per) return;
    for (int e0 = r; e0 < accepts; e0 += per * U) {
      uint2 en[U];
      float v[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int e = e0 + per * u;
        en[u] = e < accepts ? list[e] : make_uint2(kStale, 0u);
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (en[u].x != kStale) v[u] = src[(size_t)en[u].x * w + j];
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (en[u].x != kStale) dst[(size_t)en[u].y * w + j] = v[u];
    }
  } else {
    for (int e = 0; e < accepts; ++e) {
      const uint2 en = list[e];
      if (en.x != kStale)
        for (int j = threadIdx.x; j < w; j += kThreads)
          dst[(size_t)en.y * w + j] = src[(size_t)en.x * w + j];
    }
  }
}

template <bool kLeavesShared, int L>
__global__ void __launch_bounds__(kThreads, 1)
    consume_pool_kernel(float* __restrict__ au, float* __restrict__ al,
                        float* __restrict__ ad, const int* __restrict__ it_in,
                        int* __restrict__ it_out,
                        uint8_t* __restrict__ crossed_out,
                        const uint8_t* __restrict__ flags,
                        const float* __restrict__ cand_logl,
                        const float* __restrict__ cand_x,
                        const float* __restrict__ cand_d, int d, int k,
                        int m, int update_interval, const Plan plan,
                        uint8_t* __restrict__ scratch, int aligned) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_count[kWarps];
  __shared__ int s_accepts;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint64_t* nodes = (kLeavesShared || plan.nodes_shared)
                        ? reinterpret_cast<uint64_t*>(smem)
                        : reinterpret_cast<uint64_t*>(scratch +
                                                      plan.scratch_nodes);
  Leaves<kLeavesShared> leaves;
  if constexpr (kLeavesShared)
    leaves.key = reinterpret_cast<unsigned*>(smem + (size_t)plan.inner * 8);
  else
    leaves.al = al;
  int* last = plan.last_shared
                  ? reinterpret_cast<int*>(smem + plan.last_off)
                  : reinterpret_cast<int*>(scratch + plan.scratch_last);

  // 1. the tree, a level a barrier; the leaves' keys copied on the way
  constexpr int kGroups = 4;   // a warp's node groups in flight
#pragma unroll
  for (int l = 1; l <= L; ++l) {
    const int below = plan.count[l - 1], above = plan.count[l];
    for (int q0 = warp; q0 < above; q0 += kWarps * kGroups) {
      uint64_t v[kGroups];
#pragma unroll
      for (int u = 0; u < kGroups; ++u) {
        const int j = (q0 + kWarps * u) * 32 + lane;
        v[u] = kEmpty;
        if (j < below) {
          if (l == 1) {
            const unsigned key = ord_of(__float_as_uint(al[j]));
            if constexpr (kLeavesShared) leaves.key[j] = key;
            v[u] = pair(key, (unsigned)j);
          } else {
            v[u] = nodes[plan.offset[l - 1] + j];
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kGroups; ++u) {
        const int q = q0 + kWarps * u;
        if (q < above) {
          const uint64_t mn = warp_min(v[u]);
          if (lane == 0) nodes[plan.offset[l] + q] = mn;
        }
      }
    }
    __syncthreads();
  }
  const uint64_t root0 = nodes[plan.offset[L]];
  const float thr = float_of((unsigned)(root0 >> 32));

  // 2. pre-filter against the first worst value: count, then write in order
  const int seg = (((m + kWarps - 1) / kWarps) + 127) & ~127;
  const int lo = min(warp * seg, m), hi = min(lo + seg, m);
  constexpr int kCount = 8, kWrite = 4;   // chunks of 128 in flight a warp
  int count = 0;
  for (int base = lo; base < hi; base += 128 * kCount) {
    Four c[kCount];
#pragma unroll
    for (int u = 0; u < kCount; ++u)
      c[u] = load4(flags, cand_logl, base + 128 * u + 4 * lane, hi, aligned);
#pragma unroll
    for (int u = 0; u < kCount; ++u) count += __popc(pass4(c[u], thr));
  }
  count = (int)__reduce_add_sync(kFull, (unsigned)count);
  if (lane == 0) s_count[warp] = count;
  __syncthreads();
  int start = 0, total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) start += s_count[w];
    total += s_count[w];
  }
  const bool list_shared = total <= plan.list_cap;
  uint2* list = list_shared
                    ? reinterpret_cast<uint2*>(smem + plan.list_off)
                    : reinterpret_cast<uint2*>(scratch + plan.scratch_list);
  const unsigned below_me = (1u << lane) - 1u;
  for (int base = lo, at = start; base < hi && at < start + count;
       base += 128 * kWrite) {
    Four c[kWrite];
#pragma unroll
    for (int u = 0; u < kWrite; ++u)
      c[u] = load4(flags, cand_logl, base + 128 * u + 4 * lane, hi, aligned);
#pragma unroll
    for (int u = 0; u < kWrite; ++u) {
      const int i = base + 128 * u + 4 * lane;
      const unsigned pass = pass4(c[u], thr);
      int w = at, chunk = 0;
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const unsigned b = __ballot_sync(kFull, (pass >> s) & 1u);
        w += __popc(b & below_me);
        chunk += __popc(b);
      }
#pragma unroll
      for (int s = 0; s < 4; ++s)
        if ((pass >> s) & 1u)
          list[w++] = make_uint2(__float_as_uint(c[u].v[s]), (unsigned)(i + s));
      at += chunk;
    }
  }
  __syncthreads();

  // 3. one warp walks the survivors
  if (warp == 0) {
    // `list` itself, spelled from `smem` where the list is shared so that
    // its loads are shared-memory loads: 6-9% less time than one call on
    // `list` at the many-accept shapes (H100, chip_smoke.py --pool-baseline)
    const int accepts =
        list_shared
            ? walk<L>(plan, reinterpret_cast<uint2*>(smem + plan.list_off),
                      total, leaves, nodes, last, root0)
            : walk<L>(plan, list, total, leaves, nodes, last, root0);
    if (lane == 0) {
      const int it0 = *it_in;
      s_accepts = accepts;
      *it_out = it0 + accepts;
      *crossed_out = (uint8_t)crosses(it0, accepts, update_interval);
    }
  }
  __syncthreads();

  // 4. mark the accepts a later one to the same slot overwrites; write the
  // others' logl (from the leaves' keys no float comes back), then rows
  const int accepts = s_accepts;
  for (int e = threadIdx.x; e < accepts; e += kThreads) {
    const uint2 en = list[e];
    if (last[en.y] != e)
      list[e].x = kStale;
    else if (kLeavesShared)
      al[en.y] = cand_logl[en.x];
  }
  __syncthreads();
  copy_rows(au, cand_x, d, list, accepts);
  copy_rows(ad, cand_d, k, list, accepts);
}

template <bool kLeavesShared, int L>
int launch(const Plan& p, void* au, void* al, void* ad, const void* it_in,
           void* it_out, void* crossed_out, const void* flags,
           const void* cand_logl, const void* cand_x, const void* cand_d,
           int d, int k, int m, int update_interval, void* scratch,
           void* stream) {
  static bool attribute_set = false;
  if (!attribute_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        consume_pool_kernel<kLeavesShared, L>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
    if (e != cudaSuccess) return (int)e;
    attribute_set = true;
  }
  const int aligned = (reinterpret_cast<uintptr_t>(flags) % 4 == 0) &&
                      (reinterpret_cast<uintptr_t>(cand_logl) % 16 == 0);
  consume_pool_kernel<kLeavesShared, L>
      <<<1, kThreads, p.smem, (cudaStream_t)stream>>>(
          (float*)au, (float*)al, (float*)ad, (const int*)it_in,
          (int*)it_out, (uint8_t*)crossed_out, (const uint8_t*)flags,
          (const float*)cand_logl, (const float*)cand_x,
          (const float*)cand_d, d, k, m, update_interval, p,
          (uint8_t*)scratch, aligned);
  return (int)cudaGetLastError();
}

}  // namespace

// The most live points whose logl the kernel holds in shared memory (with
// the tree above them).
extern "C" int nnest_consume_pool_shared_capacity() {
  int lo = 1, hi = (int)(kSmemBytes / 4);
  while (lo < hi) {
    const int mid = lo + (hi - lo + 1) / 2;
    if (make_plan(mid, 0).leaves_shared)
      lo = mid;
    else
      hi = mid - 1;
  }
  return lo;
}

// Bytes of device scratch one launch at (n, m) needs: each slot's last
// accept, and the survivor list and the inner nodes where they may outgrow
// shared memory.
extern "C" long long nnest_consume_pool_scratch_bytes(int n, int m) {
  return (long long)make_plan(n, m).scratch_bytes;
}

// One launch of a single block on `stream`. au (n, d), al (n,) and ad (n, k)
// are updated in place (ad may be null when k == 0); it_in points at the
// int32 iteration count; it_out (int32) and crossed_out (a bool byte)
// receive the new count and the boundary flag; scratch holds
// nnest_consume_pool_scratch_bytes(n, m) bytes, 8-byte aligned.
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue, with
// no launch, where m * max(d, k) overflows an int).
extern "C" int nnest_consume_pool(void* au, void* al, void* ad,
                                  const void* it_in, void* it_out,
                                  void* crossed_out, const void* flags,
                                  const void* cand_logl, const void* cand_x,
                                  const void* cand_d, int n, int d, int k,
                                  int m, int update_interval, void* scratch,
                                  void* stream) {
  if ((long long)m * (d > k ? d : k) > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const Plan p = make_plan(n, m);
#define NNEST_LAUNCH(S, L)                                                  \
  launch<S, L>(p, au, al, ad, it_in, it_out, crossed_out, flags, cand_logl, \
               cand_x, cand_d, d, k, m, update_interval, scratch, stream)
  // leaves in shared memory: n <= capacity < 32^4 (4 levels at most);
  // leaves in `al`: n > capacity > 32^3 (4 levels at least)
  if (p.leaves_shared) switch (p.levels) {
      case 1: return NNEST_LAUNCH(true, 1);
      case 2: return NNEST_LAUNCH(true, 2);
      case 3: return NNEST_LAUNCH(true, 3);
      case 4: return NNEST_LAUNCH(true, 4);
    }
  else switch (p.levels) {
      case 4: return NNEST_LAUNCH(false, 4);
      case 5: return NNEST_LAUNCH(false, 5);
      case 6: return NNEST_LAUNCH(false, 6);
      case 7: return NNEST_LAUNCH(false, 7);
    }
#undef NNEST_LAUNCH
  return (int)cudaErrorInvalidConfiguration;
}
