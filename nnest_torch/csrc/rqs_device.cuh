// The RQS forward of one (row, dim) and its backward, as device code
// shared by the spline coupling's kernel pair (spline_coupling.cu) and the
// spline chain's (spline_chain.cu).
//
// Lane<K>::make computes, from the conditioner MLP's raw output o for one
// dim ([K widths | K heights | K-1 derivatives]) and the value x it
// transforms, everything of the forward: the reference's pre-normalisation
// (bijectors/spline.py: widths and heights 2B * softmax, derivatives
// softplus), rqs's own (softmax again, sizes floored at 1e-3, cumulated to
// knots with the ends pinned to -B and B; end derivatives pinned to 1
// through the softplus-inverse constant, 1e-3 + softplus of the interior
// ones), the bin from the same edge comparisons (last edge + 1e-6), theta
// clamped to [0, 1], the value and log-derivative, identity tails outside
// [-B, B]. Lane<K>::grad gives d/d o and d/dx from dL/dy and dL/dlogdet:
// the gradients autograd gives through the plain code (zero through the
// clamp where theta is clamped, only d/dx = 1 in the tails, nothing
// through the bin selection). Every intermediate lives in registers (K is
// a template argument); f32 throughout, no fast-math intrinsics.

#pragma once

#include <cuda_runtime.h>

namespace nnest_rqs {

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

}  // namespace nnest_rqs
