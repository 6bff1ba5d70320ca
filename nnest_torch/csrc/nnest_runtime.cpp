// Native runtime for nnest_torch: the hot host-side paths (a port of
// nnest_tpu/runtime/src/nnest_runtime.cpp, the same functions).
//
// The chain writer formats getdist/CosmoMC text chains row by row in C
// (np.savetxt formats each value through Python), and the chain
// diagnostics run their O(chains x steps x lags) loops natively. Bound with
// ctypes by nnest_torch/runtime/__init__.py, which builds this file with
// g++ at first use into nnest_torch/csrc/build/; a machine without a
// compiler takes the numpy paths of nnest_torch/utils/evaluation.py and
// Sampler._save_samples.
//
// Build: g++ -O3 -shared -fPIC -o libnnest_runtime.so nnest_runtime.cpp

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

extern "C" {

// Write a getdist/CosmoMC text chain: rows of
//   weight -loglike params... [derived...]
// samples: (n, d) row-major, derived: (n, nd) or nullptr.
// Returns 0 on success, -1 on I/O error.
int write_chain(const char* path,
                const double* weights,
                const double* logl,
                const double* samples,
                const double* derived,
                int64_t n, int64_t d, int64_t nd,
                double min_weight,
                const char* header) {
  FILE* f = std::fopen(path, "w");
  if (!f) return -1;
  std::vector<char> buf(1 << 20);
  std::setvbuf(f, buf.data(), _IOFBF, buf.size());
  if (header && header[0]) std::fprintf(f, "#%s\n", header);
  for (int64_t i = 0; i < n; ++i) {
    double w = weights[i] > min_weight ? weights[i] : min_weight;
    std::fprintf(f, "%.5E %.5E", w, -logl[i]);
    const double* row = samples + i * d;
    for (int64_t j = 0; j < d; ++j) std::fprintf(f, " %.5E", row[j]);
    if (derived && nd > 0) {
      const double* drow = derived + i * nd;
      for (int64_t j = 0; j < nd; ++j) std::fprintf(f, " %.5E", drow[j]);
    }
    std::fputc('\n', f);
  }
  int rc = std::ferror(f) ? -1 : 0;
  std::fclose(f);
  return rc;
}

// Truncated-autocorrelation ESS (utils/evaluation.effective_sample_size):
// for each lag s while any dim has rho_s > 0.05, accumulate
// 2*rho_s*(1 - s/t); ESS_j = t / sum_j. x: (b, t, d) row-major.
void ess_autocorr(const double* x, int64_t b, int64_t t, int64_t d,
                  const double* mu, const double* var, double* ess_out) {
  std::vector<double> acc(d, 1.0);
  std::vector<double> rho(d);
  // Pre-center a copy for cache-friendly lag products.
  std::vector<double> y(static_cast<size_t>(b) * t * d);
  for (int64_t i = 0; i < b; ++i)
    for (int64_t s = 0; s < t; ++s)
      for (int64_t j = 0; j < d; ++j) {
        size_t idx = (static_cast<size_t>(i) * t + s) * d + j;
        y[idx] = x[idx] - mu[j];
      }
  for (int64_t s = 1; s < t; ++s) {
    std::fill(rho.begin(), rho.end(), 0.0);
    for (int64_t i = 0; i < b; ++i) {
      const double* yi = y.data() + static_cast<size_t>(i) * t * d;
      for (int64_t k = 0; k < t - s; ++k) {
        const double* p = yi + k * d;
        const double* q = yi + (k + s) * d;
        for (int64_t j = 0; j < d; ++j) rho[j] += p[j] * q[j];
      }
    }
    bool any = false;
    double denom = static_cast<double>(b) * (t - s);
    for (int64_t j = 0; j < d; ++j) {
      double r = rho[j] / (denom * var[j]);
      if (r > 0.05) {
        acc[j] += 2.0 * r * (1.0 - static_cast<double>(s) / t);
        any = true;
      }
    }
    if (!any) break;
  }
  for (int64_t j = 0; j < d; ++j) ess_out[j] = t / acc[j];
}

// Fraction of steps where the chain moved (utils/evaluation.acceptance_rate).
double acceptance_rate(const double* x, int64_t b, int64_t t, int64_t d) {
  int64_t moved = 0;
  for (int64_t i = 0; i < b; ++i) {
    const double* xi = x + static_cast<size_t>(i) * t * d;
    for (int64_t s = 1; s < t; ++s) {
      const double* p = xi + (s - 1) * d;
      const double* q = xi + s * d;
      if (std::memcmp(p, q, d * sizeof(double)) != 0) ++moved;
    }
  }
  return static_cast<double>(moved) / (static_cast<double>(b) * (t - 1));
}

// Mean Euclidean jump distance (utils/evaluation.mean_jump_distance).
double mean_jump(const double* x, int64_t b, int64_t t, int64_t d) {
  double total = 0.0;
  for (int64_t i = 0; i < b; ++i) {
    const double* xi = x + static_cast<size_t>(i) * t * d;
    for (int64_t s = 1; s < t; ++s) {
      const double* p = xi + (s - 1) * d;
      const double* q = xi + s * d;
      double acc = 0.0;
      for (int64_t j = 0; j < d; ++j) {
        double diff = q[j] - p[j];
        acc += diff * diff;
      }
      total += std::sqrt(acc);
    }
  }
  return total / (static_cast<double>(b) * (t - 1));
}

}  // extern "C"
