// Native runtime for nnest_torch: the hot host-side paths (a port of
// nnest_tpu/runtime/src/nnest_runtime.cpp, the same functions).
//
// The chain writer formats getdist/CosmoMC text chains row by row in C
// (np.savetxt formats each value through Python), the chain diagnostics
// run their O(chains x steps x lags) loops natively, and the scalar event
// writer frames a batch of TensorBoard scalars (one Event proto a row,
// TFRecord framing with masked CRC32C) in one call. Bound with ctypes by
// nnest_torch/runtime/__init__.py, which builds this file with g++ at
// first use into nnest_torch/csrc/build/; a machine without a compiler
// takes the numpy paths of nnest_torch/utils/evaluation.py and
// Sampler._save_samples, and the Python encoder of
// nnest_torch/utils/events.py.
//
// Build: g++ -O3 -shared -fPIC -o libnnest_runtime.so nnest_runtime.cpp

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

// CRC32C (Castagnoli, reflected polynomial 0x82F63B78), one table lookup a
// byte: a record is ~90 bytes.
struct Crc32cTable {
  uint32_t t[256];
  Crc32cTable() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c >> 1) ^ (0x82F63B78u & (0u - (c & 1u)));
      t[i] = c;
    }
  }
};

uint32_t masked_crc32c(const char* p, size_t n) {
  static const Crc32cTable table;
  uint32_t c = 0xFFFFFFFFu;
  for (size_t i = 0; i < n; ++i)
    c = table.t[(c ^ static_cast<unsigned char>(p[i])) & 0xFFu] ^ (c >> 8);
  c ^= 0xFFFFFFFFu;
  // TFRecord's mask
  return ((c >> 15) | (c << 17)) + 0xA282EAD8u;
}

void put_le(std::string& s, uint64_t v, int bytes) {
  for (int i = 0; i < bytes; ++i) s.push_back(static_cast<char>(v >> (8 * i)));
}

void put_varint(std::string& s, uint64_t v) {
  while (v >= 0x80) {
    s.push_back(static_cast<char>((v & 0x7F) | 0x80));
    v >>= 7;
  }
  s.push_back(static_cast<char>(v));
}

void put_bytes_field(std::string& s, int field, const std::string& b) {
  put_varint(s, (static_cast<uint64_t>(field) << 3) | 2);
  put_varint(s, b.size());
  s += b;
}

// Event.wall_time (field 1, double); proto3 leaves out a zero.
void put_wall_time(std::string& s, double wall_time) {
  uint64_t bits;
  std::memcpy(&bits, &wall_time, sizeof bits);
  if (bits) {
    s.push_back(0x09);
    put_le(s, bits, 8);
  }
}

// One TFRecord: length, its masked CRC, the data, its masked CRC.
void put_record(std::string& out, const std::string& data) {
  std::string len;
  put_le(len, data.size(), 8);
  out += len;
  put_le(out, masked_crc32c(len.data(), len.size()), 4);
  out += data;
  put_le(out, masked_crc32c(data.data(), data.size()), 4);
}

}  // namespace

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

// Append one TensorBoard scalar Event a row to the event file at path:
// Event{wall_time, step, summary{value{tag, simple_value}}}, the bytes
// SummaryWriter.add_scalar writes (simple_value is the row's value cast to
// float32), each framed as a TFRecord. A file that is empty when opened
// first takes the file-version Event{wall_time of the first row,
// file_version "brain.Event:2"}. Nothing is written for n = 0.
// Returns 0 on success, -1 on I/O error.
int write_scalar_events(const char* path, const char* tag,
                        const int64_t* steps, const double* values,
                        const double* wall_times, int64_t n) {
  if (n <= 0) return 0;
  FILE* f = std::fopen(path, "ab");
  if (!f) return -1;
  std::fseek(f, 0, SEEK_END);
  std::string out, event, summary, value;
  if (std::ftell(f) == 0) {
    put_wall_time(event, wall_times[0]);
    put_bytes_field(event, 3, "brain.Event:2");
    put_record(out, event);
  }
  const std::string tag_s(tag);
  for (int64_t i = 0; i < n; ++i) {
    value.clear();
    if (!tag_s.empty()) put_bytes_field(value, 1, tag_s);
    float v = static_cast<float>(values[i]);
    uint32_t vbits;
    std::memcpy(&vbits, &v, sizeof vbits);
    value.push_back(0x15);  // simple_value (field 2, float), in a oneof
    put_le(value, vbits, 4);
    summary.clear();
    put_bytes_field(summary, 1, value);
    event.clear();
    put_wall_time(event, wall_times[i]);
    if (steps[i] != 0) {
      event.push_back(0x10);  // step (field 2, int64)
      put_varint(event, static_cast<uint64_t>(steps[i]));
    }
    put_bytes_field(event, 5, summary);
    put_record(out, event);
  }
  std::fwrite(out.data(), 1, out.size(), f);
  int rc = std::ferror(f) ? -1 : 0;
  if (std::fclose(f) != 0) rc = -1;
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
