// Parallel .npy video-feature loader + bucket-mean downsampler.
//
// A replacement for the reference's serial Python feature
// load (utils/data_utils.py:56-85: np.load per file + per-bucket Python
// mean loop over ~12k-34k videos).  Parses the NumPy .npy format (v1.0/2.0,
// little-endian f4/f8, C order, 2-D), downsamples rows to max_vlen with the
// exact reference bucket boundaries (np.round = round-half-to-even), and
// zero-pads into one contiguous (n_files, max_vlen, vdim) float32 block —
// the packed matrix the FeatureStore gathers batches from.
//
// C ABI only; bound from Python via ctypes (hual_tpu_torch/native/__init__.py).

#include <atomic>
#include <cfenv>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

// Error codes per file (0 = ok); Python falls back to np.load on failure.
enum Status : int32_t {
  kOk = 0,
  kOpenFailed = 1,
  kBadMagic = 2,
  kBadHeader = 3,
  kUnsupportedDtype = 4,
  kBadShape = 5,
  kReadFailed = 6,
};

struct Header {
  bool is_f8 = false;
  long rows = 0, cols = 0;
  long data_offset = 0;
};

int parse_header(FILE* f, Header* h) {
  unsigned char magic[8];
  if (fread(magic, 1, 8, f) != 8) return kBadMagic;
  if (memcmp(magic, "\x93NUMPY", 6) != 0) return kBadMagic;
  int major = magic[6];
  uint32_t header_len = 0;
  if (major == 1) {
    unsigned char b[2];
    if (fread(b, 1, 2, f) != 2) return kBadHeader;
    header_len = b[0] | (b[1] << 8);
    h->data_offset = 10 + header_len;
  } else if (major == 2 || major == 3) {
    unsigned char b[4];
    if (fread(b, 1, 4, f) != 4) return kBadHeader;
    header_len = b[0] | (b[1] << 8) | (b[2] << 16) | (b[3] << 24);
    h->data_offset = 12 + header_len;
  } else {
    return kBadHeader;
  }
  std::string hdr(header_len, '\0');
  if (fread(hdr.data(), 1, header_len, f) != header_len) return kBadHeader;

  if (hdr.find("'fortran_order': True") != std::string::npos) return kBadShape;
  if (hdr.find("'<f4'") != std::string::npos) {
    h->is_f8 = false;
  } else if (hdr.find("'<f8'") != std::string::npos) {
    h->is_f8 = true;
  } else {
    return kUnsupportedDtype;
  }
  auto sp = hdr.find("'shape':");
  if (sp == std::string::npos) return kBadHeader;
  auto lp = hdr.find('(', sp);
  auto rp = hdr.find(')', sp);
  if (lp == std::string::npos || rp == std::string::npos) return kBadHeader;
  std::string shape = hdr.substr(lp + 1, rp - lp - 1);
  long dims[3] = {0, 0, -1};
  int nd = 0;
  const char* p = shape.c_str();
  while (*p && nd < 3) {
    while (*p == ' ' || *p == ',') ++p;
    if (!*p) break;
    char* end = nullptr;
    long v = strtol(p, &end, 10);
    if (end == p) break;
    dims[nd++] = v;
    p = end;
  }
  if (nd != 2) return kBadShape;
  h->rows = dims[0];
  h->cols = dims[1];
  if (h->rows <= 0 || h->cols <= 0) return kBadShape;
  return kOk;
}

// Reference bucket boundaries (utils/data_utils.py:73-76): np.round is
// round-half-to-even == nearbyint under FE_TONEAREST.
inline long bucket_idx(long i, long max_clips, long num_clips) {
  double v = static_cast<double>(i) / max_clips * num_clips;
  long r = static_cast<long>(std::nearbyint(v));
  if (r > num_clips - 1) r = num_clips - 1;
  return r;
}

int load_one(const char* path, float* out, int64_t* out_len, long max_vlen,
             long vdim) {
  FILE* f = fopen(path, "rb");
  if (!f) return kOpenFailed;
  Header h;
  int st = parse_header(f, &h);
  if (st != kOk) {
    fclose(f);
    return st;
  }
  if (h.cols != vdim) {
    fclose(f);
    return kBadShape;
  }
  const long elem = h.is_f8 ? 8 : 4;
  std::vector<char> raw(static_cast<size_t>(h.rows) * h.cols * elem);
  if (fseek(f, h.data_offset, SEEK_SET) != 0 ||
      fread(raw.data(), 1, raw.size(), f) != raw.size()) {
    fclose(f);
    return kReadFailed;
  }
  fclose(f);

  auto at = [&](long r, long c) -> double {
    if (h.is_f8)
      return reinterpret_cast<const double*>(raw.data())[r * h.cols + c];
    return reinterpret_cast<const float*>(raw.data())[r * h.cols + c];
  };

  const long n = h.rows;
  float* dst = out;  // (max_vlen, vdim), caller pre-zeroed
  if (n <= max_vlen) {
    for (long r = 0; r < n; ++r)
      for (long c = 0; c < vdim; ++c)
        dst[r * vdim + c] = static_cast<float>(at(r, c));
    *out_len = n;
    return kOk;
  }
  // bucket-mean downsample to exactly max_vlen rows
  std::vector<double> acc(vdim);
  for (long i = 0; i < max_vlen; ++i) {
    long s = bucket_idx(i, max_vlen, n);
    long e = bucket_idx(i + 1, max_vlen, n);
    if (s < e) {
      std::fill(acc.begin(), acc.end(), 0.0);
      for (long r = s; r < e; ++r)
        for (long c = 0; c < vdim; ++c) acc[c] += at(r, c);
      const double inv = 1.0 / static_cast<double>(e - s);
      for (long c = 0; c < vdim; ++c)
        dst[i * vdim + c] = static_cast<float>(acc[c] * inv);
    } else {
      for (long c = 0; c < vdim; ++c)
        dst[i * vdim + c] = static_cast<float>(at(s, c));
    }
  }
  *out_len = max_vlen;
  return kOk;
}

}  // namespace

extern "C" {

// paths: n null-terminated strings; out: (n, max_vlen, vdim) float32,
// pre-zeroed; out_lens: (n,) int64; statuses: (n,) int32.
// Returns number of files loaded successfully.
int64_t hual_load_npy_batch(const char** paths, int64_t n, float* out,
                            int64_t* out_lens, int32_t* statuses,
                            int64_t max_vlen, int64_t vdim,
                            int32_t n_threads) {
  std::fesetround(FE_TONEAREST);
  if (n_threads <= 0) n_threads = std::thread::hardware_concurrency();
  if (n_threads < 1) n_threads = 1;
  std::atomic<int64_t> next(0), ok(0);
  auto worker = [&]() {
    std::fesetround(FE_TONEAREST);
    for (;;) {
      int64_t i = next.fetch_add(1);
      if (i >= n) return;
      int st = load_one(paths[i], out + i * max_vlen * vdim, &out_lens[i],
                        max_vlen, vdim);
      statuses[i] = st;
      if (st == kOk) ok.fetch_add(1);
    }
  };
  std::vector<std::thread> threads;
  for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
  return ok.load();
}

}  // extern "C"
