// Native AMC (CMU mocap) parser of the PyTorch port's data layer.
//
// Turns the AMC motion-capture text format into a dense row-major double
// matrix, roughly an order of magnitude faster than the Python line
// parser of data/mocap.py, which matters when sweeping many CMU trials.
// g++ builds it at first use into build/kernels/ (data/native_io.py).
//
// C ABI (bound with ctypes by dp_gp_lvm_tpu_torch/data/native_io.py):
//   amc_parse(path, &data, &rows, &cols, errbuf, errlen) -> 0 on success
//   amc_free(data)
//
// Format handled (same as the Python parser in data/mocap.py):
//   ':'-prefixed header lines and '#' comments are skipped;
//   an all-digit line starts a new frame;
//   'bone v1 v2 ...' lines append that bone's channels to the frame.
// Channel layout is fixed by the first frame; every later frame is
// validated bone-by-bone (name AND channel count, in order) against it —
// a reordered or reshaped frame is a hard error, never a silent column
// permutation. Short trailing frames are dropped.

#include <cerrno>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Parser {
  std::vector<std::string> bone_order;   // fixed by the first frame
  std::vector<size_t> bone_width;        // channels per bone, same order
  std::vector<double> data;     // row-major, cols fixed after first frame
  std::vector<double> current;  // current frame accumulator
  size_t cols = 0;
  size_t bone_idx = 0;  // next expected bone within the current frame
  bool first_frame_done = false;
  bool in_frame = false;

  // Validate one "bone v1 v2 ..." line against the first frame's layout.
  bool check_bone(const char* name, size_t name_len, size_t width,
                  std::string* err) {
    if (!first_frame_done) {
      bone_order.emplace_back(name, name_len);
      bone_width.push_back(width);
      return true;
    }
    if (bone_idx >= bone_order.size()) {
      *err = "frame has more bones than the first frame";
      return false;
    }
    const std::string& expect = bone_order[bone_idx];
    if (expect.size() != name_len ||
        std::memcmp(expect.data(), name, name_len) != 0) {
      *err = "bone order differs from the first frame (got '" +
             std::string(name, name_len) + "', expected '" + expect + "')";
      return false;
    }
    if (bone_width[bone_idx] != width) {
      *err = "bone '" + expect + "' channel count differs from first frame";
      return false;
    }
    ++bone_idx;
    return true;
  }

  bool flush_frame(std::string* err) {
    if (!in_frame) return true;
    if (!first_frame_done) {
      cols = current.size();
      first_frame_done = true;
      bone_idx = bone_order.size();
    }
    if (current.size() != cols || bone_idx != bone_order.size()) {
      // ignore short trailing frames; error on mid-file inconsistency
      if (current.size() < cols) {
        current.clear();
        in_frame = false;
        bone_idx = 0;
        return true;
      }
      *err = "frame with inconsistent channel count";
      return false;
    }
    data.insert(data.end(), current.begin(), current.end());
    current.clear();
    bone_idx = 0;
    return true;
  }
};

bool all_digits(const char* s, size_t n) {
  if (n == 0) return false;
  for (size_t i = 0; i < n; ++i)
    if (s[i] < '0' || s[i] > '9') return false;
  return true;
}

}  // namespace

extern "C" {

int amc_parse(const char* path, double** out_data, long* out_rows,
              long* out_cols, char* errbuf, long errlen) {
  FILE* f = std::fopen(path, "rb");
  if (!f) {
    std::snprintf(errbuf, errlen, "open failed: %s", std::strerror(errno));
    return 1;
  }
  Parser p;
  std::string err;
  char line[8192];
  while (std::fgets(line, sizeof(line), f)) {
    size_t len = std::strlen(line);
    while (len && (line[len - 1] == '\n' || line[len - 1] == '\r' ||
                   line[len - 1] == ' '))
      line[--len] = 0;
    const char* s = line;
    while (*s == ' ' || *s == '\t') ++s;
    len = std::strlen(s);
    if (len == 0 || s[0] == '#' || s[0] == ':') continue;
    if (all_digits(s, len)) {  // new frame marker
      if (!p.flush_frame(&err)) break;
      p.in_frame = true;
      continue;
    }
    if (!p.in_frame) continue;  // channel data before first frame marker
    // "bone v1 v2 ..."
    const char* q = s;
    while (*q && *q != ' ' && *q != '\t') ++q;
    char* endp = nullptr;
    size_t width = 0;
    for (const char* v = q; *v;) {
      while (*v == ' ' || *v == '\t') ++v;
      if (!*v) break;
      double x = std::strtod(v, &endp);
      if (endp == v) {
        err = "bad numeric field";
        break;
      }
      p.current.push_back(x);
      ++width;
      v = endp;
    }
    if (err.empty()) p.check_bone(s, static_cast<size_t>(q - s), width, &err);
    if (!err.empty()) break;
  }
  if (err.empty()) p.flush_frame(&err);
  std::fclose(f);
  if (!err.empty()) {
    std::snprintf(errbuf, errlen, "%s", err.c_str());
    return 2;
  }
  if (!p.first_frame_done || p.data.empty()) {
    std::snprintf(errbuf, errlen, "no frames parsed");
    return 3;
  }
  long rows = static_cast<long>(p.data.size() / p.cols);
  double* buf =
      static_cast<double*>(std::malloc(p.data.size() * sizeof(double)));
  if (!buf) {
    std::snprintf(errbuf, errlen, "alloc failed");
    return 4;
  }
  std::memcpy(buf, p.data.data(), p.data.size() * sizeof(double));
  *out_data = buf;
  *out_rows = rows;
  *out_cols = static_cast<long>(p.cols);
  return 0;
}

void amc_free(double* ptr) { std::free(ptr); }

}  // extern "C"
