// PFM decode and disparity statistics in C++ worker threads, for the
// PyTorch package's FlyingThings3D pipeline; a copy of the JAX package's
// native/pfm_stats.cpp with the same C interface and arithmetic.
//
// The first scan of FlyingThings3D reads ~22k PFM disparity images to
// build each example's statistics cache (integer min/max disparity and a
// 512-bin cumulative distribution) that the dataset filters and benchmark
// protocols read. Python does it one file at a time; this library decodes
// and reduces in threads, called through ctypes
// (practicaldeepstereo_nips2018_tpu_torch/data/native.py, which builds it
// with g++ at first use).
//
// PFM format handled as the Python reader (data/pfm.py) does: "Pf"/"PF"
// header, dimensions line, scale line whose sign gives the byte order,
// rows stored bottom-up.

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr int kCumulativeBins = 512;

struct PfmImage {
  int height = 0;
  int width = 0;
  int channels = 0;
  std::vector<float> data;  // top-down row order
};

bool ReadLine(FILE* file, std::string* line) {
  line->clear();
  int c;
  while ((c = std::fgetc(file)) != EOF) {
    if (c == '\n') return true;
    line->push_back(static_cast<char>(c));
  }
  return !line->empty();
}

void ByteSwap(float* values, size_t count) {
  auto* bytes = reinterpret_cast<uint8_t*>(values);
  for (size_t i = 0; i < count; ++i) {
    std::swap(bytes[4 * i + 0], bytes[4 * i + 3]);
    std::swap(bytes[4 * i + 1], bytes[4 * i + 2]);
  }
}

bool IsLittleEndianHost() {
  const uint16_t probe = 1;
  return *reinterpret_cast<const uint8_t*>(&probe) == 1;
}

// Reads a PFM file; returns false on any parse error.
bool ReadPfm(const char* path, PfmImage* image) {
  FILE* file = std::fopen(path, "rb");
  if (!file) return false;
  std::string header, dimensions, scale_line;
  if (!ReadLine(file, &header) || !ReadLine(file, &dimensions) ||
      !ReadLine(file, &scale_line)) {
    std::fclose(file);
    return false;
  }
  int channels;
  if (header == "PF") {
    channels = 3;
  } else if (header == "Pf") {
    channels = 1;
  } else {
    std::fclose(file);
    return false;
  }
  int width = 0, height = 0;
  if (std::sscanf(dimensions.c_str(), "%d %d", &width, &height) != 2 ||
      width <= 0 || height <= 0) {
    std::fclose(file);
    return false;
  }
  const double scale = std::atof(scale_line.c_str());
  const bool file_little_endian = scale < 0.0;

  const size_t count =
      static_cast<size_t>(width) * height * channels;
  std::vector<float> raw(count);
  const size_t read = std::fread(raw.data(), sizeof(float), count, file);
  std::fclose(file);
  if (read != count) return false;
  if (file_little_endian != IsLittleEndianHost()) {
    ByteSwap(raw.data(), count);
  }

  // PFM rows are stored bottom-up; flip to top-down.
  image->height = height;
  image->width = width;
  image->channels = channels;
  image->data.resize(count);
  const size_t row_elements = static_cast<size_t>(width) * channels;
  for (int row = 0; row < height; ++row) {
    std::memcpy(image->data.data() + static_cast<size_t>(row) * row_elements,
                raw.data() + static_cast<size_t>(height - 1 - row) *
                    row_elements,
                row_elements * sizeof(float));
  }
  return true;
}

// Statistics as data/flyingthings3d.py::_compute_cumulative_distribution:
// bins [min(min,0), 1, 2, ..., 511, max(max,512)] -> 512 bins; element n of
// the cumulative output holds the percentage of pixels < n+1 (boundary bins
// absorb out-of-range values).
void ComputeStatistics(const PfmImage& image, float* minimum_out,
                       float* maximum_out, float* cumulative_out) {
  float minimum = INFINITY, maximum = -INFINITY;
  for (float v : image.data) {
    if (v < minimum) minimum = v;
    if (v > maximum) maximum = v;
  }
  const float floor_min = std::floor(minimum);
  const float ceil_max = std::ceil(maximum);
  std::vector<int64_t> histogram(kCumulativeBins, 0);
  const double lo = std::min<double>(floor_min, 0.0);
  const double hi = std::max<double>(ceil_max, 512.0);
  int64_t counted = 0;
  for (float v : image.data) {
    if (std::isnan(v) || v < lo || v > hi) continue;  // numpy drops these
    int bin;
    if (v < 1.0f) {
      bin = 0;  // first bin spans [lo, 1)
    } else if (v >= 511.0f) {
      bin = kCumulativeBins - 1;  // last bin spans [511, hi], top-inclusive
    } else {
      bin = static_cast<int>(v);  // bin i spans [i, i+1) for 1 <= i <= 510
    }
    ++histogram[bin];
    ++counted;
  }
  const double total = static_cast<double>(counted > 0 ? counted : 1);
  double running = 0.0;
  for (int i = 0; i < kCumulativeBins; ++i) {
    running += static_cast<double>(histogram[i]) / total;
    cumulative_out[i] = static_cast<float>(running * 100.0);
  }
  *minimum_out = floor_min;
  *maximum_out = ceil_max;
}

}  // namespace

extern "C" {

// Decodes one PFM into a caller-allocated buffer of capacity floats.
// Returns 0 on success; fills height/width/channels. Returns -1 on parse
// error, -2 if the buffer is too small (height/width still filled so the
// caller can retry).
int pds_read_pfm(const char* path, float* out, int64_t capacity,
                 int* height, int* width, int* channels) {
  PfmImage image;
  if (!ReadPfm(path, &image)) return -1;
  *height = image.height;
  *width = image.width;
  *channels = image.channels;
  if (static_cast<int64_t>(image.data.size()) > capacity) return -2;
  std::memcpy(out, image.data.data(), image.data.size() * sizeof(float));
  return 0;
}

// Scans n PFM files with `threads` workers; writes per-file integer
// min/max (as floats) and the 512-bin cumulative distribution (percent).
// status_out[i]: 0 ok, -1 unreadable. Returns number of failures.
int pds_scan_disparity_statistics(const char** paths, int64_t n,
                                  int threads, float* minimum_out,
                                  float* maximum_out, float* cumulative_out,
                                  int* status_out) {
  if (threads < 1) threads = 1;
  std::atomic<int64_t> next(0);
  std::atomic<int> failures(0);
  auto worker = [&]() {
    for (;;) {
      const int64_t index = next.fetch_add(1);
      if (index >= n) return;
      PfmImage image;
      if (!ReadPfm(paths[index], &image)) {
        status_out[index] = -1;
        failures.fetch_add(1);
        continue;
      }
      ComputeStatistics(image, &minimum_out[index], &maximum_out[index],
                        &cumulative_out[index * kCumulativeBins]);
      status_out[index] = 0;
    }
  };
  std::vector<std::thread> pool;
  for (int i = 0; i < threads; ++i) pool.emplace_back(worker);
  for (auto& t : pool) t.join();
  return failures.load();
}

}  // extern "C"
