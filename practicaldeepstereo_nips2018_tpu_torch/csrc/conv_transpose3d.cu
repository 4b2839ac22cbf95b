// K3 and K4: the hourglass's transposed 3-D convs, forward (K3) and input
// gradient (K4), in gather form.
//
// Ports the JAX package's phased transposed convs,
// practicaldeepstereo_nips2018_tpu/ops/folded_banded.py
// ::conv_transpose3d_folded_phased (:176, 4x4x4, stride 2, pad 1) and
// ::anisotropic_fullsize_transpose_phased (:209, (3, 4, 4), stride (1, 2, 2),
// pad 1), which compute the function of ops/folded3d.py
// ::conv_transpose3d_folded and ::anisotropic_fullsize_transpose. No Pallas
// kernel lies behind them (XLA lowers them on the TPU); the port runs them by
// hand because the library's transposed conv is where its main path lost most
// of its time. Volumes are NCDHW-contiguous [B, C, D, H, W]; weights are
// PyTorch's ConvTranspose3d layout [cin, cout, kd, 4, 4]; the bias is float32.
//
// The function. Along each axis, output o takes input i through tap
// t = o + pad - stride * i, 0 <= t < kernel. For stride 2 and kernel 4 only
// the two taps t = (o + pad) mod 2 + {0, 2} reach o: the output's phase picks
// them, as the JAX phased form picks 2x2 of the 4x4 spatial taps per phase.
// The lhs-dilated form multiplies the zeros that the dilation inserts; here
// no zero is multiplied: an output visits 2 x 2 spatial taps times 2 (4x4x4)
// or 3 ((3, 4, 4), stride 1) depth taps, and each in-range input once per
// tap. Padding is per axis and any pad >= 0 that leaves an output is taken
// (the volume axis runs the W-sliced form with W padding 3).
//
// K4, the input gradient, is the strided conv of the output gradient by the
// same weights: grad_x[i] gathers grad_y[stride * i - pad + t] * w[t] over
// every tap t whose output lies inside.
//
// Arithmetic: float32 or bfloat16 values and weights, float32 bias; every
// product is accumulated in float32 with fmaf (exact float32 on the CUDA
// cores, no TF32) and the output is rounded once to the input type.
// Deterministic and batch-invariant, with no atomics: each output is summed
// in a fixed order (its channels, depth taps, then H and W taps), by one
// thread or by a fixed number of threads over fixed channel slices whose
// sums one of them adds in slice order; that number follows one image's
// shape, never the batch. So a batch gives each image's batch-1 bits and two
// launches give the same bits.
//
// What bounds it on an H100: bytes. The largest instance, the full-size
// upsampler at 540x960, D=191, reads [1, 4, 96, 288, 480] and writes
// [1, 1, 96, 576, 960] (212 MB in bfloat16, 63 us at 3.35 TB/s) for 2.5 G
// multiply-adds, 12 per byte, far below the card's ridge point; the deep
// levels move a few MB. The design:
//   * a thread owns a 2 x 2 block of outputs, one pair along H by one pair
//     along W, for CT channels. Both outputs of a pair read the same 3-input
//     window (the pair starts where o + pad is odd, so the phase of each
//     output, and with it its 2 taps, is fixed at compile time for any
//     padding), so 9 input reads feed 16 CT multiply-adds instead of 1 read
//     per multiply-add; neighbouring threads read neighbouring inputs and
//     the L1 serves the overlap of their windows, so device memory is read
//     about once;
//   * K4 likewise: a 2 x 2 block of input positions reads the 6 x 6 window
//     of the output gradient its 4 x 4 taps reach, 36 reads for 64 CT
//     multiply-adds;
//   * the block's weights are staged once in shared memory as float32 and
//     read as float4, 16 taps in 4 loads, the same address for every thread
//     of a warp;
//   * CT = 4 output channels per thread where the channel count allows it
//     (not the full-size upsampler, whose cout is 1); at the deep levels,
//     whose volumes give too few threads to fill 132 SMs, CT = 1 and the
//     channel loop is split over up to 8 slices of one block.
// wgmma, TMA and tiling the inputs in shared memory are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSpatialTaps = 16;  // 4 x 4, stride 2 along H and W
constexpr size_t kMaxSharedBytes = 227 * 1024;
constexpr int kMaxSplit = 8;
// One image's threads from which neither CT = 4 nor a split is needed.
constexpr long kGroupThreads = 32768;
constexpr long kTargetThreads = 262144;

__device__ __forceinline__ float load_float(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_float(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Along H or W, the outputs o and o + 1 of a pair with o + pad odd take
// the window of inputs m - 1, m, m + 1, m = (o + pad - 1) / 2: output
// o + a takes window element window_index(a, j) through tap tap_index(a, j),
// j = 0, 1 (t = o + a + pad - 2 i).
__device__ __forceinline__ constexpr int window_index(int a, int j) {
  return a == 0 ? 1 - j : 2 - j;
}
__device__ __forceinline__ constexpr int tap_index(int a, int j) {
  return a == 0 ? 1 + 2 * j : 2 * j;
}

// The 16 spatial taps of one (channel, depth tap) from shared memory.
__device__ __forceinline__ void load_taps(const float* taps, float (&k)[16]) {
  const float4* q = reinterpret_cast<const float4*>(taps);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 t = q[i];
    k[4 * i] = t.x;
    k[4 * i + 1] = t.y;
    k[4 * i + 2] = t.z;
    k[4 * i + 3] = t.w;
  }
}

// With split > 1 the block's threads form split slices of the reduced
// channels over the same positions: slices 1.. leave their CT x 4 partial
// sums in shared memory ([slice - 1][value][position]) and slice 0 adds
// them in slice order, so the sum's order is fixed.
template <int CT>
__device__ __forceinline__ void add_slices(float (&acc)[CT][4], float* partial,
                                           int split, int slice, int lane,
                                           int positions) {
  if (slice > 0) {
#pragma unroll
    for (int c = 0; c < CT; ++c) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        partial[((slice - 1) * CT * 4 + c * 4 + i) * positions + lane] =
            acc[c][i];
      }
    }
  }
  __syncthreads();
  if (slice > 0) return;
  for (int s = 1; s < split; ++s) {
#pragma unroll
    for (int c = 0; c < CT; ++c) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[c][i] += partial[((s - 1) * CT * 4 + c * 4 + i) * positions + lane];
      }
    }
  }
}

// K3. A thread owns a 2 x 2 block of outputs (a pair along H times a pair
// along W, each pair starting where o + pad is odd) of one output depth for
// CT output channels, over its slice of the input channels: per input
// channel and depth tap it reads a 3 x 3 window of inputs and 16 weights
// and makes 16 CT fused multiply-adds. grid: (ceil(pairs / (kThreads /
// split)), Dout, B * cout / CT).
template <typename T, int KD, int SD, int CT>
__global__ void __launch_bounds__(kThreads)
transpose_forward(const T* __restrict__ x, const T* __restrict__ weight,
                  const float* __restrict__ bias, T* __restrict__ y, int cin,
                  int cout, int depth, int height, int width, int depth_out,
                  int height_out, int width_out, int pad_d, int pad_h,
                  int pad_w, int split) {
  constexpr int JD = KD / SD;  // depth taps that reach one output
  constexpr int kChannel = CT * JD * kSpatialTaps;
  extern __shared__ float4 shared[];
  // [cin][CT][JD][16]: the taps of this block's depth phase; then the
  // partial sums of the slices.
  float* weight_shared = reinterpret_cast<float*>(shared);
  float* partial = weight_shared + cin * kChannel;
  const int groups = cout / CT;
  const int co0 = (blockIdx.z % groups) * CT;
  const int b = blockIdx.z / groups;
  const int od = blockIdx.y;
  const int ed = od + pad_d;
  const int td0 = ed % SD;
  for (int i = threadIdx.x; i < cin * kChannel; i += blockDim.x) {
    const int tap = i % kSpatialTaps;
    const int jd = i / kSpatialTaps % JD;
    const int c = i / (kSpatialTaps * JD) % CT;
    const int ci = i / kChannel;
    weight_shared[i] = load_float(
        weight + ((static_cast<size_t>(ci) * cout + co0 + c) * KD + td0 +
                  SD * jd) * kSpatialTaps + tap);
  }
  __syncthreads();

  const int positions = kThreads / split;
  const int slice = threadIdx.x / positions;
  const int lane = threadIdx.x - slice * positions;
  const int shift_h = 1 - (pad_h & 1), shift_w = 1 - (pad_w & 1);
  const int pairs_w = width_out / 2 + shift_w;
  const int pairs = (height_out / 2 + shift_h) * pairs_w;
  const int p = blockIdx.x * positions + lane;
  const bool active = p < pairs;
  const int qh = p / pairs_w;
  const int qw = p - qh * pairs_w;
  const int oh = 2 * qh - shift_h, ow = 2 * qw - shift_w;
  const int mh = (oh + pad_h - 1) / 2, mw = (ow + pad_w - 1) / 2;
  const int in_plane = height * width;
  const int in_volume = depth * in_plane;

  int row[3], col[3];
  bool row_in[3], col_in[3];
#pragma unroll
  for (int u = 0; u < 3; ++u) {
    const int ih = mh - 1 + u, iw = mw - 1 + u;
    row_in[u] = ih >= 0 && ih < height;
    col_in[u] = iw >= 0 && iw < width;
    row[u] = ih * width;
    col[u] = iw;
  }
  // Depth tap td0 + SD * j reaches the output from input (ed - td0) / SD - j.
  int d_offset[JD];
  bool d_in[JD];
#pragma unroll
  for (int j = 0; j < JD; ++j) {
    const int id = (ed - td0) / SD - j;
    d_in[j] = id >= 0 && id < depth;
    d_offset[j] = id * in_plane;
  }

  float acc[CT][4];
#pragma unroll
  for (int c = 0; c < CT; ++c) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[c][i] = 0.0f;
  }
  const int per_slice = cin / split;
  if (active) {
    const T* x_b = x + static_cast<size_t>(b) * cin * in_volume;
    for (int ci = slice * per_slice; ci < (slice + 1) * per_slice; ++ci) {
      const T* x_c = x_b + static_cast<size_t>(ci) * in_volume;
      const float* w_c = weight_shared + ci * kChannel;
#pragma unroll
      for (int jd = 0; jd < JD; ++jd) {
        if (!d_in[jd]) continue;
        const T* x_d = x_c + d_offset[jd];
        float v[3][3];
#pragma unroll
        for (int u = 0; u < 3; ++u) {
#pragma unroll
          for (int w = 0; w < 3; ++w) {
            v[u][w] = row_in[u] && col_in[w]
                          ? load_float(x_d + row[u] + col[w]) : 0.0f;
          }
        }
#pragma unroll
        for (int c = 0; c < CT; ++c) {
          float k[16];
          load_taps(w_c + (c * JD + jd) * kSpatialTaps, k);
#pragma unroll
          for (int a = 0; a < 2; ++a) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
#pragma unroll
              for (int jh = 0; jh < 2; ++jh) {
#pragma unroll
                for (int jw = 0; jw < 2; ++jw) {
                  acc[c][a * 2 + e] = fmaf(
                      v[window_index(a, jh)][window_index(e, jw)],
                      k[tap_index(a, jh) * 4 + tap_index(e, jw)],
                      acc[c][a * 2 + e]);
                }
              }
            }
          }
        }
      }
    }
  }
  if (split > 1) {
    add_slices<CT>(acc, partial, split, slice, lane, positions);
    if (slice > 0) return;
  }
  if (!active) return;
  const int plane = height_out * width_out;
#pragma unroll
  for (int c = 0; c < CT; ++c) {
    T* y_c = y + ((static_cast<size_t>(b) * cout + co0 + c) * depth_out + od) *
                     plane;
    const float bias_c = bias[co0 + c];
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const int h = oh + a;
      if (h < 0 || h >= height_out) continue;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int w = ow + e;
        if (w < 0 || w >= width_out) continue;
        store(y_c + h * width_out + w, acc[c][a * 2 + e] + bias_c);
      }
    }
  }
}

// K4. A thread owns a 2 x 2 block of input positions of one input depth for
// CT input channels, over its slice of the output channels: per output
// channel and depth tap it reads the 6 x 6 window of the output gradient
// that the block's 4 x 4 taps reach (output 2 i - pad + t) and makes 64 CT
// fused multiply-adds. grid: (ceil(pairs / (kThreads / split)), D,
// B * cin / CT).
template <typename T, int KD, int SD, int CT>
__global__ void __launch_bounds__(kThreads)
transpose_input_grad(const T* __restrict__ grad_y,
                     const T* __restrict__ weight, T* __restrict__ grad_x,
                     int cin, int cout, int depth, int height, int width,
                     int depth_out, int height_out, int width_out, int pad_d,
                     int pad_h, int pad_w, int split) {
  constexpr int kTaps = KD * kSpatialTaps;
  extern __shared__ float4 shared[];
  // [CT][cout][KD * 16]: this block's input channels, a contiguous slice of
  // [cin, cout, KD, 4, 4]; then the partial sums of the slices.
  float* weight_shared = reinterpret_cast<float*>(shared);
  float* partial = weight_shared + CT * cout * kTaps;
  const int groups = cin / CT;
  const int ci0 = (blockIdx.z % groups) * CT;
  const int b = blockIdx.z / groups;
  const int id = blockIdx.y;
  const T* weight_group = weight + static_cast<size_t>(ci0) * cout * kTaps;
  for (int i = threadIdx.x; i < CT * cout * kTaps; i += blockDim.x) {
    weight_shared[i] = load_float(weight_group + i);
  }
  __syncthreads();

  const int positions = kThreads / split;
  const int slice = threadIdx.x / positions;
  const int lane = threadIdx.x - slice * positions;
  const int pairs_w = (width + 1) / 2;
  const int pairs = (height + 1) / 2 * pairs_w;
  const int p = blockIdx.x * positions + lane;
  const bool active = p < pairs;
  const int qh = p / pairs_w;
  const int qw = p - qh * pairs_w;
  const int ih0 = 2 * qh, iw0 = 2 * qw;
  const int plane = height_out * width_out;
  const int volume = depth_out * plane;

  // Input ih0 + u takes output row 2 ih0 - pad + r through tap r - 2 u.
  int row[6], col[6];
  bool row_in[6], col_in[6];
#pragma unroll
  for (int r = 0; r < 6; ++r) {
    const int oh = 2 * ih0 - pad_h + r, ow = 2 * iw0 - pad_w + r;
    row_in[r] = oh >= 0 && oh < height_out;
    col_in[r] = ow >= 0 && ow < width_out;
    row[r] = oh * width_out;
    col[r] = ow;
  }

  float acc[CT][4];
#pragma unroll
  for (int c = 0; c < CT; ++c) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[c][i] = 0.0f;
  }
  const int per_slice = cout / split;
  if (active) {
    const T* g_b = grad_y + static_cast<size_t>(b) * cout * volume;
    for (int co = slice * per_slice; co < (slice + 1) * per_slice; ++co) {
      const T* g_c = g_b + static_cast<size_t>(co) * volume;
      const float* w_c = weight_shared + co * kTaps;
#pragma unroll
      for (int td = 0; td < KD; ++td) {
        const int od = SD * id - pad_d + td;
        if (od < 0 || od >= depth_out) continue;
        const T* g_d = g_c + od * plane;
        float v[6][6];
#pragma unroll
        for (int r = 0; r < 6; ++r) {
#pragma unroll
          for (int w = 0; w < 6; ++w) {
            v[r][w] = row_in[r] && col_in[w]
                          ? load_float(g_d + row[r] + col[w]) : 0.0f;
          }
        }
#pragma unroll
        for (int c = 0; c < CT; ++c) {
          float k[16];
          load_taps(w_c + c * cout * kTaps + td * kSpatialTaps, k);
#pragma unroll
          for (int u = 0; u < 2; ++u) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
#pragma unroll
              for (int th = 0; th < 4; ++th) {
#pragma unroll
                for (int tw = 0; tw < 4; ++tw) {
                  acc[c][u * 2 + e] = fmaf(v[th + 2 * u][tw + 2 * e],
                                           k[th * 4 + tw], acc[c][u * 2 + e]);
                }
              }
            }
          }
        }
      }
    }
  }
  if (split > 1) {
    add_slices<CT>(acc, partial, split, slice, lane, positions);
    if (slice > 0) return;
  }
  if (!active) return;
  const int in_plane = height * width;
#pragma unroll
  for (int c = 0; c < CT; ++c) {
    T* g_x = grad_x +
             ((static_cast<size_t>(b) * cin + ci0 + c) * depth + id) * in_plane;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      if (ih0 + u >= height) continue;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (iw0 + e >= width) continue;
        store(g_x + (ih0 + u) * width + iw0 + e, acc[c][u * 2 + e]);
      }
    }
  }
}

// Lets the kernel take up to kMaxSharedBytes of dynamic shared memory, once
// per device (the deepest level's weight slice is 64 KB).
template <typename Kernel>
int allow_shared(Kernel kernel, unsigned long long* configured_devices) {
  int device = 0;
  cudaError_t status = cudaGetDevice(&device);
  if (status != cudaSuccess) return static_cast<int>(status);
  if (device >= 64 || !(*configured_devices >> device & 1ull)) {
    status = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kMaxSharedBytes));
    if (status != cudaSuccess) return static_cast<int>(status);
    if (device < 64) *configured_devices |= 1ull << device;
  }
  return 0;
}

struct Shape {
  int batch, cin, cout, depth, height, width;
  int depth_out, height_out, width_out, pad_d, pad_h, pad_w;
};

// CT = 4 where the grouped channels allow it and one image still gives
// kGroupThreads threads; then the reduced channels split over up to
// kMaxSplit slices of >= 4 channels while one image gives fewer than
// kTargetThreads. Both follow one image's shape, never the batch, so each
// image of a batch is summed as it is alone.
struct Plan {
  int ct, split;
};

Plan plan(long positions, int grouped, int reduced) {
  Plan p{1, 1};
  if (grouped % 4 == 0 && positions * (grouped / 4) >= kGroupThreads) p.ct = 4;
  const long threads = positions * (grouped / p.ct);
  while (p.split < kMaxSplit && threads * p.split < kTargetThreads &&
         reduced % (2 * p.split) == 0 && reduced / (2 * p.split) >= 4) {
    p.split *= 2;
  }
  return p;
}

template <typename T, int KD, int SD, int CT>
int launch_forward(const void* x, const void* weight, const float* bias,
                   void* y, const Shape& s, int split, cudaStream_t stream) {
  static unsigned long long configured_devices = 0;
  auto kernel = transpose_forward<T, KD, SD, CT>;
  const int positions = kThreads / split;
  const size_t shared_bytes =
      (static_cast<size_t>(s.cin) * CT * (KD / SD) * kSpatialTaps +
       static_cast<size_t>(split - 1) * CT * 4 * positions) * sizeof(float);
  if (shared_bytes > kMaxSharedBytes) return cudaErrorInvalidValue;
  const int status = allow_shared(kernel, &configured_devices);
  if (status != 0) return status;
  const int pairs = (s.height_out / 2 + 1 - (s.pad_h & 1)) *
                    (s.width_out / 2 + 1 - (s.pad_w & 1));
  const dim3 grid((pairs + positions - 1) / positions, s.depth_out,
                  s.batch * (s.cout / CT));
  kernel<<<grid, kThreads, shared_bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(weight), bias,
      static_cast<T*>(y), s.cin, s.cout, s.depth, s.height, s.width,
      s.depth_out, s.height_out, s.width_out, s.pad_d, s.pad_h, s.pad_w,
      split);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int KD, int SD, int CT>
int launch_input_grad(const void* grad_y, const void* weight, void* grad_x,
                      const Shape& s, int split, cudaStream_t stream) {
  static unsigned long long configured_devices = 0;
  auto kernel = transpose_input_grad<T, KD, SD, CT>;
  const int positions = kThreads / split;
  const size_t shared_bytes =
      (static_cast<size_t>(CT) * s.cout * KD * kSpatialTaps +
       static_cast<size_t>(split - 1) * CT * 4 * positions) * sizeof(float);
  if (shared_bytes > kMaxSharedBytes) return cudaErrorInvalidValue;
  const int status = allow_shared(kernel, &configured_devices);
  if (status != 0) return status;
  const int pairs = (s.height + 1) / 2 * ((s.width + 1) / 2);
  const dim3 grid((pairs + positions - 1) / positions, s.depth,
                  s.batch * (s.cin / CT));
  kernel<<<grid, kThreads, shared_bytes, stream>>>(
      static_cast<const T*>(grad_y), static_cast<const T*>(weight),
      static_cast<T*>(grad_x), s.cin, s.cout, s.depth, s.height, s.width,
      s.depth_out, s.height_out, s.width_out, s.pad_d, s.pad_h, s.pad_w,
      split);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int KD, int SD>
int dispatch(bool forward, const void* a, const void* weight,
             const float* bias, void* out, const Shape& s,
             cudaStream_t stream) {
  if (forward) {
    const long pairs =
        static_cast<long>(s.height_out / 2 + 1 - (s.pad_h & 1)) *
        (s.width_out / 2 + 1 - (s.pad_w & 1));
    const Plan p = plan(pairs * s.depth_out, s.cout, s.cin);
    return p.ct == 4
               ? launch_forward<T, KD, SD, 4>(a, weight, bias, out, s,
                                              p.split, stream)
               : launch_forward<T, KD, SD, 1>(a, weight, bias, out, s,
                                              p.split, stream);
  }
  const long pairs =
      static_cast<long>((s.height + 1) / 2) * ((s.width + 1) / 2);
  const Plan p = plan(pairs * s.depth, s.cin, s.cout);
  return p.ct == 4
             ? launch_input_grad<T, KD, SD, 4>(a, weight, out, s, p.split,
                                               stream)
             : launch_input_grad<T, KD, SD, 1>(a, weight, out, s, p.split,
                                               stream);
}

template <typename T>
int dispatch_geometry(bool forward, int kernel_depth, int stride_depth,
                      const void* a, const void* weight, const float* bias,
                      void* out, const Shape& s, cudaStream_t stream) {
  if (kernel_depth == 4 && stride_depth == 2) {
    return dispatch<T, 4, 2>(forward, a, weight, bias, out, s, stream);
  }
  if (kernel_depth == 3 && stride_depth == 1) {
    return dispatch<T, 3, 1>(forward, a, weight, bias, out, s, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

int run(bool forward, const void* a, const void* weight, const float* bias,
        void* out, int batch, int cin, int cout, int depth, int height,
        int width, int kernel_depth, int stride_depth, int pad_d, int pad_h,
        int pad_w, int dtype, void* stream) {
  Shape s{batch, cin, cout, depth, height, width,
          (depth - 1) * stride_depth - 2 * pad_d + kernel_depth,
          (height - 1) * 2 - 2 * pad_h + 4, (width - 1) * 2 - 2 * pad_w + 4,
          pad_d, pad_h, pad_w};
  if (pad_d < 0 || pad_h < 0 || pad_w < 0 || s.depth_out <= 0 ||
      s.height_out <= 0 || s.width_out <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return dispatch_geometry<float>(forward, kernel_depth, stride_depth, a,
                                    weight, bias, out, s, st);
  }
  if (dtype == 1) {
    return dispatch_geometry<__nv_bfloat16>(forward, kernel_depth,
                                            stride_depth, a, weight, bias,
                                            out, s, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// K3: y [B, cout, Dout, Hout, Wout] = the transposed conv of x [B, cin, D, H,
// W] by weight [cin, cout, kernel_depth, 4, 4] (stride (stride_depth, 2, 2),
// padding (pad_d, pad_h, pad_w)) plus bias [cout].
extern "C" int conv_transpose3d(const void* x, const void* weight,
                                const void* bias, void* y, int batch, int cin,
                                int cout, int depth, int height, int width,
                                int kernel_depth, int stride_depth, int pad_d,
                                int pad_h, int pad_w, int dtype,
                                void* stream) {
  return run(true, x, weight, static_cast<const float*>(bias), y, batch, cin,
             cout, depth, height, width, kernel_depth, stride_depth, pad_d,
             pad_h, pad_w, dtype, stream);
}

// K4: grad_x [B, cin, D, H, W] of that conv for grad_y [B, cout, Dout, Hout,
// Wout]; the shape arguments are the forward's.
extern "C" int conv_transpose3d_input_grad(
    const void* grad_y, const void* weight, void* grad_x, int batch, int cin,
    int cout, int depth, int height, int width, int kernel_depth,
    int stride_depth, int pad_d, int pad_h, int pad_w, int dtype,
    void* stream) {
  return run(false, grad_y, weight, nullptr, grad_x, batch, cin, cout, depth,
             height, width, kernel_depth, stride_depth, pad_d, pad_h, pad_w,
             dtype, stream);
}

extern "C" const char* conv_transpose3d_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
