// Fused sub-pixel MAP disparity estimator.
//
// Replaces the TPU kernel practicaldeepstereo_nips2018_tpu/ops/
// subpixel_pallas.py::_estimator_kernel (driven by subpixel_map_pallas). Per
// pixel, over its D similarity scores, in float32:
//   best    = first index of the maximum;
//   window  = |i - best| <= half_taps;
//   w_i     = exp(s_i - s_best) inside the window, 0 outside;
//   output  = sum(w_i * step * i) / sum(w_i),
// computed as step * (best + sum(w_i * (i - best)) / sum(w_i)).
// The centre tap has weight 1, so the quotient is always finite. The TPU
// kernel padded pixels to 1024-row tiles and D to 128 lanes with -inf; here
// any pixel count and any D are taken as they are.
//
// Layout: pixel p = (o, i) with o < outer, i < inner; score d of p sits at
// s[o * outer_stride + i * inner_stride + d * disparity_stride]. That covers
// both a contiguous disparity-last [P, D] tensor and the port's hourglass
// output, a disparity-major [B, D, H, W] tensor seen as [B, H, W, D] without
// a copy.
//
// What bounds it on an H100: it reads every score once (2 bytes in bfloat16)
// and does a handful of operations per score, far below the card's
// FLOP:byte balance, so the bound is the memory rate: 106 MB at
// [1, 96, 576, 960] bfloat16, 32 us at 3.35 TB/s. Reaching it takes a few MB
// of loads in flight across the card, and no second read from memory.
//
// Design. Where neighbouring pixels are neighbouring scores (inner_stride 1,
// the main path's disparity-major view) and every row of scores is 16-byte
// aligned, the staged kernel runs. A block owns up to 256 neighbouring
// pixels and copies all their D rows into shared memory with 16-byte
// cp.async, every copy started before the first is awaited: 48 KB a block
// in bfloat16 at D = 96, four blocks an SM, about 25 MB in flight across
// the card, which keeps the memory busy without any thread waiting on a
// chain of its own loads. Each thread then owns two pixels: a branch-free
// running maximum over the staged rows (first occurrence), and the window
// sums over the 2*half_taps+1 staged rows around it, all lanes doing the
// same work (a window captured while streaming would branch differently in
// every lane at nearly every disparity).
// Any other layout, or a D too deep to stage 32 pixels in 96 KB, takes the
// scalar kernel: one thread per pixel, a strided walk over D and a second
// walk over the window.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float load_float(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_float(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
subpixel_map_kernel(const T* __restrict__ scores, float* __restrict__ out,
                    long long outer, long long inner, int disparities,
                    long long outer_stride, long long inner_stride,
                    long long disparity_stride, int half_taps,
                    float disparity_step) {
  const long long p = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (p >= outer * inner) return;
  const long long o = p / inner;
  const long long i = p - o * inner;
  const T* s = scores + o * outer_stride + i * inner_stride;

  float maximum = load_float(s);
  int best = 0;
  for (int d = 1; d < disparities; ++d) {
    const float v = load_float(s + d * disparity_stride);
    if (v > maximum) {  // strict: the first occurrence wins ties
      maximum = v;
      best = d;
    }
  }
  const int low = max(0, best - half_taps);
  const int high = min(disparities - 1, best + half_taps);
  // The mean is taken as best + mean offset: the offsets are small
  // integers, so the sums carry no rounding of the large disparity values.
  float weight_sum = 0.0f;
  float weighted_offset = 0.0f;
  for (int d = low; d <= high; ++d) {
    const float w = expf(load_float(s + d * disparity_stride) - maximum);
    weight_sum += w;
    weighted_offset += w * static_cast<float>(d - best);
  }
  out[p] = disparity_step * (static_cast<float>(best) +
                             weighted_offset / weight_sum);
}

__device__ __forceinline__ void copy_async_16(void* shared, const void* global) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(shared))),
               "l"(global));
}

__device__ __forceinline__ void load_pair(const float* p, float& a, float& b) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  a = v.x;
  b = v.y;
}
__device__ __forceinline__ void load_pair(const __nv_bfloat16* p, float& a,
                                          float& b) {
  const float2 v =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  a = v.x;
  b = v.y;
}

constexpr int kStagedPixels = 256;          // pixels a block stages at most
constexpr int kStagedBytes = 96 * 1024;     // shared memory a block stages

// One block per block_pixels neighbouring pixels of one outer index, two
// pixels a thread; inner_stride is 1.
template <typename T>
__global__ void __launch_bounds__(kStagedPixels / 2)
subpixel_map_staged_kernel(const T* __restrict__ scores,
                           float* __restrict__ out, long long inner,
                           int disparities, long long outer_stride,
                           long long disparity_stride, int half_taps,
                           float disparity_step, int block_pixels) {
  extern __shared__ __align__(16) unsigned char shared[];
  T* staged = reinterpret_cast<T*>(shared);  // [D][block_pixels]
  constexpr int PER_COPY = 16 / sizeof(T);
  const long long blocks_per_outer = (inner + block_pixels - 1) / block_pixels;
  const long long o = blockIdx.x / blocks_per_outer;
  const long long i0 = (blockIdx.x - o * blocks_per_outer) * block_pixels;
  const int pixels = static_cast<int>(
      min(static_cast<long long>(block_pixels), inner - i0));
  const T* s = scores + o * outer_stride + i0;

  const int copies_per_row = pixels / PER_COPY;
  for (int c = threadIdx.x; c < disparities * copies_per_row;
       c += blockDim.x) {
    const int d = c / copies_per_row;
    const int k = c - d * copies_per_row;
    copy_async_16(staged + d * block_pixels + k * PER_COPY,
                  s + d * disparity_stride + k * PER_COPY);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  const int p = 2 * threadIdx.x;
  if (p >= pixels) return;
  const T* column = staged + p;
  float maximum[2] = {-INFINITY, -INFINITY};
  int best[2] = {0, 0};
#pragma unroll 8
  for (int d = 0; d < disparities; ++d) {
    float v[2];
    load_pair(column + d * block_pixels, v[0], v[1]);
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const bool larger = v[q] > maximum[q];  // strict: first occurrence
      maximum[q] = larger ? v[q] : maximum[q];
      best[q] = larger ? d : best[q];
    }
  }
  float result[2];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int low = max(0, best[q] - half_taps);
    const int high = min(disparities - 1, best[q] + half_taps);
    float weight_sum = 0.0f;
    float weighted_offset = 0.0f;
    for (int d = low; d <= high; ++d) {
      const float w = expf(
          static_cast<float>(column[d * block_pixels + q]) - maximum[q]);
      weight_sum += w;
      weighted_offset += w * static_cast<float>(d - best[q]);
    }
    result[q] = disparity_step * (static_cast<float>(best[q]) +
                                  weighted_offset / weight_sum);
  }
  *reinterpret_cast<float2*>(out + o * inner + i0 + p) =
      make_float2(result[0], result[1]);
}

// The staged kernel where the layout allows it; -1 otherwise.
template <typename T>
int launch_staged_if_aligned(const void* scores, float* out, long long outer,
                             long long inner, int disparities,
                             long long outer_stride, long long inner_stride,
                             long long disparity_stride, int half_taps,
                             float step, cudaStream_t stream) {
  constexpr long long PER_COPY = 16 / sizeof(T);
  const bool aligned = reinterpret_cast<uintptr_t>(scores) % 16 == 0 &&
                       (inner_stride == 1 || inner == 1) &&
                       inner % PER_COPY == 0 &&
                       (outer == 1 || outer_stride % PER_COPY == 0) &&
                       (disparities == 1 || disparity_stride % PER_COPY == 0);
  int block_pixels = kStagedPixels;
  while (block_pixels > 32 && static_cast<long long>(disparities) *
                                      block_pixels * sizeof(T) >
                                  kStagedBytes) {
    block_pixels /= 2;
  }
  const long long shared_bytes =
      static_cast<long long>(disparities) * block_pixels * sizeof(T);
  if (!aligned || shared_bytes > kStagedBytes) return -1;

  auto kernel = subpixel_map_staged_kernel<T>;
  // Once per device: shared memory above 48 KB and the largest carveout.
  static unsigned long long configured_devices = 0;
  int device = 0;
  cudaError_t status = cudaGetDevice(&device);
  if (status != cudaSuccess) return static_cast<int>(status);
  if (device >= 64 || !(configured_devices >> device & 1ull)) {
    status = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kStagedBytes);
    if (status != cudaSuccess) return static_cast<int>(status);
    status = cudaFuncSetAttribute(
        kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
        cudaSharedmemCarveoutMaxShared);
    if (status != cudaSuccess) return static_cast<int>(status);
    if (device < 64) configured_devices |= 1ull << device;
  }
  const long long blocks = outer * ((inner + block_pixels - 1) / block_pixels);
  kernel<<<static_cast<unsigned int>(blocks), block_pixels / 2,
           static_cast<size_t>(shared_bytes), stream>>>(
      static_cast<const T*>(scores), out, inner, disparities, outer_stride,
      disparity_stride, half_taps, step, block_pixels);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
void launch(const void* scores, float* out, long long outer, long long inner,
            int disparities, long long outer_stride, long long inner_stride,
            long long disparity_stride, int half_taps, float disparity_step,
            cudaStream_t stream) {
  const long long pixels = outer * inner;
  const unsigned int blocks =
      static_cast<unsigned int>((pixels + kThreads - 1) / kThreads);
  subpixel_map_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(scores), out, outer, inner, disparities,
      outer_stride, inner_stride, disparity_stride, half_taps,
      disparity_step);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 scores; out is float32 [outer * inner].
// Returns cudaGetLastError() after the launch.
extern "C" int subpixel_map(const void* scores, void* out, long long outer,
                            long long inner, int disparities,
                            long long outer_stride, long long inner_stride,
                            long long disparity_stride, int half_taps,
                            int disparity_step, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  const float step = static_cast<float>(disparity_step);
  int status;
  if (dtype == 0) {
    status = launch_staged_if_aligned<float>(
        scores, o, outer, inner, disparities, outer_stride, inner_stride,
        disparity_stride, half_taps, step, s);
    if (status < 0) {
      launch<float>(scores, o, outer, inner, disparities, outer_stride,
                    inner_stride, disparity_stride, half_taps, step, s);
    }
  } else if (dtype == 1) {
    status = launch_staged_if_aligned<__nv_bfloat16>(
        scores, o, outer, inner, disparities, outer_stride, inner_stride,
        disparity_stride, half_taps, step, s);
    if (status < 0) {
      launch<__nv_bfloat16>(scores, o, outer, inner, disparities,
                            outer_stride, inner_stride, disparity_stride,
                            half_taps, step, s);
    }
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (status >= 0) return status;
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* subpixel_map_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
