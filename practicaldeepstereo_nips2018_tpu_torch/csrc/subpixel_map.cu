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
// FLOP:byte balance, so the bound is the memory rate. One thread owns one
// pixel and walks its D scores: in the disparity-major layout neighbouring
// threads read neighbouring addresses at every step, so each warp load is
// one coalesced line and the volume streams through once; the window pass
// re-reads at most 2*half_taps+1 scores, which are still in L1.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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
  if (dtype == 0) {
    launch<float>(scores, o, outer, inner, disparities, outer_stride,
                  inner_stride, disparity_stride, half_taps, step, s);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(scores, o, outer, inner, disparities, outer_stride,
                          inner_stride, disparity_stride, half_taps, step, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* subpixel_map_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
