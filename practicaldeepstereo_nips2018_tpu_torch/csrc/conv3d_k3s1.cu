// Direct 3x3x3 convolution, stride 1, zero padding 1, fused bias.
//
// Replaces the TPU kernel practicaldeepstereo_nips2018_tpu/ops/folded_banded.py
// ::_slab_kernel (driven by conv3d_folded_pallas). That kernel computed the
// same conv on a depth-folded [B, H, W, D*C] volume as 9 banded K=256 MXU dots
// per 128-lane output group; the folding and the banded weights exist only for
// the TPU's 128-lane matrix unit and are not carried over. Here the volume is
// NCDHW-contiguous [B, C, D, H, W], the port's hourglass layout.
//
// Arithmetic: x in float32 or bfloat16, weights in the same type, bias in
// float32; every product is accumulated in float32 and the output is rounded
// once to the input type. Unlike the TPU kernel (whose slab guard reads 256
// lanes where cin = 128 needs 384, and so drops a depth tap at the deepest
// level), every tap is read at every channel count.
//
// What bounds it on an H100: at the 8-channel level (the largest volume) the
// work is ~2.9 GMAC on 53 MB, far below the card's FLOP:byte balance, so the
// bound is memory; at the 128-channel level it is operations. This kernel
// runs on the CUDA cores, one thread per output element, 27*cin fused
// multiply-adds each, so its real ceiling is the FMA rate and the L1 load
// rate (one load per FMA), not the tensor cores. The design keeps those loads
// cheap: the output channel's 27*cin weights are staged once per block in
// shared memory, and neighbouring threads own neighbouring W positions, so
// every input load of a warp is one coalesced line that the 27-fold reuse
// then finds in L1/L2. An implicit GEMM on wgmma with TMA-fed tiles is the
// later redesign.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float load_float(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_float(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

constexpr int kThreads = 256;

// grid: (ceil(H*W / kThreads), D, B * cout); one thread per output (h, w).
template <typename T>
__global__ void __launch_bounds__(kThreads)
conv3d_k3s1_kernel(const T* __restrict__ x, const T* __restrict__ weight,
                   const float* __restrict__ bias, T* __restrict__ y, int cin,
                   int cout, int depth, int height, int width) {
  extern __shared__ float weight_shared[];  // [cin, 27] of this output channel
  const int co = blockIdx.z % cout;
  const int b = blockIdx.z / cout;
  const int d = blockIdx.y;
  const int taps = cin * 27;
  const T* weight_co = weight + static_cast<size_t>(co) * taps;
  for (int i = threadIdx.x; i < taps; i += blockDim.x) {
    weight_shared[i] = load_float(weight_co + i);
  }
  __syncthreads();

  const int plane = height * width;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= plane) return;
  const int h = p / width;
  const int w = p - h * width;
  const size_t volume = static_cast<size_t>(depth) * plane;
  const T* x_b = x + static_cast<size_t>(b) * cin * volume;

  float acc = bias[co];
  for (int ci = 0; ci < cin; ++ci) {
    const T* x_c = x_b + ci * volume;
    const float* w_c = weight_shared + ci * 27;
#pragma unroll
    for (int kd = 0; kd < 3; ++kd) {
      const int dd = d + kd - 1;
      if (dd < 0 || dd >= depth) continue;
#pragma unroll
      for (int kh = 0; kh < 3; ++kh) {
        const int hh = h + kh - 1;
        if (hh < 0 || hh >= height) continue;
        const T* row = x_c + static_cast<size_t>(dd) * plane + hh * width;
#pragma unroll
        for (int kw = 0; kw < 3; ++kw) {
          const int ww = w + kw - 1;
          if (ww < 0 || ww >= width) continue;
          acc = fmaf(w_c[kd * 9 + kh * 3 + kw], load_float(row + ww), acc);
        }
      }
    }
  }
  store(y + (static_cast<size_t>(b) * cout + co) * volume +
            static_cast<size_t>(d) * plane + p,
        acc);
}

template <typename T>
void launch(const void* x, const void* weight, const float* bias, void* y,
            int batch, int cin, int cout, int depth, int height, int width,
            cudaStream_t stream) {
  const int plane = height * width;
  const dim3 grid((plane + kThreads - 1) / kThreads, depth, batch * cout);
  const size_t shared_bytes = static_cast<size_t>(cin) * 27 * sizeof(float);
  conv3d_k3s1_kernel<T><<<grid, kThreads, shared_bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(weight), bias,
      static_cast<T*>(y), cin, cout, depth, height, width);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, weight and y share it; bias is
// float32). Returns cudaGetLastError() after the launch.
extern "C" int conv3d_k3s1(const void* x, const void* weight, const void* bias,
                           void* y, int batch, int cin, int cout, int depth,
                           int height, int width, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  if (dtype == 0) {
    launch<float>(x, weight, b, y, batch, cin, cout, depth, height, width, s);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(x, weight, b, y, batch, cin, cout, depth, height,
                          width, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* conv3d_k3s1_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
