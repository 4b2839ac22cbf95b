// K5: the tail of a conv block, LeakyReLU -> instance norm -> residual add.
//
// Replaces no TPU kernel: the JAX package left its instance norm
// (practicaldeepstereo_nips2018_tpu/models/blocks.py::instance_norm) and the
// activation and residual add around it to XLA, which fuses them. In PyTorch
// the same composition (models/blocks.py) takes ~14 launches per norm: a
// float32 copy, var_mean, the scale and offset in tiny launches, a
// broadcast multiply, a broadcast add and a cast back, besides the
// LeakyReLU before it and the residual add after it. This kernel computes
// the same function with the same rounding points in two launches, and its
// gradient in three.
//
// The tensor is [N, C, *spatial], contiguous, seen as N * C rows of length
// L; the affine map's channel of row r is r % C. Per element, in float32:
//   a = round(x > 0 ? x : x * slope)            (slope 1: no LeakyReLU)
//   y = round(a * scale + offset)               (a multiply, then an add)
//   y = round(y + residual)                     (if a residual is given)
// where round is to the tensor's dtype, scale = gamma * rsqrt(var + eps) and
// offset = (-mean * rsqrt(var + eps)) * gamma + beta over the row's biased
// moments (without the affine map: gamma 1, beta 0 and neither product).
// The products and sums round one by one (__fmul_rn, __fadd_rn), as the
// composition's separate launches do: no fused multiply-add.
//
// What bounds it on an H100: a handful of operations per element, far below
// the card's FLOP:byte balance, so the memory rate: it has to read x (and
// the residual) once and write y once; at the matching stage's
// [48, 64, 144, 240] bfloat16 volume that is 424 MB, 0.127 ms at 3.35 TB/s.
//
// Design. The moments of a row need the whole row before its first output,
// and a row can be 13M elements long (the hourglass's half-size level), so a
// row is cut into chunks of at most 32 KB (16384 bfloat16 elements) and the
// work into two launches over the same grid of (row, chunk) blocks:
//   pass 1 reads its chunk with 16-byte loads, 128 bytes a thread held in
//   registers (all loads issued before the first is used), and writes the
//   chunk's float32 (mean, M2), taken in two passes over those registers
//   (the mean first, then the squares of the deviations: no raw sum of
//   squares), to a [rows, chunks] scratch;
//   pass 2 issues the loads of its chunk (and of its residual) first, merges
//   its row's partials with Chan's formula while they are in flight, then
//   writes its outputs with 16-byte stores. Whether a residual is added is a
//   template argument, so the common block without one holds half the
//   registers and keeps more blocks, and loads, in flight on each SM.
// The second read is the price of the two launches: 1.5x the bound on a
// tensor larger than the 50 MB L2 (measured on an H100 SXM at 700 W: 1.8-2x
// at the matching volumes, ~2.5 TB/s over the three streams). Pass 2 walks the blocks in the reverse
// order of pass 1, so its first blocks find the chunks pass 1 read last
// still in L2; a tensor that fits in L2 is read from memory once. Rows whose
// length or base address does not allow 16-byte accesses take the same
// kernels with scalar loads.
//
// The backward (block_norm_backward) takes the output gradient dy, the
// forward's x and its pass-1 partials, and runs over the same grid, in
// float32 throughout, with x_hat = (a - mean) * rstd:
//   pass 1 reads x and dy once, re-merges the row's moments and writes the
//   chunk's sums of dy and of dy * x_hat;
//   pass 2, in reverse order, merges the row's sums in a fixed order and
//   writes dx = leaky'(x) * rstd * gamma * (dy - mean(dy) - x_hat *
//   mean(dy * x_hat)), rounded once to the dtype;
//   a third launch, one block a channel, sums dgamma = sum(dy * x_hat) and
//   dbeta = sum(dy) over the channel's rows' chunks in a fixed order.
// No atomics: a batch's gradients are the same bits from run to run. The
// residual's gradient is dy itself. Bound: read x and dy, write dx; the
// second read of x and dy is the price of the two passes, as above.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBytesPerThread = 128;  // of each tensor read, in registers
constexpr int kWarps = kThreads / 32;

// Elements a thread holds; a chunk has at most kThreads times as many.
template <typename T>
__host__ __device__ constexpr int per_thread() {
  return kBytesPerThread / static_cast<int>(sizeof(T));
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// The LeakyReLU in float32, rounded to T as PyTorch's leaky_relu rounds.
template <typename T>
__device__ __forceinline__ float leaky(float v, float slope) {
  return v > 0.0f ? v : to_float(from_float<T>(__fmul_rn(v, slope)));
}

// VEC elements of T at p, as one 16-byte load when VEC * sizeof(T) == 16.
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> load(const T* p) {
  Pack<T, VEC> pack;
  if constexpr (VEC * sizeof(T) == 16) {
    *reinterpret_cast<uint4*>(pack.v) = *reinterpret_cast<const uint4*>(p);
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) pack.v[j] = p[j];
  }
  return pack;
}

template <typename T, int VEC>
__device__ __forceinline__ void store(T* p, const Pack<T, VEC>& pack) {
  if constexpr (VEC * sizeof(T) == 16) {
    *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(pack.v);
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) p[j] = pack.v[j];
  }
}

// The sum over the block, returned to every thread. `shared` holds kWarps
// floats; the call ends with a barrier, so it can be reused at once.
__device__ __forceinline__ float block_sum(float value, float* shared) {
#pragma unroll
  for (int offset = 16; offset > 0; offset /= 2) {
    value += __shfl_xor_sync(0xffffffffu, value, offset);
  }
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) shared[warp] = value;
  __syncthreads();
  float total = 0.0f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) total += shared[w];
  __syncthreads();
  return total;
}

// Moments (count, mean, M2) of two disjoint sets merged (Chan et al.).
struct Moments {
  float count, mean, m2;
};

__device__ __forceinline__ Moments merge(Moments a, Moments b) {
  if (b.count == 0.0f) return a;
  if (a.count == 0.0f) return b;
  const float count = a.count + b.count;
  const float delta = b.mean - a.mean;
  const float share = b.count / count;
  return {count, a.mean + delta * share,
          a.m2 + b.m2 + delta * delta * a.count * share};
}

__device__ __forceinline__ Moments shuffle(Moments m, int offset) {
  return {__shfl_xor_sync(0xffffffffu, m.count, offset),
          __shfl_xor_sync(0xffffffffu, m.mean, offset),
          __shfl_xor_sync(0xffffffffu, m.m2, offset)};
}

struct Chunk {
  long long row;
  long long begin;  // element offset of the chunk in the tensor
  int count;        // elements in the chunk
};

__device__ __forceinline__ Chunk chunk_of(long long block, long long length,
                                          int chunk, int chunks) {
  const long long row = block / chunks;
  const long long first = (block - row * chunks) * chunk;
  const long long left = length - first;
  return {row, row * length + first,
          static_cast<int>(left < chunk ? left : chunk)};
}

// The moments of `row` from its chunks' partials (pass 1's), returned to
// every thread: each thread merges a strided share of the chunks, then the
// lanes and the warps merge in a fixed order, so every block of a row, in
// either direction, gets the same bits. Every chunk but the last holds
// `chunk` elements. `shared` holds kWarps Moments.
__device__ __forceinline__ Moments row_moments(
    const float2* __restrict__ partials, long long row, long long length,
    int chunk, int chunks, Moments* shared) {
  Moments m = {0.0f, 0.0f, 0.0f};
  for (int i = threadIdx.x; i < chunks; i += kThreads) {
    const float2 p = partials[row * chunks + i];
    const long long first = static_cast<long long>(i) * chunk;
    const long long n = length - first < chunk ? length - first : chunk;
    m = merge(m, {static_cast<float>(n), p.x, p.y});
  }
#pragma unroll
  for (int offset = 16; offset > 0; offset /= 2) {
    m = merge(m, shuffle(m, offset));
  }
  if (threadIdx.x % 32 == 0) shared[threadIdx.x / 32] = m;
  __syncthreads();
  m = shared[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) m = merge(m, shared[w]);
  return m;
}

// rsqrt(var + eps) of a row's moments, rounded as the composition rounds.
__device__ __forceinline__ float row_rstd(const Moments& m, long long length,
                                          float eps) {
  return __frsqrt_rn(__fadd_rn(m.m2 / static_cast<float>(length), eps));
}

// Blocks each SM keeps resident, which caps the registers a thread may use
// (measured on the matching volumes: 3 of each pass, 2 of pass 2 with a
// residual, ~20 % faster than the compiler's own choice, which keeps 1-2).
constexpr int kMomentsBlocks = 3;
constexpr int kNormalizeBlocks = 3;
constexpr int kResidualBlocks = 2;

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads, kMomentsBlocks)
moments_kernel(const T* __restrict__ x, float2* __restrict__ partials,
               long long length, int chunk, int chunks, float slope) {
  constexpr int kVectors = per_thread<T>() / VEC;
  __shared__ float shared[kWarps];
  const Chunk c = chunk_of(blockIdx.x, length, chunk, chunks);
  Pack<T, VEC> values[kVectors];
#pragma unroll
  for (int k = 0; k < kVectors; ++k) {
    const int e = (k * kThreads + threadIdx.x) * VEC;
    if (e < c.count) values[k] = load<T, VEC>(x + c.begin + e);
  }
  float sum = 0.0f;
#pragma unroll
  for (int k = 0; k < kVectors; ++k) {
    const int e = (k * kThreads + threadIdx.x) * VEC;
    if (e < c.count) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        sum += leaky<T>(to_float(values[k].v[j]), slope);
      }
    }
  }
  const float mean = block_sum(sum, shared) / static_cast<float>(c.count);
  float m2 = 0.0f;
#pragma unroll
  for (int k = 0; k < kVectors; ++k) {
    const int e = (k * kThreads + threadIdx.x) * VEC;
    if (e < c.count) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float d = leaky<T>(to_float(values[k].v[j]), slope) - mean;
        m2 += d * d;
      }
    }
  }
  m2 = block_sum(m2, shared);
  if (threadIdx.x == 0) partials[blockIdx.x] = make_float2(mean, m2);
}

template <typename T, int VEC, bool RESIDUAL>
__global__ void __launch_bounds__(kThreads,
                                     RESIDUAL ? kResidualBlocks
                                              : kNormalizeBlocks)
normalize_kernel(const T* __restrict__ x, const T* __restrict__ residual,
                 T* __restrict__ out, const float2* __restrict__ partials,
                 const float* __restrict__ weight,
                 const float* __restrict__ bias, long long length, int chunk,
                 int chunks, int channels, float slope, float eps) {
  constexpr int kVectors = per_thread<T>() / VEC;
  __shared__ Moments shared[kWarps];
  // Reverse order: the first blocks here are the chunks pass 1 read last.
  const long long block = gridDim.x - 1 - static_cast<long long>(blockIdx.x);
  const Chunk c = chunk_of(block, length, chunk, chunks);

  Pack<T, VEC> values[kVectors];
  Pack<T, VEC> added[RESIDUAL ? kVectors : 1];
#pragma unroll
  for (int k = 0; k < kVectors; ++k) {
    const int e = (k * kThreads + threadIdx.x) * VEC;
    if (e < c.count) {
      values[k] = load<T, VEC>(x + c.begin + e);
      if constexpr (RESIDUAL) {
        added[k] = load<T, VEC>(residual + c.begin + e);
      }
    }
  }

  const Moments m = row_moments(partials, c.row, length, chunk, chunks,
                                shared);

  // scale = rsqrt(var + eps), offset = -mean * scale, then the affine map:
  // offset * gamma + beta and scale * gamma, each rounded, as the
  // composition computes them.
  float scale = row_rstd(m, length, eps);
  float offset = __fmul_rn(-m.mean, scale);
  if (weight != nullptr) {
    const int channel = static_cast<int>(c.row % channels);
    const float gamma = weight[channel];
    offset = __fadd_rn(__fmul_rn(offset, gamma), bias[channel]);
    scale = __fmul_rn(scale, gamma);
  }

#pragma unroll
  for (int k = 0; k < kVectors; ++k) {
    const int e = (k * kThreads + threadIdx.x) * VEC;
    if (e < c.count) {
      Pack<T, VEC> result;
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float a = leaky<T>(to_float(values[k].v[j]), slope);
        float y = to_float(from_float<T>(__fadd_rn(__fmul_rn(a, scale),
                                                    offset)));
        if constexpr (RESIDUAL) y = __fadd_rn(y, to_float(added[k].v[j]));
        result.v[j] = from_float<T>(y);
      }
      store<T, VEC>(out + c.begin + e, result);
    }
  }
}

// The backward's passes hold two tensors' chunks (x and dy) in registers,
// as pass 2 with a residual does.
constexpr int kGradientBlocks = 2;

// Backward pass 1: the chunk's float32 sums of dy and of dy * x_hat, where
// x_hat = (a - mean) * rstd is recomputed from x and the row's moments.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads, kGradientBlocks)
gradient_sums_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                     const float2* __restrict__ partials,
                     float2* __restrict__ sums, long long length, int chunk,
                     int chunks, float slope, float eps) {
  constexpr int kVectors = per_thread<T>() / VEC;
  __shared__ Moments moments[kWarps];
  __shared__ float shared[kWarps];
  const Chunk c = chunk_of(blockIdx.x, length, chunk, chunks);
  Pack<T, VEC> values[kVectors];
  Pack<T, VEC> grads[kVectors];
#pragma unroll
  for (int k = 0; k < kVectors; ++k) {
    const int e = (k * kThreads + threadIdx.x) * VEC;
    if (e < c.count) {
      values[k] = load<T, VEC>(x + c.begin + e);
      grads[k] = load<T, VEC>(dy + c.begin + e);
    }
  }
  const Moments m = row_moments(partials, c.row, length, chunk, chunks,
                                moments);
  const float rstd = row_rstd(m, length, eps);
  float sum = 0.0f, product = 0.0f;
#pragma unroll
  for (int k = 0; k < kVectors; ++k) {
    const int e = (k * kThreads + threadIdx.x) * VEC;
    if (e < c.count) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float a = leaky<T>(to_float(values[k].v[j]), slope);
        const float d = to_float(grads[k].v[j]);
        sum += d;
        product += d * ((a - m.mean) * rstd);
      }
    }
  }
  sum = block_sum(sum, shared);
  product = block_sum(product, shared);
  if (threadIdx.x == 0) sums[blockIdx.x] = make_float2(sum, product);
}

// A row's sums from its chunks' pass-1 sums, returned to every thread, in
// a fixed order (a strided share a thread, then lanes, then warps).
__device__ __forceinline__ float2 row_sums(const float2* __restrict__ sums,
                                           long long row, int chunks,
                                           float2* shared) {
  float2 s = make_float2(0.0f, 0.0f);
  for (int i = threadIdx.x; i < chunks; i += kThreads) {
    const float2 p = sums[row * chunks + i];
    s.x += p.x;
    s.y += p.y;
  }
#pragma unroll
  for (int offset = 16; offset > 0; offset /= 2) {
    s.x += __shfl_xor_sync(0xffffffffu, s.x, offset);
    s.y += __shfl_xor_sync(0xffffffffu, s.y, offset);
  }
  if (threadIdx.x % 32 == 0) shared[threadIdx.x / 32] = s;
  __syncthreads();
  float2 total = shared[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) {
    total.x += shared[w].x;
    total.y += shared[w].y;
  }
  return total;
}

// Backward pass 2, in pass 1's reverse block order: per element
//   dx = leaky'(x) * rstd * gamma * (dy - mean(dy) - x_hat * mean(dy x_hat))
// rounded once to T, leaky' = 1 where x > 0, else the slope (PyTorch's
// leaky_relu_backward, decided on x itself, not on the rounded a).
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads, kGradientBlocks)
input_gradient_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                      T* __restrict__ dx, const float2* __restrict__ partials,
                      const float2* __restrict__ sums,
                      const float* __restrict__ weight, long long length,
                      int chunk, int chunks, int channels, float slope,
                      float eps) {
  constexpr int kVectors = per_thread<T>() / VEC;
  __shared__ Moments moments[kWarps];
  __shared__ float2 totals[kWarps];
  const long long block = gridDim.x - 1 - static_cast<long long>(blockIdx.x);
  const Chunk c = chunk_of(block, length, chunk, chunks);
  Pack<T, VEC> values[kVectors];
  Pack<T, VEC> grads[kVectors];
#pragma unroll
  for (int k = 0; k < kVectors; ++k) {
    const int e = (k * kThreads + threadIdx.x) * VEC;
    if (e < c.count) {
      values[k] = load<T, VEC>(x + c.begin + e);
      grads[k] = load<T, VEC>(dy + c.begin + e);
    }
  }
  const Moments m = row_moments(partials, c.row, length, chunk, chunks,
                                moments);
  const float2 s = row_sums(sums, c.row, chunks, totals);
  const float rstd = row_rstd(m, length, eps);
  const float gamma =
      weight != nullptr ? weight[static_cast<int>(c.row % channels)] : 1.0f;
  const float scale = rstd * gamma;
  const float mean_dy = s.x / static_cast<float>(length);
  const float mean_product = s.y / static_cast<float>(length);
#pragma unroll
  for (int k = 0; k < kVectors; ++k) {
    const int e = (k * kThreads + threadIdx.x) * VEC;
    if (e < c.count) {
      Pack<T, VEC> result;
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float v = to_float(values[k].v[j]);
        const float x_hat = (leaky<T>(v, slope) - m.mean) * rstd;
        float g = scale * (to_float(grads[k].v[j]) - mean_dy -
                           x_hat * mean_product);
        if (!(v > 0.0f)) g *= slope;
        result.v[j] = from_float<T>(g);
      }
      store<T, VEC>(dx + c.begin + e, result);
    }
  }
}

// dgamma = sum of dy * x_hat and dbeta = sum of dy over a channel's rows
// (row n * channels + c of each of the `samples`), from pass 1's sums in a
// fixed order: one block a channel, no atomics.
__global__ void __launch_bounds__(kThreads)
parameter_gradient_kernel(const float2* __restrict__ sums,
                          float* __restrict__ dweight,
                          float* __restrict__ dbias, long long samples,
                          int channels, int chunks) {
  __shared__ float shared[kWarps];
  const int channel = blockIdx.x;
  float sum = 0.0f, product = 0.0f;
  const long long count = samples * chunks;
  for (long long i = threadIdx.x; i < count; i += kThreads) {
    const long long sample = i / chunks;
    const float2 p =
        sums[(sample * channels + channel) * chunks + (i - sample * chunks)];
    sum += p.x;
    product += p.y;
  }
  sum = block_sum(sum, shared);
  product = block_sum(product, shared);
  if (threadIdx.x == 0) {
    dweight[channel] = product;
    dbias[channel] = sum;
  }
}

template <typename T, int VEC>
int launch(const void* x, const void* residual, void* out, void* partials,
           const void* weight, const void* bias, long long blocks,
           long long length, int chunk, int chunks, int channels, float slope,
           float eps, cudaStream_t stream) {
  if (chunk > kThreads * per_thread<T>()) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned int>(blocks));
  moments_kernel<T, VEC><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<float2*>(partials), length, chunk,
      chunks, slope);
  const cudaError_t first = cudaGetLastError();
  if (first != cudaSuccess) return static_cast<int>(first);
  auto normalize = residual != nullptr ? normalize_kernel<T, VEC, true>
                                       : normalize_kernel<T, VEC, false>;
  normalize<<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(residual),
      static_cast<T*>(out), static_cast<const float2*>(partials),
      static_cast<const float*>(weight), static_cast<const float*>(bias),
      length, chunk, chunks, channels, slope, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int VEC>
int launch_backward(const void* x, const void* dy, void* dx,
                    const void* partials, void* sums, const void* weight,
                    void* dweight, void* dbias, long long rows,
                    long long length, int channels, int chunk, int chunks,
                    float slope, float eps, cudaStream_t stream) {
  if (chunk > kThreads * per_thread<T>()) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned int>(rows * chunks));
  gradient_sums_kernel<T, VEC><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy),
      static_cast<const float2*>(partials), static_cast<float2*>(sums),
      length, chunk, chunks, slope, eps);
  cudaError_t status = cudaGetLastError();
  if (status != cudaSuccess) return static_cast<int>(status);
  input_gradient_kernel<T, VEC><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy),
      static_cast<T*>(dx), static_cast<const float2*>(partials),
      static_cast<const float2*>(sums), static_cast<const float*>(weight),
      length, chunk, chunks, channels, slope, eps);
  status = cudaGetLastError();
  if (status != cudaSuccess || weight == nullptr) {
    return static_cast<int>(status);
  }
  parameter_gradient_kernel<<<channels, kThreads, 0, stream>>>(
      static_cast<const float2*>(sums), static_cast<float*>(dweight),
      static_cast<float*>(dbias), rows / channels, channels, chunks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, residual (or null) and out: [rows, length] of dtype 0 = float32 or
// 1 = bfloat16; partials: float2 [rows * chunks] scratch; weight and bias
// (both or neither null): float32 [channels]. The host picks chunk (a
// multiple of the vector width, at most 32 KB of elements) and chunks =
// ceil(length / chunk); vector 1 asks for 16-byte accesses, which need length a multiple
// of 16 bytes of elements and every pointer 16-byte aligned. Returns
// cudaGetLastError() after the launches.
extern "C" int block_norm(const void* x, const void* residual, void* out,
                          void* partials, const void* weight,
                          const void* bias, long long rows, long long length,
                          int channels, int chunk, int chunks, int vector,
                          float slope, float eps, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long blocks = rows * chunks;
  if (blocks <= 0 || blocks > 0x7fffffffLL || chunk <= 0 || channels <= 0 ||
      (weight == nullptr) != (bias == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == 0) {
    return vector ? launch<float, 4>(x, residual, out, partials, weight, bias,
                                     blocks, length, chunk, chunks, channels,
                                     slope, eps, s)
                  : launch<float, 1>(x, residual, out, partials, weight, bias,
                                     blocks, length, chunk, chunks, channels,
                                     slope, eps, s);
  }
  if (dtype == 1) {
    return vector ? launch<__nv_bfloat16, 8>(x, residual, out, partials,
                                             weight, bias, blocks, length,
                                             chunk, chunks, channels, slope,
                                             eps, s)
                  : launch<__nv_bfloat16, 1>(x, residual, out, partials,
                                             weight, bias, blocks, length,
                                             chunk, chunks, channels, slope,
                                             eps, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The gradient of block_norm for the output gradient dy: x (block_norm's
// input), dy and dx: [rows, length] of dtype 0 or 1, as block_norm takes
// them; partials: block_norm's pass-1 partials of x, at the same chunk and
// chunks; sums: float2 [rows * chunks] scratch; weight (or null):
// float32 [channels]; dweight and dbias: float32 [channels], written when
// weight is given (else null). Three launches: pass 1, pass 2 (dx) and,
// with weight, one block a channel for dweight and dbias. Returns
// cudaGetLastError() after the launches.
extern "C" int block_norm_backward(const void* x, const void* dy, void* dx,
                                   const void* partials, void* sums,
                                   const void* weight, void* dweight,
                                   void* dbias, long long rows,
                                   long long length, int channels, int chunk,
                                   int chunks, int vector, float slope,
                                   float eps, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long blocks = rows * chunks;
  if (blocks <= 0 || blocks > 0x7fffffffLL || chunk <= 0 || channels <= 0 ||
      rows % channels != 0 || (weight == nullptr) != (dweight == nullptr) ||
      (weight == nullptr) != (dbias == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == 0) {
    return vector ? launch_backward<float, 4>(
                        x, dy, dx, partials, sums, weight, dweight, dbias,
                        rows, length, channels, chunk, chunks, slope, eps, s)
                  : launch_backward<float, 1>(
                        x, dy, dx, partials, sums, weight, dweight, dbias,
                        rows, length, channels, chunk, chunks, slope, eps, s);
  }
  if (dtype == 1) {
    return vector ? launch_backward<__nv_bfloat16, 8>(
                        x, dy, dx, partials, sums, weight, dweight, dbias,
                        rows, length, channels, chunk, chunks, slope, eps, s)
                  : launch_backward<__nv_bfloat16, 1>(
                        x, dy, dx, partials, sums, weight, dweight, dbias,
                        rows, length, channels, chunk, chunks, slope, eps, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* block_norm_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
