// K6: PSMNet's BatchNorm, forward (on the batch's statistics or the running
// ones) and backward.
//
// Replaces no TPU kernel: the JAX package has no PSMNet. In PyTorch a
// bfloat16 BatchNorm with float32 parameters takes the native kernels for
// contiguous NC(D)HW input, which launch one block per channel: each block
// reduces all of a channel's N x D x H x W elements (the backward's block
// then also writes the channel's dx). PSMNet's norms have 32 to 128
// channels, so each call fills at most 32 to 128 of the H100's 132 SMs, and
// at the aggregation's [12, 32, 48, 64, 128] volume each of 32 blocks walks
// 4.7M elements: ~12x the byte bound over a train step.
//
// The tensor is [N, C, *spatial], contiguous, seen as N * C rows of length
// S (the spatial size); channel c's data is the N rows n * C + c. Per
// element, in float32, with the channel's mean and rstd = 1 / sqrt(var +
// eps) (biased variance) and the affine map gamma, beta (1 and 0 without
// one):
//   y = round((x - mean) * (gamma * rstd) + beta)
// a subtraction and one fused multiply-add, rounded once to the tensor's
// dtype, as F.batch_norm normalises in float32 and casts once.
//
// What bounds it on an H100: a few operations per element, so the memory
// rate. Read x and write y once: 4 bytes an element in bfloat16.
//
// Design. The moments of a channel need all of its elements before its
// first output, so the work is split over (row, chunk) blocks that fill the
// whole card, whatever the channel count: a row is cut into chunks of at
// most 32 KB, and
//   pass 1 reads its chunk with 16-byte loads, 128 bytes a thread held in
//   registers, and writes the chunk's float32 (mean, M2), taken in two
//   passes over those registers (no raw sum of squares: a conv's output
//   can have a mean large beside its deviation), to a [rows, chunks]
//   scratch;
//   pass 2, over the same grid in reverse order, issues its chunk's loads,
//   merges its channel's N x chunks partials with Chan's formula in a fixed
//   order while they are in flight (every block of a channel gets the same
//   bits), then writes its outputs with 16-byte stores. The channel's first
//   block (n = 0, chunk 0) also writes the channel's (mean, rstd) for the
//   backward and updates the running statistics as nn.BatchNorm does:
//   running = momentum * batch + (1 - momentum) * running, the variance
//   unbiased (times M / (M - 1), M = N * S); the first block of channel 0
//   adds one to num_batches_tracked.
// In eval mode pass 2 runs alone on the running statistics. The second read
// is the price of the two passes on a tensor larger than the 50 MB L2; the
// reverse order of pass 2 finds the chunks pass 1 read last still in L2.
//
// The backward (batch_norm_backward) takes dy, x and the forward's (mean,
// rstd) per channel, with x_hat = (x - mean) * rstd, in float32:
//   pass 1 reads x and dy once and writes the chunk's sums of dy and of
//   dy * x_hat;
//   pass 2, in reverse order, merges its channel's sums in a fixed order
//   and writes
//     dx = gamma * rstd * (dy - sum(dy) / M - x_hat * sum(dy * x_hat) / M)
//   (eval mode: dx = gamma * rstd * dy), rounded once to the dtype; the
//   channel's first block writes dgamma = sum(dy * x_hat) and dbeta =
//   sum(dy).
// No atomics: two runs give the same bits. Bound: read x and dy, write dx.

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

// VEC elements of T at p, as one 16-byte access when VEC * sizeof(T) == 16.
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
  if (threadIdx.x % 32 == 0) shared[threadIdx.x / 32] = value;
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
  int channel;
  long long begin;  // element offset of the chunk in the tensor
  int count;        // elements in the chunk
  bool first;       // the channel's first chunk: sample 0, chunk 0
};

__device__ __forceinline__ Chunk chunk_of(long long block, long long length,
                                          int chunk, int chunks,
                                          int channels) {
  const long long row = block / chunks;
  const int index = static_cast<int>(block - row * chunks);
  const long long first = static_cast<long long>(index) * chunk;
  const long long left = length - first;
  return {static_cast<int>(row % channels), row * length + first,
          static_cast<int>(left < chunk ? left : chunk),
          row < channels && index == 0};
}

// The moments of `channel` from pass 1's partials of its `samples` rows,
// returned to every thread: each thread merges a strided share of the
// samples x chunks partials, then the lanes and the warps merge in a fixed
// order, so every block of the channel, in either direction, gets the same
// bits. Every chunk of a row but the last holds `chunk` elements. `shared`
// holds kWarps Moments.
__device__ __forceinline__ Moments channel_moments(
    const float2* __restrict__ partials, int channel, long long samples,
    int channels, long long length, int chunk, int chunks, Moments* shared) {
  Moments m = {0.0f, 0.0f, 0.0f};
  const long long parts = samples * chunks;
  for (long long i = threadIdx.x; i < parts; i += kThreads) {
    const long long sample = i / chunks;
    const int index = static_cast<int>(i - sample * chunks);
    const float2 p = partials[(sample * channels + channel) * chunks + index];
    const long long first = static_cast<long long>(index) * chunk;
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

// The sums (of dy, of dy * x_hat) of `channel` from backward pass 1's sums
// of its rows' chunks, returned to every thread in a fixed order (a strided
// share a thread, then lanes, then warps).
__device__ __forceinline__ float2 channel_sums(
    const float2* __restrict__ sums, int channel, long long samples,
    int channels, int chunks, float2* shared) {
  float2 s = make_float2(0.0f, 0.0f);
  const long long parts = samples * chunks;
  for (long long i = threadIdx.x; i < parts; i += kThreads) {
    const long long sample = i / chunks;
    const float2 p = sums[(sample * channels + channel) * chunks +
                          (i - sample * chunks)];
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

// 1 / sqrt(var + eps), each step rounded, as PyTorch's invstd.
__device__ __forceinline__ float inverse_std(float var, float eps) {
  return __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, eps)));
}

// Blocks each SM keeps resident, which caps the registers a thread may use:
// three where a block holds one tensor's chunk, two where it holds two.
constexpr int kOneTensorBlocks = 3;
constexpr int kTwoTensorBlocks = 2;

// Forward pass 1 (batch statistics): the chunk's float32 (mean, M2).
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads, kOneTensorBlocks)
bn_moments_kernel(const T* __restrict__ x, float2* __restrict__ partials,
                  long long length, int chunk, int chunks, int channels) {
  constexpr int kVectors = per_thread<T>() / VEC;
  __shared__ float shared[kWarps];
  const Chunk c = chunk_of(blockIdx.x, length, chunk, chunks, channels);
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
      for (int j = 0; j < VEC; ++j) sum += to_float(values[k].v[j]);
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
        const float d = to_float(values[k].v[j]) - mean;
        m2 += d * d;
      }
    }
  }
  m2 = block_sum(m2, shared);
  if (threadIdx.x == 0) partials[blockIdx.x] = make_float2(mean, m2);
}

// Forward pass 2, in pass 1's reverse block order: the channel's statistics
// (merged from pass 1's partials, or the running ones in eval mode), the
// first block's bookkeeping, then y.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads, kOneTensorBlocks)
bn_normalize_kernel(const T* __restrict__ x, T* __restrict__ out,
                    const float2* __restrict__ partials,
                    const float* __restrict__ weight,
                    const float* __restrict__ bias, float* running_mean,
                    float* running_var, long long* batches,
                    float2* __restrict__ saved, long long samples,
                    long long length, int chunk, int chunks, int channels,
                    int training, float momentum, float eps) {
  constexpr int kVectors = per_thread<T>() / VEC;
  __shared__ Moments shared[kWarps];
  const long long block = gridDim.x - 1 - static_cast<long long>(blockIdx.x);
  const Chunk c = chunk_of(block, length, chunk, chunks, channels);

  Pack<T, VEC> values[kVectors];
#pragma unroll
  for (int k = 0; k < kVectors; ++k) {
    const int e = (k * kThreads + threadIdx.x) * VEC;
    if (e < c.count) values[k] = load<T, VEC>(x + c.begin + e);
  }

  float mean, rstd;
  if (training) {
    const Moments m = channel_moments(partials, c.channel, samples,
                                      channels, length, chunk, chunks,
                                      shared);
    const double total = static_cast<double>(samples * length);
    const float var = __fdiv_rn(m.m2, static_cast<float>(total));
    mean = m.mean;
    rstd = inverse_std(var, eps);
    if (c.first && threadIdx.x == 0) {
      saved[c.channel] = make_float2(mean, rstd);
      if (running_mean != nullptr) {
        const float unbiased =
            __fmul_rn(var, static_cast<float>(total / (total - 1.0)));
        const float keep = __fsub_rn(1.0f, momentum);
        running_mean[c.channel] =
            __fadd_rn(__fmul_rn(mean, momentum),
                      __fmul_rn(keep, running_mean[c.channel]));
        running_var[c.channel] =
            __fadd_rn(__fmul_rn(unbiased, momentum),
                      __fmul_rn(keep, running_var[c.channel]));
      }
      if (batches != nullptr && c.channel == 0) *batches += 1;
    }
  } else {
    mean = running_mean[c.channel];
    rstd = inverse_std(running_var[c.channel], eps);
    if (c.first && threadIdx.x == 0) {
      saved[c.channel] = make_float2(mean, rstd);
    }
  }
  const float scale =
      weight != nullptr ? __fmul_rn(weight[c.channel], rstd) : rstd;
  const float shift = bias != nullptr ? bias[c.channel] : 0.0f;

#pragma unroll
  for (int k = 0; k < kVectors; ++k) {
    const int e = (k * kThreads + threadIdx.x) * VEC;
    if (e < c.count) {
      Pack<T, VEC> result;
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        result.v[j] = from_float<T>(__fmaf_rn(
            __fsub_rn(to_float(values[k].v[j]), mean), scale, shift));
      }
      store<T, VEC>(out + c.begin + e, result);
    }
  }
}

// Backward pass 1: the chunk's float32 sums of dy and of dy * x_hat.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads, kTwoTensorBlocks)
bn_gradient_sums_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                        const float2* __restrict__ saved,
                        float2* __restrict__ sums, long long length,
                        int chunk, int chunks, int channels) {
  constexpr int kVectors = per_thread<T>() / VEC;
  __shared__ float shared[kWarps];
  const Chunk c = chunk_of(blockIdx.x, length, chunk, chunks, channels);
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
  const float2 statistics = saved[c.channel];
  float sum = 0.0f, product = 0.0f;
#pragma unroll
  for (int k = 0; k < kVectors; ++k) {
    const int e = (k * kThreads + threadIdx.x) * VEC;
    if (e < c.count) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float d = to_float(grads[k].v[j]);
        sum += d;
        product += d * ((to_float(values[k].v[j]) - statistics.x) *
                        statistics.y);
      }
    }
  }
  sum = block_sum(sum, shared);
  product = block_sum(product, shared);
  if (threadIdx.x == 0) sums[blockIdx.x] = make_float2(sum, product);
}

// Backward pass 2, in pass 1's reverse block order: dx, and the channel's
// first block writes dgamma and dbeta.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads, kTwoTensorBlocks)
bn_input_gradient_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                         T* __restrict__ dx,
                         const float2* __restrict__ saved,
                         const float2* __restrict__ sums,
                         const float* __restrict__ weight,
                         float* __restrict__ dweight,
                         float* __restrict__ dbias, long long samples,
                         long long length, int chunk, int chunks,
                         int channels, int training) {
  constexpr int kVectors = per_thread<T>() / VEC;
  __shared__ float2 shared[kWarps];
  const long long block = gridDim.x - 1 - static_cast<long long>(blockIdx.x);
  const Chunk c = chunk_of(block, length, chunk, chunks, channels);
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
  const float2 s = channel_sums(sums, c.channel, samples, channels, chunks,
                                shared);
  if (c.first && threadIdx.x == 0 && dweight != nullptr) {
    dweight[c.channel] = s.y;
    dbias[c.channel] = s.x;
  }
  const float2 statistics = saved[c.channel];
  const float mean = statistics.x, rstd = statistics.y;
  const float scale = weight != nullptr ? weight[c.channel] * rstd : rstd;
  const float total = static_cast<float>(samples * length);
  const float mean_dy = training ? s.x / total : 0.0f;
  const float mean_product = training ? s.y / total : 0.0f;
#pragma unroll
  for (int k = 0; k < kVectors; ++k) {
    const int e = (k * kThreads + threadIdx.x) * VEC;
    if (e < c.count) {
      Pack<T, VEC> result;
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float x_hat = (to_float(values[k].v[j]) - mean) * rstd;
        result.v[j] = from_float<T>(
            scale * (to_float(grads[k].v[j]) - mean_dy -
                     x_hat * mean_product));
      }
      store<T, VEC>(dx + c.begin + e, result);
    }
  }
}

template <typename T, int VEC>
int launch(const void* x, void* out, void* partials, const void* weight,
           const void* bias, void* running_mean, void* running_var,
           void* batches, void* saved, long long samples, int channels,
           long long length, int chunk, int chunks, int training,
           float momentum, float eps, cudaStream_t stream) {
  if (chunk > kThreads * per_thread<T>()) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned int>(samples * channels * chunks));
  if (training) {
    bn_moments_kernel<T, VEC><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<float2*>(partials), length,
        chunk, chunks, channels);
    const cudaError_t first = cudaGetLastError();
    if (first != cudaSuccess) return static_cast<int>(first);
  }
  bn_normalize_kernel<T, VEC><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out),
      static_cast<const float2*>(partials), static_cast<const float*>(weight),
      static_cast<const float*>(bias), static_cast<float*>(running_mean),
      static_cast<float*>(running_var), static_cast<long long*>(batches),
      static_cast<float2*>(saved), samples, length, chunk, chunks, channels,
      training, momentum, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int VEC>
int launch_backward(const void* x, const void* dy, void* dx,
                    const void* saved, void* sums, const void* weight,
                    void* dweight, void* dbias, long long samples,
                    int channels, long long length, int chunk, int chunks,
                    int training, cudaStream_t stream) {
  if (chunk > kThreads * per_thread<T>()) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned int>(samples * channels * chunks));
  bn_gradient_sums_kernel<T, VEC><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy),
      static_cast<const float2*>(saved), static_cast<float2*>(sums), length,
      chunk, chunks, channels);
  const cudaError_t first = cudaGetLastError();
  if (first != cudaSuccess) return static_cast<int>(first);
  bn_input_gradient_kernel<T, VEC><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy),
      static_cast<T*>(dx), static_cast<const float2*>(saved),
      static_cast<const float2*>(sums), static_cast<const float*>(weight),
      static_cast<float*>(dweight), static_cast<float*>(dbias), samples,
      length, chunk, chunks, channels, training);
  return static_cast<int>(cudaGetLastError());
}

bool valid_grid(long long samples, int channels, long long length, int chunk,
                int chunks) {
  const long long blocks = samples * channels * chunks;
  return samples > 0 && channels > 0 && length > 0 && chunk > 0 &&
         chunks > 0 && blocks <= 0x7fffffffLL &&
         static_cast<long long>(chunks - 1) * chunk < length &&
         length <= static_cast<long long>(chunks) * chunk;
}

}  // namespace

// x and out: [samples, channels, length] of dtype 0 = float32 or 1 =
// bfloat16; weight and bias (both or neither null): float32 [channels];
// running_mean and running_var (both or neither null): float32 [channels],
// updated in training mode, read in eval mode (training 0), which needs
// them; batches (or null): one int64, plus one in training mode; saved:
// float2 [channels], written with each channel's (mean, rstd); partials:
// float2 [samples * channels * chunks] scratch in training mode (else
// unused). The host picks chunk (a multiple of the vector width, at most
// 32 KB of elements) and chunks = ceil(length / chunk); vector 1 asks for
// 16-byte accesses, which need length a multiple of 16 bytes of elements
// and every pointer 16-byte aligned. Returns cudaGetLastError() after the
// launches: two in training mode, one in eval mode.
extern "C" int batch_norm(const void* x, void* out, void* partials,
                          const void* weight, const void* bias,
                          void* running_mean, void* running_var,
                          void* batches, void* saved, long long samples,
                          int channels, long long length, int chunk,
                          int chunks, int vector, int training,
                          float momentum, float eps, int dtype,
                          void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!valid_grid(samples, channels, length, chunk, chunks) ||
      (weight == nullptr) != (bias == nullptr) ||
      (running_mean == nullptr) != (running_var == nullptr) ||
      (training && partials == nullptr) ||
      (!training && running_mean == nullptr) || saved == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#define K6_LAUNCH(T, VEC)                                                   \
  launch<T, VEC>(x, out, partials, weight, bias, running_mean, running_var, \
                 batches, saved, samples, channels, length, chunk, chunks,  \
                 training, momentum, eps, s)
  if (dtype == 0) return vector ? K6_LAUNCH(float, 4) : K6_LAUNCH(float, 1);
  if (dtype == 1) {
    return vector ? K6_LAUNCH(__nv_bfloat16, 8)
                  : K6_LAUNCH(__nv_bfloat16, 1);
  }
#undef K6_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

// The gradient of batch_norm for the output gradient dy: x (batch_norm's
// input), dy and dx: [samples, channels, length] of dtype 0 or 1, as
// batch_norm takes them; saved: batch_norm's (mean, rstd) per channel;
// sums: float2 [samples * channels * chunks] scratch; weight (or null):
// float32 [channels]; dweight and dbias: float32 [channels], written when
// both are given (else both null); training 0 differentiates eval mode's
// normalisation by constant statistics. Two launches. Returns
// cudaGetLastError() after them.
extern "C" int batch_norm_backward(const void* x, const void* dy, void* dx,
                                   const void* saved, void* sums,
                                   const void* weight, void* dweight,
                                   void* dbias, long long samples,
                                   int channels, long long length, int chunk,
                                   int chunks, int vector, int training,
                                   int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!valid_grid(samples, channels, length, chunk, chunks) ||
      (dweight == nullptr) != (dbias == nullptr) || saved == nullptr ||
      sums == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#define K6_LAUNCH(T, VEC)                                                   \
  launch_backward<T, VEC>(x, dy, dx, saved, sums, weight, dweight, dbias,   \
                          samples, channels, length, chunk, chunks,         \
                          training, s)
  if (dtype == 0) return vector ? K6_LAUNCH(float, 4) : K6_LAUNCH(float, 1);
  if (dtype == 1) {
    return vector ? K6_LAUNCH(__nv_bfloat16, 8)
                  : K6_LAUNCH(__nv_bfloat16, 1);
  }
#undef K6_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* batch_norm_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
