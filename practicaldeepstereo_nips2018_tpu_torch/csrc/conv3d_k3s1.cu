// 3x3x3 convolution, stride 1, zero padding 1, fused bias.
//
// Replaces the TPU kernel practicaldeepstereo_nips2018_tpu/ops/folded_banded.py
// ::_slab_kernel (driven by conv3d_folded_pallas). That kernel computed the
// same conv on a depth-folded [B, H, W, D*C] volume as 9 banded K=256 MXU dots
// per 128-lane output group; the folding and the banded weights exist only for
// the TPU's 128-lane matrix unit and are not carried over. Here the volume is
// NCDHW-contiguous [B, C, D, H, W], the port's hourglass layout, and the
// weights arrive tap-major, [cout, 27, cin] (tap = kd*9 + kh*3 + kw), as
// ops/conv3d.py::tap_major_weight lays them out.
//
// Arithmetic: x in float32 or bfloat16, weights in the same type, bias in
// float32; every product is accumulated in float32 and the output is rounded
// once to the input type. Unlike the TPU kernel (whose slab guard reads 256
// lanes where cin = 128 needs 384, and so drops a depth tap at the deepest
// level), every tap is read at every channel count.
//
// What bounds it on an H100. The conv is a GEMM with M = output voxels,
// N = cout and K = 27*cin. At the hourglass's first level (cin = cout = 8,
// 1.66 M voxels at 540x960, D=191) it moves 53 MB of bfloat16 for 5.7 GFLOP,
// far below the card's FLOP:byte balance: bound by bytes (16 us). The deeper
// levels have 207k to 405 voxels and 0.4 to 4 us of tensor-core work: bound
// by latency and by filling 132 SMs, not by a rate.
//
// Design, bfloat16 with cin in {8, 16, 32, 64, 128} (every level of the
// hourglass): an implicit GEMM on the tensor cores, mma.sync with bf16 in
// and f32 accumulators (m16n8k16; m16n8k8 at cin = 8, one tap a step). A
// block owns TH rows x TW = 16*TWT columns x TD depths x BN output channels:
//   * it walks its TD depths in order over a ring of 3 input planes in
//     shared memory, channels-last [h][w][ci], transposed from NCDHW as they
//     load; each new plane is loaded into registers while the previous
//     depth is computed (the loads are volatile so that the compiler emits
//     them before the tensor-core work), so every input plane is read about
//     once per block instead of 3 times; positions outside the volume are
//     zero, which is the conv's padding;
//   * each voxel is padded to an odd number of 16-byte units, so that
//     ldmatrix reads 8 neighbouring voxels without bank conflicts;
//   * it copies its BN rows of tap-major weights once with cp.async (rows of
//     54*cin bytes, 16-byte aligned), again padded to an odd number of
//     16-byte units per row, so B fragments load without conflicts;
//   * each warp multiplies MT m16 tiles by NT n8 tiles; a tap is a constant
//     offset from its (kd, kh) row in the ring, the kw taps and channel
//     steps of one (kd, kh) are unrolled, the 9 (kd, kh) pairs are a loop
//     (unrolled too, the compiler hoists every ldmatrix and spills);
//   * at the deep levels WARPS_K warps of a block split the (kd, kh) pairs
//     and their partial sums are added in a fixed order in shared memory
//     (no atomics, so every run gives the same bits), and cout is split over
//     blocks, so that every level runs in about one wave of blocks;
//   * the epilogue adds the bias, rounds once and stores the C fragments
//     straight to NCDHW: each warp store writes 16 bytes along W for each of
//     4 output channels (16-byte stores staged through shared memory are
//     no faster on an H100).
// mma.sync, not wgmma: no level is bound by the tensor-core rate. At the
// first level the time goes to moving the data (the output stores, the
// input loads and the ldmatrix reads of the im2col-shaped A fragments:
// 27 x 16 bytes per voxel at cin = 8), not to the tensor cores.
//
// float32 with cin <= 32 takes a tiled kernel on the CUDA cores in exact
// float32 (no TF32): input and weight tiles in shared memory, 4 outputs x 8
// channels in each thread's registers. Other shapes (float32 from cin = 64,
// or cout not a multiple of 8; bfloat16 with other channel counts) take the
// direct kernel: one thread per output element, 27*cin fused multiply-adds,
// also in exact float32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// Direct kernel (shapes the tiled kernels do not take).

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
  const T* weight_co = weight + static_cast<size_t>(co) * taps;  // [27, cin]
  for (int i = threadIdx.x; i < taps; i += blockDim.x) {
    const int ci = i / 27;
    weight_shared[i] = load_float(weight_co + (i - ci * 27) * cin + ci);
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
int launch_direct(const void* x, const void* weight, const float* bias,
                  void* y, int batch, int cin, int cout, int depth,
                  int height, int width, cudaStream_t stream) {
  const int plane = height * width;
  const dim3 grid((plane + kThreads - 1) / kThreads, depth, batch * cout);
  const size_t shared_bytes = static_cast<size_t>(cin) * 27 * sizeof(float);
  conv3d_k3s1_kernel<T><<<grid, kThreads, shared_bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(weight), bias,
      static_cast<T*>(y), cin, cout, depth, height, width);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Tiled float32 kernel: exact float32 on the CUDA cores (fmaf, no TF32).
// A block owns 16 rows x 32 columns of one depth for 8 output channels. It
// stages 4 input channels at a time (3 depths x 18 x 34, rows padded to 35
// floats so that a warp's reads hit 32 distinct banks) and their weights in
// shared memory; each thread keeps 4 neighbouring outputs x 8 channels in
// registers, so every input value read feeds 8 fused multiply-adds and
// every weight read 4.

constexpr int kF32TileW = 32;
constexpr int kF32TileH = 16;
constexpr int kF32Pixels = 4;  // outputs along W per thread
constexpr int kF32Couts = 8;   // output channels per block
constexpr int kF32Chunk = 4;   // input channels staged at a time
constexpr int kF32Threads = kF32TileW / kF32Pixels * kF32TileH;
constexpr int kF32InW = kF32TileW + 2;
constexpr int kF32InH = kF32TileH + 2;
constexpr int kF32RowStride = kF32InW + 1;

// grid: (ceil(W/32) * ceil(H/16), D, B * cout/8).
__global__ void __launch_bounds__(kF32Threads)
conv3d_k3s1_f32_kernel(const float* __restrict__ x,
                       const float* __restrict__ weight_taps,
                       const float* __restrict__ bias, float* __restrict__ y,
                       int cin, int cout, int depth, int height, int width) {
  __shared__ float tile[kF32Chunk][3][kF32InH][kF32RowStride];
  __shared__ __align__(16) float weights[kF32Chunk][27][kF32Couts];
  const int w_tiles = (width + kF32TileW - 1) / kF32TileW;
  const int h0 = (blockIdx.x / w_tiles) * kF32TileH;
  const int w0 = (blockIdx.x % w_tiles) * kF32TileW;
  const int d = blockIdx.y;
  const int groups = cout / kF32Couts;
  const int co0 = (blockIdx.z % groups) * kF32Couts;
  const int b = blockIdx.z / groups;
  const int tx = threadIdx.x % (kF32TileW / kF32Pixels);
  const int ty = threadIdx.x / (kF32TileW / kF32Pixels);
  const size_t plane = static_cast<size_t>(height) * width;
  const size_t volume = static_cast<size_t>(depth) * plane;
  const float* x_b = x + static_cast<size_t>(b) * cin * volume;

  float acc[kF32Pixels][kF32Couts];
#pragma unroll
  for (int p = 0; p < kF32Pixels; ++p)
#pragma unroll
    for (int co = 0; co < kF32Couts; ++co) acc[p][co] = 0.0f;

  for (int c0 = 0; c0 < cin; c0 += kF32Chunk) {
    __syncthreads();  // the previous chunk's reads are done
    for (int i = threadIdx.x; i < kF32Chunk * 3 * kF32InH * kF32InW;
         i += kF32Threads) {
      const int wl = i % kF32InW;
      int rest = i / kF32InW;
      const int hl = rest % kF32InH;
      rest /= kF32InH;
      const int kd = rest % 3;
      const int c = rest / 3;
      const int ci = c0 + c;
      const int dd = d + kd - 1;
      const int hh = h0 + hl - 1;
      const int ww = w0 + wl - 1;
      float v = 0.0f;
      if (ci < cin && dd >= 0 && dd < depth && hh >= 0 && hh < height &&
          ww >= 0 && ww < width) {
        v = __ldg(x_b + ci * volume + static_cast<size_t>(dd) * plane +
                  static_cast<size_t>(hh) * width + ww);
      }
      tile[c][kd][hl][wl] = v;
    }
    for (int i = threadIdx.x; i < kF32Chunk * 27 * kF32Couts;
         i += kF32Threads) {
      const int co = i % kF32Couts;
      const int tap = (i / kF32Couts) % 27;
      const int c = i / (kF32Couts * 27);
      const int ci = c0 + c;
      weights[c][tap][co] =
          ci < cin ? __ldg(weight_taps +
                           (static_cast<size_t>(co0 + co) * 27 + tap) * cin +
                           ci)
                   : 0.0f;
    }
    __syncthreads();
    const int chunk = min(kF32Chunk, cin - c0);
    for (int c = 0; c < chunk; ++c) {
#pragma unroll
      for (int kd = 0; kd < 3; ++kd) {
#pragma unroll
        for (int kh = 0; kh < 3; ++kh) {
          const float* row = &tile[c][kd][ty + kh][tx * kF32Pixels];
          float in[kF32Pixels + 2];
#pragma unroll
          for (int p = 0; p < kF32Pixels + 2; ++p) in[p] = row[p];
#pragma unroll
          for (int kw = 0; kw < 3; ++kw) {
            const float4* tap_weights =
                reinterpret_cast<const float4*>(weights[c][kd * 9 + kh * 3 + kw]);
            const float4 low = tap_weights[0];
            const float4 high = tap_weights[1];
            const float w[kF32Couts] = {low.x,  low.y,  low.z,  low.w,
                                        high.x, high.y, high.z, high.w};
#pragma unroll
            for (int p = 0; p < kF32Pixels; ++p)
#pragma unroll
              for (int co = 0; co < kF32Couts; ++co)
                acc[p][co] = fmaf(w[co], in[p + kw], acc[p][co]);
          }
        }
      }
    }
  }

  const int h = h0 + ty;
  if (h >= height) return;
#pragma unroll
  for (int p = 0; p < kF32Pixels; ++p) {
    const int w = w0 + tx * kF32Pixels + p;
    if (w >= width) continue;
#pragma unroll
    for (int co = 0; co < kF32Couts; ++co) {
      y[(static_cast<size_t>(b) * cout + co0 + co) * volume +
        static_cast<size_t>(d) * plane + static_cast<size_t>(h) * width + w] =
          acc[p][co] + bias[co0 + co];
    }
  }
}

int launch_f32(const void* x, const void* weight, const float* bias, void* y,
               int batch, int cin, int cout, int depth, int height, int width,
               cudaStream_t stream) {
  const dim3 grid(((width + kF32TileW - 1) / kF32TileW) *
                      ((height + kF32TileH - 1) / kF32TileH),
                  depth, batch * (cout / kF32Couts));
  conv3d_k3s1_f32_kernel<<<grid, kF32Threads, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(weight), bias,
      static_cast<float*>(y), cin, cout, depth, height, width);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Tensor-core kernel (bfloat16).

__device__ __forceinline__ uint32_t shared_address(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void copy_async_16(void* shared, const void* global) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   shared_address(shared)),
               "l"(global));
}

__device__ __forceinline__ void copy_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void load_matrix_x4(uint32_t (&a)[4],
                                               uint32_t address) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(address));
}

__device__ __forceinline__ void load_matrix_x2(uint32_t (&a)[2],
                                               uint32_t address) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(a[0]), "=r"(a[1])
               : "r"(address));
}

__device__ __forceinline__ void mma_bf16_k8(float (&c)[4],
                                            const uint32_t (&a)[2],
                                            uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(b));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Block tile: TD depths (walked in order), TH rows x TW = 16*TWT columns,
// BN output channels; WARPS_M x WARPS_N warps own the M and N tiles,
// WARPS_K warps split the K steps.
template <int CIN, int TD, int TH, int TWT, int BN, int WARPS_M, int WARPS_N,
          int WARPS_K>
struct Tile {
  static_assert(CIN % 8 == 0, "cin must be a multiple of 8");
  static constexpr int TW = TWT * 16;
  static constexpr int IN_H = TH + 2;
  static constexpr int IN_W = TW + 2;
  static constexpr int GROUPS = CIN / 8;  // 16-byte channel groups per voxel
  // An odd number of 16-byte units per voxel: ldmatrix rows of 8
  // neighbouring voxels then fall in 8 distinct bank groups.
  static constexpr int VOXEL_BYTES =
      GROUPS % 2 == 1 ? CIN * 2 : CIN * 2 + 16;
  static constexpr int TAP_CHUNKS = 27 * CIN / 8;  // 16-byte chunks of a row
  // One output channel's weights, an odd number of 16-byte units.
  static constexpr int ROW_BYTES =
      TAP_CHUNKS % 2 == 1 ? TAP_CHUNKS * 16 : TAP_CHUNKS * 16 + 16;
  static constexpr int M_TILES = TH * TWT;
  static_assert(M_TILES % WARPS_M == 0, "M tiles must split over warps");
  static_assert(BN % (8 * WARPS_N) == 0, "BN must split over warps");
  static_assert(9 % WARPS_K == 0,
                "split-K warps take whole groups of (kd, kh) pairs");
  static constexpr int MT = M_TILES / WARPS_M;
  static constexpr int NT = BN / 8 / WARPS_N;
  static constexpr int THREADS = 32 * WARPS_M * WARPS_N * WARPS_K;
  static constexpr int ACC = MT * NT * 4;
  static constexpr int PLANE_ITEMS = IN_H * IN_W * GROUPS;
  static constexpr int ITEMS_PER_THREAD = (PLANE_ITEMS + THREADS - 1) / THREADS;
  static constexpr int PLANE_BYTES = IN_H * IN_W * VOXEL_BYTES;
  static constexpr int WEIGHT_OFFSET = 3 * PLANE_BYTES;  // after a ring of 3
  static constexpr int REDUCE_OFFSET = WEIGHT_OFFSET + BN * ROW_BYTES;
  static constexpr int REDUCE_BYTES =
      (WARPS_K - 1) * WARPS_M * WARPS_N * ACC * 32 * 4;
  static constexpr int SHARED_BYTES = REDUCE_OFFSET + REDUCE_BYTES;
};

// 16-bit load that the compiler keeps where it is written (volatile, like
// the ldmatrix and mma around it), so that a prefetch starts before the
// tensor-core work and not sunk to its first use; 0 where !valid.
__device__ __forceinline__ uint32_t load_u16(const unsigned short* p,
                                             bool valid) {
  unsigned short v;
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %2, 0;\n mov.b16 %0, 0;\n"
      " @p ld.global.nc.u16 %0, [%1];\n}\n"
      : "=h"(v)
      : "l"(p), "r"(static_cast<int>(valid)));
  return v;
}

// This thread's items of a halo'd input plane: item i is 8 channels of one
// (h, w); the same for every depth, so computed once.
template <class Cfg>
struct PlaneItems {
  const unsigned short* source[Cfg::ITEMS_PER_THREAD];  // at depth 0
  uint32_t target[Cfg::ITEMS_PER_THREAD];  // byte offset in a ring slot
  uint32_t inside;                         // bit r: item r lies in the volume

  __device__ __forceinline__ PlaneItems(const unsigned short* x_b, int h0,
                                        int w0, int height, int width,
                                        size_t volume) {
    inside = 0;
#pragma unroll
    for (int r = 0; r < Cfg::ITEMS_PER_THREAD; ++r) {
      const int i = threadIdx.x + r * Cfg::THREADS;
      const int wl = i % Cfg::IN_W;
      const int group = (i / Cfg::IN_W) % Cfg::GROUPS;
      const int hl = i / (Cfg::IN_W * Cfg::GROUPS);
      const int hh = h0 + hl - 1;
      const int ww = w0 + wl - 1;
      const bool in = i < Cfg::PLANE_ITEMS && hh >= 0 && hh < height &&
                      ww >= 0 && ww < width;
      source[r] = x_b + (in ? group * 8 * volume +
                                  static_cast<size_t>(hh) * width + ww
                            : 0);
      target[r] = i < Cfg::PLANE_ITEMS
                      ? (hl * Cfg::IN_W + wl) * Cfg::VOXEL_BYTES + group * 16
                      : 0xffffffffu;
      inside |= (in ? 1u : 0u) << r;
    }
  }

  // Starts the loads of plane dd (zero outside the volume) into raw.
  __device__ __forceinline__ void load(uint32_t (&raw)[Cfg::ITEMS_PER_THREAD][8],
                                       int dd, int depth, size_t plane,
                                       size_t volume) const {
    const bool depth_inside = dd >= 0 && dd < depth;
    const size_t offset = depth_inside ? static_cast<size_t>(dd) * plane : 0;
#pragma unroll
    for (int r = 0; r < Cfg::ITEMS_PER_THREAD; ++r) {
      const bool valid = depth_inside && (inside >> r & 1u);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        raw[r][j] = load_u16(source[r] + offset + j * volume, valid);
      }
    }
  }

  // Packs raw into the ring slot that starts at slot.
  __device__ __forceinline__ void store(
      const uint32_t (&raw)[Cfg::ITEMS_PER_THREAD][8],
      unsigned char* slot) const {
#pragma unroll
    for (int r = 0; r < Cfg::ITEMS_PER_THREAD; ++r) {
      if (target[r] == 0xffffffffu) continue;
      *reinterpret_cast<uint4*>(slot + target[r]) = make_uint4(
          raw[r][0] | (raw[r][1] << 16), raw[r][2] | (raw[r][3] << 16),
          raw[r][4] | (raw[r][5] << 16), raw[r][6] | (raw[r][7] << 16));
    }
  }
};

// grid: (ceil(W/TW) * ceil(H/TH), ceil(D/TD), B * cout/BN).
template <int CIN, int TD, int TH, int TWT, int BN, int WARPS_M, int WARPS_N,
          int WARPS_K, int MIN_BLOCKS>
__global__ void __launch_bounds__(32 * WARPS_M * WARPS_N * WARPS_K, MIN_BLOCKS)
conv3d_k3s1_mma_kernel(const unsigned short* __restrict__ x,
                       const unsigned short* __restrict__ weight_taps,
                       const float* __restrict__ bias,
                       __nv_bfloat16* __restrict__ y, int cout, int depth,
                       int height, int width) {
  using Cfg = Tile<CIN, TD, TH, TWT, BN, WARPS_M, WARPS_N, WARPS_K>;
  extern __shared__ __align__(16) unsigned char shared[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int w_tiles = (width + Cfg::TW - 1) / Cfg::TW;
  const int h0 = (blockIdx.x / w_tiles) * TH;
  const int w0 = (blockIdx.x % w_tiles) * Cfg::TW;
  const int d0 = blockIdx.y * TD;
  const int depths = min(TD, depth - d0);
  const int n_splits = cout / BN;
  const int n0 = (blockIdx.z % n_splits) * BN;
  const int b = blockIdx.z / n_splits;
  const size_t plane = static_cast<size_t>(height) * width;
  const size_t volume = static_cast<size_t>(depth) * plane;
  const unsigned short* x_b = x + static_cast<size_t>(b) * CIN * volume;

  // 1. This block's BN rows of tap-major weights, [n][tap*CIN + ci].
  {
    const unsigned short* source =
        weight_taps + static_cast<size_t>(n0) * 27 * CIN;
    for (int i = tid; i < BN * Cfg::TAP_CHUNKS; i += Cfg::THREADS) {
      const int n = i / Cfg::TAP_CHUNKS;
      const int chunk = i - n * Cfg::TAP_CHUNKS;
      copy_async_16(shared + Cfg::WEIGHT_OFFSET + n * Cfg::ROW_BYTES +
                        chunk * 16,
                    source + static_cast<size_t>(n) * 27 * CIN + chunk * 8);
    }
  }

  // 2. The ring: input planes d0-1, d0, d0+1 in slots 0, 1, 2, channels-last
  //    [h][w][ci], zero outside the volume (the conv's padding).
  const PlaneItems<Cfg> items(x_b, h0, w0, height, width, volume);
  uint32_t raw[Cfg::ITEMS_PER_THREAD][8];
#pragma unroll 1
  for (int kd = 0; kd < 3; ++kd) {
    items.load(raw, d0 + kd - 1, depth, plane, volume);
    items.store(raw, shared + kd * Cfg::PLANE_BYTES);
  }
  copy_async_wait_all();
  __syncthreads();

  const int warp_m = warp % WARPS_M;
  const int warp_n = (warp / WARPS_M) % WARPS_N;
  const int warp_k = warp / (WARPS_M * WARPS_N);
  // ldmatrix: lanes 0-15 address rows 0-15 at K offset 0 and, for x4,
  // lanes 16-31 rows 0-15 at K offset 8.
  uint32_t a_base[Cfg::MT];
#pragma unroll
  for (int i = 0; i < Cfg::MT; ++i) {
    const int tile = warp_m * Cfg::MT + i;
    const int th = tile / TWT;
    const int tw = (tile % TWT) * 16 + (lane & 15);
    a_base[i] = shared_address(shared + (th * Cfg::IN_W + tw) * Cfg::VOXEL_BYTES);
  }
  // B fragment: b0 = row n, K 2*(lane%4) + {0, 1}; b1 = K + 8.
  const unsigned char* b_rows =
      shared + Cfg::WEIGHT_OFFSET +
      (warp_n * Cfg::NT * 8 + (lane >> 2)) * Cfg::ROW_BYTES + (lane & 3) * 4;
  // This lane's output channels in the C fragment: 2*(lane%4) + {0, 1}.
  float bias_lane[Cfg::NT][2];
#pragma unroll
  for (int j = 0; j < Cfg::NT; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      bias_lane[j][e] =
          bias[n0 + (warp_n * Cfg::NT + j) * 8 + 2 * (lane & 3) + e];
    }
  }

#pragma unroll 1
  for (int t = 0; t < depths; ++t) {
    const int d = d0 + t;
    // 3. Loads of plane d+2 fly while plane d is computed.
    const bool prefetch = t + 1 < depths;
    if (prefetch) items.load(raw, d + 2, depth, plane, volume);
    const uint32_t planes[3] = {(t % 3) * Cfg::PLANE_BYTES,
                                ((t + 1) % 3) * Cfg::PLANE_BYTES,
                                ((t + 2) % 3) * Cfg::PLANE_BYTES};

    // 4. The K steps of this warp on the tensor cores.
    float acc[Cfg::MT][Cfg::NT][4];
#pragma unroll
    for (int i = 0; i < Cfg::MT; ++i)
#pragma unroll
      for (int j = 0; j < Cfg::NT; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.0f;
    // One K step: 16 channels of one tap (m16n8k16), or at cin = 8 the
    // tap's 8 channels (m16n8k8).
    auto step = [&](uint32_t a_offset, const unsigned char* b) {
      if constexpr (CIN == 8) {
        uint32_t a[Cfg::MT][2];
#pragma unroll
        for (int i = 0; i < Cfg::MT; ++i) load_matrix_x2(a[i], a_base[i] + a_offset);
        uint32_t bfrag[Cfg::NT];
#pragma unroll
        for (int j = 0; j < Cfg::NT; ++j) {
          bfrag[j] = *reinterpret_cast<const uint32_t*>(b + j * 8 * Cfg::ROW_BYTES);
        }
#pragma unroll
        for (int i = 0; i < Cfg::MT; ++i)
#pragma unroll
          for (int j = 0; j < Cfg::NT; ++j) mma_bf16_k8(acc[i][j], a[i], bfrag[j]);
      } else {
        uint32_t a[Cfg::MT][4];
#pragma unroll
        for (int i = 0; i < Cfg::MT; ++i) load_matrix_x4(a[i], a_base[i] + a_offset);
        uint32_t bfrag[Cfg::NT][2];
#pragma unroll
        for (int j = 0; j < Cfg::NT; ++j) {
          const unsigned char* p = b + j * 8 * Cfg::ROW_BYTES;
          bfrag[j][0] = *reinterpret_cast<const uint32_t*>(p);
          bfrag[j][1] = *reinterpret_cast<const uint32_t*>(p + 16);
        }
#pragma unroll
        for (int i = 0; i < Cfg::MT; ++i)
#pragma unroll
          for (int j = 0; j < Cfg::NT; ++j) mma_bf16(acc[i][j], a[i], bfrag[j]);
      }
    };
    // The warp's (kd, kh) pairs, kd*3 + kh, one after another; within a pair
    // the 3 kw taps and their channel steps are unrolled, each a constant
    // offset from the pair's row in the ring.
    constexpr int PAIRS = 9 / WARPS_K;
    constexpr int STEPS_PER_TAP = CIN == 8 ? 1 : CIN / 16;
    const uint32_t lane_offset = CIN == 8 ? 0 : (lane >> 4) * 16;
#pragma unroll 1
    for (int pair = warp_k * PAIRS; pair < (warp_k + 1) * PAIRS; ++pair) {
      const int kd = pair / 3;
      const int kh = pair - kd * 3;
      const uint32_t row_base =
          (kd == 0 ? planes[0] : kd == 1 ? planes[1] : planes[2]) +
          kh * Cfg::IN_W * Cfg::VOXEL_BYTES + lane_offset;
      const unsigned char* b_pair = b_rows + pair * 3 * CIN * 2;
#pragma unroll
      for (int kw = 0; kw < 3; ++kw) {
#pragma unroll
        for (int c = 0; c < STEPS_PER_TAP; ++c) {
          step(row_base + kw * Cfg::VOXEL_BYTES + c * 32,
               b_pair + kw * CIN * 2 + c * 32);
        }
      }
    }

    // 5. Split-K partial sums, added in warp_k order (deterministic).
    if constexpr (WARPS_K > 1) {
      float* reduce = reinterpret_cast<float*>(shared + Cfg::REDUCE_OFFSET);
      const int slot = warp_m + WARPS_M * warp_n;
      if (warp_k > 0) {
        float* out = reduce +
                     ((warp_k - 1) * WARPS_M * WARPS_N + slot) * Cfg::ACC * 32 +
                     lane;
#pragma unroll
        for (int i = 0; i < Cfg::MT; ++i)
#pragma unroll
          for (int j = 0; j < Cfg::NT; ++j)
#pragma unroll
            for (int c = 0; c < 4; ++c)
              out[((i * Cfg::NT + j) * 4 + c) * 32] = acc[i][j][c];
      }
      __syncthreads();
      if (warp_k == 0) {
        for (int k = 1; k < WARPS_K; ++k) {
          const float* in =
              reduce + ((k - 1) * WARPS_M * WARPS_N + slot) * Cfg::ACC * 32 +
              lane;
#pragma unroll
          for (int i = 0; i < Cfg::MT; ++i)
#pragma unroll
            for (int j = 0; j < Cfg::NT; ++j)
#pragma unroll
              for (int c = 0; c < 4; ++c)
                acc[i][j][c] += in[((i * Cfg::NT + j) * 4 + c) * 32];
        }
      }
    }

    // 6. Bias, one rounding, and the stores. C fragment: c0, c1 = row
    //    lane/4, columns 2*(lane%4) + {0, 1}; c2, c3 = row lane/4 + 8. Each
    //    warp store writes 16 bytes along W for each of 4 output channels.
    if (warp_k == 0) {
      __nv_bfloat16* y_d = y + (static_cast<size_t>(b) * cout + n0) * volume +
                           static_cast<size_t>(d) * plane;
#pragma unroll
      for (int i = 0; i < Cfg::MT; ++i) {
        const int tile = warp_m * Cfg::MT + i;
        const int h = h0 + tile / TWT;
        const int w_tile = w0 + (tile % TWT) * 16;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int w = w_tile + (lane >> 2) + 8 * (c >> 1);
          if (h >= height || w >= width) continue;
#pragma unroll
          for (int j = 0; j < Cfg::NT; ++j) {
            const int n = (warp_n * Cfg::NT + j) * 8 + 2 * (lane & 3) + (c & 1);
            y_d[n * volume + static_cast<size_t>(h) * width + w] =
                __float2bfloat16_rn(acc[i][j][c] + bias_lane[j][c & 1]);
          }
        }
      }
    }
    __syncthreads();
    // 7. Plane d+2 replaces plane d-1 in the ring.
    if (prefetch) items.store(raw, shared + (t % 3) * Cfg::PLANE_BYTES);
    __syncthreads();
  }
}

template <int CIN, int TD, int TH, int TWT, int BN, int WARPS_M, int WARPS_N,
          int WARPS_K, int MIN_BLOCKS>
int launch_mma(const void* x, const void* weight, const float* bias, void* y,
               int batch, int cout, int depth, int height, int width,
               cudaStream_t stream) {
  using Cfg = Tile<CIN, TD, TH, TWT, BN, WARPS_M, WARPS_N, WARPS_K>;
  auto kernel = conv3d_k3s1_mma_kernel<CIN, TD, TH, TWT, BN, WARPS_M, WARPS_N,
                                       WARPS_K, MIN_BLOCKS>;
  // Once per device: the dynamic shared memory above 48 KB, and the largest
  // shared-memory carveout, so that as many blocks fit on an SM as the
  // shared memory allows.
  static unsigned long long configured_devices = 0;
  int device = 0;
  cudaError_t status = cudaGetDevice(&device);
  if (status != cudaSuccess) return static_cast<int>(status);
  if (device >= 64 || !(configured_devices >> device & 1ull)) {
    status = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::SHARED_BYTES);
    if (status != cudaSuccess) return static_cast<int>(status);
    status = cudaFuncSetAttribute(
        kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
        cudaSharedmemCarveoutMaxShared);
    if (status != cudaSuccess) return static_cast<int>(status);
    if (device < 64) configured_devices |= 1ull << device;
  }
  const dim3 grid(((width + Cfg::TW - 1) / Cfg::TW) * ((height + TH - 1) / TH),
                  (depth + TD - 1) / TD, batch * (cout / BN));
  kernel<<<grid, Cfg::THREADS, Cfg::SHARED_BYTES, stream>>>(
      static_cast<const unsigned short*>(x),
      static_cast<const unsigned short*>(weight), bias,
      static_cast<__nv_bfloat16*>(y), cout, depth, height, width);
  return static_cast<int>(cudaGetLastError());
}

// The tensor-core tiling of each hourglass width (cin), chosen on an H100
// among a few candidates each so that every level fills the card in about
// one wave of blocks: <CIN, TD, TH, TWT, BN, WARPS_M, WARPS_N, WARPS_K,
// MIN_BLOCKS>. Returns -1 where it takes no such shape.
int launch_tensor_cores(const void* x, const void* weight, const float* bias,
                        void* y, int batch, int cin, int cout, int depth,
                        int height, int width, cudaStream_t s) {
  switch (cin) {
    case 8:
      if (cout % 8 == 0)
        return launch_mma<8, 8, 8, 4, 8, 8, 1, 1, 2>(x, weight, bias, y, batch,
                                                  cout, depth, height, width,
                                                  s);
      break;
    case 16:
      if (cout % 16 == 0)
        return launch_mma<16, 4, 4, 4, 16, 8, 1, 1, 2>(x, weight, bias, y, batch,
                                                    cout, depth, height, width,
                                                    s);
      break;
    case 32:
      if (cout % 32 == 0)
        return launch_mma<32, 2, 2, 4, 32, 8, 1, 1, 1>(x, weight, bias, y, batch,
                                                    cout, depth, height, width,
                                                    s);
      break;
    case 64:
      if (cout % 32 == 0)
        return launch_mma<64, 1, 2, 2, 32, 4, 1, 3, 1>(x, weight, bias, y, batch,
                                                    cout, depth, height, width,
                                                    s);
      break;
    case 128:
      if (cout % 16 == 0)
        return launch_mma<128, 1, 2, 1, 16, 2, 1, 9, 1>(x, weight, bias, y, batch,
                                                     cout, depth, height,
                                                     width, s);
      break;
    default:
      break;
  }
  return -1;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, weight and y share it; bias is
// float32). weight is tap-major [cout, 27, cin]. Returns cudaGetLastError()
// after the launch.
extern "C" int conv3d_k3s1(const void* x, const void* weight, const void* bias,
                           void* y, int batch, int cin, int cout, int depth,
                           int height, int width, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  if (dtype == 0) {
    // The tiled kernel walks cin in chunks of 4, one after another; from
    // cin = 64 on (the hourglass's two deepest levels, a few hundred to a
    // few thousand voxels) that chain outlasts the direct kernel's.
    if (cout % kF32Couts == 0 && cin <= 32) {
      return launch_f32(x, weight, b, y, batch, cin, cout, depth, height,
                        width, s);
    }
    return launch_direct<float>(x, weight, b, y, batch, cin, cout, depth,
                                height, width, s);
  }
  if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  const int status = launch_tensor_cores(x, weight, b, y, batch, cin, cout,
                                         depth, height, width, s);
  if (status >= 0) return status;
  return launch_direct<__nv_bfloat16>(x, weight, b, y, batch, cin, cout, depth,
                                      height, width, s);
}

extern "C" const char* conv3d_k3s1_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
