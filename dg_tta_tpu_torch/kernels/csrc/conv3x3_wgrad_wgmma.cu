// bf16 weight gradient of the stride-1 3x3(x3) convolution, on Hopper's
// tensor cores (sm_90a): wgmma fed by TMA, split over positions.
//
// The backward of dg_tta_tpu/ops/conv2d_pallas.py::conv3x3_pallas, which the
// TPU package left to XLA's conv transpose, for bf16 x and dy with
// C % 16 == 0 and CO % 8 == 0; conv3x3_wgrad_tf32x3.cu takes f32,
// conv3x3_c1.cu C = 1 and conv3x3_wgrad.cu the other channel counts.  The
// same function as conv3x3_wgrad.cu:
//
//   dW[kz,ky,kx,ci,co] = sum_{n,h,w} x[n+kz-KZ/2, h+ky-1, w+kx-1, ci]
//                                    * dy[n,h,w,co]
//
// zero-padded as the forward pads, f32 sums and f32 dW.
//
// What bounds it on an H100: 2*27*C*CO operations per position against
// (C + CO) * 2 bytes read: bound by the tensor cores, which conv3x3_wgrad.cu
// leaves idle (f32 FMAs on the CUDA cores, bound there by shared-memory
// loads).  The output is small (27*C*CO) and the sum long (up to 3.2M
// positions), so the positions are split across blocks (split-K).
//
// What the design does about it: per tap, dW_tap (C x CO) = x_shift^T * dy,
// a GEMM with M = input channels (a tile of 64), N = output channels (a tile
// of BN = 32 or 64), K = positions.  A block owns one z-tap kz, a ci tile, a
// co tile and a contiguous range of 4 x 16 position tiles of the planes,
// for all nine (ky, kx) taps.  Per position tile one producer thread issues
// two TMA loads into a ring of kStages shared-memory stages: the zero-padded
// 6 x 18 halo of x [n+dz, h0-1 : +6, w0-1 : +18, ci0 : +64] (out-of-bounds
// zero fill is the H/W padding; channels past C read zeros) and the dy tile
// [n, h0 : +4, w0 : +16, co0 : +BN]; the halo is read once for the nine
// taps, which bounds the L2 traffic (a box per tap read 5x more bytes).
// Three consumer warpgroups, one per ky, each issue 3 (kx) x 4 (rows of 16
// positions) wgmma m64nBNk16 per stage with both operands MN-major
// (channels contiguous, positions the reduction axis): tap (ky, kx) and
// output row r read the 16 halo rows from (r + ky) * 18 + kx on.  That
// start is not aligned to the 1024-byte swizzle atom, which needs nothing
// more: the swizzle is a function of the shared-memory address, the same for
// TMA's writes and wgmma's reads (base offset 0).  One wgmma group stays in
// flight.  A tile whose x
// plane lies outside the group is skipped by the whole block.  Each block
// writes its partial sums to its own slice of a scratch buffer and a second
// kernel adds the slices in a fixed order: deterministic, no atomics.  With
// one split the first kernel writes dW directly.

#include <cuda_bf16.h>
#include <stddef.h>

#include "hopper.cuh"

namespace {

using namespace dgtta;

constexpr int kTileH = 4;
constexpr int kTileW = 16;
constexpr int kHaloW = kTileW + 2;
constexpr int kPos = kTileH * kTileW;  // positions per stage (GEMM K step)
constexpr int kCiTile = 64;            // GEMM M tile: input channels
constexpr int kRowBytes = kCiTile * 2;  // one halo position in smem
constexpr int kConsumers = 3;          // warpgroups, one per ky
constexpr int kThreads = kConsumers * 128 + 32;
constexpr int kStages = 4;
// the (4 + 2) x 18 halo, rounded up to the 1024-byte swizzle atom
constexpr int kHaloBytes = (kTileH + 2) * kHaloW * kRowBytes;
constexpr int kXBytes = (kHaloBytes + 1023) / 1024 * 1024;

template <int BN>
struct Cfg {
  static constexpr int kDBytes = kPos * BN * 2;
  static constexpr int kSmem =
      1024 + kStages * (kXBytes + kDBytes) + 2 * kStages * 8;
};

template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
wgrad_wgmma_kernel(const __grid_constant__ CUtensorMap tmx,
                   const __grid_constant__ CUtensorMap tmdy,
                   float* __restrict__ part, int depth, int C, int CO, int KZ,
                   int tiles_w, int tiles_per_plane, int n_tiles,
                   int tiles_per_split) {
  using CF = Cfg<BN>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sx = align_1024(smem_raw);
  uint8_t* sd = sx + kStages * kXBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(sd + kStages * CF::kDBytes);
  uint64_t* empty = full + kStages;

  const int ci_tiles = (C + kCiTile - 1) / kCiTile;
  const int kz = blockIdx.y / ci_tiles;
  const int ci0 = (blockIdx.y % ci_tiles) * kCiTile;
  const int co0 = blockIdx.z * BN;
  const int dz = kz - KZ / 2;
  const int t_begin = blockIdx.x * tiles_per_split;
  const int t_end = min(n_tiles, t_begin + tiles_per_split);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {  // the producer warp; one thread issues the loads
    if (threadIdx.x == kConsumers * 128) {
      int it = 0;
      for (int t = t_begin; t < t_end; ++t) {
        const int n = t / tiles_per_plane;
        const int d = n % depth;
        if (d + dz < 0 || d + dz >= depth) continue;
        const int tt = t % tiles_per_plane;
        const int h0 = (tt / tiles_w) * kTileH;
        const int w0 = (tt % tiles_w) * kTileW;
        const int s = it % kStages;
        if (it >= kStages) mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(&full[s], kHaloBytes + CF::kDBytes);
        tma_load_4d(sx + s * kXBytes, &tmx, &full[s], ci0, w0 - 1, h0 - 1,
                    n + dz);
        tma_load_4d(sd + s * CF::kDBytes, &tmdy, &full[s], co0, w0, h0, n);
        ++it;
      }
    }
    return;
  }

  // consumer warpgroup wg = ky, taps (ky, 0..2)
  float acc[3][BN / 2];
#pragma unroll
  for (int kx = 0; kx < 3; ++kx) {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[kx][i] = 0.f;
    fence_operands(acc[kx]);
  }
  int it = 0;
  for (int t = t_begin; t < t_end; ++t) {
    const int d = (t / tiles_per_plane) % depth;
    if (d + dz < 0 || d + dz >= depth) continue;
    const int s = it % kStages;
    mbar_wait(&full[s], (it / kStages) & 1);
    wgmma_fence();
#pragma unroll
    for (int r = 0; r < kTileH; ++r) {
      // dy rows 16 r .. 16 r + 15, aligned to the swizzle atom
      const uint64_t db = smem_desc(sd + s * CF::kDBytes + r * 16 * BN * 2,
                                    CF::kDBytes, 8 * BN * 2, BN * 2);
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        const uint8_t* xa = sx + s * kXBytes + ((r + wg) * kHaloW + kx) *
                                                   kRowBytes;
        wgmma_m64k16<BN, 1, 1>(
            acc[kx], smem_desc(xa, kXBytes, 8 * kRowBytes, kRowBytes), db);
      }
    }
    wgmma_commit();
    wgmma_wait<1>();
    if (it > 0 && threadIdx.x % 128 == 0)
      mbar_arrive(&empty[(it - 1) % kStages]);
    ++it;
  }
  wgmma_wait<0>();
  const int lane = threadIdx.x % 32;
  const int row0 = ((threadIdx.x % 128) / 32) * 16 + lane / 4;
#pragma unroll
  for (int kx = 0; kx < 3; ++kx) {
    fence_operands(acc[kx]);
    float* out = part + ((size_t)blockIdx.x * KZ * 9 + kz * 9 + wg * 3 + kx) *
                            C * CO;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int ci = ci0 + row0 + 8 * i;
      if (ci >= C) continue;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int co = co0 + 8 * j + 2 * (lane % 4);
        if (co < CO)
          *reinterpret_cast<float2*>(out + (size_t)ci * CO + co) = make_float2(
              acc[kx][4 * j + 2 * i], acc[kx][4 * j + 2 * i + 1]);
      }
    }
  }
}

__global__ void sum_splits_kernel(const float* __restrict__ part,
                                  float* __restrict__ dw, long long m,
                                  int splits) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += part[(size_t)k * m + i];
  dw[i] = s;
}

template <int BN>
int launch(const void* x, const void* dy, float* part, int N, int depth,
           int H, int W, int C, int CO, int KZ, int splits,
           cudaStream_t stream) {
  using CF = Cfg<BN>;
  CUtensorMap tmx, tmdy;
  const cuuint64_t xd[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H,
                            (cuuint64_t)N};
  const cuuint64_t xs[3] = {(cuuint64_t)C * 2, (cuuint64_t)W * C * 2,
                            (cuuint64_t)H * W * C * 2};
  const cuuint32_t xb[4] = {kCiTile, kHaloW, kTileH + 2, 1};
  const cuuint64_t dd[4] = {(cuuint64_t)CO, (cuuint64_t)W, (cuuint64_t)H,
                            (cuuint64_t)N};
  const cuuint64_t ds[3] = {(cuuint64_t)CO * 2, (cuuint64_t)W * CO * 2,
                            (cuuint64_t)H * W * CO * 2};
  const cuuint32_t db[4] = {BN, kTileW, kTileH, 1};
  if (!make_map(&tmx, x, 4, xd, xs, xb) || !make_map(&tmdy, dy, 4, dd, ds, db))
    return static_cast<int>(cudaErrorInvalidValue);
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        wgrad_wgmma_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        CF::kSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const int tiles_w = (W + kTileW - 1) / kTileW;
  const int tiles_per_plane = ((H + kTileH - 1) / kTileH) * tiles_w;
  const int n_tiles = N * tiles_per_plane;
  const int tiles_per_split = (n_tiles + splits - 1) / splits;
  const dim3 grid(splits, KZ * ((C + kCiTile - 1) / kCiTile),
                  (CO + BN - 1) / BN);
  wgrad_wgmma_kernel<BN><<<grid, kThreads, CF::kSmem, stream>>>(
      tmx, tmdy, part, depth, C, CO, KZ, tiles_w, tiles_per_plane, n_tiles,
      tiles_per_split);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (N, H, W, C) and dy (N, H, W, CO) bf16 NHWC, contiguous and 16-byte
// aligned, C % 16 == 0, CO % 8 == 0; dw (KZ, 3, 3, C, CO) f32; scratch holds
// splits * KZ*9*C*CO f32 (unused when splits == 1).  The co tile is 32
// channels for CO <= 32, else 64.  Returns cudaGetLastError() after the
// launches (cudaErrorInvalidValue for arguments the kernels do not take or a
// tensor map that cuTensorMapEncodeTiled refuses).
extern "C" int dgtta_conv3x3_wgrad_wgmma(const void* x, const void* dy,
                                         void* dw, void* scratch, int N,
                                         int depth, int H, int W, int C,
                                         int CO, int KZ, int splits,
                                         void* stream) {
  if (N <= 0 || depth <= 0 || N % depth != 0 || H <= 0 || W <= 0 || C <= 0 ||
      C % 16 != 0 || CO <= 0 || CO % 8 != 0 || (KZ != 1 && KZ != 3) ||
      splits <= 0 || (splits > 1 && scratch == nullptr) ||
      (reinterpret_cast<uintptr_t>(x) & 15) ||
      (reinterpret_cast<uintptr_t>(dy) & 15))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = splits == 1 ? static_cast<float*>(dw)
                            : static_cast<float*>(scratch);
  const int err =
      CO <= 32 ? launch<32>(x, dy, part, N, depth, H, W, C, CO, KZ, splits, s)
               : launch<64>(x, dy, part, N, depth, H, W, C, CO, KZ, splits, s);
  if (err != 0) return err;
  if (splits > 1) {
    const long long m = (long long)KZ * 9 * C * CO;
    const int threads = 256;
    sum_splits_kernel<<<(unsigned)((m + threads - 1) / threads), threads, 0,
                        s>>>(part, static_cast<float*>(dw), m, splits);
  }
  return static_cast<int>(cudaGetLastError());
}
