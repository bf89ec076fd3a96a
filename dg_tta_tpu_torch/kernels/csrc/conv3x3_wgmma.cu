// bf16 3x3 stride-1 pad-1 convolution on NHWC planes, with an optional sum
// over three z-neighbour planes, on Hopper's tensor cores (sm_90a): wgmma fed
// by TMA.
//
// Replaces dg_tta_tpu/ops/conv2d_pallas.py::conv3x3_pallas (and with KZ=3 the
// three z-tap calls of it that dg_tta_tpu/models/unet.py::_conv sums) for
// bf16 operands with C % 16 == 0 and CO % 8 == 0; conv3x3.cu keeps f32 and
// the other channel counts.  The same function as conv3x3.cu:
//
//   y[n,h,w,co] = sum_{kz<KZ} sum_{ky,kx<3} sum_{ci<C}
//                   x[n+kz-KZ/2, h+ky-1, w+kx-1, ci] * w[kz,ky,kx,ci,co]
//
// zero-padded in H and W and within the plane's group of `depth` planes,
// f32 accumulation, bf16 output.  The weights come transposed, as
// wt[kz,ky,kx,co,ci] (the wrapper transposes the few MB once per call), so
// that both operands are K-major: ci is contiguous in x and in wt.
//
// What bounds it on an H100: 2*27*C*CO operations per output voxel against
// (C + CO) * 2 bytes of traffic, hundreds of operations per byte: bound by
// the tensor cores (989 TFLOP/s bf16), which conv3x3.cu leaves idle (it
// widens bf16 to f32 and runs FMAs on the CUDA cores, 67 TFLOP/s).
//
// What the design does about it: an implicit GEMM.  M = a tile of 8 x 16
// output pixels of one plane n, N = a tile of BN output channels, K = 27 x C
// walked as (kz, ky, kx, chunk of KC input channels).  Per K step one
// producer thread issues two TMA loads into a ring of kStages shared-memory
// stages: the shifted NHWC box x[n+dz, h0+ky-1 : +8, w0+kx-1 : +16,
// ci0 : +KC] (TMA's out-of-bounds zero fill is the H/W zero padding) and the
// weight slice wt[tap, co0 : +BN, ci0 : +KC]; an mbarrier counts the bytes
// in.  Two consumer warpgroups (64 pixel rows each) issue KC/16 wgmma
// m64nBNk16 per stage on the swizzled tiles and keep one wgmma group in
// flight; a stage goes back to the producer when its group has retired.  A
// z-tap whose plane lies outside the group is skipped by the whole block (TMA
// cannot: that plane exists in memory and belongs to the next volume).  The
// epilogue rounds the f32 accumulators to bf16 and skips rows past H and W.
// KC = 64, 32 or 16 (the largest that divides C) sets the swizzle: 128, 64 or
// 32 bytes per row.

#include <cuda_bf16.h>
#include <stddef.h>

#include "hopper.cuh"

namespace {

using namespace dgtta;

constexpr int kTileH = 8;
constexpr int kTileW = 16;
constexpr int kRows = kTileH * kTileW;  // pixels per block (GEMM M tile)
constexpr int kConsumers = 2;           // warpgroups, 64 rows each
constexpr int kThreads = kConsumers * 128 + 32;
constexpr int kStages = 4;

template <int BN, int KC>
struct Cfg {
  static constexpr int kABytes = kRows * KC * 2;
  static constexpr int kBBytes = BN * KC * 2;
  static constexpr int kSpan = KC * 2;  // bytes per smem row = swizzle
  static constexpr int kSmem =
      1024 + kStages * (kABytes + kBBytes) + 2 * kStages * 8;
};

template <int BN, int KC>
__global__ void __launch_bounds__(kThreads, 1)
conv3x3_wgmma_kernel(const __grid_constant__ CUtensorMap tmx,
                     const __grid_constant__ CUtensorMap tmw,
                     __nv_bfloat16* __restrict__ y, int depth, int H, int W,
                     int C, int CO, int KZ, int tiles_w) {
  using CF = Cfg<BN, KC>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sa = align_1024(smem_raw);
  uint8_t* sb = sa + kStages * CF::kABytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(sb + kStages * CF::kBBytes);
  uint64_t* empty = full + kStages;

  const int n = blockIdx.z;
  const int d = n % depth;
  const int h0 = (blockIdx.x / tiles_w) * kTileH;
  const int w0 = (blockIdx.x % tiles_w) * kTileW;
  const int co0 = blockIdx.y * BN;
  // z-taps whose plane lies inside the group (uniform over the block)
  const int kz_lo = (KZ == 3 && d == 0) ? 1 : 0;
  const int kz_hi = (KZ == 3 && d == depth - 1) ? 1 : KZ - 1;
  const int nch = C / KC;
  const int total = (kz_hi - kz_lo + 1) * 9 * nch;

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
      for (int it = 0; it < total; ++it) {
        const int s = it % kStages;
        if (it >= kStages) mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
        const int ch = it % nch;
        const int tap = (it / nch) % 9;
        const int kz = kz_lo + it / (9 * nch);
        mbar_expect_tx(&full[s], CF::kABytes + CF::kBBytes);
        tma_load_4d(sa + s * CF::kABytes, &tmx, &full[s], ch * KC,
                    w0 + tap % 3 - 1, h0 + tap / 3 - 1, n + kz - KZ / 2);
        tma_load_3d(sb + s * CF::kBBytes, &tmw, &full[s], ch * KC, co0,
                    kz * 9 + tap);
      }
    }
    return;
  }

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  fence_operands(acc);
  const int a_off = wg * 64 * CF::kSpan;
  for (int it = 0; it < total; ++it) {
    const int s = it % kStages;
    mbar_wait(&full[s], (it / kStages) & 1);
    const uint64_t da =
        smem_desc(sa + s * CF::kABytes + a_off, 16, 8 * CF::kSpan, CF::kSpan);
    const uint64_t db =
        smem_desc(sb + s * CF::kBBytes, 16, 8 * CF::kSpan, CF::kSpan);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < KC / 16; ++k)  // 16 bf16 along K = 32 bytes
      wgmma_m64k16<BN, 0, 0>(acc, da + 2 * k, db + 2 * k);
    wgmma_commit();
    wgmma_wait<1>();
    if (it > 0 && threadIdx.x % 128 == 0)
      mbar_arrive(&empty[(it - 1) % kStages]);
  }
  wgmma_wait<0>();
  fence_operands(acc);

  const int lane = threadIdx.x % 32;
  const int row0 = wg * 64 + ((threadIdx.x % 128) / 32) * 16 + lane / 4;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + 8 * i;
    const int h = h0 + r / kTileW, w = w0 + r % kTileW;
    if (h >= H || w >= W) continue;
    __nv_bfloat16* yp = y + (((size_t)n * H + h) * W + w) * CO;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int co = co0 + 8 * j + 2 * (lane % 4);
      if (co < CO)
        *reinterpret_cast<__nv_bfloat162*>(yp + co) =
            __floats2bfloat162_rn(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
    }
  }
}

template <int BN, int KC>
int launch(const void* x, const void* wt, void* y, int N, int depth, int H,
           int W, int C, int CO, int KZ, cudaStream_t stream) {
  using CF = Cfg<BN, KC>;
  CUtensorMap tmx, tmw;
  const cuuint64_t xd[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H,
                            (cuuint64_t)N};
  const cuuint64_t xs[3] = {(cuuint64_t)C * 2, (cuuint64_t)W * C * 2,
                            (cuuint64_t)H * W * C * 2};
  const cuuint32_t xb[4] = {KC, kTileW, kTileH, 1};
  const cuuint64_t wd[3] = {(cuuint64_t)C, (cuuint64_t)CO,
                            (cuuint64_t)KZ * 9};
  const cuuint64_t ws[2] = {(cuuint64_t)C * 2, (cuuint64_t)CO * C * 2};
  const cuuint32_t wb[3] = {KC, BN, 1};
  if (!make_map(&tmx, x, 4, xd, xs, xb) || !make_map(&tmw, wt, 3, wd, ws, wb))
    return static_cast<int>(cudaErrorInvalidValue);
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        conv3x3_wgmma_kernel<BN, KC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, CF::kSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const int tiles_w = (W + kTileW - 1) / kTileW;
  const int tiles_h = (H + kTileH - 1) / kTileH;
  const dim3 grid(tiles_h * tiles_w, (CO + BN - 1) / BN, N);
  conv3x3_wgmma_kernel<BN, KC><<<grid, kThreads, CF::kSmem, stream>>>(
      tmx, tmw, static_cast<__nv_bfloat16*>(y), depth, H, W, C, CO, KZ,
      tiles_w);
  return static_cast<int>(cudaGetLastError());
}

template <int BN>
int launch_kc(const void* x, const void* wt, void* y, int N, int depth, int H,
              int W, int C, int CO, int KZ, cudaStream_t s) {
  if (C % 64 == 0)
    return launch<BN, 64>(x, wt, y, N, depth, H, W, C, CO, KZ, s);
  if (C % 32 == 0)
    return launch<BN, 32>(x, wt, y, N, depth, H, W, C, CO, KZ, s);
  return launch<BN, 16>(x, wt, y, N, depth, H, W, C, CO, KZ, s);
}

}  // namespace

// x (N, H, W, C) and y (N, H, W, CO) bf16 NHWC, wt (KZ, 3, 3, CO, C) bf16,
// all contiguous and 16-byte aligned; C % 16 == 0, CO % 8 == 0.  The output
// tile is 32 channels for CO <= 32, 128 where CO is a multiple of 128, else
// 64.  Returns cudaGetLastError() after the launch (cudaErrorInvalidValue
// for arguments the kernel does not take or a tensor map that
// cuTensorMapEncodeTiled refuses).
extern "C" int dgtta_conv3x3_wgmma(const void* x, const void* wt, void* y,
                                   int N, int depth, int H, int W, int C,
                                   int CO, int KZ, void* stream) {
  if (N <= 0 || depth <= 0 || N % depth != 0 || H <= 0 || W <= 0 || C <= 0 ||
      C % 16 != 0 || CO <= 0 || CO % 8 != 0 || (KZ != 1 && KZ != 3) ||
      N > 65535 || (reinterpret_cast<uintptr_t>(x) & 15) ||
      (reinterpret_cast<uintptr_t>(wt) & 15) ||
      (reinterpret_cast<uintptr_t>(y) & 15))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (CO <= 32) return launch_kc<32>(x, wt, y, N, depth, H, W, C, CO, KZ, s);
  if (CO % 128 == 0)
    return launch_kc<128>(x, wt, y, N, depth, H, W, C, CO, KZ, s);
  return launch_kc<64>(x, wt, y, N, depth, H, W, C, CO, KZ, s);
}
