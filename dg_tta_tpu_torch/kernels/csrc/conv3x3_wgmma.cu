// 3x3 stride-1 pad-1 convolution on NHWC planes, with an optional sum over
// three z-neighbour planes, on Hopper's tensor cores (sm_90a): wgmma fed by
// TMA, in two instantiations of one kernel:
//   * bf16 operands (C % 16 == 0, CO % 8 == 0), bf16 output;
//   * f32 operands (C % 8 == 0, CO % 8 == 0), f32 output, as 3xTF32: every
//     product at f32 accuracy from three tf32 products (below).
//
// Replaces dg_tta_tpu/ops/conv2d_pallas.py::conv3x3_pallas (and with KZ=3 the
// three z-tap calls of it that dg_tta_tpu/models/unet.py::_conv sums) for
// those shapes; conv3x3_c1.cu takes the 1-channel first conv and conv3x3.cu
// the other channel counts.  The same function as conv3x3.cu:
//
//   y[n,h,w,co] = sum_{kz<KZ} sum_{ky,kx<3} sum_{ci<C}
//                   x[n+kz-KZ/2, h+ky-1, w+kx-1, ci] * w[kz,ky,kx,ci,co]
//
// zero-padded in H and W and within the plane's group of `depth` planes,
// f32 accumulation.  The weights come transposed, as wt[kz,ky,kx,co,ci] (the
// wrapper transposes the few MB once per call), so that both operands are
// K-major: ci is contiguous in x and in wt.
//
// What bounds it on an H100: 2*27*C*CO operations per output voxel against
// (C + CO) elements of traffic, hundreds of operations per byte: bound by
// the tensor cores.  bf16 runs at 989 TFLOP/s.  f32 has no tensor-core type
// of its own, and TF32 alone keeps ~3 decimal digits, so the f32 route splits
// each operand v into hi = tf32(v) and lo = tf32(v - hi) and sums
// a_hi*b_hi + a_hi*b_lo + a_lo*b_hi (dropping a_lo*b_lo, ~2^-22 of the
// product): three tf32 products at 495 TFLOP/s, so its bound is
// 3 * ops / 495e12 s, against ops / 67e12 s on the CUDA cores (conv3x3.cu).
//
// What the design does about it: an implicit GEMM.  M = a tile of 8 x 16
// output pixels of one plane n, N = a tile of BN output channels, K = 27 x C
// walked as (kz, ky, kx, chunk of KC input channels).  Per K step one
// producer thread issues TMA loads into a ring of kStages shared-memory
// stages: the shifted NHWC box x[n+dz, h0+ky-1 : +8, w0+kx-1 : +16,
// ci0 : +KC] (TMA's out-of-bounds zero fill is the H/W zero padding) and the
// weight slice wt[tap, co0 : +BN, ci0 : +KC] (f32: wt_hi and wt_lo); an
// mbarrier counts the bytes in.  A row of KC elements is 32, 64 or 128
// bytes (KC = 16/32/64 bf16, 8/16/32 f32) and sets the swizzle; one wgmma
// step eats 32 bytes of K in either type (k16 bf16, k8 tf32), so the
// descriptors and their per-step advance are the same bytes.  Two consumer
// warpgroups (64 pixel rows each) issue the wgmmas of a stage on the
// swizzled tiles and keep one wgmma group in flight; a stage goes back to
// the producer when its group has retired.  A z-tap whose plane lies outside
// the group is skipped by the whole block (TMA cannot: that plane exists in
// memory and belongs to the next volume).  The epilogue skips rows past H
// and W.
//
// The f32 split.  The weights are split once per call by the wrapper (a
// plain tensor op on a few MB: wt_hi = wt rounded to tf32, wt_lo = wt -
// wt_hi exactly) and both are TMA-loaded per stage.  The activations are
// split in the consumer: for 32-bit types wgmma takes A from shared memory
// only K-major and without conversion, so each thread loads its A fragment
// (4 values per k8 step) from the swizzled tile into registers, rounds
// hi = cvt.rna.tf32(a), lo = cvt.rna.tf32(a - hi), and issues
// (lo, B_hi), (hi, B_lo), (hi, B_hi) with A from registers.  Rewriting the
// tile in shared memory as hi and lo halves instead would cost a third tile
// per stage, shared-memory bandwidth, and a generic-to-async proxy fence
// before every wgmma.  The fragments are double-buffered (stage it fills
// one set while the group of stage it - 1 still reads the other).  What the
// split costs: three wgmmas per step instead of one, a second weight tile
// per stage (B_lo), and per thread 16 shared loads, 32 conversions and 16
// subtractions per 32-channel stage.  Accuracy: the tensor cores add each
// step's products into the f32 accumulator with truncation, not rounding;
// over K = 27 x 512 that drifts to ~1e-4 of the output's range, above the
// route's 5e-5.  So every kPromote stages (512 K at KC = 32) the consumers
// drain their wgmmas, add the accumulator into a second f32 register tile
// (rounded adds) and restart it from zero.

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
constexpr int kPromote = 16;  // f32: stages between accumulator promotions

template <typename T>
struct Elem;
template <>
struct Elem<__nv_bfloat16> {
  static constexpr CUtensorMapDataType kMap = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
};
template <>
struct Elem<float> {
  static constexpr CUtensorMapDataType kMap = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
};

template <typename T, int BN, int KC>
struct Cfg {
  static constexpr bool kSplit = sizeof(T) == 4;  // 3xTF32
  static constexpr int kSpan = KC * sizeof(T);    // bytes per smem row
  static constexpr int kABytes = kRows * kSpan;
  static constexpr int kBBytes = BN * kSpan;      // one weight operand
  static constexpr int kBOps = kSplit ? 2 : 1;    // f32: wt_hi, wt_lo
  static constexpr int kStageB = kBOps * kBBytes;
  static constexpr int kSteps = KC * sizeof(T) / 32;  // wgmma steps / stage
  static constexpr int kSmem =
      1024 + kStages * (kABytes + kStageB) + 2 * kStages * 8;
};

__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a,
                                           float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// Writes the warpgroup's 64 x BN accumulator tile, skipping rows past H and
// W and channels past CO.
template <typename T, int BN>
__device__ __forceinline__ void store_tile(T* __restrict__ y,
                                           const float (&acc)[BN / 2], int n,
                                           int h0, int w0, int co0, int wg,
                                           int H, int W, int CO) {
  const int lane = threadIdx.x % 32;
  const int row0 = wg * 64 + ((threadIdx.x % 128) / 32) * 16 + lane / 4;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + 8 * i;
    const int h = h0 + r / kTileW, w = w0 + r % kTileW;
    if (h >= H || w >= W) continue;
    T* yp = y + (((size_t)n * H + h) * W + w) * CO;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int co = co0 + 8 * j + 2 * (lane % 4);
      if (co < CO)
        store_pair(yp + co, acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
    }
  }
}

template <typename T, int BN, int KC>
__global__ void __launch_bounds__(kThreads, 1)
conv3x3_wgmma_kernel(const __grid_constant__ CUtensorMap tmx,
                     const __grid_constant__ CUtensorMap tmw,
                     const __grid_constant__ CUtensorMap tmw_lo,
                     T* __restrict__ y, int depth, int H, int W, int C,
                     int CO, int KZ, int tiles_w) {
  using CF = Cfg<T, BN, KC>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sa = align_1024(smem_raw);
  uint8_t* sb = sa + kStages * CF::kABytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(sb + kStages * CF::kStageB);
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
        uint8_t* b = sb + s * CF::kStageB;
        mbar_expect_tx(&full[s], CF::kABytes + CF::kStageB);
        tma_load_4d(sa + s * CF::kABytes, &tmx, &full[s], ch * KC,
                    w0 + tap % 3 - 1, h0 + tap / 3 - 1, n + kz - KZ / 2);
        tma_load_3d(b, &tmw, &full[s], ch * KC, co0, kz * 9 + tap);
        if constexpr (CF::kSplit)
          tma_load_3d(b + CF::kBBytes, &tmw_lo, &full[s], ch * KC, co0,
                      kz * 9 + tap);
      }
    }
    return;
  }

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  fence_operands(acc);

  if constexpr (!CF::kSplit) {
    const int a_off = wg * 64 * CF::kSpan;
    for (int it = 0; it < total; ++it) {
      const int s = it % kStages;
      mbar_wait(&full[s], (it / kStages) & 1);
      const uint64_t da = smem_desc(sa + s * CF::kABytes + a_off, 16,
                                    8 * CF::kSpan, CF::kSpan);
      const uint64_t db =
          smem_desc(sb + s * CF::kStageB, 16, 8 * CF::kSpan, CF::kSpan);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < CF::kSteps; ++k)  // 16 bf16 along K = 32 bytes
        wgmma_m64k16<BN, 0, 0>(acc, da + 2 * k, db + 2 * k);
      wgmma_commit();
      wgmma_wait<1>();
      if (it > 0 && threadIdx.x % 128 == 0)
        mbar_arrive(&empty[(it - 1) % kStages]);
    }
    wgmma_wait<0>();
    fence_operands(acc);
    store_tile<T, BN>(y, acc, n, h0, w0, co0, wg, H, W, CO);
  } else {
    // 3xTF32.  This thread's A rows within the 128-row tile and its first
    // column within a k8 step (wgmma_m64k8_tf32's register layout).
    const int lane = threadIdx.x % 32;
    const int r0 = wg * 64 + ((threadIdx.x % 128) / 32) * 16 + lane / 4;
    constexpr int kMask = CF::kSpan / 16 - 1;  // swizzle: 128 B -> 7, ...
    float tot[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) tot[i] = 0.f;
    // [buffer][k step][hi, lo][register]
    uint32_t frag[2][CF::kSteps][2][4];

    auto stage = [&](int it, uint32_t (&f)[CF::kSteps][2][4]) {
      const int s = it % kStages;
      mbar_wait(&full[s], (it / kStages) & 1);
      const uint8_t* a = sa + s * CF::kABytes;
#pragma unroll
      for (int k = 0; k < CF::kSteps; ++k) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int off = (r0 + 8 * (q & 1)) * CF::kSpan +
                          (8 * k + lane % 4 + 4 * (q >> 1)) * 4;
          const float v = *reinterpret_cast<const float*>(
              a + (off ^ (((off >> 7) & kMask) << 4)));
          const uint32_t hi = cvt_tf32(v);
          f[k][0][q] = hi;
          f[k][1][q] = cvt_tf32(v - __uint_as_float(hi));
        }
      }
      const uint64_t db =
          smem_desc(sb + s * CF::kStageB, 16, 8 * CF::kSpan, CF::kSpan);
      const uint64_t db_lo = smem_desc(sb + s * CF::kStageB + CF::kBBytes,
                                       16, 8 * CF::kSpan, CF::kSpan);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < CF::kSteps; ++k) {  // 8 tf32 along K = 32 bytes
        wgmma_m64k8_tf32<BN>(acc, f[k][1], db + 2 * k);
        wgmma_m64k8_tf32<BN>(acc, f[k][0], db_lo + 2 * k);
        wgmma_m64k8_tf32<BN>(acc, f[k][0], db + 2 * k);
      }
      wgmma_commit();
      wgmma_wait<1>();
      if (it > 0 && threadIdx.x % 128 == 0)
        mbar_arrive(&empty[(it - 1) % kStages]);
      if ((it + 1) % kPromote == 0) {
        wgmma_wait<0>();
        fence_operands(acc);
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) {
          tot[i] += acc[i];
          acc[i] = 0.f;
        }
        fence_operands(acc);
      }
    };

    for (int it = 0; it < total; it += 2) {
      stage(it, frag[0]);
      if (it + 1 < total) stage(it + 1, frag[1]);
    }
    wgmma_wait<0>();
    fence_operands(acc);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) tot[i] += acc[i];
    store_tile<T, BN>(y, tot, n, h0, w0, co0, wg, H, W, CO);
  }
}

template <typename T, int BN, int KC>
int launch(const void* x, const void* wt, const void* wt_lo, void* y, int N,
           int depth, int H, int W, int C, int CO, int KZ,
           cudaStream_t stream) {
  using CF = Cfg<T, BN, KC>;
  constexpr CUtensorMapDataType kType = Elem<T>::kMap;
  constexpr int e = sizeof(T);
  CUtensorMap tmx, tmw, tmw_lo;
  const cuuint64_t xd[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H,
                            (cuuint64_t)N};
  const cuuint64_t xs[3] = {(cuuint64_t)C * e, (cuuint64_t)W * C * e,
                            (cuuint64_t)H * W * C * e};
  const cuuint32_t xb[4] = {KC, kTileW, kTileH, 1};
  const cuuint64_t wd[3] = {(cuuint64_t)C, (cuuint64_t)CO,
                            (cuuint64_t)KZ * 9};
  const cuuint64_t ws[2] = {(cuuint64_t)C * e, (cuuint64_t)CO * C * e};
  const cuuint32_t wb[3] = {KC, BN, 1};
  if (!make_map(&tmx, x, 4, xd, xs, xb, kType, e) ||
      !make_map(&tmw, wt, 3, wd, ws, wb, kType, e) ||
      !make_map(&tmw_lo, CF::kSplit ? wt_lo : wt, 3, wd, ws, wb, kType, e))
    return static_cast<int>(cudaErrorInvalidValue);
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        conv3x3_wgmma_kernel<T, BN, KC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, CF::kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const int tiles_w = (W + kTileW - 1) / kTileW;
  const int tiles_h = (H + kTileH - 1) / kTileH;
  const dim3 grid(tiles_h * tiles_w, (CO + BN - 1) / BN, N);
  conv3x3_wgmma_kernel<T, BN, KC><<<grid, kThreads, CF::kSmem, stream>>>(
      tmx, tmw, tmw_lo, static_cast<T*>(y), depth, H, W, C, CO, KZ, tiles_w);
  return static_cast<int>(cudaGetLastError());
}

// The channel chunk KC: the widest 128-byte row that divides C, else 64 or
// 32 bytes.
template <typename T, int BN>
int launch_kc(const void* x, const void* wt, const void* wt_lo, void* y,
              int N, int depth, int H, int W, int C, int CO, int KZ,
              cudaStream_t s) {
  constexpr int k128 = 128 / sizeof(T);
  if (C % k128 == 0)
    return launch<T, BN, k128>(x, wt, wt_lo, y, N, depth, H, W, C, CO, KZ, s);
  if (C % (k128 / 2) == 0)
    return launch<T, BN, k128 / 2>(x, wt, wt_lo, y, N, depth, H, W, C, CO,
                                   KZ, s);
  return launch<T, BN, k128 / 4>(x, wt, wt_lo, y, N, depth, H, W, C, CO, KZ,
                                 s);
}

bool misaligned(const void* p) {
  return reinterpret_cast<uintptr_t>(p) & 15;
}

}  // namespace

// x (N, H, W, C) and y (N, H, W, CO) NHWC, wt (KZ, 3, 3, CO, C), all
// contiguous and 16-byte aligned, of one type: dtype 1 = bf16 with
// C % 16 == 0 (wt_lo unused, may be null), dtype 0 = f32 with C % 8 == 0,
// wt = the weights rounded to tf32 and wt_lo = the remainder, same layout.
// CO % 8 == 0.  The output tile is 32 channels for CO <= 32; else 64, and
// 128 in bf16 where CO is a multiple of 128 (f32 keeps 64: its second
// accumulator tile needs the registers).  Returns cudaGetLastError() after
// the launch (cudaErrorInvalidValue for arguments the kernel does not take
// or a tensor map that cuTensorMapEncodeTiled refuses).
extern "C" int dgtta_conv3x3_wgmma(const void* x, const void* wt,
                                   const void* wt_lo, void* y, int N,
                                   int depth, int H, int W, int C, int CO,
                                   int KZ, int dtype, void* stream) {
  const bool f32 = dtype == 0;
  if (N <= 0 || depth <= 0 || N % depth != 0 || H <= 0 || W <= 0 || C <= 0 ||
      C % (f32 ? 8 : 16) != 0 || CO <= 0 || CO % 8 != 0 ||
      (KZ != 1 && KZ != 3) || (dtype != 0 && dtype != 1) || N > 65535 ||
      misaligned(x) || misaligned(wt) || misaligned(y) ||
      (f32 && (wt_lo == nullptr || misaligned(wt_lo))))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f32) {
    if (CO <= 32)
      return launch_kc<float, 32>(x, wt, wt_lo, y, N, depth, H, W, C, CO, KZ,
                                  s);
    return launch_kc<float, 64>(x, wt, wt_lo, y, N, depth, H, W, C, CO, KZ,
                                s);
  }
  using bf16 = __nv_bfloat16;
  if (CO <= 32)
    return launch_kc<bf16, 32>(x, wt, wt_lo, y, N, depth, H, W, C, CO, KZ, s);
  if (CO % 128 == 0)
    return launch_kc<bf16, 128>(x, wt, wt_lo, y, N, depth, H, W, C, CO, KZ,
                                s);
  return launch_kc<bf16, 64>(x, wt, wt_lo, y, N, depth, H, W, C, CO, KZ, s);
}
