// f32 weight gradient of the stride-1 3x3(x3) convolution, on Hopper's
// tensor cores (sm_90a) as 3xTF32: wgmma fed by TMA, split over positions.
//
// The backward of dg_tta_tpu/ops/conv2d_pallas.py::conv3x3_pallas, which the
// TPU package left to XLA's conv transpose, for f32 x and dy with
// C % 8 == 0 and CO % 8 == 0; conv3x3_wgrad.cu keeps the other channel
// counts, conv3x3_c1.cu C = 1, conv3x3_wgrad_wgmma.cu bf16.  The same
// function as conv3x3_wgrad.cu:
//
//   dW[kz,ky,kx,ci,co] = sum_{n,h,w} x[n+kz-KZ/2, h+ky-1, w+kx-1, ci]
//                                    * dy[n,h,w,co]
//
// zero-padded as the forward pads, f32 sums and f32 dW.
//
// What bounds it on an H100: 2*27*C*CO operations per position against
// (C + CO) * 4 bytes read: the arithmetic.  f32 has no tensor-core type of
// its own; as in conv3x3_wgmma.cu every product is taken from three tf32
// products (a_hi b_hi + a_hi b_lo + a_lo b_hi, 495 TFLOP/s), so the bound is
// 3 * ops / 495e12 s against ops / 67e12 s for the f32 FMAs of
// conv3x3_wgrad.cu.
//
// What the design does about it.  Per kz, dW is a (9 C) x CO matrix whose
// rows are (tap, ci) pairs: a GEMM with M = (tap, ci), N = co, K =
// positions.  For 32-bit types wgmma reads shared-memory operands only
// K-major, and NHWC x and dy are channel-contiguous (MN-major), so:
//   * A = x comes from registers.  Per 4 x 16 position tile one TMA load
//     brings the zero-padded 6 x 18 halo of x [n+dz, h0-1 : +6, w0-1 : +18,
//     ci0 : +32] (one 128-byte swizzled row per position; out-of-bounds zero
//     fill is the H/W padding, channels past C read zeros) and every thread
//     loads its fragment of the nine shifted taps from it by hand (the
//     swizzle XOR in the address), then splits it with cvt.rna.tf32 into hi
//     and lo.  A register fragment may start at any halo row, which no
//     shared-memory descriptor could (a tap shifts K by ky*18 + kx rows).
//   * B = dy comes K-major from a pre-pass: split_transpose_kernel reads dy
//     once and writes dyT_hi = tf32(dy) and dyT_lo = dy - dyT_hi as
//     (N, H, CO, Wp) rows, positions contiguous (a bytes-bound pass; its
//     time counts in the route's).  Per tile TMA loads both as
//     [h][co][16 w] boxes with the 64-byte swizzle; a k8 step of positions
//     (h, 8 w) is a 32-byte column of that box.
// M tiles.  The 32 channels of a block and its nine taps make 288 rows:
// five m64 tiles of two taps x 32 channels each, the fifth half padding
// (its rows read zeros and are not stored).  Each of five consumer
// warpgroups owns one tile, so a warp's four fragment rows lie in one tap;
// the output tile is BN = 32 channels (a 16-register accumulator, and 16
// more for the promotion below).  Per k8 step a warpgroup issues
// (lo, B_hi), (hi, B_lo), (hi, B_hi) as one group and keeps one group in
// flight; the fragments are double-buffered.  One producer thread keeps a
// ring of kStages stages full (halo, dyT_hi and dyT_lo of a tile, counted
// in bytes on an mbarrier); a stage goes back when the group of its last
// step has retired.  A tile whose x plane lies outside the group is skipped
// by the whole block.
// Accuracy.  The tensor cores add each step into the f32 accumulator with
// truncation; a block sums up to ~37k positions at the TS104 shapes.  Every
// kPromote stages (512 positions) the consumers drain their wgmmas, add the
// accumulator into a second f32 register tile with rounded adds, and
// restart it (tests/test_torch_conv3x3.py models this).  Each block writes
// its partial sums to its own slice of a scratch buffer and a second kernel
// adds the slices in a fixed order: deterministic, no atomics.  With one
// split the first kernel writes dW directly.

#include <cuda_runtime.h>
#include <stddef.h>

#include "hopper.cuh"

namespace {

using namespace dgtta;

constexpr int kTileH = 4;
constexpr int kTileW = 16;
constexpr int kHaloW = kTileW + 2;
constexpr int kPos = kTileH * kTileW;   // positions per stage (GEMM K step)
constexpr int kCi = 32;                 // input channels per block
constexpr int kRowBytes = kCi * 4;      // one halo position in smem
constexpr int kBN = 32;                 // output channels per block
constexpr int kConsumers = 5;           // warpgroups: M tiles of taps 2j, 2j+1
constexpr int kThreads = kConsumers * 128 + 32;
constexpr int kStages = 4;
constexpr int kSteps = kPos / 8;        // k8 steps per stage
constexpr int kPromote = 8;             // stages between accumulator promotions
// the (4 + 2) x 18 halo, rounded up to the 1024-byte swizzle atom
constexpr int kHaloBytes = (kTileH + 2) * kHaloW * kRowBytes;
constexpr int kXBytes = (kHaloBytes + 1023) / 1024 * 1024;
constexpr int kDRow = kTileW * 4;       // one (h, co) row of a dyT box
constexpr int kDBytes = kPos * kBN * 4;  // one of dyT_hi, dyT_lo
constexpr int kStageBytes = kXBytes + 2 * kDBytes;
constexpr int kSmem = 1024 + kStages * kStageBytes + 2 * kStages * 8;

// dyT_hi[n,h,co,w] = tf32(dy[n,h,w,co]) and dyT_lo = dy - dyT_hi, rows of Wp
// floats (Wp = W rounded up to 4, so that TMA's row stride is a multiple of
// 16 bytes).  A 32 x 32 (w, co) tile per block through shared memory: the
// reads are coalesced along co, the writes along w.  The N * H rows stride
// over blockIdx.z (at most 65535 blocks there: a grouped TTA step's top
// level has 8 x 112 x 112 rows).
__global__ void __launch_bounds__(256)
split_transpose_kernel(const float* __restrict__ dy, float* __restrict__ hi,
                       float* __restrict__ lo, int W, int CO, int Wp,
                       long long NH) {
  __shared__ float t[32][33];
  const int w0 = blockIdx.x * 32, co0 = blockIdx.y * 32;
  for (size_t nh = blockIdx.z; nh < (size_t)NH; nh += gridDim.z) {
    const float* src = dy + nh * W * CO;   // row n * H + h
    for (int i = threadIdx.y; i < 32; i += 8) {
      const int w = w0 + i, co = co0 + threadIdx.x;
      t[i][threadIdx.x] = (w < W && co < CO) ? src[(size_t)w * CO + co] : 0.f;
    }
    __syncthreads();
    for (int i = threadIdx.y; i < 32; i += 8) {
      const int co = co0 + i, w = w0 + threadIdx.x;
      if (co >= CO || w >= Wp) continue;
      const float v = t[threadIdx.x][i];
      const float h = __uint_as_float(cvt_tf32(v));
      const size_t o = (nh * CO + co) * Wp + w;
      hi[o] = h;
      lo[o] = __fsub_rn(v, h);
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads, 1)
wgrad_tf32x3_kernel(const __grid_constant__ CUtensorMap tmx,
                    const __grid_constant__ CUtensorMap tmhi,
                    const __grid_constant__ CUtensorMap tmlo,
                    float* __restrict__ part, int depth, int C, int CO,
                    int KZ, int tiles_w, int tiles_per_plane, int n_tiles,
                    int tiles_per_split) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* st = align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(st + kStages * kStageBytes);
  uint64_t* empty = full + kStages;

  const int ci_tiles = (C + kCi - 1) / kCi;
  const int kz = blockIdx.y / ci_tiles;
  const int ci0 = (blockIdx.y % ci_tiles) * kCi;
  const int co0 = blockIdx.z * kBN;
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
        uint8_t* b = st + s * kStageBytes;
        mbar_expect_tx(&full[s], kHaloBytes + 2 * kDBytes);
        tma_load_4d(b, &tmx, &full[s], ci0, w0 - 1, h0 - 1, n + dz);
        tma_load_4d(b + kXBytes, &tmhi, &full[s], w0, co0, h0, n);
        tma_load_4d(b + kXBytes + kDBytes, &tmlo, &full[s], w0, co0, h0, n);
        ++it;
      }
    }
    return;
  }

  // consumer warpgroup wg: M rows (tap 2 wg + warp / 2, ci); tap 9 pads
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int tap = 2 * wg + warp / 2;
  const bool live = tap < 9;
  const int ky = tap / 3, kx = tap % 3;
  const int ci = 16 * (warp % 2) + lane / 4;  // fragment rows ci, ci + 8
  const int kk = lane % 4;                    // fragment columns kk, kk + 4
  float acc[kBN / 2], tot[kBN / 2];
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) acc[i] = tot[i] = 0.f;
  fence_operands(acc);
  uint32_t frag[2][2][4];  // [buffer][hi, lo][register]
#pragma unroll
  for (int b = 0; b < 2; ++b)
#pragma unroll
    for (int q = 0; q < 4; ++q) frag[b][0][q] = frag[b][1][q] = 0u;

  int it = 0;
  for (int t = t_begin; t < t_end; ++t) {
    const int d = (t / tiles_per_plane) % depth;
    if (d + dz < 0 || d + dz >= depth) continue;
    const int s = it % kStages;
    mbar_wait(&full[s], (it / kStages) & 1);
    const uint8_t* xs = st + s * kStageBytes;
    const uint8_t* dh = xs + kXBytes;
    const uint8_t* dl = dh + kDBytes;
#pragma unroll
    for (int k = 0; k < kSteps; ++k) {
      // k8 step k: positions (h = k / 2, w = 8 (k % 2) .. + 7) of the tile
      uint32_t(&f)[2][4] = frag[k & 1];
      if (live) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int hr = (k / 2 + ky) * kHaloW + 8 * (k % 2) + kk +
                         4 * (q >> 1) + kx;
          const int off = hr * kRowBytes + (ci + 8 * (q & 1)) * 4;
          const float v = *reinterpret_cast<const float*>(
              xs + (off ^ (((off >> 7) & 7) << 4)));
          const uint32_t h = cvt_tf32(v);
          f[0][q] = h;
          f[1][q] = cvt_tf32(__fsub_rn(v, __uint_as_float(h)));
        }
      }
      const int boff = (k / 2) * kBN * kDRow + (k % 2) * 32;
      const uint64_t bh = smem_desc(dh + boff, 16, 8 * kDRow, kDRow);
      const uint64_t bl = smem_desc(dl + boff, 16, 8 * kDRow, kDRow);
      wgmma_fence();
      wgmma_m64k8_tf32<kBN>(acc, f[1], bh);
      wgmma_m64k8_tf32<kBN>(acc, f[0], bl);
      wgmma_m64k8_tf32<kBN>(acc, f[0], bh);
      wgmma_commit();
      wgmma_wait<1>();
      // the group of the previous step has retired: its fragments are free
      // (the fence keeps them live until here), and at the first step of a
      // stage so is the previous stage
      fence_regs(frag[(k + 1) & 1][0]);
      fence_regs(frag[(k + 1) & 1][1]);
      if (k == 0 && it > 0 && threadIdx.x % 128 == 0)
        mbar_arrive(&empty[(it - 1) % kStages]);
    }
    if ((it + 1) % kPromote == 0) {
      wgmma_wait<0>();
      fence_operands(acc);
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i) {
        tot[i] += acc[i];
        acc[i] = 0.f;
      }
      fence_operands(acc);
    }
    ++it;
  }
  wgmma_wait<0>();
  fence_operands(acc);
  if (!live) return;
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) tot[i] += acc[i];
  float* out = part + ((size_t)blockIdx.x * KZ * 9 + kz * 9 + tap) * C * CO;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = ci0 + ci + 8 * i;
    if (c >= C) continue;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int co = co0 + 8 * j + 2 * kk;
      if (co < CO)
        *reinterpret_cast<float2*>(out + (size_t)c * CO + co) =
            make_float2(tot[4 * j + 2 * i], tot[4 * j + 2 * i + 1]);
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

bool misaligned(const void* p) {
  return reinterpret_cast<uintptr_t>(p) & 15;
}

}  // namespace

// x (N, H, W, C) and dy (N, H, W, CO) f32 NHWC, contiguous and 16-byte
// aligned, C % 8 == 0, CO % 8 == 0; dyt holds 2 * N*H*CO*Wp f32 (Wp = W
// rounded up to a multiple of 4: dyT_hi, then dyT_lo; written here);
// dw (KZ, 3, 3, C, CO) f32; scratch holds splits * KZ*9*C*CO f32 (unused
// when splits == 1).  Returns cudaGetLastError() after the launches
// (cudaErrorInvalidValue for arguments the kernels do not take or a tensor
// map that cuTensorMapEncodeTiled refuses).
extern "C" int dgtta_conv3x3_wgrad_tf32x3(const void* x, const void* dy,
                                          void* dyt, void* dw, void* scratch,
                                          int N, int depth, int H, int W,
                                          int C, int CO, int KZ, int splits,
                                          void* stream) {
  const int Wp = (W + 3) / 4 * 4;
  if (N <= 0 || depth <= 0 || N % depth != 0 || H <= 0 || W <= 0 || C <= 0 ||
      C % 8 != 0 || CO <= 0 || CO % 8 != 0 || (KZ != 1 && KZ != 3) ||
      splits <= 0 || (splits > 1 && scratch == nullptr) ||
      (long long)N * ((H + kTileH - 1) / kTileH) *
              ((W + kTileW - 1) / kTileW) > 2147483647LL ||
      misaligned(x) || misaligned(dy) ||
      dyt == nullptr || misaligned(dyt) || misaligned(dw))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* hi = static_cast<float*>(dyt);
  float* lo = hi + (size_t)N * H * CO * Wp;
  const long long nh = (long long)N * H;
  const dim3 tgrid((Wp + 31) / 32, (CO + 31) / 32,
                   (unsigned)(nh < 65535 ? nh : 65535));
  split_transpose_kernel<<<tgrid, dim3(32, 8), 0, s>>>(
      static_cast<const float*>(dy), hi, lo, W, CO, Wp, nh);

  constexpr CUtensorMapDataType kF32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  CUtensorMap tmx, tmhi, tmlo;
  const cuuint64_t xd[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H,
                            (cuuint64_t)N};
  const cuuint64_t xs[3] = {(cuuint64_t)C * 4, (cuuint64_t)W * C * 4,
                            (cuuint64_t)H * W * C * 4};
  const cuuint32_t xb[4] = {kCi, kHaloW, kTileH + 2, 1};
  // dyT (N, H, CO, Wp): W columns, the padding past them never read
  const cuuint64_t dd[4] = {(cuuint64_t)W, (cuuint64_t)CO, (cuuint64_t)H,
                            (cuuint64_t)N};
  const cuuint64_t ds[3] = {(cuuint64_t)Wp * 4, (cuuint64_t)CO * Wp * 4,
                            (cuuint64_t)H * CO * Wp * 4};
  const cuuint32_t db[4] = {kTileW, kBN, kTileH, 1};
  if (!make_map(&tmx, x, 4, xd, xs, xb, kF32, 4) ||
      !make_map(&tmhi, hi, 4, dd, ds, db, kF32, 4) ||
      !make_map(&tmlo, lo, 4, dd, ds, db, kF32, 4))
    return static_cast<int>(cudaErrorInvalidValue);
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        wgrad_tf32x3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const int tiles_w = (W + kTileW - 1) / kTileW;
  const int tiles_per_plane = ((H + kTileH - 1) / kTileH) * tiles_w;
  const int n_tiles = N * tiles_per_plane;
  const int tiles_per_split = (n_tiles + splits - 1) / splits;
  float* part = splits == 1 ? static_cast<float*>(dw)
                            : static_cast<float*>(scratch);
  const dim3 grid(splits, KZ * ((C + kCi - 1) / kCi), (CO + kBN - 1) / kBN);
  wgrad_tf32x3_kernel<<<grid, kThreads, kSmem, s>>>(
      tmx, tmhi, tmlo, part, depth, C, CO, KZ, tiles_w, tiles_per_plane,
      n_tiles, tiles_per_split);
  if (splits > 1) {
    const long long m = (long long)KZ * 9 * C * CO;
    const int threads = 256;
    sum_splits_kernel<<<(unsigned)((m + threads - 1) / threads), threads, 0,
                        s>>>(part, static_cast<float*>(dw), m, splits);
  }
  return static_cast<int>(cudaGetLastError());
}
