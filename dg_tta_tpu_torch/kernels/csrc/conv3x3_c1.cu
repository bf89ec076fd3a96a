// The first U-Net conv, on the 1-channel image: the 3x3(x3) stride-1 pad-1
// convolution and its weight gradient for C = 1, f32 or bf16, on Hopper's
// tensor cores (sm_90a, mma.sync).
//
// Replaces dg_tta_tpu/ops/conv2d_pallas.py:99 conv3x3_pallas at C = 1 (with
// KZ=3 the three z-tap calls of it that dg_tta_tpu/models/unet.py::_conv
// sums), and its weight gradient, which the TPU package left to XLA's conv
// transpose:
//
//   y[n,h,w,co]  = sum_{kz<KZ,ky,kx} x[n+kz-KZ/2, h+ky-1, w+kx-1] * w[tap,co]
//   dW[tap,co]   = sum_{n,h,w}       x[n+kz-KZ/2, h+ky-1, w+kx-1] * dy[n,h,w,co]
//
// tap = (kz, ky, kx), zeros outside the plane and outside the plane's group
// of `depth` planes, f32 sums, y in the input's type, dW f32.
//
// What bounds it on an H100, at the TS104 first conv (112 x 112 x 128
// planes, CO = 32): one input channel against 32 outputs, 2*27*32 = 1728
// operations per voxel.  In bf16 a voxel moves 2 + 64 bytes, 26 operations
// per byte, above the f32 CUDA cores' 67 TFLOP/s / 3.35 TB/s = 20: on the
// CUDA cores bf16 is bound by its multiply-adds, 0.122 ms for a window
// forward plus a trained step's forward (three volumes, 8.2 GFLOP) and
// 0.081 ms for a step's weight gradient (two volumes), above the 0.095 and
// 0.063 ms that the bytes of y and dy take.  On the tensor cores the
// operations take ~0.01 ms and the bytes bound both.  In f32 a voxel moves
// 4 + 128 bytes, 13 operations per byte: bound by bytes on either unit,
// 0.190 and 0.127 ms; here f32 takes each product as three tf32 products
// (3xTF32: hi*hi + hi*lo + lo*hi, f32 accuracy), 0.050 and 0.033 ms of
// operations at 495/3 TFLOP/s, under the bytes.
//
// Why mma.sync and not wgmma.  The GEMMs are tiny (N = 32, K = 32) and the
// work only has to keep the tensor cores under the bytes, which leaves them
// ~10x headroom; the A operand of the forward is gathered from the halo by
// index anyway (a tap is not a shift of a dense operand at one channel),
// and register-A wgmma would tie four warps to one 64-pixel M tile and add
// the async proxy's fences.  mma.sync keeps every warp independent: it
// gathers, multiplies and stores its own 16 pixels.
//
// The forward: an implicit GEMM per warp, M = 16 output pixels of one row,
// N = 32 output channels (four n8 tiles), K = the taps (KZ*9) padded to 16
// or 32: two k16 steps in bf16, four k8 steps in f32.  A block (eight warps)
// owns an 8 x 64 pixel tile of a plane, one row per warp, and walks tiles
// persistently.  The tile's zero-padded halo (KZ planes x 10 rows x 80
// pixels) is staged in shared memory by 16-byte cp.async, in a ring of
// three buffers: the next two tiles' halos load while a tile computes, one
// barrier per tile.  Row and plane pitches (80 and 816 elements) put the
// taps that one load instruction gathers in distinct banks.  Each thread
// packs its B fragments of the weights once, into registers (rows in tap
// order, zero rows past KZ*9; f32 split into tf32 hi and remainder), so
// the wrapper launches nothing but the kernel.  The columns are permuted
// within each 32-channel tile, column 8j + 2t + e holding channel 8t + 2j
// + e, so that the accumulators of lane t of a quad are the 8 contiguous
// channels 8t..8t+7 of its pixel: y leaves in one 16-byte streaming store
// per pixel and lane (bf16; two in f32), a warp writing 512 contiguous
// bytes per instruction.  f32 keeps its 64 weight registers (hi and
// remainder) unspilled at one block per SM.
//
// The weight gradient: dW^T (CO x taps) = dy^T im2col(x), M = 32 output
// channels (two m16 tiles), N = the taps (four n8 tiles, 27 -> 32), K =
// positions, 16 (bf16) or 8 (f32) per step.  This orientation puts dy, the
// operand that carries the bytes, in A, where it is read once from shared
// memory with no gather; the taps in N make the gather of x a pair of
// neighbouring positions per register.  (Taps in M, on wgmma, would pad 27
// to 64 rows and need im2col(x) as a dense operand in shared memory.)  A
// block of eight warps sums a contiguous range of tiles (bf16 8 x 64
// positions, f32 4 x 64), each warp one row (bf16) or half a row (f32).
// dy and the x halo are staged by 16-byte cp.async in the forward's ring of
// three buffers (dy in rows of 32 channels, 16-byte chunks XOR-swizzled by
// position so that the loads of A hit distinct banks: bf16 by
// ldmatrix.x4.trans, f32 by plain loads, each split into tf32 hi and
// remainder).  The tensor cores add with truncation, so each warp's MMA
// sums over a tile (64 or 32 positions) are promoted into an f32 total in
// registers.  At the end the eight warps' totals are added in shared memory
// in a fixed order, one partial per block is written, and a second kernel
// adds the partials in a fixed order: no atomics, dW is the same bit for
// bit from run to run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <algorithm>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;  // eight warps
constexpr int kTW = 64;        // tile pixels along W
constexpr int kCoT = 32;       // output channels per block

// The halo of a tile of TH rows: KZ planes of TH + 2 rows of 64 + 2 kLead
// staged pixels (stage_halo), row pitch P and plane pitch Q elements (P >=
// the staged row, Q >= (TH + 2) * P).
template <int TH, int P, int Q>
struct Geo {
  static constexpr int kTH = TH, kP = P, kQ = Q;
};
// forward (both types): rows 8 words (bf16) / 16 (f32) apart mod 32 banks,
// planes 24 / 16
using FwdGeo = Geo<8, 80, 816>;
// weight gradient: bf16 as the forward; f32 rows 8 words apart, planes 24
using WgBfGeo = Geo<8, 80, 816>;
using WgF32Geo = Geo<4, 72, 440>;

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ bf16 zero<bf16>() { return __float2bfloat16(0.f); }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// D(16 x 8, f32) += A(16 x 16, bf16) * B(16 x 8, bf16).  Lane l = 4 g + t:
//   a[0] = A[g][2t, 2t+1],  a[1] = A[g+8][2t, 2t+1],
//   a[2] = A[g][2t+8, 2t+9], a[3] = A[g+8][2t+8, 2t+9] (lower k in the low
//   half); b0 = B[2t, 2t+1][g], b1 = B[2t+8, 2t+9][g];
//   d[0, 1] = D[g][2t, 2t+1], d[2, 3] = D[g+8][2t, 2t+1].
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// D(16 x 8, f32) += A(16 x 8, tf32) * B(8 x 8, tf32).  Lane l = 4 g + t:
//   a[0] = A[g][t], a[1] = A[g+8][t], a[2] = A[g][t+4], a[3] = A[g+8][t+4];
//   b0 = B[t][g], b1 = B[t+4][g]; d as in mma_bf16.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// f32 -> tf32 (nearest, ties away from zero) and the remainder, as tf32.
__device__ __forceinline__ uint32_t cvt_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = cvt_tf32(v);
  lo = cvt_tf32(__fsub_rn(v, __uint_as_float(hi)));
}

// Four transposed 8 x 8 matrices of 16-bit elements: lane l gives the
// address of row l % 8 of matrix l / 8 (16 bytes); lane l receives, of
// every matrix, elements (row 2 (l % 4), column l / 4) in the low half and
// (row 2 (l % 4) + 1, column l / 4) in the high half.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// 16 bytes from global to shared memory, asynchronously; zeros where !ok.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t bits(bf16 v) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(v));
}
__device__ __forceinline__ uint32_t bits(float v) { return __float_as_uint(v); }

// A staged halo row starts kLead = 16 / sizeof(T) pixels before the
// tile (8 in bf16, 4 in f32), so that its 16-byte chunks lie on x's
// 16-byte grid; pixel w0 - 1, the left zero pad, is its element kLead - 1.
template <typename T>
constexpr int kLead = 16 / (int)sizeof(T);

// The offset (elements) of tap k = (kz * 3 + ky) * 3 + kx of a pixel in
// the staged halo, from the pixel's column in the tile's first halo row of
// plane 0 (its own row for ky = 0); -1 for the zero taps k >= KZ * 9.
template <typename T, int KZ, typename G>
__device__ __forceinline__ int tap_offset(int k) {
  return k < KZ * 9 ? (k / 9) * G::kQ + ((k / 3) % 3) * G::kP + k % 3 +
                          kLead<T> - 1
                    : -1;
}

// The cp.async groups in flight: a block computes one tile while the next
// two load, in a ring of three buffers, with one barrier per tile.
constexpr int kStages = 3;

// Stages the zero-padded halo of the tile at (n, h0, w0) into hs: KZ planes
// (n - KZ/2 ..; zeros outside the plane's group of `depth`), TH + 2 rows
// (from h0 - 1) of 64 + 2 kLead pixels (from w0 - kLead), row pitch P, plane
// pitch Q.  vec (W % kLead == 0, x 16-byte aligned): 16-byte cp.async
// chunks, each wholly inside or outside the plane (zero-filled); else
// element by element with plain loads (W not a multiple of kLead).
template <typename T, int KZ, typename G>
__device__ __forceinline__ void stage_halo(T* hs, const T* __restrict__ x,
                                           int n, int depth, int H, int W,
                                           int h0, int w0, bool vec) {
  constexpr int kL = kLead<T>;
  constexpr int kRows = G::kTH + 2, kCh = kTW / kL + 2;
  const int d = n % depth;
  if (vec) {
    for (int i = threadIdx.x; i < KZ * kRows * kCh; i += kThreads) {
      const int kz = i / (kRows * kCh), rem = i % (kRows * kCh);
      const int r = rem / kCh, c = rem % kCh;
      const int dz = kz - KZ / 2, h = h0 + r - 1, w = w0 - kL + c * kL;
      const bool ok = d + dz >= 0 && d + dz < depth && h >= 0 && h < H &&
                      w >= 0 && w < W;
      cp_async16(hs + kz * G::kQ + r * G::kP + c * kL,
                 ok ? x + ((ptrdiff_t)(n + dz) * H + h) * W + w : x, ok);
    }
  } else {
    for (int i = threadIdx.x; i < KZ * kRows * kCh * kL; i += kThreads) {
      const int kz = i / (kRows * kCh * kL), rem = i % (kRows * kCh * kL);
      const int r = rem / (kCh * kL), c = rem % (kCh * kL);
      const int dz = kz - KZ / 2, h = h0 + r - 1, w = w0 - kL + c;
      const bool ok = d + dz >= 0 && d + dz < depth && h >= 0 && h < H &&
                      w >= 0 && w < W;
      hs[kz * G::kQ + r * G::kP + c] =
          ok ? x[((ptrdiff_t)(n + dz) * H + h) * W + w] : zero<T>();
    }
  }
}

// Two f32 rounded to bf16, a in the low half.
__device__ __forceinline__ uint32_t pack2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Stores the 8 contiguous channels co .. co + 7 of one pixel (v in channel
// order), one 16-byte (bf16) or two (f32) streaming stores (y is not read
// back by this kernel) where CO % 8 == 0 and the 8 exist, else channel by
// channel up to CO.
__device__ __forceinline__ void store8(bf16* p, int co, int CO, bool vec,
                                       const float (&v)[8]) {
  if (vec && co + 8 <= CO) {
    __stcs(reinterpret_cast<uint4*>(p + co),
           make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]), pack2(v[4], v[5]),
                      pack2(v[6], v[7])));
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      if (co + e < CO) p[co + e] = __float2bfloat16(v[e]);
  }
}
__device__ __forceinline__ void store8(float* p, int co, int CO, bool vec,
                                       const float (&v)[8]) {
  if (vec && co + 8 <= CO) {
    __stcs(reinterpret_cast<float4*>(p + co),
           make_float4(v[0], v[1], v[2], v[3]));
    __stcs(reinterpret_cast<float4*>(p + co + 4),
           make_float4(v[4], v[5], v[6], v[7]));
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      if (co + e < CO) p[co + e] = v[e];
  }
}

// ---- forward ---------------------------------------------------------------

// The MMAs of one warp's 16 pixels (m16 tile), from the halo row `hrow` at
// the tile's first pixel: bf16, K = 16 KS.
template <int KS>
__device__ __forceinline__ void forward_mma(float (&acc)[4][4],
                                            const bf16* hrow,
                                            const int (&koff)[KS][4],
                                            const uint32_t (&bw)[KS][4][2],
                                            const uint32_t (&)[KS][4][2],
                                            int g) {
  const uint16_t* h = reinterpret_cast<const uint16_t*>(hrow) + g;
#pragma unroll
  for (int s = 0; s < KS; ++s) {
    uint32_t v[4][2];  // [k slot][pixel g, g + 8]
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int o = koff[s][q];
      v[q][0] = o >= 0 ? h[o] : 0u;
      v[q][1] = o >= 0 ? h[o + 8] : 0u;
    }
    const uint32_t a[4] = {v[0][0] | (v[1][0] << 16), v[0][1] | (v[1][1] << 16),
                           v[2][0] | (v[3][0] << 16),
                           v[2][1] | (v[3][1] << 16)};
#pragma unroll
    for (int j = 0; j < 4; ++j) mma_bf16(acc[j], a, bw[s][j][0], bw[s][j][1]);
  }
}

// f32, K = 8 KS, 3xTF32.
template <int KS>
__device__ __forceinline__ void forward_mma(float (&acc)[4][4],
                                            const float* hrow,
                                            const int (&koff)[KS][2],
                                            const uint32_t (&bh)[KS][4][2],
                                            const uint32_t (&bl)[KS][4][2],
                                            int g) {
  const float* h = hrow + g;
#pragma unroll
  for (int s = 0; s < KS; ++s) {
    const int o0 = koff[s][0], o1 = koff[s][1];
    const float v[4] = {o0 >= 0 ? h[o0] : 0.f, o0 >= 0 ? h[o0 + 8] : 0.f,
                        o1 >= 0 ? h[o1] : 0.f, o1 >= 0 ? h[o1 + 8] : 0.f};
    uint32_t ah[4], al[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) split_tf32(v[q], ah[q], al[q]);
    // 3xTF32, the small products first, each product over the four
    // n-tiles before the next (no chain of dependent MMAs)
#pragma unroll
    for (int j = 0; j < 4; ++j) mma_tf32(acc[j], al, bh[s][j][0], bh[s][j][1]);
#pragma unroll
    for (int j = 0; j < 4; ++j) mma_tf32(acc[j], ah, bl[s][j][0], bl[s][j][1]);
#pragma unroll
    for (int j = 0; j < 4; ++j) mma_tf32(acc[j], ah, bh[s][j][0], bh[s][j][1]);
  }
}

template <typename T>
struct FwdK;
// bf16: k16 steps, four k slots per thread per step (2t, 2t+1, 2t+8, 2t+9)
template <>
struct FwdK<bf16> {
  static constexpr int kStep = 16, kSlots = 4;
  __device__ static int k(int s, int t, int q) {
    return 16 * s + 2 * t + (q & 1) + 8 * (q >> 1);
  }
};
// f32: k8 steps, two k slots per thread per step (t, t + 4)
template <>
struct FwdK<float> {
  static constexpr int kStep = 8, kSlots = 2;
  __device__ static int k(int s, int t, int q) { return 8 * s + t + 4 * q; }
};

// w (KZ * 9, CO): row k = tap (kz * 3 + ky) * 3 + kx.
template <typename T, int KZ>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 2 ? 2 : 1)
c1_forward_kernel(const T* __restrict__ x, const T* __restrict__ w,
                  T* __restrict__ y, int depth, int H, int W, int CO,
                  int tiles_w, int tiles_per_plane, int n_tiles, int vec_x) {
  using G = FwdGeo;
  using K = FwdK<T>;
  constexpr int KS = (KZ == 3 ? 32 : 16) / K::kStep;
  __shared__ __align__(16) uint8_t halo_raw[kStages * KZ * G::kQ *
                                            sizeof(T)];
  T* halo = reinterpret_cast<T*>(halo_raw);  // kStages buffers of KZ * Q
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int co0 = blockIdx.y * kCoT;
  const bool vec = CO % 8 == 0;

  // B fragments (f32: tf32 part and remainder), k-step s, n-tile j: row
  // k = tap (zero past KZ * 9), column 8 j + g = channel co0 + 8 (g / 2) +
  // 2 j + g % 2 (zero past CO), so that lane t's accumulators are channels
  // co0 + 8 t .. + 7
  uint32_t bh[KS][4][2], bl[KS][4][2];
  int koff[KS][K::kSlots];
#pragma unroll
  for (int s = 0; s < KS; ++s) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ch = co0 + 8 * (g / 2) + 2 * j + g % 2;
      auto at = [&](int k) {
        return k < KZ * 9 && ch < CO ? w[k * CO + ch] : zero<T>();
      };
      if constexpr (sizeof(T) == 2) {
#pragma unroll
        for (int q = 0; q < 2; ++q)
          bh[s][j][q] = bits(at(K::k(s, t, 2 * q))) |
                        (bits(at(K::k(s, t, 2 * q + 1))) << 16);
        bl[s][j][0] = bl[s][j][1] = 0u;
      } else {
#pragma unroll
        for (int q = 0; q < 2; ++q)
          split_tf32(at(K::k(s, t, q)), bh[s][j][q], bl[s][j][q]);
      }
    }
#pragma unroll
    for (int q = 0; q < K::kSlots; ++q)
      koff[s][q] = tap_offset<T, KZ, G>(K::k(s, t, q));
  }

  // the block's k-th tile's halo into ring buffer k % kStages, one
  // cp.async group per tile (empty past the last)
  auto stage = [&](int k) {
    const int tile = blockIdx.x + k * (int)gridDim.x;
    if (tile < n_tiles) {
      const int n = tile / tiles_per_plane, tt = tile % tiles_per_plane;
      stage_halo<T, KZ, G>(halo + (k % kStages) * KZ * G::kQ, x, n, depth,
                           H, W, (tt / tiles_w) * G::kTH,
                           (tt % tiles_w) * kTW, vec_x);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) stage(k);
  int tile = blockIdx.x;
  for (int it = 0; tile < n_tiles; ++it, tile += gridDim.x) {
    cp_async_wait<kStages - 2>();  // this tile's halo has landed
    __syncthreads();  // ... for every thread, and the oldest buffer is free
    stage(it + kStages - 1);

    const int n = tile / tiles_per_plane, tt = tile % tiles_per_plane;
    const int h = (tt / tiles_w) * G::kTH + warp, w0 = (tt % tiles_w) * kTW;
    // the warp's row of the halo, ky = 0
    const T* hrow = halo + (it % kStages) * KZ * G::kQ + warp * G::kP;
#pragma unroll
    for (int mt = 0; mt < kTW / 16; ++mt) {
      float acc[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[j][q] = 0.f;
      forward_mma<KS>(acc, hrow + 16 * mt, koff, bh, bl, g);
      // lane t holds channels co0 + 8 t + 2 j + e of pixels g and g + 8
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int px = w0 + 16 * mt + g + 8 * i;
        if (h >= H || px >= W) continue;
        const float v[8] = {acc[0][2 * i], acc[0][2 * i + 1],
                            acc[1][2 * i], acc[1][2 * i + 1],
                            acc[2][2 * i], acc[2][2 * i + 1],
                            acc[3][2 * i], acc[3][2 * i + 1]};
        store8(y + (((size_t)n * H + h) * W + px) * CO, co0 + 8 * t, CO,
               vec, v);
      }
    }
  }
  cp_async_wait<0>();
}

// ---- weight gradient -------------------------------------------------------

// The weight gradient's halo geometry, K step and stage layout of dy: the
// byte offset of dy's 16-byte chunk j (channels co0 + 8 j (bf16) or 4 j
// (f32) ..) of tile position p, in rows of 32 channels (bf16 64 bytes, f32
// 128), the chunks XOR-swizzled so that the loads of A hit distinct banks:
// bf16 by (p / 2) % 4, the 8 rows of an ldmatrix matrix in 8 distinct
// 16-byte bank groups; f32 by 2 (p % 4), the lanes (t, g) of an A fragment
// load (positions t, channels g) in 32 distinct banks.
template <typename T>
struct WgCfg;
template <>
struct WgCfg<bf16> {
  using G = WgBfGeo;
  static constexpr int kKStep = 16;
  __device__ static int chunk(int p, int j) {
    return p * 64 + ((j ^ ((p >> 1) & 3)) << 4);
  }
};
template <>
struct WgCfg<float> {
  using G = WgF32Geo;
  static constexpr int kKStep = 8;
  __device__ static int chunk(int p, int j) {
    return p * 128 + ((j ^ ((p & 3) << 1)) << 4);
  }
};


// Stages position tile `tile` of the weight gradient: its x halo into hs
// and dy's 32 channels co0 .. into d (Cfg::chunk layout), by cp.async where
// vec (CO % 8 == 0), else element by element; zeros past the plane and CO.
template <typename T, int KZ>
__device__ __forceinline__ void stage_wgrad(uint8_t* d, T* hs,
                                            const T* __restrict__ x,
                                            const T* __restrict__ dy,
                                            int tile, int co0, int depth,
                                            int H, int W, int CO,
                                            int tiles_w, int tiles_per_plane,
                                            bool vec, bool vec_x) {
  using Cfg = WgCfg<T>;
  using G = typename Cfg::G;
  constexpr int kPos = G::kTH * kTW;
  constexpr int kEl = 16 / (int)sizeof(T);  // channels per chunk
  constexpr int kChunks = kPos * kCoT / kEl;
  const int n = tile / tiles_per_plane, tt = tile % tiles_per_plane;
  const int h0 = (tt / tiles_w) * G::kTH, w0 = (tt % tiles_w) * kTW;
  stage_halo<T, KZ, G>(hs, x, n, depth, H, W, h0, w0, vec_x);
  for (int c = threadIdx.x; c < kChunks; c += kThreads) {
    const int p = c / (kCoT / kEl), j = c % (kCoT / kEl);
    const int h = h0 + p / kTW, w = w0 + p % kTW, co = co0 + kEl * j;
    const size_t src = (((size_t)n * H + h) * W + w) * CO + co;
    uint8_t* dst = d + Cfg::chunk(p, j);
    if (vec) {
      const bool ok = h < H && w < W && co < CO;
      cp_async16(dst, ok ? dy + src : dy, ok);
    } else {
#pragma unroll
      for (int e = 0; e < kEl; ++e)
        reinterpret_cast<T*>(dst)[e] =
            h < H && w < W && co + e < CO ? dy[src + e] : zero<T>();
    }
  }
}

// splits blocks x co tiles; block b sums position tiles [b * tps, (b + 1) *
// tps) and writes its partial (KZ*9 x CO, f32) to part + b * KZ*9*CO.
template <typename T, int KZ>
__global__ void __launch_bounds__(kThreads, 2)
c1_wgrad_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                float* __restrict__ part, int depth, int H, int W, int CO,
                int tiles_w, int tiles_per_plane, int n_tiles,
                int tiles_per_split, int vec_x) {
  using Cfg = WgCfg<T>;
  using G = typename Cfg::G;
  constexpr int kTaps = KZ * 9;
  constexpr int kPos = G::kTH * kTW;           // positions per tile
  constexpr int kDyBytes = kPos * kCoT * (int)sizeof(T);
  constexpr int kWarpPos = kPos / 8;           // positions per warp
  constexpr int kSteps = kWarpPos / Cfg::kKStep;
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* dys = smem;  // [kStages][kDyBytes]
  T* halo = reinterpret_cast<T*>(smem + kStages * kDyBytes);  // [kStages][KZ Q]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int co0 = blockIdx.y * kCoT;
  const bool vec = CO % 8 == 0;
  const int t_begin = blockIdx.x * tiles_per_split;
  const int t_end = min(n_tiles, t_begin + tiles_per_split);
  // the warp's positions: row rw of the tile, columns cb ..
  const int rw = warp * kWarpPos / kTW, cb = warp * kWarpPos % kTW;

  // f32 A: the offset of channel 16 i + g + 8 h in the swizzled row of a
  // position p with p % 4 == t (Cfg::chunk)
  int aoff[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      aoff[i][h] = (((4 * i + 2 * h + g / 4) ^ (2 * t)) << 2) + g % 4;
  // B: tap 8 j + g of n-tile j, as a halo offset from the warp's row
  int toff[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int o = tap_offset<T, KZ, G>(8 * j + g);
    toff[j] = o < 0 ? -1 : o + rw * G::kP + cb;
  }

  // dy (by cp.async where CO % 8 == 0) and the x halo of the block's k-th
  // tile into ring buffer k % kStages, one cp.async group per tile (empty
  // past the range)
  auto stage = [&](int k) {
    const int b = k % kStages;
    if (t_begin + k < t_end)
      stage_wgrad<T, KZ>(dys + b * kDyBytes, halo + b * KZ * G::kQ, x, dy,
                         t_begin + k, co0, depth, H, W, CO, tiles_w,
                         tiles_per_plane, vec, vec_x);
    cp_async_commit();
  };

  float tot[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) tot[i][j][q] = 0.f;

#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) stage(k);
  for (int it = 0; t_begin + it < t_end; ++it) {
    cp_async_wait<kStages - 2>();  // this tile's dy and halo have landed
    __syncthreads();  // ... for every thread, and the oldest buffer is free
    stage(it + kStages - 1);

    const uint8_t* d = dys + (it % kStages) * kDyBytes;
    const T* hs = halo + (it % kStages) * KZ * G::kQ;
    float acc[2][4][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      const int k0 = Cfg::kKStep * s;  // the step's first position
      if constexpr (sizeof(T) == 2) {
        // A = dy^T: matrix q = lane / 8 is (channels 0-7 | 8-15 of the m
        // tile) x (positions 0-7 | 8-15 of the step)
        uint32_t a[2][4];
        const int q = lane / 8;
        const int p = rw * kTW + cb + k0 + lane % 8 + 8 * (q >> 1);
#pragma unroll
        for (int i = 0; i < 2; ++i)
          ldmatrix_x4_trans(a[i], d + Cfg::chunk(p, 2 * i + (q & 1)));
        // B = im2col(x): positions 2t, 2t+1 (b0) and 2t+8, 2t+9 (b1)
        const uint16_t* hp = reinterpret_cast<const uint16_t*>(hs) + k0 +
                             2 * t;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          uint32_t b0 = 0u, b1 = 0u;
          if (toff[j] >= 0) {
            const uint16_t* e = hp + toff[j];
            b0 = e[0] | (static_cast<uint32_t>(e[1]) << 16);
            b1 = e[8] | (static_cast<uint32_t>(e[9]) << 16);
          }
#pragma unroll
          for (int i = 0; i < 2; ++i) mma_bf16(acc[i][j], a[i], b0, b1);
        }
      } else {
        // A = dy^T: a[0] = dy[t][g], a[1] = dy[t][g+8], a[2] = dy[t+4][g],
        // a[3] = dy[t+4][g+8] of the m tile's channels (aoff: the swizzled
        // float offsets of channels 16 i + g + 8 h in a row of position
        // t mod 4)
        const float* dp = reinterpret_cast<const float*>(d) +
                          (rw * kTW + cb + k0 + t) * kCoT;
        uint32_t ah[2][4], al[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float v[4] = {dp[aoff[i][0]], dp[aoff[i][1]],
                              dp[4 * kCoT + aoff[i][0]],
                              dp[4 * kCoT + aoff[i][1]]};
#pragma unroll
          for (int r = 0; r < 4; ++r) split_tf32(v[r], ah[i][r], al[i][r]);
        }
        // B = im2col(x): positions t (b0) and t + 4 (b1)
        const float* hp = reinterpret_cast<const float*>(hs) + k0 + t;
        uint32_t bh[4][2], bl[4][2];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          bh[j][0] = bh[j][1] = bl[j][0] = bl[j][1] = 0u;
          if (toff[j] >= 0) {
            split_tf32(hp[toff[j]], bh[j][0], bl[j][0]);
            split_tf32(hp[toff[j] + 4], bh[j][1], bl[j][1]);
          }
        }
        // 3xTF32, the small products first, each over all eight tiles
        // before the next (no chain of dependent MMAs)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            mma_tf32(acc[i][j], al[i], bh[j][0], bh[j][1]);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            mma_tf32(acc[i][j], ah[i], bl[j][0], bl[j][1]);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            mma_tf32(acc[i][j], ah[i], bh[j][0], bh[j][1]);
      }
    }
    // promote the tile's sums (the tensor cores' adds truncate)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) tot[i][j][q] += acc[i][j][q];
  }
  cp_async_wait<0>();
  __syncthreads();

  // the eight warps' totals, added in warp order: red[warp][value][lane]
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        red[(warp * 32 + (i * 4 + j) * 4 + q) * 32 + lane] = tot[i][j][q];
  __syncthreads();
  float* out = part + (size_t)blockIdx.x * kTaps * CO;
  for (int e = threadIdx.x; e < 32 * 32; e += kThreads) {
    const int l = e % 32, v = e / 32;
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k) s += red[(k * 32 + v) * 32 + l];
    // value v = (i * 4 + j) * 4 + q of lane l: D[co][tap], co = 16 i +
    // l / 4 + 8 (q / 2), tap = 8 j + 2 (l % 4) + q % 2
    const int i = v / 16, j = (v / 4) % 4, q = v % 4;
    const int co = co0 + 16 * i + l / 4 + 8 * (q >> 1);
    const int tap = 8 * j + 2 * (l % 4) + (q & 1);
    if (tap < kTaps && co < CO) out[(size_t)tap * CO + co] = s;
  }
}

__global__ void sum_splits_kernel(const float* __restrict__ part,
                                  float* __restrict__ dw, int m, int splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += part[(size_t)k * m + i];
  dw[i] = s;
}

// ---- host ------------------------------------------------------------------

bool misaligned(const void* p) {
  return reinterpret_cast<uintptr_t>(p) & 15;
}

// Whether the halo of x loads in 16-byte chunks (stage_halo's vec).
template <typename T>
int halo_vec(const void* x, int W) {
  return W % kLead<T> == 0 && !misaligned(x);
}

template <typename T, int KZ>
int launch_forward(const void* x, const void* w, void* y, int N, int depth,
                   int H, int W, int CO, cudaStream_t s) {
  const auto kernel = c1_forward_kernel<T, KZ>;
  const int tiles_w = (W + kTW - 1) / kTW;
  const int tiles_per_plane = ((H + FwdGeo::kTH - 1) / FwdGeo::kTH) * tiles_w;
  const int n_tiles = N * tiles_per_plane;
  const int co_tiles = (CO + kCoT - 1) / kCoT;
  // a persistent grid: as many blocks as the device holds at once (asked
  // once per process: the host work of a launch stays a launch)
  static int resident = 0;
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
        (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
        (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                           kThreads, 0)) !=
            cudaSuccess)
      return static_cast<int>(e);
    resident = std::max(1, per_sm) * sms;
  }
  const int blocks = std::max(1, std::min(n_tiles, resident / co_tiles));
  kernel<<<dim3(blocks, co_tiles), kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y),
      depth, H, W, CO, tiles_w, tiles_per_plane, n_tiles, halo_vec<T>(x, W));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int KZ>
int launch_wgrad(const void* x, const void* dy, float* part, int N,
                 int depth, int H, int W, int CO, int splits,
                 cudaStream_t s) {
  using Cfg = WgCfg<T>;
  using G = typename Cfg::G;
  const auto kernel = c1_wgrad_kernel<T, KZ>;
  const int smem = kStages * (G::kTH * kTW * kCoT + KZ * G::kQ) *
                   (int)sizeof(T);
  static int configured = 0;
  if (smem > configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = smem;
  }
  const int tiles_w = (W + kTW - 1) / kTW;
  const int tiles_per_plane = ((H + G::kTH - 1) / G::kTH) * tiles_w;
  const int n_tiles = N * tiles_per_plane;
  kernel<<<dim3(splits, (CO + kCoT - 1) / kCoT), kThreads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), part, depth, H, W,
      CO, tiles_w, tiles_per_plane, n_tiles, (n_tiles + splits - 1) / splits,
      halo_vec<T>(x, W));
  return static_cast<int>(cudaGetLastError());
}

bool bad_shape(int N, int depth, int H, int W, int CO, int KZ, int dtype) {
  return N <= 0 || depth <= 0 || N % depth != 0 || H <= 0 || W <= 0 ||
         CO <= 0 || (KZ != 1 && KZ != 3) || (dtype != 0 && dtype != 1);
}

}  // namespace

// x (N, H, W, 1) and y (N, H, W, CO) NHWC, w (KZ, 3, 3, 1, CO), contiguous,
// one type: dtype 0 = float32, 1 = bfloat16; y 16-byte aligned.  Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for arguments
// the kernel does not take).
extern "C" int dgtta_conv3x3_c1(const void* x, const void* w, void* y, int N,
                                int depth, int H, int W, int CO, int KZ,
                                int dtype, void* stream) {
  if (bad_shape(N, depth, H, W, CO, KZ, dtype) || misaligned(y))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return KZ == 3 ? launch_forward<float, 3>(x, w, y, N, depth, H, W, CO, s)
                   : launch_forward<float, 1>(x, w, y, N, depth, H, W, CO, s);
  return KZ == 3 ? launch_forward<bf16, 3>(x, w, y, N, depth, H, W, CO, s)
                 : launch_forward<bf16, 1>(x, w, y, N, depth, H, W, CO, s);
}

// x (N, H, W, 1) and dy (N, H, W, CO) contiguous, dy 16-byte aligned, dtype
// 0 = float32, 1 = bfloat16; dw (KZ, 3, 3, 1, CO) f32; scratch holds
// splits * KZ*9*CO f32 (unused when splits == 1).  Block b of the first
// kernel sums the position tiles [b * ceil(tiles / splits), ...), a tile
// being 8 x 64 positions in bf16 and 4 x 64 in f32.  Returns
// cudaGetLastError() after the launches (cudaErrorInvalidValue for
// arguments the kernels do not take).
extern "C" int dgtta_conv3x3_wgrad_c1(const void* x, const void* dy, void* dw,
                                      void* scratch, int N, int depth, int H,
                                      int W, int CO, int KZ, int splits,
                                      int dtype, void* stream) {
  if (bad_shape(N, depth, H, W, CO, KZ, dtype) || splits <= 0 ||
      (splits > 1 && scratch == nullptr) || misaligned(dy))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = splits == 1 ? static_cast<float*>(dw)
                            : static_cast<float*>(scratch);
  int err;
  if (dtype == 0)
    err = KZ == 3 ? launch_wgrad<float, 3>(x, dy, part, N, depth, H, W, CO,
                                           splits, s)
                  : launch_wgrad<float, 1>(x, dy, part, N, depth, H, W, CO,
                                           splits, s);
  else
    err = KZ == 3 ? launch_wgrad<bf16, 3>(x, dy, part, N, depth, H, W, CO,
                                          splits, s)
                  : launch_wgrad<bf16, 1>(x, dy, part, N, depth, H, W, CO,
                                          splits, s);
  if (err != 0) return err;
  if (splits > 1) {
    const int m = KZ * 9 * CO;
    sum_splits_kernel<<<(m + 255) / 256, 256, 0, s>>>(
        part, static_cast<float*>(dw), m, splits);
  }
  return static_cast<int>(cudaGetLastError());
}
