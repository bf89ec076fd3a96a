// The 3x3(x3) stride-1 pad-1 convolution and its weight gradient for a few
// input channels (1 < C < 16, CO % 8 == 0), f32 or bf16, on Hopper's
// tensor cores (sm_90a): the stem conv of a MIND model, C = 12 -> CO = 32.
//
// Replaces dg_tta_tpu/ops/conv2d_pallas.py::conv3x3_pallas at those shapes
// (with KZ=3 the three z-tap calls of it that dg_tta_tpu/models/unet.py::_conv
// sums), and its weight gradient, which the TPU package left to XLA's conv
// transpose.  The same function as conv3x3.cu and conv3x3_wgrad.cu:
//
//   y[n,h,w,co]        = sum_{kz<KZ,ky,kx,ci} x[n+kz-KZ/2, h+ky-1, w+kx-1, ci]
//                                               * w[kz,ky,kx,ci,co]
//   dW[kz,ky,kx,ci,co] = sum_{n,h,w}           x[n+kz-KZ/2, h+ky-1, w+kx-1, ci]
//                                               * dy[n,h,w,co]
//
// zero-padded in H and W and within the plane's group of `depth` planes,
// f32 sums, y in the input's type, dW in f32.  f32 takes every product as
// three tf32 products (3xTF32, as conv3x3_wgmma.cu explains).
//
// What bounds it on an H100, at the stem's shapes (112 x 112 x 128 planes):
// 2*27*12*32 operations per voxel against (12 + 32) elements of traffic,
// ~240 operations per byte in bf16, under the tensor cores' ~295: bf16 is
// bound by bytes, 0.127 ms for a window forward plus a trained step's
// forward (three volumes) and 0.084 ms for a step's weight gradient (two);
// f32 by its three tf32 products at 495 TFLOP/s, 0.595 and 0.397 ms.
//
// Why a route of its own.  The wgmma routes step 16 (bf16) or 8 (f32) input
// channels per tap, each tap a K step with a TMA box of its own: C = 12 ran
// on x and w zero-padded to 16 in device memory (a pad copy of x per call),
// and the weight gradients' 64- and 32-channel M tiles were three quarters
// and half zeros.  Here x is read at its own C and staged once per tile as
// a zero-padded halo in shared memory; C = 1 has conv3x3_c1.cu, whose K
// is the 27 taps alone (here each tap is a 16-channel step: 16x the MMAs
// at C = 1), and from C = 16 on the wgmma routes need no padding.
//
// The halo.  A block stages the zero-padded halo of its tile (KZ planes x
// rows x pixels; zeros past the plane and past the volume's group of
// planes) in shared memory once, and every tap reads it at a shift: x is
// read at its own C, with no copy.  Two halo buffers: the next tile's halo
// loads while this one computes.  bf16 (pixels of 24 bytes at C = 12,
// which TMA's 16-byte stride rule refuses) loads it with cp.async in 16-,
// 8- or 4-byte units, element by element for odd C; f32 with one 5D TMA box
// per tile where C % 4 == 0 (x seen as volumes x depth x H x W x C, whose
// out-of-bounds fill gives the padding), cp.async otherwise.
//
// bf16 (bound by bytes; the tensor cores have room): each pixel of the
// halo is one 32-byte row of 16 channels (channels C .. 15 zero, written
// once), with the 32-byte swizzle (16-byte chunk ^= bit 7 of the address),
// so that a tap is a shift of an operand's start and no index map is needed:
//   * forward: an implicit GEMM, M = a row of 64 output pixels per
//     warpgroup (four warpgroups, a 4 x 64 tile), N = 32 output channels,
//     K = (kz, ky, kx, 16 channels), one k16 step per tap (27 at KZ = 3,
//     against 21 for K = 27 x 12 padded to 336: padding that costs only
//     tensor-core time).  A is loaded with ldmatrix from the halo row
//     (row + ky, from pixel kx on) into registers; B is the weights, packed
//     by the wrapper (`pack_few_weights`, 16 rows per tap) and staged once
//     per persistent block, read by descriptor.  Read from shared memory by
//     descriptor too, A (twice B's bytes at N = 32) made each m64n32k16
//     wait on operand fetch longer than on the tensor cores; through
//     ldmatrix it loads on the load units.  The three taps of a (kz, ky)
//     are one wgmma group, whose
//     fragments load once the previous group has retired: loading them
//     while it runs makes ptxas serialize every wgmma (C7513), and the
//     eight warpgroups of an SM keep the tensor cores busy meanwhile;
//   * weight gradient: dW = im2col(x)^T dy, M = (kx, ci) for one (kz, ky):
//     64 rows = four 16-channel atoms of an MN-major operand whose leading
//     byte offset is one pixel (32 bytes), so atom kx reads the halo
//     shifted by kx pixels (kx = 3 reads padding and is dropped), N = 32
//     output channels, K = the 16 positions of a halo row per k16 step, B =
//     dy, MN-major, cp.async'd into the 64-byte swizzle; both operands by
//     descriptor, no gather.  Three warpgroups, one per ky, each with KZ
//     accumulators; 8 x 16 positions per stage.  M = 9 x 64 rows for 324
//     useful ones, against the 27 x 64 of the padded route.
// f32 (bound by its three tf32 products): wgmma takes 32-bit operands from
// shared memory only K-major and unsplit, so A comes from registers,
// gathered by index from a dense halo of C-channel pixels and split there
// into tf32 hi and lo, and the taps fold into the GEMM's K (forward) or M
// (weight gradient) axis unpadded:
//   * forward: M = 16 x 16 output pixels (four warpgroups), N = 32, K =
//     (kz, ky, kx, ci) flattened, 27 C padded once to the k8 step (328 at
//     C = 12, against 432 for C padded to 16); the weights (tf32 hi and
//     remainder, packed by the wrapper) staged once per persistent block,
//     K-major 32-byte rows with the 32-byte swizzle; a table maps each
//     thread's k to its halo offset; each k8 step issues (lo, B_hi),
//     (hi, B_lo), (hi, B_hi), kFGroup steps per wgmma group, two groups'
//     fragments in registers.  K <= 405 at C < 16: the truncating
//     accumulation needs no promotion;
//   * weight gradient: M = (tap, ci) rows in m64 tiles (wg, wg + 6, ... per
//     warpgroup, six warpgroups: one tile each at C = 12), N = 32, K = 4 x
//     16 positions per stage, split over blocks.  The block transposes its
//     dy tile in shared memory and splits it into tf32 hi and remainder
//     there (B is K-major; no device-memory pre-pass).  Two accumulators per
//     tile (hi B_hi; lo B_hi + hi B_lo) halve the chains of dependent
//     wgmmas; every kPromote stages (512 positions) they are promoted into
//     rounded sums in shared memory, as conv3x3_wgrad_tf32x3.cu does in
//     registers.
// Both weight gradients write one partial sum per block into a scratch
// slice, and a second kernel adds the slices in a fixed order:
// deterministic, no atomics.  With one split the first kernel writes dW.

#include <cuda_bf16.h>
#include <stddef.h>

#include <algorithm>

#include "hopper.cuh"

namespace {

using namespace dgtta;
using bf16 = __nv_bfloat16;

constexpr int kBN = 32;  // output channels per block
constexpr int kPx = 32;  // bf16 halo: bytes per pixel (16 channels)
// bf16 forward: four warpgroups, one row of 64 output pixels each
constexpr int kBfWG = 4;
constexpr int kBfRow = 64;
constexpr int kBfHR = kBfWG + 2, kBfHW = kBfRow + 2;
// bf16 weight gradient: three warpgroups (one per ky), 8 x 16 positions
// per stage, halo rows of 20 pixels (16 + kx <= 3, the last two padding)
constexpr int kBgWG = 3;
constexpr int kBgH = 8, kBgW = 16;
constexpr int kBgHR = kBgH + 2, kBgHW = 20;
// f32 forward: four warpgroups, 16 x 16 output pixels
constexpr int kFThreads = 512;
constexpr int kFH = 16, kFW = 16;
constexpr int kFHR = kFH + 2, kFHW = kFW + 2;
constexpr int kFGroup = 4;  // k8 steps per wgmma group
// f32 weight gradient: six warpgroups (one m64 tile each at C = 12), 4 x 16
// positions per stage
constexpr int kGWG = 6;
constexpr int kGThreads = kGWG * 128;
constexpr int kGH = 4, kGW = 16;
constexpr int kGPos = kGH * kGW;
constexpr int kGHR = kGH + 2, kGHW = kGW + 2;
constexpr int kPromote = 8;  // f32 weight gradient: stages between promotions
constexpr int kRawRow = 36;  // f32 dy tile: floats per position row (144 B)
constexpr int kDyT = kGPos / 8 * 1024;  // f32: one of dyT_hi, dyT_lo

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ bf16 zero<bf16>() { return __float2bfloat16(0.f); }

__device__ __forceinline__ void store_pair(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// The 32-byte swizzle of a shared-memory offset from a 1024-byte boundary.
__device__ __forceinline__ int swz32(int off) {
  return off ^ (((off >> 7) & 1) << 4);
}

// U bytes from global to shared memory, asynchronously; zeros where !ok.
template <int U>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "n"(U), "r"(ok ? U : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The halo copy unit: the widest of 16, 8 and 4 bytes that divides a
// pixel's C channels, 0 where none does (odd C in bf16).
__device__ __forceinline__ int copy_unit(int bytes) {
  return bytes % 16 == 0 ? 16 : bytes % 8 == 0 ? 8 : bytes % 4 == 0 ? 4 : 0;
}

struct Plain {
  __device__ __forceinline__ int operator()(int off) const { return off; }
};
struct Swz32 {
  __device__ __forceinline__ int operator()(int off) const {
    return swz32(off);
  }
};

// Stages the zero-padded halo of a tile into hs: KZ planes (n + kz - KZ/2;
// zeros outside the group of `depth` planes) x HR rows (from h0 - 1) x HW
// pixels (from w0 - 1), row pitch `pitch` pixels of `stride` bytes each,
// byte `off` of the buffer at hs + swz(off) (hs on the swizzle's 1024-byte
// grid, so that the swizzle follows the address).  The block's `threads`
// share the units evenly.  U > 0: cp.async in U-byte units, UPP of them
// per pixel (0: C * sizeof(T) / U, known only at run time); U == 0:
// element by element with plain loads and stores.
template <typename T, int HR, int HW, int U, int UPP, typename Swz>
__device__ __forceinline__ void stage_halo(uint8_t* hs,
                                           const T* __restrict__ x, int n,
                                           int depth, int H, int W, int C,
                                           int KZ, int h0, int w0, int pitch,
                                           int stride, int threads, Swz swz) {
  const int d = n % depth;
  const int bytes = C * (int)sizeof(T);
  // units per pixel: a constant where the caller knows it
  const int upp = U == 0 ? C : UPP > 0 ? UPP : bytes / U;
  for (int i = threadIdx.x; i < KZ * HR * HW * upp; i += threads) {
    const int r = i / (HW * upp), rem = i - r * (HW * upp);
    const int p = rem / upp, k = rem - p * upp;
    const int dz = r / HR - KZ / 2, h = h0 - 1 + r % HR, ww = w0 - 1 + p;
    const bool ok = d + dz >= 0 && d + dz < depth && h >= 0 && h < H &&
                    ww >= 0 && ww < W;
    const ptrdiff_t px = ok ? ((ptrdiff_t)(n + dz) * H + h) * W + ww : 0;
    const int off = r * pitch * stride + p * stride;
    if constexpr (U > 0) {
      cp_async<U>(hs + swz(off + k * U),
                  reinterpret_cast<const char*>(x + px * C) + (ok ? k * U : 0),
                  ok);
    } else {
      *reinterpret_cast<T*>(hs + swz(off + k * (int)sizeof(T))) =
          ok ? x[px * C + k] : zero<T>();
    }
  }
}

// stage_halo with the widest copy unit that divides a pixel's C channels:
// 16, 8 or 4 bytes, element by element where none does (odd C in bf16);
// the stem's C = 12 (3 units of 8 bytes in bf16, of 16 in f32) with its
// index arithmetic by constants.
template <typename T, int HR, int HW, typename Swz>
__device__ __forceinline__ void stage_halo_unit(uint8_t* hs, const T* x,
                                                int n, int depth, int H,
                                                int W, int C, int KZ, int h0,
                                                int w0, int pitch, int stride,
                                                int threads, Swz swz) {
  const int bytes = C * (int)sizeof(T);
  if (C == 12) {
    constexpr int kU = sizeof(T) == 2 ? 8 : 16;
    stage_halo<T, HR, HW, kU, 3>(hs, x, n, depth, H, W, C, KZ, h0, w0, pitch,
                                 stride, threads, swz);
    return;
  }
  switch (copy_unit(bytes)) {
    case 16:
      stage_halo<T, HR, HW, 16, 0>(hs, x, n, depth, H, W, C, KZ, h0, w0,
                                   pitch, stride, threads, swz);
      break;
    case 8:
      stage_halo<T, HR, HW, 8, 0>(hs, x, n, depth, H, W, C, KZ, h0, w0,
                                  pitch, stride, threads, swz);
      break;
    case 4:
      stage_halo<T, HR, HW, 4, 0>(hs, x, n, depth, H, W, C, KZ, h0, w0,
                                  pitch, stride, threads, swz);
      break;
    default:
      stage_halo<T, HR, HW, 0, 0>(hs, x, n, depth, H, W, C, KZ, h0, w0,
                                  pitch, stride, threads, swz);
  }
}

// The f32 kernels' halo buffers: KZ planes x HR rows x HW pixels x C
// floats, dense, rounded up to 1024 bytes.
__host__ __device__ __forceinline__ int f32_halo_floats(int KZ, int HR,
                                                        int HW, int C) {
  return (KZ * HR * HW * C + 255) / 256 * 256;
}

// Loads the f32 halo of the tile at (n, h0, w0) into buffer b: one TMA box
// of x seen as (volumes, depth, H, W, C), planes d - KZ/2 .. (zeros past
// the volume and the plane: the box's out-of-bounds fill), counted in bytes
// on bar[b], where the tensor map exists (C % 4 == 0: 16-byte pixel
// strides); else cp.async by every thread.  wait() waits for the k-th load
// into buffer b.
template <int HR, int HW>
struct F32Halo {
  const CUtensorMap* map;
  bool tma;
  float* buf;
  int floats;
  uint64_t* bar;
  const float* x;
  int depth, H, W, C, KZ, threads;

  __device__ __forceinline__ void init() const {
    if (tma && threadIdx.x == 0) {
      mbar_init(&bar[0], 1);
      mbar_init(&bar[1], 1);
      fence_barrier_init();
    }
  }
  __device__ __forceinline__ void load(int b, int n, int h0, int w0) const {
    float* dst = buf + b * floats;
    if (tma) {
      if (threadIdx.x == 0) {
        mbar_expect_tx(&bar[b], KZ * HR * HW * C * 4);
        tma_load_5d(dst, map, &bar[b], 0, w0 - 1, h0 - 1,
                    n % depth - KZ / 2, n / depth);
      }
    } else {
      stage_halo_unit<float, HR, HW>(reinterpret_cast<uint8_t*>(dst), x, n,
                                     depth, H, W, C, KZ, h0, w0, HW, C * 4,
                                     threads, Plain());
    }
  }
  __device__ __forceinline__ void wait(int b, int k) const {
    if (tma) mbar_wait(&bar[b], k & 1);
  }
};

// Zeroes `bytes` (a multiple of 16) of shared memory from p.
__device__ __forceinline__ void zero_smem(uint8_t* p, int bytes,
                                          int threads) {
  for (int i = threadIdx.x; i < bytes / 16; i += threads)
    reinterpret_cast<uint4*>(p)[i] = make_uint4(0u, 0u, 0u, 0u);
}

// bf16 halo bytes of one buffer: KZ planes x HR rows x pitch pixels x 32 B,
// rounded up to 1024 (each buffer starts on the swizzle's 1024-byte grid)
__host__ __device__ __forceinline__ int bf_halo_bytes(int KZ, int HR,
                                                      int pitch) {
  return (KZ * HR * pitch * kPx + 1023) / 1024 * 1024;
}

// ---- bf16 forward ----------------------------------------------------------

__global__ void __launch_bounds__(kBfWG * 128, 2)
few_forward_bf16_kernel(const bf16* __restrict__ x,
                        const bf16* __restrict__ wk, bf16* __restrict__ y,
                        int depth, int H, int W, int C, int CO, int KZ,
                        int tiles_w, int tiles_per_plane, int n_tiles) {
  constexpr int kThreads = kBfWG * 128;
  extern __shared__ uint8_t smem_raw[];
  const int steps = KZ * 9;  // one k16 step (16 channels) per tap
  // [B: steps x 1 KB] [halo x 2]
  uint8_t* sb = align_1024(smem_raw);
  uint8_t* halo = sb + steps * 1024;
  const int hb = bf_halo_bytes(KZ, kBfHR, kBfHW);
  const int co0 = blockIdx.y * kBN;

  zero_smem(halo, 2 * hb, kThreads);  // channels C .. 15 stay zero
  // the packed weights (k = tap * 16 + ci): one 32-byte row per output
  // channel per tap, the 32-byte swizzle
  for (int i = threadIdx.x; i < steps * 16 * kBN; i += kThreads) {
    const int k = i / kBN, c = i % kBN;
    const bf16 v = co0 + c < CO ? wk[(size_t)k * CO + co0 + c] : zero<bf16>();
    *reinterpret_cast<bf16*>(
        sb + swz32((k / 16) * 1024 + c * 32 + (k % 16) * 2)) = v;
  }
  __syncthreads();  // the zeros land before the first copies

  const int wg = threadIdx.x / 128, warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  // the row this lane addresses for ldmatrix: matrix q = lane / 8 is
  // (pixels 0-7 | 8-15 of the warp's 16) x (channels 0-7 | 8-15)
  const int lpix = 16 * warp + lane % 8 + 8 * ((lane / 8) & 1);
  const int lchunk = 16 * (lane / 16);
  auto stage = [&](uint8_t* hs, int tile) {
    const int n = tile / tiles_per_plane, tt = tile % tiles_per_plane;
    stage_halo_unit<bf16, kBfHR, kBfHW>(hs, x, n, depth, H, W, C, KZ,
                                        (tt / tiles_w) * kBfWG,
                                        (tt % tiles_w) * kBfRow, kBfHW, kPx,
                                        kThreads, Swz32());
  };

  int tile = blockIdx.x;
  if (tile < n_tiles) stage(halo, tile);
  cp_async_commit();
  for (int it = 0; tile < n_tiles; ++it, tile += gridDim.x) {
    cp_async_wait<0>();
    fence_proxy_async();  // the halo and the weights are read by wgmma
    __syncthreads();
    const uint8_t* hs = halo + (it & 1) * hb;
    if (tile + (int)gridDim.x < n_tiles)
      stage(halo + ((it + 1) & 1) * hb, tile + gridDim.x);
    cp_async_commit();

    float acc[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[i] = 0.f;
    fence_operands(acc);
    // a row of taps (kz, ky, kx = 0..2) per wgmma group; the fragments of
    // a row are loaded once its predecessor has retired (loading them while
    // it runs makes ptxas serialize the wgmmas), the other warpgroups of the
    // SM filling the tensor cores meanwhile
    uint32_t fr[3][4];
    auto load = [&](int row, uint32_t(&f)[3][4]) {
      const int base = ((row / 3) * kBfHR + wg + row % 3) * kBfHW + lpix;
#pragma unroll
      for (int kx = 0; kx < 3; ++kx)
        ldmatrix_x4(f[kx], hs + swz32((base + kx) * kPx + lchunk));
    };
    auto issue = [&](int row, uint32_t(&f)[3][4]) {
      wgmma_fence();
#pragma unroll
      for (int kx = 0; kx < 3; ++kx)
        wgmma_m64n32k16_rs(
            acc, f[kx],
            smem_desc(sb + (row * 3 + kx) * 1024, 16, 8 * kPx, kPx));
      wgmma_commit();
    };
    for (int row = 0; row < 3 * KZ; ++row) {
      load(row, fr);
      issue(row, fr);
      wgmma_wait<0>();
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) fence_regs(fr[kx]);
    }
    fence_operands(acc);

    const int n = tile / tiles_per_plane, tt = tile % tiles_per_plane;
    const int h = (tt / tiles_w) * kBfWG + wg;
    if (h < H) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int w = (tt % tiles_w) * kBfRow + 16 * warp + g + 8 * i;
        if (w >= W) continue;
        bf16* yp = y + (((size_t)n * H + h) * W + w) * CO;
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j) {
          const int co = co0 + 8 * j + 2 * t;
          if (co < CO) store_pair(yp + co, acc[4 * j + 2 * i],
                                  acc[4 * j + 2 * i + 1]);
        }
      }
    }
  }
}

// ---- f32 forward -----------------------------------------------------------

__global__ void __launch_bounds__(kFThreads)
few_forward_f32_kernel(const __grid_constant__ CUtensorMap tmx, int tma,
                       const float* __restrict__ x,
                       const float* __restrict__ wk,
                       const float* __restrict__ wk_lo, float* __restrict__ y,
                       int depth, int H, int W, int C, int CO, int KZ, int Kp,
                       int tiles_w, int tiles_per_plane, int n_tiles) {
  extern __shared__ uint8_t smem_raw[];
  const int steps = Kp / 8;
  // [B_hi: steps x 1 KB] [B_lo] [(step, t) -> halo offsets of the thread's
  // two k] [halo x 2] [2 mbarriers]
  uint8_t* sb = align_1024(smem_raw);
  int2* ktab = reinterpret_cast<int2*>(sb + 2 * steps * 1024);
  const int hn = f32_halo_floats(KZ, kFHR, kFHW, C);
  float* halo = reinterpret_cast<float*>(
      sb + 2 * steps * 1024 + (steps * 32 + 1023) / 1024 * 1024);
  const F32Halo<kFHR, kFHW> hl{&tmx, tma != 0, halo, hn,
                               reinterpret_cast<uint64_t*>(halo + 2 * hn), x,
                               depth, H, W, C, KZ, kFThreads};
  hl.init();
  const int co0 = blockIdx.y * kBN;

  for (int i = threadIdx.x; i < Kp * kBN; i += kFThreads) {
    const int k = i / kBN, c = i % kBN;
    const int off = swz32((k / 8) * 1024 + c * 32 + (k % 8) * 4);
    const bool ok = co0 + c < CO;
    const size_t src = (size_t)k * CO + co0 + c;
    *reinterpret_cast<float*>(sb + off) = ok ? wk[src] : 0.f;
    *reinterpret_cast<float*>(sb + steps * 1024 + off) =
        ok ? wk_lo[src] : 0.f;
  }
  // the thread's k in step s: 8 s + t and 4 further (wgmma's tf32 A
  // fragment), as halo offsets (-1 past the valid K: zero)
  const int kvalid = KZ * 9 * C;
  auto koff = [&](int k) {
    if (k >= kvalid) return -1;
    const int tap = k / C, ci = k % C;
    return (((tap / 9) * kFHR + (tap / 3) % 3) * kFHW + tap % 3) * C + ci;
  };
  for (int i = threadIdx.x; i < steps * 4; i += kFThreads) {
    const int k = (i / 4) * 8 + i % 4;
    ktab[i] = make_int2(koff(k), koff(k + 4));
  }
  fence_proxy_async();  // the weights are read by wgmma (async proxy)

  const int wg = threadIdx.x / 128, warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  // this thread's fragment rows: pixels (m0 / 16, m0 % 16) and 8 further
  const int m0 = wg * 64 + warp * 16 + g;
  const int pix0 = ((m0 / kFW) * kFHW + m0 % kFW) * C;
  const int pix1 = pix0 + 8 * C;

  auto stage = [&](int b, int tile) {
    const int n = tile / tiles_per_plane, tt = tile % tiles_per_plane;
    hl.load(b, n, (tt / tiles_w) * kFH, (tt % tiles_w) * kFW);
  };

  __syncthreads();  // the mbarriers are initialised
  int tile = blockIdx.x;
  if (tile < n_tiles) stage(0, tile);
  cp_async_commit();
  for (int it = 0; tile < n_tiles; ++it, tile += gridDim.x) {
    const float* hs = halo + (it & 1) * hn;
    if (tile + (int)gridDim.x < n_tiles) stage((it + 1) & 1, tile + gridDim.x);
    cp_async_commit();
    cp_async_wait<1>();
    hl.wait(it & 1, it >> 1);
    __syncthreads();

    float acc[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[i] = 0.f;
    fence_operands(acc);
    // kFGroup steps per wgmma group, two groups' fragments ([hi 4, lo 4]
    // per step): the next group is gathered while the last one runs
    uint32_t fr[2][kFGroup][8] = {};
    auto gather = [&](int s0, uint32_t(&f)[kFGroup][8]) {
#pragma unroll
      for (int j = 0; j < kFGroup; ++j) {
        if (s0 + j >= steps) break;
        const int2 ko = ktab[(s0 + j) * 4 + t];
        const float v[4] = {ko.x >= 0 ? hs[pix0 + ko.x] : 0.f,
                            ko.x >= 0 ? hs[pix1 + ko.x] : 0.f,
                            ko.y >= 0 ? hs[pix0 + ko.y] : 0.f,
                            ko.y >= 0 ? hs[pix1 + ko.y] : 0.f};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const uint32_t hi = cvt_tf32(v[q]);
          f[j][q] = hi;
          f[j][4 + q] = cvt_tf32(__fsub_rn(v[q], __uint_as_float(hi)));
        }
      }
    };
    auto issue = [&](int s0, uint32_t(&f)[kFGroup][8]) {
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < kFGroup; ++j) {
        const int s = s0 + j;
        if (s >= steps) break;
        const uint32_t(&hi)[4] = *reinterpret_cast<uint32_t(*)[4]>(f[j]);
        const uint32_t(&lo)[4] = *reinterpret_cast<uint32_t(*)[4]>(f[j] + 4);
        const uint64_t db = smem_desc(sb + s * 1024, 16, 256, 32);
        const uint64_t dbl = smem_desc(sb + (steps + s) * 1024, 16, 256, 32);
        wgmma_m64n32k8_tf32(acc, lo, db);
        wgmma_m64n32k8_tf32(acc, hi, dbl);
        wgmma_m64n32k8_tf32(acc, hi, db);
      }
      wgmma_commit();
    };
    auto fence_group = [&](uint32_t(&f)[kFGroup][8]) {
#pragma unroll
      for (int j = 0; j < kFGroup; ++j) fence_regs(f[j]);
    };
    for (int s0 = 0; s0 < steps; s0 += 2 * kFGroup) {
      gather(s0, fr[0]);
      issue(s0, fr[0]);
      wgmma_wait<1>();
      fence_group(fr[1]);  // the previous group has retired
      if (s0 + kFGroup < steps) {
        gather(s0 + kFGroup, fr[1]);
        issue(s0 + kFGroup, fr[1]);
        wgmma_wait<1>();
        fence_group(fr[0]);
      }
    }
    wgmma_wait<0>();
    fence_group(fr[0]);
    fence_group(fr[1]);
    fence_operands(acc);

    const int n = tile / tiles_per_plane, tt = tile % tiles_per_plane;
    const int h0 = (tt / tiles_w) * kFH, w0 = (tt % tiles_w) * kFW;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = m0 + 8 * i;
      const int h = h0 + r / kFW, w = w0 + r % kFW;
      if (h >= H || w >= W) continue;
      float* yp = y + (((size_t)n * H + h) * W + w) * CO;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        const int co = co0 + 8 * j + 2 * t;
        if (co < CO) store_pair(yp + co, acc[4 * j + 2 * i],
                                acc[4 * j + 2 * i + 1]);
      }
    }
    __syncthreads();  // the halo buffer is free for the tile after next
  }
}

// ---- bf16 weight gradient --------------------------------------------------

__global__ void __launch_bounds__(kBgWG * 128, 2)
few_wgrad_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dy,
                      float* __restrict__ part, int depth, int H, int W,
                      int C, int CO, int KZ, int tiles_w, int tiles_per_plane,
                      int n_tiles, int tiles_per_split) {
  constexpr int kThreads = kBgWG * 128;
  constexpr int kPos = kBgH * kBgW;
  constexpr int kDyBytes = kPos * kBN * 2;  // 64-byte rows, one per position
  extern __shared__ uint8_t smem_raw[];
  // [dy x 2] [halo x 2]
  uint8_t* dys = align_1024(smem_raw);
  uint8_t* halo = dys + 2 * kDyBytes;
  const int hb = bf_halo_bytes(KZ, kBgHR, kBgHW);

  const int co0 = blockIdx.y * kBN;
  const int t_begin = blockIdx.x * tiles_per_split;
  const int t_end = min(n_tiles, t_begin + tiles_per_split);
  const int ky = threadIdx.x / 128;  // the warpgroup's ky

  zero_smem(halo, 2 * hb, kThreads);  // channels C .. 15, pixels 18, 19
  __syncthreads();

  auto stage = [&](int b, int tile) {
    const int n = tile / tiles_per_plane, tt = tile % tiles_per_plane;
    const int h0 = (tt / tiles_w) * kBgH, w0 = (tt % tiles_w) * kBgW;
    stage_halo_unit<bf16, kBgHR, kBgW + 2>(halo + b * hb, x, n, depth, H, W,
                                           C, KZ, h0, w0, kBgHW, kPx,
                                           kThreads, Swz32());
    uint8_t* d = dys + b * kDyBytes;
    // 16-byte chunks of dy[n, h0 + p / 16, w0 + p % 16, co0 : co0 + 32],
    // MN-major 64-byte rows with the 64-byte swizzle (chunk ^= bits 7-8)
    for (int c = threadIdx.x; c < kPos * 4; c += kThreads) {
      const int p = c / 4, j = c % 4;
      const int h = h0 + p / kBgW, w = w0 + p % kBgW, co = co0 + 8 * j;
      const bool ok = h < H && w < W && co < CO;
      cp_async<16>(d + p * 64 + ((j ^ ((p >> 1) & 3)) << 4),
                   ok ? dy + (((size_t)n * H + h) * W + w) * CO + co : dy,
                   ok);
    }
  };

  float acc[3][16];
#pragma unroll
  for (int kz = 0; kz < 3; ++kz) {
#pragma unroll
    for (int q = 0; q < 16; ++q) acc[kz][q] = 0.f;
    fence_operands(acc[kz]);
  }
  if (t_begin < t_end) stage(0, t_begin);
  cp_async_commit();
  for (int it = 0, tile = t_begin; tile < t_end; ++it, ++tile) {
    cp_async_wait<0>();
    fence_proxy_async();  // halo and dy are read by wgmma (async proxy)
    __syncthreads();
    const uint8_t* hs = halo + (it & 1) * hb;
    const uint8_t* d = dys + (it & 1) * kDyBytes;
    wgmma_fence();
#pragma unroll
    for (int kz = 0; kz < 3; ++kz) {
      if (kz >= KZ) break;
#pragma unroll
      for (int r = 0; r < kBgH; ++r) {
        // K: the 16 positions of row r; M: (kx, ci), atom kx one pixel on
        const uint8_t* a = hs + (kz * kBgHR + r + ky) * kBgHW * kPx;
        wgmma_m64n32k16<1, 1>(acc[kz], smem_desc(a, kPx, 8 * kPx, kPx),
                              smem_desc(d + r * 16 * 64, kDyBytes, 512, 64));
      }
    }
    wgmma_commit();
    wgmma_wait<1>();
    __syncthreads();  // every warpgroup has retired the previous stage
    if (tile + 1 < t_end) stage((it + 1) & 1, tile + 1);
    cp_async_commit();
  }
  wgmma_wait<0>();
#pragma unroll
  for (int kz = 0; kz < 3; ++kz) fence_operands(acc[kz]);

  // rows of warp w: kx = w (w = 3 is padding), ci = g, g + 8
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  if (warp == 3) return;
  float* out = part + (size_t)blockIdx.x * KZ * 9 * C * CO;
#pragma unroll
  for (int kz = 0; kz < 3; ++kz) {
    if (kz >= KZ) break;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int ci = g + 8 * i;
      if (ci >= C) continue;
      const int row = ((kz * 3 + ky) * 3 + warp) * C + ci;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        const int co = co0 + 8 * j + 2 * t;
        if (co < CO)
          *reinterpret_cast<float2*>(out + (size_t)row * CO + co) =
              make_float2(acc[kz][4 * j + 2 * i], acc[kz][4 * j + 2 * i + 1]);
      }
    }
  }
}

// ---- f32 weight gradient ---------------------------------------------------

// MT: m64 tiles per warpgroup (the warpgroup's tiles are wg, wg + 6, ...).
template <int MT>
__global__ void __launch_bounds__(kGThreads, 1)
few_wgrad_f32_kernel(const __grid_constant__ CUtensorMap tmx, int tma,
                     const float* __restrict__ x, const float* __restrict__ dy,
                     float* __restrict__ part, int depth, int H, int W, int C,
                     int CO, int KZ, int tiles_w, int tiles_per_plane,
                     int n_tiles, int tiles_per_split) {
  constexpr int kDyBytes = kGPos * kRawRow * 4;
  constexpr int kSteps = kGPos / 8;
  extern __shared__ uint8_t smem_raw[];
  // [dyT_hi, dyT_lo] [dy x 2] [halo x 2] [promoted sums] [2 mbarriers]
  uint8_t* dyt = align_1024(smem_raw);
  uint8_t* dys = dyt + 2 * kDyT;
  const int hn = f32_halo_floats(KZ, kGHR, kGHW, C);
  float* halo = reinterpret_cast<float*>(dys + 2 * kDyBytes);
  // tot[(i * 16 + q) * kGThreads + thread]: the rounded sums the
  // accumulators are promoted into (registers hold two fragment sets and
  // two accumulators per tile instead)
  float* tot = halo + 2 * hn;
  const F32Halo<kGHR, kGHW> hl{&tmx, tma != 0, halo, hn,
                               reinterpret_cast<uint64_t*>(
                                   tot + MT * 16 * kGThreads),
                               x, depth, H, W, C, KZ, kGThreads};
  hl.init();

  const int co0 = blockIdx.y * kBN;
  const int t_begin = blockIdx.x * tiles_per_split;
  const int t_end = min(n_tiles, t_begin + tiles_per_split);

  const int wg = threadIdx.x / 128, warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  // M rows m = (tap, ci), tap-major as dW; this thread's fragment rows in
  // its warpgroup's m64 tiles: their halo offsets at position 0, -1 past
  // KZ x 9 x C
  const int mrows = KZ * 9 * C;
  const int my_tiles =
      min(MT, ((mrows + 63) / 64 - wg + kGWG - 1) / kGWG);
  int roff[MT][2];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int m = 64 * (wg + kGWG * i) + 16 * warp + g + 8 * r;
      const int tap = m / C, ci = m % C;
      roff[i][r] =
          m < mrows
              ? (((tap / 9) * kGHR + (tap / 3) % 3) * kGHW + tap % 3) * C + ci
              : -1;
    }

  // per tile: [0] the hi B_hi products, [1] the corrections lo B_hi and
  // hi B_lo (two chains of dependent wgmmas, not one)
  float acc[MT][2][16];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int p = 0; p < 2; ++p) {
#pragma unroll
      for (int q = 0; q < 16; ++q) acc[i][p][q] = 0.f;
      fence_operands(acc[i][p]);
    }
#pragma unroll
    for (int q = 0; q < 16; ++q)
      tot[(i * 16 + q) * kGThreads + threadIdx.x] = 0.f;
  }

  auto stage = [&](int b, int tile) {
    const int n = tile / tiles_per_plane, tt = tile % tiles_per_plane;
    const int h0 = (tt / tiles_w) * kGH, w0 = (tt % tiles_w) * kGW;
    hl.load(b, n, h0, w0);
    uint8_t* d = dys + b * kDyBytes;
    // 16-byte chunks of dy[n, h0 + p / 16, w0 + p % 16, co0 : co0 + 32],
    // plain rows of kRawRow floats
    for (int c = threadIdx.x; c < kGPos * 8; c += kGThreads) {
      const int p = c / 8, j = c % 8;
      const int h = h0 + p / kGW, w = w0 + p % kGW, co = co0 + 4 * j;
      const bool ok = h < H && w < W && co < CO;
      cp_async<16>(d + p * kRawRow * 4 + j * 16,
                   ok ? dy + (((size_t)n * H + h) * W + w) * CO + co : dy,
                   ok);
    }
  };

  uint32_t fr[2][8] = {};  // [buffer][hi 4, lo 4]
  __syncthreads();  // the mbarriers are initialised
  if (t_begin < t_end) stage(0, t_begin);
  cp_async_commit();
  for (int it = 0, tile = t_begin; tile < t_end; ++it, ++tile) {
    const int b = it & 1;
    if (tile + 1 < t_end) stage(b ^ 1, tile + 1);
    cp_async_commit();
    cp_async_wait<1>();
    hl.wait(b, it >> 1);
    const float* hs = halo + b * hn;
    const float* d = reinterpret_cast<const float*>(dys + b * kDyBytes);
    // dyT[s][co][8 positions] = tf32 hi and remainder of dy, K-major
    // 32-byte rows with the 32-byte swizzle, one 1 KB tile per k8 step
    __syncthreads();
    {
      const int co = (threadIdx.x / 8) % kBN, j8 = threadIdx.x % 8;
#pragma unroll
      for (int s = threadIdx.x / (8 * kBN); s < kSteps;
           s += kGThreads / (8 * kBN)) {
        const float v = d[(8 * s + j8) * kRawRow + co];
        const uint32_t hi = cvt_tf32(v);
        const int off = swz32(s * 1024 + co * 32 + j8 * 4);
        *reinterpret_cast<uint32_t*>(dyt + off) = hi;
        *reinterpret_cast<float*>(dyt + kDyT + off) =
            __fsub_rn(v, __uint_as_float(hi));
      }
    }
    fence_proxy_async();  // dyT is read by wgmma (async proxy)
    __syncthreads();

#pragma unroll
    for (int i = 0; i < MT; ++i) {
      if (i >= my_tiles) break;  // uniform over the warpgroup
      const int ra = roff[i][0], rb = roff[i][1];
#pragma unroll
      for (int s = 0; s < kSteps; ++s) {
        uint32_t(&f)[8] = fr[s & 1];
        // k8 step s: positions (s / 2, 8 (s % 2) + t) and 4 further
        const int p0 = ((s / 2) * kGHW + 8 * (s % 2) + t) * C;
        const float v[4] = {ra >= 0 ? hs[ra + p0] : 0.f,
                            rb >= 0 ? hs[rb + p0] : 0.f,
                            ra >= 0 ? hs[ra + p0 + 4 * C] : 0.f,
                            rb >= 0 ? hs[rb + p0 + 4 * C] : 0.f};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const uint32_t hi = cvt_tf32(v[q]);
          f[q] = hi;
          f[4 + q] = cvt_tf32(__fsub_rn(v[q], __uint_as_float(hi)));
        }
        const uint32_t(&hi)[4] = *reinterpret_cast<uint32_t(*)[4]>(f);
        const uint32_t(&lo)[4] = *reinterpret_cast<uint32_t(*)[4]>(f + 4);
        const uint64_t bh = smem_desc(dyt + s * 1024, 16, 256, 32);
        const uint64_t bl = smem_desc(dyt + kDyT + s * 1024, 16, 256, 32);
        wgmma_fence();
        wgmma_m64n32k8_tf32(acc[i][1], lo, bh);
        wgmma_m64n32k8_tf32(acc[i][0], hi, bh);
        wgmma_m64n32k8_tf32(acc[i][1], hi, bl);
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(fr[(s + 1) & 1]);  // the previous step's group retired
      }
    }
    wgmma_wait<0>();
    fence_regs(fr[0]);
    fence_regs(fr[1]);
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      fence_operands(acc[i][0]);
      fence_operands(acc[i][1]);
    }
    if ((it + 1) % kPromote == 0) {
#pragma unroll
      for (int i = 0; i < MT; ++i) {
#pragma unroll
        for (int q = 0; q < 16; ++q) {
          tot[(i * 16 + q) * kGThreads + threadIdx.x] +=
              acc[i][0][q] + acc[i][1][q];
          acc[i][0][q] = acc[i][1][q] = 0.f;
        }
        fence_operands(acc[i][0]);
        fence_operands(acc[i][1]);
      }
    }
    __syncthreads();  // this stage's buffers are free for the next refill
  }

  float* out = part + (size_t)blockIdx.x * KZ * 9 * C * CO;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    if (i >= my_tiles) break;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int m = 64 * (wg + kGWG * i) + 16 * warp + g + 8 * r;
      if (roff[i][r] < 0) continue;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        const int co = co0 + 8 * j + 2 * t;
        const int q = 4 * j + 2 * r;
        const float* tq = tot + (i * 16 + q) * kGThreads + threadIdx.x;
        if (co < CO)
          *reinterpret_cast<float2*>(out + (size_t)m * CO + co) =
              make_float2(tq[0] + (acc[i][0][q] + acc[i][1][q]),
                          tq[kGThreads] +
                              (acc[i][0][q + 1] + acc[i][1][q + 1]));
      }
    }
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

// Sets the kernel's dynamic shared memory to at least `smem` bytes (once
// per size that grows it).
template <typename K>
cudaError_t allow_smem(K kernel, int smem, int& configured) {
  if (smem <= configured) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess) configured = smem;
  return e;
}

// Blocks for a persistent grid: as many as the device holds at once, split
// over `co_tiles` output-channel tiles, at most one per tile.
template <typename K>
int persistent_blocks(K kernel, int threads, int smem, int n_tiles,
                      int co_tiles, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess ||
      (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, threads, smem)) != cudaSuccess)
    return static_cast<int>(e);
  *blocks =
      std::max(1, std::min(n_tiles, std::max(1, per_sm) * sms / co_tiles));
  return 0;
}

int launch_forward_bf16(const void* x, const void* wk, void* y, int N,
                        int depth, int H, int W, int C, int CO, int KZ,
                        int Kp, cudaStream_t s) {
  if (Kp != KZ * 9 * 16) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = 1024 + KZ * 9 * 1024 + 2 * bf_halo_bytes(KZ, kBfHR, kBfHW);
  static int configured = 0;
  const cudaError_t e = allow_smem(few_forward_bf16_kernel, smem, configured);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles_w = (W + kBfRow - 1) / kBfRow;
  const int tiles_per_plane = ((H + kBfWG - 1) / kBfWG) * tiles_w;
  const int n_tiles = N * tiles_per_plane;
  const int co_tiles = (CO + kBN - 1) / kBN;
  int blocks = 0;
  const int err = persistent_blocks(few_forward_bf16_kernel, kBfWG * 128,
                                    smem, n_tiles, co_tiles, &blocks);
  if (err != 0) return err;
  few_forward_bf16_kernel<<<dim3(blocks, co_tiles), kBfWG * 128, smem, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wk),
      static_cast<bf16*>(y), depth, H, W, C, CO, KZ, tiles_w,
      tiles_per_plane, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

// The TMA map of an f32 halo box (KZ planes x HR rows x HW pixels x C) of
// x seen as (volumes, depth, H, W, C): built where C % 4 == 0 (TMA needs
// 16-byte strides between pixels); *tma = 0 elsewhere (cp.async).
bool f32_halo_map(CUtensorMap* map, int* tma, const void* x, int N,
                  int depth, int H, int W, int C, int KZ, int HR, int HW) {
  *tma = 0;
  if (C % 4 != 0) return true;
  const cuuint64_t dims[5] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H,
                              (cuuint64_t)depth, (cuuint64_t)(N / depth)};
  const cuuint64_t strides[4] = {
      (cuuint64_t)C * 4, (cuuint64_t)W * C * 4, (cuuint64_t)H * W * C * 4,
      (cuuint64_t)depth * H * W * C * 4};
  const cuuint32_t box[5] = {(cuuint32_t)C, (cuuint32_t)HW, (cuuint32_t)HR,
                             (cuuint32_t)KZ, 1};
  if (!make_map(map, x, 5, dims, strides, box,
                CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, false))
    return false;
  *tma = 1;
  return true;
}

int launch_forward_f32(const void* x, const void* wk, const void* wk_lo,
                       void* y, int N, int depth, int H, int W, int C, int CO,
                       int KZ, int Kp, cudaStream_t s) {
  if (Kp != (KZ * 9 * C + 7) / 8 * 8 || wk_lo == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tmx = {};
  int tma = 0;
  if (!f32_halo_map(&tmx, &tma, x, N, depth, H, W, C, KZ, kFHR, kFHW))
    return static_cast<int>(cudaErrorInvalidValue);
  const int steps = Kp / 8;
  const int smem = 1024 + 2 * steps * 1024 +
                   (steps * 32 + 1023) / 1024 * 1024 +
                   2 * f32_halo_floats(KZ, kFHR, kFHW, C) * 4 + 16;
  static int configured = 0;
  const cudaError_t e = allow_smem(few_forward_f32_kernel, smem, configured);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles_w = (W + kFW - 1) / kFW;
  const int tiles_per_plane = ((H + kFH - 1) / kFH) * tiles_w;
  const int n_tiles = N * tiles_per_plane;
  const int co_tiles = (CO + kBN - 1) / kBN;
  int blocks = 0;
  const int err = persistent_blocks(few_forward_f32_kernel, kFThreads, smem,
                                    n_tiles, co_tiles, &blocks);
  if (err != 0) return err;
  few_forward_f32_kernel<<<dim3(blocks, co_tiles), kFThreads, smem, s>>>(
      tmx, tma, static_cast<const float*>(x), static_cast<const float*>(wk),
      static_cast<const float*>(wk_lo), static_cast<float*>(y), depth, H, W,
      C, CO, KZ, Kp, tiles_w, tiles_per_plane, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

int launch_wgrad_bf16(const void* x, const void* dy, float* part, int N,
                      int depth, int H, int W, int C, int CO, int KZ,
                      int splits, cudaStream_t s) {
  const int smem = 1024 + 2 * kBgH * kBgW * kBN * 2 +
                   2 * bf_halo_bytes(KZ, kBgHR, kBgHW);
  static int configured = 0;
  const cudaError_t e = allow_smem(few_wgrad_bf16_kernel, smem, configured);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles_w = (W + kBgW - 1) / kBgW;
  const int tiles_per_plane = ((H + kBgH - 1) / kBgH) * tiles_w;
  const int n_tiles = N * tiles_per_plane;
  few_wgrad_bf16_kernel<<<dim3(splits, (CO + kBN - 1) / kBN), kBgWG * 128,
                          smem, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(dy), part, depth,
      H, W, C, CO, KZ, tiles_w, tiles_per_plane, n_tiles,
      (n_tiles + splits - 1) / splits);
  return static_cast<int>(cudaGetLastError());
}

template <int MT>
int launch_wgrad_f32(const void* x, const void* dy, float* part, int N,
                     int depth, int H, int W, int C, int CO, int KZ,
                     int splits, cudaStream_t s) {
  CUtensorMap tmx = {};
  int tma = 0;
  if (!f32_halo_map(&tmx, &tma, x, N, depth, H, W, C, KZ, kGHR, kGHW))
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = 1024 + 2 * kDyT + 2 * kGPos * kRawRow * 4 +
                   2 * f32_halo_floats(KZ, kGHR, kGHW, C) * 4 +
                   MT * 16 * kGThreads * 4 + 16;
  static int configured = 0;
  const cudaError_t e = allow_smem(few_wgrad_f32_kernel<MT>, smem, configured);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles_w = (W + kGW - 1) / kGW;
  const int tiles_per_plane = ((H + kGH - 1) / kGH) * tiles_w;
  const int n_tiles = N * tiles_per_plane;
  few_wgrad_f32_kernel<MT><<<dim3(splits, (CO + kBN - 1) / kBN), kGThreads,
                             smem, s>>>(
      tmx, tma, static_cast<const float*>(x), static_cast<const float*>(dy), part,
      depth, H, W, C, CO, KZ, tiles_w, tiles_per_plane, n_tiles,
      (n_tiles + splits - 1) / splits);
  return static_cast<int>(cudaGetLastError());
}

// The f32 weight gradient's m64 tiles per warpgroup: a sixth of the
// KZ x 9 x C rows' tiles, rounded up (C = 12, KZ = 3: 324 rows, six tiles,
// one each; C = 15: seven).
int launch_wgrad_f32_mt(const void* x, const void* dy, float* part, int N,
                        int depth, int H, int W, int C, int CO, int KZ,
                        int splits, cudaStream_t s) {
  if ((KZ * 9 * C + 63) / 64 <= kGWG)
    return launch_wgrad_f32<1>(x, dy, part, N, depth, H, W, C, CO, KZ, splits,
                               s);
  return launch_wgrad_f32<2>(x, dy, part, N, depth, H, W, C, CO, KZ, splits,
                             s);
}

bool misaligned(const void* p) {
  return reinterpret_cast<uintptr_t>(p) & 15;
}

bool bad_shape(int N, int depth, int H, int W, int C, int CO, int KZ,
               int dtype) {
  return N <= 0 || depth <= 0 || N % depth != 0 || H <= 0 || W <= 0 ||
         C < 2 || C > 15 || CO <= 0 || CO % 8 != 0 || (KZ != 1 && KZ != 3) ||
         (dtype != 0 && dtype != 1);
}

}  // namespace

// x (N, H, W, C) and y (N, H, W, CO) NHWC, contiguous, x and y 16-byte
// aligned, one type: dtype 0 = f32, 1 = bf16; 1 < C < 16, CO % 8 == 0.
// wk: the weights packed in the K order (kz, ky, kx, ci), a (Kp, CO) matrix
// (`pack_few_weights`): bf16 16 rows per tap (ci padded with zeros), Kp =
// KZ*9*16; f32 C rows per tap, zero rows past KZ*9*C up to Kp, a multiple
// of 8, wk = the tf32 part and wk_lo the remainder (bf16: wk_lo unused,
// may be null).  Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for arguments the kernel does not take).
extern "C" int dgtta_conv3x3_few(const void* x, const void* wk,
                                 const void* wk_lo, void* y, int N, int depth,
                                 int H, int W, int C, int CO, int KZ, int Kp,
                                 int dtype, void* stream) {
  if (bad_shape(N, depth, H, W, C, CO, KZ, dtype) || misaligned(x) ||
      misaligned(y) || wk == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_forward_f32(x, wk, wk_lo, y, N, depth, H, W, C, CO, KZ, Kp,
                              s);
  return launch_forward_bf16(x, wk, y, N, depth, H, W, C, CO, KZ, Kp, s);
}

// x (N, H, W, C) and dy (N, H, W, CO) NHWC, contiguous and 16-byte aligned,
// dtype 0 = f32, 1 = bf16; 1 < C < 16, CO % 8 == 0; dw (KZ, 3, 3, C, CO)
// f32; scratch holds splits * KZ*9*C*CO f32 (unused when splits == 1).
// Block b sums position tiles [b * ceil(tiles / splits), ...), a tile being
// 8 x 16 positions in bf16 and 4 x 16 in f32.  Returns cudaGetLastError()
// after the launches (cudaErrorInvalidValue for arguments the kernels do
// not take).
extern "C" int dgtta_conv3x3_wgrad_few(const void* x, const void* dy,
                                       void* dw, void* scratch, int N,
                                       int depth, int H, int W, int C, int CO,
                                       int KZ, int splits, int dtype,
                                       void* stream) {
  if (bad_shape(N, depth, H, W, C, CO, KZ, dtype) || splits <= 0 ||
      (splits > 1 && scratch == nullptr) || misaligned(x) || misaligned(dy) ||
      misaligned(dw))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = splits == 1 ? static_cast<float*>(dw)
                            : static_cast<float*>(scratch);
  const int err =
      dtype == 0 ? launch_wgrad_f32_mt(x, dy, part, N, depth, H, W, C, CO, KZ,
                                       splits, s)
                 : launch_wgrad_bf16(x, dy, part, N, depth, H, W, C, CO, KZ,
                                     splits, s);
  if (err != 0) return err;
  if (splits > 1) {
    const int m = KZ * 9 * C * CO;
    sum_splits_kernel<<<(m + 255) / 256, 256, 0, s>>>(
        part, static_cast<float*>(dw), m, splits);
  }
  return static_cast<int>(cudaGetLastError());
}
