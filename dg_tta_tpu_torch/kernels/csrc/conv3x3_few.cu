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
// x is read at its own C (no pad copy); C = 1 has conv3x3_c1.cu, and from
// C = 16 on the wgmma routes need no padding.
//
// The walk.  Every kernel cuts a member's planes into tiles of output
// pixels (or of positions) and orders its steps, zb output planes of one
// tile each (the forwards two, the weight gradients one), as s = (volume *
// tiles + tile) * ceil(depth / zb) + d / zb.  A block walks a contiguous
// run of steps (kernels/conv3x3.py::few_plan: one wave of blocks, 131 runs
// of 24 steps for the window forward, 132 of 516 for the f32 weight
// gradient of a trained step), so that it walks the planes of a tile in
// order and keeps the planes it reads in a ring in shared memory: each
// staged plane serves its three z-taps (the first design staged the three
// planes of every output plane anew: 3.8-5.1 staged pixels per output
// pixel, now 1.3-1.7).  Where a run starts, or crosses into the next tile
// or volume, it stages the planes before its first step's own again;
// planes outside the volume's group of `depth` planes are zeros, never the
// neighbouring volume's.  The ring is filled by cp.async, each thread
// waiting for its own copies before a barrier; the next step's planes are
// copied during the tensor work that does not read their slots.  The
// forwards' two output planes share each staged plane's A fragments (one
// accumulator each; a plane serves z-tap i - z of output plane z).  The
// forward writes every output plane from one step of one block: its bits
// do not depend on the batch.  The weight gradients write one partial sum
// per block into a scratch slice, and a second kernel adds the slices in a
// fixed order: deterministic, no atomics (with one split the first kernel
// writes dW).  KZ is a template argument and every wgmma descriptor a base
// plus offsets: descriptor arithmetic between two wgmmas (a
// generic-to-shared conversion, a ring modulo) took more time than the
// wgmmas in the first weight gradient of this design (its skeleton alone,
// no wgmma, ran 1.52 of its 1.80 ms).
//
// f32 (bound by its three tf32 products).  wgmma takes 32-bit A operands
// from shared memory only K-major, so A comes from registers by ldmatrix
// (16-byte rows of four tf32), split into tf32 hi (`round_tf32`: the bits
// of kernels/conv3x3.py::tf32_split) and the remainder (fed raw: the
// tensor core truncates it):
//   * forward: M = 16 x 16 output pixels (four warpgroups, a row of 16 per
//     warp), N = 32, K = the (kz, ky) rows of taps: 3 x Cs contiguous
//     floats from a pixel of the dense staged plane (Cs = C rounded up to
//     4, zero channels past C), padded to Kr = 40 at C = 12, five k8 steps
//     a row whose padded K reads the next pixel's first channels (finite;
//     zero rows of B; each plane's tail is zeroed once).  The 48-byte
//     pixels keep ldmatrix free of bank conflicts.  B = the weights in that
//     order, packed, split and swizzled by the kernel itself into K-major
//     32-byte rows (`pack_few_weights` is the same matrix as a plain tensor
//     op), staged once per block (90 KB).  A group is one k8 step of one
//     staged plane ((lo, B_hi), (hi, B_lo), (hi, B_hi) for each output
//     plane it serves), ky the rotation of three fragment sets, two groups
//     in flight.  A fragment is split as it is loaded and serves both
//     output planes: a staged value is split at each of its loads, 3 ky x
//     3 kx (and the padded K's reads), where the first design split it at
//     each of its 27 (kz, ky, kx) uses.  Splitting each staged value once,
//     into hi and lo planes as it landed, measured slower (a pass over the
//     plane and a ring twice the size; and no room for it at C of 13-15).
//     The ring holds the four raw planes a step reads and the next step's
//     two, copied at the top of the step (186 KB with the weights at C =
//     12).  At C of 13-15 (16-channel pixels, K = 48 a row of taps) six
//     planes do not fit: four slots, the next step's two copied from
//     mid-step on, into the slots of the first two once their fragments
//     are loaded.  K = 27 x 40 = 360: the truncating accumulation needs no
//     promotion;
//   * weight gradient: x plane d meets dy planes d + 1, d, d - 1: M = (ky,
//     kx, ci) rows (two m64 tiles for 108), one accumulator per z-tap, so
//     that A loads once for three wgmmas; N = 32; K = 6 x 8 positions a
//     step, four warpgroups (two m64 tiles x two halves of the step's rows,
//     the halves' sums added at the end).  A row's K quad must be four
//     positions 16 bytes apart, so each staged x plane is written, split,
//     as three kx-shifted channel-major copies (A_kx[ci][row][p] =
//     x[row][p + kx][ci], 68 floats a channel: four banks apart); each dy
//     plane is transposed and split into K-major B in a ring of four.  x
//     and dy come through double raw buffers, copied two steps ahead.  A
//     group is one k8 step (nine wgmmas), three a step, two in flight;
//     every kPromote steps (384 positions an accumulator) the accumulators
//     are added into rounded sums in shared memory (the tensor cores
//     truncate).
// bf16 (bound by bytes; the tensor cores have room): each staged pixel is
// one 32-byte row of 16 channels (C .. 15 zero, written once), with the
// 32-byte swizzle (16-byte chunk ^= bit 7 of the address), so that a tap
// is a shift of an operand's start:
//   * forward: M = a row of 64 output pixels per warpgroup (a 4 x 64
//     tile), N = 32, K = (kz, ky, kx, 16 channels), one k16 step per tap;
//     A by ldmatrix from the staged plane's row, B (the weights, packed by
//     the kernel) by descriptor.  A group is a (staged plane, ky) row of
//     three taps for each output plane it serves, ky the rotation of three
//     fragment sets, two groups in flight; the ring holds the four planes
//     a step reads and the two of the next step.  K stays 27 x 16 for 324
//     useful: folding the taps' 12 channels into K needs 16-byte rows that
//     start at 24-byte pixels, which ldmatrix refuses for every other
//     pixel (a table-driven gather was bound by the load units);
//   * weight gradient: M = (kx, ci) for one (kz, ky): 64 rows = four
//     16-channel atoms of an MN-major operand whose leading byte offset is
//     one pixel (32 bytes), so atom kx reads the halo shifted by kx pixels
//     (kx = 3 reads padding and is dropped), N = 32, K = the 16 positions of
//     a halo row per k16 step, B = dy, MN-major, cp.async'd into the
//     64-byte swizzle; both operands by descriptor, no gather.  Three
//     warpgroups, one per ky, each with KZ accumulators, one block an SM
//     (two spilled at 80 registers); 8 x 16 positions a step.  The ring
//     holds six planes and three dy tiles: the next step's copies are
//     started before this step's group, while the last one runs.  M stays
//     9 x 64 rows for 324 useful: an atom is 16 channels of one pixel, and
//     12-channel pixels would need a 24-byte leading offset.
//
// Members.  An ensemble chunk's members run side by side in one launch: x,
// y and dy hold `members` groups of N / members planes (a member's batch),
// w and dW one set of weights per member, and blockIdx.z is the member.
// Its blocks are those of a launch of that member alone, on its planes,
// its weights and its slices of the partial sums (the plan is computed
// from one member's planes): a member's outputs and weight gradient are
// the bits of a launch of it alone.

#include <cuda_bf16.h>
#include <stddef.h>

#include <algorithm>
#include <type_traits>

#include "hopper.cuh"

namespace {

using namespace dgtta;
using bf16 = __nv_bfloat16;

constexpr int kBN = 32;   // output channels per block
constexpr int kSmemMax = 232448;  // 227 KB: sm_90's opt-in shared memory
constexpr int kPx = 32;   // bf16 halo: bytes per pixel (16 channels)
// bf16 forward: four warpgroups, one row of 64 output pixels each
constexpr int kBfWG = 4;
constexpr int kBfRow = 64;
constexpr int kBfHR = kBfWG + 2, kBfHW = kBfRow + 2;
// bf16 weight gradient: three warpgroups (one per ky), 8 x 16 positions
// per step, halo rows of 20 pixels (16 + kx <= 3, the last two padding);
// six planes (two steps' groups in flight and the next plane) and three
// dy tiles in their rings
constexpr int kBgWG = 3;
constexpr int kBgH = 8, kBgW = 16;
constexpr int kBgHR = kBgH + 2, kBgHW = 20;
constexpr int kBgRing = 6, kBgDy = 3;
// f32 forward: four warpgroups, 16 x 16 output pixels
constexpr int kFThreads = 512;
constexpr int kFH = 16, kFW = 16;
constexpr int kFHR = kFH + 2, kFHW = kFW + 2;
// f32 weight gradient: four warpgroups, two m64 tiles of (ky, kx, ci) rows
// x two halves of a step's 6 x 8 positions (one k8 step per row); four dy
// planes in the ring (d - 1 .. d + 1 for this step; the last step's groups
// read d - 2 .. d)
constexpr int kGMT = 2;
constexpr int kGThreads = 2 * kGMT * 128;
constexpr int kGH = 6, kGW = 8;
constexpr int kGPos = kGH * kGW;
constexpr int kGHR = kGH + 2, kGHW = kGW + 2;
constexpr int kGCh = kGHR * kGW + 4;  // A_kx buffers: floats per channel
constexpr int kGDy = 4;
constexpr int kPromote = 16;  // f32 weight gradient: steps between promotions
constexpr int kRawRow = 36;  // f32 dy tile: floats per position row (144 B)
constexpr int kDyT = kGH * 1024;  // f32: one of dyT_hi, dyT_lo

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

struct Plain {
  __device__ __forceinline__ int operator()(int off) const { return off; }
};
struct Swz32 {
  __device__ __forceinline__ int operator()(int off) const {
    return swz32(off);
  }
};

template <int V>
using Int = std::integral_constant<int, V>;

// Calls f(Int<U>, Int<UPP>) for the copy unit of a pixel of C channels of
// T: the widest of 16, 8 and 4 bytes that divides it, 0 where none does
// (odd C in bf16: element by element), UPP units per pixel (0: C * sizeof(T)
// / U, known only at run time); the stem's C = 12 (3 units of 8 bytes in
// bf16, of 16 in f32) with its index arithmetic by constants.
template <typename T, typename F>
__device__ __forceinline__ void by_unit(int C, F&& f) {
  const int bytes = C * (int)sizeof(T);
  if (C == 12) {
    f(Int<sizeof(T) == 2 ? 8 : 16>(), Int<3>());
  } else if (bytes % 16 == 0) {
    f(Int<16>(), Int<0>());
  } else if (bytes % 8 == 0) {
    f(Int<8>(), Int<0>());
  } else if (sizeof(T) == 4 || bytes % 4 == 0) {
    f(Int<4>(), Int<0>());
  } else if constexpr (sizeof(T) == 2) {
    f(Int<0>(), Int<0>());
  }
}

// The units of one staged plane that this thread owns: unit k of pixel q
// of halo row r, for i = threadIdx.x, + threads, ... over HR x HW pixels
// of `upp` units.  f(r, q, k).
template <int HR, int HW, typename F>
__device__ __forceinline__ void for_units(int upp, int threads, F&& f) {
  for (int i = threadIdx.x; i < HR * HW * upp; i += threads) {
    const int r = i / (HW * upp), rem = i - r * (HW * upp);
    const int q = rem / upp;
    f(r, q, rem - q * upp);
  }
}

// Copies plane p of volume `vol` of the halo tile from (h0 - 1, w0 - 1),
// HR rows x HW pixels, into hs: pixel (r, q) at byte swz(r * pitch *
// stride + q * stride) (hs on the swizzle's 1024-byte grid, so that the
// swizzle follows the address), its C channels by this thread's units
// (U > 0: cp.async in U-byte units; U == 0: element by element with plain
// loads and stores).  Zeros past the plane and outside 0 <= p < depth.
template <typename T, int HR, int HW, int U, int UPP, typename Swz>
__device__ __forceinline__ void copy_plane(uint8_t* hs,
                                           const T* __restrict__ x, int vol,
                                           int p, int depth, int H, int W,
                                           int C, int h0, int w0, int pitch,
                                           int stride, int threads, Swz swz) {
  const int upp = U == 0 ? C : UPP > 0 ? UPP : C * (int)sizeof(T) / U;
  const bool in = p >= 0 && p < depth;
  const T* xp = x + ((size_t)vol * depth + (in ? p : 0)) * H * W * C;
  for_units<HR, HW>(upp, threads, [&](int r, int q, int k) {
    const int h = h0 - 1 + r, w = w0 - 1 + q;
    const bool ok = in && h >= 0 && h < H && w >= 0 && w < W;
    const T* src = xp + ((size_t)(ok ? h : 0) * W + (ok ? w : 0)) * C;
    const int off = r * pitch * stride + q * stride;
    if constexpr (U > 0) {
      cp_async<U>(hs + swz(off + k * U),
                  reinterpret_cast<const char*>(src) + (ok ? k * U : 0), ok);
    } else {
      *reinterpret_cast<T*>(hs + swz(off + k * (int)sizeof(T))) =
          ok ? src[k] : zero<T>();
    }
  });
}

// Zeroes `bytes` (a multiple of 16) of shared memory from p.
__device__ __forceinline__ void zero_smem(void* p, int bytes, int threads) {
  for (int i = threadIdx.x; i < bytes / 16; i += threads)
    reinterpret_cast<uint4*>(p)[i] = make_uint4(0u, 0u, 0u, 0u);
}

// bf16 halo bytes of one staged plane: HR rows x pitch pixels x 32 B,
// rounded up to 1024 (each slot starts on the swizzle's 1024-byte grid)
__host__ __device__ __forceinline__ int bf_slot_bytes(int HR, int pitch) {
  return (HR * pitch * kPx + 1023) / 1024 * 1024;
}

// The step's place: output planes d .. d + zb - 1 (the weight gradients:
// zb = 1) of tile `tile` of volume `vol`, s = (vol * tiles + tile) *
// dsteps + d / zb, dsteps = ceil(depth / zb) steps a tile of a volume.
struct Step {
  int vol, tile, j, d;
  __device__ __forceinline__ Step(int s, int dsteps, int tiles, int zb) {
    const int tv = s / dsteps;
    j = s - tv * dsteps;
    d = zb * j;
    vol = tv / tiles;
    tile = tv - vol * tiles;
  }
};

// ---- bf16 forward ----------------------------------------------------------

// The forwards compute kZB = 2 output planes a step, one accumulator each.
// KZ (1 or 3) is a template argument in all four kernels, and every
// descriptor is a base computed once plus offsets: descriptor arithmetic
// per wgmma (a generic-to-shared conversion, a modulo) between two wgmmas
// cost more than the wgmmas in the first weight-gradient kernel.
constexpr int kZB = 2;

// The ring holds the kZB + KZ - 1 planes a step reads and the kZB planes of
// the next step, copied while this step's groups run.
template <int KZ>
__global__ void __launch_bounds__(kBfWG * 128, 1)
few_forward_bf16_kernel(const bf16* __restrict__ x,
                        const bf16* __restrict__ w, bf16* __restrict__ y,
                        int depth, int H, int W, int C, int CO, int tiles_w,
                        int tiles, int steps, int per) {
  constexpr int kThreads = kBfWG * 128;
  constexpr int kLead = KZ / 2, kReads = kZB + 2 * kLead;
  constexpr int kSlots = kReads + kZB;
  constexpr int kTaps = KZ * 9;  // one k16 step (16 channels) per tap
  extern __shared__ uint8_t smem_raw[];
  // [B: kTaps x 1 KB] [ring: kSlots planes]
  uint8_t* sb = align_1024(smem_raw);
  uint8_t* ring = sb + kTaps * 1024;
  const int sbytes = bf_slot_bytes(kBfHR, kBfHW);
  const int co0 = blockIdx.y * kBN;
  const int dsteps = (depth + kZB - 1) / kZB;
  {  // member blockIdx.z: its planes and weights
    const size_t plane = (size_t)(steps / tiles / dsteps * depth) * H * W;
    x += blockIdx.z * plane * C;
    y += blockIdx.z * plane * CO;
    w += (size_t)blockIdx.z * kTaps * C * CO;
  }

  zero_smem(ring, kSlots * sbytes, kThreads);  // channels C .. 15 stay zero
  // the weights (k = tap * 16 + ci, zero past C): one 32-byte row per
  // output channel per tap, the 32-byte swizzle
  for (int i = threadIdx.x; i < kTaps * 16 * kBN; i += kThreads) {
    const int k = i / kBN, c = i % kBN, tap = k / 16, ci = k % 16;
    const bool ok = ci < C && co0 + c < CO;
    *reinterpret_cast<bf16*>(sb + swz32(tap * 1024 + c * 32 + ci * 2)) =
        ok ? w[((size_t)tap * C + ci) * CO + co0 + c] : zero<bf16>();
  }
  fence_proxy_async();  // the weights are read by wgmma (async proxy)
  __syncthreads();      // the zeros land before the first copies

  const int wg = threadIdx.x / 128, warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  // the row this lane addresses for ldmatrix: matrix q = lane / 8 is
  // (pixels 0-7 | 8-15 of the warp's 16) x (channels 0-7 | 8-15)
  const int lpix = 16 * warp + lane % 8 + 8 * ((lane / 8) & 1);
  const int lchunk = 16 * (lane / 16);
  const uint64_t db0 = smem_desc(sb, 16, 8 * kPx, kPx);

  const int s0 = blockIdx.x * per, s1 = min(steps, s0 + per);
  for (int s = s0; s < s1; ++s) {
    const Step st(s, dsteps, tiles, kZB);
    const int h0 = (st.tile / tiles_w) * kBfWG;
    const int w0 = (st.tile % tiles_w) * kBfRow;
    auto slot = [&](int p) { return ring + ((p + 1) % kSlots) * sbytes; };
    auto copy = [&](int p) {
      by_unit<bf16>(C, [&](auto u, auto upp) {
        copy_plane<bf16, kBfHR, kBfHW, decltype(u)::value,
                   decltype(upp)::value>(slot(p), x, st.vol, p, depth, H, W,
                                         C, h0, w0, kBfHW, kPx, kThreads,
                                         Swz32());
      });
    };
    if (s == s0 || st.j == 0) {
      // a new run of planes: its first step's planes (the last step's
      // fragments are loaded: every slot is free)
      __syncthreads();
      for (int p = st.d - kLead; p < st.d + kZB + kLead; ++p) copy(p);
      cp_async_commit();
    }
    cp_async_wait<0>();  // this thread's copies of the step's planes
    __syncthreads();     // every thread's
    // the next step's planes, into the slots of the planes before d -
    // lead (read by the last step alone)
    if (s + 1 < s1 && st.j + 1 < dsteps)
      for (int p = st.d + kZB + kLead; p < st.d + 2 * kZB + kLead; ++p)
        copy(p);
    cp_async_commit();

    float acc[kZB][16];
#pragma unroll
    for (int z = 0; z < kZB; ++z) {
#pragma unroll
      for (int i = 0; i < 16; ++i) acc[z][i] = 0.f;
      fence_operands(acc[z]);
    }
    // per staged plane d - lead + i and ky, one wgmma group: the fragments
    // of its three taps load once and serve each output plane d + z it
    // reaches (z-tap i - z); ky is the fragment set: a set loads while the
    // group before it runs, and two groups are in flight.  (The planes'
    // loop peeled, so that no branch parts two wgmmas, spilled 316 bytes
    // and ran 1.6x slower.)
    uint32_t fr[3][3][4];
#pragma unroll 1
    for (int i = 0; i < kReads; ++i) {
      const uint8_t* hs = slot(st.d - kLead + i);
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
        const int base = (ky + wg) * kBfHW + lpix;
#pragma unroll
        for (int kx = 0; kx < 3; ++kx)
          ldmatrix_x4(fr[ky][kx], hs + swz32((base + kx) * kPx + lchunk));
        wgmma_fence();
#pragma unroll
        for (int z = 0; z < kZB; ++z) {
          const int kz = i - z;
          if (kz < 0 || kz >= KZ) continue;
#pragma unroll
          for (int kx = 0; kx < 3; ++kx)
            wgmma_m64n32k16_rs(acc[z], fr[ky][kx],
                               db0 + ((kz * 3 + ky) * 3 + kx) * 64);
        }
        wgmma_commit();
        wgmma_wait<1>();
      }
    }
    wgmma_wait<0>();

    const int h = h0 + wg;
#pragma unroll
    for (int z = 0; z < kZB; ++z) {
      fence_operands(acc[z]);
      if (h >= H || st.d + z >= depth) continue;
      bf16* yp =
          y + (((size_t)st.vol * depth + st.d + z) * H + h) * W * CO;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int ww = w0 + 16 * warp + g + 8 * i;
        if (ww >= W) continue;
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j) {
          const int co = co0 + 8 * j + 2 * t;
          if (co < CO)
            store_pair(yp + (size_t)ww * CO + co, acc[z][4 * j + 2 * i],
                       acc[z][4 * j + 2 * i + 1]);
        }
      }
    }
  }
}

// ---- f32 forward -----------------------------------------------------------

// Channels a staged f32 pixel holds (C rounded up to 4: 16-byte rows for
// ldmatrix) and K of one (kz, ky) row of taps (3 pixels, rounded up to the
// k8 step).
__host__ __device__ __forceinline__ int f32_cs(int C) { return (C + 3) & ~3; }
__host__ __device__ __forceinline__ int f32_kr(int C) {
  return (3 * f32_cs(C) + 7) & ~7;
}
// Floats of one staged f32 plane: 18 x 18 pixels and 4 past the last (the
// padded K reads of its last row of taps).
__host__ __device__ __forceinline__ int f32_plane_floats(int C) {
  return kFHR * kFHW * f32_cs(C) + 4;
}

// The ring holds the kZB + KZ - 1 raw planes a step reads and, with kOwn
// (where they fit beside the weights: C <= 12, or one z-tap), the kZB
// planes of the next step, copied at the top of the step; without (C of
// 13-15 at three z-taps) the next step's planes are copied into the slots
// of the first kZB once their fragments are loaded, mid-step, behind a
// barrier.  (The ring's depth as a run-time argument ran 13% slower at the
// stem than six slots as a constant.)
template <int KZ, bool kOwn>
__global__ void __launch_bounds__(kFThreads, 1)
few_forward_f32_kernel(const float* __restrict__ x,
                       const float* __restrict__ w, float* __restrict__ y,
                       int depth, int H, int W, int C, int CO, int tiles_w,
                       int tiles, int steps, int per) {
  constexpr int kLead = KZ / 2, kReads = kZB + 2 * kLead;
  constexpr int kSlots = kReads + (kOwn ? kZB : 0);
  extern __shared__ uint8_t smem_raw[];
  const int Cs = f32_cs(C), Kr = f32_kr(C), ksr = Kr / 8;
  const int nk = KZ * 3 * ksr;  // k8 steps
  const int pf = f32_plane_floats(C);
  // [B_hi: nk x 1 KB] [B_lo] [ring: kSlots planes]
  uint8_t* sb = align_1024(smem_raw);
  float* ring = reinterpret_cast<float*>(sb + 2 * nk * 1024);
  const int co0 = blockIdx.y * kBN;
  const int dsteps = (depth + kZB - 1) / kZB;
  {  // member blockIdx.z: its planes and weights
    const size_t plane = (size_t)(steps / tiles / dsteps * depth) * H * W;
    x += blockIdx.z * plane * C;
    y += blockIdx.z * plane * CO;
    w += (size_t)blockIdx.z * KZ * 9 * C * CO;
  }

  // channels past C and the tails stay zero
  zero_smem(ring, kSlots * pf * 4, kFThreads);
  // the weights: row k = r * Kr + kx * Cs + ci of (kz, ky) row r (zero
  // where kx = 3 or ci >= C), split into tf32 hi and the remainder, one
  // K-major 1 KB tile per k8 step, 32-byte rows with the 32-byte swizzle
  for (int i = threadIdx.x; i < nk * 8 * kBN; i += kFThreads) {
    const int k = i / kBN, c = i % kBN;
    const int r = k / Kr, j = k - r * Kr, kx = j / Cs, ci = j - kx * Cs;
    const bool ok = kx < 3 && ci < C && co0 + c < CO;
    const float v = ok ? w[((size_t)(r * 3 + kx) * C + ci) * CO + co0 + c]
                       : 0.f;
    const uint32_t hi = round_tf32(v);
    const int off = swz32((k / 8) * 1024 + c * 32 + (k % 8) * 4);
    *reinterpret_cast<uint32_t*>(sb + off) = hi;
    *reinterpret_cast<float*>(sb + nk * 1024 + off) = v - __uint_as_float(hi);
  }
  fence_proxy_async();  // the weights are read by wgmma (async proxy)
  __syncthreads();

  const int wg = threadIdx.x / 128, warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  // the warp's row of 16 output pixels; the row this lane addresses for
  // ldmatrix: matrix q = lane / 8 is (pixels 0-7 | 8-15) x (k 0-3 | 4-7)
  const int orow = 4 * wg + warp;
  const int loff = (orow * kFHW + lane % 8 + 8 * ((lane / 8) & 1)) * Cs +
                   4 * (lane / 16);
  const uint64_t db0 = smem_desc(sb, 16, 256, 32);
  const uint64_t dlo = (uint64_t)(nk * 1024) >> 4;  // B_lo, 16-byte units

  const int s0 = blockIdx.x * per, s1 = min(steps, s0 + per);
  for (int s = s0; s < s1; ++s) {
    const Step st(s, dsteps, tiles, kZB);
    const int h0 = (st.tile / tiles_w) * kFH, w0 = (st.tile % tiles_w) * kFW;
    auto slot = [&](int p) { return ring + ((p + 1) % kSlots) * pf; };
    auto copy = [&](int p) {
      by_unit<float>(C, [&](auto u, auto upp) {
        copy_plane<float, kFHR, kFHW, decltype(u)::value,
                   decltype(upp)::value>(
            reinterpret_cast<uint8_t*>(slot(p)), x, st.vol, p, depth, H, W,
            C, h0, w0, kFHW, Cs * 4, kFThreads, Plain());
      });
    };
    if (s == s0 || st.j == 0) {
      // a new run of planes: its first step's planes (every slot is free
      // once the last step's fragments are loaded)
      __syncthreads();
      for (int p = st.d - kLead; p < st.d + kZB + kLead; ++p) copy(p);
      cp_async_commit();
    }
    cp_async_wait<0>();  // this thread's copies of the step's planes
    __syncthreads();     // every thread's
    // the next step's planes: into their own slots now, or into the slots
    // of the first kZB planes once every thread has loaded their fragments
    const bool next = s + 1 < s1 && st.j + 1 < dsteps;
    auto copy_next = [&]() {
      if (next)
        for (int p = st.d + kZB + kLead; p < st.d + 2 * kZB + kLead; ++p)
          copy(p);
      cp_async_commit();
    };
    if constexpr (kOwn) copy_next();

    float acc[kZB][16];
#pragma unroll
    for (int z = 0; z < kZB; ++z) {
#pragma unroll
      for (int i = 0; i < 16; ++i) acc[z][i] = 0.f;
      fence_operands(acc[z]);
    }
    // a k8 step of a staged plane per wgmma group: its A fragments load
    // and split once and serve each output plane d + z it reaches (z-tap
    // i - z); ky is the fragment set ([hi 4, lo 4]): a set loads while the
    // group before it runs, and two groups are in flight
    uint32_t fr[3][8];
    auto plane = [&](int i, auto z0, auto z1) {
      if constexpr (!kOwn) {
        if (i == kZB) {
          __syncthreads();
          copy_next();
        }
      }
      const float* ph = slot(st.d - kLead + i) + loff;
      for (int j = 0; j < ksr; ++j) {
#pragma unroll
        for (int ky = 0; ky < 3; ++ky) {
          uint32_t(&hi)[4] = *reinterpret_cast<uint32_t(*)[4]>(fr[ky]);
          uint32_t(&lo)[4] = *reinterpret_cast<uint32_t(*)[4]>(fr[ky] + 4);
          ldmatrix_x4(hi, ph + ky * kFHW * Cs + 8 * j);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float v = __uint_as_float(hi[q]);
            hi[q] = round_tf32(v);
            lo[q] = __float_as_uint(v - __uint_as_float(hi[q]));
          }
          // the k8 step's B for ky (its (kz, ky) rows), in 16-byte units
          const uint64_t dj = db0 + (uint64_t)((ky * ksr + j) * 64);
          wgmma_fence();
          // (lo, B_hi), (hi, B_lo), (hi, B_hi), the output planes
          // alternating
#pragma unroll
          for (int p = 0; p < 3; ++p) {
#pragma unroll
            for (int z = decltype(z0)::value; z < decltype(z1)::value; ++z) {
              const uint64_t db = dj + (uint64_t)((i - z) * 3 * ksr * 64);
              wgmma_m64n32k8_tf32(acc[z], p == 0 ? lo : hi,
                                  p == 1 ? db + dlo : db);
            }
          }
          wgmma_commit();
          wgmma_wait<1>();
        }
      }
    };
    plane(0, Int<0>(), Int<1>());
#pragma unroll 1
    for (int i = 1; i < kReads - 1; ++i) plane(i, Int<0>(), Int<2>());
    plane(kReads - 1, Int<1>(), Int<2>());
    if constexpr (!kOwn && kReads == kZB) {  // one z-tap: after every plane
      __syncthreads();
      copy_next();
    }
    wgmma_wait<0>();

    const int h = h0 + orow;
#pragma unroll
    for (int z = 0; z < kZB; ++z) {
      fence_operands(acc[z]);
      if (h >= H || st.d + z >= depth) continue;
      float* yp =
          y + (((size_t)st.vol * depth + st.d + z) * H + h) * W * CO;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int ww = w0 + g + 8 * i;
        if (ww >= W) continue;
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j) {
          const int co = co0 + 8 * j + 2 * t;
          if (co < CO)
            store_pair(yp + (size_t)ww * CO + co, acc[z][4 * j + 2 * i],
                       acc[z][4 * j + 2 * i + 1]);
        }
      }
    }
  }
}

// ---- bf16 weight gradient --------------------------------------------------

template <int KZ>
__global__ void __launch_bounds__(kBgWG * 128, 1)
few_wgrad_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dy,
                      float* __restrict__ part, int depth, int H, int W,
                      int C, int CO, int tiles_w, int tiles, int steps,
                      int per) {
  constexpr int kThreads = kBgWG * 128;
  constexpr int kPos = kBgH * kBgW;
  constexpr int kDyBytes = kPos * kBN * 2;  // 64-byte rows, one per position
  extern __shared__ uint8_t smem_raw[];
  // [dy x kBgDy] [ring: kBgRing planes]
  uint8_t* dys = align_1024(smem_raw);
  uint8_t* ring = dys + kBgDy * kDyBytes;
  const int sbytes = bf_slot_bytes(kBgHR, kBgHW);

  const int co0 = blockIdx.y * kBN;
  const int ky = threadIdx.x / 128;  // the warpgroup's ky
  {  // member blockIdx.z: its planes and partial sums
    const size_t plane = (size_t)(steps / tiles) * H * W;
    x += blockIdx.z * plane * C;
    dy += blockIdx.z * plane * CO;
    part += (size_t)blockIdx.z * gridDim.x * KZ * 9 * C * CO;
  }

  zero_smem(ring, kBgRing * sbytes, kThreads);  // channels C .. 15, pixels
  __syncthreads();                              // 18 and 19

  float acc[KZ][16];
#pragma unroll
  for (int kz = 0; kz < KZ; ++kz) {
#pragma unroll
    for (int q = 0; q < 16; ++q) acc[kz][q] = 0.f;
    fence_operands(acc[kz]);
  }
  constexpr int lead = KZ / 2;
  // descriptors: the ring's first slot at the warpgroup's halo row ky, and
  // the first dy tile; a step adds constant offsets (16-byte units)
  const uint64_t da0 =
      smem_desc(ring + ky * kBgHW * kPx, kPx, 8 * kPx, kPx);
  const uint64_t db0 = smem_desc(dys, kDyBytes, 512, 64);
  const int s0 = blockIdx.x * per, s1 = min(steps, s0 + per);
  for (int s = s0, i = 0; s < s1; ++s, ++i) {
    const Step st(s, depth, tiles, 1);
    const int h0 = (st.tile / tiles_w) * kBgH, w0 = (st.tile % tiles_w) * kBgW;
    auto slot = [&](int p) { return ring + ((p + 1) % kBgRing) * sbytes; };
    auto dslot = [&](int k) { return dys + (k % kBgDy) * kDyBytes; };
    auto copy = [&](int p) {
      by_unit<bf16>(C, [&](auto u, auto upp) {
        copy_plane<bf16, kBgHR, kBgW + 2, decltype(u)::value,
                   decltype(upp)::value>(slot(p), x, st.vol, p, depth, H, W,
                                         C, h0, w0, kBgHW, kPx, kThreads,
                                         Swz32());
      });
    };
    // 16-byte chunks of dy[plane, h0 + q / 16, w0 + q % 16, co0 : co0 +
    // 32], MN-major 64-byte rows with the 64-byte swizzle (chunk ^= bits
    // 7-8)
    auto copy_dy = [&](int k, int d) {
      uint8_t* dd = dslot(k);
      const bf16* dp = dy + ((size_t)st.vol * depth + d) * H * W * CO;
      for (int c = threadIdx.x; c < kPos * 4; c += kThreads) {
        const int q = c / 4, j = c % 4;
        const int h = h0 + q / kBgW, ww = w0 + q % kBgW, co = co0 + 8 * j;
        const bool ok = h < H && ww < W && co < CO;
        cp_async<16>(dd + q * 64 + ((j ^ ((q >> 1) & 3)) << 4),
                     ok ? dp + ((size_t)h * W + ww) * CO + co : dy, ok);
      }
    };
    if (s == s0 || st.d == 0) {
      // a new run of planes: every group retired, every slot free
      wgmma_wait<0>();
      __syncthreads();
      for (int p = st.d - lead; p <= st.d + lead; ++p) copy(p);
      copy_dy(i, st.d);
      cp_async_commit();
    }
    cp_async_wait<0>();
    fence_proxy_async();  // halo and dy are read by wgmma (async proxy)
    __syncthreads();
    // the next step's plane and dy tile, into slots that neither this
    // step's group nor the last one (still running) reads
    if (s + 1 < s1 && st.d + 1 < depth) {
      copy(st.d + lead + 1);
      copy_dy(i + 1, st.d + 1);
    }
    cp_async_commit();

    const uint64_t db = db0 + (uint64_t)((i % kBgDy) * (kDyBytes >> 4));
    wgmma_fence();
#pragma unroll
    for (int kz = 0; kz < KZ; ++kz) {
      const uint64_t da =
          da0 + (uint64_t)(((st.d - lead + kz + 1) % kBgRing) *
                           (sbytes >> 4));
#pragma unroll
      for (int r = 0; r < kBgH; ++r)
        // K: the 16 positions of row r; M: (kx, ci), atom kx one pixel on
        wgmma_m64n32k16<1, 1>(acc[kz], da + r * (kBgHW * kPx >> 4),
                              db + r * (16 * 64 >> 4));
    }
    wgmma_commit();
    wgmma_wait<1>();
  }
  wgmma_wait<0>();
#pragma unroll
  for (int kz = 0; kz < KZ; ++kz) fence_operands(acc[kz]);

  // rows of warp w: kx = w (w = 3 is padding), ci = g, g + 8
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  if (warp == 3) return;
  float* out = part + (size_t)blockIdx.x * KZ * 9 * C * CO;
#pragma unroll
  for (int kz = 0; kz < KZ; ++kz) {
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

// Floats of the A buffer: (hi, lo) x 3 kx-shifted copies x C channels of
// kGCh floats.
__host__ __device__ __forceinline__ int f32_abuf_floats(int C) {
  return 2 * 3 * C * kGCh;
}

// The raw x plane (kGHR x kGHW pixels of C floats), split, into the three
// kx-shifted channel-major copies of A: A_kx[ci][r * kGW + q] = x[r][q +
// kx][ci], hi at ah and the remainder at al.  CC: C where it is a
// constant (the stem's 12), 0 where it is not.
template <int CC>
__device__ __forceinline__ void convert_x(const float* __restrict__ raw,
                                          float* ah, float* al, int C_) {
  const int C = CC > 0 ? CC : C_;
  for (int e = threadIdx.x; e < 3 * C * kGHR * kGW; e += kGThreads) {
    const int ci = e % C, j = e / C;
    const int q = j % kGW, r = (j / kGW) % kGHR, kx = j / (kGW * kGHR);
    const float v = raw[(r * kGHW + q + kx) * C + ci];
    const float hv = __uint_as_float(round_tf32(v));
    const int o = (kx * C + ci) * kGCh + r * kGW + q;
    ah[o] = hv;
    al[o] = v - hv;
  }
}

template <int KZ>
__global__ void __launch_bounds__(kGThreads, 1)
few_wgrad_f32_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                     float* __restrict__ part, int depth, int H, int W, int C,
                     int CO, int tiles_w, int tiles, int steps, int per) {
  extern __shared__ uint8_t smem_raw[];
  const int mrows = 9 * C;  // (ky, kx, ci); the z-taps are accumulators
  const int mgroups = ((mrows + 63) / 64 + kGMT - 1) / kGMT;
  // [dyT ring: kGDy x (hi, lo)] [A] [raw x x 2] [raw dy x 2] [promoted
  // sums]
  uint8_t* dyt = align_1024(smem_raw);
  const int af = f32_abuf_floats(C);
  float* ah = reinterpret_cast<float*>(dyt + kGDy * 2 * kDyT);
  float* al = ah + af / 2;
  float* rawx = ah + af;
  const int rxf = kGHR * kGHW * C;
  float* rawdy = rawx + 2 * rxf;
  // tot[(kz * 16 + q) * kGThreads + thread]: the rounded sums the
  // accumulators are promoted into
  float* tot = rawdy + 2 * kGPos * kRawRow;
  {  // member blockIdx.z: its planes and partial sums
    const size_t plane = (size_t)(steps / tiles) * H * W;
    x += blockIdx.z * plane * C;
    dy += blockIdx.z * plane * CO;
    part += (size_t)blockIdx.z * gridDim.x * KZ * 9 * C * CO;
  }
  const int co0 = (blockIdx.y / mgroups) * kBN;
  const int wg = threadIdx.x / 128, warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  // warpgroup wg: m64 tile mt of the block's row (a tile past the last,
  // C = 15's, runs on rows past 9 x C: no branch around its wgmmas, which
  // ptxas would serialize, C7518) and half kh of each step's positions
  const int mt = (blockIdx.y % mgroups) * kGMT + wg % kGMT;
  const int kh = wg / kGMT;
  // this lane's ldmatrix row m = (ky, kx, ci): its offset in A at position
  // 0 (rows past 9 x C read row 0 and are dropped); matrix lane / 8 is
  // (rows 0-7 | 8-15) x (positions 0-3 | 4-7)
  int loff = 4 * (lane / 16);
  {
    const int m = 64 * mt + 16 * warp + lane % 8 + 8 * ((lane / 8) & 1);
    if (m < mrows) {
      const int tap = m / C, ci = m % C;
      loff += ((tap % 3) * C + ci) * kGCh + (tap / 3) * kGW;
    }
  }
  constexpr int lead = KZ / 2;
  // the dy ring's descriptor (a slot adds 2 kDyT, a k8 step 1 KB, lo kDyT)
  const uint64_t db0 = smem_desc(dyt, 16, 256, 32);

  float acc[KZ][16];
#pragma unroll
  for (int kz = 0; kz < KZ; ++kz) {
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      acc[kz][q] = 0.f;
      tot[(kz * 16 + q) * kGThreads + threadIdx.x] = 0.f;
    }
    fence_operands(acc[kz]);
  }
  // the accumulators' sums, added into tot with rounding (the tensor
  // cores truncate)
  auto promote = [&]() {
    wgmma_wait<0>();
#pragma unroll
    for (int kz = 0; kz < KZ; ++kz) {
      fence_operands(acc[kz]);
#pragma unroll
      for (int q = 0; q < 16; ++q) {
        tot[(kz * 16 + q) * kGThreads + threadIdx.x] += acc[kz][q];
        acc[kz][q] = 0.f;
      }
      fence_operands(acc[kz]);
    }
  };
  uint32_t fr[3][8];  // [set][hi 4, lo 4]

  const int s0 = blockIdx.x * per, s1 = min(steps, s0 + per);
  for (int s = s0, i = 0; s < s1; ++s, ++i) {
    const Step st(s, depth, tiles, 1);
    const int h0 = (st.tile / tiles_w) * kGH, w0 = (st.tile % tiles_w) * kGW;
    // dy plane n's slot of the ring (n >= -1)
    auto dslot = [&](int n) { return dyt + ((n + 1) & (kGDy - 1)) * 2 * kDyT; };
    // step s + k walks on in this tile
    auto walks_to = [&](int k) { return s + k < s1 && st.d + k < depth; };
    // x plane p and dy plane n into raw buffer b (cp.async)
    auto copy_x = [&](int p, int b) {
      by_unit<float>(C, [&](auto u, auto upp) {
        copy_plane<float, kGHR, kGHW, decltype(u)::value,
                   decltype(upp)::value>(
            reinterpret_cast<uint8_t*>(rawx + b * rxf), x, st.vol, p, depth,
            H, W, C, h0, w0, kGHW, C * 4, kGThreads, Plain());
      });
    };
    auto copy_dy = [&](int n, int b) {
      const bool in = n >= 0 && n < depth;
      const float* dp =
          dy + ((size_t)st.vol * depth + (in ? n : 0)) * H * W * CO;
      float* rd = rawdy + b * kGPos * kRawRow;
      for (int c = threadIdx.x; c < kGPos * 8; c += kGThreads) {
        const int q = c / 8, j = c % 8;
        const int h = h0 + q / kGW, ww = w0 + q % kGW, co = co0 + 4 * j;
        const bool ok = in && h < H && ww < W && co < CO;
        cp_async<16>(rd + q * kRawRow + 4 * j,
                     ok ? dp + ((size_t)h * W + ww) * CO + co : dy, ok);
      }
    };
    // raw dy buffer b, split, into n's slot: dyT[k8 step][co][8
    // positions] = tf32 hi and remainder, K-major 32-byte rows with the
    // 32-byte swizzle, one 1 KB tile per k8 step (a row of 8 positions)
    auto convert_dy = [&](int n, int b) {
      uint8_t* dh = dslot(n);
      const float* rd = rawdy + b * kGPos * kRawRow;
      const int co = (threadIdx.x / 8) % kBN, j8 = threadIdx.x % 8;
      for (int k = threadIdx.x / (8 * kBN); k < kGH;
           k += kGThreads / (8 * kBN)) {
        const float v = rd[(8 * k + j8) * kRawRow + co];
        const uint32_t hi = round_tf32(v);
        const int off = swz32(k * 1024 + co * 32 + j8 * 4);
        *reinterpret_cast<uint32_t*>(dh + off) = hi;
        *reinterpret_cast<float*>(dh + kDyT + off) = v - __uint_as_float(hi);
      }
    };
    // Step s stages x plane d and dy plane d + lead through raw buffer i %
    // 2, as cp.async group G(s); the groups are committed in step order,
    // one a step (empty where the walk ends), G(s + 2) during step s, so
    // that at the top of step s only G(s + 1) may still be in flight.
    if (st.d == 0 || s == s0) {
      // a new run of planes: every group retired (the dy slots are free),
      // its dy planes before d + lead one at a time, then G(s), G(s + 1)
      wgmma_wait<0>();
      __syncthreads();
      for (int n = st.d - lead; n < st.d + lead; ++n) {
        copy_dy(n, i % 2);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        convert_dy(n, i % 2);
        __syncthreads();
      }
      copy_x(st.d, i % 2);
      copy_dy(st.d + lead, i % 2);
      cp_async_commit();
      if (walks_to(1)) {
        copy_x(st.d + 1, (i + 1) % 2);
        copy_dy(st.d + 1 + lead, (i + 1) % 2);
      }
      cp_async_commit();
    }
    cp_async_wait<1>();  // G(s)
    __syncthreads();
    // x plane d into A (the last step's fragments are loaded), dy plane d
    // + lead into the slot of plane d + lead - 4 (the last step's groups
    // read d + lead - 3 .. d + lead - 1)
    if (C == 12)
      convert_x<12>(rawx + (i % 2) * rxf, ah, al, C);
    else
      convert_x<0>(rawx + (i % 2) * rxf, ah, al, C);
    convert_dy(st.d + lead, i % 2);
    fence_proxy_async();  // dyT is read by wgmma (async proxy)
    __syncthreads();
    // G(s + 2), into the raw buffers just converted
    if (walks_to(2)) {
      copy_x(st.d + 2, i % 2);
      copy_dy(st.d + 2 + lead, i % 2);
    }
    cp_async_commit();

    // one k8 step (a row of 8 positions) per wgmma group, three a step (a
    // half of its rows): A loads once for the KZ z-taps, each its own dy
    // plane (x plane d pairs with dy plane d + lead - kz) and accumulator;
    // the fragment sets rotate across steps, two groups in flight
    uint64_t db[KZ];
#pragma unroll
    for (int kz = 0; kz < KZ; ++kz)
      db[kz] = db0 + (uint64_t)(((st.d + lead - kz + 1) & (kGDy - 1)) *
                                (2 * kDyT >> 4) + kh * (kGH / 2) * 64);
#pragma unroll
    for (int k = 0; k < kGH / 2; ++k) {
      const int row = kh * (kGH / 2) + k;
      uint32_t(&hi)[4] = *reinterpret_cast<uint32_t(*)[4]>(fr[k]);
      uint32_t(&lo)[4] = *reinterpret_cast<uint32_t(*)[4]>(fr[k] + 4);
      ldmatrix_x4(hi, ah + loff + row * kGW);
      ldmatrix_x4(lo, al + loff + row * kGW);
      wgmma_fence();
#pragma unroll
      for (int p = 0; p < 3; ++p) {
#pragma unroll
        for (int kz = 0; kz < KZ; ++kz)
          wgmma_m64n32k8_tf32(acc[kz], p == 0 ? lo : hi,
                              db[kz] + k * 64 + (p == 1 ? kDyT >> 4 : 0));
      }
      wgmma_commit();
      wgmma_wait<1>();
    }
    if ((i + 1) % kPromote == 0) promote();
  }
  promote();
  __syncthreads();
  // the two halves' sums, in order, by the warpgroups of half 0
  if (kh != 0) return;
  float* out = part + (size_t)blockIdx.x * KZ * 9 * C * CO;
  const int other = threadIdx.x + kGMT * 128;
#pragma unroll
  for (int kz = 0; kz < KZ; ++kz) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int m = 64 * mt + 16 * warp + g + 8 * r;
      if (m >= mrows) continue;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        const int co = co0 + 8 * j + 2 * t;
        const int q = kz * 16 + 4 * j + 2 * r;
        if (co < CO)
          *reinterpret_cast<float2*>(out + (size_t)(kz * mrows + m) * CO +
                                     co) =
              make_float2(tot[q * kGThreads + threadIdx.x] +
                              tot[q * kGThreads + other],
                          tot[(q + 1) * kGThreads + threadIdx.x] +
                              tot[(q + 1) * kGThreads + other]);
      }
    }
  }
}

// dw[member][j] = the sum over k in order of part[member][k][j], for the
// `total` = members x m entries of dw.
__global__ void sum_splits_kernel(const float* __restrict__ part,
                                  float* __restrict__ dw, int m, int total,
                                  int splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const float* p = part + (size_t)(i / m) * splits * m + i % m;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += p[(size_t)k * m];
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

// The walk of one launch: th x tw tiles of a member's planes, its steps
// (tiles x ceil(depth / zb) per volume: zb output planes a step) and the
// steps of each of `blocks` blocks; false where `blocks` is not a count
// kernels/conv3x3.py::few_plan gives (every block walks at least one step).
struct Walk {
  int tiles_w, tiles, steps, per;
  bool init(int N, int members, int depth, int zb, int H, int W, int th,
            int tw, int blocks) {
    tiles_w = (W + tw - 1) / tw;
    tiles = ((H + th - 1) / th) * tiles_w;
    steps = N / members / depth * ((depth + zb - 1) / zb) * tiles;
    if (blocks <= 0 || blocks > steps) return false;
    per = (steps + blocks - 1) / blocks;
    return (blocks - 1) * per < steps;
  }
};

template <int KZ>
int launch_forward_bf16(const void* x, const void* w, void* y, int N,
                        int members, int depth, int H, int W, int C, int CO,
                        int blocks, cudaStream_t s) {
  Walk wk;
  if (!wk.init(N, members, depth, kZB, H, W, kBfWG, kBfRow, blocks))
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = 1024 + KZ * 9 * 1024 +
                   (2 * kZB + KZ - 1) * bf_slot_bytes(kBfHR, kBfHW);
  static int configured = 0;
  const cudaError_t e =
      allow_smem(few_forward_bf16_kernel<KZ>, smem, configured);
  if (e != cudaSuccess) return static_cast<int>(e);
  few_forward_bf16_kernel<KZ><<<dim3(blocks, (CO + kBN - 1) / kBN, members),
                                kBfWG * 128, smem, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<bf16*>(y), depth, H, W, C, CO, wk.tiles_w, wk.tiles,
      wk.steps, wk.per);
  return static_cast<int>(cudaGetLastError());
}

template <int KZ, bool kOwn>
int launch_forward_f32_ring(const void* x, const void* w, void* y,
                            int members, int depth, int H, int W, int C,
                            int CO, int blocks, const Walk& wk, int smem,
                            cudaStream_t s) {
  static int configured = 0;
  const cudaError_t e =
      allow_smem(few_forward_f32_kernel<KZ, kOwn>, smem, configured);
  if (e != cudaSuccess) return static_cast<int>(e);
  few_forward_f32_kernel<KZ, kOwn>
      <<<dim3(blocks, (CO + kBN - 1) / kBN, members), kFThreads, smem, s>>>(
          static_cast<const float*>(x), static_cast<const float*>(w),
          static_cast<float*>(y), depth, H, W, C, CO, wk.tiles_w, wk.tiles,
          wk.steps, wk.per);
  return static_cast<int>(cudaGetLastError());
}

template <int KZ>
int launch_forward_f32(const void* x, const void* w, void* y, int N,
                       int members, int depth, int H, int W, int C, int CO,
                       int blocks, cudaStream_t s) {
  Walk wk;
  if (!wk.init(N, members, depth, kZB, H, W, kFH, kFW, blocks))
    return static_cast<int>(cudaErrorInvalidValue);
  // the ring: the next step's planes in slots of their own where they fit
  const int nk = KZ * 3 * f32_kr(C) / 8;
  const int fixed = 1024 + 2 * nk * 1024, plane = f32_plane_floats(C) * 4;
  const int own = fixed + (2 * kZB + KZ - 1) * plane;
  if (own <= kSmemMax)
    return launch_forward_f32_ring<KZ, true>(x, w, y, members, depth, H, W,
                                             C, CO, blocks, wk, own, s);
  if constexpr (KZ == 3)
    return launch_forward_f32_ring<KZ, false>(
        x, w, y, members, depth, H, W, C, CO, blocks, wk,
        fixed + (kZB + KZ - 1) * plane, s);
  return static_cast<int>(cudaErrorInvalidValue);  // one z-tap fits at any C
}

template <int KZ>
int launch_wgrad_bf16(const void* x, const void* dy, float* part, int N,
                      int members, int depth, int H, int W, int C, int CO,
                      int splits, cudaStream_t s) {
  Walk wk;
  if (!wk.init(N, members, depth, 1, H, W, kBgH, kBgW, splits))
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = 1024 + kBgDy * kBgH * kBgW * kBN * 2 +
                   kBgRing * bf_slot_bytes(kBgHR, kBgHW);
  static int configured = 0;
  const cudaError_t e =
      allow_smem(few_wgrad_bf16_kernel<KZ>, smem, configured);
  if (e != cudaSuccess) return static_cast<int>(e);
  few_wgrad_bf16_kernel<KZ><<<dim3(splits, (CO + kBN - 1) / kBN, members),
                              kBgWG * 128, smem, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(dy), part, depth,
      H, W, C, CO, wk.tiles_w, wk.tiles, wk.steps, wk.per);
  return static_cast<int>(cudaGetLastError());
}

template <int KZ>
int launch_wgrad_f32(const void* x, const void* dy, float* part, int N,
                     int members, int depth, int H, int W, int C, int CO,
                     int splits, cudaStream_t s) {
  Walk wk;
  if (!wk.init(N, members, depth, 1, H, W, kGH, kGW, splits))
    return static_cast<int>(cudaErrorInvalidValue);
  // the m64 tiles of the 9 x C rows, two a block (C = 15: three, a second
  // block row)
  const int mgroups = ((9 * C + 63) / 64 + kGMT - 1) / kGMT;
  const int smem = 1024 + kGDy * 2 * kDyT + f32_abuf_floats(C) * 4 +
                   2 * kGHR * kGHW * C * 4 + 2 * kGPos * kRawRow * 4 +
                   KZ * 16 * kGThreads * 4;
  static int configured = 0;
  const cudaError_t e = allow_smem(few_wgrad_f32_kernel<KZ>, smem, configured);
  if (e != cudaSuccess) return static_cast<int>(e);
  few_wgrad_f32_kernel<KZ><<<dim3(splits, (CO + kBN - 1) / kBN * mgroups,
                                  members),
                             kGThreads, smem, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(dy), part,
      depth, H, W, C, CO, wk.tiles_w, wk.tiles, wk.steps, wk.per);
  return static_cast<int>(cudaGetLastError());
}

bool misaligned(const void* p) {
  return reinterpret_cast<uintptr_t>(p) & 15;
}

bool bad_shape(int N, int members, int depth, int H, int W, int C, int CO,
               int KZ, int dtype) {
  return N <= 0 || members <= 0 || members > 65535 || N % members != 0 ||
         depth <= 0 || (N / members) % depth != 0 || H <= 0 || W <= 0 ||
         C < 2 || C > 15 || CO <= 0 || CO % 8 != 0 || (KZ != 1 && KZ != 3) ||
         (dtype != 0 && dtype != 1);
}

}  // namespace

// x (N, H, W, C) and y (N, H, W, CO) NHWC, contiguous, x and y 16-byte
// aligned, one type: dtype 0 = f32, 1 = bf16; 1 < C < 16, CO % 8 == 0.
// Planes [m * N / members, (m + 1) * N / members) take member m's weights
// (N / members a multiple of depth).  w: each member's weights (members,
// KZ, 3, 3, C, CO) as they are, in x's type (the kernel packs them).
// `blocks`: the blocks of each member and output-channel tile, each
// walking ceil(steps / blocks) of its member's steps (few_plan; a step
// computes two output planes of a tile).  Returns cudaGetLastError() after
// the launch (cudaErrorInvalidValue for arguments the kernel does not
// take).
extern "C" int dgtta_conv3x3_few(const void* x, const void* w, void* y,
                                 int N, int members, int depth, int H, int W,
                                 int C, int CO, int KZ, int blocks, int dtype,
                                 void* stream) {
  if (bad_shape(N, members, depth, H, W, C, CO, KZ, dtype) || misaligned(x) ||
      misaligned(y) || w == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto run = [&](auto kz) {
    constexpr int K = decltype(kz)::value;
    return dtype == 1 ? launch_forward_bf16<K>(x, w, y, N, members, depth,
                                               H, W, C, CO, blocks, s)
                      : launch_forward_f32<K>(x, w, y, N, members, depth, H,
                                              W, C, CO, blocks, s);
  };
  return KZ == 3 ? run(Int<3>()) : run(Int<1>());
}

// x (N, H, W, C) and dy (N, H, W, CO) NHWC, contiguous and 16-byte aligned,
// dtype 0 = f32, 1 = bf16; 1 < C < 16, CO % 8 == 0; planes [m * N /
// members, ...) belong to member m; dw (members, KZ, 3, 3, C, CO) f32;
// scratch holds members * splits * KZ*9*C*CO f32 (unused when splits ==
// 1).  Block b of a member walks its steps [b * ceil(steps / splits), ...),
// a step being one plane of a tile of 8 x 16 positions in bf16 and 6 x 8
// in f32.  Returns cudaGetLastError() after the launches
// (cudaErrorInvalidValue for arguments the kernels do not take).
extern "C" int dgtta_conv3x3_wgrad_few(const void* x, const void* dy,
                                       void* dw, void* scratch, int N,
                                       int members, int depth, int H, int W,
                                       int C, int CO, int KZ, int splits,
                                       int dtype, void* stream) {
  if (bad_shape(N, members, depth, H, W, C, CO, KZ, dtype) || splits <= 0 ||
      (splits > 1 && scratch == nullptr) || misaligned(x) || misaligned(dy) ||
      misaligned(dw))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = splits == 1 ? static_cast<float*>(dw)
                            : static_cast<float*>(scratch);
  auto run = [&](auto kz) {
    constexpr int K = decltype(kz)::value;
    return dtype == 0 ? launch_wgrad_f32<K>(x, dy, part, N, members, depth, H,
                                            W, C, CO, splits, s)
                      : launch_wgrad_bf16<K>(x, dy, part, N, members, depth,
                                             H, W, C, CO, splits, s);
  };
  const int err = KZ == 3 ? run(Int<3>()) : run(Int<1>());
  if (err != 0) return err;
  if (splits > 1) {
    const int m = KZ * 9 * C * CO, total = m * members;
    sum_splits_kernel<<<(total + 255) / 256, 256, 0, s>>>(
        part, static_cast<float*>(dw), m, total, splits);
  }
  return static_cast<int>(cudaGetLastError());
}
