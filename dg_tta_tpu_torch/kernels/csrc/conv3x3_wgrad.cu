// Weight gradient of the stride-1 3x3(x3) convolution of conv3x3.cu, for
// sm_90a: the catch-all route ("cuda_core" in the wrappers and counters,
// the name it had when it ran on the CUDA cores), for every C >= 1 and
// every CO, on the tensor cores (mma.sync; f32 as 3xTF32; a wgmma design
// was built and ran slower at every shape, below).
//
// The backward of dg_tta_tpu/ops/conv2d_pallas.py::conv3x3_pallas, which the
// TPU package left to XLA's conv transpose (and, on the TPU, to the
// dot_general form of dg_tta_tpu/ops/conv2d.py).  For the forward
//
//   y[n,h,w,co] = sum_{kz<KZ,ky,kx,ci} x[n+kz-KZ/2, h+ky-1, w+kx-1, ci]
//                                       * W[kz,ky,kx,ci,co]
//
// it computes
//
//   dW[kz,ky,kx,ci,co] = sum_{n,h,w} x[n+kz-KZ/2, h+ky-1, w+kx-1, ci]
//                                    * dy[n,h,w,co]
//
// with zeros outside the plane and outside the plane's group of `depth`
// planes, exactly the zero padding of the forward.  x and dy are f32 or
// bf16 (NHWC, N = members * batch * depth), the sums and dW are f32.
//
// What bounds it on an H100: 2*27*C*CO operations per position against (C
// + CO) elements read: bound by the tensor cores (bf16 989 TFLOP/s, f32 as
// three tf32 products at 495/3).  The sum runs over every position (3.2M at
// the first stage of a two-patch step) while the output is small
// (27*C*CO), so the positions are split across blocks.  The first version
// ran f32 FMAs on the CUDA cores on 4 x 16 position tiles staged
// synchronously: 67.6 ms for the TS104 row forced onto it in f32 (29% of
// the CUDA-core bound).
//
// The design (per tap, dW^T (CO x C) = dy^T x_shift: M = output channels,
// N = input channels, K = positions; dy, shared by the nine taps, in A):
// * a block of nine warps owns one z-tap, 32 output and kCi input channels
//   (an item: kCi = C rounded up to 8 (f32), 16 or 32, else 32), and a
//   split: a contiguous run of 8 x 16 position tiles of one volume; warp w
//   computes tap (ky, kx) = (w / 3, w % 3), two m16 x kCi / 8 n8 tiles;
// * a stage is one position tile: the 10 x 18 halo of x (plane n + kz -
//   KZ/2, kCi channels) and the 8 x 16 tile of dy (32 channels), staged by
//   cp.async at the widest granule each one's rows allow (x: V = 16, 8 or
//   4 bytes, 2: plain loads for bf16 at an odd channel count; dy: 16 where
//   its rows allow, else V), template arguments, in a ring of three stages
//   with one barrier a stage; channels past C and CO and positions outside
//   the plane are zero-filled in shared memory; with one item of input
//   channels (C <= kCi) a stage copies only x's granules that hold
//   channels, the others zeroed once in every slot; the halo's in-plane
//   pixel indices (-1 outside) are tabled in shared memory once a stage, a
//   stage ahead of its copies (two tables), so that a granule costs a
//   table read, two compares and an address;
// * bf16: A and B by ldmatrix.trans (rows 80 bytes apart: an ldmatrix's
//   eight rows in distinct banks), a k16 step a row of 16 positions; f32:
//   32-bit loads (rows 160 bytes apart, 8 banks on per position: the 32
//   lanes of a fragment load in distinct banks), each value split into
//   tf32 hi and remainder, three products per pair, a k8 step half a row;
// * the tensor core's adds truncate: the accumulators are promoted into an
//   f32 total every kPromote stages (512 positions);
// * splits: every volume (`depth` planes of one member) is cut into the same
//   number of splits, from one volume's shape alone (kernels/conv3x3.py
//   cuda_core_wgrad_plan), so that neither the batch, nor `patch_group`,
//   nor the members side by side change which positions a partial sums;
//   each block writes its partial, and a second kernel adds a member's
//   partials in a fixed order: no atomics, dW is the same bit for bit from
//   run to run, and a member's is that of a launch of it alone.
// Times (device ms by CUDA graph, obs/conv_times.py --ragged, NVIDIA H100
// 80GB HBM3 at 700 W; rows: the ragged net's trained step, and the TS104
// shapes forced here): the first mma.sync design f32 25.56 / 35.90, bf16
// 8.43 / 9.44; the pixel-index tables f32 24.20 / 34.54, bf16 7.00 / 9.01
// (each against the step before in one call); input-channel items of 8
// and 16 at small C: the f32 C = 1 row 4.83 -> 2.42 ms.  The copies set
// the pace at ragged C: bf16 30 -> 30 (4-byte granules) ran at 97 TFLOP/s
// against 225 at 32 -> 32 (16-byte) in the first design.
// Dropped: wgmma (M = 9 taps x 16 or 32 input channels, four 16-row units
// of one tap a m64 tile, A = x from registers by ldmatrix.trans (bf16) or
// 32-bit loads split in registers (f32); N = 16-64 output channels, dy
// MN-major by descriptor in bf16, transposed and split into K-major tiles
// in shared memory in f32; two warpgroups, a group a k step, the stage
// drained before its buffers return): slower at every shape, ragged rows
// f32 44.09 / bf16 9.14 against 24.22 / 7.01, forced f32 61.64 / bf16
// 11.51 against 32.14 / 8.44 (two calls), its groups too short (N = 16-32,
// K = 8-16 a group) to hide their issue and waits; 3xTF32 pass by
// pass: f32 35.98 against 35.97; one block an SM in bf16 (no spills; two
// blocks spill 72-88 bytes): 11.24 against 9.37.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "mma_sync.cuh"

namespace {

using namespace dgtta_ms;
using bf16 = __nv_bfloat16;

constexpr int kWarps = 9;  // one (ky, kx) tap each
constexpr int kThreads = 32 * kWarps;
constexpr int kTH = 8, kTW = 16;  // positions of a stage
constexpr int kHW = kTW + 2;
constexpr int kHaloPx = (kTH + 2) * kHW;
constexpr int kPos = kTH * kTW;
constexpr int kCh = 32;      // output channels of an item
constexpr int kStages = 3;
constexpr int kPromote = 4;  // stages between promotions

template <typename T>
struct Cfg;
// rows of 32 channels: bf16 64 bytes + 16, f32 128 + 32 (40 words)
template <>
struct Cfg<bf16> {
  static constexpr int kPitch = 80, kMinBlocks = 2;
};
template <>
struct Cfg<float> {
  static constexpr int kPitch = 160, kMinBlocks = 1;
};

template <typename T>
__host__ __device__ constexpr int stage_bytes() {
  return (kHaloPx + kPos) * Cfg<T>::kPitch;
}

// the ring, then two tables of the halo's pixel indices
template <typename T>
__host__ __device__ constexpr int smem_bytes() {
  return kStages * stage_bytes<T>() + 2 * kHaloPx * 4;
}

// Stages `rows` rows of kW channels from c0 of `src` (one plane, `ch`
// channels): row i is the pixel whose in-plane index is tab[px(i)] (-1:
// outside the plane: zeros), px(i) = i for the halo of x, the inner 8 x
// 16 of the halo for dy; zeros past `ch`.  Only the first `gs` granules
// of V bytes of a row (the others hold zeros already): granules of 2 or 4
// bytes loop over those alone, wider ones over all and skip.
template <typename T, int V, bool kDy, int kW>
__device__ __forceinline__ void stage_rows(uint8_t* dst,
                                           const T* __restrict__ src,
                                           const int* tab, int rows, int ch,
                                           int c0, int gs) {
  constexpr int kG = kW * (int)sizeof(T) / V;  // granules of a row
  constexpr int kE = V / (int)sizeof(T);
  const int n = V <= 4 && !kDy ? gs : kG;
  for (int i = threadIdx.x; i < rows * n; i += kThreads) {
    const int r = i / n, g = i % n;
    if (V > 4 && g >= gs) continue;
    const int px = kDy ? (r / kTW + 1) * kHW + r % kTW + 1 : r;
    const int pix = tab[px], c = c0 + g * kE;
    const bool ok = pix >= 0 && c < ch;
    copy_async<V>(dst + r * Cfg<T>::kPitch + g * V,
                  ok ? src + (ptrdiff_t)pix * ch + c : src, ok);
  }
}

// kCi: the input channels of an item (8, 16 or 32; bf16 16 or 32), C's
// rounded up to 8 where C < 32; kNT = kCi / 8 n8 tiles a warp.  V: x's
// cp.async granule, VD: dy's (V, or 16 where dy's rows allow it).
template <typename T, int V, int kCi, int VD>
__global__ void __launch_bounds__(kThreads, Cfg<T>::kMinBlocks)
wgrad_kernel(const T* __restrict__ x, const T* __restrict__ dy,
             float* __restrict__ part, int N, int members, int depth, int H,
             int W, int C, int CO, int KZ, int splits, int per_split) {
  constexpr bool kF32 = sizeof(T) == 4;
  constexpr int kPitch = Cfg<T>::kPitch;
  constexpr int kNT = kCi / 8;
  extern __shared__ __align__(128) uint8_t smem[];

  const int ci_tiles = (C + kCi - 1) / kCi, co_tiles = (CO + kCh - 1) / kCh;
  const int items = KZ * ci_tiles * co_tiles;
  const int tiles_w = (W + kTW - 1) / kTW;
  const int tiles_plane = ((H + kTH - 1) / kTH) * tiles_w;
  const int tiles_v = depth * tiles_plane;
  const int volumes = N / members / depth;  // a member's

  // block -> (member, volume, split, item); items vary fastest, so that
  // neighbouring blocks read the same tiles
  int r = blockIdx.x;
  const int item = r % items;
  r /= items;
  const int sv = r % splits;
  r /= splits;
  const int v = r % volumes;
  const int m = r / volumes;
  const int z = item / (ci_tiles * co_tiles);
  const int ci0 = (item / co_tiles) % ci_tiles * kCi;
  const int co0 = item % co_tiles * kCh;
  const int dz = z - KZ / 2;
  const int plane0 = (m * volumes + v) * depth;  // the volume's first plane

  // the split's tiles whose x plane lies in the group (contiguous: the
  // first plane has no z-tap below it, the last none above)
  const int begin = max(sv * per_split, dz < 0 ? tiles_plane : 0);
  const int end = min(min((sv + 1) * per_split, tiles_v),
                      tiles_v - (dz > 0 ? tiles_plane : 0));
  const int S = max(0, end - begin);

  // the in-plane index of each halo pixel of a stage's tile (-1 outside
  // the plane), two tables: one filled while the other's stage is issued
  int* tabs = reinterpret_cast<int*>(smem + kStages * stage_bytes<T>());
  auto fill = [&](int s) {
    const int tp = (begin + s) % tiles_plane;
    const int h0 = tp / tiles_w * kTH, w0 = tp % tiles_w * kTW;
    for (int px = threadIdx.x; px < kHaloPx; px += kThreads) {
      const int h = h0 + px / kHW - 1, w = w0 + px % kHW - 1;
      tabs[(s & 1) * kHaloPx + px] =
          h >= 0 && h < H && w >= 0 && w < W ? h * W + w : -1;
    }
  };
  // granules a stage copies per x row: with one item of input channels
  // (C <= kCi) those that hold channels, the rest zeroed once (below)
  constexpr int kGx = kCi * (int)sizeof(T) / V;
  const int gs = ci_tiles == 1 ? (C * (int)sizeof(T) + V - 1) / V : kGx;
  auto load = [&](int s) {
    if (s < S) {
      const int n = plane0 + (begin + s) / tiles_plane;
      const int* tab = tabs + (s & 1) * kHaloPx;
      uint8_t* st = smem + (s % kStages) * stage_bytes<T>();
      stage_rows<T, V, false, kCi>(st, x + (size_t)(n + dz) * H * W * C,
                                   tab, kHaloPx, C, ci0, gs);
      stage_rows<T, VD, true, kCh>(st + kHaloPx * kPitch,
                                   dy + (size_t)n * H * W * CO, tab, kPos, CO,
                                   co0, kCh);
    }
    cp_async_commit();
  };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ky = warp / 3, kx = warp % 3;
  const int g = lane >> 2, tq = lane & 3, q = lane >> 3;

  float acc[2][kNT][4], tot[2][kNT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = tot[i][j][e] = 0.f;
  auto promote = [&]() {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          tot[i][j][e] += acc[i][j][e];
          acc[i][j][e] = 0.f;
        }
  };

  // per-lane offsets (bytes) into a stage.  bf16 (ldmatrix.trans): A =
  // dy^T, matrix q of m16 tile i: positions 8 (q / 2) + l % 8, channels 16
  // i + 8 (q % 2); B = x at the tap's shift, matrix q of n8 pair p:
  // positions 8 (q % 2) + l % 8, channels 16 p + 8 (q / 2).  f32 (32-bit
  // loads): A, position t (+4) and channel g (+8) of dy; B, position t (+4)
  // and channel g of x.
  uint32_t a_off, b_off;
  if constexpr (kF32) {
    a_off = kHaloPx * kPitch + tq * kPitch + g * 4;
    b_off = (ky * kHW + kx + tq) * kPitch + g * 4;
  } else {
    a_off = kHaloPx * kPitch + ((lane & 7) + ((q >> 1) << 3)) * kPitch +
            ((q & 1) << 4);
    b_off = (ky * kHW + kx + (lane & 7) + ((q & 1) << 3)) * kPitch +
            ((q >> 1) << 4);
  }

  if (gs < kGx) {  // the x rows' granules no stage copies, in every slot
    for (int i = threadIdx.x; i < kStages * kHaloPx * (kGx - gs);
         i += kThreads) {
      const int row = i / (kGx - gs), g = gs + i % (kGx - gs);
      uint8_t* p = smem + (row / kHaloPx) * stage_bytes<T>() +
                   (row % kHaloPx) * kPitch + g * V;
#pragma unroll
      for (int b = 0; b < V; b += 2) *reinterpret_cast<uint16_t*>(p + b) = 0;
    }
  }
  // table s + 1 is filled while stage s is issued; a barrier lies between
  // a table's filling and its use, and between its use and its refilling
  // two stages later
  fill(0);
  __syncthreads();
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    load(s);
    fill(s + 1);
    if (s + 1 < kStages - 1) __syncthreads();
  }

  for (int s = 0; s < S; ++s) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage s in; stage s - 1's buffer free
    load(s + kStages - 1);
    fill(s + kStages);
    const uint32_t st = smem_u32(smem + (s % kStages) * stage_bytes<T>());
    const uint32_t da = st + a_off, xa = st + b_off;
    if constexpr (kF32) {
#pragma unroll 4
      for (int k = 0; k < 2 * kTH; ++k) {  // half a row of positions a step
        const int pos = (k >> 1) * kTW + (k & 1) * 8;
        const int px = (k >> 1) * kHW + (k & 1) * 8;
        uint32_t ah[2][4], al[2][4], bh[kNT][2], bl[kNT][2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const uint32_t p = da + pos * kPitch + i * 64;
          const uint32_t v[4] = {lds32(p), lds32(p + 32),
                                 lds32(p + 4 * kPitch),
                                 lds32(p + 4 * kPitch + 32)};
#pragma unroll
          for (int e = 0; e < 4; ++e) split_tf32(v[e], ah[i][e], al[i][e]);
        }
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          const uint32_t p = xa + px * kPitch + j * 32;
          split_tf32(lds32(p), bh[j][0], bl[j][0]);
          split_tf32(lds32(p + 4 * kPitch), bh[j][1], bl[j][1]);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < kNT; ++j)
            mma_3xtf32(acc[i][j], ah[i], al[i], bh[j][0], bh[j][1], bl[j][0],
                       bl[j][1]);
      }
    } else {
#pragma unroll 2
      for (int k = 0; k < kTH; ++k) {  // a row of 16 positions a step
        uint32_t a[2][4], b[kNT][2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          ldsm_x4_trans(a[i], da + k * kTW * kPitch + i * 32);
#pragma unroll
        for (int p = 0; p < kNT / 2; ++p) {
          uint32_t r4[4];
          ldsm_x4_trans(r4, xa + k * kHW * kPitch + p * 32);
          b[2 * p][0] = r4[0], b[2 * p][1] = r4[1];
          b[2 * p + 1][0] = r4[2], b[2 * p + 1][1] = r4[3];
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < kNT; ++j)
            mma_bf16(acc[i][j], a[i], b[j][0], b[j][1]);
      }
    }
    if ((s + 1) % kPromote == 0) promote();
  }
  cp_async_wait<0>();
  promote();

  // lane 4g + t holds output channels co0 + 16 i + g (+8) and input
  // channels ci0 + 8 j + 2t (+1) of its tap
  const int E = KZ * 9 * C * CO;
  float* out = part + ((size_t)m * volumes * splits + (size_t)v * splits +
                       sv) * E + (size_t)(z * 9 + warp) * C * CO;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int co = co0 + 16 * i + g + 8 * (e >> 1);
        const int ci = ci0 + 8 * j + 2 * tq + (e & 1);
        if (co < CO && ci < C) out[(size_t)ci * CO + co] = tot[i][j][e];
      }
}

struct Args {
  const void* x;
  const void* dy;
  float* part;
  int N, members, depth, H, W, C, CO, KZ, splits, per_split;
  cudaStream_t stream;
};

template <typename T, int V, int kCi, int VD>
int launch(const Args& a) {
  constexpr int kSmem = smem_bytes<T>();
  const auto kernel = wgrad_kernel<T, V, kCi, VD>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const long long items =
      (long long)a.KZ * ((a.C + kCi - 1) / kCi) * ((a.CO + kCh - 1) / kCh);
  const long long blocks = (long long)(a.N / a.depth) * a.splits * items;
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<(unsigned)blocks, kThreads, kSmem, a.stream>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.dy), a.part, a.N,
      a.members, a.depth, a.H, a.W, a.C, a.CO, a.KZ, a.splits, a.per_split);
  return static_cast<int>(cudaGetLastError());
}

// x's granule vec; dy's 16 bytes (kDy16) or vec
template <typename T, int kCi, bool kDy16>
int launch_v(int vec, const Args& a) {
  switch (vec) {
    case 16:
      return launch<T, 16, kCi, 16>(a);
    case 8:
      return launch<T, 8, kCi, kDy16 ? 16 : 8>(a);
    case 4:
      return launch<T, 4, kCi, kDy16 ? 16 : 4>(a);
    case 2:
      if constexpr (sizeof(T) == 2) return launch<T, 2, kCi, kDy16 ? 16 : 2>(a);
      break;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, int kCi>
int launch_d(int vec, int dvec, const Args& a) {
  if (dvec == 16) return launch_v<T, kCi, true>(vec, a);
  if (dvec == vec) return launch_v<T, kCi, false>(vec, a);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int launch_ci(int ci, int vec, int dvec, const Args& a) {
  switch (ci) {
    case 8:
      if constexpr (sizeof(T) == 4) return launch_d<T, 8>(vec, dvec, a);
      break;
    case 16:
      return launch_d<T, 16>(vec, dvec, a);
    case 32:
      return launch_d<T, 32>(vec, dvec, a);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x (N, H, W, C), dy (N, H, W, CO) contiguous, `members` groups of N /
// members planes; dtype 0 = float32, 1 = bfloat16; dw (members, KZ, 3, 3,
// C, CO) f32.  ci: the input channels of an item (8 f32 only, 16, 32).
// Each volume of `depth` planes is cut into `splits` runs of `per_split`
// position tiles (8 x 16; the last run may be shorter, none empty); with
// more than one partial a member (volumes x splits), scratch holds members
// x partials x KZ*9*C*CO f32.  vec, dvec: the bytes of x's and dy's
// cp.async granules (16, 8, 4; 2 for bf16 only; dvec 16 or vec), which
// must divide their rows (C and CO times the element size) and their
// addresses.  Returns cudaGetLastError() after the launches
// (cudaErrorInvalidValue for arguments the kernels do not take).
extern "C" int dgtta_conv3x3_wgrad(const void* x, const void* dy, void* dw,
                                   void* scratch, int N, int members,
                                   int depth, int H, int W, int C, int CO,
                                   int KZ, int ci, int splits, int per_split,
                                   int vec, int dvec, int dtype,
                                   void* stream) {
  if (N <= 0 || members <= 0 || N % members != 0 || depth <= 0 ||
      (N / members) % depth != 0 || H <= 0 || W <= 0 || C <= 0 || CO <= 0 ||
      (KZ != 1 && KZ != 3) || splits <= 0 || per_split <= 0 || vec <= 0 ||
      dvec <= 0 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles_v = depth * ((H + kTH - 1) / kTH) * ((W + kTW - 1) / kTW);
  if ((long long)(splits - 1) * per_split >= tiles_v ||
      (long long)splits * per_split < tiles_v)
    return static_cast<int>(cudaErrorInvalidValue);  // an empty or lost run
  const size_t e = dtype == 0 ? 4 : 2;
  if ((C * e) % vec != 0 || (CO * e) % dvec != 0 ||
      reinterpret_cast<uintptr_t>(x) % vec != 0 ||
      reinterpret_cast<uintptr_t>(dy) % dvec != 0 ||
      (long long)H * W > 0x7FFFFFFFLL)  // a plane's pixel indices are ints
    return static_cast<int>(cudaErrorInvalidValue);
  const int P = N / members / depth * splits;  // partials a member
  if (P > 1 && scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = P == 1 ? static_cast<float*>(dw) : static_cast<float*>(scratch);
  const Args a{x, dy, part, N, members, depth, H, W, C, CO, KZ, splits,
               per_split, s};
  const int err = dtype == 0 ? launch_ci<float>(ci, vec, dvec, a)
                             : launch_ci<bf16>(ci, vec, dvec, a);
  if (err != 0) return err;
  if (P > 1)
    sum_splits<float>(part, static_cast<float*>(dw),
                      (long long)KZ * 9 * C * CO, members, P, s);
  return static_cast<int>(cudaGetLastError());
}
