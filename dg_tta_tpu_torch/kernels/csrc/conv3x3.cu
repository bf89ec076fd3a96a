// 3x3 stride-1 pad-1 convolution on NHWC planes, with an optional sum over
// three z-neighbour planes (the z-taps of a 3x3x3 conv), for sm_90a: the
// catch-all route ("cuda_core" in the wrappers and counters, the name it
// had when it ran on the CUDA cores), for every C >= 1 and every CO, on the
// tensor cores (wgmma; f32 as 3xTF32).
//
// Replaces dg_tta_tpu/ops/conv2d_pallas.py::conv3x3_pallas, and with KZ=3 the
// three z-tap calls of it that dg_tta_tpu/models/unet.py::_conv sums per
// stride-1 3x3x3 conv:
//
//   y[n,h,w,co] = sum_{kz<KZ} sum_{ky,kx<3} sum_{ci<C}
//                   x[n+kz-KZ/2, h+ky-1, w+kx-1, ci] * w[kz,ky,kx,ci,co]
//
// with zeros outside the plane and outside the plane's group of `depth`
// consecutive planes (one group = one (b, :) volume of a (B, D, H, W, C)
// tensor viewed as (B*D, H, W, C)).  Inputs f32 or bf16, f32 sums, output in
// the input's type.  The route takes what the other routes do not: output
// channels that are not a multiple of 8 (a plan's widths 30, 60, 300; the
// input gradient of a 12- or 1-channel stem), and any shape a caller forces
// onto it.
//
// What bounds it on an H100: at C, CO = 30..300 a conv does 2*27*C*CO
// operations per output voxel against (C + CO) elements of device traffic,
// hundreds of operations per byte: bound by the tensor cores, 989 TFLOP/s in
// bf16 and 495/3 in f32 taken as three tf32 products.  The first version of
// this file ran f32 FMAs on the CUDA cores (67 TFLOP/s), restaging each
// halo synchronously with bounds-checked scalar loads: 142.3 ms for the
// TS104 forward row forced onto it in f32 (34% of the CUDA-core bound).
//
// The design (an implicit GEMM per block, M = output pixels, N = output
// channels, K = (kz, channel chunk, ky, kx, ci)):
// * a block of two warpgroups owns a 16 x 16 pixel tile of one plane and BN
//   output channels, wgmma's N: CO rounded up to 8, 16 or 32, else column
//   tiles of 64 (30 computes 32 columns, 12 16, 1 8, 300 five tiles of 64);
//   warpgroup g takes m64 tiles 2g and 2g + 1 (tile rows 8g .. 8g + 7), the
//   block's BN columns;
// * a stage is one (z-tap, chunk of KC input channels: 16 bf16 or 8 f32,
//   one MMA depth): the tile's zero-padded 18 x 18 halo of x at those
//   channels and the chunk's weights for the nine (ky, kx) taps; A comes
//   through registers, each warp's 16 rows (one tile row) read by ldmatrix
//   from the halo at the tap's shift (an m64 tile spans four tile rows,
//   which no descriptor's single 8-row stride expresses); B by descriptor;
// * C is zero-padded to KC in shared memory only: x is read at its own C by
//   cp.async of the widest granule that a pixel's row allows (V = 16, 8 or
//   4 bytes; bf16 at odd C has 2-byte rows, which cp.async cannot copy:
//   plain loads there), V a template argument the wrapper picks, granules
//   past C or outside the plane zero-filled; with one chunk (C <= KC) a
//   stage copies only the granules that hold channels, the others zeroed
//   once in every slot (C = 1: 1 granule a pixel, not 16); the tile is the
//   block's for all its stages, so its 18 x 18 halo pixels' offsets (or -1
//   outside the plane) are computed once into a table in shared memory,
//   and a granule's copy costs a table read, two compares and an address;
// * the weights are packed by a first launch of the same call (pack_kernel;
//   kernels/conv3x3.py pack_cuda_core_weights is its plain version): per
//   member, z-tap, chunk and column tile one contiguous block
//   [part][tap][BN][KC], CO and C zero-padded, rows of 32 bytes K-major with
//   wgmma's 32-byte swizzle applied, f32 split into its tf32 part and
//   remainder (part 0 and 1); a stage copies its block as it lies by
//   16-byte cp.async, and the descriptors read it there (B of f32 wgmma
//   must be K-major, and w's rows run along CO, so they are transposed
//   somewhere: one pass over a few MB, not a pass per block);
// * stages run in a ring of three, filled by cp.async while earlier stages
//   compute, one barrier a stage; the halo rows are 48 bytes apart (32 of
//   data), so that the eight rows of an ldmatrix fall in distinct banks;
// * a tap is one wgmma group (both m64 tiles; f32: lo * B_hi, hi * B_lo,
//   hi * B_hi, the tiles alternating); its A fragments load into one of
//   three register sets while the previous tap's group runs; the stage
//   drains its groups before the next barrier gives its buffer back;
// * f32: each A fragment is split into tf32 hi and remainder in registers;
//   the tensor core's adds truncate, so the accumulators are promoted into
//   an f32 total every kPromote stages (K = 288);
// * a z-tap whose plane lies outside the group is skipped by the whole
//   block; the store masks rows past H, W and columns past CO;
// * where a volume has few (plane, tile, column tile) items (the 7 x 8 and
//   14 x 16 levels: 35-56 items against 132 SMs, each a K of up to 27 x
//   320), the (z-tap, chunk) stages are cut into up to 8 runs, a block
//   each (kernels/conv3x3.py cuda_core_plan, from one volume's shape), and
//   a second kernel adds the runs' f32 partial sums in order;
// * members: x holds `members` groups of N / members planes, and plane n
//   takes member n / (N / members)'s packed weights; a block's sums are those
//   of a launch of that member alone, and the splits follow one volume, so
//   a member's output is bit for bit its own launch's.
// Times (device ms by CUDA graph, obs/conv_times.py --ragged, NVIDIA H100
// 80GB HBM3 at 700 W; rows: the ragged net's forward, and the TS104 shapes
// forced here; f32 / bf16).  The first design, on mma.sync (a warp per 64
// pixels x 32 columns, B by ldmatrix, bf16 halo rows reused across ky),
// step by step in one call each: 44.97 / 11.50 and 60.35 / 14.16; the
// halo offset table 43.60 / 9.91 and 60.05 / 13.70; the row reuse 9.68 /
// 13.58 (bf16).  Stage splits took the 7 x 8 level's f32 window forward
// from 0.606 to 0.210 ms; splitting 28 x 32 too (224 items) cost its bf16
// window 0.090 -> 0.109, so only volumes under one wave split.  wgmma
// against mma.sync on the same packed, swizzled weights, in one call: f32
// 27.574 against 39.115 (ragged) and 37.241 against 52.948 (forced), bf16
// 8.677 against 9.317 and 11.223 against 12.376: wgmma as fast or faster
// at every shape (within 1% at bf16 1 -> 32 and 60 -> 30), so mma.sync
// went.  Copying only the granules of a one-chunk C: bf16 forced 1 -> 32
// window 0.480 -> 0.294 ms (`F.conv3d` 0.292).
// Dropped: 3xTF32 pass by pass (four independent products between two on
// one accumulator): f32 60.75 against 60.32 on mma.sync, ptxas already
// interleaves; one block an SM for bf16 on mma.sync: 14.80 against 13.73.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "mma_sync.cuh"

namespace {

using namespace dgtta_ms;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kTH = 16, kTW = 16;  // output pixels of a block
constexpr int kHW = kTW + 2;       // halo row
constexpr int kHalo = (kTH + 2) * kHW;
constexpr int kPitch = 48;  // bytes per staged halo row (32 of data)
// the halo's bytes, rounded up to the 256-byte atom of the weights' 32-byte
// swizzle
constexpr int kHaloBytes = (kHalo * kPitch + 255) / 256 * 256;

template <typename T>
struct Cfg;
template <>
struct Cfg<bf16> {
  static constexpr int kKC = 16, kStages = 3, kMinBlocks = 2, kParts = 1;
};
template <>
struct Cfg<float> {
  static constexpr int kKC = 8, kStages = 3, kMinBlocks = 1, kParts = 2,
                       kPromote = 4;
};

// Two warpgroups, g taking m64 tiles 2g and 2g + 1 of the block's 16 x 16
// pixels (tile rows 8g .. 8g + 7: warp w of the warpgroup holds rows 8g + w
// and 8g + 4 + w, an m16 tile each), all BN columns.
constexpr int kMT = 2;

template <typename T, int BN>
__host__ __device__ constexpr int stage_bytes() {
  return kHaloBytes + Cfg<T>::kParts * 9 * BN * 32;
}

// alignment slack, the ring (stages 1024-byte aligned at the first), then
// the halo's pixel offsets (`kHalo` ints)
template <typename T, int BN>
__host__ __device__ constexpr int smem_bytes() {
  return 1024 + Cfg<T>::kStages * stage_bytes<T, BN>() + kHalo * 4;
}

// Stages the zero-padded halo of x (`xp`: its plane, channels c0 .. c0 +
// KC) around the block's tile: 18 x 18 rows of 32 bytes, kPitch apart, the
// first `gs` granules of V bytes of each row (the others hold zeros
// already).  tab[px]: the offset of halo pixel px's first channel in a
// plane, -1 outside it (the tile is the block's for every stage, so the
// table is computed once).  Granules of 2 or 4 bytes (8 or 16 a row) loop
// over the gs granules alone; wider ones over all (2 or 4) and skip.
template <typename T, int V>
__device__ __forceinline__ void stage_x(uint8_t* xs, const T* __restrict__ xp,
                                        const int* tab, int C, int c0,
                                        int gs) {
  constexpr int kE = V / (int)sizeof(T);    // channels of a granule
  const int n = V <= 4 ? gs : 32 / V;
  for (int i = threadIdx.x; i < kHalo * n; i += kThreads) {
    const int px = i / n, g = i % n;
    if (V > 4 && g >= gs) continue;
    const int off = tab[px], ch = c0 + g * kE;
    const bool ok = off >= 0 && ch < C;
    copy_async<V>(xs + px * kPitch + g * V, ok ? xp + off + ch : xp, ok);
  }
}

// Stages one packed weight block (pack_kernel): kParts * 9 * BN rows of 32
// bytes, as they lie.
template <typename T, int BN>
__device__ __forceinline__ void stage_w(uint8_t* ws,
                                        const uint8_t* __restrict__ src) {
  constexpr int kChunks = Cfg<T>::kParts * 9 * BN * 2;
  for (int i = threadIdx.x; i < kChunks; i += kThreads)
    copy_async<16>(ws + i * 16, src + i * 16, true);
}

// The weights w (members * KZ, 3, 3, C, CO) as the stages take them: per
// member, z-tap, chunk of KC input channels and tile of BN output channels
// one block [part][tap][BN][KC] (f32: part 0 the tf32 part of each weight,
// part 1 the remainder; bf16 one part), C and CO zero-padded.  A row is
// one output channel's KC input channels, 32 bytes (K-major: the B operand
// of both bodies), and rows whose bit 2 is set hold their two 16-byte
// halves swapped: wgmma's 32-byte swizzle, so that a block copied as it
// lies into a stage (256-byte aligned) is the operand its descriptors
// read.
template <typename T>
__global__ void pack_kernel(const T* __restrict__ w, T* __restrict__ wp,
                            int C, int CO, int bn, int nch, int co_tiles,
                            long long total) {
  using CF = Cfg<T>;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  long long r = i;
  const int k = r % CF::kKC;
  r /= CF::kKC;
  const int row = r % bn;
  r /= bn;
  const int tap = r % 9;
  r /= 9;
  const int part = r % CF::kParts;
  r /= CF::kParts;
  const int ct = r % co_tiles;
  r /= co_tiles;
  const int c = r % nch;
  r /= nch;  // member * KZ + z
  constexpr int kHalf = CF::kKC / 2;
  const int ci =
      c * CF::kKC + ((k / kHalf) ^ ((row >> 2) & 1)) * kHalf + k % kHalf;
  const int co = ct * bn + row;
  float v = 0.f;
  if (ci < C && co < CO) {
    const T e = w[((r * 9 + tap) * C + ci) * CO + co];
    if constexpr (sizeof(T) == 2) v = __bfloat162float(e);
    else v = e;
  }
  if constexpr (CF::kParts == 2) {
    const float hi = __uint_as_float(dgtta::round_tf32(v));
    v = part == 0 ? hi : v - hi;
  }
  wp[i] = from_f32<T>(v);
}

template <typename T, int BN, int V>
__global__ void __launch_bounds__(kThreads, Cfg<T>::kMinBlocks)
conv3x3_kernel(const T* __restrict__ x, const T* __restrict__ wp,
               T* __restrict__ y, float* __restrict__ part, int N,
               int members, int depth, int H, int W, int C, int CO, int KZ,
               int splits, int per_split) {
  using CF = Cfg<T>;
  constexpr int kNT = BN / 8;  // n8 tiles
  constexpr bool kF32 = sizeof(T) == 4;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = dgtta::align_1024(smem_raw);

  const int tiles_w = (W + kTW - 1) / kTW;
  const int tiles = ((H + kTH - 1) / kTH) * tiles_w;
  const int co_tiles = (CO + BN - 1) / BN;
  const int nch = (C + CF::kKC - 1) / CF::kKC;
  // block -> (plane, tile, split, column tile), column tiles fastest
  int r = blockIdx.x;
  const int ct = r % co_tiles;
  r /= co_tiles;
  const int sp = r % splits;
  r /= splits;
  const int t = r % tiles;
  const int n = r / tiles;
  const int m = n / (N / members);
  const int d = n % depth;
  const int h0 = (t / tiles_w) * kTH, w0 = (t % tiles_w) * kTW;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // the tile row of the warp's first m16 tile
  const int row0 = 8 * (warp >> 2) + (warp & 3);

  // the split's run of (z-tap, chunk) stages, z-major, less the z-taps
  // whose planes lie outside the group (contiguous at the run's ends)
  const int z_lo = (KZ == 3 && d == 0) ? 1 : 0;
  const int z_hi = (KZ == 3 && d == depth - 1) ? 2 : KZ;
  const int begin = max(sp * per_split, z_lo * nch);
  const int S = max(0, min((sp + 1) * per_split, z_hi * nch) - begin);
  const size_t wblock = (size_t)CF::kParts * 9 * BN * CF::kKC;
  const T* wm_base = wp + (size_t)m * KZ * nch * co_tiles * wblock;

  // the halo's pixel offsets, for every stage of the block
  int* tab = reinterpret_cast<int*>(smem + CF::kStages * stage_bytes<T, BN>());
  for (int px = threadIdx.x; px < kHalo; px += kThreads) {
    const int h = h0 + px / kHW - 1, w = w0 + px % kHW - 1;
    tab[px] = h >= 0 && h < H && w >= 0 && w < W ? (h * W + w) * C : -1;
  }
  // granules a stage copies per halo row: with one chunk (C <= KC) those
  // that hold channels, the rest zeroed here once in every slot
  constexpr int kG = 32 / V;
  const int gs = nch == 1 ? (C * (int)sizeof(T) + V - 1) / V : kG;
  if (gs < kG) {
    for (int i = threadIdx.x; i < CF::kStages * kHalo * (kG - gs);
         i += kThreads) {
      const int row = i / (kG - gs), g = gs + i % (kG - gs);
      uint8_t* p = smem + (row / kHalo) * stage_bytes<T, BN>() +
                   (row % kHalo) * kPitch + g * V;
#pragma unroll
      for (int b = 0; b < V; b += 2) *reinterpret_cast<uint16_t*>(p + b) = 0;
    }
  }
  __syncthreads();

  auto load = [&](int s) {
    if (s < S) {
      const int z = (begin + s) / nch, c = (begin + s) % nch;
      uint8_t* st = smem + (s % CF::kStages) * stage_bytes<T, BN>();
      stage_x<T, V>(st, x + (size_t)(n + z - KZ / 2) * H * W * C, tab, C,
                    c * CF::kKC, gs);
      stage_w<T, BN>(st + kHaloBytes,
                     reinterpret_cast<const uint8_t*>(
                         wm_base + (((size_t)z * nch + c) * co_tiles + ct) *
                                       wblock));
    }
    cp_async_commit();
  };

  // A by ldmatrix: lane l addresses pixel (l % 8) + 8 (q % 2) of an m16
  // tile at byte (q / 2) * 16 of its row (q = l / 8, the matrix the lane
  // addresses); for f32 a 16-byte row of an 8 x 8 b16 matrix is 4 floats,
  // and lane l receives word l % 4 of row l / 4: the tf32 fragment
  const int q = lane >> 3;
  const uint32_t a_off =
      (row0 * kHW + (lane & 7) + ((q & 1) << 3)) * kPitch + ((q >> 1) << 4);

  // acc[i][4 j + 2 h + c]: m16 tile i, pixel g + 8 h, column 8 j + 2 t + c
  // (lane 4 g + t)
  float acc[kMT][4 * kNT];
  float tot[kF32 ? kMT : 1][4 * kNT];  // f32: the promoted sums
#pragma unroll
  for (int i = 0; i < kMT; ++i) {
#pragma unroll
    for (int e = 0; e < 4 * kNT; ++e) acc[i][e] = 0.f;
    dgtta::fence_operands(acc[i]);
  }
  if constexpr (kF32) {
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int e = 0; e < 4 * kNT; ++e) tot[i][e] = 0.f;
  }
  // f32: the wgmmas have retired; adds the accumulators into tot (rounded)
  auto promote = [&]() {
    if constexpr (kF32) {
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
#pragma unroll
        for (int e = 0; e < 4 * kNT; ++e) {
          tot[i][e] += acc[i][e];
          acc[i][e] = 0.f;
        }
        dgtta::fence_operands(acc[i]);
      }
    }
  };
  // a tap's A fragments, three sets, so that tap j loads set j % 3 while
  // tap j - 1's group runs (loading a set a running group reads makes
  // ptxas serialize the wgmmas)
  uint32_t fr[3][kMT][kF32 ? 8 : 4];

#pragma unroll
  for (int s = 0; s < CF::kStages - 1; ++s) load(s);

  for (int s = 0; s < S; ++s) {
    cp_async_wait<CF::kStages - 2>();
    dgtta::fence_proxy_async();  // the weights are read by wgmma
    __syncthreads();  // stage s in; stage s - 1's buffer free
    load(s + CF::kStages - 1);
    uint8_t* stp = smem + (s % CF::kStages) * stage_bytes<T, BN>();
    const uint32_t xa = smem_u32(stp) + a_off;
    // per tap one group: both m64 tiles (f32: (lo, B_hi), (hi, B_lo),
    // (hi, B_hi), the tiles alternating), B by descriptor (K-major,
    // 32-byte swizzle, 8-row groups 256 bytes apart)
    const uint64_t db0 = dgtta::smem_desc(stp + kHaloBytes, 16, 256, 32);
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int ky = tap / 3, kx = tap % 3;
      auto& f = fr[tap % 3];
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        uint32_t a[4];
        ldsm_x4(a, xa + ((4 * i + ky) * kHW + kx) * kPitch);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if constexpr (kF32) split_tf32(a[e], f[i][e], f[i][4 + e]);
          else f[i][e] = a[e];
        }
      }
      const uint64_t db = db0 + ((tap * BN * 32) >> 4);
      dgtta::wgmma_fence();
      if constexpr (kF32) {
        const uint64_t db_lo = db + ((9 * BN * 32) >> 4);
#pragma unroll
        for (int p = 0; p < 3; ++p)
#pragma unroll
          for (int i = 0; i < kMT; ++i)
            dgtta::wgmma_m64k8_tf32<BN>(
                acc[i],
                *reinterpret_cast<const uint32_t(*)[4]>(f[i] +
                                                        (p == 0 ? 4 : 0)),
                p == 1 ? db_lo : db);
      } else {
#pragma unroll
        for (int i = 0; i < kMT; ++i)
          dgtta::wgmma_m64k16_rs<BN, 0>(
              acc[i], *reinterpret_cast<const uint32_t(*)[4]>(f[i]), db);
      }
      dgtta::wgmma_commit();
      dgtta::wgmma_wait<1>();
    }
    // the stage's buffer is refilled after the next barrier
    dgtta::wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < kMT; ++i) dgtta::fence_operands(acc[i]);
    if constexpr (kF32) {
      if ((s + 1) % CF::kPromote == 0) promote();
    }
  }
  cp_async_wait<0>();
  promote();

  // the store: lane 4g + t holds pixels g and g + 8 of each m16 tile (one
  // tile row), columns 2t, 2t + 1 of each n8 tile; y itself, or with
  // several splits this split's f32 partial sums (added by sum_splits)
  const int g = lane >> 2, tq = lane & 3;
  const size_t plane_off = (size_t)n * H * W * CO;
#pragma unroll
  for (int i = 0; i < kMT; ++i) {
    const int h = h0 + row0 + 4 * i;
    if (h >= H) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int w = w0 + g + 8 * half;
      if (w >= W) continue;
      const size_t off = plane_off + ((size_t)h * W + w) * CO;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const int co = ct * BN + j * 8 + 2 * tq;
        const int e = 4 * j + 2 * half;
        const float v0 = kF32 ? tot[i][e] : acc[i][e];
        const float v1 = kF32 ? tot[i][e + 1] : acc[i][e + 1];
        if (splits == 1)
          store2<T>(y + off, co, CO, v0, v1);
        else
          store2<float>(part + (size_t)sp * N * H * W * CO + off, co, CO, v0,
                        v1);
      }
    }
  }
}

struct Args {
  const void* x;
  const void* wp;
  void* y;
  float* part;
  int N, members, depth, H, W, C, CO, KZ, splits, per_split;
  cudaStream_t stream;
};

template <typename T>
int pack(const void* w, void* wp, int members, int KZ, int C, int CO, int bn,
         cudaStream_t stream) {
  const int nch = (C + Cfg<T>::kKC - 1) / Cfg<T>::kKC;
  const int co_tiles = (CO + bn - 1) / bn;
  const long long total = (long long)members * KZ * nch * co_tiles *
                          Cfg<T>::kParts * 9 * bn * Cfg<T>::kKC;
  const int threads = 256;
  pack_kernel<T><<<(unsigned)((total + threads - 1) / threads), threads, 0,
                   stream>>>(static_cast<const T*>(w), static_cast<T*>(wp),
                             C, CO, bn, nch, co_tiles, total);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int BN, int V>
int launch(const Args& a) {
  constexpr int kSmem = smem_bytes<T, BN>();
  const auto kernel = conv3x3_kernel<T, BN, V>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const int tiles = ((a.H + kTH - 1) / kTH) * ((a.W + kTW - 1) / kTW);
  const int co_tiles = (a.CO + BN - 1) / BN;
  const int stages = a.KZ * ((a.C + Cfg<T>::kKC - 1) / Cfg<T>::kKC);
  // every split a non-empty run of the KZ * nch stages, none left out
  if ((long long)(a.splits - 1) * a.per_split >= stages ||
      (long long)a.splits * a.per_split < stages)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (long long)a.N * tiles * a.splits * co_tiles;
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<(unsigned)blocks, kThreads, kSmem, a.stream>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.wp),
      static_cast<T*>(a.y), a.part, a.N, a.members, a.depth, a.H, a.W, a.C,
      a.CO, a.KZ, a.splits, a.per_split);
  if (a.splits > 1)
    sum_splits<T>(a.part, static_cast<T*>(a.y),
                  (long long)a.N * a.H * a.W * a.CO, 1, a.splits, a.stream);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int BN>
int launch_v(int vec, const Args& a) {
  switch (vec) {
    case 16:
      return launch<T, BN, 16>(a);
    case 8:
      return launch<T, BN, 8>(a);
    case 4:
      return launch<T, BN, 4>(a);
    case 2:
      if constexpr (sizeof(T) == 2) return launch<T, BN, 2>(a);
      [[fallthrough]];
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch_bn(int bn, int vec, const Args& a) {
  switch (bn) {
    case 8:
      return launch_v<T, 8>(vec, a);
    case 16:
      return launch_v<T, 16>(vec, a);
    case 32:
      return launch_v<T, 32>(vec, a);
    case 64:
      return launch_v<T, 64>(vec, a);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

bool pack_args_ok(int members, int KZ, int C, int CO, int bn, int dtype) {
  return members > 0 && (KZ == 1 || KZ == 3) && C > 0 && CO > 0 &&
         (bn == 8 || bn == 16 || bn == 32 || bn == 64) &&
         (dtype == 0 || dtype == 1) &&
         (long long)KZ * members * 9 * C * CO <= 0x7FFFFFFFLL;
}

}  // namespace

// The weights w (members, KZ, 3, 3, C, CO) packed for bn-column tiles into
// wp (members x KZ x ceil(C / KC) x ceil(CO / bn) blocks of [part][9][bn][KC]
// in w's type, KC = 16 bf16 / 8 f32; pack_kernel's layout;
// kernels/conv3x3.py::pack_cuda_core_weights is its plain version).
extern "C" int dgtta_conv3x3_pack(const void* w, void* wp, int members,
                                  int KZ, int C, int CO, int bn, int dtype,
                                  void* stream) {
  if (!pack_args_ok(members, KZ, C, CO, bn, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? pack<float>(w, wp, members, KZ, C, CO, bn, s)
                    : pack<bf16>(w, wp, members, KZ, C, CO, bn, s);
}

// x (N, H, W, C) of `members` groups of N / members planes; w (members, KZ,
// 3, 3, C, CO); wp scratch for its packed form (dgtta_conv3x3_pack's,
// written first); y (N, H, W, CO).  dtype: 0 = float32, 1 = bfloat16;
// bn: the columns of a block (8, 16, 32 or 64); vec:
// the bytes of x's cp.async granule (16, 8, 4; 2 for bf16 only), which
// must divide C * sizeof(T) and x's address; splits, per_split: the runs
// of per_split stages the KZ * ceil(C / KC) stages are cut into, a block
// each (none empty, none left out), their partial sums in scratch (splits
// x N x H x W x CO f32) added in order by a second kernel; with one split,
// scratch is unused.  Returns cudaGetLastError() after the launches
// (cudaErrorInvalidValue for arguments the kernels do not take).
extern "C" int dgtta_conv3x3(const void* x, const void* w, void* wp, void* y,
                             void* scratch, int N, int members, int depth,
                             int H, int W, int C, int CO, int KZ, int bn,
                             int vec, int splits, int per_split, int dtype,
                             void* stream) {
  if (N <= 0 || members <= 0 || N % members != 0 || depth <= 0 ||
      (N / members) % depth != 0 || H <= 0 || W <= 0 ||
      !pack_args_ok(members, KZ, C, CO, bn, dtype) || splits <= 0 ||
      per_split <= 0 || (splits > 1 && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t e = dtype == 0 ? 4 : 2;
  if ((C * e) % vec != 0 || reinterpret_cast<uintptr_t>(x) % vec != 0 ||
      (long long)H * W * C > 0x7FFFFFFFLL)  // a plane's offsets are ints
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Args a{x, wp, y, static_cast<float*>(scratch), N, members, depth, H,
               W, C, CO, KZ, splits, per_split, s};
  if (dtype == 0) {
    const int err = pack<float>(w, wp, members, KZ, C, CO, bn, s);
    return err != 0 ? err : launch_bn<float>(bn, vec, a);
  }
  const int err = pack<bf16>(w, wp, members, KZ, C, CO, bn, s);
  return err != 0 ? err : launch_bn<bf16>(bn, vec, a);
}
