// Weight gradient of the stride-1 3x3(x3) convolution on Hopper's tensor
// cores (sm_90a), one source for both types:
//   * f32 x and dy (C % 8 == 0, CO % 8 == 0), route "wgmma_tf32x3": every
//     product at f32 accuracy from three tf32 products (3xTF32, below);
//   * bf16 x and dy (C % 16 == 0, CO % 8 == 0), route "wgmma".
//
// The backward of dg_tta_tpu/ops/conv2d_pallas.py::conv3x3_pallas, which the
// TPU package left to XLA's conv transpose; conv3x3_c1.cu takes C = 1,
// conv3x3_few.cu 1 < C < 16 and conv3x3_wgrad.cu the other channel counts.
// The same function as conv3x3_wgrad.cu:
//
//   dW[kz,ky,kx,ci,co] = sum_{n,h,w} x[n+kz-KZ/2, h+ky-1, w+kx-1, ci]
//                                    * dy[n,h,w,co]
//
// zero-padded as the forward pads (in H and W, and within the plane's group
// of `depth` planes), f32 sums and f32 dW.
//
// What bounds it on an H100: 2*27*C*CO operations per position against
// (C + CO) elements read: the tensor cores (bf16 at 989 TFLOP/s; f32 as
// three tf32 products at 495, so 3 * ops / 495e12 s).  The output is small
// (27*C*CO) and the sum long (up to 3.2M positions at the top level of a
// trained step), so the positions are split across blocks (split-K).  Per
// z-tap a GEMM: M = (tap, ci) rows, N = output channels, K = positions.
// Three kernels; kernels/conv3x3.py::wgrad_plan picks one by shape
// (`wgrad_kernel`) and its splits, and passes both here.
//
// Common to the kernels:
//   * Stages of 4 x 16 positions.  Per stage one TMA box brings the halo
//     x[plane, h0-1 : +6, w0-1 : +18, ci0 : ...] (TMA's out-of-bounds zero
//     fill is the H/W padding; channels past C read zeros or the next
//     tile's channels, which no row uses) and one box dy[n, h0 : +4, w0 :
//     +16, co0 : ...] with its span's swizzle.
//   * HBM once: the blocks are numbered split-major, so that the blocks of
//     one split (the channel tiles and, where a block takes one, the
//     z-taps) are neighbours in the launch order, run in the same wave and
//     meet in L2 on the same x and dy positions: x and dy come from HBM
//     about once per call.  At the top level of a trained step (2 x 112
//     planes of 112 x 128, C = CO = 32) that is 0.82 GB in f32 (x 411 MB,
//     dy 411 MB) and 0.41 GB in bf16, plus the partial sums (splits x 27 C
//     CO f32, under 10 MB there) written and read once, against 4.9 GB for
//     the first f32 design (a dy pre-pass through HBM, x and dy re-read per
//     kz and channel tile).
//   * Accuracy.  The tensor cores add each step into the f32 accumulator
//     with truncation.  Where a block's sum is long (up to 131072
//     positions), every kPromote stages (512 positions) a warpgroup drains
//     its wgmmas, adds the accumulator into f32 sums in shared memory
//     (rounded adds) and restarts it; the other kernels keep a block's sum
//     short instead (tests/test_torch_conv3x3.py models both).  Each block
//     writes its partial sums to its split's slice of a scratch buffer and
//     a second kernel adds the slices in a fixed order: deterministic, no
//     atomics.  With one split the first kernel writes dW.
//   * Members.  An ensemble chunk's members run side by side in one launch:
//     x and dy hold `members` groups of N planes (a member's batch, a
//     multiple of `depth`), and blockIdx.y is the member.  Its blocks are
//     those of a launch of that member alone, at planes offset by member x
//     N in the tensor maps; its partial sums go to its own slices of the
//     scratch and `sum_splits_kernel` adds each member's in split order
//     into dW[member]: a member's sums are the bits of a launch of it
//     alone, and never take a position of another member.
//
// f32, `wgrad_tf32x3_kernel<BN>`.  A block owns one z-tap, 32 input
// channels, BN output channels (32; 64 where CO >= 64) and a split of
// position tiles: M = 9 taps x 32 channels in five m64 tiles of two taps
// (the fifth: tap 8 and 32 zero rows), five consumer warpgroups of one
// tile each (672 threads leave 80 registers a thread; all three z-taps in
// one block would need 27 x 32 x 32 accumulators).
//   * A (x) from registers: the nine taps read the halo at shifts of ky *
//     18 + kx rows, which no descriptor expresses.  ldmatrix cannot
//     transpose 32-bit elements, so each thread loads its four values as
//     two 8-byte loads from halo rows padded to 36 floats (144 bytes: rows
//     g and g + 8 of a warp are neighbouring channels, `f32_ci`, and the
//     loads meet no bank conflict with no swizzle, every address a
//     per-thread base plus a constant) and splits each value v into hi =
//     round_tf32(v) (two integer operations, where cvt.rna.tf32 is ~5) and
//     lo = v - hi, unrounded (the tensor core truncates it).
//   * B (dy): tf32 wgmma reads 32-bit B K-major only, so the consumers
//     transpose the dy box (32-channel boxes, 128-byte swizzle) in shared
//     memory into K-major 32-byte rows (one k8 step of positions per output
//     channel, the 32-byte swizzle) as hi = round_tf32(dy) and lo = dy - hi,
//     three buffers deep, no pass through HBM; the next stage's transpose
//     runs in the middle of this stage's wgmmas, and one named barrier per
//     stage publishes it.  (The transpose costs the consumers time; a
//     producer warpgroup whose warps transposed, handing B over by
//     mbarriers, measured slower at every level.)
//   * A group is one k8 step's three products (lo, B_hi), (hi, B_lo),
//     (hi, B_hi); fragments load into the next of kSets register sets while
//     kInFlight groups run (kSets divides a stage's 8 groups, so the
//     rotation carries across stages, and no set a running group reads is
//     written: ptxas would serialize the wgmmas, C7513).
//   * BN = 32 promotes; BN = 64 (each fragment feeds twice the products:
//     84 TFLOP/s at the 56 x 64 level, against 62 for BN = 32 at the top
//     level, PERF.md section 6) has no registers or shared memory left for
//     the promoted sums, so its splits sum at most 2048 positions.
//
// bf16, C <= 32, `wgrad_bf16_zfirst_kernel`.  bf16 products are cheap, and
// one z-tap a block was bound by L2 (a halo and a dy box per 5 x 4
// m64n32k16 products, 40 bytes per tensor-core cycle of the SM): a block
// owns 32 input and 32 output channels and all three z-taps, M = 27 taps x
// 32 channels in 14 m64 tiles (the last: tap 26 and 32 zero rows), seven
// consumer warpgroups of two tiles.  It walks its positions z-first (a
// split is a run of (tile, plane) steps, planes fastest): the halo of each
// plane is staged once and serves three steps (as kz = 2, 1, 0), so a step
// loads one halo and one dy box for 14 x 4 products (14 bytes a cycle); a
// run that starts or changes tile loads its three planes.  Halos (rows
// padded to 40 values, 80 bytes: ldmatrix's eight rows fall in eight bank
// groups with no swizzle) and dy boxes have rings of their own; a
// warpgroup gives back the previous step's dy and the halo it no longer
// needs once that step's groups have retired.  A: one ldmatrix.x4.trans
// per k16 step (a 16-bit transpose: positions are rows in shared memory,
// channels M); a tap whose plane lies outside the group (the first and
// last plane of a volume) gets zero fragments.  B: the dy box as it is,
// MN-major by descriptor.  A group is one tile's k16 step; two register
// sets alternate with one group in flight (928 threads leave 64
// registers a thread, and ptxas reports the wgmmas serialized for
// registers, C7512).  Promotes.
//
// bf16, C > 32, `wgrad_bf16_desc_kernel<BN>` (below).

#include <cuda_bf16.h>
#include <stddef.h>

#include "hopper.cuh"

namespace {

using namespace dgtta;

constexpr int kTileH = 4;
constexpr int kTileW = 16;
constexpr int kHaloH = kTileH + 2;
constexpr int kHaloW = kTileW + 2;
constexpr int kPos = kTileH * kTileW;  // positions per stage (GEMM K)
constexpr int kCi = 32;                // input channels per block
constexpr int kBN = 32;                // output channels per block
constexpr int kPromote = 8;  // stages between accumulator promotions

// ---- f32 -------------------------------------------------------------------

namespace f32 {
constexpr int kWG = 5;  // consumer warpgroups: m64 tiles of taps 2j, 2j+1
constexpr int kThreads = kWG * 128 + 32;
constexpr int kStages = 4;
constexpr int kDyTBufs = 3;   // K-major dy buffers
constexpr int kRow = 144;     // a halo row: 36 floats
constexpr int kHaloTx = kHaloH * kHaloW * kRow;
constexpr int kHalo = (kHaloTx + 1023) / 1024 * 1024;
constexpr int kGroups = kPos / 8;  // k8 steps per stage
constexpr int kDyBox = kPos * 32 * 4;  // a dy box: 32 channels, 128-byte rows
// BN output channels a block: 32, or 64 where CO >= 64 (each fragment then
// feeds twice the products; the accumulators take the registers of the
// promotion, so a block sums at most 2048 positions, kernels/conv3x3.py)
template <int BN>
struct Cfg {
  static constexpr bool kPromotes = BN == 32;
  // rotating fragment sets, and the groups left running at each wait
  static constexpr int kSets = BN == 32 ? 4 : 2;
  static constexpr int kInFlight = BN == 32 ? 2 : 1;
  static constexpr int kDy = (BN / 32) * kDyBox;
  static constexpr int kStage = kHalo + kDy;
  static constexpr int kDyT = kGroups * BN * 32;  // one of hi, lo
  static constexpr int kTot = kPromotes ? kWG * 128 * (BN / 2) * 4 : 0;
  static constexpr int kSmem = 1024 + kStages * kStage +
                               kDyTBufs * 2 * kDyT + kTot + 2 * kStages * 8;
  static_assert(kGroups % kSets == 0, "fragment sets rotate by stage");
  static_assert(kInFlight < kSets, "a loaded set is never running");
};
}  // namespace f32

// ---- bf16 ------------------------------------------------------------------

namespace bf {
constexpr int kWG = 7;     // consumer warpgroups, m64 tiles 2j and 2j + 1
constexpr int kTiles = 2;  // m64 tiles a warpgroup: two taps x 32 channels
constexpr int kThreads = kWG * 128 + 32;
constexpr int kHS = 7;  // halo ring: a restart holds 2 x 3 halos
constexpr int kDS = 4;  // dy ring
constexpr int kDy = kPos * kBN * 2;  // 64-byte rows
constexpr int kRow = 80;             // a halo row: 40 values
constexpr int kHaloTx = kHaloH * kHaloW * kRow;
constexpr int kHalo = (kHaloTx + 1023) / 1024 * 1024;
constexpr int kTot = kWG * 128 * kTiles * (kBN / 2) * 4;
constexpr int kSmem =
    1024 + kHS * kHalo + kDS * kDy + kTot + 2 * (kHS + kDS) * 8;
static_assert(kHalo % 1024 == 0 && kDy % 1024 == 0, "1024-byte slots");
}  // namespace bf

// bf16, C > 32: both operands by descriptor (`wgrad_bf16_desc_kernel`)
namespace bd {
constexpr int kWG = 3;  // consumer warpgroups, one per ky
constexpr int kThreads = kWG * 128 + 32;
constexpr int kStages = 4;
constexpr int kCiTile = 64;        // input channels per block (GEMM M)
constexpr int kRow = kCiTile * 2;  // a halo row, 128-byte swizzle
constexpr int kHaloTx = kHaloH * kHaloW * kRow;
constexpr int kHalo = (kHaloTx + 1023) / 1024 * 1024;
template <int BN>
struct Cfg {
  static constexpr int kDy = kPos * BN * 2;
  static constexpr int kSmem =
      1024 + kStages * (kHalo + kDy) + 2 * kStages * 8;
};
}  // namespace bd

// Four transposed 8 x 8 matrices of 16-bit elements: lane l gives the
// shared-memory address of row l % 8 of matrix l / 8 (16 bytes); lane l
// receives, of every matrix, elements (row 2 (l % 4), column l / 4) in the
// low half and (row 2 (l % 4) + 1, column l / 4) in the high half.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// A barrier over the f32 kernel's consumer warpgroups alone (barrier 0 is
// __syncthreads).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(f32::kWG * 128) : "memory");
}

// f32: the channel (of the warp's 16, from 8 * (warp % 2)) of fragment row
// g; row g + 8 is the next channel, so that one 8-byte load gives both.
// The half-warp's (g, t) then reads 16 distinct bank pairs of the 144-byte
// halo rows: channels {0, 2, 16, 18} (+ 4 for g >= 4) + 4 t banks.
__device__ __forceinline__ int f32_ci(int g) {
  return 2 * (g & 1) + 4 * (g >> 2) + 16 * ((g >> 1) & 1);
}

// Adds the accumulator into this thread's f32 sums in shared memory (laid
// out [register][thread]: no bank conflicts) and clears it.
template <int R>
__device__ __forceinline__ void promote(float (&acc)[R], float* tot,
                                        int stride) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
    tot[i * stride] += acc[i];
    acc[i] = 0.f;
  }
}

// The rows of an m64 tile held by this thread, stored: rows g and g + 8 of
// its warp as channels c0 and c1 of the tap's dW slice `out` (C x CO),
// columns co0 .. co0 + 2 R - 1.
template <int R>
__device__ __forceinline__ void store_rows(float* out, const float (&a)[R],
                                           int c0, int c1, int C, int CO,
                                           int co0, int t4) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = i == 0 ? c0 : c1;
    if (c >= C) continue;
#pragma unroll
    for (int j = 0; j < R / 4; ++j) {
      const int co = co0 + 8 * j + 2 * t4;
      if (co < CO)
        *reinterpret_cast<float2*>(out + (size_t)c * CO + co) =
            make_float2(a[4 * j + 2 * i], a[4 * j + 2 * i + 1]);
    }
  }
}

template <int BN>
__global__ void __launch_bounds__(f32::kThreads, 1)
wgrad_tf32x3_kernel(const __grid_constant__ CUtensorMap tmx,
                    const __grid_constant__ CUtensorMap tmdy,
                    float* __restrict__ part, int depth, int C, int CO,
                    int KZ, int ci_tiles, int co_tiles, int tiles_w,
                    int tiles_per_plane, int n_tiles, int tiles_per_split) {
  using namespace f32;
  using CF = Cfg<BN>;
  constexpr int kSets = CF::kSets;
  constexpr int kDyT = CF::kDyT;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = align_1024(smem_raw);
  uint8_t* dyt = ring + kStages * CF::kStage;  // [buffer][hi, lo]
  float* tot = reinterpret_cast<float*>(dyt + kDyTBufs * 2 * kDyT);
  uint64_t* full = reinterpret_cast<uint64_t*>(
      reinterpret_cast<uint8_t*>(tot) + CF::kTot);
  uint64_t* empty = full + kStages;

  // split-major: the blocks of one split are neighbours
  const int per_split = KZ * ci_tiles * co_tiles;
  const int split = blockIdx.x / per_split;
  int item = blockIdx.x % per_split;
  const int co0 = (item % co_tiles) * BN;
  item /= co_tiles;
  const int ci0 = (item % ci_tiles) * kCi;
  const int kz = item / ci_tiles;
  const int dz = kz - KZ / 2;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(n_tiles, t_begin + tiles_per_split);
  // member blockIdx.y: its first plane and its partial sums
  const int p0 = blockIdx.y * (n_tiles / tiles_per_plane);
  part += (size_t)blockIdx.y * (gridDim.x / per_split) * KZ * 9 * C * CO;
  // the next tile at or after t whose x plane lies inside the group
  auto next_valid = [&](int t) {
    while (t < t_end) {
      const int d = (t / tiles_per_plane) % depth;
      if (d + dz >= 0 && d + dz < depth) break;
      t = (t / tiles_per_plane + 1) * tiles_per_plane;
    }
    return min(t, t_end);
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 1);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kWG) {  // the producer warp; one thread issues the loads
    if (threadIdx.x == kWG * 128) {
      int it = 0;
      for (int t = next_valid(t_begin); t < t_end; t = next_valid(t + 1)) {
        const int n = t / tiles_per_plane;
        const int tt = t % tiles_per_plane;
        const int h0 = (tt / tiles_w) * kTileH;
        const int w0 = (tt % tiles_w) * kTileW;
        const int s = it % kStages;
        if (it >= kStages) mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
        uint8_t* b = ring + s * CF::kStage;
        mbar_expect_tx(&full[s], kHaloTx + CF::kDy);
        tma_load_4d(b, &tmx, &full[s], ci0, w0 - 1, h0 - 1, p0 + n + dz);
#pragma unroll
        for (int j = 0; j < BN / 32; ++j)
          tma_load_4d(b + kHalo + j * kDyBox, &tmdy, &full[s], co0 + 32 * j,
                      w0, h0, p0 + n);
        ++it;
      }
    }
    return;
  }

  // consumer warpgroup wg: M tile wg, rows (tap 2 wg + warp / 2, channels
  // 8 (warp % 2) + f32_ci); tap 9 is padding (its fragments stay zero)
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int tap = 2 * wg + warp / 2;
  const bool live = tap < 9;
  const int ci = 8 * (warp % 2) + f32_ci(g);
  // this lane's fragment at k8 step 0: positions t4 and t4 + 4, channels
  // ci, ci + 1, in bytes from the halo's base; step k adds a constant
  const int abase = ((tap / 3) * kHaloW + tap % 3 + t4) * kRow + ci * 4;
  float* my_tot = tot + threadIdx.x;
  constexpr int kTotStride = kWG * 128;

  float acc[BN / 2];
#pragma unroll
  for (int q = 0; q < BN / 2; ++q) {
    acc[q] = 0.f;
    if constexpr (CF::kPromotes) my_tot[q * kTotStride] = 0.f;
  }
  fence_operands(acc);
  uint32_t fr[kSets][8];  // [set][hi 0-3, lo 4-7]
#pragma unroll
  for (int j = 0; j < kSets; ++j)
#pragma unroll
    for (int q = 0; q < 8; ++q) fr[j][q] = 0u;

  // dy [position][co] (boxes of 32 channels: 128-byte rows, 128-byte
  // swizzle) of stage `it` -> K-major hi / lo [k8 step][co][8 positions]
  // (32-byte rows, 32-byte swizzle) in buffer it % kDyTBufs; a warp takes
  // 8 positions x 4 channels a pass: lane (j8 = lane % 8, c4 = lane / 8),
  // both sides free of bank conflicts
  auto transpose = [&](int it) {
    const int s = it % kStages;
    mbar_wait(&full[s], (it / kStages) & 1);
    const uint8_t* dys = ring + s * CF::kStage + kHalo;
    uint8_t* bh = dyt + (it % kDyTBufs) * 2 * kDyT;
    uint8_t* bl = bh + kDyT;
    const int j8 = lane % 8, c4 = lane / 8;
    for (int u = threadIdx.x / 32; u < kGroups * (BN / 4); u += kWG * 4) {
      const int k = u / (BN / 4), cg = u % (BN / 4);
      const int p = 8 * k + j8, co = 4 * cg + c4;
      const float v = *reinterpret_cast<const float*>(
          dys + (cg / 8) * kDyBox + p * 128 + (((cg % 8) ^ j8) << 4) +
          c4 * 4);
      const uint32_t hi = round_tf32(v);
      int off = k * (BN * 32) + co * 32 + j8 * 4;
      off ^= ((off >> 7) & 1) << 4;
      *reinterpret_cast<uint32_t*>(bh + off) = hi;
      *reinterpret_cast<float*>(bl + off) = v - __uint_as_float(hi);
    }
    fence_proxy_async();  // read by wgmma (async proxy)
  };

  int t = next_valid(t_begin);
  if (t < t_end) transpose(0);
  consumers_sync();
  for (int it = 0; t < t_end; ++it) {
    const int t_next = next_valid(t + 1);
    const uint8_t* halo = ring + (it % kStages) * CF::kStage;
    const uint8_t* bh = dyt + (it % kDyTBufs) * 2 * kDyT;
    const uint64_t db_hi = smem_desc(bh, 16, 256, 32);
    const uint64_t db_lo = smem_desc(bh + kDyT, 16, 256, 32);
#pragma unroll
    for (int k = 0; k < kGroups; ++k) {
      uint32_t(&f)[8] = fr[k % kSets];
      if (live) {
        // k8 step k: positions (k / 2, 8 (k % 2) + t4) and 4 further
        const int koff = ((k / 2) * kHaloW + 8 * (k % 2)) * kRow;
        const float2 v0 =
            *reinterpret_cast<const float2*>(halo + abase + koff);
        const float2 v1 = *reinterpret_cast<const float2*>(
            halo + abase + koff + 4 * kRow);
        const float v[4] = {v0.x, v0.y, v1.x, v1.y};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const uint32_t hi = round_tf32(v[q]);
          f[q] = hi;
          // exact; the tensor core truncates it to tf32
          f[4 + q] = __float_as_uint(v[q] - __uint_as_float(hi));
        }
      }
      const uint32_t(&hi)[4] = *reinterpret_cast<uint32_t(*)[4]>(f);
      const uint32_t(&lo)[4] = *reinterpret_cast<uint32_t(*)[4]>(f + 4);
      wgmma_fence();
      // one k8 step of B is BN x 32 bytes (2 BN in 16-byte units)
      wgmma_m64k8_tf32<BN>(acc, lo, db_hi + 2 * BN * k);
      wgmma_m64k8_tf32<BN>(acc, hi, db_lo + 2 * BN * k);
      wgmma_m64k8_tf32<BN>(acc, hi, db_hi + 2 * BN * k);
      wgmma_commit();
      wgmma_wait<CF::kInFlight>();
      // the group kInFlight back has retired: its set is free
      fence_regs(fr[(k + kSets - CF::kInFlight) % kSets]);
      // the next stage's B, while this stage's groups run
      if (k == kGroups / 2 - 1 && t_next < t_end) transpose(it + 1);
    }
    if constexpr (CF::kPromotes) {
      if ((it + 1) % kPromote == 0) {
        wgmma_wait<0>();
        fence_operands(acc);
        promote(acc, my_tot, kTotStride);
        fence_operands(acc);
      }
    }
    // the next stage's B is published; every consumer is past this
    // stage's halo loads: give the stage back
    consumers_sync();
    if (threadIdx.x == 0) mbar_arrive(&empty[it % kStages]);
    t = t_next;
  }
  wgmma_wait<0>();
  fence_operands(acc);
#pragma unroll
  for (int j = 0; j < kSets; ++j) fence_regs(fr[j]);
  if (!live) return;
  if constexpr (CF::kPromotes) {
#pragma unroll
    for (int q = 0; q < BN / 2; ++q) acc[q] += my_tot[q * kTotStride];
  }
  store_rows(part + ((size_t)split * KZ * 9 + kz * 9 + tap) * C * CO, acc,
             ci0 + ci, ci0 + ci + 1, C, CO, co0, t4);
}


__global__ void __launch_bounds__(bf::kThreads, 1)
wgrad_bf16_zfirst_kernel(const __grid_constant__ CUtensorMap tmx,
                  const __grid_constant__ CUtensorMap tmdy,
                  float* __restrict__ part, int N, int depth, int C, int CO,
                  int KZ, int co_tiles, int tiles_w, int n_steps,
                  int steps_per_split) {
  using namespace bf;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* halos = align_1024(smem_raw);
  uint8_t* dys = halos + kHS * kHalo;
  float* tot = reinterpret_cast<float*>(dys + kDS * kDy);
  uint64_t* hfull = reinterpret_cast<uint64_t*>(
      reinterpret_cast<uint8_t*>(tot) + kTot);
  uint64_t* hempty = hfull + kHS;
  uint64_t* dfull = hempty + kHS;
  uint64_t* dempty = dfull + kDS;

  // split-major: the blocks of one split are neighbours
  const int per_split = ((C + kCi - 1) / kCi) * co_tiles;
  const int split = blockIdx.x / per_split;
  const int item = blockIdx.x % per_split;
  const int co0 = (item % co_tiles) * kBN;
  const int ci0 = (item / co_tiles) * kCi;
  // steps l = tile * N + plane, planes fastest
  const int l_begin = split * steps_per_split;
  const int l_end = min(n_steps, l_begin + steps_per_split);
  const int half = KZ / 2;
  // member blockIdx.y: its first plane and its partial sums
  const int p0 = blockIdx.y * N;
  part += (size_t)blockIdx.y * (gridDim.x / per_split) * KZ * 9 * C * CO;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kHS; ++s) {
      mbar_init(&hfull[s], 1);
      mbar_init(&hempty[s], kWG);
    }
    for (int s = 0; s < kDS; ++s) {
      mbar_init(&dfull[s], 1);
      mbar_init(&dempty[s], kWG);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kWG) {  // the producer warp; one thread issues the loads
    if (threadIdx.x == kWG * 128) {
      int hc = 0;  // halos loaded
      for (int l = l_begin; l < l_end; ++l) {
        const int tile = l / N, n = l % N;
        const int h0 = (tile / tiles_w) * kTileH;
        const int w0 = (tile % tiles_w) * kTileW;
        // a run's first step loads its KZ planes, a later step the newest
        const bool restart = l == l_begin || n == 0;
        for (int j = restart ? 0 : KZ - 1; j < KZ; ++j, ++hc) {
          const int s = hc % kHS;
          if (hc >= kHS) mbar_wait(&hempty[s], ((hc / kHS) & 1) ^ 1);
          mbar_expect_tx(&hfull[s], kHaloTx);
          tma_load_4d(halos + s * kHalo, &tmx, &hfull[s], ci0, w0 - 1,
                      h0 - 1, p0 + n - half + j);
        }
        const int i = l - l_begin, s = i % kDS;
        if (i >= kDS) mbar_wait(&dempty[s], ((i / kDS) & 1) ^ 1);
        mbar_expect_tx(&dfull[s], kDy);
        tma_load_4d(dys + s * kDy, &tmdy, &dfull[s], co0, w0, h0, p0 + n);
      }
    }
    return;
  }

  // consumer warpgroup wg: M tiles 2 wg + i; a warp's 16 rows are tap T =
  // 2 (2 wg + i) + warp / 2 of the KZ x 9, channels 16 (warp % 2) ..;
  // T >= 9 KZ is padding (zero fragments)
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  auto tap_of = [&](int i) { return 2 * (kTiles * wg + i) + warp / 2; };
  // ldmatrix: this lane addresses row lane % 8 (a position) of matrix m =
  // lane / 8 (positions 8 (m / 2) .., channels 8 (m % 2) .. of the warp's
  // 16), in bytes from the halo's base; k16 step k adds k x 18 rows.  The
  // tile's z-tap in bits 0-1 (3: padding), the offset above them.
  uint32_t tsel[kTiles];
#pragma unroll
  for (int i = 0; i < kTiles; ++i) {
    const int T = tap_of(i), tap = T % 9, m = lane / 8;
    const uint32_t off =
        ((tap / 3) * kHaloW + tap % 3 + 8 * (m / 2) + lane % 8) * kRow +
        (16 * (warp % 2) + 8 * (m % 2)) * 2;
    tsel[i] = (off << 2) | (T < 9 * KZ ? T / 9 : 3);
  }
  const uint32_t halo0 = smem_u32(halos);
  float* my_tot = tot + threadIdx.x;
  constexpr int kTotStride = kWG * 128;
  float acc[kTiles][kBN / 2];
#pragma unroll
  for (int i = 0; i < kTiles; ++i) {
#pragma unroll
    for (int q = 0; q < kBN / 2; ++q) {
      acc[i][q] = 0.f;
      my_tot[(i * (kBN / 2) + q) * kTotStride] = 0.f;
    }
    fence_operands(acc[i]);
  }
  // fragment sets: two alternating (one group in flight)
  uint32_t fr[2][4];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) fr[j][q] = 0u;

  int hc = 0;             // halos consumed (loaded) so far
  int hz[3] = {0, 0, 0};  // the halo count of planes n - half + kz
  for (int l = l_begin; l < l_end; ++l) {
    const int n = l % N, d = n % depth;
    const bool restart = l == l_begin || n == 0;
    // the previous step's halos this step no longer reads: all at a
    // restart (none at the first), else the oldest
    const int rel0 = hz[0];
    const int rel_n = restart ? (l == l_begin ? 0 : KZ) : 1;
    if (restart) {
      for (int j = 0; j < KZ; ++j, ++hc) {
        hz[j] = hc;
        mbar_wait(&hfull[hc % kHS], (hc / kHS) & 1);
      }
    } else {
      hz[0] = hz[1];
      hz[1] = hz[2];
      hz[KZ - 1] = hc;
      mbar_wait(&hfull[hc % kHS], (hc / kHS) & 1);
      ++hc;
    }
    const int i_step = l - l_begin;
    const int ds = i_step % kDS;
    mbar_wait(&dfull[ds], (i_step / kDS) & 1);
    // dy MN-major: 64-byte rows, a k16 step 16 of them (1024 bytes)
    const uint64_t db = smem_desc(dys + ds * kDy, kDy, 512, 64);
    // this step's fragment address of each tile, 0 if its tap reads no
    // plane of the group
    uint32_t ab[kTiles];
#pragma unroll
    for (int i = 0; i < kTiles; ++i) {
      const int z = tsel[i] & 3;
      const bool ok = z != 3 && d + z - half >= 0 && d + z - half < depth;
      ab[i] = ok ? halo0 + (hz[z == 3 ? 0 : z] % kHS) * kHalo + (tsel[i] >> 2)
                 : 0u;
    }
#pragma unroll
    for (int k = 0; k < kPos / 16; ++k) {
#pragma unroll
      for (int i = 0; i < kTiles; ++i) {
        // k16 step k: positions (k, 0 .. 15), halo rows from k + ky on
        uint32_t(&f)[4] = fr[(k * kTiles + i) & 1];
        if (ab[i] != 0u) {
          ldmatrix_x4_trans(f, ab[i] + k * kHaloW * kRow);
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q) f[q] = 0u;
        }
        wgmma_fence();
        wgmma_m64k16_rs<kBN, 1>(acc[i], f, db + 64 * k);
        wgmma_commit();
        wgmma_wait<1>();
        // the previous group's set is free
        fence_regs(fr[(k * kTiles + i + 1) & 1]);
        if (k == 0 && i == 0 && l > l_begin && threadIdx.x % 128 == 0) {
          // the previous step's groups have retired: its dy box and the
          // halos this step does not read go back
          mbar_arrive(&dempty[(i_step - 1) % kDS]);
          for (int j = 0; j < rel_n; ++j)
            mbar_arrive(&hempty[(rel0 + j) % kHS]);
        }
      }
    }
    if ((i_step + 1) % kPromote == 0) {
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < kTiles; ++i) {
        fence_operands(acc[i]);
        promote(acc[i], my_tot + i * (kBN / 2) * kTotStride, kTotStride);
        fence_operands(acc[i]);
      }
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int j = 0; j < 2; ++j) fence_regs(fr[j]);
  const int g = lane / 4, t4 = lane % 4;
#pragma unroll
  for (int i = 0; i < kTiles; ++i) {
    fence_operands(acc[i]);
    const int T = tap_of(i);
    if (T >= 9 * KZ) continue;
#pragma unroll
    for (int q = 0; q < kBN / 2; ++q)
      acc[i][q] += my_tot[(i * (kBN / 2) + q) * kTotStride];
    const int c = ci0 + 16 * (warp % 2) + g;
    store_rows(part + ((size_t)split * KZ * 9 + T) * C * CO, acc[i], c,
               c + 8, C, CO, co0, t4);
  }
}


// bf16 with C > 32: the first bf16 design, M = 64 input channels of one
// tap a wgmma, both operands MN-major by descriptor (A: the halo at the
// tap's shift; B: dy), three warpgroups (one per ky) of three accumulators
// (kx), one z-tap a block, numbered split-major as the other kernels.  At
// C >= 64 its M is full, it loads no fragments, and each wgmma group holds
// 12 products; it measured faster there than the z-first kernel.  Its
// splits keep a block's sum within 288 tiles (18432 positions), where the
// truncating accumulation stays within the tolerance without promotion.
template <int BN>
__global__ void __launch_bounds__(bd::kThreads, 1)
wgrad_bf16_desc_kernel(const __grid_constant__ CUtensorMap tmx,
                       const __grid_constant__ CUtensorMap tmdy,
                       float* __restrict__ part, int depth, int C, int CO,
                       int KZ, int ci_tiles, int co_tiles, int tiles_w,
                       int tiles_per_plane, int n_tiles,
                       int tiles_per_split) {
  using namespace bd;
  using CF = Cfg<BN>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sx = align_1024(smem_raw);
  uint8_t* sd = sx + kStages * kHalo;
  uint64_t* full = reinterpret_cast<uint64_t*>(sd + kStages * CF::kDy);
  uint64_t* empty = full + kStages;

  // split-major: the blocks of one split are neighbours
  const int per_split = KZ * ci_tiles * co_tiles;
  const int split = blockIdx.x / per_split;
  int item = blockIdx.x % per_split;
  const int co0 = (item % co_tiles) * BN;
  item /= co_tiles;
  const int ci0 = (item % ci_tiles) * kCiTile;
  const int kz = item / ci_tiles;
  const int dz = kz - KZ / 2;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(n_tiles, t_begin + tiles_per_split);
  // member blockIdx.y: its first plane and its partial sums
  const int p0 = blockIdx.y * (n_tiles / tiles_per_plane);
  part += (size_t)blockIdx.y * (gridDim.x / per_split) * KZ * 9 * C * CO;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kWG);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kWG) {  // the producer warp; one thread issues the loads
    if (threadIdx.x == kWG * 128) {
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
        mbar_expect_tx(&full[s], kHaloTx + CF::kDy);
        tma_load_4d(sx + s * kHalo, &tmx, &full[s], ci0, w0 - 1, h0 - 1,
                    p0 + n + dz);
        tma_load_4d(sd + s * CF::kDy, &tmdy, &full[s], co0, w0, h0, p0 + n);
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
      // dy rows 16 r .. 16 r + 15, aligned to the swizzle atom; tap (ky,
      // kx) reads the 16 halo rows from (r + ky) * 18 + kx on (the swizzle
      // is a function of the address: any start row works)
      const uint64_t db = smem_desc(sd + s * CF::kDy + r * 16 * BN * 2,
                                    CF::kDy, 8 * BN * 2, BN * 2);
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        const uint8_t* xa = sx + s * kHalo + ((r + wg) * kHaloW + kx) * kRow;
        wgmma_m64k16<BN, 1, 1>(acc[kx],
                               smem_desc(xa, kHalo, 8 * kRow, kRow), db);
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
    float* out =
        part + ((size_t)split * KZ * 9 + kz * 9 + wg * 3 + kx) * C * CO;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int ci = ci0 + row0 + 8 * i;
      if (ci >= C) continue;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int co = co0 + 8 * j + 2 * (lane % 4);
        if (co < CO)
          *reinterpret_cast<float2*>(out + (size_t)ci * CO + co) =
              make_float2(acc[kx][4 * j + 2 * i], acc[kx][4 * j + 2 * i + 1]);
      }
    }
  }
}

// dw[member][j] = the sum over k in order of part[member][k][j], for the
// `members` x m entries of dw.
__global__ void sum_splits_kernel(const float* __restrict__ part,
                                  float* __restrict__ dw, long long m,
                                  long long total, int splits) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const float* p = part + (i / m) * splits * m + i % m;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += p[(size_t)k * m];
  dw[i] = s;
}

// The tensor maps: x as halo boxes of `box_c` channels (dense, padded rows,
// or with their span's swizzle where `x_swizzled`), dy as boxes of `bn`
// channels with their span's swizzle.
bool make_maps(CUtensorMap* tmx, CUtensorMap* tmdy, const void* x,
               const void* dy, long long N, int H, int W, int C, int CO,
               CUtensorMapDataType type, int e, int box_c, int bn,
               bool x_swizzled) {
  const cuuint64_t xd[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H,
                            (cuuint64_t)N};
  const cuuint64_t xs[3] = {(cuuint64_t)C * e, (cuuint64_t)W * C * e,
                            (cuuint64_t)H * W * C * e};
  const cuuint32_t xb[4] = {(cuuint32_t)box_c, kHaloW, kHaloH, 1};
  const cuuint64_t dd[4] = {(cuuint64_t)CO, (cuuint64_t)W, (cuuint64_t)H,
                            (cuuint64_t)N};
  const cuuint64_t ds[3] = {(cuuint64_t)CO * e, (cuuint64_t)W * CO * e,
                            (cuuint64_t)H * W * CO * e};
  const cuuint32_t db[4] = {(cuuint32_t)bn, kTileW, kTileH, 1};
  return make_map(tmx, x, 4, xd, xs, xb, type, e, x_swizzled) &&
         make_map(tmdy, dy, 4, dd, ds, db, type, e);
}

template <typename K>
cudaError_t allow_smem(K kernel, int smem, bool& configured) {
  if (configured) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  configured = e == cudaSuccess;
  return e;
}

template <int BN>
int launch_f32(const void* x, const void* dy, float* part, int N,
               int members, int depth, int H, int W, int C, int CO, int KZ,
               int splits, cudaStream_t stream) {
  using CF = f32::Cfg<BN>;
  CUtensorMap tmx, tmdy;
  if (!make_maps(&tmx, &tmdy, x, dy, (long long)N * members, H, W, C, CO,
                 CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, f32::kRow / 4, 32,
                 false))
    return static_cast<int>(cudaErrorInvalidValue);
  static bool configured = false;
  const cudaError_t e =
      allow_smem(wgrad_tf32x3_kernel<BN>, CF::kSmem, configured);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles_w = (W + kTileW - 1) / kTileW;
  const int tiles_per_plane = ((H + kTileH - 1) / kTileH) * tiles_w;
  const int n_tiles = N * tiles_per_plane;
  const int tiles_per_split = (n_tiles + splits - 1) / splits;
  const int ci_tiles = (C + kCi - 1) / kCi;
  const int co_tiles = (CO + BN - 1) / BN;
  const long long blocks = (long long)splits * KZ * ci_tiles * co_tiles;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  wgrad_tf32x3_kernel<BN><<<dim3((unsigned)blocks, members), f32::kThreads,
                            CF::kSmem, stream>>>(tmx, tmdy, part, depth, C, CO, KZ,
                                      ci_tiles, co_tiles, tiles_w,
                                      tiles_per_plane, n_tiles,
                                      tiles_per_split);
  return static_cast<int>(cudaGetLastError());
}


int launch_bf16_zfirst(const void* x, const void* dy, float* part, int N,
                       int members, int depth, int H, int W, int C, int CO,
                       int KZ, int splits, cudaStream_t stream) {
  CUtensorMap tmx, tmdy;
  if (!make_maps(&tmx, &tmdy, x, dy, (long long)N * members, H, W, C, CO,
                 CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, bf::kRow / 2, kBN,
                 false))
    return static_cast<int>(cudaErrorInvalidValue);
  static bool configured = false;
  const cudaError_t e =
      allow_smem(wgrad_bf16_zfirst_kernel, bf::kSmem, configured);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles_w = (W + kTileW - 1) / kTileW;
  const int n_steps = N * ((H + kTileH - 1) / kTileH) * tiles_w;
  const int steps_per_split = (n_steps + splits - 1) / splits;
  const int co_tiles = (CO + kBN - 1) / kBN;
  const long long blocks =
      (long long)splits * ((C + kCi - 1) / kCi) * co_tiles;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  wgrad_bf16_zfirst_kernel<<<dim3((unsigned)blocks, members), bf::kThreads,
                             bf::kSmem, stream>>>(tmx, tmdy, part, N, depth, C, CO, KZ,
                                       co_tiles, tiles_w, n_steps,
                                       steps_per_split);
  return static_cast<int>(cudaGetLastError());
}

template <int BN>
int launch_bf16_desc(const void* x, const void* dy, float* part, int N,
                     int members, int depth, int H, int W, int C, int CO,
                     int KZ, int splits, cudaStream_t stream) {
  using CF = bd::Cfg<BN>;
  CUtensorMap tmx, tmdy;
  if (!make_maps(&tmx, &tmdy, x, dy, (long long)N * members, H, W, C, CO,
                 CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, bd::kCiTile, BN, true))
    return static_cast<int>(cudaErrorInvalidValue);
  static bool configured = false;
  const cudaError_t e =
      allow_smem(wgrad_bf16_desc_kernel<BN>, CF::kSmem, configured);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles_w = (W + kTileW - 1) / kTileW;
  const int tiles_per_plane = ((H + kTileH - 1) / kTileH) * tiles_w;
  const int n_tiles = N * tiles_per_plane;
  const int tiles_per_split = (n_tiles + splits - 1) / splits;
  const int ci_tiles = (C + bd::kCiTile - 1) / bd::kCiTile;
  const int co_tiles = (CO + BN - 1) / BN;
  const long long blocks = (long long)splits * KZ * ci_tiles * co_tiles;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  wgrad_bf16_desc_kernel<BN><<<dim3((unsigned)blocks, members),
                               bd::kThreads, CF::kSmem, stream>>>(
      tmx, tmdy, part, depth, C, CO, KZ, ci_tiles, co_tiles, tiles_w,
      tiles_per_plane, n_tiles, tiles_per_split);
  return static_cast<int>(cudaGetLastError());
}

bool misaligned(const void* p) {
  return reinterpret_cast<uintptr_t>(p) & 15;
}

}  // namespace

// x (N, H, W, C) and dy (N, H, W, CO) NHWC, contiguous and 16-byte
// aligned, CO % 8 == 0; planes [m * N / members, (m + 1) * N / members)
// belong to member m (N / members a multiple of depth); dw (members, KZ, 3,
// 3, C, CO) f32, dw[m] the gradient of member m's weights; scratch holds
// members * splits * KZ*9*C*CO f32 (unused when splits == 1).  The splits
// are those of one member's N / members planes.  `kernel`, as
// kernels/conv3x3.py::wgrad_kernel names it: 0 f32, 32 output channels a
// block; 1 f32, 64; 2 bf16 z-first; 3 bf16 by descriptor, 32; 4 the same,
// 64 (f32 needs C % 8 == 0, bf16 C % 16 == 0).  The blocks are splits x
// items, items = KZ x ci tiles x co tiles (the z-first kernel: ci tiles x
// co tiles); a split is a run of position tiles (planes slowest; the
// z-first kernel: planes fastest), as wgrad_plan says.  Returns
// cudaGetLastError() after the launches (cudaErrorInvalidValue for
// arguments the kernels do not take or a tensor map that
// cuTensorMapEncodeTiled refuses).
extern "C" int dgtta_conv3x3_wgrad_wgmma(const void* x, const void* dy,
                                         void* dw, void* scratch, int N,
                                         int members, int depth, int H,
                                         int W, int C, int CO, int KZ,
                                         int splits, int kernel,
                                         void* stream) {
  if (N <= 0 || members <= 0 || members > 65535 || N % members != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  N /= members;  // one member's planes
  if (N <= 0 || depth <= 0 || N % depth != 0 || H <= 0 || W <= 0 || C <= 0 ||
      kernel < 0 || kernel > 4 || C % (kernel < 2 ? 8 : 16) != 0 ||
      CO <= 0 || CO % 8 != 0 || (KZ != 1 && KZ != 3) || splits <= 0 ||
      (splits > 1 && scratch == nullptr) ||
      (long long)N * ((H + kTileH - 1) / kTileH) *
              ((W + kTileW - 1) / kTileW) > 2147483647LL ||
      misaligned(x) || misaligned(dy) || misaligned(dw))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = splits == 1 ? static_cast<float*>(dw)
                            : static_cast<float*>(scratch);
  int (*const launch[5])(const void*, const void*, float*, int, int, int,
                         int, int, int, int, int, int, cudaStream_t) = {
      launch_f32<32>, launch_f32<64>, launch_bf16_zfirst,
      launch_bf16_desc<32>, launch_bf16_desc<64>};
  const int err =
      launch[kernel](x, dy, part, N, members, depth, H, W, C, CO, KZ, splits,
                     s);
  if (err != 0) return err;
  if (splits > 1) {
    const long long m = (long long)KZ * 9 * C * CO, total = m * members;
    const int threads = 256;
    sum_splits_kernel<<<(unsigned)((total + threads - 1) / threads), threads,
                        0, s>>>(part, static_cast<float*>(dw), m, total,
                                splits);
  }
  return static_cast<int>(cudaGetLastError());
}
