// 3x3 stride-1 pad-1 convolution on NHWC planes, with an optional sum over
// three z-neighbour planes, on Hopper's tensor cores (sm_90a): wgmma fed by
// TMA, in two instantiations of one kernel:
//   * bf16 operands (C % 16 == 0, CO % 8 == 0), bf16 output;
//   * f32 operands (C % 8 == 0, CO % 8 == 0), f32 output, as 3xTF32: every
//     product at f32 accuracy from three tf32 products (below).
//
// Replaces dg_tta_tpu/ops/conv2d_pallas.py::conv3x3_pallas (and with KZ=3 the
// three z-tap calls of it that dg_tta_tpu/models/unet.py::_conv sums) for
// those shapes; conv3x3_c1.cu takes the 1-channel first conv, conv3x3_few.cu
// 1 < C < 16 and conv3x3.cu the other channel counts.  The same function as
// conv3x3.cu:
//
//   y[n,h,w,co] = sum_{kz<KZ} sum_{ky,kx<3} sum_{ci<C}
//                   x[n+kz-KZ/2, h+ky-1, w+kx-1, ci] * w[kz,ky,kx,ci,co]
//
// zero-padded in H and W and within the plane's group of `depth` planes,
// f32 accumulation.  The weights come as w[kz,ky,kx,ci,co].  bf16 reads
// them as they are (an MN-major B operand: co contiguous).  tf32 wgmma
// takes 32-bit operands K-major only, so for f32 a first launch
// (`weights_kernel`, one pass over a few MB) writes them transposed into
// scratch, wt[kz,ky,kx,co,ci], split into a tf32 part and its remainder.
// (A PyTorch transpose and split per call take up to ~40 us at the deep
// levels, whose weights are MBs: more than the conv there.)
//
// What bounds it on an H100: 2*27*C*CO operations per output voxel against
// (C + CO) elements of device-memory traffic, hundreds of operations per
// byte: the tensor cores.  bf16 runs at 989 TFLOP/s.  f32 has no
// tensor-core type of its own, and TF32 alone keeps ~3 decimal digits, so
// the f32 route splits each operand v into hi = tf32(v) and lo = v - hi
// and sums a_hi*b_hi + a_hi*b_lo + a_lo*b_hi (dropping a_lo*b_lo, ~2^-22 of
// the product): three tf32 products at 495 TFLOP/s, so its bound is
// 3 * ops / 495e12 s.  What held the first design (an 8 x 16 pixel tile,
// one TMA box of x per tap) far below that was the L2: every tap reloaded
// a shifted box of x and every 128 pixels the weights, 67.5 bytes of L2 per
// output in bf16 and 162 in f32 at the top level (112 x 128 planes, C = CO
// = 32), 5-7 TB/s at its measured times.
//
// The design.  An implicit GEMM: M = a tile of output pixels of one plane n,
// N = BN output channels, K = (kz, channel chunk of KC, ky, kx).
//   * The halo.  Per (kz, chunk) one TMA box brings x[n+dz, h0-1 : +TH+2,
//     w0-1 : +TW+2, ci0 : +KC] (TMA's out-of-bounds zero fill is the H/W
//     padding) and one box the nine taps' weights for the block's BN
//     columns (f32: wt and wt_lo): a stage of the ring.  Every (ky, kx) tap
//     reads the halo at a shift of ky * (TW + 2) + kx pixel rows.  A row of
//     KC channels is 64 bytes (KC = 32 bf16, 16 f32), 32 where C is no
//     multiple of that; one wgmma step eats 32 bytes of K in either type
//     (k16 bf16, k8 tf32).
//   * A through registers.  An m64 tile spans several tile rows, each a
//     shift away from the last by TW + 2 halo rows, which no wgmma
//     descriptor (one stride between 8-row groups) expresses; so each warp
//     loads its fragment with one ldmatrix.x4 per k step, in either type
//     (for f32 a 16-byte row of an 8 x 8 b16 matrix is 4 floats, and the
//     lane gets word l % 4 of row l / 4: the tf32 fragment).  The swizzle
//     (16-byte chunk ^= bits 7.. of the offset) is computed from the
//     stage's 1024-byte base: the halo row pitch, 18 x 64 bytes, is no
//     multiple of 1024.  f32 splits the fragment in registers: hi by an
//     integer rounding (round_tf32: ptxas expands cvt.rna.tf32 into ~5
//     instructions, twelve of them per value on the consumers' critical
//     path), lo = a - hi unrounded (the tensor core truncates it to
//     tf32).
//   * Enough M.  Layout "big": a 16 x 16 tile (M = 256), two consumer
//     warpgroups of two m64 tiles each (tile rows 8g .. 8g + 7), the
//     block's BN = WN columns (32 for CO <= 32, else 64).  Layout "small",
//     for planes of at most 8 x 8 (the 7 x 8 level): one 8 x 8 tile (one m64
//     tile, 56 of its 64 rows used there) that both warpgroups share, each
//     taking WN = 32 of the block's 64 columns.  L2 bytes per output at the
//     top level, interior planes (an item: 3 kz x chunks stages of halo and
//     weights): bf16 C = CO = 32 from 67.5 to 14.3 (276,480 bytes per 128 x
//     32 outputs -> 117,504 per 256 x 32), of which A from 54.0 to 7.6; f32
//     from 162.0 to 42.2 (663,552 -> 345,600), A from 108.0 to 15.2.  The
//     weights are now most of it (f32: hi and lo).
//   * Persistent blocks.  With one split (below) a block per SM walks the
//     work items (plane, tile, column tile; columns innermost, so that
//     neighbouring blocks share a halo in L2) with one ring: the producer
//     loads the next item's stages while the consumers finish and store
//     this one.  The producer is a warpgroup of which one thread issues the
//     loads; it gives its registers to the consumers (setmaxnreg).  A stage
//     goes back to it when the consumers' wgmma group of its last tap has
//     retired.
//   * The small levels.  Where the items are fewer than the 132 SMs, a
//     cluster of `splits` (2-4) blocks shares each item, each block a
//     contiguous run of its stages; the blocks leave their f32 partial sums
//     in shared memory and rank 0 adds them in rank order through
//     distributed shared memory and stores: deterministic, no atomics, one
//     launch.  The host's plan (`kernels/conv3x3.py::wgmma_plan`) picks the
//     layout, WN, KC, the splits and the blocks.  The splits follow from
//     one volume's items (a window's launch), never from the batch, so
//     that a plane's sums, and a grouped run's losses, do not depend on how
//     many volumes share the launch: the most splits that keep that
//     launch in one wave of clusters (one more where that wave leaves over
//     a quarter of the SMs idle).  So a window at the 14 x 16 level
//     launches 112 blocks (56 items x 2) and at 7 x 8 105 (35 x 3), not
//     132: a second, part-full wave of clusters costs more on an H100
//     (`obs/conv_times.py --splits` times every split count; PERF.md, PR
//     15).
//   * The z-taps whose plane lies outside the group are skipped by the
//     whole block (the item's stage list leaves them out; TMA cannot: that
//     plane exists in memory and belongs to the next volume).  The epilogue
//     skips rows past H and W and columns past CO.
//   * Groups.  Each wgmma group is a tap (K = KC, both m64 tiles), or for
//     f32 at WN = 64 one k8 step (its accumulators take the registers);
//     the ((lo, B_hi), (hi, B_lo), (hi, B_hi)) products of f32 and the m64
//     tiles alternate.  A stage's groups are unrolled, and a group's
//     fragments load while the previous group runs, into the next of three
//     register sets (a multiple of three groups per stage keeps the
//     rotation across stages): loading into the set a running group reads
//     makes ptxas serialize the wgmmas (C7513).
//   * f32 accuracy: the tensor cores add each step's products into the f32
//     accumulator with truncation, not rounding; over K = 27 x 512 that
//     drifts to ~1e-4 of the output's range, above the route's 5e-5.  So
//     every kPromote stages (432 K at KC = 16) the consumers drain their
//     wgmmas, add the accumulator into a second f32 register tile (rounded
//     adds) and restart it from zero.
//   * Members.  An ensemble chunk's members run side by side in one launch:
//     x holds `members` groups of `planes` planes each (a member's batch,
//     a multiple of `depth`), w their weights, member after member.  Plane
//     n belongs to member n / planes, whose nine-tap weight boxes are taps
//     (member * KZ + kz) * 9 .. of the weights' map; an item is one plane,
//     so it never straddles two members, and a member's planes get the
//     bits of a launch of that member alone.

#include <cuda_bf16.h>
#include <stddef.h>

#include "hopper.cuh"

namespace {

using namespace dgtta;

constexpr int kConsumers = 2;  // warpgroups, and one producer warpgroup
constexpr int kThreads = (kConsumers + 1) * 128;
// registers per thread: the producer gives its own to the consumers
// (setmaxnreg; 128 x 40 + 256 x 232 <= 65536)
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr int kMaxStages = 4;
constexpr int kRingBudget = 200 * 1024;  // shared-memory bytes of the ring
constexpr int kPromote = 3;  // f32: stages between accumulator promotions
constexpr int kMaxSplits = 4;

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

// L = 0, "big": a 16 x 16 tile, warpgroup g on m64 tiles 2g and 2g + 1;
// L = 1, "small": an 8 x 8 tile, both warpgroups on its one m64 tile,
// warpgroup g on columns g * WN .. of the block's 2 * WN.
template <typename T, int L, int WN, int SPAN>
struct Cfg {
  static constexpr bool kTf32 = sizeof(T) == 4;  // f32 as 3xTF32
  static constexpr int TH = L == 0 ? 16 : 8, TW = TH;
  static constexpr int MT = L == 0 ? 2 : 1;   // m64 tiles per warpgroup
  static constexpr int NW = L == 0 ? 1 : 2;   // warpgroups along N
  static constexpr int BN = NW * WN;          // columns per block
  static constexpr int HW = TW + 2;           // halo pixels per row
  static constexpr int KC = SPAN / sizeof(T);
  static constexpr int kHaloTx = (TH + 2) * HW * SPAN;
  static constexpr int kHalo = (kHaloTx + 1023) / 1024 * 1024;
  // one tap's weights: bf16 MN-major, KC rows of the BN channels (read
  // from w as it is, BN * 2-byte rows with that swizzle); f32 K-major, BN
  // rows of KC channels (from the first launch's wt, SPAN-byte rows)
  static constexpr int kTapB = BN * SPAN;
  static constexpr int kBRow = kTf32 ? SPAN : BN * 2;
  static constexpr int kBBytes = 9 * kTapB;
  static constexpr int kBOps = kTf32 ? 2 : 1;  // f32: wt_hi, wt_lo
  static constexpr int kStage = kHalo + kBOps * kBBytes;
  static constexpr int kStages =
      kRingBudget / kStage < kMaxStages ? kRingBudget / kStage : kMaxStages;
  static constexpr int kSteps = SPAN / 32;    // wgmma K steps per tap
  // wgmma K steps per group: a tap, but one k8 step for f32 at WN = 64
  // (its fragments, hi and lo, are twice the registers, its accumulators
  // four times)
  static constexpr int kGroupSteps = kTf32 && WN == 64 ? 1 : kSteps;
  static constexpr int kGroups = 9 * kSteps / kGroupSteps;  // per stage
  static constexpr int kAcc = MT * WN / 2;    // accumulators per thread
  static constexpr int kSmem = 1024 + kStages * kStage + 2 * kStages * 8;
  static_assert(kStages >= 2, "a ring needs two stages");
  static_assert(kTapB % 1024 == 0, "a tap's weights on the swizzle grid");
  static_assert(kConsumers * 128 * kAcc * 4 <= kStages * kStage,
                "the partial sums fit in the ring");
};

__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a,
                                           float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// The SPAN-byte swizzle of byte `off` of a buffer on the 1024-byte grid.
template <int SPAN>
__device__ __forceinline__ int swz(int off) {
  return off ^ (((off >> 7) & (SPAN / 16 - 1)) << 4);
}

// One work item: the plane, the tile's origin, the first column, and this
// block's run [s0, s1) of the item's stages (kz from kz_lo, chunk-major).
struct Item {
  int n, h0, w0, co0, kz_lo, s0, s1;
};

template <typename T, int L, int WN, int SPAN>
__global__ void __launch_bounds__(kThreads, 1)
conv3x3_wgmma_kernel(const __grid_constant__ CUtensorMap tmx,
                     const __grid_constant__ CUtensorMap tmw,
                     const __grid_constant__ CUtensorMap tmw_lo,
                     T* __restrict__ y, int depth, int planes, int H,
                     int W, int C, int CO, int KZ, int tiles_h, int tiles_w,
                     int co_tiles, int n_items, int splits) {
  using CF = Cfg<T, L, WN, SPAN>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = align_1024(smem_raw);
  uint64_t* full =
      reinterpret_cast<uint64_t*>(ring + CF::kStages * CF::kStage);
  uint64_t* empty = full + CF::kStages;

  const int rank = blockIdx.x % splits;  // = the cluster rank
  const int first = blockIdx.x / splits, stride = gridDim.x / splits;
  const int nch = C / CF::KC;
  auto item_at = [&](int item) {
    Item it;
    it.co0 = (item % co_tiles) * CF::BN;
    int r = item / co_tiles;
    it.w0 = (r % tiles_w) * CF::TW;
    r /= tiles_w;
    it.h0 = (r % tiles_h) * CF::TH;
    it.n = r / tiles_h;
    // z-taps whose plane lies inside the group (uniform over the block)
    const int d = it.n % depth;
    it.kz_lo = (KZ == 3 && d == 0) ? 1 : 0;
    const int kz_hi = (KZ == 3 && d == depth - 1) ? 1 : KZ - 1;
    const int total = (kz_hi - it.kz_lo + 1) * nch;
    it.s0 = rank * total / splits;
    it.s1 = (rank + 1) * total / splits;
    return it;
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < CF::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {  // the producer; one thread issues the loads
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        kProducerRegs));
    if (threadIdx.x == kConsumers * 128) {
      int sc = 0;  // stages loaded so far (the ring's position)
      for (int item = first; item < n_items; item += stride) {
        const Item it = item_at(item);
        for (int s = it.s0; s < it.s1; ++s, ++sc) {
          const int slot = sc % CF::kStages;
          if (sc >= CF::kStages)
            mbar_wait(&empty[slot], ((sc / CF::kStages) & 1) ^ 1);
          const int kz = it.kz_lo + s / nch, ch = s % nch;
          // the member's nine taps of this kz
          const int tap0 = ((it.n / planes) * KZ + kz) * 9;
          uint8_t* st = ring + slot * CF::kStage;
          mbar_expect_tx(&full[slot],
                         CF::kHaloTx + CF::kBOps * CF::kBBytes);
          tma_load_4d(st, &tmx, &full[slot], ch * CF::KC, it.w0 - 1,
                      it.h0 - 1, it.n + kz - KZ / 2);
          if constexpr (CF::kTf32) {  // wt and wt_lo, K-major
            tma_load_3d(st + CF::kHalo, &tmw, &full[slot], ch * CF::KC,
                        it.co0, tap0);
            tma_load_3d(st + CF::kHalo + CF::kBBytes, &tmw_lo, &full[slot],
                        ch * CF::KC, it.co0, tap0);
          } else {  // w, MN-major
            tma_load_3d(st + CF::kHalo, &tmw, &full[slot], it.co0,
                        ch * CF::KC, tap0);
          }
        }
      }
    }
    __syncwarp();
    if (splits > 1) {  // the consumers' two cluster barriers
      cluster_sync();
      cluster_sync();
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
  const int n_off = CF::NW == 2 ? wg * WN : 0;     // this warpgroup's columns
  const int m_first = CF::NW == 2 ? 0 : wg * CF::MT;  // its first m64 tile
  // Every A fragment (a k16 step of bf16, a k8 step of f32: the warp's 16
  // rows x 32 bytes) is one ldmatrix.x4: lane l addresses row l % 8 + 8 *
  // ((l / 8) & 1) of the warp's 16, bytes 16 * (l / 16) of the step.  For
  // f32 a 16-byte row of an 8 x 8 b16 matrix is 4 floats, and lane l
  // receives word l % 4 of row l / 4: the tf32 fragment's layout.  abase:
  // the byte offset of this lane's row at tap (0, 0), per m64 tile (a tap
  // adds (ky * (TW + 2) + kx) rows).
  int abase[CF::MT];
#pragma unroll
  for (int mt = 0; mt < CF::MT; ++mt) {
    const int p = 64 * (m_first + mt) + 16 * warp + lane % 8 +
                  8 * ((lane / 8) & 1);
    abase[mt] =
        ((p / CF::TW) * CF::HW + p % CF::TW) * SPAN + 16 * (lane / 16);
  }

  // groups per stage (a multiple of 3) and per tap; three fragment sets, so
  // that group j loads set j % 3 while group j - 1 runs, across stages too
  constexpr int G = CF::kGroups, kPerTap = CF::kSteps / CF::kGroupSteps;
  static_assert(G % 3 == 0, "fragment sets rotate by stage");
  // [set][m64 tile][k step of the group][bf16: register; f32: hi, lo]
  uint32_t fr[3][CF::MT][CF::kGroupSteps][CF::kTf32 ? 8 : 4];
  float acc[CF::MT][WN / 2];
  float tot[CF::kTf32 ? CF::MT : 1][WN / 2];
  // f32: drains the wgmmas and adds the accumulators into tot (rounded)
  auto promote = [&]() {
    wgmma_wait<0>();
#pragma unroll
    for (int mt = 0; mt < CF::MT; ++mt) {
      fence_operands(acc[mt]);
#pragma unroll
      for (int i = 0; i < WN / 2; ++i) {
        tot[mt][i] += acc[mt][i];
        acc[mt][i] = 0.f;
      }
      fence_operands(acc[mt]);
    }
  };
  int sc = 0;  // stages consumed so far
  for (int item = first; item < n_items; item += stride) {
    const Item it = item_at(item);
    const int stages = it.s1 - it.s0;
#pragma unroll
    for (int mt = 0; mt < CF::MT; ++mt) {
#pragma unroll
      for (int i = 0; i < WN / 2; ++i) acc[mt][i] = 0.f;
      fence_operands(acc[mt]);
    }
    if constexpr (CF::kTf32) {
#pragma unroll
      for (int mt = 0; mt < CF::MT; ++mt)
#pragma unroll
        for (int i = 0; i < WN / 2; ++i) tot[mt][i] = 0.f;
    }

    for (int s = 0; s < stages; ++s) {
      const int slot = (sc + s) % CF::kStages;
      mbar_wait(&full[slot], ((sc + s) / CF::kStages) & 1);
      const uint8_t* st = ring + slot * CF::kStage;
      // this warpgroup's columns of the stage's weights
      const uint64_t db0 =
          smem_desc(st + CF::kHalo + n_off * (CF::kTf32 ? SPAN : 2),
                    CF::kTapB, 8 * CF::kBRow, CF::kBRow);
#pragma unroll
      for (int j = 0; j < G; ++j) {
        const int tap = j / kPerTap, k0 = (j % kPerTap) * CF::kGroupSteps;
        const int shift = ((tap / 3) * CF::HW + tap % 3) * SPAN;
        auto& f = fr[j % 3];
        // the weights of the tap, k0 steps in (16-byte units; a k16 step
        // of MN-major bf16 is 16 rows)
        const uint64_t db = db0 + ((tap * CF::kTapB + 32 * k0) >> 4);
        if constexpr (!CF::kTf32) {
#pragma unroll
          for (int mt = 0; mt < CF::MT; ++mt)
#pragma unroll
            for (int k = 0; k < CF::kSteps; ++k)
              ldmatrix_x4(*reinterpret_cast<uint32_t(*)[4]>(f[mt][k]),
                          st + swz<SPAN>(abase[mt] + shift + 32 * k));
          wgmma_fence();  // m64 tiles alternate: independent accumulators
#pragma unroll
          for (int k = 0; k < CF::kSteps; ++k)
#pragma unroll
            for (int mt = 0; mt < CF::MT; ++mt)
              wgmma_m64k16_rs<WN, 1>(
                  acc[mt], *reinterpret_cast<uint32_t(*)[4]>(f[mt][k]),
                  db + CF::kBRow * k);
        } else {
          // 3xTF32: hi = tf32(a) (nearest), lo = a - hi
#pragma unroll
          for (int mt = 0; mt < CF::MT; ++mt)
#pragma unroll
            for (int k = 0; k < CF::kGroupSteps; ++k) {
              uint32_t a[4];
              ldmatrix_x4(
                  a, st + swz<SPAN>(abase[mt] + shift + 32 * (k0 + k)));
#pragma unroll
              for (int q = 0; q < 4; ++q) {
                const float v = __uint_as_float(a[q]);
                const uint32_t hi = round_tf32(v);
                f[mt][k][q] = hi;
                // exact; the tensor core truncates it to tf32
                f[mt][k][4 + q] = __float_as_uint(v - __uint_as_float(hi));
              }
            }
          const uint64_t db_lo = db + (CF::kBBytes >> 4);
          wgmma_fence();
          // (lo, B_hi), (hi, B_lo), (hi, B_hi), the m64 tiles alternating
#pragma unroll
          for (int k = 0; k < CF::kGroupSteps; ++k)
#pragma unroll
            for (int p = 0; p < 3; ++p)
#pragma unroll
              for (int mt = 0; mt < CF::MT; ++mt) {
                const uint32_t(&a)[4] = *reinterpret_cast<uint32_t(*)[4]>(
                    f[mt][k] + (p == 0 ? 4 : 0));
                wgmma_m64k8_tf32<WN>(acc[mt], a,
                                     (p == 1 ? db_lo : db) + 2 * k);
              }
        }
        wgmma_commit();
        // group j - 1 has retired: the last group of the previous stage
        // gives that stage back
        wgmma_wait<1>();
        if (j == 0 && s > 0 && threadIdx.x % 128 == 0)
          mbar_arrive(&empty[(sc + s - 1) % CF::kStages]);
      }
      if constexpr (CF::kTf32)
        if ((s + 1) % kPromote == 0) promote();
    }
    // the item's sums, into acc[0 .. MT)
    if constexpr (CF::kTf32) {
      promote();
#pragma unroll
      for (int mt = 0; mt < CF::MT; ++mt)
#pragma unroll
        for (int i = 0; i < WN / 2; ++i) acc[mt][i] = tot[mt][i];
    } else {
      wgmma_wait<0>();
#pragma unroll
      for (int mt = 0; mt < CF::MT; ++mt) fence_operands(acc[mt]);
    }
    if (stages > 0 && threadIdx.x % 128 == 0)
      mbar_arrive(&empty[(sc + stages - 1) % CF::kStages]);
    sc += stages;

    if (splits > 1) {
      // one item per cluster (the plan's grid): the ring is idle now.  Each
      // block leaves its partial sums there, thread-major; rank 0 adds the
      // others' in rank order and stores.
      float* part = reinterpret_cast<float*>(ring);
      const int t = threadIdx.x;  // 0 .. 255
      asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers * 128) : "memory");
      if (rank != 0) {
#pragma unroll
        for (int mt = 0; mt < CF::MT; ++mt)
#pragma unroll
          for (int i = 0; i < WN / 2; ++i)
            part[(mt * (WN / 2) + i) * (kConsumers * 128) + t] = acc[mt][i];
      }
      cluster_sync();
      if (rank == 0) {
        for (int r = 1; r < splits; ++r)
#pragma unroll
          for (int mt = 0; mt < CF::MT; ++mt)
#pragma unroll
            for (int i = 0; i < WN / 2; ++i)
              acc[mt][i] += ld_cluster_f32(
                  &part[(mt * (WN / 2) + i) * (kConsumers * 128) + t], r);
      }
      cluster_sync();
      if (rank != 0) continue;
    }

    // the epilogue: rows past H and W and columns past CO are skipped
#pragma unroll
    for (int mt = 0; mt < CF::MT; ++mt) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int p = 64 * (m_first + mt) + 16 * warp + lane / 4 + 8 * i;
        const int h = it.h0 + p / CF::TW, w = it.w0 + p % CF::TW;
        if (h >= H || w >= W) continue;
        T* yp = y + (((size_t)it.n * H + h) * W + w) * CO;
#pragma unroll
        for (int j = 0; j < WN / 8; ++j) {
          const int co = it.co0 + n_off + 8 * j + 2 * (lane % 4);
          if (co < CO)
            store_pair(yp + co, acc[mt][4 * j + 2 * i],
                       acc[mt][4 * j + 2 * i + 1]);
        }
      }
    }
  }
}

template <typename T, int L, int WN, int SPAN>
int launch(const void* x, const void* w, const void* wt_lo, void* y, int N,
           int members, int depth, int H, int W, int C, int CO, int KZ,
           int splits, int blocks, cudaStream_t stream) {
  using CF = Cfg<T, L, WN, SPAN>;
  constexpr CUtensorMapDataType kType = Elem<T>::kMap;
  constexpr int e = sizeof(T);
  int tiles_h = (H + CF::TH - 1) / CF::TH;
  int tiles_w = (W + CF::TW - 1) / CF::TW;
  int co_tiles = (CO + CF::BN - 1) / CF::BN;
  const long long items = (long long)N * tiles_h * tiles_w * co_tiles;
  // one split: persistent blocks, at most one per item; several: a cluster
  // per item (the partial sums reuse the ring)
  if (items * splits > 0x7fffffff ||
      (splits == 1 ? blocks > items : blocks != items * splits))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tmx, tmw, tmw_lo;
  const cuuint64_t xd[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H,
                            (cuuint64_t)N};
  const cuuint64_t xs[3] = {(cuuint64_t)C * e, (cuuint64_t)W * C * e,
                            (cuuint64_t)H * W * C * e};
  const cuuint32_t xb[4] = {CF::KC, CF::HW, CF::TH + 2, 1};
  // the weights, nine taps a box: f32 wt (members * KZ * 9, CO, C) K-major
  // and its wt_lo; bf16 w itself (members * KZ * 9, C, CO), MN-major
  const cuuint64_t d0 = CF::kTf32 ? C : CO, d1 = CF::kTf32 ? CO : C;
  const cuuint64_t wd[3] = {d0, d1, (cuuint64_t)members * KZ * 9};
  const cuuint64_t ws[2] = {d0 * e, (cuuint64_t)CO * C * e};
  const cuuint32_t wb[3] = {(cuuint32_t)(CF::kTf32 ? CF::KC : CF::BN),
                            (cuuint32_t)(CF::kTf32 ? CF::BN : CF::KC), 9};
  if (!make_map(&tmx, x, 4, xd, xs, xb, kType, e) ||
      !make_map(&tmw, w, 3, wd, ws, wb, kType, e) ||
      !make_map(&tmw_lo, CF::kTf32 ? wt_lo : w, 3, wd, ws, wb, kType, e))
    return static_cast<int>(cudaErrorInvalidValue);
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        conv3x3_wgmma_kernel<T, L, WN, SPAN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, CF::kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = CF::kSmem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = splits > 1 ? 1 : 0;
  T* yp = static_cast<T*>(y);
  int n_items = static_cast<int>(items);
  int planes = N / members;
  void* args[] = {&tmx,     &tmw,     &tmw_lo,  &yp,       &depth,
                  &planes,  &H,       &W,       &C,        &CO,
                  &KZ,      &tiles_h, &tiles_w, &co_tiles, &n_items,
                  &splits};
  const cudaError_t err = cudaLaunchKernelExC(
      &cfg, reinterpret_cast<const void*>(conv3x3_wgmma_kernel<T, L, WN, SPAN>),
      args);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int SPAN>
int launch_layout(const void* x, const void* w, const void* wt_lo, void* y,
                  int N, int members, int depth, int H, int W, int C, int CO,
                  int KZ, int layout, int wn, int splits, int blocks,
                  cudaStream_t s) {
  if (layout == 1)
    return launch<T, 1, 32, SPAN>(x, w, wt_lo, y, N, members, depth, H, W, C,
                                  CO, KZ, splits, blocks, s);
  if (wn == 32)
    return launch<T, 0, 32, SPAN>(x, w, wt_lo, y, N, members, depth, H, W, C,
                                  CO, KZ, splits, blocks, s);
  return launch<T, 0, 64, SPAN>(x, w, wt_lo, y, N, members, depth, H, W, C,
                                CO, KZ, splits, blocks, s);
}

// f32: the weights as the GEMM reads them, written before the conv: w
// (taps, C, CO) -> wt (taps, CO, C), every member's taps, K-major (tf32 wgmma takes no MN-major
// operand), split into wt = tf32(w) (nearest, ties away, as the
// activations) and wt_lo = w - wt, exact.  A 32 x 32 (ci, co) tile per
// block through shared memory: reads coalesced along co, writes along ci.
// One pass over a few MB, in place of a PyTorch transpose and three
// elementwise passes.
__global__ void __launch_bounds__(256)
weights_kernel(const float* __restrict__ w, float* __restrict__ wt,
               float* __restrict__ wt_lo, int C, int CO) {
  __shared__ float t[32][33];
  const int c0 = blockIdx.y * 32, co0 = blockIdx.x * 32;
  const size_t tap = blockIdx.z;
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int c = c0 + i, co = co0 + threadIdx.x;
    t[i][threadIdx.x] = c < C && co < CO ? w[(tap * C + c) * CO + co] : 0.f;
  }
  __syncthreads();
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int co = co0 + i, c = c0 + threadIdx.x;
    if (co >= CO || c >= C) continue;
    const float v = t[threadIdx.x][i];
    const float hi = __uint_as_float(round_tf32(v));
    const size_t o = (tap * CO + co) * C + c;
    wt[o] = hi;
    wt_lo[o] = __fsub_rn(v, hi);
  }
}

int prepare_weights(const void* w, void* wt, void* wt_lo, int C, int CO,
                    int taps, cudaStream_t s) {
  const dim3 grid((CO + 31) / 32, (C + 31) / 32, taps);
  weights_kernel<<<grid, dim3(32, 8), 0, s>>>(
      static_cast<const float*>(w), static_cast<float*>(wt),
      static_cast<float*>(wt_lo), C, CO);
  return static_cast<int>(cudaGetLastError());
}

bool misaligned(const void* p) {
  return reinterpret_cast<uintptr_t>(p) & 15;
}

}  // namespace

// x (N, H, W, C) and y (N, H, W, CO) NHWC, w (members, KZ, 3, 3, C, CO),
// all contiguous, x, y and bf16's w 16-byte aligned, of one type: dtype 1 =
// bf16 with C % 16 == 0, dtype 0 = f32 with C % 8 == 0; CO % 8 == 0.
// Planes [m * N / members, (m + 1) * N / members) belong to member m and
// take its weights; N / members is a multiple of depth.  wt and wt_lo
// (members, KZ, 3, 3, CO, C), 16-byte aligned, are f32's scratch, which a
// first launch fills with the weights as the GEMM reads them
// (`weights_kernel`); bf16 reads w itself (wt and wt_lo unused, may be
// null).  The plan
// (`kernels/conv3x3.py::wgmma_plan`): layout 0 ("big", 16 x 16 pixels, wn
// = 32 or 64 columns) or 1 ("small", 8 x 8 pixels, wn = 32 columns per
// warpgroup, 64 per block); kc channels per stage, 64 or 32 bytes of them,
// dividing C; splits 1-4 blocks per work item (a cluster); blocks: with
// one split at most the items (persistent blocks), else items x splits.
// Returns cudaGetLastError() after the launches (cudaErrorInvalidValue
// for arguments the kernel does not take or a tensor map that
// cuTensorMapEncodeTiled refuses).
extern "C" int dgtta_conv3x3_wgmma(const void* x, const void* w, void* wt,
                                   void* wt_lo, void* y, int N, int members,
                                   int depth, int H, int W, int C, int CO,
                                   int KZ, int dtype, int layout, int wn,
                                   int kc, int splits, int blocks,
                                   void* stream) {
  const bool f32 = dtype == 0;
  const int span = kc * (f32 ? 4 : 2);
  if (N <= 0 || members <= 0 || N % members != 0 || depth <= 0 ||
      (N / members) % depth != 0 || H <= 0 || W <= 0 || C <= 0 ||
      members * KZ * 9 > 65535 ||
      C % (f32 ? 8 : 16) != 0 || CO <= 0 || CO % 8 != 0 ||
      (KZ != 1 && KZ != 3) || (dtype != 0 && dtype != 1) ||
      misaligned(x) || misaligned(y) || (!f32 && misaligned(w)) ||
      (f32 && (wt == nullptr || wt_lo == nullptr || misaligned(wt) ||
               misaligned(wt_lo))) ||
      (layout != 0 && layout != 1) || (wn != 32 && wn != 64) ||
      (layout == 1 && wn != 32) || (span != 32 && span != 64) ||
      C % kc != 0 || splits < 1 || splits > kMaxSplits || blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f32) {
    const int err =
        prepare_weights(w, wt, wt_lo, C, CO, members * KZ * 9, s);
    if (err != 0) return err;
    if (span == 64)
      return launch_layout<float, 64>(x, wt, wt_lo, y, N, members, depth, H,
                                      W, C, CO, KZ, layout, wn, splits,
                                      blocks, s);
    return launch_layout<float, 32>(x, wt, wt_lo, y, N, members, depth, H, W,
                                    C, CO, KZ, layout, wn, splits, blocks, s);
  }
  using bf16 = __nv_bfloat16;
  if (span == 64)
    return launch_layout<bf16, 64>(x, w, nullptr, y, N, members, depth, H, W,
                                   C, CO, KZ, layout, wn, splits, blocks, s);
  return launch_layout<bf16, 32>(x, w, nullptr, y, N, members, depth, H, W, C,
                                 CO, KZ, layout, wn, splits, blocks, s);
}
