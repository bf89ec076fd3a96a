// Trilinear and nearest resampling of channels-first flat volumes, for sm_90a.
//
// Replaces dg_tta_tpu/ops/experimental/warp_pallas_staged.py::
// grid_sample_flat_pallas (reached through ops/warp_pallas.py::warp_flat_auto)
// and computes the function of dg_tta_tpu/core/grid.py::grid_sample_flat:
//
//   out[b, c, o] = sum over the 8 (trilinear) or 1 (nearest) corners k of
//                  weight_k(o) * src[b, c, lin_k(o)]
//
// where the corners surround the point (gx, gy, gz)[b, o], a normalized xyz
// coordinate unnormalized with torch's align_corners convention against the
// source shape (D, H, W); lin = (z * H + y) * W + x.  Padding "zeros" drops
// the corners outside the source (weight 0); "border" clamps each corner
// index to the edge.  Nearest rounds half to even (rintf, as jnp.round).
// Source and output shapes may differ; no shape limits (the TPU kernel's
// W == 128, endomorphic and bounded-window limits do not apply).  src and
// out are f32 or bf16, the grid f32, the sum f32.
//
// Two forward entries.  dgtta_warp takes the grid as three f32 arrays (any
// map: grid_sample, a deformable plan's fields and warps).
// dgtta_warp_affine takes the 12 numbers of an affine theta per batch entry
// and builds each point in the kernel with the operations of
// core/grid.py::affine_grid, so it reads no grid, and its output is bit for
// bit that of dgtta_warp on affine_grid(theta); every warp of an affine
// plan's adaptation takes it.  It also takes an optional per-batch factor
// (the adjoint's 1 / |det|), applied in the store.
//
// What bounds it on an H100: bytes by count (per output voxel 8 corners per
// channel read, three f32 coordinates through the grid entry, one value per
// channel written, ~20 flops per channel), but instructions in practice:
// the exact arithmetic of a point (rounded, unfused operations), its
// corners (clamps, conversions, in-range tests) and its weights take ~100
// instructions per output, and each channel 8 gathers.  Timing variants of
// the one-thread-per-output kernel that the grid entry still is (stores
// alone; points and weights without gathers; gathers at coalesced
// addresses) put a C = 1 warp's time in its arithmetic (the affine entry
// spent most of it on three true divisions an output) and a C = 4 warp's in
// its 32 gathers an output (PERF.md §6 has the numbers).
//
// What the design does about it:
// * The affine entry's unit of work is a 3D brick of outputs, 32 x (a
//   warp's lanes) by 8 y by KBZ z (8 for C <= 2, 4 above: the host's
//   plan, kernels/warp.py::warp_plan); thread (warp w, lane l) takes x = l,
//   y = w at each of the KBZ rows, so a point costs three rounded
//   additions per axis: theta[i][0] * x_n and theta[i][1] * y_n once per
//   thread, theta[i][2] * z_n of row j in lane j and shuffled, from base
//   coordinates the host computes (as affine_grid's: no division in the
//   kernel); the operations and their order are those of affine_grid.
// * The TTA draws are near the identity, so a brick reads a compact source
//   box about twice its outputs.  The box is the exact range of the
//   brick's clamped corner indices, from two vertices per axis (each corner
//   index is a composition of monotone rounded operations, so monotone in
//   each output index and extreme at a vertex), found by every warp with a
//   shuffle and no barrier.  The box, every channel of it, is staged in
//   shared memory by 16-byte cp.async (rows widened to 16-byte chunks where
//   W allows, else element by element), and the corners are gathered from
//   there with 32-bit byte offsets: the same voxels, so the sums are bit
//   for bit those of a gather from device memory.  A brick whose box does
//   not fit the block's buffer (stage_bytes: a strong warp) is gathered
//   from device memory by the same kernel; an optional device counter
//   records each brick's path (counts[0] staged, counts[1] global).
// * A block holds one brick and little state (the buffer, registers for
//   one output row at a time), so four blocks share an SM and one block's
//   copy hides behind the others' gathers.  (A block that kept a brick's
//   per-output state across its barriers, or a persistent block that
//   double-buffered its bricks, ran at two blocks an SM and was slower than
//   the one-thread-per-output kernel.)
// * The grid entry keeps one output a thread in runs of 256 (staging its
//   box needs a pass over the grid and a barrier before the copy, and cost
//   more than it saved; 32 x 8 tiles were slower too), with the leaner
//   corner arithmetic of the affine entry and, from C = 4 on, a register
//   budget of four blocks an SM, so that a thread keeps more of its 8 C
//   gathers in flight.
// * One set of offsets and weights serves every channel.  The coordinate
//   unnormalization uses round-to-nearest intrinsics, which the compiler
//   never fuses into an FMA, so the corner choice (floor, and the rounding
//   of exact .5 ties in nearest mode) is bit-for-bit that of the plain
//   version; each corner is added by fmaf in the order k = 0..7.
//
// A third entry, dgtta_warp_adjoint, is the exact adjoint of the grid entry's
// trilinear warp: the gradient of sum(out * g) with respect to src,
//
//   dx[b, c, lin_k(o)] += weight_k(o) * g[b, c, o]
//
// over the 8 corners of every output o, the weights and corners of the
// forward kernel (zeros padding drops the outside corners; border padding
// adds their weight to the clamped edge voxel).  It is what the JAX package's
// autodiff of its gather computes, a scatter-add; the TTA engine runs it for
// DGTTA_EXACT_WARP_GRAD.  One thread per output voxel computes its corners
// and weights once, then loops over the channels, reading g[b, c, o]
// (coalesced across the warp) and adding eight products into an f32 buffer
// with atomicAdd.  What bounds it: the atomics; the TTA warps are near the
// identity, so the 32 threads of a warp add into a few neighbouring cache
// lines per corner, which L2 serves.  The sum's order varies from run to
// run, so its result does too, in the last bits of f32.  A bf16 result is
// the f32 buffer cast by one pass (the wrapper's).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // the adjoint's block

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// core/grid.py::_unnormalize, in the same operation order, unfused.
__device__ __forceinline__ float unnormalize(float c, int size, bool align) {
  if (align)
    return __fmul_rn(__fmul_rn(__fadd_rn(c, 1.0f), 0.5f),
                     static_cast<float>(size - 1));
  return __fmul_rn(
      __fsub_rn(__fmul_rn(__fadd_rn(c, 1.0f), static_cast<float>(size)),
                1.0f),
      0.5f);
}

// An integer corner index from a float that may be far out of range: the
// clamp keeps the conversion defined and changes no in-range index, no
// out-of-range verdict and no border clamp.
__device__ __forceinline__ int to_index(float v, int size) {
  return static_cast<int>(fminf(fmaxf(v, -2.0f), static_cast<float>(size) + 1.0f));
}

// The index clamped to the volume; *inside turns false when it had to move.
__device__ __forceinline__ int corner(int i, int size, bool* inside) {
  if (i < 0 || i >= size) {
    *inside = false;
    return i < 0 ? 0 : size - 1;
  }
  return i;
}

// v rounded to T, then times scale rounded to T, rounded to T: the value of
// `warp_flat(...) * scale.to(T)` in PyTorch (which multiplies two T values in
// f32 and rounds once).
template <typename T>
__device__ __forceinline__ T scaled(float v, float scale) {
  return from_f32<T>(__fmul_rn(to_f32(from_f32<T>(v)),
                               to_f32(from_f32<T>(scale))));
}

__device__ __forceinline__ void cp_async16(unsigned dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

// An element of shared memory at byte address addr, as f32.
__device__ __forceinline__ float lds(unsigned addr, float) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr));
  return v;
}
__device__ __forceinline__ float lds(unsigned addr, __nv_bfloat16) {
  unsigned short v;
  asm volatile("ld.shared.b16 %0, [%1];\n" : "=h"(v) : "r"(addr));
  return __bfloat162float(__ushort_as_bfloat16(v));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The brick of outputs, a block's unit of work: kBX consecutive x (a warp's
// lanes) by kBY y by KBZ z (a template parameter: the host's choice);
// thread (warp w, lane l) takes x = l, y = w of the brick at each of its
// KBZ rows z = j.
constexpr int kBX = 32;
constexpr int kBY = 8;
constexpr int kBrickThreads = 256;
constexpr int kWarps = kBrickThreads / 32;
static_assert(kBY == kWarps, "warp w takes the brick's row y = w");

struct Args {
  const void* src;    // (B, C, D*H*W)
  void* out;          // (B, C, Do*Ho*Wo)
  const float* gx;    // grid entry: (B, Do*Ho*Wo) each
  const float* gy;
  const float* gz;
  const float* theta;  // affine entry: 12 per batch entry, or one for all
  const float* scale;  // affine entry: null, or a factor per batch entry
  const float* base;   // affine entry: x_n (Wo), y_n (Ho), z_n (Do)
  unsigned long long* counts;  // null, or bricks staged / global
  int theta_stride, scale_stride, align;
  int B, C, D, H, W, Do, Ho, Wo;
  int nbx, nby, nbz;   // affine entry: bricks along x, y and z
  int stage_bytes;     // affine entry: the block's box buffer
};

// One axis of an output's point u (unnormalized) against a source of n
// voxels (nm1 = n - 1 as a float): the corner indices clamped into the
// volume (trilinear: floor(u) and floor(u) + 1; nearest: u rounded half to
// even, both) and, trilinear, the interpolation factors 1 - t and t (t =
// u - floor(u)), each zeroed where its index lies outside the volume unless
// BORDER; nearest: w[0] is 1, or 0 outside the volume unless BORDER.  The
// same verdicts and indices as `corner(to_index(...))` on every float,
// NaN and infinities included, in floating-point operations.
template <bool NEAREST, bool BORDER>
struct Axis {
  int i[2];
  float w[2];
  __device__ __forceinline__ Axis(float u, float nm1) {
    const float f = NEAREST ? rintf(u) : floorf(u);
    i[0] = static_cast<int>(fminf(fmaxf(f, 0.0f), nm1));
    if constexpr (NEAREST) {
      i[1] = i[0];
      w[0] = w[1] = (BORDER || (f >= 0.0f && f <= nm1)) ? 1.0f : 0.0f;
    } else {
      i[1] = static_cast<int>(fminf(fmaxf(f + 1.0f, 0.0f), nm1));
      const float t = u - f;
      w[0] = 1.0f - t;
      w[1] = t;
      if constexpr (!BORDER) {
        if (!(f >= 0.0f && f <= nm1)) w[0] = 0.0f;
        if (!(f >= -1.0f && f <= nm1 - 1.0f)) w[1] = 0.0f;
      }
    }
  }
};

// One output's gathers and stores for its C channels.  Staged: base is the
// byte address of channel 0's box in shared memory, channel c at base +
// c * cstride bytes, and a corner's offset counts bytes; else base points at
// channel 0 in device memory, channel c at base + c * cstride elements.
// ax, ay, az are the output's axes, whose indices (minus org, times 1, sy,
// sz) sum to a corner's offset; dst is the output of channel 0.  Weights as
// core/grid.py: (z factor) * (y factor) * (x factor), each rounded; a factor
// zeroed for an outside index zeroes the weight, as the plain version's
// mask does (the factors are finite and nonnegative wherever they are not
// zeroed).
template <typename T, bool NEAREST, bool BORDER, bool STAGED>
__device__ __forceinline__ void gather_store(
    const T* base, unsigned sbase, size_t cstride, int C,
    const Axis<NEAREST, BORDER>& ax, const Axis<NEAREST, BORDER>& ay,
    const Axis<NEAREST, BORDER>& az, const int (&org)[3], int sy, int sz,
    T* dst, size_t n_out, const float* scale, float sc) {
  constexpr int E = STAGED ? static_cast<int>(sizeof(T)) : 1;  // units
  const int ox[2] = {(ax.i[0] - org[0]) * E, (ax.i[1] - org[0]) * E};
  int ozy[4];
  float wzy[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    ozy[q] = (az.i[q >> 1] - org[2]) * sz + (ay.i[q & 1] - org[1]) * sy;
    wzy[q] = __fmul_rn(az.w[q >> 1], ay.w[q & 1]);
  }
  auto load = [&](int c, int off) {
    if constexpr (STAGED)
      return lds(sbase + static_cast<unsigned>(c * cstride + off), T());
    else
      return to_f32(__ldg(base + c * cstride + off));
  };
  if constexpr (NEAREST) {
    const int off = ozy[0] + ox[0];
    const bool keep = __fmul_rn(wzy[0], ax.w[0]) != 0.0f;
    for (int c = 0; c < C; ++c) {
      const float v = keep ? load(c, off) : 0.0f;
      dst[c * n_out] = scale == nullptr ? from_f32<T>(v) : scaled<T>(v, sc);
    }
  } else {
    float w[8];
    int off[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      w[k] = __fmul_rn(wzy[k >> 1], ax.w[k & 1]);
      off[k] = ozy[k >> 1] + ox[k & 1];
    }
    for (int c = 0; c < C; ++c) {
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < 8; ++k) acc = fmaf(w[k], load(c, off[k]), acc);
      dst[c * n_out] = scale == nullptr ? from_f32<T>(acc)
                                        : scaled<T>(acc, sc);
    }
  }
}

// A brick: its batch entry and its first output along each axis.
struct Brick {
  int b, x, y, z;
};

// The block's brick: blockIdx = (x brick, y brick, z brick + nbz * b).
template <int KBZ>
__device__ __forceinline__ Brick block_brick(const Args& a) {
  const int b = static_cast<int>(blockIdx.z) / a.nbz;
  return {b, static_cast<int>(blockIdx.x) * kBX,
          static_cast<int>(blockIdx.y) * kBY,
          (static_cast<int>(blockIdx.z) - b * a.nbz) * KBZ};
}

// Where a brick's box lives in shared memory: rows of sx elements from x =
// xs (widened to 16-byte chunks where W and src allow: vec), ey rows a
// plane, ez planes a channel; staged when all C channels fit the buffer.
struct Box {
  int lo[3], xs, sx, ey, ez;
  bool vec, staged;
};

template <typename T>
__device__ __forceinline__ Box box_layout(const Args& a, const int* lohi) {
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  Box box;
  box.lo[0] = lohi[0];
  box.lo[1] = lohi[1];
  box.lo[2] = lohi[2];
  box.vec = a.W % V == 0 && (reinterpret_cast<uintptr_t>(a.src) & 15u) == 0;
  box.xs = box.vec ? lohi[0] & ~(V - 1) : lohi[0];
  box.sx = box.vec ? (lohi[3] + V - box.xs) & ~(V - 1)
                   : lohi[3] + 1 - box.xs;
  box.ey = lohi[4] + 1 - lohi[1];
  box.ez = lohi[5] + 1 - lohi[2];
  box.staged = static_cast<long long>(box.sx) * box.ey * box.ez * a.C *
                   static_cast<long long>(sizeof(T)) <=
               a.stage_bytes;
  return box;
}

constexpr int kFlat = 256;

// The grid entry's kernel: one output a thread, kFlat consecutive outputs a
// block, gathered from device memory (no box: a grid's box needs a pass
// over its points and a barrier before its copy, which cost more than the
// staged gathers saved at the grid entry's sites; 32 x 8 tiles instead of
// flat runs were slower too).  Two instantiations differ in their register
// budget only: `warp_grid_kernel` leaves it to the compiler, which keeps
// few registers and many threads (faster for C < 4); `_wide` holds four
// blocks an SM and lets a thread keep more loads in flight (faster for
// C >= 4).
template <typename T, bool NEAREST, bool BORDER>
__device__ __forceinline__ void grid_body(const Args& a) {
  using A = Axis<NEAREST, BORDER>;
  const size_t n_out = static_cast<size_t>(a.Do) * a.Ho * a.Wo;
  const size_t o = static_cast<size_t>(blockIdx.x) * kFlat + threadIdx.x;
  const int b = blockIdx.y;
  if (threadIdx.x == 0 && a.counts != nullptr) atomicAdd(a.counts + 1, 1ull);
  if (o >= n_out) return;
  const int D = a.D, H = a.H, W = a.W, C = a.C;
  const size_t n_src = static_cast<size_t>(D) * H * W, gi = b * n_out + o;
  const A ax(unnormalize(__ldg(a.gx + gi), W, a.align),
             static_cast<float>(W - 1)),
      ay(unnormalize(__ldg(a.gy + gi), H, a.align),
         static_cast<float>(H - 1)),
      az(unnormalize(__ldg(a.gz + gi), D, a.align),
         static_cast<float>(D - 1));
  const int org[3] = {0, 0, 0};
  gather_store<T, NEAREST, BORDER, false>(
      static_cast<const T*>(a.src) + b * C * n_src, 0, n_src, C, ax, ay, az,
      org, W, H * W, static_cast<T*>(a.out) + b * C * n_out + o, n_out,
      nullptr, 1.0f);
}

template <typename T, bool NEAREST, bool BORDER>
__global__ void __launch_bounds__(kFlat) warp_grid_kernel(const Args a) {
  grid_body<T, NEAREST, BORDER>(a);
}

template <typename T, bool NEAREST, bool BORDER>
__global__ void __launch_bounds__(kFlat, 4)
warp_grid_kernel_wide(const Args a) {
  grid_body<T, NEAREST, BORDER>(a);
}

// The affine entry's kernel: one block per brick of KBZ rows.  The rounded
// products theta[i][0] * x_n, theta[i][1] * y_n and theta[i][2] * z_n
// come from the base coordinates in `a.base` (computed on the host as
// affine_grid computes them: no division in the kernel).  (A) The brick's
// box of clamped corners: every warp computes it from two vertices per
// axis and a shuffle (each corner index is a composition of monotone
// rounded operations, so monotone in each output index and extreme at a
// vertex), with no barrier.  (B) The box, every channel, copied into
// shared memory by 16-byte cp.async, if it fits a.stage_bytes.  (C) Each
// thread's outputs, row by row: point, corners, weights, then every
// channel gathered (from the staged box or from device memory) and
// stored.
template <typename T, bool NEAREST, bool BORDER, int KBZ>
__global__ void __launch_bounds__(kBrickThreads, 4)
warp_brick_kernel(const Args a) {
  static_assert(KBZ >= 1 && KBZ <= 32, "lane j holds row j's z product");
  using A = Axis<NEAREST, BORDER>;
  extern __shared__ __align__(16) unsigned char s_raw[];
  T* const s_box = reinterpret_cast<T*>(s_raw);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int D = a.D, H = a.H, W = a.W, C = a.C;
  const float wm1 = static_cast<float>(W - 1), hm1 = static_cast<float>(H - 1),
              dm1 = static_cast<float>(D - 1);
  const size_t n_src = static_cast<size_t>(D) * H * W;
  const size_t n_out = static_cast<size_t>(a.Do) * a.Ho * a.Wo;
  const Brick k = block_brick<KBZ>(a);
  const int ox = k.x + lane, oy = k.y + warp;  // row j: z = k.z + j
  const T* const src_b =
      static_cast<const T*>(a.src) + static_cast<size_t>(k.b) * C * n_src;

  Box box = {};
  unsigned s_base = 0;
  float px[3], py[3], pz[3], t3[3], sc = 1.0f;
  {
    // theta[i][0] * x_n, theta[i][1] * y_n (the warp's row) and theta[i][3]
    // per thread, theta[i][2] * z_n of row j in lane j
    const float* th = a.theta + k.b * a.theta_stride;
    const float* const xb = a.base;  // x_n, then y_n, then z_n
    const float* const yb = a.base + a.Wo;
    const float* const zb = a.base + a.Wo + a.Ho;
    const float xn = __ldg(xb + min(ox, a.Wo - 1)),
                yn = __ldg(yb + min(oy, a.Ho - 1)),
                zn = __ldg(zb + min(k.z + lane % KBZ, a.Do - 1));
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      px[i] = __fmul_rn(__ldg(th + 4 * i), xn);
      py[i] = __fmul_rn(__ldg(th + 4 * i + 1), yn);
      pz[i] = __fmul_rn(__ldg(th + 4 * i + 2), zn);
      t3[i] = __ldg(th + 4 * i + 3);
    }
    if (a.scale != nullptr) sc = __ldg(a.scale + k.b * a.scale_stride);

    // (A) lane 2 r + e: the lowest (e = 0) or highest (e = 1) corner index
    // along axis r, at the vertex where row r of theta is least or greatest
    // (the first or the last index along each output axis, by the sign of
    // its coefficient)
    int lohi[6];
    {
      const int r = min(lane >> 1, 2), e = lane & 1;
      const float* t = th + 4 * r;
      const float t0 = __ldg(t), t1 = __ldg(t + 1), t2 = __ldg(t + 2);
      const int xv = (t0 < 0.0f) != (e == 1) ? min(k.x + kBX, a.Wo) - 1 : k.x;
      const int yv = (t1 < 0.0f) != (e == 1) ? min(k.y + kBY, a.Ho) - 1 : k.y;
      const int zv = (t2 < 0.0f) != (e == 1) ? min(k.z + KBZ, a.Do) - 1 : k.z;
      const int n = r == 0 ? W : r == 1 ? H : D;
      // affine_grid's order: ((t0 x + t1 y) + t2 z) + t3
      const float g = __fadd_rn(
          __fadd_rn(__fadd_rn(__fmul_rn(t0, __ldg(xb + xv)),
                              __fmul_rn(t1, __ldg(yb + yv))),
                    __fmul_rn(t2, __ldg(zb + zv))),
          __ldg(t + 3));
      const A v(unnormalize(g, n, false), static_cast<float>(n - 1));
      const int end = e ? v.i[1] : v.i[0];
#pragma unroll
      for (int i = 0; i < 6; ++i)
        lohi[i] = __shfl_sync(0xffffffffu, end, 2 * (i % 3) + i / 3);
    }
    box = box_layout<T>(a, lohi);

    // (B) the box into shared memory, if it fits
    s_base = static_cast<unsigned>(__cvta_generic_to_shared(s_box));
    if (box.staged) {
      const int step = box.vec ? 16 / static_cast<int>(sizeof(T)) : 1;
      const int nq = box.sx / step, plane = box.sx * box.ey;
      const size_t hw = static_cast<size_t>(H) * W;
      const T* const src = src_b + static_cast<size_t>(box.lo[2]) * hw +
                           static_cast<size_t>(box.lo[1]) * W + box.xs;
      for (int i = tid; i < box.ey * nq; i += kBrickThreads) {
        const int y = i / nq, q = i - y * nq;
        const T* g = src + static_cast<size_t>(y) * W + q * step;
        int s = y * box.sx + q * step;  // elements
        for (int c = 0; c < C; ++c, g += n_src - box.ez * hw)
          for (int z = 0; z < box.ez; ++z, g += hw, s += plane) {
            if (box.vec)
              cp_async16(s_base + s * static_cast<int>(sizeof(T)), g);
            else
              s_box[s] = __ldg(g);
          }
      }
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
    }
  }
  if (tid == 0 && a.counts != nullptr)
    atomicAdd(a.counts + (box.staged ? 0 : 1), 1ull);

  // (C) the thread's outputs, row by row
  T* const out_b =
      static_cast<T*>(a.out) + static_cast<size_t>(k.b) * C * n_out;
  constexpr int E = static_cast<int>(sizeof(T));
  const int plane = box.sx * box.ey;
  const int org[3] = {box.staged ? box.xs : 0, box.staged ? box.lo[1] : 0,
                      box.staged ? box.lo[2] : 0};
  const int sy = box.staged ? box.sx * E : W, sz = box.staged ? plane * E
                                                             : H * W;
#pragma unroll
  for (int j = 0; j < KBZ; ++j) {
    const int oz = k.z + j;
    float v[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      // affine_grid's order: ((t0 x + t1 y) + t2 z) + t3
      const float zj = __shfl_sync(0xffffffffu, pz[i], j);
      v[i] = __fadd_rn(__fadd_rn(__fadd_rn(px[i], py[i]), zj), t3[i]);
    }
    if (ox >= a.Wo || oy >= a.Ho || oz >= a.Do) continue;
    const size_t o = (static_cast<size_t>(oz) * a.Ho + oy) * a.Wo + ox;
    const A ax(unnormalize(v[0], W, false), wm1),
        ay(unnormalize(v[1], H, false), hm1),
        az(unnormalize(v[2], D, false), dm1);
    if (box.staged)
      gather_store<T, NEAREST, BORDER, true>(
          src_b, s_base, static_cast<size_t>(plane) * box.ez * E, C, ax, ay,
          az, org, sy, sz, out_b + o, n_out, a.scale, sc);
    else
      gather_store<T, NEAREST, BORDER, false>(src_b, 0, n_src, C, ax, ay, az,
                                              org, sy, sz, out_b + o, n_out,
                                              a.scale, sc);
  }
}

template <typename T, bool NEAREST, bool BORDER, int KBZ>
int launch_brick(Args a, cudaStream_t stream) {
  auto kernel = warp_brick_kernel<T, NEAREST, BORDER, KBZ>;
  // the dynamic shared memory this instantiation may take on each device,
  // asked for once (the default limit counts the static tables too)
  static int allowed[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (a.stage_bytes > allowed[dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, a.stage_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed[dev] = a.stage_bytes;
  }
  a.nbx = (a.Wo + kBX - 1) / kBX;
  a.nby = (a.Ho + kBY - 1) / kBY;
  a.nbz = (a.Do + KBZ - 1) / KBZ;
  if (a.nby > 65535 || static_cast<long long>(a.nbz) * a.B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<dim3(a.nbx, a.nby, a.nbz * a.B), kBrickThreads, a.stage_bytes,
           stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The kernels of the host's plan (kernels/warp.py::warp_plan): `variant` is
// the affine entry's brick depth (8 for C <= 2, 4 above) or the grid
// entry's register budget (1: four blocks an SM, for C >= 4; 0: the
// compiler's).
template <typename T, bool NEAREST, bool BORDER>
int launch_kind(const Args& a, bool affine, int variant,
                cudaStream_t stream) {
  if (!affine) {
    const long long n_out = static_cast<long long>(a.Do) * a.Ho * a.Wo;
    const dim3 grid(static_cast<unsigned>((n_out + kFlat - 1) / kFlat), a.B);
    if (variant == 1)
      warp_grid_kernel_wide<T, NEAREST, BORDER><<<grid, kFlat, 0, stream>>>(a);
    else
      warp_grid_kernel<T, NEAREST, BORDER><<<grid, kFlat, 0, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  if (variant == 8) return launch_brick<T, NEAREST, BORDER, 8>(a, stream);
  return launch_brick<T, NEAREST, BORDER, 4>(a, stream);
}

template <typename T>
int launch_typed(const Args& a, bool affine, int variant, int nearest,
                 int border, cudaStream_t stream) {
  if (nearest)
    return border ? launch_kind<T, true, true>(a, affine, variant, stream)
                  : launch_kind<T, true, false>(a, affine, variant, stream);
  return border ? launch_kind<T, false, true>(a, affine, variant, stream)
                : launch_kind<T, false, false>(a, affine, variant, stream);
}

int launch(const Args& a, bool affine, int variant, int nearest, int border,
           int dtype, cudaStream_t stream) {
  return dtype == 0 ? launch_typed<float>(a, affine, variant, nearest,
                                          border, stream)
                    : launch_typed<__nv_bfloat16>(a, affine, variant,
                                                  nearest, border, stream);
}

// Arguments both forward entries check: shapes, type, shared memory (a
// multiple of 16 bytes).
bool bad_forward_args(int B, int C, int D, int H, int W, int Do, int Ho,
                      int Wo, int dtype, int stage_bytes) {
  // (a source axis of up to 2^24 voxels: its indices are exact in f32)
  return B <= 0 || B > 65535 || C <= 0 || D <= 0 || H <= 0 || W <= 0 ||
         D > (1 << 24) || H > (1 << 24) || W > (1 << 24) || Do <= 0 ||
         Ho <= 0 || Wo <= 0 ||
         static_cast<long long>(D) * H * W > 2147483647LL ||
         static_cast<long long>(Do) * Ho * Wo > 2147483647LL ||
         (dtype != 0 && dtype != 1) || stage_bytes < 0 ||
         stage_bytes % 16 != 0 || stage_bytes > 200 * 1024;
}

// The exact adjoint of the grid entry (trilinear): dx (f32, zeroed by the
// caller) += weight * g at each corner, by atomicAdd.  One thread per output
// voxel, the corners and weights of the forward kernel computed once, a loop
// over the channels.
template <typename T, bool BORDER>
__global__ void __launch_bounds__(kThreads)
warp_adjoint_kernel(const T* __restrict__ g, const float* __restrict__ gx,
                    const float* __restrict__ gy,
                    const float* __restrict__ gz, float* __restrict__ dx,
                    int C, int D, int H, int W, long long n_out, int align) {
  const long long o = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (o >= n_out) return;
  const int b = blockIdx.y;
  const long long n_src = static_cast<long long>(D) * H * W;
  const size_t gi = static_cast<size_t>(b) * n_out + o;
  const float x = unnormalize(gx[gi], W, align);
  const float y = unnormalize(gy[gi], H, align);
  const float z = unnormalize(gz[gi], D, align);
  const float x0f = floorf(x), y0f = floorf(y), z0f = floorf(z);
  const float tx = x - x0f, ty = y - y0f, tz = z - z0f;
  const int x0 = to_index(x0f, W), y0 = to_index(y0f, H),
            z0 = to_index(z0f, D);
  int lin[8];
  float wt[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int dz = k >> 2, dy = (k >> 1) & 1, dx_ = k & 1;
    bool inside = true;
    const int zi = corner(z0 + dz, D, &inside);
    const int yi = corner(y0 + dy, H, &inside);
    const int xi = corner(x0 + dx_, W, &inside);
    lin[k] = (zi * H + yi) * W + xi;
    const float w = __fmul_rn(__fmul_rn(dz ? tz : 1.0f - tz,
                                        dy ? ty : 1.0f - ty),
                              dx_ ? tx : 1.0f - tx);
    wt[k] = (BORDER || inside) ? w : 0.0f;
  }
  const T* gb = g + static_cast<size_t>(b) * C * n_out + o;
  float* db = dx + static_cast<size_t>(b) * C * n_src;
  for (int c = 0; c < C; ++c) {
    const float gv = to_f32(gb[static_cast<size_t>(c) * n_out]);
    if (gv == 0.0f) continue;
    float* dc = db + static_cast<size_t>(c) * n_src;
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (wt[k] != 0.0f) atomicAdd(dc + lin[k], __fmul_rn(wt[k], gv));
  }
}

template <typename T>
void launch_adjoint(const void* g, const float* gx, const float* gy,
                    const float* gz, float* dx, int B, int C, int D, int H,
                    int W, long long n_out, int border, int align,
                    cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((n_out + kThreads - 1) / kThreads),
                  B);
  const T* gt = static_cast<const T*>(g);
  if (border)
    warp_adjoint_kernel<T, true><<<grid, kThreads, 0, stream>>>(
        gt, gx, gy, gz, dx, C, D, H, W, n_out, align);
  else
    warp_adjoint_kernel<T, false><<<grid, kThreads, 0, stream>>>(
        gt, gx, gy, gz, dx, C, D, H, W, n_out, align);
}

}  // namespace

// The grid entry: out (B, C, Do*Ho*Wo) = src (B, C, D*H*W) sampled at the
// points gx/gy/gz (B, Do*Ho*Wo) f32; all contiguous.  nearest: 0 =
// trilinear, 1 = nearest; border: 0 = zeros, 1 = border; dtype: 0 =
// float32, 1 = bfloat16; wide: 1 for the kernel of the wide register
// budget, 0 for the compiler's; counts: null, or two device counters
// (staged, global) that each block of 256 consecutive outputs adds one to
// (the grid entry gathers every block from device memory).  Returns
// cudaGetLastError()
// after the launch (cudaErrorInvalidValue for arguments the kernel does
// not take).
extern "C" int dgtta_warp(const void* src, const void* gx, const void* gy,
                          const void* gz, void* out, int B, int C, int D,
                          int H, int W, int Do, int Ho, int Wo, int nearest,
                          int border, int align, int dtype, int wide,
                          void* counts, void* stream) {
  if (bad_forward_args(B, C, D, H, W, Do, Ho, Wo, dtype, 0) ||
      (wide != 0 && wide != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a = {};
  a.src = src;
  a.out = out;
  a.gx = static_cast<const float*>(gx);
  a.gy = static_cast<const float*>(gy);
  a.gz = static_cast<const float*>(gz);
  a.counts = static_cast<unsigned long long*>(counts);
  a.align = align;
  a.B = B, a.C = C, a.D = D, a.H = H, a.W = W, a.Do = Do, a.Ho = Ho, a.Wo = Wo;
  return launch(a, false, wide, nearest, border, dtype,
                static_cast<cudaStream_t>(stream));
}

// The affine entry: out (B, C, Do*Ho*Wo) = src (B, C, D*H*W) sampled at the
// points of core/grid.py::affine_grid(theta, (Do, Ho, Wo),
// align_corners=False), built in the kernel.  theta: f32, 12 per batch entry
// (theta_stride 12) or one for all (0); scale: null, or an f32 factor per
// batch entry (scale_stride 1) or for all (0) applied as
// `out * scale.to(out's type)`; base: f32, the Wo + Ho + Do base
// coordinates of core/grid.py::_base_coords (x, then y, then z); depth: the
// bricks' rows, 4 or 8; stage_bytes: a block's box buffer (a brick whose
// box of all channels exceeds it gathers from device memory); counts: as
// dgtta_warp's, for bricks of 32 x 8 x depth outputs; the rest as
// dgtta_warp's.  All contiguous.  Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for arguments the kernel does not take).
extern "C" int dgtta_warp_affine(const void* src, const void* theta,
                                 int theta_stride, const void* scale,
                                 int scale_stride, const void* base,
                                 void* out, int B, int C, int D, int H, int W,
                                 int Do, int Ho, int Wo, int nearest,
                                 int border, int dtype, int depth,
                                 int stage_bytes, void* counts,
                                 void* stream) {
  if (bad_forward_args(B, C, D, H, W, Do, Ho, Wo, dtype, stage_bytes) ||
      (theta_stride != 0 && theta_stride != 12) ||
      (scale_stride != 0 && scale_stride != 1) ||
      (depth != 4 && depth != 8))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a = {};
  a.src = src;
  a.out = out;
  a.theta = static_cast<const float*>(theta);
  a.theta_stride = theta_stride;
  a.scale = static_cast<const float*>(scale);
  a.scale_stride = scale_stride;
  a.base = static_cast<const float*>(base);
  a.counts = static_cast<unsigned long long*>(counts);
  a.B = B, a.C = C, a.D = D, a.H = H, a.W = W, a.Do = Do, a.Ho = Ho, a.Wo = Wo;
  a.stage_bytes = stage_bytes;
  return launch(a, true, depth, nearest, border, dtype,
                static_cast<cudaStream_t>(stream));
}

// The exact adjoint of dgtta_warp (trilinear): dx (B, C, D*H*W) f32, zeroed
// by the caller, += the scatter of g (B, C, n_out) through the corners and
// weights of the points gx/gy/gz (B, n_out) f32; border: 0 = zeros, 1 =
// border; dtype of g: 0 = float32, 1 = bfloat16.  All contiguous.  Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for arguments
// the kernel does not take).
extern "C" int dgtta_warp_adjoint(const void* g, const void* gx,
                                  const void* gy, const void* gz, void* dx,
                                  int B, int C, int D, int H, int W,
                                  long long n_out, int border, int align,
                                  int dtype, void* stream) {
  if (B <= 0 || B > 65535 || C <= 0 || D <= 0 || H <= 0 || W <= 0 ||
      static_cast<long long>(D) * H * W > 2147483647LL || n_out <= 0 ||
      (n_out + kThreads - 1) / kThreads > 2147483647LL ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* x = static_cast<const float*>(gx);
  const float* y = static_cast<const float*>(gy);
  const float* z = static_cast<const float*>(gz);
  float* d = static_cast<float*>(dx);
  if (dtype == 0)
    launch_adjoint<float>(g, x, y, z, d, B, C, D, H, W, n_out, border, align,
                          s);
  else
    launch_adjoint<__nv_bfloat16>(g, x, y, z, d, B, C, D, H, W, n_out,
                                  border, align, s);
  return static_cast<int>(cudaGetLastError());
}
