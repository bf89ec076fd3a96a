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
// What bounds it on an H100: bytes.  Per output voxel it reads three f32
// coordinates and 8 corners per channel and writes one value per channel,
// for ~20 flops per channel: far below the card's ~20 flops per byte of f32
// balance.  The corner reads are scattered, but the TTA warps are near the
// identity, so the 8 corners of neighbouring output voxels fall on
// neighbouring source addresses and a warp's loads stay within a few cache
// lines per corner.
//
// Two entries.  dgtta_warp takes the grid as three f32 arrays (any map:
// grid_sample, the deformable slice).  dgtta_warp_affine takes the 12
// numbers of an affine theta per batch entry and builds each point in the
// kernel with the operations of core/grid.py::affine_grid, so it reads no
// grid (12 bytes per output voxel fewer, more than a C = 1 warp's own source
// and output bytes) and its output is bit for bit that of dgtta_warp on
// affine_grid(theta); every call site of adaptation warps by an affine.
// It also takes an optional per-batch factor (the adjoint's 1 / |det|),
// applied in the store.
//
// What the design does about it: one thread per output voxel (grid entry)
// or per two output voxels a block apart (affine entry: every load and
// store instruction of a warp still covers 32 consecutive outputs; four
// consecutive outputs per thread, with 16-byte stores, took 136 registers
// and scattered each gather instruction over 4x the cache lines, and were
// no faster on the card).  A thread gets its points once (read or built),
// computes the 8 corner addresses and weights once and keeps them in
// registers, then loops over the C channels: one set of addresses serves
// every channel, and the output stores of a warp are
// contiguous in o for every channel.  The coordinate unnormalization uses
// round-to-nearest intrinsics, which the compiler never fuses into an FMA,
// so the corner choice (floor, and the rounding of exact .5 ties in nearest
// mode) is bit-for-bit that of the plain version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

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

template <typename T, bool NEAREST, bool BORDER>
__global__ void __launch_bounds__(kThreads)
warp_kernel(const T* __restrict__ src, const float* __restrict__ gx,
            const float* __restrict__ gy, const float* __restrict__ gz,
            T* __restrict__ out, int C, int D, int H, int W, long long n_out,
            int align) {
  const long long o = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (o >= n_out) return;
  const int b = blockIdx.y;
  const long long n_src = static_cast<long long>(D) * H * W;
  const size_t gi = static_cast<size_t>(b) * n_out + o;
  const float x = unnormalize(gx[gi], W, align);
  const float y = unnormalize(gy[gi], H, align);
  const float z = unnormalize(gz[gi], D, align);
  const T* s = src + static_cast<size_t>(b) * C * n_src;
  T* dst = out + static_cast<size_t>(b) * C * n_out + o;

  if (NEAREST) {
    bool inside = true;
    const int xi = corner(to_index(rintf(x), W), W, &inside);
    const int yi = corner(to_index(rintf(y), H), H, &inside);
    const int zi = corner(to_index(rintf(z), D), D, &inside);
    const int lin = (zi * H + yi) * W + xi;
    const bool keep = BORDER || inside;
    for (int c = 0; c < C; ++c)
      dst[static_cast<size_t>(c) * n_out] =
          keep ? s[c * n_src + lin] : from_f32<T>(0.f);
    return;
  }

  const float x0f = floorf(x), y0f = floorf(y), z0f = floorf(z);
  const float tx = x - x0f, ty = y - y0f, tz = z - z0f;
  const int x0 = to_index(x0f, W), y0 = to_index(y0f, H),
            z0 = to_index(z0f, D);
  int lin[8];  // source offsets: the entry point takes D*H*W < 2^31
  float wt[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int dz = k >> 2, dy = (k >> 1) & 1, dx = k & 1;
    bool inside = true;
    const int zi = corner(z0 + dz, D, &inside);
    const int yi = corner(y0 + dy, H, &inside);
    const int xi = corner(x0 + dx, W, &inside);
    lin[k] = (zi * H + yi) * W + xi;
    // core/grid.py order: (z factor) * (y factor) * (x factor)
    const float w = __fmul_rn(__fmul_rn(dz ? tz : 1.0f - tz,
                                        dy ? ty : 1.0f - ty),
                              dx ? tx : 1.0f - tx);
    wt[k] = (BORDER || inside) ? w : 0.0f;
  }
  for (int c = 0; c < C; ++c) {
    const T* sc = s + c * n_src;
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < 8; ++k) acc = fmaf(wt[k], to_f32(sc[lin[k]]), acc);
    dst[static_cast<size_t>(c) * n_out] = from_f32<T>(acc);
  }
}

// core/grid.py::_base_coords with align_corners=False, in its operations:
// (2 i + 1) / size - 1, each rounded (the division a true division, as the
// CPU computes it; the grid's base coordinates are computed there).
__device__ __forceinline__ float base_coord(int i, int size) {
  return __fsub_rn(__fdiv_rn(__fadd_rn(__fmul_rn(2.0f, static_cast<float>(i)),
                                       1.0f),
                             static_cast<float>(size)),
                   1.0f);
}

// One row of core/grid.py::affine_grid: ((t0 x + t1 y) + t2 z) + t3, each
// operation rounded, never fused.
__device__ __forceinline__ float affine_row(const float* t, float x, float y,
                                            float z) {
  return __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(t[0], x), __fmul_rn(t[1], y)),
                             __fmul_rn(t[2], z)),
                   t[3]);
}

// v rounded to T, then times scale rounded to T, rounded to T: the value of
// `warp_flat(...) * scale.to(T)` in PyTorch (which multiplies two T values in
// f32 and rounds once).
template <typename T>
__device__ __forceinline__ T scaled(float v, float scale) {
  return from_f32<T>(__fmul_rn(to_f32(from_f32<T>(v)),
                               to_f32(from_f32<T>(scale))));
}

// The affine entry: each thread builds the points of kPer outputs, kThreads
// apart (so that every load and store instruction of a warp covers 32
// consecutive outputs, whose corners share cache lines), from theta's 12
// numbers (no grid in memory), computes their corners and weights once,
// then loops over the channels, two at a time so that their gathers are
// in flight together.
constexpr int kPer = 2;

template <typename T, bool NEAREST, bool BORDER>
__global__ void __launch_bounds__(kThreads)
warp_affine_kernel(const T* __restrict__ src, const float* __restrict__ theta,
                   int theta_stride, const float* __restrict__ scale,
                   int scale_stride, T* __restrict__ out, int C, int D, int H,
                   int W, int Do, int Ho, int Wo) {
  constexpr int K = NEAREST ? 1 : 8;
  const int b = blockIdx.y;
  const unsigned n_out = static_cast<unsigned>(Do) * Ho * Wo;
  const unsigned o0 = blockIdx.x * (kThreads * kPer) + threadIdx.x;
  float t[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) t[i] = __ldg(theta + b * theta_stride + i);
  const size_t n_src = static_cast<size_t>(D) * H * W;
  const T* s = src + static_cast<size_t>(b) * C * n_src;
  T* dst = out + static_cast<size_t>(b) * C * n_out;
  const float sc = scale == nullptr ? 1.0f : __ldg(scale + b * scale_stride);

  int lin[kPer][K];  // source offsets (D*H*W < 2^31)
  float wt[kPer][K];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const unsigned o = min(o0 + j * kThreads, n_out - 1);
    const bool live = o0 + j * kThreads < n_out;
    const unsigned row = o / Wo;
    const float xn = base_coord(static_cast<int>(o - row * Wo), Wo);
    const float yn = base_coord(static_cast<int>(row % Ho), Ho);
    const float zn = base_coord(static_cast<int>(row / Ho), Do);
    const float x = unnormalize(affine_row(t, xn, yn, zn), W, false);
    const float y = unnormalize(affine_row(t + 4, xn, yn, zn), H, false);
    const float z = unnormalize(affine_row(t + 8, xn, yn, zn), D, false);
    if constexpr (NEAREST) {
      bool inside = true;
      const int xi = corner(to_index(rintf(x), W), W, &inside);
      const int yi = corner(to_index(rintf(y), H), H, &inside);
      const int zi = corner(to_index(rintf(z), D), D, &inside);
      lin[j][0] = (zi * H + yi) * W + xi;
      wt[j][0] = ((BORDER || inside) && live) ? 1.0f : 0.0f;
    } else {
      const float x0f = floorf(x), y0f = floorf(y), z0f = floorf(z);
      const float tx = x - x0f, ty = y - y0f, tz = z - z0f;
      const int x0 = to_index(x0f, W), y0 = to_index(y0f, H),
                z0 = to_index(z0f, D);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int dz = k >> 2, dy = (k >> 1) & 1, dx = k & 1;
        bool inside = true;
        const int zi = corner(z0 + dz, D, &inside);
        const int yi = corner(y0 + dy, H, &inside);
        const int xi = corner(x0 + dx, W, &inside);
        lin[j][k] = (zi * H + yi) * W + xi;
        // core/grid.py order: (z factor) * (y factor) * (x factor)
        const float w = __fmul_rn(__fmul_rn(dz ? tz : 1.0f - tz,
                                            dy ? ty : 1.0f - ty),
                                  dx ? tx : 1.0f - tx);
        wt[j][k] = ((BORDER || inside) && live) ? w : 0.0f;
      }
    }
  }
#pragma unroll 2
  for (int c = 0; c < C; ++c) {
    const T* sc_src = s + c * n_src;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      float acc;
      if constexpr (NEAREST) {
        acc = wt[j][0] != 0.0f ? to_f32(__ldg(sc_src + lin[j][0])) : 0.0f;
      } else {
        acc = 0.0f;
#pragma unroll
        for (int k = 0; k < 8; ++k)
          acc = fmaf(wt[j][k], to_f32(__ldg(sc_src + lin[j][k])), acc);
      }
      const unsigned o = o0 + j * kThreads;
      if (o < n_out)
        dst[static_cast<size_t>(c) * n_out + o] =
            scale == nullptr ? from_f32<T>(acc) : scaled<T>(acc, sc);
    }
  }
}

template <typename T>
void launch_affine(const void* src, const float* theta, int theta_stride,
                   const float* scale, int scale_stride, void* out, int B,
                   int C, int D, int H, int W, int Do, int Ho, int Wo,
                   int nearest, int border, cudaStream_t stream) {
  const long long n_out = static_cast<long long>(Do) * Ho * Wo;
  const dim3 grid(
      static_cast<unsigned>((n_out + kThreads * kPer - 1) /
                            (kThreads * kPer)),
      B);
  const T* s = static_cast<const T*>(src);
  T* o = static_cast<T*>(out);
#define DGTTA_WARP_AFFINE(NEAR, BORD)                                         \
  warp_affine_kernel<T, NEAR, BORD><<<grid, kThreads, 0, stream>>>(           \
      s, theta, theta_stride, scale, scale_stride, o, C, D, H, W, Do, Ho, Wo)
  if (nearest) {
    if (border) DGTTA_WARP_AFFINE(true, true);
    else DGTTA_WARP_AFFINE(true, false);
  } else {
    if (border) DGTTA_WARP_AFFINE(false, true);
    else DGTTA_WARP_AFFINE(false, false);
  }
#undef DGTTA_WARP_AFFINE
}

template <typename T>
void launch(const void* src, const float* gx, const float* gy,
            const float* gz, void* out, int B, int C, int D, int H, int W,
            long long n_out, int nearest, int border, int align,
            cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((n_out + kThreads - 1) / kThreads),
                  B);
  const T* s = static_cast<const T*>(src);
  T* o = static_cast<T*>(out);
  if (nearest) {
    if (border)
      warp_kernel<T, true, true><<<grid, kThreads, 0, stream>>>(
          s, gx, gy, gz, o, C, D, H, W, n_out, align);
    else
      warp_kernel<T, true, false><<<grid, kThreads, 0, stream>>>(
          s, gx, gy, gz, o, C, D, H, W, n_out, align);
  } else {
    if (border)
      warp_kernel<T, false, true><<<grid, kThreads, 0, stream>>>(
          s, gx, gy, gz, o, C, D, H, W, n_out, align);
    else
      warp_kernel<T, false, false><<<grid, kThreads, 0, stream>>>(
          s, gx, gy, gz, o, C, D, H, W, n_out, align);
  }
}

}  // namespace

// src (B, C, D*H*W), gx/gy/gz (B, n_out) f32, out (B, C, n_out); all
// contiguous.  nearest: 0 = trilinear, 1 = nearest; border: 0 = zeros,
// 1 = border; dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError()
// after the launch (cudaErrorInvalidValue for arguments the kernel does not
// take).
extern "C" int dgtta_warp(const void* src, const void* gx, const void* gy,
                          const void* gz, void* out, int B, int C, int D,
                          int H, int W, long long n_out, int nearest,
                          int border, int align, int dtype, void* stream) {
  if (B <= 0 || B > 65535 || C <= 0 || D <= 0 || H <= 0 || W <= 0 ||
      static_cast<long long>(D) * H * W > 2147483647LL || n_out <= 0 ||
      (n_out + kThreads - 1) / kThreads > 2147483647LL ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* x = static_cast<const float*>(gx);
  const float* y = static_cast<const float*>(gy);
  const float* z = static_cast<const float*>(gz);
  if (dtype == 0)
    launch<float>(src, x, y, z, out, B, C, D, H, W, n_out, nearest, border,
                  align, s);
  else
    launch<__nv_bfloat16>(src, x, y, z, out, B, C, D, H, W, n_out, nearest,
                          border, align, s);
  return static_cast<int>(cudaGetLastError());
}

// The affine entry: out (B, C, Do*Ho*Wo) = src (B, C, D*H*W) sampled at the
// points of core/grid.py::affine_grid(theta, (Do, Ho, Wo),
// align_corners=False), built in the kernel.  theta: f32, 12 per batch entry
// (theta_stride 12) or one for all (0); scale: null, or an f32 factor per
// batch entry (scale_stride 1) or for all (0) applied as
// `out * scale.to(out's type)`.  All contiguous.  Returns cudaGetLastError()
// after the launch (cudaErrorInvalidValue for arguments the kernel does not
// take).
extern "C" int dgtta_warp_affine(const void* src, const void* theta,
                                 int theta_stride, const void* scale,
                                 int scale_stride, void* out, int B, int C,
                                 int D, int H, int W, int Do, int Ho, int Wo,
                                 int nearest, int border, int dtype,
                                 void* stream) {
  if (B <= 0 || B > 65535 || C <= 0 || D <= 0 || H <= 0 || W <= 0 ||
      Do <= 0 || Ho <= 0 || Wo <= 0 ||
      static_cast<long long>(D) * H * W > 2147483647LL ||
      static_cast<long long>(Do) * Ho * Wo > 2147483647LL ||
      (theta_stride != 0 && theta_stride != 12) ||
      (scale_stride != 0 && scale_stride != 1) ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* t = static_cast<const float*>(theta);
  const float* sc = static_cast<const float*>(scale);
  if (dtype == 0)
    launch_affine<float>(src, t, theta_stride, sc, scale_stride, out, B, C, D,
                         H, W, Do, Ho, Wo, nearest, border, s);
  else
    launch_affine<__nv_bfloat16>(src, t, theta_stride, sc, scale_stride, out,
                                 B, C, D, H, W, Do, Ho, Wo, nearest, border,
                                 s);
  return static_cast<int>(cudaGetLastError());
}
