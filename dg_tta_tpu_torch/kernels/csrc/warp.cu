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
// What the design does about it: one thread per output voxel.  It reads its
// grid point once, computes the 8 corner addresses and weights once and
// keeps them in registers, then loops over the C channels: one set of
// addresses serves every channel, and the output stores of a warp are
// contiguous in o for every channel.  The coordinate unnormalization uses
// round-to-nearest intrinsics, which the compiler never fuses into an FMA,
// so the corner choice (floor, and the rounding of exact .5 ties in nearest
// mode) is bit-for-bit that of the plain version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

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
