// 3x3 stride-1 pad-1 convolution on NHWC planes, with an optional sum over
// three z-neighbour planes (the z-taps of a 3x3x3 conv), for sm_90a.
//
// Replaces dg_tta_tpu/ops/conv2d_pallas.py::conv3x3_pallas, and with KZ=3 the
// three z-tap calls of it that dg_tta_tpu/models/unet.py::_conv sums per
// stride-1 3x3x3 conv.
//
//   y[n,h,w,co] = sum_{kz<KZ} sum_{ky,kx<3} sum_{ci<C}
//                   x[n+kz-KZ/2, h+ky-1, w+kx-1, ci] * w[kz,ky,kx,ci,co]
//
// with zeros outside the plane and outside the plane's group of `depth`
// consecutive planes (one group = one (b, :) volume of a (B, D, H, W, C)
// tensor viewed as (B*D, H, W, C)).  Inputs f32 or bf16, f32 accumulation in
// registers, output in the input's type.
//
// What bounds it on an H100: at the U-Net's widths (C, CO = 32..512) a conv
// does 2*27*C*CO operations per output voxel against (C + CO) elements of
// device traffic, hundreds of operations per byte, so it is bound by
// arithmetic.  This first version runs the arithmetic as f32 FMAs on the CUDA
// cores (67 TFLOP/s peak), not on the tensor cores; moving the inner product
// onto wgmma with TMA-fed tiles is the later redesign.
//
// What the design does about it: each block owns a TILE_H x 16 pixel tile of
// one output plane and a CO_TILE slice of output channels.  Per z-tap and per
// chunk of 8 input channels it stages the zero-padded (TILE_H+2) x 18 halo
// tile and the 9 x 8 x CO_TILE weight slice in shared memory (f32), then
// each of the 256 threads accumulates a 4-pixel x 8-channel register tile:
// every shared-memory load feeds 4 (input) or 8 (weight) FMAs.  Input tiles
// are stored channel-major so the four pixel groups of a warp read distinct
// banks; each thread's 8 output channels are two runs of 4 at CO_TILE/2
// apart so the float4 weight loads of a quarter-warp hit distinct banks.
// Ragged edges (H, W, C, CO not multiples of the tiles, C = 1) are masked
// with zeros on load and skipped on store.  A z-tap whose plane lies outside
// the group is skipped by the whole block.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileW = 16;
constexpr int kCiChunk = 8;
constexpr int kPx = 4;  // pixels per thread, along w
constexpr int kCo = 8;  // output channels per thread

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

template <int CO_TILE>
struct Tile {
  static constexpr int kCoGroups = CO_TILE / kCo;
  static constexpr int kPxGroups = kThreads / kCoGroups;
  static constexpr int kGroupsPerRow = kTileW / kPx;
  static constexpr int kTileH = kPxGroups / kGroupsPerRow;
  static constexpr int kHaloH = kTileH + 2;
  static constexpr int kHaloW = kTileW + 2;
};

template <typename T, int CO_TILE>
__global__ void __launch_bounds__(kThreads)
conv3x3_kernel(const T* __restrict__ x, const T* __restrict__ w,
               T* __restrict__ y, int depth, int H, int W, int C, int CO,
               int KZ, int tiles_w) {
  using TL = Tile<CO_TILE>;
  constexpr int kHalf = CO_TILE / 2;
  __shared__ float xs[kCiChunk][TL::kHaloH][TL::kHaloW];
  __shared__ __align__(16) float ws[9][kCiChunk][CO_TILE];

  const int n = blockIdx.z;
  const int d = n % depth;
  const int h0 = (blockIdx.x / tiles_w) * TL::kTileH;
  const int w0 = (blockIdx.x % tiles_w) * kTileW;
  const int co0 = blockIdx.y * CO_TILE;

  const int tid = threadIdx.x;
  const int cog = tid % TL::kCoGroups;
  const int pg = tid / TL::kCoGroups;
  const int ph = pg / TL::kGroupsPerRow;
  const int pw = (pg % TL::kGroupsPerRow) * kPx;

  float acc[kPx][kCo];
#pragma unroll
  for (int p = 0; p < kPx; ++p)
#pragma unroll
    for (int j = 0; j < kCo; ++j) acc[p][j] = 0.f;

  for (int kz = 0; kz < KZ; ++kz) {
    const int dz = kz - KZ / 2;
    if (d + dz < 0 || d + dz >= depth) continue;  // uniform over the block
    const T* xp = x + (size_t)(n + dz) * H * W * C;
    const T* wp = w + (size_t)kz * 9 * C * CO;
    for (int ci0 = 0; ci0 < C; ci0 += kCiChunk) {
      __syncthreads();
      for (int i = tid; i < TL::kHaloH * TL::kHaloW * kCiChunk;
           i += kThreads) {
        const int ci = i % kCiChunk;
        const int p = i / kCiChunk;
        const int r = p / TL::kHaloW;
        const int c = p % TL::kHaloW;
        const int hh = h0 + r - 1, ww = w0 + c - 1, cc = ci0 + ci;
        float v = 0.f;
        if (hh >= 0 && hh < H && ww >= 0 && ww < W && cc < C)
          v = to_f32(xp[((size_t)hh * W + ww) * C + cc]);
        xs[ci][r][c] = v;
      }
      for (int i = tid; i < 9 * kCiChunk * CO_TILE; i += kThreads) {
        const int co = i % CO_TILE;
        const int t = i / CO_TILE;
        const int ci = t % kCiChunk;
        const int tap = t / kCiChunk;
        const int cc = ci0 + ci, oc = co0 + co;
        float v = 0.f;
        if (cc < C && oc < CO) v = to_f32(wp[((size_t)tap * C + cc) * CO + oc]);
        ws[tap][ci][co] = v;
      }
      __syncthreads();
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
#pragma unroll
          for (int ci = 0; ci < kCiChunk; ++ci) {
            float xv[kPx];
#pragma unroll
            for (int p = 0; p < kPx; ++p) xv[p] = xs[ci][ph + ky][pw + p + kx];
            const float4 wa =
                *reinterpret_cast<const float4*>(&ws[ky * 3 + kx][ci][cog * 4]);
            const float4 wb = *reinterpret_cast<const float4*>(
                &ws[ky * 3 + kx][ci][kHalf + cog * 4]);
            const float wv[kCo] = {wa.x, wa.y, wa.z, wa.w,
                                   wb.x, wb.y, wb.z, wb.w};
#pragma unroll
            for (int p = 0; p < kPx; ++p)
#pragma unroll
              for (int j = 0; j < kCo; ++j)
                acc[p][j] = fmaf(xv[p], wv[j], acc[p][j]);
          }
        }
      }
    }
  }

  const int h = h0 + ph;
  if (h >= H) return;
#pragma unroll
  for (int p = 0; p < kPx; ++p) {
    const int ww = w0 + pw + p;
    if (ww >= W) continue;
    T* yp = y + (((size_t)n * H + h) * W + ww) * CO;
#pragma unroll
    for (int j = 0; j < kCo; ++j) {
      const int oc = co0 + (j < 4 ? cog * 4 + j : kHalf + cog * 4 + j - 4);
      if (oc < CO) yp[oc] = from_f32<T>(acc[p][j]);
    }
  }
}

template <typename T, int CO_TILE>
void launch(const void* x, const void* w, void* y, int N, int depth, int H,
            int W, int C, int CO, int KZ, cudaStream_t stream) {
  using TL = Tile<CO_TILE>;
  const int tiles_w = (W + kTileW - 1) / kTileW;
  const int tiles_h = (H + TL::kTileH - 1) / TL::kTileH;
  const dim3 grid(tiles_h * tiles_w, (CO + CO_TILE - 1) / CO_TILE, N);
  conv3x3_kernel<T, CO_TILE><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y),
      depth, H, W, C, CO, KZ, tiles_w);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for arguments the kernel does not take).
extern "C" int dgtta_conv3x3(const void* x, const void* w, void* y, int N,
                             int depth, int H, int W, int C, int CO, int KZ,
                             int dtype, void* stream) {
  if (N <= 0 || depth <= 0 || N % depth != 0 || H <= 0 || W <= 0 || C <= 0 ||
      CO <= 0 || (KZ != 1 && KZ != 3) || (dtype != 0 && dtype != 1) ||
      N > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool narrow = CO <= 32;
  if (dtype == 0) {
    if (narrow)
      launch<float, 32>(x, w, y, N, depth, H, W, C, CO, KZ, s);
    else
      launch<float, 64>(x, w, y, N, depth, H, W, C, CO, KZ, s);
  } else {
    if (narrow)
      launch<__nv_bfloat16, 32>(x, w, y, N, depth, H, W, C, CO, KZ, s);
    else
      launch<__nv_bfloat16, 64>(x, w, y, N, depth, H, W, C, CO, KZ, s);
  }
  return static_cast<int>(cudaGetLastError());
}
