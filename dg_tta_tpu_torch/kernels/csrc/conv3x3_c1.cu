// The first U-Net conv, on the 1-channel image: the 3x3(x3) stride-1 pad-1
// convolution of conv3x3.cu and its weight gradient for C = 1, f32 or bf16,
// for sm_90a.
//
// Replaces dg_tta_tpu/ops/conv2d_pallas.py::conv3x3_pallas at C = 1 (with
// KZ=3 the three z-tap calls of it that dg_tta_tpu/models/unet.py::_conv
// sums), and its weight gradient, which the TPU package left to XLA's conv
// transpose:
//
//   y[n,h,w,co]  = sum_{kz<KZ,ky,kx} x[n+kz-KZ/2, h+ky-1, w+kx-1] * w[tap,co]
//   dW[tap,co]   = sum_{n,h,w}       x[n+kz-KZ/2, h+ky-1, w+kx-1] * dy[n,h,w,co]
//
// tap = (kz, ky, kx), zeros outside the plane and outside the plane's group
// of `depth` planes, f32 sums, y in the input's type, dW f32.
//
// What bounds it on an H100: one input channel against CO = 32 outputs, so
// 2*27*CO operations per voxel against CO elements of y written (forward) or
// of dy read (weight gradient): ~27 operations per byte in bf16, below the
// card's ~20 (f32 CUDA cores) to ~295 (bf16 tensor cores) per byte, and the
// image is 1/CO of the traffic.  Both are bound by the bytes of y or dy:
// 205 MB, 0.061 ms, for the two 112 x 112 x 128 volumes of a TTA step in
// bf16, twice that in f32.  conv3x3.cu and conv3x3_wgrad.cu run this shape
// through channel tiles of 8 and 4 input channels, 7/8 and 3/4 of them zero
// padding, and the CUDA-core weight gradient reads dy once per tap slice.
//
// What the design does about it: a block owns a 16 x 32 pixel tile of one
// plane and 32 output channels.  It stages the KZ zero-padded 18 x 34 halo
// planes of x in shared memory (f32); each of its 256 threads owns one row
// of the tile and one pair of output channels, and walks the row's 32
// pixels with the 3 x 3 x KZ window of x in registers (9 new shared loads
// per pixel, the rest shifted).  The forward keeps the thread's 2 x 27
// weights in registers: 54 FMAs per pixel, then one 4- (bf16) or 8-byte
// (f32) store; the 16 threads of a row write the pixel's 32 channels as one
// contiguous 64- or 128-byte run.  The weight gradient reads each pixel's dy
// pair once for all 27 taps, coalesced the same way, and keeps 27 x 2 sums
// in registers over a fixed, strided set of tiles per block; at the end the
// block reduces its rows (shuffle, then shared memory in warp order) and
// writes one partial per block, and a second kernel adds the partials in a
// fixed order: the sum does not depend on scheduling (no atomics).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kRows = 16;   // tile rows: one per thread row
constexpr int kCols = 32;   // tile columns, walked by each thread
constexpr int kPairs = 16;  // output channel pairs per block
constexpr int kCoT = 2 * kPairs;
constexpr int kThreads = kRows * kPairs;
constexpr int kHaloH = kRows + 2;
constexpr int kHaloW = kCols + 2;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a,
                                           float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_one(__nv_bfloat16* p, float a) {
  *p = __float2bfloat16(a);
}
__device__ __forceinline__ void store_one(float* p, float a) { *p = a; }

__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// Stages the KZ halo planes of the tile at (n, h0, w0), zeros outside the
// plane and the group.
template <typename T, int KZ>
__device__ __forceinline__ void stage_halo(float (&xs)[KZ][kHaloH][kHaloW],
                                           const T* __restrict__ x, int n,
                                           int depth, int H, int W, int h0,
                                           int w0) {
  const int d = n % depth;
  for (int i = threadIdx.x; i < KZ * kHaloH * kHaloW; i += kThreads) {
    const int kz = i / (kHaloH * kHaloW);
    const int rr = (i / kHaloW) % kHaloH;
    const int cc = i % kHaloW;
    const int dz = kz - KZ / 2;
    const int hh = h0 + rr - 1, ww = w0 + cc - 1;
    float v = 0.f;
    if (d + dz >= 0 && d + dz < depth && hh >= 0 && hh < H && ww >= 0 &&
        ww < W)
      v = to_f32(x[((size_t)(n + dz) * H + hh) * W + ww]);
    xs[kz][rr][cc] = v;
  }
}

// Shifts the register window one column along w and loads the new column
// (halo column c + 2) of row r.
template <int KZ>
__device__ __forceinline__ void slide(float (&win)[KZ][3][3],
                                      const float (&xs)[KZ][kHaloH][kHaloW],
                                      int r, int c) {
#pragma unroll
  for (int kz = 0; kz < KZ; ++kz)
#pragma unroll
    for (int ky = 0; ky < 3; ++ky) {
      win[kz][ky][0] = win[kz][ky][1];
      win[kz][ky][1] = win[kz][ky][2];
      win[kz][ky][2] = xs[kz][r + ky][c + 2];
    }
}

template <typename T, int KZ>
__global__ void __launch_bounds__(kThreads)
c1_forward_kernel(const T* __restrict__ x, const T* __restrict__ w,
                  T* __restrict__ y, int depth, int H, int W, int CO,
                  int tiles_w) {
  __shared__ float xs[KZ][kHaloH][kHaloW];
  const int n = blockIdx.z;
  const int h0 = (blockIdx.x / tiles_w) * kRows;
  const int w0 = (blockIdx.x % tiles_w) * kCols;
  const int co = blockIdx.y * kCoT + 2 * (threadIdx.x % kPairs);
  const int r = threadIdx.x / kPairs;

  float wa[KZ * 9], wb[KZ * 9];
#pragma unroll
  for (int t = 0; t < KZ * 9; ++t) {
    wa[t] = co < CO ? to_f32(w[t * CO + co]) : 0.f;
    wb[t] = co + 1 < CO ? to_f32(w[t * CO + co + 1]) : 0.f;
  }
  stage_halo<T, KZ>(xs, x, n, depth, H, W, h0, w0);
  __syncthreads();

  const int h = h0 + r;
  const bool pairs = (CO & 1) == 0;  // pair stores stay aligned
  float win[KZ][3][3];
#pragma unroll
  for (int kz = 0; kz < KZ; ++kz)
#pragma unroll
    for (int ky = 0; ky < 3; ++ky) {
      win[kz][ky][1] = xs[kz][r + ky][0];
      win[kz][ky][2] = xs[kz][r + ky][1];
    }
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    slide<KZ>(win, xs, r, c);
    float a = 0.f, b = 0.f;
#pragma unroll
    for (int kz = 0; kz < KZ; ++kz)
#pragma unroll
      for (int ky = 0; ky < 3; ++ky)
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          const int t = (kz * 3 + ky) * 3 + kx;
          a = fmaf(win[kz][ky][kx], wa[t], a);
          b = fmaf(win[kz][ky][kx], wb[t], b);
        }
    const int ww = w0 + c;
    if (h < H && ww < W && co < CO) {
      T* yp = y + (((size_t)n * H + h) * W + ww) * CO + co;
      if (pairs) {
        store_pair(yp, a, b);
      } else {
        store_one(yp, a);
        if (co + 1 < CO) store_one(yp + 1, b);
      }
    }
  }
}

template <typename T, int KZ>
__global__ void __launch_bounds__(kThreads)
c1_wgrad_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                float* __restrict__ part, int depth, int H, int W, int CO,
                int tiles_w, int tiles_per_plane, int n_tiles, int splits) {
  constexpr int kTaps = KZ * 9;
  constexpr int kWarps = kThreads / 32;
  __shared__ float xs[KZ][kHaloH][kHaloW];
  __shared__ float red[kWarps][kTaps][kCoT];
  const int g = threadIdx.x % kPairs;
  const int co = blockIdx.y * kCoT + 2 * g;
  const int r = threadIdx.x / kPairs;
  const bool pairs = (CO & 1) == 0;

  float acc[kTaps][2];
#pragma unroll
  for (int t = 0; t < kTaps; ++t) acc[t][0] = acc[t][1] = 0.f;

  for (int tile = blockIdx.x; tile < n_tiles; tile += splits) {
    const int n = tile / tiles_per_plane;
    const int tt = tile % tiles_per_plane;
    const int h0 = (tt / tiles_w) * kRows;
    const int w0 = (tt % tiles_w) * kCols;
    __syncthreads();
    stage_halo<T, KZ>(xs, x, n, depth, H, W, h0, w0);
    __syncthreads();
    const int h = h0 + r;
    const T* dp = dy + ((size_t)n * H + h) * W * CO + co;
    float win[KZ][3][3];
#pragma unroll
    for (int kz = 0; kz < KZ; ++kz)
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
        win[kz][ky][1] = xs[kz][r + ky][0];
        win[kz][ky][2] = xs[kz][r + ky][1];
      }
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      slide<KZ>(win, xs, r, c);
      const int ww = w0 + c;
      float2 v = make_float2(0.f, 0.f);
      if (h < H && ww < W && co < CO) {
        const T* p = dp + (size_t)ww * CO;
        if (pairs) {
          v = load_pair(p);
        } else {
          v.x = to_f32(p[0]);
          if (co + 1 < CO) v.y = to_f32(p[1]);
        }
      }
#pragma unroll
      for (int kz = 0; kz < KZ; ++kz)
#pragma unroll
        for (int ky = 0; ky < 3; ++ky)
#pragma unroll
          for (int kx = 0; kx < 3; ++kx) {
            const int t = (kz * 3 + ky) * 3 + kx;
            acc[t][0] = fmaf(win[kz][ky][kx], v.x, acc[t][0]);
            acc[t][1] = fmaf(win[kz][ky][kx], v.y, acc[t][1]);
          }
    }
  }

  // rows r and r + 1 of a warp hold the same channel pair: lanes g, g + 16
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int t = 0; t < kTaps; ++t) {
    acc[t][0] += __shfl_down_sync(0xffffffffu, acc[t][0], 16);
    acc[t][1] += __shfl_down_sync(0xffffffffu, acc[t][1], 16);
  }
  if (lane < 16) {
#pragma unroll
    for (int t = 0; t < kTaps; ++t) {
      red[warp][t][2 * g] = acc[t][0];
      red[warp][t][2 * g + 1] = acc[t][1];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kTaps * kCoT; i += kThreads) {
    const int t = i / kCoT, oc = blockIdx.y * kCoT + i % kCoT;
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) s += red[k][t][i % kCoT];
    if (oc < CO) part[((size_t)blockIdx.x * kTaps + t) * CO + oc] = s;
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

template <typename T, int KZ>
void launch_forward(const void* x, const void* w, void* y, int N, int depth,
                    int H, int W, int CO, cudaStream_t s) {
  const int tiles_w = (W + kCols - 1) / kCols;
  const int tiles_h = (H + kRows - 1) / kRows;
  const dim3 grid(tiles_h * tiles_w, (CO + kCoT - 1) / kCoT, N);
  c1_forward_kernel<T, KZ><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y),
      depth, H, W, CO, tiles_w);
}

template <typename T, int KZ>
void launch_wgrad(const void* x, const void* dy, float* part, int N,
                  int depth, int H, int W, int CO, int splits,
                  cudaStream_t s) {
  const int tiles_w = (W + kCols - 1) / kCols;
  const int tiles_per_plane = ((H + kRows - 1) / kRows) * tiles_w;
  const dim3 grid(splits, (CO + kCoT - 1) / kCoT);
  c1_wgrad_kernel<T, KZ><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), part, depth, H, W,
      CO, tiles_w, tiles_per_plane, N * tiles_per_plane, splits);
}

bool misaligned(const void* p) {
  return reinterpret_cast<uintptr_t>(p) & 15;
}

}  // namespace

// x (N, H, W, 1) and y (N, H, W, CO) NHWC, w (KZ, 3, 3, 1, CO), contiguous,
// one type: dtype 0 = float32, 1 = bfloat16; y 16-byte aligned (pair
// stores).  Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for arguments
// the kernel does not take).
extern "C" int dgtta_conv3x3_c1(const void* x, const void* w, void* y, int N,
                                int depth, int H, int W, int CO, int KZ,
                                int dtype, void* stream) {
  if (N <= 0 || depth <= 0 || N % depth != 0 || H <= 0 || W <= 0 || CO <= 0 ||
      (KZ != 1 && KZ != 3) || (dtype != 0 && dtype != 1) || N > 65535 ||
      misaligned(y))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (dtype == 0) {
    if (KZ == 3) launch_forward<float, 3>(x, w, y, N, depth, H, W, CO, s);
    else launch_forward<float, 1>(x, w, y, N, depth, H, W, CO, s);
  } else {
    if (KZ == 3) launch_forward<bf16, 3>(x, w, y, N, depth, H, W, CO, s);
    else launch_forward<bf16, 1>(x, w, y, N, depth, H, W, CO, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// x (N, H, W, 1) and dy (N, H, W, CO) contiguous, dy 16-byte aligned (pair
// loads), dtype
// 0 = float32, 1 = bfloat16; dw (KZ, 3, 3, 1, CO) f32; scratch holds
// splits * KZ*9*CO f32 (unused when splits == 1).  Block b of the first
// kernel sums the tiles b, b + splits, ...  Returns cudaGetLastError() after
// the launches (cudaErrorInvalidValue for arguments the kernels do not take).
extern "C" int dgtta_conv3x3_wgrad_c1(const void* x, const void* dy, void* dw,
                                      void* scratch, int N, int depth, int H,
                                      int W, int CO, int KZ, int splits,
                                      int dtype, void* stream) {
  if (N <= 0 || depth <= 0 || N % depth != 0 || H <= 0 || W <= 0 || CO <= 0 ||
      (KZ != 1 && KZ != 3) || splits <= 0 || (dtype != 0 && dtype != 1) ||
      (splits > 1 && scratch == nullptr) || misaligned(dy))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = splits == 1 ? static_cast<float*>(dw)
                            : static_cast<float*>(scratch);
  using bf16 = __nv_bfloat16;
  if (dtype == 0) {
    if (KZ == 3)
      launch_wgrad<float, 3>(x, dy, part, N, depth, H, W, CO, splits, s);
    else
      launch_wgrad<float, 1>(x, dy, part, N, depth, H, W, CO, splits, s);
  } else {
    if (KZ == 3)
      launch_wgrad<bf16, 3>(x, dy, part, N, depth, H, W, CO, splits, s);
    else
      launch_wgrad<bf16, 1>(x, dy, part, N, depth, H, W, CO, splits, s);
  }
  if (splits > 1) {
    const int m = KZ * 9 * CO;
    sum_splits_kernel<<<(m + 255) / 256, 256, 0, s>>>(
        part, static_cast<float*>(dw), m, splits);
  }
  return static_cast<int>(cudaGetLastError());
}
