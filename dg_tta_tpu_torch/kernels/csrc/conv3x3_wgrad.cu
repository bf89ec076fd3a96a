// Weight gradient of the stride-1 3x3(x3) convolution of conv3x3.cu, for
// sm_90a.
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
// bf16 (NHWC, N = batch * depth), the sums and dW are f32.
//
// What bounds it on an H100: at the U-Net's widths a conv's weight gradient
// does 2*27*C*CO operations per position against (C + CO) elements read,
// hundreds of operations per byte, so it is bound by arithmetic, run here
// as f32 FMAs on the CUDA cores (67 TFLOP/s peak).  The sum runs over every
// position (3.2M at the first stage of a two-patch batch, a few hundred at
// the 7 x 8 level) while the output is small (27*C*CO), so the positions
// are split across blocks (split-K).
//
// What the design does about it: a block owns one z-tap kz, a TC slice of
// input channels and a 32-channel slice of output channels, for all nine
// (ky, kx) taps, and a contiguous range of 4 x 16 position tiles.  Per tile
// it stages the zero-padded 6 x 18 halo of x (plane n + kz - KZ/2) and the
// 4 x 16 tile of dy in shared memory, once for all nine taps; each thread
// owns one tap and a 4 x 8 (ci, co) register tile, so per position three
// 16-byte shared-memory loads feed 32 FMAs.  Each block writes its partial
// sums to its own slice of a scratch buffer, and a second kernel adds the
// slices in a fixed order: the result does not depend on scheduling (no
// atomics).  With one split the first kernel writes dW directly.  Ragged
// planes, channel counts and C = 1 (TC = 4) are masked with zeros on load
// and skipped on store; a tile whose x plane lies outside the group is
// skipped by the whole block.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kTileH = 4;
constexpr int kTileW = 16;
constexpr int kHaloH = kTileH + 2;
constexpr int kHaloW = kTileW + 2;
constexpr int kPos = kTileH * kTileW;
constexpr int kTco = 32;   // output channels per block
constexpr int kCiT = 4;    // input channels per thread
constexpr int kCoT = 8;    // output channels per thread

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <int TC>
struct Shape {
  static constexpr int kThreadsPerTap = (TC / kCiT) * (kTco / kCoT);
  static constexpr int kThreads = 9 * kThreadsPerTap;
};

template <typename T, int TC>
__global__ void __launch_bounds__(Shape<TC>::kThreads)
wgrad_kernel(const T* __restrict__ x, const T* __restrict__ dy,
             float* __restrict__ part, int N, int depth, int H, int W, int C,
             int CO, int KZ, int tiles_w, int tiles_per_plane,
             int tiles_per_split) {
  constexpr int kThreads = Shape<TC>::kThreads;
  constexpr int kPerTap = Shape<TC>::kThreadsPerTap;
  __shared__ __align__(16) float xs[kHaloH * kHaloW][TC];
  __shared__ __align__(16) float ds[kPos][kTco];

  const int ci_tiles = (C + TC - 1) / TC;
  const int kz = blockIdx.y / ci_tiles;
  const int ci0 = (blockIdx.y % ci_tiles) * TC;
  const int co0 = blockIdx.z * kTco;
  const int dz = kz - KZ / 2;

  const int tid = threadIdx.x;
  const int tap = tid / kPerTap;
  const int ky = tap / 3, kx = tap % 3;
  const int cig = (tid % kPerTap) / (kTco / kCoT);
  const int cog = tid % (kTco / kCoT);

  float acc[kCiT][kCoT];
#pragma unroll
  for (int i = 0; i < kCiT; ++i)
#pragma unroll
    for (int j = 0; j < kCoT; ++j) acc[i][j] = 0.f;

  const int n_tiles = N * tiles_per_plane;
  const int t_begin = blockIdx.x * tiles_per_split;
  const int t_end = min(n_tiles, t_begin + tiles_per_split);
  for (int t = t_begin; t < t_end; ++t) {
    const int n = t / tiles_per_plane;
    const int d = n % depth;
    if (d + dz < 0 || d + dz >= depth) continue;  // uniform over the block
    const int tt = t % tiles_per_plane;
    const int h0 = (tt / tiles_w) * kTileH;
    const int w0 = (tt % tiles_w) * kTileW;
    const T* xp = x + (size_t)(n + dz) * H * W * C;
    const T* dp = dy + (size_t)n * H * W * CO;

    __syncthreads();
    for (int i = tid; i < kHaloH * kHaloW * TC; i += kThreads) {
      const int ci = i % TC;
      const int p = i / TC;
      const int hh = h0 + p / kHaloW - 1, ww = w0 + p % kHaloW - 1;
      const int cc = ci0 + ci;
      float v = 0.f;
      if (hh >= 0 && hh < H && ww >= 0 && ww < W && cc < C)
        v = to_f32(xp[((size_t)hh * W + ww) * C + cc]);
      xs[p][ci] = v;
    }
    for (int i = tid; i < kPos * kTco; i += kThreads) {
      const int co = i % kTco;
      const int p = i / kTco;
      const int hh = h0 + p / kTileW, ww = w0 + p % kTileW;
      const int oc = co0 + co;
      float v = 0.f;
      if (hh < H && ww < W && oc < CO)
        v = to_f32(dp[((size_t)hh * W + ww) * CO + oc]);
      ds[p][co] = v;
    }
    __syncthreads();

#pragma unroll 4
    for (int p = 0; p < kPos; ++p) {
      const int hp = (p / kTileW + ky) * kHaloW + p % kTileW + kx;
      const float4 xv = *reinterpret_cast<const float4*>(&xs[hp][cig * kCiT]);
      const float4 da = *reinterpret_cast<const float4*>(&ds[p][cog * kCoT]);
      const float4 db =
          *reinterpret_cast<const float4*>(&ds[p][cog * kCoT + 4]);
      const float xa[kCiT] = {xv.x, xv.y, xv.z, xv.w};
      const float dv[kCoT] = {da.x, da.y, da.z, da.w, db.x, db.y, db.z, db.w};
#pragma unroll
      for (int i = 0; i < kCiT; ++i)
#pragma unroll
        for (int j = 0; j < kCoT; ++j)
          acc[i][j] = fmaf(xa[i], dv[j], acc[i][j]);
    }
  }

  float* out = part + (size_t)blockIdx.x * KZ * 9 * C * CO +
               (size_t)(kz * 9 + tap) * C * CO;
#pragma unroll
  for (int i = 0; i < kCiT; ++i) {
    const int ci = ci0 + cig * kCiT + i;
    if (ci >= C) continue;
#pragma unroll
    for (int j = 0; j < kCoT; ++j) {
      const int co = co0 + cog * kCoT + j;
      if (co < CO) out[(size_t)ci * CO + co] = acc[i][j];
    }
  }
}

__global__ void sum_splits_kernel(const float* __restrict__ part,
                                  float* __restrict__ dw, long long m,
                                  int splits) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += part[(size_t)k * m + i];
  dw[i] = s;
}

template <typename T, int TC>
void launch(const void* x, const void* dy, float* part, int N, int depth,
            int H, int W, int C, int CO, int KZ, int splits,
            cudaStream_t stream) {
  const int tiles_w = (W + kTileW - 1) / kTileW;
  const int tiles_per_plane = ((H + kTileH - 1) / kTileH) * tiles_w;
  const int n_tiles = N * tiles_per_plane;
  const int tiles_per_split = (n_tiles + splits - 1) / splits;
  const dim3 grid(splits, KZ * ((C + TC - 1) / TC), (CO + kTco - 1) / kTco);
  wgrad_kernel<T, TC><<<grid, Shape<TC>::kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), part, N, depth, H,
      W, C, CO, KZ, tiles_w, tiles_per_plane, tiles_per_split);
}

}  // namespace

// x (N, H, W, C), dy (N, H, W, CO) contiguous, dtype 0 = float32,
// 1 = bfloat16; dw (KZ, 3, 3, C, CO) f32; scratch holds splits * KZ*9*C*CO
// f32 (unused when splits == 1).  C <= 4 runs the 4-channel tile, wider C
// the 32-channel tile.  Returns cudaGetLastError() after the launches
// (cudaErrorInvalidValue for arguments the kernels do not take).
extern "C" int dgtta_conv3x3_wgrad(const void* x, const void* dy, void* dw,
                                   void* scratch, int N, int depth, int H,
                                   int W, int C, int CO, int KZ, int splits,
                                   int dtype, void* stream) {
  if (N <= 0 || depth <= 0 || N % depth != 0 || H <= 0 || W <= 0 || C <= 0 ||
      CO <= 0 || (KZ != 1 && KZ != 3) || splits <= 0 ||
      (dtype != 0 && dtype != 1) || (splits > 1 && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = splits == 1 ? static_cast<float*>(dw)
                            : static_cast<float*>(scratch);
  const bool narrow = C <= 4;
  if (dtype == 0) {
    if (narrow)
      launch<float, 4>(x, dy, part, N, depth, H, W, C, CO, KZ, splits, s);
    else
      launch<float, 32>(x, dy, part, N, depth, H, W, C, CO, KZ, splits, s);
  } else {
    if (narrow)
      launch<__nv_bfloat16, 4>(x, dy, part, N, depth, H, W, C, CO, KZ,
                               splits, s);
    else
      launch<__nv_bfloat16, 32>(x, dy, part, N, depth, H, W, C, CO, KZ,
                                splits, s);
  }
  if (splits > 1) {
    const long long m = (long long)KZ * 9 * C * CO;
    const int threads = 256;
    sum_splits_kernel<<<(unsigned)((m + threads - 1) / threads), threads, 0,
                        s>>>(part, static_cast<float*>(dw), m, splits);
  }
  return static_cast<int>(cudaGetLastError());
}
