// Warp-level building blocks of the catch-all conv kernels (conv3x3.cu:
// ldmatrix, cp.async, the tf32 split, the stores; conv3x3_wgrad.cu: also
// mma.sync), for sm_90a, and their split sum.
//
// Fragment layouts (lane l = 4 g + t of a warp):
//   bf16 m16n8k16: a[0] = A[g][2t, 2t+1], a[1] = A[g+8][2t, 2t+1],
//     a[2] = A[g][2t+8, 2t+9], a[3] = A[g+8][2t+8, 2t+9] (lower k in the
//     low half); b0 = B[2t, 2t+1][g], b1 = B[2t+8, 2t+9][g];
//   tf32 m16n8k8: a[0] = A[g][t], a[1] = A[g+8][t], a[2] = A[g][t+4],
//     a[3] = A[g+8][t+4]; b0 = B[t][g], b1 = B[t+4][g];
//   both: d[0, 1] = D[g][2t, 2t+1], d[2, 3] = D[g+8][2t, 2t+1].
// ldmatrix.x4 (16-bit elements, four 8 x 8 matrices whose row addresses
// lanes 8q .. 8q + 7 give for matrix q) hands lane l row g, elements 2t and
// 2t + 1 of each matrix, which on 32-bit data is element t of a 16-byte
// row: the A and B fragments of both types from rows of 16 bytes.  With
// .trans it hands elements (row 2t, column g) and (row 2t + 1, column g).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace dgtta_ms {

using dgtta::smem_u32;

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// D += A * B at f32 accuracy from tf32 parts (3xTF32): the two cross
// products first, then hi * hi.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           uint32_t bh0, uint32_t bh1,
                                           uint32_t bl0, uint32_t bl1) {
  mma_tf32(d, al, bh0, bh1);
  mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);
}

// hi = v rounded to tf32 (hopper.cuh's round_tf32: the bits of
// kernels/conv3x3.py::tf32_split), lo = v - hi (exact; the tensor core
// truncates it to tf32).
__device__ __forceinline__ void split_tf32(uint32_t v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = dgtta::round_tf32(__uint_as_float(v));
  lo = __float_as_uint(__uint_as_float(v) - __uint_as_float(hi));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

// V bytes (4, 8 or 16) from global to shared memory, asynchronously; zeros
// where !ok (src is then not read).  V = 2 has no cp.async: a plain load
// and store.
template <int V>
__device__ __forceinline__ void copy_async(void* dst, const void* src,
                                           bool ok) {
  if constexpr (V == 2) {
    *static_cast<uint16_t*>(dst) =
        ok ? *static_cast<const uint16_t*>(src) : uint16_t(0);
  } else if constexpr (V == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "r"(ok ? 16 : 0)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "n"(V), "r"(ok ? V : 0)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Two neighbouring channels co, co + 1 of one output row p (co even): one
// 4-byte (bf16) or 8-byte (f32) store where both exist and CO is even (the
// pair is then aligned), else each channel below CO alone.
template <typename T>
__device__ __forceinline__ void store2(T* p, int co, int CO, float v0,
                                       float v1) {
  if (co + 1 < CO && (CO & 1) == 0) {
    if constexpr (sizeof(T) == 2) {
      *reinterpret_cast<__nv_bfloat162*>(p + co) =
          __floats2bfloat162_rn(v0, v1);
    } else {
      *reinterpret_cast<float2*>(p + co) = make_float2(v0, v1);
    }
  } else {
    if (co < CO) p[co] = from_f32<T>(v0);
    if (co + 1 < CO) p[co + 1] = from_f32<T>(v1);
  }
}

// out[m E + e] = the sum over k < P of part[(m P + k) E + e], k in order,
// in out's type: the partial sums of a split launch added in a fixed order
// (no atomics), m < members.
template <typename T>
__global__ void sum_splits_kernel(const float* __restrict__ part,
                                  T* __restrict__ out, long long E,
                                  int members, int P) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= E * members) return;
  const float* p = part + i / E * P * E + i % E;
  float s = 0.f;
  for (int k = 0; k < P; ++k) s += p[(size_t)k * E];
  out[i] = from_f32<T>(s);
}

template <typename T>
inline void sum_splits(const float* part, T* out, long long E, int members,
                       int P, cudaStream_t stream) {
  const int threads = 256;
  sum_splits_kernel<T>
      <<<(unsigned)((E * members + threads - 1) / threads), threads, 0,
         stream>>>(part, out, E, members, P);
}

}  // namespace dgtta_ms
