// pairwise_lp: D[i, j] = max(na[i] + nb[j] + sum_K A[i, :] * B[j, :], 0),
// the packed all-pairs l_p estimate with its margin epilogue, in fp32.
//
// Replaces the Pallas TPU kernel pairwise_lp_kernel / pairwise_lp_call in
// src/repro/kernels/pairwise_lp/kernel.py (every query strip of the engine).
//
// Bound on an H100: operations.  A strip is 2 * n * m * K fp32 FLOPs on the
// CUDA cores (IEEE fp32, no TF32: the port is held against the fp32
// reference) against (n + m) * K + n * m words moved; at the main path's
// 2048 x 2048 x 768 strips that is ~190 FLOPs a byte, far above the fp32
// ridge of ~20.
//
// Design: one block per 128 x 128 output tile, 256 threads, each thread
// an 8 x 8 micro-tile in registers (64 FMAs per 4 float4 shared-memory
// reads).  The TPU's sequential K grid axis becomes a loop inside the
// block: each step stages an 8-deep slice of A and B in shared memory,
// transposed to K-major so a thread reads its rows and columns as float4s
// (the two halves of a thread's 8 rows and 8 columns sit 64 apart, which
// keeps a warp's reads free of bank conflicts).  Ragged n, m and K are
// masked (zero fill), never padded in memory.  The epilogue adds the
// margins and clips in registers, so the estimate leaves the block once,
// already final.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kBM = 128;  // rows of A per block
constexpr int kBN = 128;  // rows of B per block
constexpr int kBK = 8;    // depth (K) per step
constexpr int kThreads = 256;
constexpr int kHalf = 64;  // a thread's rows are {ty*4 + i} and {64 + ty*4 + i}
constexpr int kPad = 4;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T, bool CLIP>
__global__ void __launch_bounds__(kThreads)
pairwise_lp_kernel(const T* __restrict__ A, const T* __restrict__ B,
                   const float* __restrict__ na, const float* __restrict__ nb,
                   float* __restrict__ out, int n, int m, int K) {
  __shared__ __align__(16) float as[kBK][kBM + kPad];  // [k][row of A]
  __shared__ __align__(16) float bs[kBK][kBN + kPad];  // [k][row of B]

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int row0 = blockIdx.y * kBM;
  const int col0 = blockIdx.x * kBN;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
#pragma unroll
    for (int t = 0; t < (kBM * kBK) / kThreads; ++t) {
      const int idx = tid + t * kThreads;
      const int r = idx / kBK, c = idx % kBK;
      const int gk = k0 + c;
      const int ga = row0 + r, gb = col0 + r;
      as[c][r] = (ga < n && gk < K) ? to_f32(A[(size_t)ga * K + gk]) : 0.f;
      bs[c][r] = (gb < m && gk < K) ? to_f32(B[(size_t)gb * K + gk]) : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&as[kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&as[kk][kHalf + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&bs[kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&bs[kk][kHalf + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gr = row0 + (i < 4 ? ty * 4 + i : kHalf + ty * 4 + i - 4);
    if (gr >= n) continue;
    const float ma = na[gr];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int gc = col0 + (j < 4 ? tx * 4 + j : kHalf + tx * 4 + j - 4);
      if (gc >= m) continue;
      float v = (ma + nb[gc]) + acc[i][j];  // the reference's (na + nb) + A.B order
      if (CLIP && v < 0.f) v = 0.f;         // NaN passes through, as in max(v, 0)
      out[(size_t)gr * m + gc] = v;
    }
  }
}

template <typename T>
cudaError_t launch(const void* A, const void* B, const float* na, const float* nb,
                   float* out, int n, int m, int K, bool clip, cudaStream_t stream) {
  const dim3 grid((m + kBN - 1) / kBN, (n + kBM - 1) / kBM);
  const T* a = static_cast<const T*>(A);
  const T* b = static_cast<const T*>(B);
  if (clip)
    pairwise_lp_kernel<T, true><<<grid, kThreads, 0, stream>>>(a, b, na, nb, out, n, m, K);
  else
    pairwise_lp_kernel<T, false><<<grid, kThreads, 0, stream>>>(a, b, na, nb, out, n, m, K);
  return cudaGetLastError();
}

}  // namespace

// A (n, K) and B (m, K) row-major, both fp32 (bf16 = 0) or both bf16
// (bf16 = 1); na (n,), nb (m,) fp32; out (n, m) row-major fp32, written in
// full.  Launches on `stream` and returns the launch's cudaError_t.
extern "C" int pairwise_lp_launch(const void* A, const void* B, int bf16,
                                  const float* na, const float* nb, float* out,
                                  int n, int m, int K, int clip, void* stream) {
  if (n < 1 || m < 1 || K < 0 || (n + kBM - 1) / kBM > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(A, B, na, nb, out, n, m, K, clip != 0, st)
              : launch<float>(A, B, na, nb, out, n, m, K, clip != 0, st);
}

extern "C" const char* pairwise_lp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
