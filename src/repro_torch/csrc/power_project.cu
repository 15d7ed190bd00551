// power_project: U[:, s, :] = (X ** powers[s]) @ R, accumulated in fp32.
//
// Replaces the Pallas TPU kernel power_project_kernel / power_project_call
// in src/repro/kernels/power_project/kernel.py (the sketch's linear scan).
//
// Bound on an H100: operations.  The work is 2 * n * D * k * len(powers)
// fp32 FLOPs on the CUDA cores (no tensor cores: the port keeps IEEE fp32),
// against n*D + D*k + n*len(powers)*k words moved; at the main path's
// shapes (n=4096, D=16384, k=256, three powers) that is ~77 FLOPs a byte,
// well above the card's fp32 ridge of ~20.
//
// Design: one block owns a 64 x 64 tile of (rows of X) x (columns of R)
// for every power.  The TPU's sequential D grid axis becomes a loop inside
// the block.  Each step stages a 64 x 16 tile of X in shared memory already
// raised to each power (so each X element is read from memory once per
// block and its powers are formed once, incrementally, in registers), plus
// the 16 x 64 R tile, and every thread accumulates a 4 x 4 micro-tile per
// power in registers.  Each step's shared-memory reads are one float4 of R and one
// float4 per power, for 16 FMAs per power.  Ragged n, D and k are masked
// (zero fill), never padded in memory: 0 ** e = 0 adds nothing.  Blocks
// with the same rows of X run next to each other, so X tiles are reused
// from L2.  The number of powers is a template parameter (1..7, p <= 8).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kBM = 64;  // rows of X per block
constexpr int kBN = 64;  // columns of R per block
constexpr int kBK = 16;  // depth (D) per step
constexpr int kTM = 4;   // rows per thread
constexpr int kTN = 4;   // columns per thread
constexpr int kThreads = (kBM / kTM) * (kBN / kTN);  // 256
constexpr int kMaxPowers = 7;
constexpr int kPad = 4;  // keeps float4 rows aligned, spreads banks

struct Powers {
  int e[kMaxPowers];
  int max_e;  // the largest exponent
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T, int NP>
__global__ void __launch_bounds__(kThreads)
power_project_kernel(const T* __restrict__ X, const float* __restrict__ R,
                     float* __restrict__ U, int n, int D, int k, Powers powers) {
  __shared__ __align__(16) float xs[NP][kBK][kBM + kPad];  // x^e, [power][d][row]
  __shared__ __align__(16) float rs[kBK][kBN];             // R tile, [d][col]

  const int tid = threadIdx.x;
  const int tx = tid % (kBN / kTN);
  const int ty = tid / (kBN / kTN);
  const int row0 = blockIdx.y * kBM;
  const int col0 = blockIdx.x * kBN;

  float acc[NP][kTM][kTN];
#pragma unroll
  for (int s = 0; s < NP; ++s)
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) acc[s][i][j] = 0.f;

  for (int d0 = 0; d0 < D; d0 += kBK) {
#pragma unroll
    for (int t = 0; t < (kBM * kBK) / kThreads; ++t) {
      const int idx = tid + t * kThreads;
      const int r = idx / kBK, c = idx % kBK;
      const int gr = row0 + r, gc = d0 + c;
      const float x = (gr < n && gc < D) ? to_f32(X[(size_t)gr * D + gc]) : 0.f;
      // x ** j formed incrementally, each power once, as the TPU kernel does;
      // the powers may come in any order ((3, 1) for the alternative strategy)
      float xp = x;
      for (int j = 1; j <= powers.max_e; ++j) {
#pragma unroll
        for (int s = 0; s < NP; ++s)
          if (powers.e[s] == j) xs[s][c][r] = xp;
        xp *= x;
      }
    }
#pragma unroll
    for (int t = 0; t < (kBK * kBN) / kThreads; ++t) {
      const int idx = tid + t * kThreads;
      const int r = idx / kBN, c = idx % kBN;
      const int gr = d0 + r, gc = col0 + c;
      rs[r][c] = (gr < D && gc < k) ? R[(size_t)gr * k + gc] : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 b4 = *reinterpret_cast<const float4*>(&rs[kk][tx * kTN]);
      const float b[kTN] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int s = 0; s < NP; ++s) {
        const float4 a4 = *reinterpret_cast<const float4*>(&xs[s][kk][ty * kTM]);
        const float a[kTM] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
        for (int i = 0; i < kTM; ++i)
#pragma unroll
          for (int j = 0; j < kTN; ++j) acc[s][i][j] = fmaf(a[i], b[j], acc[s][i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int gr = row0 + ty * kTM + i;
    if (gr >= n) continue;
#pragma unroll
    for (int s = 0; s < NP; ++s) {
      float* out = U + ((size_t)gr * NP + s) * k;
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const int gc = col0 + tx * kTN + j;
        if (gc < k) out[gc] = acc[s][i][j];
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* X, const float* R, float* U, int n, int D, int k,
                   const Powers& powers, int np, cudaStream_t stream) {
  const dim3 grid((k + kBN - 1) / kBN, (n + kBM - 1) / kBM);
  const T* x = static_cast<const T*>(X);
  switch (np) {
    case 1: power_project_kernel<T, 1><<<grid, kThreads, 0, stream>>>(x, R, U, n, D, k, powers); break;
    case 2: power_project_kernel<T, 2><<<grid, kThreads, 0, stream>>>(x, R, U, n, D, k, powers); break;
    case 3: power_project_kernel<T, 3><<<grid, kThreads, 0, stream>>>(x, R, U, n, D, k, powers); break;
    case 4: power_project_kernel<T, 4><<<grid, kThreads, 0, stream>>>(x, R, U, n, D, k, powers); break;
    case 5: power_project_kernel<T, 5><<<grid, kThreads, 0, stream>>>(x, R, U, n, D, k, powers); break;
    case 6: power_project_kernel<T, 6><<<grid, kThreads, 0, stream>>>(x, R, U, n, D, k, powers); break;
    case 7: power_project_kernel<T, 7><<<grid, kThreads, 0, stream>>>(x, R, U, n, D, k, powers); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// X (n, D) row-major, fp32 (x_bf16 = 0) or bf16 (x_bf16 = 1); R (D, k)
// row-major fp32; U (n, np, k) row-major fp32, written in full.  Launches on
// `stream` and returns the launch's cudaError_t (0 when it was accepted).
extern "C" int power_project_launch(const void* X, int x_bf16, const float* R,
                                    float* U, int n, int D, int k,
                                    const int* powers, int np, void* stream) {
  if (np < 1 || np > kMaxPowers || n < 1 || k < 1 || D < 0 ||
      (n + kBM - 1) / kBM > 65535)
    return cudaErrorInvalidValue;
  Powers pw = {};
  for (int s = 0; s < np; ++s) {
    if (powers[s] < 1) return cudaErrorInvalidValue;
    pw.e[s] = powers[s];
    pw.max_e = powers[s] > pw.max_e ? powers[s] : pw.max_e;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return x_bf16 ? launch<__nv_bfloat16>(X, R, U, n, D, k, pw, np, st)
                : launch<float>(X, R, U, n, D, k, pw, np, st);
}

extern "C" const char* power_project_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
