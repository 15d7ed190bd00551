// pairwise_lp: D[i, j] = max(na[i] + nb[j] + sum_K A[i, :] * B[j, :], 0),
// the packed all-pairs l_p estimate with its margin epilogue, in fp32.
//
// Replaces the Pallas TPU kernel pairwise_lp_kernel / pairwise_lp_call in
// src/repro/kernels/pairwise_lp/kernel.py (every query strip of the engine).
//
// Bound on an H100, by route: operations.  A strip is 2 * n * m * K FLOPs
// against (n + m) * K + n + m + n * m words moved.  At the main path's
// 2048 x 2048 x 768 strips that is 6.44 GFLOP: 0.096 ms on the CUDA cores in
// fp32 (67 TFLOP/s), 0.039 ms as the three TF32 products per product of this
// kernel (tf32x3.cuh) at 495 TFLOP/s; the 29.4 MB it moves take 0.0088 ms.
//
// Design: GEMM with M = n, N = m, K = K on the tensor cores through
// tf32x3.cuh (3xTF32 mma.sync behind a 3-stage cp.async ring).  A and B are
// both K-contiguous, the natural row.col case: both tiles stay
// [row][depth] in shared memory.  One block per 128 x 128 output tile,
// 8 warps of 64 x 32 (64 running sums a thread and 32 for a half's slice),
// one block an SM (ptxas -v: 181 to 228 registers, no spills; 108 KB of
// shared memory for float32), so a 2048 x 2048 strip is 256 blocks in two
// waves.  Capped at two blocks an SM (128 registers) the fresh slices
// spilled 440 to 468 bytes and took 0.1428 ms a strip against 0.1105 ms
// here; one running sum at two blocks an SM took 0.0997 ms, so the fresh
// slices cost a tenth of the time for a quarter of the error
// (tools/torch_kernel_ab.py on an H100 80GB HBM3 at 700 W).  Float32
// fragments are read with ldmatrix and split in registers.  bfloat16 factors are exact in
// TF32, so their products take one MMA, not three.  The tensor cores round
// their sums toward zero: summed into one running sum over the 288 MMAs of
// a K = 768 depth (3 a step), A.B leaned toward zero by up to 4.7e-7 of
// the largest sum of |terms| on the card, against 1.2e-7 now.  So each half of the
// warp's rows (two row tiles) sums a 32-deep slice from zero and adds it
// to its running sums in IEEE float32, as power_project does; a depth
// step's B fragments are then read and split once for each half.
// The epilogue adds the margins and clips in registers, so each estimate
// leaves the block once, already final, in the reference's
// (na + nb) + A.B order.  Ragged n, m and K are zero-filled by the copies,
// never padded in memory.

#include "tf32x3.cuh"

namespace {

using namespace tf32x3;

constexpr int kBM = 128;  // rows of A per block
constexpr int kBN = 128;  // rows of B per block
constexpr int kBK = 32;   // depth (K) per ring slot
constexpr int kStages = 3;
constexpr int kThreads = 256;  // 8 warps: 2 (rows) x 4 (columns), 64 x 32 each

template <typename T>
constexpr int kTileBytes = kBM * kLd<T, kBK> * sizeof(T);
template <typename T>
constexpr int kSmem = kStages * 2 * kTileBytes<T>;

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads, 1)
pairwise_lp_kernel(const T* __restrict__ A, const T* __restrict__ B,
                   const float* __restrict__ na, const float* __restrict__ nb,
                   float* __restrict__ out, int n, int m, int K, bool clip) {
  // float32 factors are split into three TF32 products; bf16 ones are exact
  constexpr bool kSplit = sizeof(T) == 4;
  constexpr int kLdT = kLd<T, kBK>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* as = reinterpret_cast<T*>(smem);
  T* bs = reinterpret_cast<T*>(smem + kStages * kTileBytes<T>);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.y * kBM, col0 = blockIdx.x * kBN;

  // acc[h][i][j]: row tile 2h + i, column tile j of the warp's 64 x 32
  float acc[2][2][4][4];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[h][i][j][q] = 0.f;

  auto load = [&](int slot, int tile) {
    const int k0 = tile * kBK;
    load_rows<T, kBM, kBK, kThreads, VEC>(as + slot * kBM * kLdT, A, row0, n, k0, K, tid);
    load_rows<T, kBN, kBK, kThreads, VEC>(bs + slot * kBN * kLdT, B, col0, m, k0, K, tid);
  };
  auto compute = [&](int slot) {
    const T* at = as + slot * kBM * kLdT;
    const T* bt = bs + slot * kBN * kLdT;
    // the warp's rows in two halves of 32, which bounds the live registers;
    // each half's products over the slice are summed from zero on the
    // tensor cores and then added to its running sums in IEEE float32
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float part[2][1][4][4] = {};
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 8) {
        uint32_t b_big[4][2], b_small[4][2];
        if constexpr (kSplit) {
#pragma unroll
          for (int j = 0; j < 4; j += 2) ldsm_b2<kLdT>(b_big[j], b_big[j + 1], bt, wn + j * 8, kk, lane);
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int q = 0; q < 2; ++q) split(__uint_as_float(b_big[j][q]), b_big[j][q], b_small[j][q]);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float b[2];
            load_b<kLdT>(b, bt, wn + j * 8, kk, lane);
            b_big[j][0] = __float_as_uint(b[0]);
            b_big[j][1] = __float_as_uint(b[1]);
          }
        }
        // one row tile at a time, so that only its A fragment is live
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          uint32_t a_big[1][4], a_small[1][4];
          if constexpr (kSplit) {
            ldsm_a<kLdT>(a_big[0], at, wm + (2 * h + i) * 16, kk, lane);
#pragma unroll
            for (int q = 0; q < 4; ++q) split(__uint_as_float(a_big[0][q]), a_big[0][q], a_small[0][q]);
          } else {
            float a[4];
            load_a<kLdT>(a, at, wm + (2 * h + i) * 16, kk, lane);
#pragma unroll
            for (int q = 0; q < 4; ++q) a_big[0][q] = __float_as_uint(a[q]);
          }
          mma_tiles<kSplit>(part[i], a_big, a_small, b_big, b_small);
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[h][i][j][q] += part[i][0][j][q];
    }
  };
  ring<kStages>((K + kBK - 1) / kBK, load, compute);

  float mb[4][2];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int c = col0 + wn + j * 8 + 2 * t + q;
      mb[j][q] = c < m ? nb[c] : 0.f;
    }
  const bool pairs = (m & 1) == 0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + wm + i * 16 + g + 8 * h;
      if (r >= n) continue;
      const float(&c)[4][4] = acc[i / 2][i % 2];
      const float ma = na[r];
      float* row = out + (size_t)r * m;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float v[2];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          v[q] = (ma + mb[j][q]) + c[j][2 * h + q];  // the reference's order
          if (clip && v[q] < 0.f) v[q] = 0.f;  // NaN passes through, as in max(v, 0)
        }
        store2(row, col0 + wn + j * 8 + 2 * t, m, pairs, v[0], v[1]);
      }
    }
}

template <typename T, bool VEC>
cudaError_t run(const T* A, const T* B, const float* na, const float* nb, float* out,
                int n, int m, int K, bool clip, cudaStream_t stream) {
  auto kernel = pairwise_lp_kernel<T, VEC>;
  static SmemGrant grant;
  cudaError_t e = grant.allow(kernel, kSmem<T>);
  if (e != cudaSuccess) return e;
  const dim3 grid((m + kBN - 1) / kBN, (n + kBM - 1) / kBM);
  kernel<<<grid, kThreads, kSmem<T>, stream>>>(A, B, na, nb, out, n, m, K, clip);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* A, const void* B, const float* na, const float* nb,
                   float* out, int n, int m, int K, bool clip, cudaStream_t stream) {
  const T* a = static_cast<const T*>(A);
  const T* b = static_cast<const T*>(B);
  const bool vec = K % (16 / sizeof(T)) == 0 && aligned16(A) && aligned16(B);
  return vec ? run<T, true>(a, b, na, nb, out, n, m, K, clip, stream)
             : run<T, false>(a, b, na, nb, out, n, m, K, clip, stream);
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
