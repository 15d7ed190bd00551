// power_project: U[:, s, :] = (X ** powers[s]) @ R, accumulated in fp32.
//
// Replaces the Pallas TPU kernel power_project_kernel / power_project_call
// in src/repro/kernels/power_project/kernel.py (the sketch's linear scan).
//
// Bound on an H100, by route: operations.  The work is 2 * n * D * k *
// len(powers) FLOPs against n*D + D*k + n*len(powers)*k words moved.  At
// the main path's shapes (n=4096, D=16384, k=256, three powers) that is
// 103.1 GFLOP: 1.54 ms on the CUDA cores in fp32 (67 TFLOP/s), 0.625 ms
// as the three TF32 products per product of this kernel (tf32x3.cuh) at
// 495 TFLOP/s; the 297 MB it moves take 0.089 ms.
//
// Design: GEMM with M = rows of X, N = columns of R, K = D, on the tensor
// cores through tf32x3.cuh (3xTF32 mma.sync behind a 4-stage cp.async ring
// of 32-deep slices).  One block owns a 64 x 128 tile of (rows of X) x
// (columns of R) for up to three powers (more powers take more blocks on
// grid z, or a second launch for the last one or two), so each element of
// X is read from device memory once per block for all of its powers, as
// the Pallas kernel does.  When a slice lands, the block splits it once:
// each X element is raised to every exponent of the block (runtime
// exponents in any order, such as (3, 1) or (2, 2)) and each power split
// into big + small, 16 bytes a thread, into split tiles in shared memory;
// R, which is N-contiguous (D, k), is split and transposed to [col][d] on
// the way.  Splitting once per block and not once per warp matters: each
// X element feeds 4 warps and each R element 2.  The warps then read
// whole fragments with ldmatrix and run three MMAs per product.  Each
// power's slice is summed from zero on the tensor cores and added to the
// running sum in IEEE float32 (the MMA rounds toward zero, which over
// 16,384-deep sums into one accumulator would cost far more than the
// 3xTF32 split).  8 warps of 32 x 32 each; 96 running sums a thread
// (3 powers x 2 x 4 MMA tiles x 4).  At the main path's shapes the grid is
// 2 x 64 = 128 blocks on 132 SMs, one block an SM: ptxas -v gives the
// float32, three-power instantiation 255 registers and 16 bytes of spill
// stores and loads, and it takes 194 KB of shared memory.  Ragged n, D and
// k are zero-filled by the copies (0 ** e = 0 adds nothing), never padded
// in memory.

#include "tf32x3.cuh"

namespace {

using namespace tf32x3;

constexpr int kBM = 64;   // rows of X per block
constexpr int kBN = 128;  // columns of R per block
constexpr int kBK = 32;   // depth (D) per ring slot
constexpr int kStages = 4;
constexpr int kThreads = 256;  // 8 warps: 2 (rows) x 4 (columns), 32 x 32 each
constexpr int kChunk = 3;      // powers per block
constexpr int kMaxPowers = 7;
constexpr int kLdR = kBN + 8;           // R ring tile [d][col]: rows 8 banks apart
constexpr int kLdS = kLd<float, kBK>;  // split tiles [row][d]

struct Powers {
  int e[kMaxPowers];
  int np;
};

template <typename T>
constexpr int kXBytes = kBM * kLd<T, kBK> * sizeof(T);
constexpr int kRBytes = kBK * kLdR * sizeof(float);
// split tiles of one depth slice: x^e big and small for each power, and R
// transposed to [col][d], big and small
constexpr int kSplitXBytes = 2 * kBM * kLdS * sizeof(float);
constexpr int kSplitRBytes = 2 * kBN * kLdS * sizeof(float);
template <typename T, int NP>
constexpr int kSmem = kStages * (kXBytes<T> + kRBytes) + NP * kSplitXBytes + kSplitRBytes;

// Copies R rows [d0, d0 + kBK) x columns [col0, col0 + kBN) into a [d][col]
// tile; what lies outside (D, k) is zero.
template <bool VEC>
__device__ __forceinline__ void load_r(float* tile, const float* R, int d0, int D, int col0,
                                       int k, int tid) {
  if constexpr (VEC) {
    constexpr int kRowChunks = kBN / 4;
#pragma unroll
    for (int i = 0; i < kBK * kRowChunks / kThreads; ++i) {
      const int c = tid + i * kThreads;
      const int r = c / kRowChunks, cc = (c % kRowChunks) * 4;
      const bool ok = d0 + r < D && col0 + cc < k;
      cp_async16(tile + r * kLdR + cc, ok ? R + (size_t)(d0 + r) * k + col0 + cc : R, ok);
    }
  } else {
#pragma unroll 4
    for (int i = 0; i < kBK * kBN / kThreads; ++i) {
      const int c = tid + i * kThreads;
      const int r = c / kBN, cc = c % kBN;
      const bool ok = d0 + r < D && col0 + cc < k;
      cp_async4(tile + r * kLdR + cc, ok ? R + (size_t)(d0 + r) * k + col0 + cc : R, ok);
    }
  }
}

// Four consecutive elements as float32 (bf16 -> float32 is exact).
__device__ __forceinline__ void load4(float (&v)[4], const float* p) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}
__device__ __forceinline__ void load4(float (&v)[4], const __nv_bfloat16* p) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  v[0] = __uint_as_float(q.x << 16);
  v[1] = __uint_as_float(q.x & 0xffff0000u);
  v[2] = __uint_as_float(q.y << 16);
  v[3] = __uint_as_float(q.y & 0xffff0000u);
}

// Splits four floats and stores their big and small parts, 16 bytes each.
__device__ __forceinline__ void store_split4(float* big, float* small, const float (&v)[4]) {
  uint32_t b[4], s[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) split(v[q], b[q], s[q]);
  *reinterpret_cast<uint4*>(big) = make_uint4(b[0], b[1], b[2], b[3]);
  *reinterpret_cast<uint4*>(small) = make_uint4(s[0], s[1], s[2], s[3]);
}

template <typename T, bool VEC, int NP>
__global__ void __launch_bounds__(kThreads, 1)
power_project_kernel(const T* __restrict__ X, const float* __restrict__ R,
                     float* __restrict__ U, int n, int D, int k, Powers powers, int first) {
  constexpr int kLdX = kLd<T, kBK>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);
  float* rs = reinterpret_cast<float*>(smem + kStages * kXBytes<T>);
  float* xsplit = reinterpret_cast<float*>(smem + kStages * (kXBytes<T> + kRBytes));
  float* rsplit = reinterpret_cast<float*>(smem + kStages * (kXBytes<T> + kRBytes) +
                                           NP * kSplitXBytes);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp >> 2) * 32, wn = (warp & 3) * 32;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.y * kBM, col0 = blockIdx.x * kBN;

  // this block's NP powers: places base .. base + NP - 1 of U
  const int base = first + blockIdx.z * NP;
  int e[NP];
#pragma unroll
  for (int s = 0; s < NP; ++s) e[s] = powers.e[base + s];

  float acc[NP][2][4][4];
#pragma unroll
  for (int s = 0; s < NP; ++s)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[s][i][j][q] = 0.f;

  auto load = [&](int slot, int tile) {
    const int d0 = tile * kBK;
    load_rows<T, kBM, kBK, kThreads, VEC>(xs + slot * kBM * kLdX, X, row0, n, d0, D, tid);
    load_r<VEC>(rs + slot * kBK * kLdR, R, d0, D, col0, k, tid);
  };
  auto compute = [&](int slot) {
    // 1. the landed slice, split once for the whole block: each element of
    //    X raised to every exponent of the block and each power split; R
    //    split and transposed to [col][d], which ldmatrix reads as B
    //    fragments.  Every access is 16 bytes a thread or falls in 32
    //    different banks.
    const T* xt = xs + slot * kBM * kLdX;
    constexpr int kXIt = kBM * kBK / 4 / kThreads;  // 4 depths of a row each
    float x[kXIt][4];
#pragma unroll
    for (int it = 0; it < kXIt; ++it) {
      const int idx = tid + it * kThreads;
      load4(x[it], xt + (idx / (kBK / 4)) * kLdX + (idx % (kBK / 4)) * 4);
    }
#pragma unroll
    for (int s = 0; s < NP; ++s) {
      float v[kXIt][4];
#pragma unroll
      for (int it = 0; it < kXIt; ++it)
#pragma unroll
        for (int q = 0; q < 4; ++q) v[it][q] = x[it][q];
      for (int j = 1; j < e[s]; ++j)  // x ** e[s] by repeated products
#pragma unroll
        for (int it = 0; it < kXIt; ++it)
#pragma unroll
          for (int q = 0; q < 4; ++q) v[it][q] *= x[it][q];
#pragma unroll
      for (int it = 0; it < kXIt; ++it) {
        const int idx = tid + it * kThreads;
        float* out = xsplit + s * 2 * kBM * kLdS + (idx / (kBK / 4)) * kLdS + (idx % (kBK / 4)) * 4;
        store_split4(out, out + kBM * kLdS, v[it]);
      }
    }
    const float* rt = rs + slot * kBK * kLdR;
#pragma unroll
    for (int it = 0; it < kBK / 4 * kBN / kThreads; ++it) {
      const int idx = tid + it * kThreads, c = idx % kBN, d = (idx / kBN) * 4;
      float v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) v[q] = rt[(d + q) * kLdR + c];
      store_split4(rsplit + c * kLdS + d, rsplit + kBN * kLdS + c * kLdS + d, v);
    }
    __syncthreads();
    // 2. each power's products over the slice are summed from zero on the
    //    tensor cores and then added to the running sum in IEEE float32
#pragma unroll
    for (int s = 0; s < NP; ++s) {
      const float* xb = xsplit + s * 2 * kBM * kLdS;
      float part[2][4][4] = {};
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 8) {
        uint32_t a_big[2][4], a_small[2][4], b_big[4][2], b_small[4][2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          ldsm_a<kLdS>(a_big[i], xb, wm + i * 16, kk, lane);
          ldsm_a<kLdS>(a_small[i], xb + kBM * kLdS, wm + i * 16, kk, lane);
        }
#pragma unroll
        for (int j = 0; j < 4; j += 2) {
          ldsm_b2<kLdS>(b_big[j], b_big[j + 1], rsplit, wn + j * 8, kk, lane);
          ldsm_b2<kLdS>(b_small[j], b_small[j + 1], rsplit + kBN * kLdS, wn + j * 8, kk, lane);
        }
        mma_tiles<true>(part, a_big, a_small, b_big, b_small);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[s][i][j][q] += part[i][j][q];
    }
  };
  ring<kStages>((D + kBK - 1) / kBK, load, compute);

  const bool pairs = (k & 1) == 0;
#pragma unroll
  for (int s = 0; s < NP; ++s)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row0 + wm + i * 16 + g + 8 * h;
        if (r >= n) continue;
        float* out = U + ((size_t)r * powers.np + base + s) * k;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          store2(out, col0 + wn + j * 8 + 2 * t, k, pairs, acc[s][i][j][2 * h],
                 acc[s][i][j][2 * h + 1]);
      }
}

// `chunks` blocks along grid z, each for NP powers, from power `first` on
template <typename T, bool VEC, int NP>
cudaError_t run(const T* X, const float* R, float* U, int n, int D, int k,
                const Powers& powers, int first, int chunks, cudaStream_t stream) {
  auto kernel = power_project_kernel<T, VEC, NP>;
  constexpr int smem = kSmem<T, NP>;
  static SmemGrant grant;
  cudaError_t e = grant.allow(kernel, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((k + kBN - 1) / kBN, (n + kBM - 1) / kBM, chunks);
  kernel<<<grid, kThreads, smem, stream>>>(X, R, U, n, D, k, powers, first);
  return cudaGetLastError();
}

// the powers in chunks of kChunk, then one launch for the rest
template <typename T, bool VEC>
cudaError_t run_chunks(const T* X, const float* R, float* U, int n, int D, int k,
                       const Powers& powers, cudaStream_t stream) {
  static_assert(kChunk == 3, "the rest below is 1 or 2 powers");
  const int full = powers.np / kChunk, rest = powers.np % kChunk, first = full * kChunk;
  cudaError_t e = cudaSuccess;
  if (full > 0) e = run<T, VEC, kChunk>(X, R, U, n, D, k, powers, 0, full, stream);
  if (e == cudaSuccess && rest == 1) e = run<T, VEC, 1>(X, R, U, n, D, k, powers, first, 1, stream);
  if (e == cudaSuccess && rest == 2) e = run<T, VEC, 2>(X, R, U, n, D, k, powers, first, 1, stream);
  return e;
}

template <typename T>
cudaError_t launch(const void* X, const float* R, float* U, int n, int D, int k,
                   const Powers& powers, cudaStream_t stream) {
  const T* x = static_cast<const T*>(X);
  const bool vec = D % (16 / sizeof(T)) == 0 && k % 4 == 0 && aligned16(X) && aligned16(R);
  return vec ? run_chunks<T, true>(x, R, U, n, D, k, powers, stream)
             : run_chunks<T, false>(x, R, U, n, D, k, powers, stream);
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
  pw.np = np;
  for (int s = 0; s < np; ++s) {
    if (powers[s] < 1) return cudaErrorInvalidValue;
    pw.e[s] = powers[s];
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return x_bf16 ? launch<__nv_bfloat16>(X, R, U, n, D, k, pw, st)
                : launch<float>(X, R, U, n, D, k, pw, st);
}

extern "C" const char* power_project_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
