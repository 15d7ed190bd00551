// tf32x3: the tensor-core main loop shared by power_project.cu and
// pairwise_lp.cu.
//
// Precision.  A float32 product a*b is taken as three TF32 products on the
// tensor cores: a = a_big + a_small with a_big = a rounded to TF32 (nearest,
// ties away, as cvt.rna) and a_small = a - a_big (exact), and
//   a*b ~ a_small*b_big + a_big*b_small + a_big*b_big,
// the small terms first, summed in float32.  a_small goes to the MMA as it
// is: the MMA reads only its top 19 bits, which costs about 2^-21 of |a*b|,
// as does the dropped a_small*b_small term, so the error per product is a
// few 2^-22 relative, near float32's own 2^-24 and far inside the port's
// 1e-5 x (sum of |terms|) tolerance; a single TF32 product (2^-11) is not
// (tests/test_torch_kernels.py::test_tf32_emulation_error emulates both).
// The tensor cores round their float32 sums toward zero, so both kernels
// sum each 32-deep slice from zero and add it to their running sums in
// IEEE float32 (see mma_tiles); on the card the whole sums then differ
// from float32's by about 1e-7 of the largest sum of |terms|.  A bfloat16
// value is exact in TF32 (small = 0), so a product of two bf16 operands is
// one MMA.
//
// Instructions: mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 as inline
// PTX, fragments read with ldmatrix.  mma.sync takes both operands from
// registers, so a kernel may split its fragments in registers after
// reading them (pairwise_lp) or split a landed tile once into big and
// small tiles in shared memory (power_project); wgmma would read B from
// shared memory and need B_big and B_small staged there, K-major.
//
// Staging: depth tiles go through a STAGES-deep ring of cp.async copies in
// dynamic shared memory, one commit group per tile, so the copies of the
// next STAGES-1 tiles are in flight while one tile is multiplied.  Ragged
// edges are zero-filled by the copy itself (src-size 0), never padded in
// device memory.  Rows that are not 16-byte aligned use 4-byte cp.async
// (float32) or predicated 2-byte loads (bfloat16, which cp.async cannot
// copy alone).  No atomics: a run repeats bit for bit.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstddef>
#include <cstdint>

namespace tf32x3 {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared, asynchronously; zero-filled when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes from global to shared, asynchronously; zero-filled when !valid.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x = big + small as float32 bit patterns: big is x rounded to TF32 to
// nearest, ties away from zero (the bits are sign and magnitude, so adding
// half a TF32 ulp and dropping the 13 low bits rounds the magnitude; the
// same value as cvt.rna.tf32.f32 for finite x, in two integer
// instructions), small = x - big exactly, left for the MMA to truncate.
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

// Four 8x8 matrices of 16-bit elements from shared memory: lane l gives the
// address of row l % 8 of matrix l / 8, and receives from matrix j the
// 32-bit pair at (row l / 4, pair l % 4) in r[j].  On a float32 tile a pair
// is one float, so this reads a whole TF32 fragment.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const float* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row)));
}

// c += a * b on one 16x8x8 tile.  Not volatile: the MMA has no side
// effect, so the compiler may interleave it with its neighbours.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c[i][j] += a[i] * b[j] for every row tile i and column tile j.  SPLIT:
// the three products small*big, big*small, big*big, the small terms first;
// otherwise big*big alone (operands exact in TF32).  Each pass walks every
// tile, so consecutive MMAs write different accumulators and none waits
// for the one before.
//
// The MMA rounds c + a*b toward zero.  Into one running sum over many
// depth steps that adds up to a biased error of order (steps x ulp(c));
// so a kernel sums a few steps into a fresh c and adds that to its running
// sum in IEEE float32 (rounded to nearest).
template <bool SPLIT, int MI, int NJ>
__device__ __forceinline__ void mma_tiles(float (&c)[MI][NJ][4], const uint32_t (&a_big)[MI][4],
                                          const uint32_t (&a_small)[MI][4],
                                          const uint32_t (&b_big)[NJ][2],
                                          const uint32_t (&b_small)[NJ][2]) {
  if constexpr (SPLIT) {
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) mma(c[i][j], a_small[i], b_big[j]);
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) mma(c[i][j], a_big[i], b_small[j]);
  }
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) mma(c[i][j], a_big[i], b_big[j]);
}

// Fragment layouts of m16n8k8 (tf32), with g = lane / 4 and t = lane % 4:
//   A (16 x 8, row):  a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
//   B (8 x 8, col):   b0 (k = t, n = g), b1 (k = t + 4, n = g)
//   C (16 x 8):       c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)

// The A fragment at (row, k) of a [rows][LD] depth-contiguous tile.
template <int LD, typename T>
__device__ __forceinline__ void load_a(float (&a)[4], const T* tile, int row, int k, int lane) {
  const T* p = tile + (row + (lane >> 2)) * LD + k + (lane & 3);
  a[0] = to_f32(p[0]);
  a[1] = to_f32(p[8 * LD]);
  a[2] = to_f32(p[4]);
  a[3] = to_f32(p[8 * LD + 4]);
}

// The A fragment at (row, k) of a [rows][LD] depth-contiguous float32 tile,
// in one ldmatrix (LD a multiple of 4, rows 16-byte aligned).
template <int LD>
__device__ __forceinline__ void ldsm_a(uint32_t (&a)[4], const float* tile, int row, int k,
                                       int lane) {
  const int m = lane >> 3;  // matrices: rows +0/+8 (bit 0), depth +0/+4 (bit 1)
  ldsm_x4(a, tile + (row + (lane & 7) + (m & 1) * 8) * LD + k + (m >> 1) * 4);
}

// The B fragments at (n, k) and (n + 8, k) of an [n][LD] depth-contiguous
// float32 tile, in one ldmatrix.
template <int LD>
__device__ __forceinline__ void ldsm_b2(uint32_t (&b0)[2], uint32_t (&b1)[2], const float* tile,
                                        int n, int k, int lane) {
  const int m = lane >> 3;  // matrices: depth +0/+4 (bit 0), n +0/+8 (bit 1)
  uint32_t r[4];
  ldsm_x4(r, tile + (n + (lane & 7) + (m >> 1) * 8) * LD + k + (m & 1) * 4);
  b0[0] = r[0];
  b0[1] = r[1];
  b1[0] = r[2];
  b1[1] = r[3];
}

// The B fragment at (n, k) of an [n][LD] depth-contiguous tile.
template <int LD, typename T>
__device__ __forceinline__ void load_b(float (&b)[2], const T* tile, int n, int k, int lane) {
  const T* p = tile + (n + (lane >> 2)) * LD + k + (lane & 3);
  b[0] = to_f32(p[0]);
  b[1] = to_f32(p[4]);
}

// The padding of a depth-contiguous tile row: 16 bytes keeps every row
// 16-byte aligned for cp.async and puts the 8 rows a fragment reads 4 banks
// apart, so the fragment reads are free of bank conflicts.
template <typename T, int BK>
constexpr int kLd = BK + 16 / static_cast<int>(sizeof(T));

// Copies rows [row0, row0 + ROWS) x depth [k0, k0 + BK) of a row-major
// (nrows, K) matrix into a [ROWS][LD] tile; what lies outside is zero.
// VEC: 16-byte copies, for a 16-byte aligned matrix whose rows are a whole
// number of 16-byte chunks.
template <typename T, int ROWS, int BK, int THREADS, bool VEC>
__device__ __forceinline__ void load_rows(T* tile, const T* g, int row0, int nrows, int k0,
                                          int K, int tid) {
  constexpr int LD = kLd<T, BK>;
  if constexpr (VEC) {
    constexpr int kPer = 16 / sizeof(T);
    constexpr int kRowChunks = BK / kPer;
    static_assert((ROWS * kRowChunks) % THREADS == 0, "tile copy must split evenly");
#pragma unroll
    for (int i = 0; i < ROWS * kRowChunks / THREADS; ++i) {
      const int c = tid + i * THREADS;
      const int r = c / kRowChunks, kc = (c % kRowChunks) * kPer;
      const bool ok = row0 + r < nrows && k0 + kc < K;
      const T* src = ok ? g + (size_t)(row0 + r) * K + k0 + kc : g;
      cp_async16(tile + r * LD + kc, src, ok);
    }
  } else {
    static_assert((ROWS * BK) % THREADS == 0, "tile copy must split evenly");
#pragma unroll 4
    for (int i = 0; i < ROWS * BK / THREADS; ++i) {
      const int c = tid + i * THREADS;
      const int r = c / BK, kc = c % BK;
      const bool ok = row0 + r < nrows && k0 + kc < K;
      const T* src = ok ? g + (size_t)(row0 + r) * K + k0 + kc : g;
      if constexpr (sizeof(T) == 4) {
        cp_async4(tile + r * LD + kc, src, ok);
      } else {
        const unsigned short v = ok ? __ldg(reinterpret_cast<const unsigned short*>(src)) : 0;
        reinterpret_cast<unsigned short*>(tile)[r * LD + kc] = v;
      }
    }
  }
}

// The depth loop through the ring.  load(slot, tile) issues the copies of
// depth tile `tile` into ring slot `slot`; compute(slot) multiplies the tile
// in `slot`.  Every iteration commits one group (empty past the end), so
// waiting until STAGES-2 groups are pending means tile t has landed; the
// barrier after it also tells every warp that the slot refilled next,
// consumed one iteration earlier, is free.
template <int STAGES, class Load, class Compute>
__device__ __forceinline__ void ring(int tiles, Load&& load, Compute&& compute) {
  static_assert(STAGES >= 2, "a ring needs two slots");
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < tiles) load(s, s);
    cp_async_commit();
  }
  for (int t = 0; t < tiles; ++t) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int next = t + STAGES - 1;
    if (next < tiles) load(next % STAGES, next);
    cp_async_commit();
    compute(t % STAGES);
  }
  cp_async_wait<0>();
}

// Writes v0, v1 to row[c], row[c + 1] where they lie below `limit`; one
// 8-byte store when both do and `pairs` says the row is 8-byte aligned.
__device__ __forceinline__ void store2(float* row, int c, int limit, bool pairs, float v0,
                                       float v1) {
  if (pairs && c + 1 < limit) {
    *reinterpret_cast<float2*>(row + c) = make_float2(v0, v1);
  } else {
    if (c < limit) row[c] = v0;
    if (c + 1 < limit) row[c + 1] = v1;
  }
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// Lets a kernel take more than 48 KB of dynamic shared memory.  The
// attributes hold for the process, so each kernel instantiation keeps a
// function-local `static SmemGrant` and sets them at its first launch on
// each device, not on every launch.
class SmemGrant {
 public:
  template <class Kernel>
  cudaError_t allow(Kernel kernel, int smem) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    const bool known = dev >= 0 && dev < kDevices;
    if (known && done_[dev].load(std::memory_order_acquire)) return cudaSuccess;
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (e == cudaSuccess && known) done_[dev].store(true, std::memory_order_release);
    return e;
  }

 private:
  static constexpr int kDevices = 64;
  std::atomic<bool> done_[kDevices] = {};
};

}  // namespace tf32x3
