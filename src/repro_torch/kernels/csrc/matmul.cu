// K1: C = A @ B with float32 accumulation.
//
// Replaces src/repro/kernels/matmul/matmul.py::matmul_pallas
// (_matmul_kernel), the tiled MXU product behind SVD-Halko's three O(mdk)
// products (core/halko.py: C @ Omega, C^T @ Y, Q^T @ C).
//
// What bounds it on the H100: at DROP's shapes the products are skinny
// (m <= 70000 rows, d <= 1024, l = k + oversample <= ~100), so each call
// reads the large operand C once (up to ~280 MB; ~32 MB at 8000 x 1024)
// and does 2*m*d*l operations at the float32 rate outside the tensor
// cores: bytes and operations are within a small factor of each other.
//
// Design:
// * IEEE float32 fused multiply-adds (no TF32), as the reference computes
//   at Precision.HIGHEST; bf16 inputs are widened to float32 on load and
//   the output is rounded to the input type, as the reference kernel does.
// * Operands arrive with their strides, so the transposed views C^T and
//   Q^T are read in place and never materialized. Each tile load picks its
//   thread mapping from whichever axis of the operand is contiguous, so the
//   load stays coalesced for both layouts.
// * The TPU kernel carries its accumulator across a sequential K grid axis;
//   here one block owns a 64 x 64 output tile and loops over K itself.
// * C^T @ Y and Q^T @ C have few output tiles and a long K (the sample
//   rows), which would leave most SMs idle: the caller asks for a split of
//   K, each split writes a float32 partial to a workspace, and a second
//   kernel sums the partials in a fixed order (deterministic, no atomics).
// * Ragged edges are masked in the loads and stores; nothing is padded.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int TM = 4;
constexpr int TN = 4;
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256
constexpr int RED_THREADS = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// One block computes the (BM, BN) tile at (blockIdx.y, blockIdx.x) over the
// K range of split blockIdx.z. Thread (ty, tx) owns rows ty + 16 i and
// columns tx + 16 j, so shared-memory reads are broadcasts or consecutive
// and global stores are coalesced.
template <typename T, typename OutT>
__global__ void __launch_bounds__(THREADS)
    matmul_kernel(const T* __restrict__ a, const T* __restrict__ b,
                  OutT* __restrict__ c, int m, int n, int k, long long sa0,
                  long long sa1, long long sb0, long long sb1, int k_per_split,
                  long long split_stride) {
  __shared__ float as[BK][BM + 1];
  __shared__ float bs[BK][BN + 1];
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const int k_begin = blockIdx.z * k_per_split;
  const int k_end = min(k, k_begin + k_per_split);
  const bool a_k_fast = (sa1 == 1);
  const bool b_n_fast = (sb1 == 1);

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
#pragma unroll
    for (int r = 0; r < (BM * BK) / THREADS; ++r) {
      const int e = tid + r * THREADS;
      const int kk = a_k_fast ? e % BK : e / BM;
      const int ii = a_k_fast ? e / BK : e % BM;
      const int gi = row0 + ii;
      const int gk = k0 + kk;
      as[kk][ii] = (gi < m && gk < k_end) ? to_f32(a[gi * sa0 + gk * sa1]) : 0.f;
    }
#pragma unroll
    for (int r = 0; r < (BK * BN) / THREADS; ++r) {
      const int e = tid + r * THREADS;
      const int jj = b_n_fast ? e % BN : e / BK;
      const int kk = b_n_fast ? e / BN : e % BK;
      const int gj = col0 + jj;
      const int gk = k0 + kk;
      bs[kk][jj] = (gj < n && gk < k_end) ? to_f32(b[gk * sb0 + gj * sb1]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float av[TM];
      float bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = as[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  OutT* out = c + blockIdx.z * split_stride;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gi = row0 + ty + 16 * i;
    if (gi >= m) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gj = col0 + tx + 16 * j;
      if (gj < n) store(&out[static_cast<long long>(gi) * n + gj], acc[i][j]);
    }
  }
}

// Sums the per-split float32 partials in split order and rounds once.
template <typename OutT>
__global__ void __launch_bounds__(RED_THREADS)
    sum_splits_kernel(const float* __restrict__ ws, OutT* __restrict__ c,
                      long long count, int splits) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       e < count; e += step) {
    float s = 0.f;
    for (int p = 0; p < splits; ++p) s += ws[p * count + e];
    store(&c[e], s);
  }
}

template <typename T>
void launch(const T* a, const T* b, T* c, float* ws, int m, int n, int k,
            long long sa0, long long sa1, long long sb0, long long sb1,
            int splits, cudaStream_t stream) {
  const int k_per_split = ((k + splits - 1) / splits + BK - 1) / BK * BK;
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM, splits);
  if (splits == 1) {
    matmul_kernel<T, T><<<grid, THREADS, 0, stream>>>(
        a, b, c, m, n, k, sa0, sa1, sb0, sb1, k_per_split, 0);
    return;
  }
  const long long count = static_cast<long long>(m) * n;
  matmul_kernel<T, float><<<grid, THREADS, 0, stream>>>(
      a, b, ws, m, n, k, sa0, sa1, sb0, sb1, k_per_split, count);
  const long long blocks = (count + RED_THREADS - 1) / RED_THREADS;
  sum_splits_kernel<T><<<static_cast<int>(blocks < 4096 ? blocks : 4096),
                         RED_THREADS, 0, stream>>>(ws, c, count, splits);
}

}  // namespace

// C (m, n) = A (m, k) @ B (k, n). Strides are in elements; C is contiguous.
// ws holds splits * m * n floats when splits > 1 (unused otherwise).
// dtype: 0 = float32, 1 = bfloat16 (A, B and C share it).
extern "C" int repro_matmul(const void* a, const void* b, void* c, void* ws,
                            int m, int n, int k, long long sa0, long long sa1,
                            long long sb0, long long sb1, int splits, int dtype,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    launch(static_cast<const __nv_bfloat16*>(a),
           static_cast<const __nv_bfloat16*>(b), static_cast<__nv_bfloat16*>(c),
           static_cast<float*>(ws), m, n, k, sa0, sa1, sb0, sb1, splits, s);
  } else {
    launch(static_cast<const float*>(a), static_cast<const float*>(b),
           static_cast<float*>(c), static_cast<float*>(ws), m, n, k, sa0, sa1,
           sb0, sb1, splits, s);
  }
  return static_cast<int>(cudaGetLastError());
}
