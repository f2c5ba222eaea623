// K3: nearest other row (1-NN) per query row.
//
// Replaces src/repro/kernels/pairwise_reduce/pairwise_reduce.py::
// pairwise_knn_pallas (_knn_kernel, _knn_body, _tile_d2). For queries xq
// (mq, d), which are the first mq rows of the dataset x (mk, d), it writes
// the index and squared distance of the nearest dataset row other than the
// query itself, with d2 = ||q||^2 + ||x||^2 - 2 q.x; columns >= m count as
// +inf. Ties keep the first occurrence (lowest index); a row with no
// candidate (m == 1) returns index 0 and +inf.
//
// What bounds it on the H100: 2 * mq * mk * d operations on a few MB of
// input (DROP's reduced data: d = k <= ~100), so it is bound by the float32
// rate outside the tensor cores, never by memory.
//
// Design:
// * The TPU kernel carries (min d2, argmin) across a sequential grid axis
//   over dataset tiles; here each block owns 64 query rows and loops over
//   the dataset tiles itself, keeping the running pair in registers. The
//   mq x mk distance matrix never exists.
// * A 64 x 64 distance tile is a small product through shared memory in
//   chunks of d (IEEE float32 FMAs, no TF32); the squared norms are summed
//   from the same shared-memory chunks.
// * The tile's per-row minimum is reduced across the 16 threads that share
//   a row with warp shuffles, ordered by (d2, index), so the earliest column
//   wins a tie, as the reference's strict-< carry and first-occurrence
//   argmin do.
// * Ragged rows, columns and d are masked in the kernel; nothing is padded.
#include "common.cuh"

namespace {

constexpr int BQ = 64;
constexpr int BKT = 64;
constexpr int DC = 16;
constexpr int TQ = 4;
constexpr int TK = 4;
constexpr int THREADS = (BQ / TQ) * (BKT / TK);  // 256

__device__ __forceinline__ bool before(float d2a, int ia, float d2b, int ib) {
  return d2a < d2b || (d2a == d2b && ia < ib);
}

__global__ void __launch_bounds__(THREADS)
    pairwise_knn_kernel(const float* __restrict__ xq,
                        const float* __restrict__ x, int* __restrict__ out_idx,
                        float* __restrict__ out_d2, int mq, int mk, int d,
                        int m) {
  __shared__ float qs[DC][BQ + 1];
  __shared__ float xs[DC][BKT + 1];
  __shared__ float sq_q[BQ];
  __shared__ float sq_x[BKT];

  const int tid = threadIdx.x;
  const int tx = tid % (BKT / TK);
  const int ty = tid / (BKT / TK);
  const int q0 = blockIdx.x * BQ;
  const int n_cols = min(mk, m);

  float best_d2[TQ];
  int best_idx[TQ];
#pragma unroll
  for (int i = 0; i < TQ; ++i) {
    best_d2[i] = INFINITY;
    best_idx[i] = 0;
  }

  for (int c0 = 0; c0 < n_cols; c0 += BKT) {
    float acc[TQ][TK];
#pragma unroll
    for (int i = 0; i < TQ; ++i)
#pragma unroll
      for (int j = 0; j < TK; ++j) acc[i][j] = 0.f;
    // threads 0..63 sum ||x||^2 of tile column tid, 64..127 ||q||^2 of row
    float sq = 0.f;

    for (int d0 = 0; d0 < d; d0 += DC) {
#pragma unroll
      for (int r = 0; r < BQ * DC / THREADS; ++r) {
        const int e = tid + r * THREADS;
        const int dd = e % DC;
        const int rr = e / DC;
        const int gq = q0 + rr;
        const int gd = d0 + dd;
        qs[dd][rr] = (gq < mq && gd < d) ? xq[static_cast<long long>(gq) * d + gd] : 0.f;
        const int gc = c0 + rr;
        xs[dd][rr] = (gc < n_cols && gd < d) ? x[static_cast<long long>(gc) * d + gd] : 0.f;
      }
      __syncthreads();
      if (tid < BKT) {
#pragma unroll
        for (int dd = 0; dd < DC; ++dd) sq = fmaf(xs[dd][tid], xs[dd][tid], sq);
      } else if (tid < BKT + BQ) {
#pragma unroll
        for (int dd = 0; dd < DC; ++dd)
          sq = fmaf(qs[dd][tid - BKT], qs[dd][tid - BKT], sq);
      }
#pragma unroll
      for (int dd = 0; dd < DC; ++dd) {
        float qv[TQ];
        float xv[TK];
#pragma unroll
        for (int i = 0; i < TQ; ++i) qv[i] = qs[dd][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < TK; ++j) xv[j] = xs[dd][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < TQ; ++i)
#pragma unroll
          for (int j = 0; j < TK; ++j) acc[i][j] = fmaf(qv[i], xv[j], acc[i][j]);
      }
      __syncthreads();
    }
    if (tid < BKT) {
      sq_x[tid] = sq;
    } else if (tid < BKT + BQ) {
      sq_q[tid - BKT] = sq;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < TQ; ++i) {
      const int row = q0 + ty + 16 * i;
      float t_d2 = INFINITY;
      int t_idx = INT32_MAX;
#pragma unroll
      for (int j = 0; j < TK; ++j) {
        const int col = c0 + tx + 16 * j;
        if (col < n_cols && col != row) {
          const float v = __fsub_rn(__fadd_rn(sq_q[ty + 16 * i], sq_x[tx + 16 * j]),
                                    __fmul_rn(2.f, acc[i][j]));
          if (before(v, col, t_d2, t_idx)) {
            t_d2 = v;
            t_idx = col;
          }
        }
      }
      // the 16 threads sharing this row are one half of a warp
#pragma unroll
      for (int off = 8; off > 0; off /= 2) {
        const float o_d2 = __shfl_xor_sync(0xffffffffu, t_d2, off);
        const int o_idx = __shfl_xor_sync(0xffffffffu, t_idx, off);
        if (before(o_d2, o_idx, t_d2, t_idx)) {
          t_d2 = o_d2;
          t_idx = o_idx;
        }
      }
      if (t_d2 < best_d2[i]) {
        best_d2[i] = t_d2;
        best_idx[i] = t_idx;
      }
    }
    __syncthreads();
  }

  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < TQ; ++i) {
      const int row = q0 + ty + 16 * i;
      if (row < mq) {
        out_idx[row] = best_idx[i];
        out_d2[row] = best_d2[i];
      }
    }
  }
}

}  // namespace

// xq (mq, d), x (mk, d) float32 contiguous; idx int32 (mq,), d2 float32
// (mq,). Columns >= m are excluded.
extern "C" int repro_pairwise_knn(const void* xq, const void* x, void* idx,
                                  void* d2, int mq, int mk, int d, int m,
                                  void* stream) {
  const dim3 grid((mq + BQ - 1) / BQ);
  pairwise_knn_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xq), static_cast<const float*>(x),
      static_cast<int*>(idx), static_cast<float*>(d2), mq, mk, d, m);
  return static_cast<int>(cudaGetLastError());
}
