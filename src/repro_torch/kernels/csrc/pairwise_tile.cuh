// The distance tile shared by K4 (pairwise_dbscan.cu) and K5
// (pairwise_kde.cu): a block of 8 warps owns 64 query rows (8 per warp) and
// walks the dataset in 128-column tiles; lane j of a warp owns columns
// 32w + j of the tile's four 32-column words.
//
// Each d-chunk of the query and dataset tiles is staged in shared memory
// (the dataset tile transposed, so the lanes read consecutive words); a lane
// keeps 8 x 4 IEEE float32 dot products in registers and sums its columns'
// ||x||^2 from the same chunks. d2 is rounded step by step (no FMA
// contraction), as the JAX package's ||q||^2 + ||x||^2 - 2 q.x.
#pragma once

#include "common.cuh"

namespace tile {

constexpr int WARPS = 8;
constexpr int RPW = 8;           // query rows per warp
constexpr int BQ = WARPS * RPW;  // 64 query rows per block
constexpr int CPL = 4;           // columns per lane = 32-column words per tile
constexpr int BK = 32 * CPL;     // 128 dataset columns per tile
constexpr int DC = 16;           // dims staged per chunk
constexpr int THREADS = 32 * WARPS;
constexpr unsigned FULL = 0xffffffffu;

struct Smem {
  float qs[BQ][DC + 1];
  float xs[DC][BK + 1];
  float sq_q[BQ];
};

// ||q||^2 of the block's rows into sm.sq_q (the warp's rows, lanes striding
// over d); ends with a barrier.
__device__ __forceinline__ void row_norms(const float* __restrict__ xq, int q0,
                                          int mq, int d, Smem& sm) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int i = 0; i < RPW; ++i) {
    const int gq = q0 + warp * RPW + i;
    float s = 0.f;
    if (gq < mq) {
      for (int dd = lane; dd < d; dd += 32) {
        const float v = xq[static_cast<long long>(gq) * d + dd];
        s = fmaf(v, v, s);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off /= 2) s += __shfl_xor_sync(FULL, s, off);
    if (lane == 0) sm.sq_q[warp * RPW + i] = s;
  }
  __syncthreads();
}

// d2[i][j] of the warp's row i and the lane's column c0 + 32j + lane, for
// the dataset's first n_cols rows (other columns see a zero row). Every
// thread of the block must call it.
__device__ __forceinline__ void tile_d2(const float* __restrict__ xq,
                                        const float* __restrict__ x, int q0,
                                        int c0, int mq, int n_cols, int d,
                                        Smem& sm, float (&d2)[RPW][CPL]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float sq_x[CPL];
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    sq_x[j] = 0.f;
#pragma unroll
    for (int i = 0; i < RPW; ++i) d2[i][j] = 0.f;  // the dot products first
  }
  for (int d0 = 0; d0 < d; d0 += DC) {
    for (int e = threadIdx.x; e < BQ * DC; e += THREADS) {
      const int r = e / DC;
      const int dd = e % DC;
      const int gq = q0 + r;
      const int gd = d0 + dd;
      sm.qs[r][dd] = (gq < mq && gd < d) ? xq[static_cast<long long>(gq) * d + gd] : 0.f;
    }
    for (int e = threadIdx.x; e < BK * DC; e += THREADS) {
      const int c = e / DC;
      const int dd = e % DC;
      const int gc = c0 + c;
      const int gd = d0 + dd;
      sm.xs[dd][c] = (gc < n_cols && gd < d) ? x[static_cast<long long>(gc) * d + gd] : 0.f;
    }
    __syncthreads();
    const int dn = min(DC, d - d0);
#pragma unroll 4
    for (int dd = 0; dd < dn; ++dd) {
      float xv[CPL];
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        xv[j] = sm.xs[dd][lane + 32 * j];
        sq_x[j] = fmaf(xv[j], xv[j], sq_x[j]);
      }
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const float qv = sm.qs[warp * RPW + i][dd];
#pragma unroll
        for (int j = 0; j < CPL; ++j) d2[i][j] = fmaf(qv, xv[j], d2[i][j]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      d2[i][j] = __fsub_rn(__fadd_rn(sm.sq_q[warp * RPW + i], sq_x[j]),
                           __fmul_rn(2.f, d2[i][j]));
    }
  }
}

// Column tiles per block along the grid's second axis: when the row blocks
// are too few to give each SM about four blocks, the tiles are split.
inline int tiles_per_split(int mq, int n_tiles) {
  int dev = 0;
  int sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int row_blocks = (mq + BQ - 1) / BQ;
  const int want = (4 * (sms > 0 ? sms : 1) + row_blocks - 1) / row_blocks;
  const int splits = max(1, min(n_tiles, want));
  return max(1, (n_tiles + splits - 1) / splits);
}

inline int splits(int mq, int n_tiles) {
  const int per = tiles_per_split(mq, n_tiles);
  return max(1, (n_tiles + per - 1) / per);
}

}  // namespace tile
