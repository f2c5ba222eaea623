// K4: DBSCAN eps-ball counts and packed neighbor bits per query row.
//
// Replaces src/repro/kernels/pairwise_reduce/pairwise_reduce.py::
// pairwise_dbscan_pallas (_dbscan_kernel, _dbscan_body, pack_bits_u32).
// For queries xq (mq, d) and the dataset x (mk, d) it flags every column c
// with d2 = ||q||^2 + ||x_c||^2 - 2 q.x_c <= eps2 (self included, columns
// >= m never), writes the flags as uint32 words (mq, ceil(mk / 32)) with
// bit j of word w for column 32w + j (zero tail bits), and counts them.
//
// What bounds it on the H100: 2 * mq * mk * d float32 operations for the
// dot products, beside mq * mk / 8 bytes of packed output. At DROP's
// reduced widths the operations are the larger term (70,000 rows at
// d = 8: 78 GFLOP against a 613 MB write), so the output is written once,
// straight from the ballots, and the distance tile stays in registers.
//
// Design:
// * The TPU kernel walks dataset tiles on a sequential grid axis; here a
//   block owns 64 query rows (8 warps x 8 rows) and loops over 128-column
//   dataset tiles itself (the distance tile of pairwise_tile.cuh). The
//   mq x mk distance matrix never exists.
// * Lane j of a warp owns columns 32w + j of the tile's four words, so
//   __ballot_sync over the lanes' tests gives word w in exactly the
//   reference's little-endian layout, and __popc adds to the count.
// * When there are too few row blocks to fill the card, the column tiles
//   are split over a second grid axis; the packed words of a split are its
//   own, and its counts are added with integer atomics (exact in any
//   order, so the result does not depend on the split).
#include "pairwise_tile.cuh"

namespace {

using namespace tile;

__global__ void __launch_bounds__(THREADS)
    pairwise_dbscan_kernel(const float* __restrict__ xq,
                           const float* __restrict__ x,
                           int* __restrict__ counts,
                           uint32_t* __restrict__ packed, int mq, int mk,
                           int d, int m, float eps2, int tiles_per_split) {
  __shared__ Smem sm;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int q0 = blockIdx.x * BQ;
  const int n_cols = min(mk, m);
  const int words = (mk + 31) / 32;
  const int n_tiles = (words + CPL - 1) / CPL;
  const int t_begin = blockIdx.y * tiles_per_split;
  const int t_end = min(t_begin + tiles_per_split, n_tiles);

  row_norms(xq, q0, mq, d, sm);
  int cnt[RPW];
#pragma unroll
  for (int i = 0; i < RPW; ++i) cnt[i] = 0;

  for (int t = t_begin; t < t_end; ++t) {
    const int c0 = t * BK;
    float d2[RPW][CPL];
    if (c0 < n_cols) {  // block-uniform; tiles at or past m write zero words
      tile_d2(xq, x, q0, c0, mq, n_cols, d, sm, d2);
    } else {
#pragma unroll
      for (int i = 0; i < RPW; ++i)
#pragma unroll
        for (int j = 0; j < CPL; ++j) d2[i][j] = INFINITY;
    }
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int gq = q0 + warp * RPW + i;
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        const int col = c0 + 32 * j + lane;
        const unsigned word = __ballot_sync(FULL, col < n_cols && d2[i][j] <= eps2);
        cnt[i] += __popc(word);
        const int w = t * CPL + j;
        if (lane == j && gq < mq && w < words) {
          packed[static_cast<long long>(gq) * words + w] = word;
        }
      }
    }
  }

  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int gq = q0 + warp * RPW + i;
      if (gq < mq && cnt[i] != 0) atomicAdd(&counts[gq], cnt[i]);
    }
  }
}

}  // namespace

// xq (mq, d), x (mk, d) float32 contiguous; counts int32 (mq,) zeroed by the
// caller; packed uint32 (mq, ceil(mk / 32)). Columns >= m are excluded.
extern "C" int repro_pairwise_dbscan(const void* xq, const void* x, void* counts,
                                     void* packed, int mq, int mk, int d, int m,
                                     float eps2, void* stream) {
  const int n_tiles = ((mk + 31) / 32 + CPL - 1) / CPL;
  const dim3 grid((mq + BQ - 1) / BQ, splits(mq, n_tiles));
  pairwise_dbscan_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xq), static_cast<const float*>(x),
      static_cast<int*>(counts), static_cast<uint32_t*>(packed), mq, mk, d, m,
      eps2, tiles_per_split(mq, n_tiles));
  return static_cast<int>(cudaGetLastError());
}
