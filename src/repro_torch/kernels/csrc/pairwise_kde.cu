// K5: compensated Gaussian exp-sum per query row (kernel density).
//
// Replaces src/repro/kernels/pairwise_reduce/pairwise_reduce.py::
// pairwise_kde_pallas (_kde_kernel, _kde_body). For queries xq (mq, d) and
// the dataset x (mk, d) it sums exp(-max(d2, 0) * inv_two_h2) over the
// columns < m, d2 = ||q||^2 + ||x||^2 - 2 q.x, and writes the sum as a
// Neumaier pair (sums, comps): the value is sums + comps, which the caller
// folds in float64.
//
// What bounds it on the H100: per (row, column), 2 * d + 9 float32
// operations (dot product, d2, scale, Neumaier add) beside one expf on the
// special function units (16 exp2 per clock per SM, against 128 FP32
// lanes). From d = 4 up the float32 operations are the larger term; the
// input is a few MB and the output 8 bytes per row, so nothing is
// memory-bound and the distance tile stays in registers.
//
// Design:
// * The TPU kernel carries (sum, comp) across a sequential grid axis of
//   dataset tiles; here a block owns 64 query rows (8 warps x 8 rows) and
//   loops over 128-column dataset tiles itself (the distance tile of
//   pairwise_tile.cuh, shared with K4). The mq x mk matrix never exists.
// * Each lane keeps its own Neumaier (sum, comp) per row over the columns
//   it owns; the warp then combines the 32 lanes' pairs with a compensated
//   add in a fixed butterfly, as _kde_body combines tiles.
// * expf, not __expf: the fast intrinsic is ~2 ulp off for large arguments
//   and would move densities. No FMA contraction in d2.
// * When there are too few row blocks to fill the card, the column tiles
//   are split over a second grid axis; each split writes its pair to a
//   scratch row, and a second small kernel folds the splits in order with
//   the same compensated add (deterministic, no atomics).
#include "pairwise_tile.cuh"

namespace {

using namespace tile;

// Neumaier: add b to the running (s, c)
__device__ __forceinline__ void comp_add(float& s, float& c, float b) {
  const float t = __fadd_rn(s, b);
  c = __fadd_rn(c, fabsf(s) >= fabsf(b) ? __fadd_rn(__fsub_rn(s, t), b)
                                        : __fadd_rn(__fsub_rn(b, t), s));
  s = t;
}

// (s, c) += (s2, c2)
__device__ __forceinline__ void comp_merge(float& s, float& c, float s2, float c2) {
  comp_add(s, c, s2);
  c = __fadd_rn(c, c2);
}

__global__ void __launch_bounds__(THREADS)
    pairwise_kde_kernel(const float* __restrict__ xq, const float* __restrict__ x,
                        float* __restrict__ out_s, float* __restrict__ out_c,
                        int mq, int mk, int d, int m, float inv_two_h2,
                        int tiles_per_split) {
  __shared__ Smem sm;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int q0 = blockIdx.x * BQ;
  const int n_cols = min(mk, m);
  const int n_tiles = (n_cols + BK - 1) / BK;
  const int t_begin = blockIdx.y * tiles_per_split;
  const int t_end = min(t_begin + tiles_per_split, n_tiles);

  row_norms(xq, q0, mq, d, sm);
  float sum[RPW];
  float comp[RPW];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    sum[i] = 0.f;
    comp[i] = 0.f;
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int c0 = t * BK;
    float d2[RPW][CPL];
    tile_d2(xq, x, q0, c0, mq, n_cols, d, sm, d2);
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        if (c0 + 32 * j + lane < n_cols) {
          comp_add(sum[i], comp[i], expf(__fmul_rn(-fmaxf(d2[i][j], 0.f), inv_two_h2)));
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    float s = sum[i];
    float c = comp[i];
#pragma unroll
    for (int off = 16; off > 0; off /= 2) {
      const float s2 = __shfl_xor_sync(FULL, s, off);
      const float c2 = __shfl_xor_sync(FULL, c, off);
      comp_merge(s, c, s2, c2);
    }
    const int gq = q0 + warp * RPW + i;
    if (lane == 0 && gq < mq) {
      const long long o = static_cast<long long>(blockIdx.y) * mq + gq;
      out_s[o] = s;
      out_c[o] = c;
    }
  }
}

// Folds the (splits, mq) partial pairs of each row in split order.
__global__ void kde_fold_kernel(const float* __restrict__ part_s,
                                const float* __restrict__ part_c,
                                float* __restrict__ sums,
                                float* __restrict__ comps, int mq, int splits) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= mq) return;
  float s = 0.f;
  float c = 0.f;
  for (int k = 0; k < splits; ++k) {
    comp_merge(s, c, part_s[static_cast<long long>(k) * mq + row],
               part_c[static_cast<long long>(k) * mq + row]);
  }
  sums[row] = s;
  comps[row] = c;
}

int column_tiles(int mk, int m) { return (min(mk, m) + BK - 1) / BK; }

}  // namespace

// How many column splits repro_pairwise_kde uses for this shape: the caller
// sizes its scratch (2, splits, mq) from it.
extern "C" int repro_pairwise_kde_splits(int mq, int mk, int m) {
  return mq > 0 ? splits(mq, column_tiles(mk, m)) : 1;
}

// xq (mq, d), x (mk, d) float32 contiguous; sums, comps float32 (mq,);
// scratch float32 (2, splits, mq) when splits > 1 (else unused). Columns
// >= m are excluded.
extern "C" int repro_pairwise_kde(const void* xq, const void* x, void* sums,
                                  void* comps, void* scratch, int mq, int mk,
                                  int d, int m, float inv_two_h2, int n_splits,
                                  void* stream) {
  if (n_splits != repro_pairwise_kde_splits(mq, mk, m)) {
    return static_cast<int>(cudaErrorInvalidValue);  // scratch sized for another shape
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((mq + BQ - 1) / BQ, n_splits);
  const int per = tiles_per_split(mq, column_tiles(mk, m));
  float* part_s = n_splits == 1 ? static_cast<float*>(sums) : static_cast<float*>(scratch);
  float* part_c = n_splits == 1 ? static_cast<float*>(comps)
                                : part_s + static_cast<long long>(n_splits) * mq;
  pairwise_kde_kernel<<<grid, THREADS, 0, s>>>(
      static_cast<const float*>(xq), static_cast<const float*>(x), part_s,
      part_c, mq, mk, d, m, inv_two_h2, per);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0 || n_splits == 1) return err;
  kde_fold_kernel<<<(mq + 255) / 256, 256, 0, s>>>(
      part_s, part_c, static_cast<float*>(sums), static_cast<float*>(comps), mq,
      n_splits);
  return static_cast<int>(cudaGetLastError());
}
