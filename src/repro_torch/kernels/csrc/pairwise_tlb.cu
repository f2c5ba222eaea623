// K2: all-prefix pairwise TLB table.
//
// Replaces src/repro/kernels/pairwise_tlb/pairwise_tlb.py::pairwise_tlb_pallas
// (_tlb_kernel). For P pairs (xi, xj) and a (d, K) basis V it writes
//   out[p, k] = sqrt(clip(sum_{c<=k} ((xi_p - xj_p) . V[:, c])^2 / ||xi_p - xj_p||^2, 0, 1))
// and 1 for coincident pairs (||diff||^2 <= 1e-30).
//
// What bounds it on the H100: DROP sends 100-400 new pairs per batch at
// d = 1024 and K <= ~100, i.e. 1-3 MB and ~0.1 GFLOP per call: a few
// microseconds of either bytes or operations, so a call is bound by its
// launch and by the host round trip that reads the table back.
//
// Design:
// * One block owns 16 pairs and every column of the table. The TPU kernel
//   carries the prefix sum across a sequential K grid axis; here the block
//   walks the K tiles in order and keeps the running sum in shared memory.
// * The squared distance ||diff||^2 is computed once per pair, before the
//   K loop, one warp per pair.
// * Per K tile the projection z = diff @ V[:, tile] is a small product
//   over d in chunks through shared memory (IEEE float32 FMAs, no TF32);
//   z^2 is then prefix-scanned along the tile with warp shuffles.
// * Ragged P, d and K are masked in the kernel; nothing is padded.
#include "common.cuh"

namespace {

constexpr int BP = 16;       // pairs per block
constexpr int BKC = 64;      // table columns per K tile
constexpr int DC = 64;       // d per shared-memory chunk
constexpr int THREADS = 256;
constexpr int PAIRS_PER_THREAD = BP * BKC / THREADS;  // 4
constexpr int PAIR_GROUPS = THREADS / BKC;            // 4
constexpr int WARPS = THREADS / 32;

__global__ void __launch_bounds__(THREADS)
    pairwise_tlb_kernel(const float* __restrict__ xi,
                        const float* __restrict__ xj,
                        const float* __restrict__ v, float* __restrict__ out,
                        int p_total, int d, int k_total) {
  __shared__ float ds[BP][DC + 1];
  __shared__ float vs[DC][BKC];
  __shared__ float zs[BP][BKC];
  __shared__ float den[BP];
  __shared__ float carry[BP];

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int p0 = blockIdx.x * BP;

  // ||diff||^2 once per pair: warp w sums pairs w and w + WARPS.
  for (int p = warp; p < BP; p += WARPS) {
    float s = 0.f;
    const int gp = p0 + p;
    if (gp < p_total) {
      const long long base = static_cast<long long>(gp) * d;
      for (int c = lane; c < d; c += 32) {
        const float df = xi[base + c] - xj[base + c];
        s = fmaf(df, df, s);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off /= 2) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) {
      den[p] = s;
      carry[p] = 0.f;
    }
  }
  __syncthreads();

  const int col = tid % BKC;
  const int pg = tid / BKC;
  for (int k0 = 0; k0 < k_total; k0 += BKC) {
    float acc[PAIRS_PER_THREAD];
#pragma unroll
    for (int i = 0; i < PAIRS_PER_THREAD; ++i) acc[i] = 0.f;

    for (int d0 = 0; d0 < d; d0 += DC) {
#pragma unroll
      for (int r = 0; r < BP * DC / THREADS; ++r) {
        const int e = tid + r * THREADS;
        const int pp = e / DC;
        const int cc = e % DC;
        const int gp = p0 + pp;
        const int gc = d0 + cc;
        float df = 0.f;
        if (gp < p_total && gc < d) {
          const long long at = static_cast<long long>(gp) * d + gc;
          df = xi[at] - xj[at];
        }
        ds[pp][cc] = df;
      }
#pragma unroll 4
      for (int r = 0; r < DC * BKC / THREADS; ++r) {
        const int e = tid + r * THREADS;
        const int rr = e / BKC;
        const int cc = e % BKC;
        const int gr = d0 + rr;
        const int gc = k0 + cc;
        vs[rr][cc] = (gr < d && gc < k_total)
                         ? v[static_cast<long long>(gr) * k_total + gc]
                         : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int c = 0; c < DC; ++c) {
        const float vv = vs[c][col];
#pragma unroll
        for (int i = 0; i < PAIRS_PER_THREAD; ++i)
          acc[i] = fmaf(ds[pg + PAIR_GROUPS * i][c], vv, acc[i]);
      }
      __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < PAIRS_PER_THREAD; ++i)
      zs[pg + PAIR_GROUPS * i][col] = acc[i] * acc[i];
    __syncthreads();

    // Inclusive scan of z^2 along the tile: warp w scans pairs w, w + 8;
    // lane l holds columns l and l + 32.
    for (int p = warp; p < BP; p += WARPS) {
      float lo = zs[p][lane];
      float hi = zs[p][lane + 32];
#pragma unroll
      for (int off = 1; off < 32; off *= 2) {
        const float lo_up = __shfl_up_sync(0xffffffffu, lo, off);
        const float hi_up = __shfl_up_sync(0xffffffffu, hi, off);
        if (lane >= off) {
          lo += lo_up;
          hi += hi_up;
        }
      }
      const float lo_total = __shfl_sync(0xffffffffu, lo, 31);
      const float base = carry[p];
      const float cum_lo = base + lo;
      const float cum_hi = base + (lo_total + hi);
      const int gp = p0 + p;
      if (gp < p_total) {
        const float dn = den[p];
        const float dn_safe = fmaxf(dn, 1e-30f);
        const long long row = static_cast<long long>(gp) * k_total;
        const int c_lo = k0 + lane;
        const int c_hi = k0 + lane + 32;
        if (c_lo < k_total)
          out[row + c_lo] =
              dn > 1e-30f ? sqrtf(fminf(fmaxf(cum_lo / dn_safe, 0.f), 1.f)) : 1.f;
        if (c_hi < k_total)
          out[row + c_hi] =
              dn > 1e-30f ? sqrtf(fminf(fmaxf(cum_hi / dn_safe, 0.f), 1.f)) : 1.f;
      }
      __syncwarp();
      if (lane == 31) carry[p] = cum_hi;
    }
    __syncthreads();
  }
}

}  // namespace

// out (P, K) from xi, xj (P, d) and v (d, K); all float32, contiguous.
extern "C" int repro_pairwise_tlb(const void* xi, const void* xj,
                                  const void* v, void* out, int p, int d,
                                  int k, void* stream) {
  const dim3 grid((p + BP - 1) / BP);
  pairwise_tlb_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xi), static_cast<const float*>(xj),
      static_cast<const float*>(v), static_cast<float*>(out), p, d, k);
  return static_cast<int>(cudaGetLastError());
}
