// K2a / K2b — visibility over capped per-tile candidate lists.
//
// Replaces tssplat_tpu/ops/pallas_raster.py _vis_kernel (:53, K2a) and
// _vis_kernel_g (:113, K2b), both launched by the pl.pallas_call at :884.
// The JAX package takes them for scenes too large for its flat layout; the
// port takes them for the same scenes (ops/binning.py uses_capped_layout).
// Per pixel of an 8x128 tile: walk the tile's first counts[t] entries of
// its row of the dense (B*ntiles, k) candidate matrix (ascending face ids,
// at most k) and keep the nearest covering face (tss::depth_test, the same
// test as K1). Outputs id+1 and z per pixel (K2a) and, with EMIT_G (K2b),
// the winner's rows g6 (B,6,H,W) and gaux (B,4,H,W), channel-major; every
// output is 0 on background. The JAX kernels read their rows from a shared
// SMEM table or from a per-tile pre-gathered block; here the candidate ids
// index the per-face table in global memory, which serves both.
//
// Bound on the H100: operations. Each candidate is tested against all 1024
// pixels of its tile (~30 flops each), four times K1's 256, so at the
// multi-sphere scene's ~10^5 (tile, candidate) pairs the f32 work exceeds
// the bytes (table + candidate ids + 8 or 48 B/px of outputs). Design: one
// CTA of 256 threads per (view, tile), each thread owning 4 pixels (rows
// r, r+2, r+4, r+6 of one column: neighbouring threads, neighbouring
// columns, coalesced stores); candidates are staged through shared memory
// in chunks of 256 (ids, then their 48-byte test rows, read by all threads
// as broadcasts); the four running (z, id) pairs stay in registers and the
// winner's row is read once at the end, as in K1. The walk stops at
// counts[t], so empty tiles cost one load.

#include "vis_common.cuh"

namespace {

constexpr int kTileH = 8;
constexpr int kTileW = 128;
constexpr int kThreads = 256;
constexpr int kPix = kTileH * kTileW / kThreads;   // 4 pixels per thread

template <bool EMIT_G>
__global__ void __launch_bounds__(kThreads) vis_capped_kernel(
    const float4* __restrict__ table,      // (B, F, 4) float4 = (B, F, 16)
    const int* __restrict__ counts,        // (B * ntiles), each <= k
    const int* __restrict__ cand,          // (B * ntiles, k) face ids
    int F, int H, int W, int ntx, int ntiles, int k,
    int* __restrict__ ids_out, float* __restrict__ z_out,
    float* __restrict__ g6, float* __restrict__ gaux) {
  __shared__ float4 s_row[kThreads][3];
  __shared__ int s_id[kThreads];

  const int b = blockIdx.y;
  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int row0 = (t / ntx) * kTileH;
  const int col = (t % ntx) * kTileW + tid % kTileW;
  const int rsub = tid / kTileW;                   // 0 or 1

  float px = tss::ndc_center(col, W);
  float py[kPix], best_z[kPix];
  int best_id[kPix];
#pragma unroll
  for (int p = 0; p < kPix; ++p) {
    py[p] = tss::ndc_center(row0 + rsub + 2 * p, H);
    best_z[p] = CUDART_INF_F;
    best_id[p] = 0;
  }

  const int slot = b * ntiles + t;
  const int count = counts[slot];
  const int* tile_cand = cand + (size_t)slot * k;
  const float4* tbl = table + (size_t)b * F * 4;

  for (int base = 0; base < count; base += kThreads) {
    const int n = min(kThreads, count - base);
    __syncthreads();
    if (tid < n) {
      const int f = tile_cand[base + tid];
      s_id[tid] = f + 1;
      s_row[tid][0] = tbl[(size_t)f * 4 + 0];
      s_row[tid][1] = tbl[(size_t)f * 4 + 1];
      s_row[tid][2] = tbl[(size_t)f * 4 + 2];
    }
    __syncthreads();
    for (int i = 0; i < n; ++i) {
      const float4 r0 = s_row[i][0];
      const float4 r1 = s_row[i][1];
      const float4 r2 = s_row[i][2];
      const int id1 = s_id[i];
#pragma unroll
      for (int p = 0; p < kPix; ++p) {
        tss::depth_test(r0, r1, r2, id1, px, py[p], best_z[p], best_id[p]);
      }
    }
  }

  const size_t HW = (size_t)H * W;
#pragma unroll
  for (int p = 0; p < kPix; ++p) {
    const size_t q = (size_t)(row0 + rsub + 2 * p) * W + col;
    ids_out[(size_t)b * HW + q] = best_id[p];
    z_out[(size_t)b * HW + q] = best_id[p] > 0 ? best_z[p] : 0.0f;
    if (EMIT_G) {
      tss::emit_winner_rows(tbl, best_id[p], HW,
                            g6 + (size_t)b * 6 * HW + q,
                            gaux + (size_t)b * 4 * HW + q);
    }
  }
}

template <bool EMIT_G>
int launch(const void* table, const void* counts, const void* cand, int B,
           int F, int H, int W, int k, void* ids_out, void* z_out, void* g6,
           void* gaux, void* stream) {
  const int nty = H / kTileH, ntx = W / kTileW;
  const dim3 grid(nty * ntx, B);
  vis_capped_kernel<EMIT_G><<<grid, kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(table), static_cast<const int*>(counts),
      static_cast<const int*>(cand), F, H, W, ntx, nty * ntx, k,
      static_cast<int*>(ids_out), static_cast<float*>(z_out),
      static_cast<float*>(g6), static_cast<float*>(gaux));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K2a: ids + z. H % 8 == 0 and W % 128 == 0 (checked by the wrapper).
extern "C" int tss_vis_capped_launch(const void* table, const void* counts,
                                     const void* cand, int B, int F, int H,
                                     int W, int k, void* ids_out, void* z_out,
                                     void* stream) {
  return launch<false>(table, counts, cand, B, F, H, W, k, ids_out, z_out,
                       nullptr, nullptr, stream);
}

// K2b: ids + z + the winner's rows g6, gaux.
extern "C" int tss_vis_capped_g_launch(const void* table, const void* counts,
                                       const void* cand, int B, int F, int H,
                                       int W, int k, void* ids_out,
                                       void* z_out, void* g6, void* gaux,
                                       void* stream) {
  return launch<true>(table, counts, cand, B, F, H, W, k, ids_out, z_out, g6,
                      gaux, stream);
}
