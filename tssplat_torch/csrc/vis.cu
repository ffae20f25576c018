// K1 — tile-binned visibility with winner rows.
//
// Replaces tssplat_tpu/ops/pallas_raster.py _vis_kernel_flat (:197, the
// pl.pallas_call at :838, emit_g mode). Per pixel: walk the binned faces of
// its screen tile and keep the nearest covering one (tss::depth_test,
// vis_common.cuh). Outputs id+1 and z per pixel and, with EMIT_G, the
// winner's rows: g6 = (ax,bx,cx,ay,by,cy), gaux = (nbr0,nbr1,nbr2,
// sign(inv_area)), channel-major. Every output is 0 on background.
//
// Bound on the H100: the 12 output channels written once (48 B/px) — the
// per-candidate arithmetic (~30 flops x candidates x 256 px per tile) is far
// below the f32 rate at this scene's tile occupancy. Design: one CTA per
// (view, 16x16 tile), one thread per pixel; the tile's face rows are staged
// through shared memory in chunks of 256 (one 64-byte row per thread, read
// by all threads as a broadcast), the running best (z, id) stays in
// registers, and the winner's row is fetched once at the end instead of
// carrying 10 channels through the loop. Coalesced channel-major stores.

#include "vis_common.cuh"

namespace {

constexpr int kTile = 16;
constexpr int kThreads = kTile * kTile;

template <bool EMIT_G>
__global__ void __launch_bounds__(kThreads) vis_kernel(
    const float4* __restrict__ table,      // (B, F, 4) float4 = (B, F, 16)
    const int* __restrict__ tile_start,    // (B * ntiles)
    const int* __restrict__ tile_count,    // (B * ntiles)
    const int* __restrict__ faces,         // sorted face ids
    int F, int H, int W, int ntx, int ntiles,
    int* __restrict__ ids_out, float* __restrict__ z_out,
    float* __restrict__ g6, float* __restrict__ gaux) {
  __shared__ float4 s_row[kThreads][3];    // ax..z1 | z2,inv_area,.. (12 floats)
  __shared__ int s_id[kThreads];

  const int b = blockIdx.y;
  const int t = blockIdx.x;
  const int tid = threadIdx.y * kTile + threadIdx.x;
  const int col = (t % ntx) * kTile + threadIdx.x;
  const int row = (t / ntx) * kTile + threadIdx.y;
  const float px = tss::ndc_center(col, W);
  const float py = tss::ndc_center(row, H);

  const int slot = b * ntiles + t;
  const int start = tile_start[slot];
  const int count = tile_count[slot];
  const float4* tbl = table + (size_t)b * F * 4;

  float best_z = CUDART_INF_F;
  int best_id = 0;
  for (int base = 0; base < count; base += kThreads) {
    const int n = min(kThreads, count - base);
    __syncthreads();
    if (tid < n) {
      const int f = faces[start + base + tid];
      s_id[tid] = f + 1;
      s_row[tid][0] = tbl[(size_t)f * 4 + 0];
      s_row[tid][1] = tbl[(size_t)f * 4 + 1];
      s_row[tid][2] = tbl[(size_t)f * 4 + 2];
    }
    __syncthreads();
    for (int i = 0; i < n; ++i) {
      tss::depth_test(s_row[i][0], s_row[i][1], s_row[i][2], s_id[i], px, py,
                      best_z, best_id);
    }
  }
  if (row >= H || col >= W) return;

  const size_t HW = (size_t)H * W;
  const size_t q = (size_t)row * W + col;
  ids_out[(size_t)b * HW + q] = best_id;
  z_out[(size_t)b * HW + q] = best_id > 0 ? best_z : 0.0f;
  if (EMIT_G) {
    tss::emit_winner_rows(tbl, best_id, HW, g6 + (size_t)b * 6 * HW + q,
                          gaux + (size_t)b * 4 * HW + q);
  }
}

}  // namespace

extern "C" int tss_vis_launch(const void* table, const void* tile_start,
                              const void* tile_count, const void* faces,
                              int B, int F, int H, int W, int nty, int ntx,
                              int emit_g, void* ids_out, void* z_out,
                              void* g6, void* gaux, void* stream) {
  const dim3 grid(nty * ntx, B);
  const dim3 block(kTile, kTile);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (emit_g) {
    vis_kernel<true><<<grid, block, 0, s>>>(
        static_cast<const float4*>(table), static_cast<const int*>(tile_start),
        static_cast<const int*>(tile_count), static_cast<const int*>(faces),
        F, H, W, ntx, nty * ntx, static_cast<int*>(ids_out),
        static_cast<float*>(z_out), static_cast<float*>(g6),
        static_cast<float*>(gaux));
  } else {
    vis_kernel<false><<<grid, block, 0, s>>>(
        static_cast<const float4*>(table), static_cast<const int*>(tile_start),
        static_cast<const int*>(tile_count), static_cast<const int*>(faces),
        F, H, W, ntx, nty * ntx, static_cast<int*>(ids_out),
        static_cast<float*>(z_out), nullptr, nullptr);
  }
  return static_cast<int>(cudaGetLastError());
}
