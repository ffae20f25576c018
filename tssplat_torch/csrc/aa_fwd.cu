// K4 — silhouette antialias forward, all pixel pairs.
//
// Replaces tssplat_tpu/ops/pallas_raster.py _aa_halo_fwd_kernel (:1171, the
// pl.pallas_call at :1278 in aa_halo_forward) together with the tile-border
// pass _aa_boundary_deltas (rasterize.py:1082) that completes it: the output
// equals antialias_silhouette_halo as a whole, and the dense antialias
// (rasterize.py:975) on the silhouette. Per pixel p:
//   out(p) = fg(p) + delta_a(p, right) + delta_b(left, p)
//                  + delta_a(p, below) + delta_b(above, p)
// in the dense chain's summation order.
//
// Bound on the H100: bytes — the winner ids of every pixel and the output
// (8 B/px), plus z, g6 and gaux (44 B) of the few pixels on a silhouette.
// Design: one thread per pixel, no tiles, no atomics. A thread reads its own
// and its four neighbours' ids (coalesced, mostly from L1) and returns fg
// unless some pair straddles a silhouette; only then does it read the rows
// of the pixels involved. The TPU's interior/boundary split and activity
// flags are not needed: every pair is evaluated where its pixels live.

#include "aa_pair.cuh"

namespace {

__global__ void aa_fwd_kernel(aa::View v, float* __restrict__ out) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y * blockDim.y + threadIdx.y;
  v.b = blockIdx.z;
  if (r >= v.H || c >= v.W) return;
  const int id = v.id(r, c);
  const int id_r = c + 1 < v.W ? v.id(r, c + 1) : id;
  const int id_l = c > 0 ? v.id(r, c - 1) : id;
  const int id_d = r + 1 < v.H ? v.id(r + 1, c) : id;
  const int id_u = r > 0 ? v.id(r - 1, c) : id;
  float o = id > 0 ? 1.0f : 0.0f;
  if (aa::differ(id, id_r) || aa::differ(id, id_l) || aa::differ(id, id_d) ||
      aa::differ(id, id_u)) {
    const aa::Pixel P = aa::load(v, r, c, id);
    if (aa::differ(id, id_r)) o += aa::eval(P, aa::load(v, r, c + 1, id_r)).delta_a;
    if (aa::differ(id_l, id)) o += aa::eval(aa::load(v, r, c - 1, id_l), P).delta_b;
    if (aa::differ(id, id_d)) o += aa::eval(P, aa::load(v, r + 1, c, id_d)).delta_a;
    if (aa::differ(id_u, id)) o += aa::eval(aa::load(v, r - 1, c, id_u), P).delta_b;
  }
  out[v.b * v.HW + v.at(r, c)] = o;
}

}  // namespace

extern "C" int tss_aa_fwd_launch(const void* ids, const void* z,
                                 const void* g6, const void* gaux, int B,
                                 int H, int W, void* out, void* stream) {
  aa::View v{static_cast<const int*>(ids), static_cast<const float*>(z),
             static_cast<const float*>(g6), static_cast<const float*>(gaux),
             H, W, (long long)H * W, 0};
  const dim3 block(32, 8);
  const dim3 grid((W + 31) / 32, (H + 7) / 8, B);
  aa_fwd_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      v, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
