// K5 — silhouette antialias backward.
//
// Replaces tssplat_tpu/ops/pallas_raster.py _aa_halo_bwd_kernel (:1200, the
// pl.pallas_call at :1307 in aa_halo_backward), which takes jax.vjp of the
// pair math, plus the autodiff of the tile-border pass. Computes d g6
// (B,6,H,W) of K4's output under the cotangent ct (B,H,W) with the backward
// of the pair math derived by hand (aa_pair.cuh aa::grad): the gradient flows
// only through the crossing t into the owner pixel's six xy channels.
//
// Bound on the H100: bytes — the ids of every pixel and the six output
// channels written everywhere (28 B/px), plus z, g6, gaux and ct (48 B) of
// the pixels on a silhouette. Design: one thread per pixel gathers the
// contributions of the <= 4 pairs in which its pixel can be the owner
// (right and below as pixel a, left and above as pixel b) and writes its
// d g6 once: no atomics, and the result is deterministic.

#include "aa_pair.cuh"

namespace {

__device__ inline void add_pair(const aa::Pixel& A, const aa::Pixel& B,
                                float ct_a, float ct_b, bool self_is_a,
                                float d[6]) {
  const aa::Pair P = aa::eval(A, B);
  if (!P.valid || P.owner_a != self_is_a) return;
  float c[6];
  aa::grad(A, B, P, ct_a, ct_b, c);
#pragma unroll
  for (int j = 0; j < 6; ++j) d[j] += c[j];
}

__global__ void aa_bwd_kernel(aa::View v, const float* __restrict__ ct,
                              float* __restrict__ dg6) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y * blockDim.y + threadIdx.y;
  v.b = blockIdx.z;
  if (r >= v.H || c >= v.W) return;
  const int id = v.id(r, c);
  float d[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (id > 0) {              // only a foreground pixel can own a pair
    const float* ctv = ct + v.b * v.HW;
    const int id_r = c + 1 < v.W ? v.id(r, c + 1) : id;
    const int id_l = c > 0 ? v.id(r, c - 1) : id;
    const int id_d = r + 1 < v.H ? v.id(r + 1, c) : id;
    const int id_u = r > 0 ? v.id(r - 1, c) : id;
    if (aa::differ(id, id_r) || aa::differ(id, id_l) ||
        aa::differ(id, id_d) || aa::differ(id, id_u)) {
      const aa::Pixel P = aa::load(v, r, c, id);
      const float ct_p = ctv[v.at(r, c)];
      if (aa::differ(id, id_r))
        add_pair(P, aa::load(v, r, c + 1, id_r), ct_p, ctv[v.at(r, c + 1)],
                 true, d);
      if (aa::differ(id_l, id))
        add_pair(aa::load(v, r, c - 1, id_l), P, ctv[v.at(r, c - 1)], ct_p,
                 false, d);
      if (aa::differ(id, id_d))
        add_pair(P, aa::load(v, r + 1, c, id_d), ct_p, ctv[v.at(r + 1, c)],
                 true, d);
      if (aa::differ(id_u, id))
        add_pair(aa::load(v, r - 1, c, id_u), P, ctv[v.at(r - 1, c)], ct_p,
                 false, d);
    }
  }
  const long long q = v.at(r, c);
#pragma unroll
  for (int j = 0; j < 6; ++j) dg6[(v.b * 6 + j) * v.HW + q] = d[j];
}

}  // namespace

extern "C" int tss_aa_bwd_launch(const void* ids, const void* z,
                                 const void* g6, const void* gaux,
                                 const void* ct, int B, int H, int W,
                                 void* dg6, void* stream) {
  aa::View v{static_cast<const int*>(ids), static_cast<const float*>(z),
             static_cast<const float*>(g6), static_cast<const float*>(gaux),
             H, W, (long long)H * W, 0};
  const dim3 block(32, 8);
  const dim3 grid((W + 31) / 32, (H + 7) / 8, B);
  aa_bwd_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      v, static_cast<const float*>(ct), static_cast<float*>(dg6));
  return static_cast<int>(cudaGetLastError());
}
