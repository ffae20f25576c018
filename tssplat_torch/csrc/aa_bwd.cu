// K5 — silhouette antialias backward.
//
// Replaces tssplat_tpu/ops/pallas_raster.py _aa_halo_bwd_kernel (:1200, the
// pl.pallas_call at :1307 in aa_halo_backward), which takes jax.vjp of the
// pair math, plus the autodiff of the tile-border pass. Computes d g6
// (B,6,H,W) of K4's output under the cotangent ct (B,H,W) with the backward
// of the pair math derived by hand (aa_pair.cuh aa::grad_terms): the gradient
// flows only through the crossing t into the owner pixel's six xy
// channels. Per pixel, the pairs it owns add in the order right, left,
// below, above, as the plain version sums them; no atomics, deterministic.
//
// Bound on the H100: bytes — the ids of every pixel and the six output
// channels written everywhere (28 B/px), plus K4's z and owner rows and ct
// (4 B) at the pixels of a valid pair. Design: K4's tile (aa_pair.cuh). A run with
// no differing pair stores its zeros at once, six 16-byte stores, one a
// plane. Each listed pair is evaluated once, with its gradient where it is
// valid: the owner's four non-zero terms (aa::grad_terms) and its flags
// are kept by the pair's position, so the last phase only adds each
// pixel's owned terms. The zeros are most of the time (PERF.md).

#include <cstdint>

#include "aa_pair.cuh"

namespace {

// Per pair position: valid | owner_a << 1 | k << 2, and for a valid pair
// the owner's four non-zero gradient terms (aa::grad_terms).
struct Shared {
  aa::Tile tile;
  float4 terms[aa::kNP];
  unsigned char flags[aa::kNP];
};

__device__ inline void store_run(float* dg6, const aa::View& v,
                                 const aa::Run& u, bool vec,
                                 float d[aa::kRun][6]) {
  if (u.r >= v.H || u.c >= v.W) return;
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    float* p = dg6 + v.at(6, k, u.r, u.c);
    if (vec) {
      *reinterpret_cast<float4*>(p) =
          make_float4(d[0][k], d[1][k], d[2][k], d[3][k]);
    } else {
#pragma unroll
      for (int j = 0; j < aa::kRun; ++j)
        if (u.c + j < v.W) p[j] = d[j][k];
    }
  }
}

// Add the terms of the pair at position p if it is valid and owned by the
// pixel that is its a (self_a) or its b.
__device__ inline void add_owned(const Shared& s, int p, bool self_a,
                                 float d[6]) {
  const unsigned f = s.flags[p];
  if ((f & 1u) && ((f & 2u) != 0u) == self_a)
    aa::add_terms(d, (int)(f >> 2), s.terms[p]);
}

__global__ void __launch_bounds__(aa::kThreads, aa::kMinBlocks)
aa_bwd_kernel(aa::View v, bool vec, const float* __restrict__ ct,
              float* __restrict__ dg6) {
  __shared__ Shared s;
  v.b = blockIdx.z;
  const int r0 = blockIdx.y * aa::kTileH, c0 = blockIdx.x * aa::kTileW;
  float d[aa::kRun][6];
#pragma unroll
  for (int j = 0; j < aa::kRun; ++j)
#pragma unroll
    for (int k = 0; k < 6; ++k) d[j][k] = 0.0f;
  const aa::Run u = aa::find_pairs(v, r0, c0, vec);
  if (!u.touched()) store_run(dg6, v, u, vec, d);
  if (!aa::tile_has_pairs(s.tile, u)) return;
  aa::collect(s.tile, u);
  aa::evaluate(
      s.tile, v, r0, c0,
      [&](int p, const aa::Pair& P, const aa::Owner& o, int ra, int ca,
          int rb, int cb, int id_a, int id_b) {
        s.flags[p] = (unsigned char)((P.valid ? 1u : 0u) |
                                     (P.owner_a ? 2u : 0u) |
                                     ((unsigned)P.k << 2));
        if (!P.valid) return;
        s.terms[p] = aa::grad_terms(
            o, aa::ndc(ca, v.W), aa::ndc(v.row0 + ra, v.full_h),
            aa::ndc(cb, v.W), aa::ndc(v.row0 + rb, v.full_h), P,
            aa::coverage(id_a), aa::coverage(id_b),
            __ldg(ct + v.at(ra, ca)), __ldg(ct + v.at(rb, cb)));
      });
  if (!u.touched()) return;
#pragma unroll
  for (int j = 0; j < aa::kRun; ++j) {
    const int c = u.lc + j;
    const unsigned bit = 1u << j;
    if (u.right & bit) add_owned(s, aa::hpos(u.lr, c), true, d[j]);
    if (u.left & bit) add_owned(s, aa::hpos(u.lr, c - 1), false, d[j]);
    if (u.down & bit) add_owned(s, aa::vpos(u.lr, c), true, d[j]);
    if (u.up & bit) add_owned(s, aa::vpos(u.lr - 1, c), false, d[j]);
  }
  store_run(dg6, v, u, vec, d);
}

}  // namespace

extern "C" int tss_aa_bwd_launch(const void* ids, const void* z,
                                 const void* g6, const void* gaux,
                                 const void* ct, int B, int H, int W,
                                 int row0, int full_h, void* dg6,
                                 void* stream) {
  aa::View v{static_cast<const int*>(ids), static_cast<const float*>(z),
             static_cast<const float*>(g6), static_cast<const float*>(gaux),
             H, W, (long long)H * W, 0, row0, full_h};
  const bool vec = W % 4 == 0 && reinterpret_cast<uintptr_t>(ids) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(dg6) % 16 == 0;
  const dim3 grid((W + aa::kTileW - 1) / aa::kTileW,
                  (H + aa::kTileH - 1) / aa::kTileH, B);
  aa_bwd_kernel<<<grid, aa::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      v, vec, static_cast<const float*>(ct), static_cast<float*>(dg6));
  return static_cast<int>(cudaGetLastError());
}
