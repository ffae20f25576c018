// Per-pixel face evaluation, winner merge and winner-row values shared by K1
// (vis.cu) and K2a/K2b (vis_capped.cu), so the two searches cannot drift
// apart: K1 merges in registers along its walk (depth_test), K2a/K2b merge
// with an atomic minimum on a packed (z, id) key.
//
// Parity: pixel centres and edge functions are evaluated in exactly the
// order of pallas_raster.py:92-104 (and :229-268); the libraries are built
// with -fmad=false so no multiply-add is contracted (a contracted edge
// function flips ids at pixels lying on an edge against the plain version).

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace tss {

// NDC centre of pixel index idx along an axis of n pixels
__device__ __forceinline__ float ndc_center(int idx, int n) {
  return ((float)idx + 0.5f) / (float)n * 2.0f - 1.0f;
}

// A face row is r0 = ax,ay,bx,by; r1 = cx,cy,z0,z1; r2 = z2,inv_area,..
// The first product of each edge function depends on the pixel's row only:
// a search that walks along a row computes it once per row.
struct RowTerms {
  float t0, t1, t2;
};

__device__ __forceinline__ RowTerms face_row_terms(const float4& r0,
                                                   const float4& r1,
                                                   float py) {
  const float ax = r0.x, ay = r0.y, bx = r0.z, by = r0.w;
  const float cx = r1.x, cy = r1.y;
  return {(cx - bx) * (py - by), (ax - cx) * (py - cy), (bx - ax) * (py - ay)};
}

// The face evaluated at the pixel centre px of the row whose terms are
// ``rt``: true when it covers the pixel (all three edges >= 0, inv_area != 0
// and z in [-1, 1]), with its depth in ``z``.
__device__ __forceinline__ bool face_covers_in_row(const float4& r0,
                                                   const float4& r1,
                                                   const float4& r2,
                                                   const RowTerms& rt,
                                                   float px, float& z) {
  const float ax = r0.x, ay = r0.y, bx = r0.z, by = r0.w;
  const float cx = r1.x, cy = r1.y, z0 = r1.z, z1 = r1.w;
  const float z2 = r2.x, inv_area = r2.y;
  const float e0 = (rt.t0 - (cy - by) * (px - bx)) * inv_area;
  const float e1 = (rt.t1 - (ay - cy) * (px - cx)) * inv_area;
  const float e2 = (rt.t2 - (by - ay) * (px - ax)) * inv_area;
  z = e0 * z0 + e1 * z1 + e2 * z2;
  return e0 >= 0.0f && e1 >= 0.0f && e2 >= 0.0f && inv_area != 0.0f &&
         z >= -1.0f && z <= 1.0f;
}

// The face evaluated at pixel centre (px, py). K1 and K2a/K2b both evaluate
// through these functions, the same operations in the same order, so their
// edges and depths round alike.
__device__ __forceinline__ bool face_covers(const float4& r0, const float4& r1,
                                            const float4& r2, float px,
                                            float py, float& z) {
  return face_covers_in_row(r0, r1, r2, face_row_terms(r0, r1, py), px, z);
}

// Merge one evaluated face (id+1 ``id1``) into a pixel's running winner:
// the smallest z wins and an exact tie goes to the smaller id.
__device__ __forceinline__ void merge_winner(bool cov, float z, int id1,
                                             float& best_z, int& best_id) {
  const float zc = cov ? z : CUDART_INF_F;
  if (zc < best_z || (zc == best_z && cov && id1 < best_id)) {
    best_z = zc;
    best_id = id1;
  }
}

// Evaluation and merge in one call: K1's walk over a tile's faces.
__device__ __forceinline__ void depth_test(const float4& r0, const float4& r1,
                                           const float4& r2, int id1,
                                           float px, float py,
                                           float& best_z, int& best_id) {
  float z;
  const bool cov = face_covers(r0, r1, r2, px, py, z);
  merge_winner(cov, z, id1, best_z, best_id);
}

// The winner's ten row values at one pixel: v[0..5] = (ax,bx,cx,ay,by,cy),
// v[6..9] = (nbr0,nbr1,nbr2,sign(inv_area)); all zero on background
// (best_id == 0). ``tbl`` is the view's (F, 4) float4 table.
__device__ __forceinline__ void winner_row_values(const float4* tbl,
                                                  int best_id, float v[10]) {
  float4 r0 = make_float4(0.f, 0.f, 0.f, 0.f), r1 = r0, r2 = r0, r3 = r0;
  if (best_id > 0) {
    const float4* r = tbl + (size_t)(best_id - 1) * 4;
    r0 = r[0]; r1 = r[1]; r2 = r[2]; r3 = r[3];
  }
  const float inv_area = r2.y;
  v[0] = r0.x;    // ax
  v[1] = r0.z;    // bx
  v[2] = r1.x;    // cx
  v[3] = r0.y;    // ay
  v[4] = r0.w;    // by
  v[5] = r1.y;    // cy
  v[6] = r2.z;    // nbr0
  v[7] = r2.w;    // nbr1
  v[8] = r3.x;    // nbr2
  v[9] = inv_area > 0.0f ? 1.0f : (inv_area < 0.0f ? -1.0f : 0.0f);
}

// The winner's rows stored channel-major with plane stride HW: g gets
// v[0..5], a gets v[6..9] (K1: one pixel per thread).
__device__ __forceinline__ void emit_winner_rows(const float4* tbl,
                                                 int best_id, size_t HW,
                                                 float* g, float* a) {
  float v[10];
  winner_row_values(tbl, best_id, v);
#pragma unroll
  for (int c = 0; c < 6; ++c) g[c * HW] = v[c];
#pragma unroll
  for (int c = 0; c < 4; ++c) a[c * HW] = v[6 + c];
}

}  // namespace tss
