// Per-pixel visibility test and winner-row emission shared by K1 (vis.cu)
// and K2a/K2b (vis_capped.cu), so the two searches cannot drift apart.
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

// One face row (r0 = ax,ay,bx,by; r1 = cx,cy,z0,z1; r2 = z2,inv_area,..)
// with id+1 ``id1`` against pixel (px, py). The face covers the pixel when
// all three edges are >= 0, inv_area != 0 and z lies in [-1, 1]; the
// smallest z wins and an exact tie goes to the smaller id.
__device__ __forceinline__ void depth_test(const float4& r0, const float4& r1,
                                           const float4& r2, int id1,
                                           float px, float py,
                                           float& best_z, int& best_id) {
  const float ax = r0.x, ay = r0.y, bx = r0.z, by = r0.w;
  const float cx = r1.x, cy = r1.y, z0 = r1.z, z1 = r1.w;
  const float z2 = r2.x, inv_area = r2.y;
  const float e0 = ((cx - bx) * (py - by) - (cy - by) * (px - bx)) * inv_area;
  const float e1 = ((ax - cx) * (py - cy) - (ay - cy) * (px - cx)) * inv_area;
  const float e2 = ((bx - ax) * (py - ay) - (by - ay) * (px - ax)) * inv_area;
  const float z = e0 * z0 + e1 * z1 + e2 * z2;
  const bool cov = e0 >= 0.0f && e1 >= 0.0f && e2 >= 0.0f &&
                   inv_area != 0.0f && z >= -1.0f && z <= 1.0f;
  const float zc = cov ? z : CUDART_INF_F;
  if (zc < best_z || (zc == best_z && cov && id1 < best_id)) {
    best_z = zc;
    best_id = id1;
  }
}

// The winner's rows at one pixel, channel-major with plane stride HW:
// g = (ax,bx,cx,ay,by,cy), a = (nbr0,nbr1,nbr2,sign(inv_area)); all zero on
// background (best_id == 0). ``tbl`` is the view's (F, 4) float4 table.
__device__ __forceinline__ void emit_winner_rows(const float4* tbl,
                                                 int best_id, size_t HW,
                                                 float* g, float* a) {
  float4 r0 = make_float4(0.f, 0.f, 0.f, 0.f), r1 = r0, r2 = r0, r3 = r0;
  if (best_id > 0) {
    const float4* r = tbl + (size_t)(best_id - 1) * 4;
    r0 = r[0]; r1 = r[1]; r2 = r[2]; r3 = r[3];
  }
  const float inv_area = r2.y;
  const float sgn = inv_area > 0.0f ? 1.0f : (inv_area < 0.0f ? -1.0f : 0.0f);
  g[0 * HW] = r0.x;    // ax
  g[1 * HW] = r0.z;    // bx
  g[2 * HW] = r1.x;    // cx
  g[3 * HW] = r0.y;    // ay
  g[4 * HW] = r0.w;    // by
  g[5 * HW] = r1.y;    // cy
  a[0 * HW] = r2.z;    // nbr0
  a[1 * HW] = r2.w;    // nbr1
  a[2 * HW] = r3.x;    // nbr2
  a[3 * HW] = sgn;
}

}  // namespace tss
