// Silhouette antialias pair math shared by K4 (aa_fwd.cu) and K5
// (aa_bwd.cu): the arithmetic of tssplat_tpu/ops/rasterize.py _aa_pairs
// (:880) and pallas_raster.py _aa_pair_core (:1063), for one pair of
// horizontally or vertically adjacent pixels a -> b, and its hand-derived
// backward. The colour of the silhouette pass is the coverage itself
// (1 on foreground, 0 on background).
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace aa {

struct View {
  const int* ids;      // (B,H,W) winner id + 1
  const float* z;      // (B,H,W)
  const float* g6;     // (B,6,H,W) ax,bx,cx,ay,by,cy
  const float* gaux;   // (B,4,H,W) nbr0,nbr1,nbr2,sign
  int H, W;
  long long HW;
  long long b;

  __device__ long long at(int r, int c) const {
    return (long long)r * W + c;
  }
  __device__ int id(int r, int c) const { return ids[b * HW + at(r, c)]; }
};

struct Pixel {
  int id;
  float z, px, py;
  float g[6];
  float aux[4];
};

__device__ inline Pixel load(const View& v, int r, int c, int id) {
  Pixel p;
  const long long q = v.at(r, c);
  p.id = id;
  p.z = v.z[v.b * v.HW + q];
  p.px = ((float)c + 0.5f) / (float)v.W * 2.0f - 1.0f;
  p.py = ((float)r + 0.5f) / (float)v.H * 2.0f - 1.0f;
#pragma unroll
  for (int j = 0; j < 6; ++j) p.g[j] = v.g6[(v.b * 6 + j) * v.HW + q];
#pragma unroll
  for (int j = 0; j < 4; ++j) p.aux[j] = v.gaux[(v.b * 4 + j) * v.HW + q];
  return p;
}

// A pair can blend only where the ids differ and one side is foreground.
__device__ inline bool differ(int id_a, int id_b) {
  return id_a != id_b && (id_a > 0 || id_b > 0);
}

// Inside-positive edge function of x0,y0 -> x1,y1 at (X, Y), times sign s.
__device__ inline float edge(float x0, float y0, float x1, float y1, float X,
                             float Y, float s) {
  return ((x1 - x0) * (Y - y0) - (y1 - y0) * (X - x0)) * s;
}

struct Pair {
  bool valid, owner_a;
  int k;                  // owner-triangle edge slot of the crossing
  float t, tc;            // crossing along a->b, and clip(t, 0, 1)
  float col_a, col_b;
  float delta_a, delta_b;
};

__device__ inline Pair eval(const Pixel& A, const Pixel& B) {
  Pair P;
  const bool dif = differ(A.id, B.id);
  // owner = the foreground triangle at the boundary: non-background first,
  // then the smaller depth
  P.owner_a = A.id != 0 && (B.id == 0 || A.z <= B.z);
  const int other_tri = (P.owner_a ? B.id : A.id) - 1;
  const Pixel& O = P.owner_a ? A : B;
  const float s = O.aux[3];
  float te[3], tn[3];
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    const int e1 = e == 2 ? 0 : e + 1;
    const float sa = edge(O.g[e], O.g[3 + e], O.g[e1], O.g[3 + e1], A.px,
                          A.py, s);
    const float sb = edge(O.g[e], O.g[3 + e], O.g[e1], O.g[3 + e1], B.px,
                          B.py, s);
    const float denom = sa - sb;
    const float safe = fabsf(denom) > 1e-20f ? denom : 1.0f;
    const float t_all = sa / safe;
    te[e] = (sa >= 0.0f && sb < 0.0f) ? t_all : CUDART_INF_F;
    tn[e] = (sa < 0.0f && sb >= 0.0f) ? t_all : -CUDART_INF_F;
  }
  // nearest exit (owner a) / entry (owner b), earliest slot on ties
  const int kx01 = te[1] < te[0] ? 1 : 0;
  const float bx01 = te[1] < te[0] ? te[1] : te[0];
  const int k_exit = te[2] < bx01 ? 2 : kx01;
  const float t_exit = te[2] < bx01 ? te[2] : bx01;
  const int kn01 = tn[1] > tn[0] ? 1 : 0;
  const float bn01 = tn[1] > tn[0] ? tn[1] : tn[0];
  const int k_entry = tn[2] > bn01 ? 2 : kn01;
  const float t_entry = tn[2] > bn01 ? tn[2] : bn01;

  P.k = P.owner_a ? k_exit : k_entry;
  P.t = P.owner_a ? t_exit : t_entry;
  const bool found = isfinite(P.t);
  // silhouette check: the crossing edge must not be shared with the other
  // pixel's triangle
  const float nbr = O.aux[P.k];
  const bool other_fg = P.owner_a ? B.id > 0 : A.id > 0;
  const bool shared = nbr == (float)other_tri && other_tri >= 0 && other_fg;
  P.valid = dif && found && !shared;
  P.tc = fminf(fmaxf(P.valid ? P.t : 0.5f, 0.0f), 1.0f);
  const float v = P.valid ? 1.0f : 0.0f;
  const float w_a = fmaxf(0.5f - P.tc, 0.0f) * v;
  const float w_b = fmaxf(P.tc - 0.5f, 0.0f) * v;
  P.col_a = A.id > 0 ? 1.0f : 0.0f;
  P.col_b = B.id > 0 ? 1.0f : 0.0f;
  P.delta_a = (P.col_b - P.col_a) * w_a;
  P.delta_b = (P.col_a - P.col_b) * w_b;
  return P;
}

// Step derivative of max(u, 0): 1 above, 1/2 at the tie (JAX's balanced
// convention for max/min, which the reference gradients follow), 0 below.
__device__ inline float step(float u) {
  return u > 0.0f ? 1.0f : (u == 0.0f ? 0.5f : 0.0f);
}

// d(owner g6) of ct_a * delta_a + ct_b * delta_b, written into c[6]. The
// gradient flows only through the crossing t = sa / (sa - sb) into the
// owner's two edge endpoints; masks and the sign are piecewise constant.
__device__ inline void grad(const Pixel& A, const Pixel& B, const Pair& P,
                            float ct_a, float ct_b, float c[6]) {
#pragma unroll
  for (int j = 0; j < 6; ++j) c[j] = 0.0f;
  if (!P.valid) return;
  const Pixel& O = P.owner_a ? A : B;
  const float s = O.aux[3];
  const int j0 = P.k, j1 = P.k == 2 ? 0 : P.k + 1;
  const float x0 = O.g[j0], y0 = O.g[3 + j0];
  const float x1 = O.g[j1], y1 = O.g[3 + j1];
  const float sa = edge(x0, y0, x1, y1, A.px, A.py, s);
  const float sb = edge(x0, y0, x1, y1, B.px, B.py, s);
  const float denom = sa - sb;
  const bool big = fabsf(denom) > 1e-20f;
  const float safe = big ? denom : 1.0f;

  const float g_tc = ct_a * (P.col_b - P.col_a) * -step(0.5f - P.tc) +
                     ct_b * (P.col_a - P.col_b) * step(P.tc - 0.5f);
  const float g_t = g_tc * step(P.t) * step(1.0f - P.t);
  const float g_safe = big ? -g_t * sa / (safe * safe) : 0.0f;
  const float g_sa = g_t / safe + g_safe;
  const float g_sb = -g_safe;

  // E = (x1-x0)*(Y-y0) - (y1-y0)*(X-x0): dE/dx0 = (y1-y0)-(Y-y0),
  // dE/dx1 = Y-y0, dE/dy0 = (X-x0)-(x1-x0), dE/dy1 = -(X-x0)
  const float ga = g_sa * s, gb = g_sb * s;
  const float a1 = x1 - x0, c1 = y1 - y0;
  const float ba = A.py - y0, da = A.px - x0;
  const float bb = B.py - y0, db = B.px - x0;
  c[j0] = ga * (c1 - ba) + gb * (c1 - bb);
  c[j1] = ga * ba + gb * bb;
  c[3 + j0] = ga * (da - a1) + gb * (db - a1);
  c[3 + j1] = -ga * da - gb * db;
}

}  // namespace aa
