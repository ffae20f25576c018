// K6 — the shading of the winners, forward and backward.
//
// Replaces no Pallas kernel: JAX runs the shading as XLA code
// (tssplat_tpu/ops/rasterize.py _shade_rast, :688, after one row gather of
// its per-face screen table, _gather_tri_screen :462). PyTorch would gather
// a dense (B,H,W,12) row per pixel and run some seventy elementwise kernels
// over it, forward and about twice that in autograd's backward.
//
// Forward: ids+1 (B,H,W) int32 and the per-face table tbl (B,F,12) =
// (ax,bx,cx, ay,by,cy, z0,z1,z2, iw0,iw1,iw2) -> rast (B,H,W,4) = (u, v,
// z/w, id+1): the barycentrics at the pixel centre of the absolute row
// (viewport (row0, full_h)), divided by the area where |area| > 1e-14,
// perspective-corrected by the 1/w sum where it is > 1e-9, zero on
// background. Every operation in the order of raster_kernels.py
// shade_plain; built with -fmad=false, so the two agree to the bit.
// Backward: the cotangents of (u, v, z) at each foreground pixel where one
// is != 0, taken back through the same arithmetic recomputed from the face
// row (raster_kernels.py _shade_grad, the same order) and folded per face
// into d tbl (B,F,12) (face_fold.cuh); autograd carries it on to pos_clip.
//
// Bound on the H100: bytes. Forward: the ids (4 B/px) and rast (16 B/px)
// streamed once, the table read once (48 B a row, L2-resident per view).
// Backward: the ids, d rast at the foreground pixels (16 B), the table read
// and d tbl written. Design (face_fold.cuh): a thread per run of four
// pixels reads its ids with one 16-byte load and each foreground pixel's
// face row with three, and writes each pixel's rast row with one 16-byte
// store; in the backward a warp without a foreground pixel, or without a
// non-zero cotangent, ends after its ids, and the folds' atomics fall to
// one per (warp, face, column) for faces that span a warp's row.

#include "face_fold.cuh"

namespace {

using namespace ff;

struct Face {
  float ax, bx, cx, ay, by, cy, z0, z1, z2, w0, w1, w2;
};

__device__ inline Face load_face(const float* tbl, int id1) {
  const float4* p = reinterpret_cast<const float4*>(tbl) + (id1 - 1) * 3;
  const float4 a = __ldg(p), b = __ldg(p + 1), c = __ldg(p + 2);
  return {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x, c.y, c.z, c.w};
}

// The forward's quantities at pixel centre (px, py)
struct Bary {
  bool ok_a, ok_s;
  float sa, l0, l1, l2, s, u, v;
};

__device__ inline Bary bary(const Face& f, float px, float py) {
  Bary q;
  const float area = (f.bx - f.ax) * (f.cy - f.ay) - (f.by - f.ay) * (f.cx - f.ax);
  q.ok_a = fabsf(area) > kAreaEps;
  q.sa = q.ok_a ? area : 1.0f;
  q.l0 = ((f.cx - f.bx) * (py - f.by) - (f.cy - f.by) * (px - f.bx)) / q.sa;
  q.l1 = ((f.ax - f.cx) * (py - f.cy) - (f.ay - f.cy) * (px - f.cx)) / q.sa;
  q.l2 = ((f.bx - f.ax) * (py - f.ay) - (f.by - f.ay) * (px - f.ax)) / q.sa;
  const float d0 = q.l0 * f.w0, d1 = q.l1 * f.w1, d2 = q.l2 * f.w2;
  const float s = d0 + d1 + d2;
  q.ok_s = fabsf(s) > kWEps;
  q.s = q.ok_s ? s : 1.0f;
  q.u = d0 / q.s;
  q.v = d1 / q.s;
  return q;
}

// d (u, v, z) / d row under the cotangents (gu, gv, gz), in the table's
// column order (raster_kernels.py _shade_grad)
__device__ inline void row_grad(const Face& f, float px, float py, float gu,
                                float gv, float gz, float o[12]) {
  const Bary q = bary(f, px, py);
  const float gs = q.ok_s ? -(gu * q.u + gv * q.v) / q.s : 0.0f;
  const float gd0 = gu / q.s + gs, gd1 = gv / q.s + gs, gd2 = gs;
  const float ge0 = (gd0 * f.w0 + gz * f.z0) / q.sa;
  const float ge1 = (gd1 * f.w1 + gz * f.z1) / q.sa;
  const float ge2 = (gd2 * f.w2 + gz * f.z2) / q.sa;
  const float ga = q.ok_a ? -(ge0 * q.l0 + ge1 * q.l1 + ge2 * q.l2) : 0.0f;
  o[0] = ge1 * (py - f.cy) + ge2 * (f.by - py) + ga * (f.by - f.cy);
  o[1] = ge0 * (f.cy - py) + ge2 * (py - f.ay) + ga * (f.cy - f.ay);
  o[2] = ge0 * (py - f.by) + ge1 * (f.ay - py) + ga * (f.ay - f.by);
  o[3] = ge1 * (f.cx - px) + ge2 * (px - f.bx) + ga * (f.cx - f.bx);
  o[4] = ge0 * (px - f.cx) + ge2 * (f.ax - px) + ga * (f.ax - f.cx);
  o[5] = ge0 * (f.bx - px) + ge1 * (px - f.ax) + ga * (f.bx - f.ax);
  o[6] = gz * q.l0;
  o[7] = gz * q.l1;
  o[8] = gz * q.l2;
  o[9] = gd0 * q.l0;
  o[10] = gd1 * q.l1;
  o[11] = gd2 * q.l2;
}

__global__ void __launch_bounds__(kThreads)
shade_kernel(const int* __restrict__ ids, const float* __restrict__ tbl,
             int H, int W, int F, int row0, int full_h, bool vec,
             float* __restrict__ rast) {
  const Run u = run_of(H, W);
  if (u.r >= H || u.n == 0) return;
  int id[kRun];
  load_ids(ids, u, vec, id);
  const float py = ndc_center(u.r + row0, full_h);
  const float* t = tbl + (long long)u.b * F * 12;
  float4* out = reinterpret_cast<float4*>(rast) + u.px;
#pragma unroll
  for (int j = 0; j < kRun; ++j) {
    if (j >= u.n) break;
    float4 o = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (id[j] > 0) {
      const Face f = load_face(t, id[j]);
      const Bary q = bary(f, ndc_center(u.c + j, W), py);
      o = make_float4(q.u, q.v,
                      q.l0 * f.z0 + q.l1 * f.z1 + q.l2 * f.z2, (float)id[j]);
    }
    out[j] = o;
  }
}

__global__ void __launch_bounds__(kThreads)
shade_grad_kernel(const int* __restrict__ ids, const float* __restrict__ tbl,
                  const float* __restrict__ ct, int H, int W, int F,
                  int row0, int full_h, bool vec, float* __restrict__ out) {
  __shared__ float sums[12][kThreads];
  const Run u = run_of(H, W);
  if (u.r >= H) return;                        // the whole warp: one row
  int id[kRun];
  load_ids(ids, u, vec, id);
  bool fg = false;
#pragma unroll
  for (int j = 0; j < kRun; ++j) fg |= id[j] > 0;
  if (!__any_sync(kAll, fg)) return;

  float g[kRun][3];
  unsigned counted = 0u;
  const float4* cp = reinterpret_cast<const float4*>(ct) + u.px;
#pragma unroll
  for (int j = 0; j < kRun; ++j) {
    g[j][0] = g[j][1] = g[j][2] = 0.0f;
    if (id[j] <= 0) continue;
    const float4 q = __ldg(cp + j);
    g[j][0] = q.x;
    g[j][1] = q.y;
    g[j][2] = q.z;
    if (q.x != 0.0f || q.y != 0.0f || q.z != 0.0f) counted |= 1u << j;
  }
  if (!__any_sync(kAll, counted != 0u)) return;

  const int key = fold_key(id, counted);
  const unsigned group = __match_any_sync(kAll, key);
  const float py = ndc_center(u.r + row0, full_h);
  const float* t = tbl + (long long)u.b * F * 12;
  fold<12>(id, counted, key, group, out + (long long)u.b * F * 12, 12, 0, 12,
           sums, [&](int j, float v[12]) {
             row_grad(load_face(t, id[j]), ndc_center(u.c + j, W), py,
                      g[j][0], g[j][1], g[j][2], v);
           });
}

}  // namespace

extern "C" int tss_shade_launch(const void* ids, const void* tbl, int B,
                                int H, int W, int F, int row0, int full_h,
                                void* rast, void* stream) {
  if (!aligned16(tbl) || !aligned16(rast))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const long long n = blocks(B, H, W);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  shade_kernel<<<(unsigned)n, kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ids), static_cast<const float*>(tbl), H, W, F,
      row0, full_h, W % 4 == 0 && aligned16(ids), static_cast<float*>(rast));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tss_shade_grad_launch(const void* ids, const void* tbl,
                                     const void* ct, int B, int H, int W,
                                     int F, int row0, int full_h, void* out,
                                     void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!aligned16(tbl) || !aligned16(ct))
    return static_cast<int>(cudaErrorMisalignedAddress);
  cudaError_t err =
      cudaMemsetAsync(out, 0, (size_t)B * F * 12 * sizeof(float), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n = blocks(B, H, W);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  shade_grad_kernel<<<(unsigned)n, kThreads, 0, s>>>(
      static_cast<const int*>(ids), static_cast<const float*>(tbl),
      static_cast<const float*>(ct), H, W, F, row0, full_h,
      W % 4 == 0 && aligned16(ids), static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
