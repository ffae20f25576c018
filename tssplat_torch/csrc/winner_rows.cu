// K8 — the antialias pass's winner rows on the shaded path, forward only.
//
// Replaces no Pallas kernel: JAX gathers these rows as XLA code
// (tssplat_tpu/ops/rasterize.py antialias, :975: the 16-channel
// _gather_tri_screen, :462, put channel-major). PyTorch would gather a
// dense (B,H,W,10) row per pixel, permute it and copy out two planes.
//
// rast (B,H,W,4) = (u, v, z/w, id+1), the xy table tbl6 (B,F,6) = (ax,bx,
// cx, ay,by,cy) and the edge neighbours (F,3) int64 -> K4/K5's inputs: ids
// (B,H,W) int32 and z (B,H,W) of rast, g6 (B,6,H,W) = the winner's tbl6
// row and gaux (B,4,H,W) = (its neighbours as floats, the sign of its
// screen area (bx-ax)(cy-ay) - (by-ay)(cx-ax)), channel-major, zero on
// background: raster_kernels.py winner_rows_plain's values to the bit. No
// gradient: the rows' gradient is K3's (rasterize.py winner_screen_rows).
//
// Bound on the H100: bytes — rast read (16 B/px) and 48 B/px written (ids,
// z, six row planes and four aux planes), the tables read once. Design
// (face_fold.cuh): a thread per run of four pixels reads their rast rows
// with a 16-byte load each and each foreground pixel's face row (24 B) and
// neighbours from L2, then writes the run's four pixels of each of the
// twelve output planes with one 16-byte store (scalar where W % 4 != 0).

#include "face_fold.cuh"

namespace {

using namespace ff;

// A run's four values of one plane: one 16-byte store where ``vec``
template <class T, class V>
__device__ inline void store_run(T* p, const Run& u, bool vec,
                                 const T v[kRun]) {
  if (vec) {
    V q;
    q.x = v[0]; q.y = v[1]; q.z = v[2]; q.w = v[3];
    *reinterpret_cast<V*>(p) = q;
  } else {
#pragma unroll
    for (int j = 0; j < kRun; ++j)
      if (j < u.n) p[j] = v[j];
  }
}

__global__ void __launch_bounds__(kThreads)
winner_rows_kernel(const float* __restrict__ rast,
                   const float* __restrict__ tbl6,
                   const long long* __restrict__ nbrs, int H, int W, int F,
                   bool vec, int* __restrict__ ids, float* __restrict__ z,
                   float* __restrict__ g6, float* __restrict__ gaux) {
  const Run u = run_of(H, W);
  if (u.r >= H || u.n == 0) return;
  float4 r[kRun];
  load_rast(rast, u, r);
  int id[kRun];
  float zz[kRun], g[10][kRun];
  const float* t = tbl6 + (long long)u.b * F * 6;
#pragma unroll
  for (int j = 0; j < kRun; ++j) {
    id[j] = (int)r[j].w;
    zz[j] = r[j].z;
#pragma unroll
    for (int ch = 0; ch < 10; ++ch) g[ch][j] = 0.0f;
    if (id[j] <= 0) continue;
    const float* row = t + (long long)(id[j] - 1) * 6;
#pragma unroll
    for (int ch = 0; ch < 6; ++ch) g[ch][j] = __ldg(row + ch);
    const long long* nb = nbrs + (long long)(id[j] - 1) * 3;
#pragma unroll
    for (int k = 0; k < 3; ++k) g[6 + k][j] = (float)__ldg(nb + k);
    const float area =
        (g[1][j] - g[0][j]) * (g[5][j] - g[3][j]) -
        (g[4][j] - g[3][j]) * (g[2][j] - g[0][j]);
    g[9][j] = (float)((area > 0.0f) - (area < 0.0f));
  }
  const long long HW = (long long)H * W;
  const long long at = (long long)u.r * W + u.c;
  store_run<int, int4>(ids + u.px, u, vec, id);
  store_run<float, float4>(z + u.px, u, vec, zz);
#pragma unroll
  for (int ch = 0; ch < 6; ++ch)
    store_run<float, float4>(g6 + ((long long)u.b * 6 + ch) * HW + at, u,
                             vec, g[ch]);
#pragma unroll
  for (int ch = 0; ch < 4; ++ch)
    store_run<float, float4>(gaux + ((long long)u.b * 4 + ch) * HW + at, u,
                             vec, g[6 + ch]);
}

}  // namespace

extern "C" int tss_winner_rows_launch(const void* rast, const void* tbl6,
                                      const void* nbrs, int B, int H, int W,
                                      int F, void* ids, void* z, void* g6,
                                      void* gaux, void* stream) {
  if (!aligned16(rast)) return static_cast<int>(cudaErrorMisalignedAddress);
  const long long n = blocks(B, H, W);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  const bool vec = W % 4 == 0 && aligned16(ids) && aligned16(z) &&
                   aligned16(g6) && aligned16(gaux);
  winner_rows_kernel<<<(unsigned)n, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rast), static_cast<const float*>(tbl6),
      static_cast<const long long*>(nbrs), H, W, F, vec,
      static_cast<int*>(ids), static_cast<float*>(z), static_cast<float*>(g6),
      static_cast<float*>(gaux));
  return static_cast<int>(cudaGetLastError());
}
