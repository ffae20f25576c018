// K7 — barycentric attribute interpolation, forward and backward.
//
// Replaces no Pallas kernel: JAX runs it as XLA code (tssplat_tpu/ops/
// rasterize.py interpolate, :842: a row gather of the per-face attribute
// table, then the blend). PyTorch would gather a dense (B,H,W,3C) row per
// pixel and blend it with strided elementwise kernels.
//
// Forward: rast (B,H,W,4) = (u, v, z/w, id+1) and the attribute table
// (F,3C), shared by the views, or (B,F,3C), one per view (row f = the
// corners 3f..3f+2 of the corner layout) -> (B,H,W,C) = (a0 u + a1 v) +
// a2 ((1 - u) - v), zero on background: raster_kernels.py interp_plain's
// operations in its order, built with -fmad=false, so the two agree to the
// bit. Backward under ct (B,H,W,C): d rast = (d u, d v, 0, 0) with d u =
// sum_c ct a0 - sum_c ct a2 and d v = sum_c ct a1 - sum_c ct a2 (channels
// added in order) at every foreground pixel, zero elsewhere; and (ct u,
// ct v, ct (1 - u - v)) of each foreground pixel with a non-zero cotangent
// folded into d tbl (B,F,3C) (face_fold.cuh) in chunks of 12 columns. A
// shared table's rows are folded per view, so views never contend for a
// row, and summed over the views by the caller.
//
// Bound on the H100: bytes — rast read (16 B/px) and the output written
// (4C B/px) once, the table read once; backward: rast, ct at the
// foreground (4C B), d rast written (16 B/px), d tbl written. Design
// (face_fold.cuh): a thread per run of four pixels reads their rast rows
// with a 16-byte load each and writes the run's 4C contiguous outputs with
// C 16-byte stores (scalar where W % 4 != 0); each foreground pixel reads
// its face's 3C attributes from L2. The backward stores d rast for every
// run, then a warp without a counted pixel ends.

#include "face_fold.cuh"

namespace {

using namespace ff;

constexpr int kChunk = 12;                     // columns a fold carries

// A run's winners and their weights (u, v, 1 - u - v)
struct Blend {
  int id[kRun];
  float u[kRun], v[kRun], w[kRun];
};

__device__ inline Blend blend_of(const float* rast, const Run& u) {
  float4 r[kRun];
  load_rast(rast, u, r);
  Blend q;
#pragma unroll
  for (int j = 0; j < kRun; ++j) {
    q.id[j] = (int)r[j].w;
    q.u[j] = r[j].x;
    q.v[j] = r[j].y;
    q.w[j] = (1.0f - r[j].x) - r[j].y;
  }
  return q;
}

// Output k (0 .. 4C - 1) of a run: pixel k / C, channel k % C
__device__ inline float value(const Blend& q, const float* t, int C, int k) {
  const int j = k / C, ch = k - j * C;
  const int id1 = pick4(q.id, j);
  if (id1 <= 0) return 0.0f;
  const float* a = t + (long long)(id1 - 1) * 3 * C + ch;
  return (__ldg(a) * pick4(q.u, j) + __ldg(a + C) * pick4(q.v, j)) +
         __ldg(a + 2 * C) * pick4(q.w, j);
}

__global__ void __launch_bounds__(kThreads)
interp_kernel(const float* __restrict__ rast, const float* __restrict__ tbl,
              int H, int W, int F, int C, bool per_view, bool vec,
              float* __restrict__ out) {
  const Run u = run_of(H, W);
  if (u.r >= H || u.n == 0) return;
  const Blend q = blend_of(rast, u);
  const float* t = tbl + (per_view ? (long long)u.b * F * 3 * C : 0);
  float* o = out + u.px * C;
  if (vec) {                                   // a full run: 4C floats
    float4* o4 = reinterpret_cast<float4*>(o);
    for (int k = 0; k < C; ++k)
      o4[k] = make_float4(value(q, t, C, 4 * k), value(q, t, C, 4 * k + 1),
                          value(q, t, C, 4 * k + 2),
                          value(q, t, C, 4 * k + 3));
  } else {
    for (int k = 0; k < u.n * C; ++k) o[k] = value(q, t, C, k);
  }
}

__global__ void __launch_bounds__(kThreads)
interp_grad_kernel(const float* __restrict__ rast,
                   const float* __restrict__ tbl,
                   const float* __restrict__ ct, int H, int W, int F, int C,
                   bool per_view, float* __restrict__ d_tbl,
                   float* __restrict__ d_rast) {
  __shared__ float sums[kChunk][kThreads];
  const Run u = run_of(H, W);
  if (u.r >= H) return;                        // the whole warp: one row
  const Blend q = blend_of(rast, u);
  const float* t = tbl + (per_view ? (long long)u.b * F * 3 * C : 0);
  const float* cp = ct + u.px * C;
  unsigned counted = 0u;
  float4* dr = reinterpret_cast<float4*>(d_rast) + u.px;
#pragma unroll
  for (int j = 0; j < kRun; ++j) {
    if (j >= u.n) break;
    float du = 0.0f, dv = 0.0f;
    if (q.id[j] > 0) {
      const float* a = t + (long long)(q.id[j] - 1) * 3 * C;
      float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f;
      bool any = false;
      for (int ch = 0; ch < C; ++ch) {
        const float x = __ldg(cp + j * C + ch);
        const float p0 = x * __ldg(a + ch), p1 = x * __ldg(a + C + ch),
                    p2 = x * __ldg(a + 2 * C + ch);
        s0 = ch ? s0 + p0 : p0;
        s1 = ch ? s1 + p1 : p1;
        s2 = ch ? s2 + p2 : p2;
        any |= x != 0.0f;
      }
      du = s0 - s2;
      dv = s1 - s2;
      if (any) counted |= 1u << j;
    }
    dr[j] = make_float4(du, dv, 0.0f, 0.0f);
  }
  if (!__any_sync(kAll, counted != 0u)) return;

  const int key = fold_key(q.id, counted);
  const unsigned group = __match_any_sync(kAll, key);
  float* table = d_tbl + (long long)u.b * F * 3 * C;
  for (int col0 = 0; col0 < 3 * C; col0 += kChunk) {
    fold<kChunk>(q.id, counted, key, group, table, 3 * C, col0,
                 min(kChunk, 3 * C - col0), sums, [&](int j, float v[kChunk]) {
#pragma unroll
                   for (int c = 0; c < kChunk; ++c) {
                     const int col = col0 + c;
                     const int k = col / C;
                     const float wk = k == 0 ? q.u[j] : (k == 1 ? q.v[j] : q.w[j]);
                     v[c] = col < 3 * C ? __ldg(cp + j * C + col - k * C) * wk
                                        : 0.0f;
                   }
                 });
  }
}

}  // namespace

extern "C" int tss_interp_launch(const void* rast, const void* tbl, int B,
                                 int H, int W, int F, int C, int per_view,
                                 void* out, void* stream) {
  if (!aligned16(rast)) return static_cast<int>(cudaErrorMisalignedAddress);
  const long long n = blocks(B, H, W);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  interp_kernel<<<(unsigned)n, kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rast), static_cast<const float*>(tbl), H, W,
      F, C, per_view != 0, W % 4 == 0 && aligned16(out),
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tss_interp_grad_launch(const void* rast, const void* tbl,
                                      const void* ct, int B, int H, int W,
                                      int F, int C, int per_view, void* d_tbl,
                                      void* d_rast, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!aligned16(rast) || !aligned16(d_rast))
    return static_cast<int>(cudaErrorMisalignedAddress);
  cudaError_t err = cudaMemsetAsync(
      d_tbl, 0, (size_t)B * F * 3 * C * sizeof(float), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n = blocks(B, H, W);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  interp_grad_kernel<<<(unsigned)n, kThreads, 0, s>>>(
      static_cast<const float*>(rast), static_cast<const float*>(tbl),
      static_cast<const float*>(ct), H, W, F, C, per_view != 0,
      static_cast<float*>(d_tbl), static_cast<float*>(d_rast));
  return static_cast<int>(cudaGetLastError());
}
