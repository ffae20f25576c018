// K4 — silhouette antialias forward, all pixel pairs.
//
// Replaces tssplat_tpu/ops/pallas_raster.py _aa_halo_fwd_kernel (:1171, the
// pl.pallas_call at :1278 in aa_halo_forward) together with the tile-border
// pass _aa_boundary_deltas (rasterize.py:1082) that completes it: the output
// equals antialias_silhouette_halo as a whole, and the dense antialias
// (rasterize.py:975) on the silhouette. Per pixel p:
//   out(p) = fg(p) + delta_a(p, right) + delta_b(left, p)
//                  + delta_a(p, below) + delta_b(above, p)
// in the dense chain's summation order (a pair that is not valid adds 0).
//
// Bound on the H100: bytes — the winner ids of every pixel and the output
// (8 B/px), plus the few pixels at a differing pair: z where both sides are
// foreground (4 B) and the owner's g6 and gaux (40 B).
// Design (aa_pair.cuh): a CTA per (view, 8x128 tile), a thread per run of
// four pixels of a row. A run's ids and those of the runs above and below
// come in as 16-byte loads, its left and right neighbours from the next
// lanes, and a run with no differing pair stores its coverage at once with
// one 16-byte store; a tile with none ends there, past one barrier. The
// other tiles list their differing pairs in shared memory and evaluate
// each once, the list dealt to the lanes in turn so that a warp's lanes all
// work, keeping delta_a and delta_b by the pair's position; then the runs
// that touch a pair add them up and store. Pairs across a tile's border
// are evaluated by both CTAs with the same arithmetic. What is left above
// the bound is mostly the streaming itself: with every id 0 the kernel
// takes 2.2x its bound, about what one PyTorch kernel takes to move the
// same bytes (PERF.md).

#include <cstdint>

#include "aa_pair.cuh"

namespace {

struct Shared {
  aa::Tile tile;
  float delta_a[aa::kNP], delta_b[aa::kNP];   // by pair position
};

__device__ inline void store_run(float* out, const aa::View& v,
                                 const aa::Run& u, bool vec,
                                 const float o[aa::kRun]) {
  if (u.r >= v.H || u.c >= v.W) return;
  float* p = out + v.at(u.r, u.c);
  if (vec) {
    *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
  } else {
#pragma unroll
    for (int j = 0; j < aa::kRun; ++j)
      if (u.c + j < v.W) p[j] = o[j];
  }
}

__global__ void __launch_bounds__(aa::kThreads, aa::kMinBlocks)
aa_fwd_kernel(aa::View v, bool vec, float* __restrict__ out) {
  __shared__ Shared s;
  v.b = blockIdx.z;
  const int r0 = blockIdx.y * aa::kTileH, c0 = blockIdx.x * aa::kTileW;
  const aa::Run u = aa::find_pairs(v, r0, c0, vec);
  float o[aa::kRun];
#pragma unroll
  for (int j = 0; j < aa::kRun; ++j) o[j] = aa::coverage(u.id[j]);
  if (!u.touched()) store_run(out, v, u, vec, o);
  if (!aa::tile_has_pairs(s.tile, u)) return;
  aa::collect(s.tile, u);
  aa::evaluate(s.tile, v, r0, c0,
               [&](int p, const aa::Pair& P, const aa::Owner&, int, int, int,
                   int, int id_a, int id_b) {
                 aa::deltas(P, aa::coverage(id_a), aa::coverage(id_b),
                            s.delta_a[p], s.delta_b[p]);
               });
  if (!u.touched()) return;
#pragma unroll
  for (int j = 0; j < aa::kRun; ++j) {
    const int c = u.lc + j;
    if (u.right >> j & 1u) o[j] += s.delta_a[aa::hpos(u.lr, c)];
    if (u.left >> j & 1u) o[j] += s.delta_b[aa::hpos(u.lr, c - 1)];
    if (u.down >> j & 1u) o[j] += s.delta_a[aa::vpos(u.lr, c)];
    if (u.up >> j & 1u) o[j] += s.delta_b[aa::vpos(u.lr - 1, c)];
  }
  store_run(out, v, u, vec, o);
}

}  // namespace

extern "C" int tss_aa_fwd_launch(const void* ids, const void* z,
                                 const void* g6, const void* gaux, int B,
                                 int H, int W, int row0, int full_h,
                                 void* out, void* stream) {
  aa::View v{static_cast<const int*>(ids), static_cast<const float*>(z),
             static_cast<const float*>(g6), static_cast<const float*>(gaux),
             H, W, (long long)H * W, 0, row0, full_h};
  const bool vec = W % 4 == 0 && reinterpret_cast<uintptr_t>(ids) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const dim3 grid((W + aa::kTileW - 1) / aa::kTileW,
                  (H + aa::kTileH - 1) / aa::kTileH, B);
  aa_fwd_kernel<<<grid, aa::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      v, vec, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
