// Silhouette antialias shared by K4 (aa_fwd.cu) and K5 (aa_bwd.cu).
//
// 1. The pair math: the arithmetic of tssplat_tpu/ops/rasterize.py _aa_pairs
//    (:880) and pallas_raster.py _aa_pair_core (:1063) for one pair of
//    horizontally or vertically adjacent pixels a -> b, and its backward
//    derived by hand. The colour of the silhouette pass is the coverage
//    itself (1 on foreground, 0 on background).
// 2. The tile both kernels walk: one CTA of kThreads per (view, kTileH x
//    kTileW pixels), a thread per run of kRun pixels of one row, which reads
//    its run's ids and the neighbours' with 16-byte loads and shuffles. A
//    tile with a pair whose ids differ lists them in shared memory and
//    evaluates each listed pair once with all its threads, each kernel
//    keeping the pair's terms in shared memory by the pair's position; then
//    each thread sums the terms of its pixels in the plain version's order.
// 3. The slab form (row-slab spatial sharding): the H rows are absolute rows
//    row0 + r of a full_h-tall image (rasterize.py:1012-1044 with a
//    viewport). Pixel centres are those of the absolute rows, and a vertical
//    pair exists only where both of its absolute rows lie in [0, full_h) --
//    JAX's row_valid cut, derived from (row0, full_h) instead of a mask.
//    Pairs along a row and each pixel's own coverage are not cut. A run
//    whose vertical neighbours are cut lists no pair with them, so a quiet
//    run next to a valid-row boundary inside a tile streams as before.
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
  int row0, full_h;    // the slab's first absolute row; the image's height

  __device__ long long at(int r, int c) const {
    return b * HW + (long long)r * W + c;
  }
  // channel j of a (B,C,H,W) array
  __device__ long long at(int C, int j, int r, int c) const {
    return (b * C + j) * HW + (long long)r * W + c;
  }
  // whether slab row r is a row of the image
  __device__ bool row_in_image(int r) const {
    return r + row0 >= 0 && r + row0 < full_h;
  }
};

// NDC centre of pixel i of n along one axis (ops/screen.py ndc_center).
__device__ inline float ndc(int i, int n) {
  return ((float)i + 0.5f) / (float)n * 2.0f - 1.0f;
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

// a[k] for k in 0..2, by selects (an indexed register array would live in
// local memory)
__device__ inline float pick3(const float* a, int k) {
  return k == 0 ? a[0] : (k == 1 ? a[1] : a[2]);
}

struct Pair {
  bool valid, owner_a;
  int k;        // owner-triangle edge slot of the crossing
  float t;      // crossing along a->b (finite where valid)
};

// The owner's xy row and orientation sign, as eval read them.
struct Owner {
  float g[6];
  float s;
};

// The forward pair math for a = (ra, ca), b = (rb, cb) of view v.b. Reads
// z of both pixels and the owner's ten row channels from global memory.
__device__ inline Pair eval(const View& v, int ra, int ca, int rb, int cb,
                            int id_a, int id_b, Owner& o) {
  Pair P;
  const bool dif = differ(id_a, id_b);
  float aux[3];
  // owner = the foreground triangle at the boundary: non-background first,
  // then the smaller depth
  P.owner_a = id_a != 0 && (id_b == 0 || __ldg(v.z + v.at(ra, ca)) <=
                                             __ldg(v.z + v.at(rb, cb)));
  const int other_tri = (P.owner_a ? id_b : id_a) - 1;
  const int ro = P.owner_a ? ra : rb, co = P.owner_a ? ca : cb;
#pragma unroll
  for (int j = 0; j < 6; ++j) o.g[j] = __ldg(v.g6 + v.at(6, j, ro, co));
#pragma unroll
  for (int j = 0; j < 3; ++j) aux[j] = __ldg(v.gaux + v.at(4, j, ro, co));
  o.s = __ldg(v.gaux + v.at(4, 3, ro, co));
  const float* g = o.g;
  const float pax = ndc(ca, v.W), pay = ndc(v.row0 + ra, v.full_h);
  const float pbx = ndc(cb, v.W), pby = ndc(v.row0 + rb, v.full_h);
  float te[3], tn[3];
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    const int e1 = e == 2 ? 0 : e + 1;
    const float sa = edge(g[e], g[3 + e], g[e1], g[3 + e1], pax, pay, o.s);
    const float sb = edge(g[e], g[3 + e], g[e1], g[3 + e1], pbx, pby, o.s);
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
  const float nbr = pick3(aux, P.k);
  const bool other_fg = P.owner_a ? id_b > 0 : id_a > 0;
  const bool shared = nbr == (float)other_tri && other_tri >= 0 && other_fg;
  P.valid = dif && found && !shared;
  return P;
}

__device__ inline float coverage(int id) { return id > 0 ? 1.0f : 0.0f; }

// clip(t, 0, 1), with t taken as 0.5 where the pair is not valid
__device__ inline float clip_t(const Pair& P) {
  return fminf(fmaxf(P.valid ? P.t : 0.5f, 0.0f), 1.0f);
}

// The blends of a pair: delta_a into pixel a, delta_b into pixel b (zeros
// where it is not valid).
__device__ inline void deltas(const Pair& P, float col_a, float col_b,
                              float& delta_a, float& delta_b) {
  const float tc = clip_t(P), v = P.valid ? 1.0f : 0.0f;
  delta_a = (col_b - col_a) * (fmaxf(0.5f - tc, 0.0f) * v);
  delta_b = (col_a - col_b) * (fmaxf(tc - 0.5f, 0.0f) * v);
}

// Step derivative of max(u, 0): 1 above, 1/2 at the tie (JAX's balanced
// convention for max/min, which the reference gradients follow), 0 below.
__device__ inline float step(float u) {
  return u > 0.0f ? 1.0f : (u == 0.0f ? 0.5f : 0.0f);
}

// d(owner g6) of ct_a * delta_a + ct_b * delta_b for a valid pair: the
// gradient flows only through the crossing t = sa / (sa - sb) into the
// owner's two edge endpoints (slots k and k+1); masks and the sign are
// piecewise constant. Returns (d x_k, d x_k+1, d y_k, d y_k+1).
__device__ inline float4 grad_terms(const Owner& o, float pax, float pay,
                                    float pbx, float pby, const Pair& P,
                                    float col_a, float col_b, float ct_a,
                                    float ct_b) {
  const int j0 = P.k, j1 = P.k == 2 ? 0 : P.k + 1;
  const float s = o.s;
  const float x0 = pick3(o.g, j0), y0 = pick3(o.g + 3, j0);
  const float x1 = pick3(o.g, j1), y1 = pick3(o.g + 3, j1);
  const float sa = edge(x0, y0, x1, y1, pax, pay, s);
  const float sb = edge(x0, y0, x1, y1, pbx, pby, s);
  const float denom = sa - sb;
  const bool big = fabsf(denom) > 1e-20f;
  const float safe = big ? denom : 1.0f;

  const float tc = clip_t(P);
  const float g_tc = ct_a * (col_b - col_a) * -step(0.5f - tc) +
                     ct_b * (col_a - col_b) * step(tc - 0.5f);
  const float g_t = g_tc * step(P.t) * step(1.0f - P.t);
  const float g_safe = big ? -g_t * sa / (safe * safe) : 0.0f;
  const float g_sa = g_t / safe + g_safe;
  const float g_sb = -g_safe;

  // E = (x1-x0)*(Y-y0) - (y1-y0)*(X-x0): dE/dx0 = (y1-y0)-(Y-y0),
  // dE/dx1 = Y-y0, dE/dy0 = (X-x0)-(x1-x0), dE/dy1 = -(X-x0)
  const float ga = g_sa * s, gb = g_sb * s;
  const float a1 = x1 - x0, c1 = y1 - y0;
  const float ba = pay - y0, da = pax - x0;
  const float bb = pby - y0, db = pbx - x0;
  return make_float4(ga * (c1 - ba) + gb * (c1 - bb), ga * ba + gb * bb,
                     ga * (da - a1) + gb * (db - a1), -ga * da - gb * db);
}

// d[6] += the six-channel gradient whose non-zero terms grad_terms gave for
// edge slot k (the other channels add 0, as the plain version adds them).
__device__ inline void add_terms(float d[6], int k, float4 q) {
  const int j1 = k == 2 ? 0 : k + 1;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    d[j] += j == k ? q.x : (j == j1 ? q.y : 0.0f);
    d[3 + j] += j == k ? q.z : (j == j1 ? q.w : 0.0f);
  }
}

// ---------------------------------------------------------------------------
// The tile
// ---------------------------------------------------------------------------

constexpr int kTileH = 8;
constexpr int kTileW = 128;
constexpr int kRun = 4;                              // pixels per thread
constexpr int kLanes = kTileW / kRun;                // threads per tile row
constexpr int kThreads = kTileH * kLanes;            // 256
// CTAs an SM must hold: caps the kernels at 64 registers a thread, so that
// four CTAs (1,024 threads) keep their loads in flight
constexpr int kMinBlocks = 4;
// Pair positions: horizontal (r, c)-(r, c+1) for c in [-1, kTileW-1], then
// vertical (r, c)-(r+1, c) for r in [-1, kTileH-1], tile-local, so each
// pair with a pixel in the tile has one slot.
constexpr int kNH = kTileH * (kTileW + 1);
constexpr int kNP = kNH + (kTileH + 1) * kTileW;
constexpr int kOutside = -1;               // the id of a pixel off the image

__device__ inline int hpos(int r, int c) { return r * (kTileW + 1) + c + 1; }
__device__ inline int vpos(int r, int c) {
  return kNH + (r + 1) * kTileW + c;
}

// (pixel a, pixel b) of a pair position, tile-local
__device__ inline void pair_ends(int p, int& ra, int& ca, int& rb, int& cb) {
  if (p < kNH) {
    ra = rb = p / (kTileW + 1);
    ca = p % (kTileW + 1) - 1;
    cb = ca + 1;
  } else {
    ra = (p - kNH) / kTileW - 1;
    ca = cb = (p - kNH) % kTileW;
    rb = ra + 1;
  }
}

// The shared memory both kernels use; each adds its per-position terms.
struct Tile {
  unsigned short list[kNP];        // positions of the pairs whose ids differ
  int count;
};

// A pair exists where both pixels lie in the image, and counts where its
// ids differ.
__device__ inline bool pair_differs(int id_a, int id_b) {
  return id_a != kOutside && id_b != kOutside && differ(id_a, id_b);
}

// A thread's run: kRun pixels of one tile row, and for each pixel j the
// bits (1 << j) of the pairs on its right, left, lower and upper side
// whose ids differ.
struct Run {
  int lr, lc, r, c;       // tile-local and global row / first column
  int id[kRun];
  unsigned right, left, down, up;
  __device__ unsigned touched() const { return right | left | down | up; }
};

// ids of kRun pixels from (r, c) on, kOutside off the image; one 16-byte
// load where the rows are 16-byte aligned (vec: W % 4 == 0).
__device__ inline void load_run(const View& v, int r, int c, bool vec,
                                int out[kRun]) {
#pragma unroll
  for (int j = 0; j < kRun; ++j) out[j] = kOutside;
  if (r < 0 || r >= v.H || c >= v.W) return;
  const int* row = v.ids + v.at(r, 0);
  if (vec) {
    const int4 q = __ldg(reinterpret_cast<const int4*>(row + c));
    out[0] = q.x; out[1] = q.y; out[2] = q.z; out[3] = q.w;
  } else {
#pragma unroll
    for (int j = 0; j < kRun; ++j)
      if (c + j < v.W) out[j] = __ldg(row + c + j);
  }
}

__device__ inline int load_id(const View& v, int r, int c) {
  return r >= 0 && r < v.H && c >= 0 && c < v.W ? __ldg(v.ids + v.at(r, c))
                                                 : kOutside;
}

// Each thread's run and its differing pairs. A warp holds one tile row:
// the runs above and below come as 16-byte loads of their own (mostly L1
// and L2 hits), the neighbours left and right from the next lanes, and
// past the tile's columns from one load by the edge lane.
__device__ inline Run find_pairs(const View& v, int r0, int c0, bool vec) {
  const int lane = threadIdx.x % kLanes;
  Run u;
  u.lr = threadIdx.x / kLanes;
  u.lc = lane * kRun;
  u.r = r0 + u.lr;
  u.c = c0 + u.lc;
  int edge_id = kOutside;
  if (lane == 0) edge_id = load_id(v, u.r, u.c - 1);
  if (lane == kLanes - 1) edge_id = load_id(v, u.r, u.c + kRun);
  int above[kRun], below[kRun];
  load_run(v, u.r, u.c, vec, u.id);
  // a vertical pair with a row outside the image does not exist: its
  // neighbour reads as off the slab (row -1)
  const bool in_image = v.row_in_image(u.r);
  load_run(v, in_image && v.row_in_image(u.r - 1) ? u.r - 1 : -1, u.c, vec,
           above);
  load_run(v, in_image && v.row_in_image(u.r + 1) ? u.r + 1 : -1, u.c, vec,
           below);
  int left = __shfl_up_sync(0xffffffffu, u.id[kRun - 1], 1);
  int right = __shfl_down_sync(0xffffffffu, u.id[0], 1);
  if (lane == 0) left = edge_id;
  if (lane == kLanes - 1) right = edge_id;
  u.right = u.left = u.down = u.up = 0u;
#pragma unroll
  for (int j = 0; j < kRun; ++j) {
    const int id = u.id[j];
    const int l = j == 0 ? left : u.id[j - 1];
    const int r = j == kRun - 1 ? right : u.id[j + 1];
    u.right |= (unsigned)pair_differs(id, r) << j;
    u.left |= (unsigned)pair_differs(l, id) << j;
    u.down |= (unsigned)pair_differs(id, below[j]) << j;
    u.up |= (unsigned)pair_differs(above[j], id) << j;
  }
  return u;
}

// Whether the tile has a differing pair at all; zeroes the list. A
// barrier: all threads must call it.
__device__ inline bool tile_has_pairs(Tile& s, const Run& u) {
  if (threadIdx.x == 0) s.count = 0;
  return __syncthreads_or(u.touched() != 0u) != 0;
}

// List the run's share of the tile's differing pairs: those right of and
// below its pixels, and the halo pairs whose pixel b it holds (left of
// column 0, above row 0). Each pair with a pixel in the tile is listed
// once. All threads of a warp must call it.
__device__ inline void collect(Tile& s, const Run& u) {
  const bool col0 = u.lc == 0, row0 = u.lr == 0;
  const int n = __popc(u.right) + __popc(u.down) +
                (col0 ? (int)(u.left & 1u) : 0) + (row0 ? __popc(u.up) : 0);
  const int lane = threadIdx.x & 31;
  int incl = n;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  int base = 0;
  if (lane == 31 && incl > 0) base = atomicAdd(&s.count, incl);
  base = __shfl_sync(0xffffffffu, base, 31);
  int at = base + incl - n;
#pragma unroll
  for (int j = 0; j < kRun; ++j) {
    if (u.right >> j & 1u) s.list[at++] = hpos(u.lr, u.lc + j);
    if (u.down >> j & 1u) s.list[at++] = vpos(u.lr, u.lc + j);
    if (row0 && (u.up >> j & 1u)) s.list[at++] = vpos(-1, u.lc + j);
  }
  if (col0 && (u.left & 1u)) s.list[at++] = hpos(u.lr, -1);
}

// Every listed pair evaluated once: list entries dealt to the threads in
// turn, so that the lanes of a warp all work, and each handed to
// ``f(p, P, o, ra, ca, rb, cb, id_a, id_b)`` with its position, its
// evaluation, its owner's row and its pixels (global). Starts and ends
// with a __syncthreads.
template <class F>
__device__ inline void evaluate(Tile& s, const View& v, int r0, int c0,
                                F&& f) {
  __syncthreads();
  const int n = s.count;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int p = s.list[i];
    int ra, ca, rb, cb;
    pair_ends(p, ra, ca, rb, cb);
    ra += r0; ca += c0; rb += r0; cb += c0;
    const int id_a = __ldg(v.ids + v.at(ra, ca));
    const int id_b = __ldg(v.ids + v.at(rb, cb));
    Owner o;
    const Pair P = eval(v, ra, ca, rb, cb, id_a, id_b, o);
    f(p, P, o, ra, ca, rb, cb, id_a, id_b);
  }
  __syncthreads();
}

}  // namespace aa
