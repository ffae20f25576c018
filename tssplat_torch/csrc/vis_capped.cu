// K2a / K2b — visibility over capped per-tile candidate lists.
//
// Replaces tssplat_tpu/ops/pallas_raster.py _vis_kernel (:53, K2a) and
// _vis_kernel_g (:113, K2b), both launched by the pl.pallas_call at :884.
// The JAX package takes them for scenes too large for its flat layout; the
// port takes them for the same scenes (ops/binning.py uses_capped_layout).
// Per pixel of an 8x128 tile: among the tile's first counts[t] entries of
// its row of the dense (B*ntiles, k) candidate matrix (ascending face ids,
// at most k, padded with F), the nearest covering face; an exact depth tie
// goes to the smaller id (tss::face_covers, the evaluation K1 uses).
// Outputs id+1 and z per pixel (K2a) and, with EMIT_G (K2b), the winner's
// rows g6 (B,6,H,W) and gaux (B,4,H,W), channel-major; every output is 0 on
// background. The JAX kernels read their rows from a shared SMEM table or
// from a per-tile pre-gathered block; here the candidate ids index the
// per-face table in global memory, which serves both.
//
// Bound on the H100: bytes. A face's screen box holds few of its tile's
// 1,024 pixels (about 10 on the 18-sphere scene), so the tests the data
// needs are far below the f32 rate, and the table rows, the candidate ids
// and the 8 (K2a) or 48 (K2b) bytes per pixel of outputs set the bound.
// 7/8 of that scene's tiles hold no candidate: their zeros are most of the
// bytes. Design, one CTA of kThreads per (view, tile):
//  - The winner is the minimum over the covering candidates of the key
//    (z, id+1), so the search may visit candidates and pixels in any order
//    and in parallel. The tile's 1,024 running keys live in shared memory,
//    64 bits each: the high word is a monotone unsigned image of z (with
//    -0.0 folded onto +0.0, which compare equal), the low word is id+1
//    shifted left by one with the folded sign in bit 0, so the z written
//    has the bits the evaluation gave. Background is all ones. Every
//    covering test ends in one shared-memory atomicMin (a compare-and-swap
//    loop in SASS; a read that skips losing atomics bought nothing).
//  - Search inside the box. Each candidate's pixel box is clipped to the
//    tile: the vertices' pixel-centre span with binning's half-pixel slack
//    (ops/binning.py _tile_range at a tile of one pixel), the rule by which
//    the candidate came to be listed for the tile, widened by kBoxPad = 1
//    pixel on each side. The walk that defines the result tests every
//    pixel of the tile: a sliver whose edge functions round to >= 0 beyond
//    its vertices is still found one pixel further out, and no further
//    (the one way the search could part from the walk). A non-finite
//    coordinate or inv_area == 0 gives an empty box. Padding entries past
//    counts[t] are never read.
//  - Boxes sorted by size. A warp runs as long as its largest box, and with
//    the candidates in list order less than half of the lane slots did a
//    test. So a pass stages up to kStage candidates (a box each, no rows),
//    counts them by pixel count, and places (face, box) in shared memory
//    largest first (a counting sort: two shared atomicAdd per candidate and
//    one scan by a warp); empty boxes go no further.
//  - Two widths of worker, dealt out as work items from a shared counter,
//    largest first, so warps that finish early take more: a box above
//    kSmallBox pixels is one item, taken by a whole warp whose lanes, laid
//    out as a 4x8 .. 32x1 patch, stride over it (a face that fills the tile
//    costs 32 lanes 32 tests each); the others go in groups of 32 of about
//    one size, one box per lane. The rows come from the global table (L1/L2)
//    when an item is taken.
//  - Pixel centres are computed once per tile (tss::ndc_center, as K1)
//    into shared memory, and the first product of each edge function once
//    per row of a box (tss::face_row_terms).
//  - Wide stores. After the search each thread owns four neighbouring
//    columns of one row, unpacks four keys and writes ids, z and (K2b) the
//    ten row channels with one 16-byte store each; winner rows come from
//    the global table once per pixel.
//  - A tile with counts[t] == 0 touches no shared memory and only stores
//    its zeros.
//  - Launch order: the grid is flat, the views of one tile side by side.
//    The hardware starts CTAs in the order of their index, and a CTA with
//    candidates runs long while one without only stores zeros. Tile after
//    tile, view by view, the last views' long CTAs would start only when
//    the empty tiles of every view before them have gone through the few
//    slots the earlier long CTAs leave free.
// What is left above the bound is the search itself: the two densest tiles
// that share an SM set the kernel's length (PERF.md).
//
// Slab form (pallas_raster.py:66 and :132, row0_ref and the static full_h):
// the H rows are absolute rows row0 + r of a full_h-tall image; pixel
// centres and the faces' row boxes are taken in absolute rows (the box
// clipped to the tile's absolute rows), the stores go to the slab's rows.

#include "vis_common.cuh"

namespace {

constexpr int kTileH = 8;
constexpr int kTileW = 128;
constexpr int kTilePx = kTileH * kTileW;
constexpr int kThreads = 512;                   // threads per CTA
constexpr int kSmallBox = 64;     // largest box (pixels) one thread takes
constexpr float kBoxPad = 1.0f;   // pixels added to each side of the slack box
constexpr int kQuads = kTilePx / 4;             // 4-pixel store groups
constexpr int kStage = kThreads * 8 < 4096 ? kThreads * 8 : 4096;
constexpr int kPerThread = kStage / kThreads;
constexpr int kClasses = kSmallBox + 2;          // size classes 0 .. kSmallBox+1
constexpr unsigned long long kBackground = ~0ull;
constexpr unsigned kFull = 0xffffffffu;

static_assert(kThreads % 32 == 0 && kThreads >= kTileW && kThreads <= 1024 &&
              kStage % kThreads == 0,
              "a CTA fills the pixel centres and stages kStage candidates");

// (z, id+1) as one key whose unsigned order is the winner's order: smaller
// z first, then smaller id. z is finite (it lies in [-1, 1]).
__device__ __forceinline__ unsigned long long make_key(float z, int id1) {
  const unsigned neg_zero = __float_as_uint(z) == 0x80000000u;
  const unsigned bits = neg_zero ? 0u : __float_as_uint(z);
  const unsigned mono = (bits & 0x80000000u) ? ~bits : (bits | 0x80000000u);
  return ((unsigned long long)mono << 32) | ((unsigned)id1 << 1) | neg_zero;
}

__device__ __forceinline__ void unpack_key(unsigned long long key, int& id1,
                                           float& z) {
  if (key == kBackground) {
    id1 = 0;
    z = 0.0f;
    return;
  }
  const unsigned low = (unsigned)key, mono = (unsigned)(key >> 32);
  const unsigned bits = (mono & 0x80000000u) ? (mono ^ 0x80000000u) : ~mono;
  id1 = (int)(low >> 1);
  z = (low & 1u) ? -0.0f : __uint_as_float(bits);
}

// One axis of a face's pixel box, clipped to the tile's pixels
// [origin, origin + extent): tile-local inclusive [p0, p1]; false when it
// is empty. a, b, c are the vertices' NDC coordinates on an axis of n
// pixels. Floats are clamped before the cast, so huge coordinates stay
// defined.
__device__ __forceinline__ bool clip_axis(float a, float b, float c, int n,
                                          int origin, int extent, int& p0,
                                          int& p1) {
  const float pa = (a + 1.0f) * 0.5f * (float)n - 0.5f;
  const float pb = (b + 1.0f) * 0.5f * (float)n - 0.5f;
  const float pc = (c + 1.0f) * 0.5f * (float)n - 0.5f;
  if (!(isfinite(pa) && isfinite(pb) && isfinite(pc))) return false;
  const float lo = fminf(fminf(pa, pb), pc);
  const float hi = fmaxf(fmaxf(pa, pb), pc);
  const float f0 = ceilf(lo - 0.5f) - kBoxPad;
  const float f1 = floorf(hi + 0.5f) + kBoxPad;
  const float t0 = (float)origin, t1 = (float)(origin + extent - 1);
  if (f1 < t0 || f0 > t1) return false;
  p0 = (int)fmaxf(f0, t0) - origin;
  p1 = (int)fminf(f1, t1) - origin;
  return true;
}

// One pixel test: evaluate the face at pixel x of the tile-local row whose
// terms are ``rt`` and whose keys are ``row_key`` and, when it covers the
// pixel, lower its key.
__device__ __forceinline__ void test_pixel(const float4& r0, const float4& r1,
                                           const float4& r2,
                                           const tss::RowTerms& rt, int id1,
                                           int x, const float* s_px,
                                           unsigned long long* row_key) {
  float z;
  if (!tss::face_covers_in_row(r0, r1, r2, rt, s_px[x], z)) return;
  atomicMin(row_key + x, make_key(z, id1));
}

// A staged candidate: its face and its clipped box, tile-local and packed
// as x0 | x1 << 8 | y0 << 16 | y1 << 24.
__device__ __forceinline__ int pack_box(int x0, int x1, int y0, int y1) {
  return x0 | x1 << 8 | y0 << 16 | y1 << 24;
}

struct Box {
  int x0, x1, y0, y1;
  __device__ __forceinline__ explicit Box(int p)
      : x0(p & 255), x1(p >> 8 & 255), y0(p >> 16 & 255), y1(p >> 24 & 255) {}
  __device__ __forceinline__ int pixels() const {
    return (x1 - x0 + 1) * (y1 - y0 + 1);
  }
};

// Boxes are sorted by their size class: their pixel count up to kSmallBox,
// and one class above it for the boxes a whole warp takes.
__device__ __forceinline__ int size_class(int npx) {
  return min(npx, kSmallBox + 1);
}

template <bool EMIT_G>
__global__ void __launch_bounds__(kThreads) vis_capped_kernel(
    const float4* __restrict__ table,      // (B, F, 4) float4 = (B, F, 16)
    const int* __restrict__ counts,        // (B * ntiles), each <= k
    const int* __restrict__ cand,          // (B * ntiles, k) face ids
    int B, int F, int H, int W, int ntx, int ntiles, int k, int slab_row0,
    int full_h, int* __restrict__ ids_out, float* __restrict__ z_out,
    float* __restrict__ g6, float* __restrict__ gaux) {
  __shared__ unsigned long long s_key[kTilePx];
  __shared__ float s_px[kTileW];
  __shared__ float s_py[kTileH];
  __shared__ int2 s_ent[kStage];           // (face, box), largest boxes first
  __shared__ int s_class[kClasses];        // counts, then write cursors
  __shared__ int s_large, s_live;          // entries a warp takes; all entries
  __shared__ int s_next;                   // next work item

  const int b = blockIdx.x % B;
  const int t = blockIdx.x / B;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int row0 = (t / ntx) * kTileH;        // the tile's first slab row
  const int abs_row0 = slab_row0 + row0;      // ... as an image row
  const int col0 = (t % ntx) * kTileW;
  const int slot = b * ntiles + t;
  const int count = counts[slot];          // uniform over the CTA
  const float4* tbl = table + (size_t)b * F * 4;

  if (count > 0) {
    for (int i = tid; i < kTilePx; i += kThreads) s_key[i] = kBackground;
    if (tid < kTileW) s_px[tid] = tss::ndc_center(col0 + tid, W);
    if (tid < kTileH) s_py[tid] = tss::ndc_center(abs_row0 + tid, full_h);

    const int* tile_cand = cand + (size_t)slot * k;
    for (int base = 0; base < count; base += kStage) {
      const int n = min(kStage, count - base);
      for (int i = tid; i < kClasses; i += kThreads) s_class[i] = 0;
      if (tid == 0) s_next = 0;
      __syncthreads();

      // 1. stage: clip every candidate's box to the tile and count the
      // boxes of each size; empty boxes go no further
      int ent_f[kPerThread], ent_box[kPerThread];
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) {
        const int i = tid + j * kThreads;
        ent_box[j] = -1;
        if (i < n) {
          const int f = tile_cand[base + i];
          const float4 r0 = tbl[(size_t)f * 4 + 0];
          const float4 r1 = tbl[(size_t)f * 4 + 1];
          const float inv_area = tbl[(size_t)f * 4 + 2].y;
          int x0, x1, y0, y1;
          if (inv_area != 0.0f &&
              clip_axis(r0.x, r0.z, r1.x, W, col0, kTileW, x0, x1) &&
              clip_axis(r0.y, r0.w, r1.y, full_h, abs_row0, kTileH, y0,
                        y1)) {
            ent_f[j] = f;
            ent_box[j] = pack_box(x0, x1, y0, y1);
            atomicAdd(&s_class[size_class(Box(ent_box[j]).pixels())], 1);
          }
        }
      }
      __syncthreads();

      // 2. where each size class starts, largest first (warp 0)
      if (tid < 32) {
        constexpr int kPer = (kClasses + 31) / 32;
        int cnt[kPer], sum = 0;
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          const int c = kClasses - 1 - (lane * kPer + j);
          cnt[j] = c >= 0 ? s_class[c] : 0;
          sum += cnt[j];
        }
        int start = sum;                   // inclusive scan over the lanes
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const int up = __shfl_up_sync(kFull, start, d);
          if (lane >= d) start += up;
        }
        if (lane == 31) s_live = start;
        start -= sum;
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          const int c = kClasses - 1 - (lane * kPer + j);
          if (c >= 0) s_class[c] = start;
          start += cnt[j];
        }
        if (lane == 0) s_large = cnt[0];   // class kClasses - 1
      }
      __syncthreads();

      // 3. place the entries by size class
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) {
        if (ent_box[j] >= 0) {
          const int c = size_class(Box(ent_box[j]).pixels());
          s_ent[atomicAdd(&s_class[c], 1)] = make_int2(ent_f[j], ent_box[j]);
        }
      }
      __syncthreads();

      // 4. search. Warps draw work items, largest first: a large box each,
      // then groups of 32 boxes of about one size, a box a lane
      const int n_large = s_large, n_live = s_live;
      const int n_items = n_large + (n_live - n_large + 31) / 32;
      for (;;) {
        int item = 0;
        if (lane == 0) item = atomicAdd(&s_next, 1);
        item = __shfl_sync(kFull, item, 0);
        if (item >= n_items) break;
        const int e = item < n_large ? item
                                     : n_large + (item - n_large) * 32 + lane;
        if (e >= n_live) continue;
        const int2 ent = s_ent[e];
        const float4 r0 = tbl[(size_t)ent.x * 4 + 0];
        const float4 r1 = tbl[(size_t)ent.x * 4 + 1];
        const float4 r2 = tbl[(size_t)ent.x * 4 + 2];
        const Box box(ent.y);
        if (item < n_large) {
          // the lanes form a (32 >> sh) x (1 << sh) patch striding the box
          const int w = box.x1 - box.x0 + 1;
          const int sh = w <= 4 ? 2 : w <= 8 ? 3 : w <= 16 ? 4 : 5;
          for (int y = box.y0 + (lane >> sh); y <= box.y1; y += 32 >> sh) {
            const tss::RowTerms rt = tss::face_row_terms(r0, r1, s_py[y]);
            for (int x = box.x0 + (lane & ((1 << sh) - 1)); x <= box.x1;
                 x += 1 << sh) {
              test_pixel(r0, r1, r2, rt, ent.x + 1, x, s_px,
                         s_key + y * kTileW);
            }
          }
        } else {
          const int npx = box.pixels();
          int x = box.x1, y = box.y0 - 1;
          tss::RowTerms rt;
          for (int i = 0; i < npx; ++i) {
            if (++x > box.x1) {
              x = box.x0;
              ++y;
              rt = tss::face_row_terms(r0, r1, s_py[y]);
            }
            test_pixel(r0, r1, r2, rt, ent.x + 1, x, s_px,
                       s_key + y * kTileW);
          }
        }
      }
      __syncthreads();
    }
  }

  // stores: four neighbouring columns of one row per thread
  const size_t HW = (size_t)H * W;
  for (int i = tid; i < kQuads; i += kThreads) {
    const int y = i / (kTileW / 4);
    const int x = (i % (kTileW / 4)) * 4;
    int id[4] = {0, 0, 0, 0};
    float z[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (count > 0) {
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        unpack_key(s_key[y * kTileW + x + p], id[p], z[p]);
      }
    }
    const size_t q = (size_t)(row0 + y) * W + col0 + x;
    *reinterpret_cast<int4*>(ids_out + (size_t)b * HW + q) =
        make_int4(id[0], id[1], id[2], id[3]);
    *reinterpret_cast<float4*>(z_out + (size_t)b * HW + q) =
        make_float4(z[0], z[1], z[2], z[3]);
    if (EMIT_G) {
      float v[4][10];
#pragma unroll
      for (int p = 0; p < 4; ++p) tss::winner_row_values(tbl, id[p], v[p]);
      float* g = g6 + (size_t)b * 6 * HW + q;
      float* a = gaux + (size_t)b * 4 * HW + q;
#pragma unroll
      for (int c = 0; c < 6; ++c) {
        *reinterpret_cast<float4*>(g + c * HW) =
            make_float4(v[0][c], v[1][c], v[2][c], v[3][c]);
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        *reinterpret_cast<float4*>(a + c * HW) =
            make_float4(v[0][6 + c], v[1][6 + c], v[2][6 + c], v[3][6 + c]);
      }
    }
  }
}

template <bool EMIT_G>
int launch(const void* table, const void* counts, const void* cand, int B,
           int F, int H, int W, int k, int row0, int full_h, void* ids_out,
           void* z_out, void* g6, void* gaux, void* stream) {
  const int nty = H / kTileH, ntx = W / kTileW;
  vis_capped_kernel<EMIT_G><<<B * nty * ntx, kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(table), static_cast<const int*>(counts),
      static_cast<const int*>(cand), B, F, H, W, ntx, nty * ntx, k, row0,
      full_h, static_cast<int*>(ids_out), static_cast<float*>(z_out),
      static_cast<float*>(g6), static_cast<float*>(gaux));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K2a: ids + z. H % 8 == 0 and W % 128 == 0 (checked by the wrapper); the
// H rows are absolute rows row0.. of a full_h-tall image.
extern "C" int tss_vis_capped_launch(const void* table, const void* counts,
                                     const void* cand, int B, int F, int H,
                                     int W, int k, int row0, int full_h,
                                     void* ids_out, void* z_out,
                                     void* stream) {
  return launch<false>(table, counts, cand, B, F, H, W, k, row0, full_h,
                       ids_out, z_out, nullptr, nullptr, stream);
}

// K2b: ids + z + the winner's rows g6, gaux.
extern "C" int tss_vis_capped_g_launch(const void* table, const void* counts,
                                       const void* cand, int B, int F, int H,
                                       int W, int k, int row0, int full_h,
                                       void* ids_out, void* z_out, void* g6,
                                       void* gaux, void* stream) {
  return launch<true>(table, counts, cand, B, F, H, W, k, row0, full_h,
                      ids_out, z_out, g6, gaux, stream);
}
