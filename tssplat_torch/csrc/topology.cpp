// Host-side topology passes of tssplat_torch: boundary-surface extraction,
// tet face adjacency and triangle edge adjacency, with open-addressing hash
// tables. The port's own copy of the JAX package's native/topology.cpp, with
// the same extern "C" entries, so both packages pair the faces of a mesh
// alike, also at a non-manifold fan edge, where a (F,3) table has to choose
// one of the fan's triangles and the numpy sort path chooses another.
//
// Built by tssplat_torch/native.py (g++ -O2 -shared -fPIC) into build/ at
// first use; loaded with ctypes.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// local faces of a tet with outward winding — must match
// tssplat_torch/mesh/surface.py:_TET_FACES
constexpr int kTetFaces[4][3] = {{1, 2, 3}, {0, 3, 2}, {0, 1, 3}, {0, 2, 1}};

inline uint64_t hash_combine(uint64_t h, uint64_t v) {
  h ^= v + 0x9e3779b97f4a7c15ull + (h << 6) + (h >> 2);
  return h;
}

struct FaceKey {
  int64_t a, b, c;  // sorted ascending
  bool operator==(const FaceKey& o) const {
    return a == o.a && b == o.b && c == o.c;
  }
};

inline FaceKey make_key(int64_t x, int64_t y, int64_t z) {
  if (x > y) { int64_t t = x; x = y; y = t; }
  if (y > z) { int64_t t = y; y = z; z = t; }
  if (x > y) { int64_t t = x; x = y; y = t; }
  return FaceKey{x, y, z};
}

inline uint64_t face_hash(const FaceKey& k) {
  uint64_t h = 0xcbf29ce484222325ull;
  h = hash_combine(h, (uint64_t)k.a);
  h = hash_combine(h, (uint64_t)k.b);
  h = hash_combine(h, (uint64_t)k.c);
  return h;
}

// open-addressing table sized to the face count (power of two)
struct FaceTable {
  std::vector<FaceKey> keys;
  std::vector<int64_t> first;   // first face slot id seen (encodes tet*4+f)
  std::vector<int32_t> count;
  std::vector<uint8_t> used;
  uint64_t mask;

  explicit FaceTable(size_t n_faces) {
    size_t cap = 16;
    while (cap < n_faces * 2) cap <<= 1;
    keys.resize(cap);
    first.resize(cap);
    count.assign(cap, 0);
    used.assign(cap, 0);
    mask = cap - 1;
  }

  // returns slot index
  size_t insert(const FaceKey& k, int64_t face_id) {
    size_t i = face_hash(k) & mask;
    while (used[i]) {
      if (keys[i] == k) {
        count[i]++;
        return i;
      }
      i = (i + 1) & mask;
    }
    used[i] = 1;
    keys[i] = k;
    first[i] = face_id;
    count[i] = 1;
    return i;
  }

  // returns -1 if absent
  int64_t find(const FaceKey& k) const {
    size_t i = face_hash(k) & mask;
    while (used[i]) {
      if (keys[i] == k) return (int64_t)i;
      i = (i + 1) & mask;
    }
    return -1;
  }
};

}  // namespace

extern "C" {

// Boundary surface extraction (parity with tssplat_torch/mesh/surface.py
// get_surface_vf; reference contract geometry/mesh_utils.py:5-35).
//
// tets: (T,4) int64. Outputs:
//   surface_tris_orig: caller buffer of size >= 4*T*3 — boundary faces in
//       ORIGINAL vertex ids, winding preserved, in first-occurrence order.
// Returns the number of boundary faces written.
int64_t tss_surface_faces(const int64_t* tets, int64_t T,
                          int64_t* surface_tris_orig) {
  FaceTable table((size_t)T * 4);
  for (int64_t t = 0; t < T; ++t) {
    const int64_t* v = tets + t * 4;
    for (int f = 0; f < 4; ++f) {
      int64_t i0 = v[kTetFaces[f][0]];
      int64_t i1 = v[kTetFaces[f][1]];
      int64_t i2 = v[kTetFaces[f][2]];
      table.insert(make_key(i0, i1, i2), t * 4 + f);
    }
  }
  // second pass in face order keeps deterministic output ordering
  int64_t n_out = 0;
  for (int64_t t = 0; t < T; ++t) {
    const int64_t* v = tets + t * 4;
    for (int f = 0; f < 4; ++f) {
      int64_t i0 = v[kTetFaces[f][0]];
      int64_t i1 = v[kTetFaces[f][1]];
      int64_t i2 = v[kTetFaces[f][2]];
      int64_t slot = table.find(make_key(i0, i1, i2));
      if (slot >= 0 && table.count[slot] == 1 &&
          table.first[slot] == t * 4 + f) {
        surface_tris_orig[n_out * 3 + 0] = i0;
        surface_tris_orig[n_out * 3 + 1] = i1;
        surface_tris_orig[n_out * 3 + 2] = i2;
        ++n_out;
      }
    }
  }
  return n_out;
}

// Tet face adjacency (parity with surface.py tet_face_neighbors): for each
// tet, up to 4 face-adjacent tets in slot order, -1 padded; degree out.
void tss_tet_face_neighbors(const int64_t* tets, int64_t T,
                            int64_t* nbrs /* (T,4) */,
                            int64_t* degree /* (T) */) {
  FaceTable table((size_t)T * 4);
  for (int64_t t = 0; t < T; ++t) {
    const int64_t* v = tets + t * 4;
    for (int f = 0; f < 4; ++f) {
      table.insert(make_key(v[kTetFaces[f][0]], v[kTetFaces[f][1]],
                            v[kTetFaces[f][2]]),
                   t * 4 + f);
    }
  }
  for (int64_t i = 0; i < T; ++i) {
    nbrs[i * 4] = nbrs[i * 4 + 1] = nbrs[i * 4 + 2] = nbrs[i * 4 + 3] = -1;
    degree[i] = 0;
  }
  // pair up shared faces: count==2 means exactly two (tet,face) incidences;
  // re-scan to find both
  std::vector<int64_t> second(table.keys.size(), -1);
  for (int64_t t = 0; t < T; ++t) {
    const int64_t* v = tets + t * 4;
    for (int f = 0; f < 4; ++f) {
      int64_t slot = table.find(make_key(v[kTetFaces[f][0]],
                                         v[kTetFaces[f][1]],
                                         v[kTetFaces[f][2]]));
      if (slot < 0 || table.count[slot] != 2) continue;
      if (table.first[slot] == t * 4 + f) continue;  // first incidence
      second[slot] = t * 4 + f;
    }
  }
  for (size_t s = 0; s < table.keys.size(); ++s) {
    if (!table.used[s] || table.count[s] != 2 || second[s] < 0) continue;
    int64_t ta = table.first[s] / 4;
    int64_t tb = second[s] / 4;
    nbrs[ta * 4 + degree[ta]++] = tb;
    nbrs[tb * 4 + degree[tb]++] = ta;
  }
}

// Triangle edge adjacency (parity with surface.py triangle_edge_neighbors):
// out[t*3+e] = other triangle sharing edge e ((0,1),(1,2),(2,0)), else -1.
void tss_triangle_edge_neighbors(const int64_t* faces, int64_t F,
                                 int64_t* out /* (F,3) */) {
  struct EdgeRec { int64_t tri; int32_t slot; };
  // key -> first incidence; matched pairs written directly
  size_t cap = 16;
  while (cap < (size_t)F * 6) cap <<= 1;
  std::vector<int64_t> ka(cap), kb(cap), tri(cap);
  std::vector<int32_t> slot(cap);
  std::vector<uint8_t> used(cap, 0);
  uint64_t mask = cap - 1;

  for (int64_t i = 0; i < F * 3; ++i) out[i] = -1;

  const int e0[3] = {0, 1, 2};
  const int e1[3] = {1, 2, 0};
  for (int64_t t = 0; t < F; ++t) {
    for (int e = 0; e < 3; ++e) {
      int64_t a = faces[t * 3 + e0[e]];
      int64_t b = faces[t * 3 + e1[e]];
      if (a > b) { int64_t tmp = a; a = b; b = tmp; }
      uint64_t h = hash_combine(hash_combine(0x9e3779b9ull, (uint64_t)a),
                                (uint64_t)b) & mask;
      for (;;) {
        if (!used[h]) {
          used[h] = 1; ka[h] = a; kb[h] = b; tri[h] = t; slot[h] = e;
          break;
        }
        if (ka[h] == a && kb[h] == b) {
          out[tri[h] * 3 + slot[h]] = t;
          out[t * 3 + e] = tri[h];
          // leave entry (3+ incidences at a non-manifold edge keep pairing
          // with the first, matching the numpy lexsort pairing closely
          // enough for AA purposes)
          break;
        }
        h = (h + 1) & mask;
      }
    }
  }
}

}  // extern "C"
