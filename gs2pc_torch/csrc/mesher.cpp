// Marching tetrahedra on a dense density grid -- the port's copy of the
// JAX package's gs2pc/native/mesher.cpp, unchanged below this comment.
//
// C++ twin of gs2pc_torch.meshing_native._marching_tetrahedra_numpy (same
// 6-tet cube decomposition sharing the (0,0,0)-(1,1,1) diagonal, same
// inside-first corner ordering and edge-interpolation semantics): one pass
// with an open-addressing edge hash instead of the numpy pass's ~100 us per
// active cube and GBs of index arrays at poisson_depth 10.  Built with g++
// at first use (gs2pc_torch/ops/cuda_build.py::load_mesher) and called
// through ctypes.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <vector>

namespace {

struct MeshCtx {
  std::vector<float> verts;   // x,y,z triples (lattice coordinates)
  std::vector<int32_t> faces; // i,j,k triples
};

// Cube corner offsets, bit 0 = +x, bit 1 = +y, bit 2 = +z (matches
// _CORNER_OFFSETS in meshing_native.py).
static const int kCorner[8][3] = {
    {0, 0, 0}, {1, 0, 0}, {0, 1, 0}, {1, 1, 0},
    {0, 0, 1}, {1, 0, 1}, {0, 1, 1}, {1, 1, 1},
};

// 6 tetrahedra sharing the main diagonal 0-7 (matches _TETS).
static const int kTets[6][4] = {
    {0, 1, 3, 7}, {0, 3, 2, 7}, {0, 2, 6, 7},
    {0, 6, 4, 7}, {0, 4, 5, 7}, {0, 5, 1, 7},
};

// Open-addressing hash map (with growth): edge key -> vertex id.
struct EdgeMap {
  std::vector<uint64_t> keys;
  std::vector<int32_t> vals;
  uint64_t mask;
  size_t count = 0;

  explicit EdgeMap(size_t expect) {
    size_t cap = 64;
    while (cap < expect * 2) cap <<= 1;
    keys.assign(cap, UINT64_MAX);
    vals.assign(cap, -1);
    mask = cap - 1;
  }

  static inline size_t probe0(uint64_t key, uint64_t mask) {
    return (size_t)((key * 0x9E3779B97F4A7C15ULL) & mask);
  }

  void grow() {
    std::vector<uint64_t> ok(std::move(keys));
    std::vector<int32_t> ov(std::move(vals));
    size_t cap = (mask + 1) * 2;
    keys.assign(cap, UINT64_MAX);
    vals.assign(cap, -1);
    mask = cap - 1;
    for (size_t i = 0; i < ok.size(); ++i) {
      if (ok[i] == UINT64_MAX) continue;
      size_t j = probe0(ok[i], mask);
      while (keys[j] != UINT64_MAX) j = (j + 1) & mask;
      keys[j] = ok[i];
      vals[j] = ov[i];
    }
  }

  // Returns existing id or -1 and remembers the probe slot.
  int32_t find_or_reserve(uint64_t key, size_t* slot) {
    if (count * 10 >= (mask + 1) * 7) grow();  // keep load factor <= 0.7
    size_t i = probe0(key, mask);
    for (;;) {
      if (keys[i] == key) return vals[i];
      if (keys[i] == UINT64_MAX) {
        *slot = i;
        return -1;
      }
      i = (i + 1) & mask;
    }
  }

  void put(size_t slot, uint64_t key, int32_t val) {
    keys[slot] = key;
    vals[slot] = val;
    ++count;
  }
};

struct Extractor {
  const float* grid;
  int64_t res;
  float iso;
  MeshCtx* out;
  EdgeMap edges;

  Extractor(const float* g, int64_t r, float i, MeshCtx* o, size_t expect)
      : grid(g), res(r), iso(i), out(o), edges(expect) {}

  inline float val(int64_t x, int64_t y, int64_t z) const {
    return grid[(x * res + y) * res + z];
  }

  // Canonical edge vertex between lattice corners ka/kb with values va/vb.
  int32_t edge_vertex(uint64_t ka, uint64_t kb, float va, float vb) {
    if (ka > kb) {
      uint64_t tk = ka; ka = kb; kb = tk;
      float tv = va; va = vb; vb = tv;
    }
    uint64_t key = ka * (uint64_t)(res * res * res) + kb;
    size_t slot;
    int32_t id = edges.find_or_reserve(key, &slot);
    if (id >= 0) return id;

    float denom = vb - va;
    if (std::fabs(denom) < 1e-20f) denom = 1e-20f;
    float t = (iso - va) / denom;
    if (t < 0.0f) t = 0.0f;
    if (t > 1.0f) t = 1.0f;

    double r2 = (double)(res * res);
    double ax = (double)(ka / (uint64_t)r2);
    double ay = (double)((ka / (uint64_t)res) % (uint64_t)res);
    double az = (double)(ka % (uint64_t)res);
    double bx = (double)(kb / (uint64_t)r2);
    double by = (double)((kb / (uint64_t)res) % (uint64_t)res);
    double bz = (double)(kb % (uint64_t)res);

    id = (int32_t)(out->verts.size() / 3);
    out->verts.push_back((float)(ax + t * (bx - ax)));
    out->verts.push_back((float)(ay + t * (by - ay)));
    out->verts.push_back((float)(az + t * (bz - az)));
    edges.put(slot, key, id);
    return id;
  }

  inline void tri(int32_t a, int32_t b, int32_t c) {
    if (a == b || b == c || a == c) return;  // degenerate (shared-face dup)
    out->faces.push_back(a);
    out->faces.push_back(b);
    out->faces.push_back(c);
  }

  void run() {
    const int64_t r1 = res - 1;
    for (int64_t x = 0; x < r1; ++x) {
      for (int64_t y = 0; y < r1; ++y) {
        const float* col0 = &grid[(x * res + y) * res];
        const float* col1 = &grid[(x * res + y + 1) * res];
        const float* col2 = &grid[((x + 1) * res + y) * res];
        const float* col3 = &grid[((x + 1) * res + y + 1) * res];
        for (int64_t z = 0; z < r1; ++z) {
          float v[8];
          v[0] = col0[z];     // (0,0,0)
          v[1] = col2[z];     // (1,0,0)
          v[2] = col1[z];     // (0,1,0)
          v[3] = col3[z];     // (1,1,0)
          v[4] = col0[z + 1]; // (0,0,1)
          v[5] = col2[z + 1]; // (1,0,1)
          v[6] = col1[z + 1]; // (0,1,1)
          v[7] = col3[z + 1]; // (1,1,1)

          int insmask = 0;
          for (int c = 0; c < 8; ++c) insmask |= (v[c] > iso) << c;
          if (insmask == 0 || insmask == 0xFF) continue;

          uint64_t gkey[8];
          for (int c = 0; c < 8; ++c) {
            gkey[c] = ((uint64_t)(x + kCorner[c][0]) * res +
                       (uint64_t)(y + kCorner[c][1])) * res +
                      (uint64_t)(z + kCorner[c][2]);
          }

          for (int t = 0; t < 6; ++t) {
            // Inside-first stable ordering of the tet's corners (matches
            // numpy argsort(~ins, stable)).
            int ord[4];
            int n_in = 0;
            for (int c = 0; c < 4; ++c)
              if (v[kTets[t][c]] > iso) ord[n_in++] = kTets[t][c];
            int n = n_in;
            for (int c = 0; c < 4; ++c)
              if (!(v[kTets[t][c]] > iso)) ord[n++] = kTets[t][c];
            if (n_in == 0 || n_in == 4) continue;

            uint64_t k0 = gkey[ord[0]], k1 = gkey[ord[1]],
                     k2 = gkey[ord[2]], k3 = gkey[ord[3]];
            float v0 = v[ord[0]], v1 = v[ord[1]], v2 = v[ord[2]],
                  v3 = v[ord[3]];

            if (n_in == 1) {
              tri(edge_vertex(k0, k1, v0, v1),
                  edge_vertex(k0, k2, v0, v2),
                  edge_vertex(k0, k3, v0, v3));
            } else if (n_in == 3) {
              tri(edge_vertex(k3, k0, v3, v0),
                  edge_vertex(k3, k1, v3, v1),
                  edge_vertex(k3, k2, v3, v2));
            } else {  // n_in == 2: quad split into two triangles
              int32_t e02 = edge_vertex(k0, k2, v0, v2);
              int32_t e03 = edge_vertex(k0, k3, v0, v3);
              int32_t e13 = edge_vertex(k1, k3, v1, v3);
              int32_t e12 = edge_vertex(k1, k2, v1, v2);
              tri(e02, e03, e13);
              tri(e02, e13, e12);
            }
          }
        }
      }
    }
  }
};

}  // namespace

extern "C" {

// Phase 1: extract; returns an opaque context + sizes.
int gs2pc_marching_tet(const float* grid, int64_t res, float iso,
                       void** ctx_out, int64_t* nverts, int64_t* nfaces) {
  if (!grid || res < 2 || !ctx_out || !nverts || !nfaces) return -1;
  MeshCtx* ctx = new (std::nothrow) MeshCtx();
  if (!ctx) return -2;
  // Initial edge-map sizing from a cheap strided sign-flip census (the
  // map also grows on demand, this just avoids early rehash churn).
  int64_t n = res * res * res;
  int64_t flips = 0;
  for (int64_t i = 1; i < n; i += 97)
    flips += (grid[i] > iso) != (grid[i - 1] > iso);
  Extractor ex(grid, res, iso, ctx, (size_t)(flips * 97 * 4 + 4096));
  ex.run();
  *ctx_out = ctx;
  *nverts = (int64_t)(ctx->verts.size() / 3);
  *nfaces = (int64_t)(ctx->faces.size() / 3);
  return 0;
}

// Phase 2: copy out and free.
int gs2pc_marching_tet_fetch(void* ctx_in, float* verts, int32_t* faces) {
  MeshCtx* ctx = (MeshCtx*)ctx_in;
  if (!ctx) return -1;
  if (verts && !ctx->verts.empty())
    std::memcpy(verts, ctx->verts.data(), ctx->verts.size() * sizeof(float));
  if (faces && !ctx->faces.empty())
    std::memcpy(faces, ctx->faces.data(), ctx->faces.size() * sizeof(int32_t));
  delete ctx;
  return 0;
}

}  // extern "C"
