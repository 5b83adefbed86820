// Native host components of solstrale_tpu_torch: fast OBJ mesh ingest and
// the large-scene LBVH sort and node reduction. These are the host-side,
// scene-compilation hot paths — the counterpart of the reference's Rust
// `tobj` loader (loader/obj.rs) and rayon-parallel BVH build
// (hittable/bvh.rs:84-114). The JAX package carries the same source
// (solstrale_tpu/native/solstrale_native.cpp); the two stay identical below
// this header, so both packages parse and sort alike.
//
// C ABI, built with g++ at first use and bound from Python with ctypes
// (native/__init__.py).

#include <algorithm>
#include <atomic>
#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

extern "C" {

// ---------------------------------------------------------------- OBJ ----

struct ObjMesh {
  float* tri_verts;  // n_tris * 9  (v0 v1 v2)
  float* tri_uvs;    // n_tris * 6
  int32_t* tri_mat;  // n_tris, index into mat_names order, -1 = none
  int32_t n_tris;
  int32_t has_uvs;
  char* mat_names;  // '\n'-joined usemtl names (id order)
  char* mtl_libs;   // '\n'-joined mtllib entries
};

static char* dup_string(const std::string& s) {
  char* p = static_cast<char*>(std::malloc(s.size() + 1));
  std::memcpy(p, s.c_str(), s.size() + 1);
  return p;
}

// Fan-triangulating Wavefront OBJ parser. Handles v/vt/f records,
// v[/vt[/vn]] face syntax and negative (relative) indices, matching the
// subset the reference's tobj usage exercises (loader/obj.rs:45-53).
ObjMesh* obj_parse(const char* path) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::string data(static_cast<size_t>(size), '\0');
  if (std::fread(data.data(), 1, size, f) != static_cast<size_t>(size)) {
    std::fclose(f);
    return nullptr;
  }
  std::fclose(f);

  std::vector<float> positions, texcoords;
  std::vector<float> tri_verts, tri_uvs;
  std::vector<int32_t> tri_mat;
  std::vector<std::string> mat_names;
  std::unordered_map<std::string, int32_t> mat_ids;
  std::string mtl_libs;
  int32_t current_mat = -1;
  bool any_uv = false;

  const char* p = data.c_str();
  const char* end = p + data.size();

  auto skip_ws = [&](const char*& q) {
    while (q < end && (*q == ' ' || *q == '\t')) q++;
  };
  auto line_end = [&](const char* q) {
    while (q < end && *q != '\n') q++;
    return q;
  };

  std::vector<long> fv, fuv;  // per-face scratch
  while (p < end) {
    skip_ws(p);
    const char* le = line_end(p);
    if (p < le) {
      if (p[0] == 'v' && (p[1] == ' ' || p[1] == '\t')) {
        char* q;
        float x = std::strtof(p + 1, &q);
        float y = std::strtof(q, &q);
        float z = std::strtof(q, &q);
        positions.insert(positions.end(), {x, y, z});
      } else if (p[0] == 'v' && p[1] == 't' &&
                 (p[2] == ' ' || p[2] == '\t')) {
        char* q;
        float u = std::strtof(p + 2, &q);
        float v = std::strtof(q, &q);
        texcoords.insert(texcoords.end(), {u, v});
      } else if (p[0] == 'f' && (p[1] == ' ' || p[1] == '\t')) {
        fv.clear();
        fuv.clear();
        const char* q = p + 1;
        while (q < le) {
          while (q < le && (*q == ' ' || *q == '\t')) q++;
          if (q >= le) break;
          char* r;
          long vi = std::strtol(q, &r, 10);
          long ti = 0;
          bool has_t = false;
          if (r < le && *r == '/') {
            r++;
            if (r < le && *r != '/') {
              ti = std::strtol(r, &r, 10);
              has_t = true;
            }
            if (r < le && *r == '/') {
              r++;
              std::strtol(r, &r, 10);  // normal index, ignored
            }
          }
          long np = static_cast<long>(positions.size() / 3);
          fv.push_back(vi > 0 ? vi - 1 : np + vi);
          long nt = static_cast<long>(texcoords.size() / 2);
          fuv.push_back(has_t ? (ti > 0 ? ti - 1 : nt + ti) : -1);
          q = r;
        }
        for (size_t i = 1; i + 1 < fv.size(); i++) {
          const size_t ids[3] = {0, i, i + 1};
          for (size_t k = 0; k < 3; k++) {
            long vi = fv[ids[k]];
            tri_verts.insert(tri_verts.end(),
                             {positions[3 * vi], positions[3 * vi + 1],
                              positions[3 * vi + 2]});
            long ti = fuv[ids[k]];
            if (ti >= 0) {
              any_uv = true;
              tri_uvs.insert(tri_uvs.end(),
                             {texcoords[2 * ti], texcoords[2 * ti + 1]});
            } else {
              tri_uvs.insert(tri_uvs.end(), {0.0f, 0.0f});
            }
          }
          tri_mat.push_back(current_mat);
        }
      } else if (!std::strncmp(p, "usemtl", 6)) {
        const char* q = p + 6;
        skip_ws(q);
        std::string name(q, le - q);
        while (!name.empty() &&
               (name.back() == '\r' || name.back() == ' ')) name.pop_back();
        auto it = mat_ids.find(name);
        if (it == mat_ids.end()) {
          current_mat = static_cast<int32_t>(mat_names.size());
          mat_ids.emplace(name, current_mat);
          mat_names.push_back(name);
        } else {
          current_mat = it->second;
        }
      } else if (!std::strncmp(p, "mtllib", 6)) {
        const char* q = p + 6;
        skip_ws(q);
        std::string name(q, le - q);
        while (!name.empty() &&
               (name.back() == '\r' || name.back() == ' ')) name.pop_back();
        if (!mtl_libs.empty()) mtl_libs += '\n';
        mtl_libs += name;
      }
    }
    p = le + 1;
  }

  ObjMesh* mesh = static_cast<ObjMesh*>(std::malloc(sizeof(ObjMesh)));
  mesh->n_tris = static_cast<int32_t>(tri_mat.size());
  mesh->has_uvs = any_uv ? 1 : 0;
  size_t nv = tri_verts.size() * sizeof(float);
  mesh->tri_verts = static_cast<float*>(std::malloc(nv));
  std::memcpy(mesh->tri_verts, tri_verts.data(), nv);
  size_t nu = tri_uvs.size() * sizeof(float);
  mesh->tri_uvs = static_cast<float*>(std::malloc(nu));
  std::memcpy(mesh->tri_uvs, tri_uvs.data(), nu);
  size_t nm = tri_mat.size() * sizeof(int32_t);
  mesh->tri_mat = static_cast<int32_t*>(std::malloc(nm));
  std::memcpy(mesh->tri_mat, tri_mat.data(), nm);
  std::string joined;
  for (size_t i = 0; i < mat_names.size(); i++) {
    if (i) joined += '\n';
    joined += mat_names[i];
  }
  mesh->mat_names = dup_string(joined);
  mesh->mtl_libs = dup_string(mtl_libs);
  return mesh;
}

void obj_free(ObjMesh* mesh) {
  if (!mesh) return;
  std::free(mesh->tri_verts);
  std::free(mesh->tri_uvs);
  std::free(mesh->tri_mat);
  std::free(mesh->mat_names);
  std::free(mesh->mtl_libs);
  std::free(mesh);
}

// --------------------------------------------------------------- LBVH ----

static inline uint32_t expand_bits(uint32_t v) {
  v = (v * 0x00010001u) & 0xFF0000FFu;
  v = (v * 0x00000101u) & 0x0F00F00Fu;
  v = (v * 0x00000011u) & 0xC30C30C3u;
  v = (v * 0x00000005u) & 0x49249249u;
  return v;
}

// Morton-sorted permutation of primitive AABB centroids. Parallel sort via
// std::thread merge — the counterpart of the reference's rayon::join build
// parallelism (bvh.rs:100-103).
void lbvh_sort(const float* aabb_min, const float* aabb_max, int32_t n,
               int32_t* order_out) {
  float lo[3] = {INFINITY, INFINITY, INFINITY};
  float hi[3] = {-INFINITY, -INFINITY, -INFINITY};
  for (int32_t i = 0; i < n; i++) {
    for (int k = 0; k < 3; k++) {
      float c = 0.5f * (aabb_min[3 * i + k] + aabb_max[3 * i + k]);
      lo[k] = std::min(lo[k], c);
      hi[k] = std::max(hi[k], c);
    }
  }
  float ext[3];
  for (int k = 0; k < 3; k++) ext[k] = std::max(hi[k] - lo[k], 1e-12f);

  std::vector<std::pair<uint32_t, int32_t>> keyed(n);
  int hw = std::max(1u, std::thread::hardware_concurrency());
  int n_threads = std::min<int>(hw, 16);
  std::vector<std::thread> threads;
  auto work = [&](int32_t a, int32_t b) {
    for (int32_t i = a; i < b; i++) {
      uint32_t q[3];
      for (int k = 0; k < 3; k++) {
        float c = 0.5f * (aabb_min[3 * i + k] + aabb_max[3 * i + k]);
        float t = (c - lo[k]) / ext[k] * 1023.0f;
        q[k] = static_cast<uint32_t>(std::min(std::max(t, 0.0f), 1023.0f));
      }
      uint32_t code = (expand_bits(q[0]) << 2) | (expand_bits(q[1]) << 1) |
                      expand_bits(q[2]);
      keyed[i] = {code, i};
    }
  };
  int32_t chunk = (n + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; t++) {
    int32_t a = t * chunk;
    int32_t b = std::min(n, a + chunk);
    if (a < b) threads.emplace_back(work, a, b);
  }
  for (auto& t : threads) t.join();

  std::stable_sort(keyed.begin(), keyed.end(),
                   [](const auto& x, const auto& y) {
                     return x.first < y.first;
                   });
  for (int32_t i = 0; i < n; i++) order_out[i] = keyed[i].second;
}

// Bottom-up AABB reduction over the complete tree: slot AABBs (leaves,
// n_slots = n_leaves*leaf_size, padded with +inf/-inf) → 2*n_leaves-1 node
// AABBs in implicit-index order.
void lbvh_nodes(const float* slot_min, const float* slot_max, int32_t n_slots,
                int32_t leaf_size, float* node_min, float* node_max) {
  int32_t n_leaves = n_slots / leaf_size;
  int32_t base = n_leaves - 1;
  for (int32_t l = 0; l < n_leaves; l++) {
    float mn[3] = {INFINITY, INFINITY, INFINITY};
    float mx[3] = {-INFINITY, -INFINITY, -INFINITY};
    for (int32_t s = 0; s < leaf_size; s++) {
      for (int k = 0; k < 3; k++) {
        mn[k] = std::min(mn[k], slot_min[3 * (l * leaf_size + s) + k]);
        mx[k] = std::max(mx[k], slot_max[3 * (l * leaf_size + s) + k]);
      }
    }
    for (int k = 0; k < 3; k++) {
      node_min[3 * (base + l) + k] = mn[k];
      node_max[3 * (base + l) + k] = mx[k];
    }
  }
  for (int32_t i = base - 1; i >= 0; i--) {
    for (int k = 0; k < 3; k++) {
      node_min[3 * i + k] = std::min(node_min[3 * (2 * i + 1) + k],
                                     node_min[3 * (2 * i + 2) + k]);
      node_max[3 * i + k] = std::max(node_max[3 * (2 * i + 1) + k],
                                     node_max[3 * (2 * i + 2) + k]);
    }
  }
}

}  // extern "C"
