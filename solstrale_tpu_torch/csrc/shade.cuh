// The shading step's device functions, shared by the render megakernel (K5,
// megakernel.cu), the wavefront step kernels (S1 and S2, step.cu) and the
// first-hit kernels (CR and FH, first_hit.cu):
// vector helpers in geo/soa.py's association order, the samplers of
// ops/rng.py, the material, texture and light-table lookups, the NEE light
// pdf and light sample, the hit's attributes, blend walk and normal map
// (S1 and the first-hit kernels FH and FHB, first_hit.cu), the sums over a
// warp's lanes that share a row (the backward kernels S1B and FHB), and the
// thin-lens camera ray (K5, S2 and the camera-ray kernels CR and CRB,
// first_hit.cu).
//
// Each formula follows its plain PyTorch version expression for expression;
// compiled with -fmad=false (ops/_build.py) a kernel returns that version's
// values bit for bit on the card. PyTorch's CUDA ops round as IEEE f32 with
// libdevice's transcendentals, and so do these.
#pragma once

#include <cstdint>

#include "hit.cuh"

namespace shade {

// Python float constants as torch rounds them to f32 (geo, math.pi)
constexpr float kPi = static_cast<float>(3.14159265358979323846);
constexpr float kTwoPi = static_cast<float>(2.0 * 3.14159265358979323846);
constexpr float kSphereValue =
    static_cast<float>(1.0 / (4.0 * 3.14159265358979323846));

// x / s with s a Python scalar: PyTorch's CUDA division multiplies by the
// scalar's f32 reciprocal (div_true_kernel_cuda), so the plain version on
// the card does that, and so does this kernel (the CPU divides exactly).
__device__ __forceinline__ float div_scalar(float x, float s) {
  return x * (1.0f / s);
}

// RNG purposes (ops/rng.py)
constexpr uint32_t P_JITTER = 0, P_LENS = 1, P_MIX_COIN = 2,
                   P_LIGHT_PICK = 3, P_LIGHT_SAMPLE = 4, P_COSINE = 5,
                   P_DIELECTRIC = 6, P_FUZZ = 7, P_BLEND_SCATTER = 9,
                   P_BLEND_NORMAL = 10, P_PHASE = 11, P_MEDIUM_BASE = 16;

// material kinds (scene/materials.py) and light kinds (scene/compile.py)
constexpr int LAMBERTIAN = 0, METAL = 1, DIELECTRIC = 2, DIFFUSE_LIGHT = 3,
              ISOTROPIC = 4, BLEND = 5;
constexpr int LIGHT_SPHERE = 0, LIGHT_QUAD = 1;
constexpr int kMaxBlendDepth = 3;
// intersect._MEAN3_UNROLL_MAX: the light count above which the plain
// light_pdf_mean3 takes its batched (R, L) form
constexpr int kMeanUnrollMax = 16;
constexpr int kFlagBlend = 1;

// counter RNG: PCG4D, bit-equal to ops/rng.py (hit.cuh)
using hit::uniform4;

// --- vector helpers in geo/soa.py's association order ------------------------

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 v3(float x, float y, float z) { return {x, y, z}; }
__device__ __forceinline__ V3 add(V3 a, V3 b) {
  return {a.x + b.x, a.y + b.y, a.z + b.z};
}
__device__ __forceinline__ V3 sub(V3 a, V3 b) {
  return {a.x - b.x, a.y - b.y, a.z - b.z};
}
__device__ __forceinline__ V3 scale(V3 a, float s) {
  return {a.x * s, a.y * s, a.z * s};
}
__device__ __forceinline__ V3 neg(V3 a) { return {-a.x, -a.y, -a.z}; }
__device__ __forceinline__ float dot(V3 a, V3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
          a.x * b.y - a.y * b.x};
}
__device__ __forceinline__ V3 unit(V3 a) {
  const float inv = 1.0f / sqrtf(dot(a, a));
  return scale(a, inv);
}
__device__ __forceinline__ V3 sel(bool m, V3 a, V3 b) { return m ? a : b; }

// torch.clamp / torch.minimum keep NaN (fminf/fmaxf would drop it)
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x < lo ? lo : x;
}
__device__ __forceinline__ float clamp_max(float x, float hi) {
  return x > hi ? hi : x;
}
__device__ __forceinline__ float nan_min(float a, float b) {
  if (a != a || b != b) return a + b;  // NaN
  return a < b ? a : b;
}

__device__ __forceinline__ V3 reflect(V3 v, V3 n) {
  const float k = 2.0f * dot(v, n);
  return {v.x - n.x * k, v.y - n.y * k, v.z - n.z * k};
}

__device__ __forceinline__ V3 refract(V3 v, V3 n, float ir) {
  const float cos_theta = clamp_max(dot(neg(v), n), 1.0f);
  const V3 perp = scale(add(scale(n, cos_theta), v), ir);
  const float par_k = -sqrtf(fabsf(1.0f - dot(perp, perp)));
  return add(perp, scale(n, par_k));
}

// (tangent, bitangent, normal) from a direction (geo/soa.py::onb_from_w3)
__device__ __forceinline__ void onb_from_w(V3 w, V3* t, V3* b, V3* n) {
  const V3 uw = unit(w);
  const bool pick = fabsf(uw.x) > 0.9f;
  const V3 a = v3(pick ? 0.0f : 1.0f, pick ? 1.0f : 0.0f, 0.0f);
  const V3 v = unit(cross(uw, a));
  *t = cross(uw, v);
  *b = v;
  *n = uw;
}

__device__ __forceinline__ V3 onb_local(V3 t, V3 b, V3 n, V3 v) {
  return {t.x * v.x + b.x * v.y + n.x * v.z,
          t.y * v.x + b.y * v.y + n.y * v.z,
          t.z * v.x + b.z * v.y + n.z * v.z};
}

// --- samplers (ops/rng.py) -------------------------------------------------

__device__ __forceinline__ V3 cosine_direction(float r1, float r2) {
  const float z = sqrtf(1.0f - r2);
  const float phi = kTwoPi * r1;
  const float sq_r2 = sqrtf(r2);
  return {cosf(phi) * sq_r2, sinf(phi) * sq_r2, z};
}

__device__ __forceinline__ V3 unit_vector(float r1, float r2) {
  const float z = 1.0f - 2.0f * r1;
  const float phi = kTwoPi * r2;
  const float zz = sqrtf(clamp_min(1.0f - z * z, 0.0f));
  return {cosf(phi) * zz, sinf(phi) * zz, z};
}

__device__ __forceinline__ V3 in_unit_sphere(float r1, float r2, float r3) {
  const V3 d = unit_vector(r1, r2);
  const float radius = expf(div_scalar(logf(clamp_min(r3, 1e-12f)), 3.0f));
  return {d.x * radius, d.y * radius, d.z * radius};
}

__device__ __forceinline__ V3 to_sphere(float radius, float dist_sq, float r1,
                                        float r2) {
  const float z = 1.0f + r2 * (sqrtf(clamp_min(
                      1.0f - radius * radius / dist_sq, 0.0f)) - 1.0f);
  const float phi = kTwoPi * r1;
  const float zz = sqrtf(clamp_min(1.0f - z * z, 0.0f));
  return {cosf(phi) * zz, sinf(phi) * zz, z};
}

// --- scene tables ------------------------------------------------------------

struct Scene {
  const float* __restrict__ cam;      // (24,)
  const float4* __restrict__ sph;     // (S, 8)
  int n_sph;
  const float4* __restrict__ pln;     // (P, 28)
  int n_pl;
  const float* __restrict__ mats;     // (Mt, 9)
  int n_mat;
  const float* __restrict__ tex_attr; // (T, 3) offset w h
  int n_tex;
  const float* __restrict__ texels;   // (N, 3)
  int n_texels;
  const float* __restrict__ lights;   // (L, 20)
  int n_light;
  const float4* __restrict__ msph;    // packed medium boundaries (., 8)
  const float4* __restrict__ mpln;    // (., 16)
  const int* __restrict__ msph_off;   // (M+1,)
  const int* __restrict__ mpln_off;
  const float* __restrict__ med;      // (M, 4) neg_inv_density mat 0 0
  const float4* __restrict__ mbox;    // (M, 8) padded box: lo 0 hi 0
  int n_media;
  int flags;
};

constexpr int kPlnRow = 7;  // float4s per (P, 28) planar row

struct MatRow {
  int kind, albedo_tex;
  float fuzz, ior, atten, blend_factor;
  int m1, m2;
};

// Materials.attr row; an out-of-range id reads a zero row (table_rows)
__device__ __forceinline__ MatRow mat_row(const Scene& sc, int id) {
  MatRow r = {0, 0, 0.f, 0.f, 0.f, 0.f, 0, 0};
  if (id >= 0 && id < sc.n_mat) {
    const float* m = sc.mats + 9 * id;
    r.kind = static_cast<int>(m[0]);
    r.albedo_tex = static_cast<int>(m[1]);
    r.fuzz = m[3];
    r.ior = m[4];
    r.atten = m[5];
    r.blend_factor = m[6];
    r.m1 = static_cast<int>(m[7]);
    r.m2 = static_cast<int>(m[8]);
  }
  return r;
}

// integrator.texel_index: the arena row sample_texture reads (nearest
// neighbour, abs-wrap, flipped v, out-of-range indices clamped)
__device__ __forceinline__ int texel_row(const Scene& sc, int tex_id,
                                         float u_in, float v_in) {
  const int tid = tex_id < 0 ? 0 : tex_id;
  int off = 0, w = 0, h = 0;
  if (tid < sc.n_tex) {
    off = static_cast<int>(sc.tex_attr[3 * tid]);
    w = static_cast<int>(sc.tex_attr[3 * tid + 1]);
    h = static_cast<int>(sc.tex_attr[3 * tid + 2]);
  }
  const float u = fmodf(fabsf(u_in), 1.0f);
  const float v = 1.0f - fmodf(fabsf(v_in), 1.0f);
  const int x = static_cast<int>(u * static_cast<float>(w - 1));
  const int y = static_cast<int>(v * static_cast<float>(h - 1));
  const int idx = off + y * w + x;
  return idx < 0 ? 0 : (idx > sc.n_texels - 1 ? sc.n_texels - 1 : idx);
}

// integrator.sample_texture: the texel at texel_row
__device__ __forceinline__ V3 sample_texture(const Scene& sc, int tex_id,
                                             float u_in, float v_in) {
  const float* px =
      sc.texels + 3 * static_cast<size_t>(texel_row(sc, tex_id, u_in, v_in));
  return {px[0], px[1], px[2]};
}

// Mean over lights of the per-light sampling pdf towards direction d from
// point o (intersect.light_pdf_mean3), summed in light order. Above
// kMeanUnrollMax lights the plain version takes each light's pdf from the
// batched (R, L) table (intersect.light_pdf_values), which counts a planar
// light only where its t is finite; below, an accepted infinite t counts.
// kSkipMisses (S1's form): a light the direction cannot hit (a sphere's
// negative discriminant, a planar light's failed test) adds its 0 without
// the divisions and square roots of its pdf; the sum is the same bits.
template <bool kSkipMisses = false>
__device__ float light_pdf_mean(const Scene& sc, V3 o, V3 d) {
  const bool batched = sc.n_light > kMeanUnrollMax;
  const float dd = dot(d, d);
  float acc = 0.0f;
  for (int i = 0; i < sc.n_light; ++i) {
    const float* L = sc.lights + 20 * i;
    const int kind = static_cast<int>(L[0]);
    const V3 p0 = v3(L[1], L[2], L[3]);
    if (kind == LIGHT_SPHERE) {
      const V3 oc = sub(o, p0);
      const float half_b = dot(oc, d);
      const float radius = L[10];
      const float dist_sq = dot(oc, oc);
      const float c2 = dist_sq - radius * radius;
      const float disc = half_b * half_b - dd * c2;
      if (kSkipMisses && !(disc >= 0.0f)) {
        acc = acc + 0.0f;
        continue;
      }
      const float sq = sqrtf(clamp_min(disc, 0.0f));
      const float r1 = (-half_b - sq) / dd;
      const float r2 = (-half_b + sq) / dd;
      const bool sph_hit = (disc >= 0.0f) &&
                           ((r1 >= hit::kRayTMin && r1 <= CUDART_INF_F) ||
                            (r2 >= hit::kRayTMin && r2 <= CUDART_INF_F));
      const float cos_theta_max = sqrtf(1.0f - radius * radius / dist_sq);
      const float solid_angle = kTwoPi * (1.0f - cos_theta_max);
      acc = acc + (sph_hit ? 1.0f / solid_angle : 0.0f);
      continue;
    }
    const V3 p1 = v3(L[4], L[5], L[6]);
    const V3 p2 = v3(L[7], L[8], L[9]);
    const V3 nrm = v3(L[11], L[12], L[13]);
    float t_pl, denom;
    bool ok;
    if (kind == LIGHT_QUAD) {
      denom = dot(d, nrm);
      t_pl = (L[14] - dot(o, nrm)) / denom;
      const V3 hp = v3(o.x + d.x * t_pl, o.y + d.y * t_pl, o.z + d.z * t_pl);
      const V3 pv = sub(hp, p0);
      const V3 w = v3(L[15], L[16], L[17]);
      const float pu = dot(w, cross(pv, p2));
      const float pvv = dot(w, cross(p1, pv));
      ok = (fabsf(denom) >= hit::kAlmostZero) && (pu >= 0.0f) &&
           (pu <= 1.0f) && (pvv >= 0.0f) && (pvv <= 1.0f) &&
           (t_pl >= hit::kRayTMin && t_pl <= CUDART_INF_F);
    } else {  // triangle: Moller-Trumbore on (v0, e1, e2)
      const V3 pvec = cross(d, p2);
      const float det = dot(p1, pvec);
      const float inv_det = 1.0f / det;
      const V3 tvec = sub(o, p0);
      const V3 qvec = cross(tvec, p1);
      const float bu = dot(tvec, pvec) * inv_det;
      const float bv = dot(d, qvec) * inv_det;
      t_pl = dot(p2, qvec) * inv_det;
      denom = dot(d, nrm);
      ok = (fabsf(det) >= hit::kAlmostZero) && (bu >= 0.0f) &&
           (bu <= 1.0f) && (bv >= 0.0f) && (bu + bv <= 1.0f) &&
           (t_pl >= hit::kRayTMin && t_pl <= CUDART_INF_F);
    }
    if (batched) ok = ok && isfinite(t_pl);
    if (kSkipMisses && !ok) {
      acc = acc + 0.0f;
      continue;
    }
    const float cos_planar = fabsf(denom) / sqrtf(dd);
    acc = acc + (ok ? t_pl * t_pl * dd / (cos_planar * L[18]) : 0.0f);
  }
  return div_scalar(acc, static_cast<float>(sc.n_light));
}

// Direction from o towards a point sampled on light ``pick``
// (intersect.sample_light_direction3)
__device__ __forceinline__ V3 sample_light(const Scene& sc, V3 o, int pick,
                                           float r1, float r2) {
  const float* L = sc.lights + 20 * pick;
  const V3 p0 = v3(L[1], L[2], L[3]);
  if (static_cast<int>(L[0]) == LIGHT_SPHERE) {
    const V3 to_c = sub(p0, o);
    const float dist_sq = dot(to_c, to_c);
    V3 t, b, n;
    onb_from_w(to_c, &t, &b, &n);
    return onb_local(t, b, n, to_sphere(L[10], dist_sq, r1, r2));
  }
  const V3 p1 = v3(L[4], L[5], L[6]);
  const V3 p2 = v3(L[7], L[8], L[9]);
  return sub(add(p0, add(scale(p1, r1), scale(p2, r2))), o);
}

// --- the small tables in shared memory (S1 and FH) --------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned int s =
      static_cast<unsigned int>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

// The block copies ``n`` floats of ``small`` (the packed small tables that
// sc's camera, materials, texture attributes and lights point into,
// ops.step.StepTables.small; n a multiple of 4) into ``staged`` with
// cp.async, ``threads`` threads a block, and points sc at the copies. Every
// thread of the block calls it (a barrier).
__device__ __forceinline__ void stage_small(Scene* sc, const float* small,
                                            int n, float4* staged,
                                            int threads) {
  const float4* src = reinterpret_cast<const float4*>(small);
  for (int k = threadIdx.x; k < n / 4; k += threads)
    cp_async16(staged + k, src + k);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  const float* base = reinterpret_cast<const float*>(staged);
  sc->cam = base + (sc->cam - small);
  sc->mats = base + (sc->mats - small);
  sc->tex_attr = base + (sc->tex_attr - small);
  sc->lights = base + (sc->lights - small);
}

// --- the hit's attributes and material (S1 and FH) --------------------------

// hit kinds (scene/compile.py)
constexpr int KIND_SPHERE = 0, KIND_QUAD = 1, KIND_TRIANGLE = 2,
              KIND_MEDIUM = 3;
// the step's and FH's flag bits (ops/step.py; kFlagBlend, K5's, is 1)
constexpr int kFlagNormalMaps = 2, kFlagSpheres = 4;
constexpr int kSphCols = 8;    // sph_attr's 5 columns, padded
constexpr int kPlnCols = 28;   // pl_attr's 25 columns, padded

// full_hit_attributes' fields but the hit point
struct Attrs {
  V3 normal, tangent, bitangent;
  float u, v;
  bool front;
  int mat;
};

// hit_attributes_soa's planar branch: row ``slot`` of the (P, 28) pl_attr
// table ``pln`` (clamped by the caller; a zero row when the table is empty)
__device__ __forceinline__ Attrs planar_attrs(const float* __restrict__ pln,
                                              int n_pl, V3 point, V3 d,
                                              int slot) {
  float c[kPlnCols];
  if (slot >= 0 && slot < n_pl) {
    const float4* row = reinterpret_cast<const float4*>(pln) +
                        (kPlnCols / 4) * static_cast<size_t>(slot);
    for (int k = 0; k < kPlnCols / 4; ++k) {
      const float4 q = row[k];
      c[4 * k] = q.x; c[4 * k + 1] = q.y; c[4 * k + 2] = q.z; c[4 * k + 3] = q.w;
    }
  } else {
    for (int k = 0; k < kPlnCols; ++k) c[k] = 0.0f;
  }
  Attrs h;
  const V3 n = v3(c[0], c[1], c[2]);
  const float bu = dot(point, v3(c[3], c[4], c[5])) + c[6];
  const float bv = dot(point, v3(c[7], c[8], c[9])) + c[10];
  h.tangent = v3(c[11], c[12], c[13]);
  h.bitangent = v3(c[14], c[15], c[16]);
  h.u = c[17] + bu * c[19] + bv * c[21];
  h.v = c[18] + bu * c[20] + bv * c[22];
  h.front = dot(d, n) < 0.0f;
  h.normal = h.front ? n : neg(n);
  h.mat = static_cast<int>(c[23]);
  return h;
}

// hit_attributes_soa's sphere branch (sphere.rs:84-107): row ``idx`` of the
// (S, 8) sph_attr table ``sph``, clamped
__device__ __forceinline__ Attrs sphere_attrs(const float* __restrict__ sph,
                                              int n_sph, V3 point, V3 d,
                                              int idx) {
  int row = idx < 0 ? 0 : idx;
  row = row > n_sph - 1 ? n_sph - 1 : row;
  float c[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (row >= 0 && row < n_sph) {
    const float* s = sph + kSphCols * static_cast<size_t>(row);
    for (int k = 0; k < 5; ++k) c[k] = s[k];
  }
  Attrs h;
  const V3 n_raw = sub(point, v3(c[0], c[1], c[2]));
  const V3 n_unit = unit(n_raw);
  h.front = dot(d, n_unit) < 0.0f;
  h.normal = h.front ? n_unit : neg(n_unit);
  const float theta = acosf(clamp_max(clamp_min(-n_unit.y, -1.0f), 1.0f));
  const float phi = -atan2f(n_unit.z, n_unit.x) + kPi;
  h.u = div_scalar(phi, kTwoPi);
  h.v = div_scalar(theta, kPi);
  // cross(unit_y, n_raw) = (n_raw.z, 0, -n_raw.x), normalised; the
  // bitangent stays unnormalised (sphere.rs:89-90)
  h.tangent = unit(v3(n_raw.z, 0.0f, -n_raw.x));
  h.bitangent = cross(n_raw, h.tangent);
  h.mat = static_cast<int>(c[4]);
  return h;
}

// resolve_blend: three levels, material_1 where U > blend_factor
__device__ __forceinline__ int blend_walk(const Scene& sc, int mat,
                                          float4 u) {
  const float ul[kMaxBlendDepth] = {u.x, u.y, u.z};
  for (int lvl = 0; lvl < kMaxBlendDepth; ++lvl) {
    const MatRow r = mat_row(sc, mat);
    if (r.kind == BLEND) mat = ul[lvl] > r.blend_factor ? r.m1 : r.m2;
  }
  return mat;
}

// Materials.attr's normal_tex column (a zero row out of range: mat_row)
__device__ __forceinline__ int normal_tex(const Scene& sc, int id) {
  return (id >= 0 && id < sc.n_mat) ? static_cast<int>(sc.mats[9 * id + 2])
                                    : 0;
}

// shading_normal_of: the tangent-space normal map of material ``eff_n``
// (the normal draw's blend walk picks it) through the hit frame; the
// geometric normal where the material has no map
__device__ __forceinline__ V3 normal_mapped(const Scene& sc, const Attrs& h,
                                            int eff_n) {
  const int ntex = normal_tex(sc, eff_n);
  if (ntex < 0) return h.normal;
  const V3 tc = sample_texture(sc, ntex, h.u, h.v);
  const V3 tn = v3(tc.x * 2.0f - 1.0f, tc.y * 2.0f - 1.0f,
                   tc.z * 2.0f - 1.0f);
  return onb_local(h.tangent, h.bitangent, h.normal, tn);
}

// A lane's hit as the scene-hit kernels give it, from its values: (kind,
// idx) and the planar attribute row it names, clamped to the table. Without
// a kind (has_kind false, a BVH scene without spheres or media), idx_in is
// K1's planar slot, mapped to its row through the (P,) ``pl_row`` in one
// gather.
__device__ __forceinline__ void decode_hit_values(
    bool has_kind, int kind_in, int idx_in, const int* __restrict__ pl_row,
    int n_q, int n_pl, int* kind, int* idx, int* slot) {
  if (has_kind) {
    *kind = kind_in;
    *idx = idx_in;
    int s = *kind == KIND_TRIANGLE ? n_q + *idx : *idx;
    s = s < 0 ? 0 : s;
    *slot = s > n_pl - 1 ? n_pl - 1 : s;
  } else {
    int ps = idx_in;
    ps = ps < 0 ? 0 : ps;
    ps = ps > n_pl - 1 ? n_pl - 1 : ps;
    *kind = KIND_QUAD;   // planar: quad or triangle, the row says which
    *idx = 0;
    *slot = pl_row[ps];
  }
}

// decode_hit_values of lane i of the scene-hit kernels' arrays (kind_in
// null: idx_in holds K1's planar slot)
__device__ __forceinline__ void decode_hit(const int* kind_in,
                                           const int* idx_in,
                                           const int* __restrict__ pl_row,
                                           int n_q, int n_pl, long long i,
                                           int* kind, int* idx, int* slot) {
  decode_hit_values(kind_in != nullptr, kind_in != nullptr ? kind_in[i] : 0,
                    idx_in[i], pl_row, n_q, n_pl, kind, idx, slot);
}

// full_hit_attributes of one lane at ``point``: on a medium hit the
// medium's overrides (constant_medium.rs:63-74: a random phase normal on
// P_PHASE, unit tangents, zero uv, a back face, the medium's phase material
// from ``med_mat``), else the sphere row of ``sph`` or the planar row of
// ``pln``
__device__ __forceinline__ Attrs hit_attrs(
    int flags, const float* __restrict__ sph, int n_sph,
    const float* __restrict__ pln, int n_pl,
    const int* __restrict__ med_mat, int n_media, int kind, int idx,
    int slot, V3 point, V3 d, uint32_t pix, uint32_t smp, uint32_t bnc,
    uint32_t seed) {
  Attrs h;
  if (n_media > 0 && kind == KIND_MEDIUM) {
    const float4 pr = uniform4(pix, smp, bnc, P_PHASE, seed);
    h.normal = unit_vector(pr.x, pr.y);
    h.tangent = h.bitangent = v3(1.0f, 1.0f, 1.0f);
    h.u = h.v = 0.0f;
    h.front = false;
    int m = idx < 0 ? 0 : idx;
    m = m > n_media - 1 ? n_media - 1 : m;
    h.mat = med_mat[m];
  } else if ((flags & kFlagSpheres) && kind == KIND_SPHERE) {
    h = sphere_attrs(sph, n_sph, point, d, idx);
  } else {
    h = planar_attrs(pln, n_pl, point, d, slot);
  }
  return h;
}

// --- sums over a warp's lanes (S1B and FHB) ---------------------------------

// v (K values) summed over each group of a warp's lanes that share
// ``peers`` (__match_any_sync's mask), into the group's lowest lane, in
// ceil(log2) of the largest group's size steps (a tree over the ranks
// within the group; the other lanes end with partial sums). Every lane of
// the warp calls it. At each step a lane still in play adds the value of
// the next lane of its group still in play, and the lanes of odd rank
// among those leave.
template <int K>
__device__ __forceinline__ void peer_sums(unsigned peers, float (&v)[K]) {
  const unsigned lane = threadIdx.x % 32;
  unsigned rank = __popc(peers & ((1u << lane) - 1u));
  unsigned above = peers & ~((2u << lane) - 1u);  // lane 31: 2u << 31 = 0
  while (__any_sync(0xffffffffu, above != 0u)) {
    const int next = __ffs(above) - 1;
    const int src = next < 0 ? static_cast<int>(lane) : next;
    for (int c = 0; c < K; ++c) {
      const float t = __shfl_sync(0xffffffffu, v[c], src);
      if (next >= 0) v[c] += t;
    }
    above &= __ballot_sync(0xffffffffu, (rank & 1u) == 0u);
    rank >>= 1;
  }
}

// integrator.camera_rays_plain for one pixel and sample (the pixel id an
// int, or CR's int64; the draws take its low 32 bits)
template <typename Pixel>
__device__ __forceinline__ void camera_ray(const Scene& sc, Pixel pixel,
                                           int sample, uint32_t seed,
                                           int width, int height, V3* o,
                                           V3* d) {
  const float* c = sc.cam;
  const float x = static_cast<float>(pixel % width);
  const float y = static_cast<float>(pixel / width);
  const uint32_t pix = static_cast<uint32_t>(pixel);
  const float4 j = uniform4(pix, sample, 0, P_JITTER, seed);
  const float u = div_scalar(x + j.x, static_cast<float>(width - 1));
  const float v = div_scalar(y + j.y, static_cast<float>(height - 1));
  const float4 l = uniform4(pix, sample, 0, P_LENS, seed);
  const float r = sqrtf(l.x);
  const float phi = kTwoPi * l.y;
  const float lr = c[18];
  const float rd0 = r * cosf(phi) * lr;
  const float rd1 = r * sinf(phi) * lr;
  const bool use_lens = lr > 0.0f;
  float oo[3], dd[3];
  for (int k = 0; k < 3; ++k) {
    const float off = use_lens ? c[12 + k] * rd0 + c[15 + k] * rd1 : 0.0f;
    oo[k] = c[k] + off;
    dd[k] = c[3 + k] + c[6 + k] * u + c[9 + k] * v - c[k] - off;
  }
  *o = v3(oo[0], oo[1], oo[2]);
  *d = v3(dd[0], dd[1], dd[2]);
}

}  // namespace shade
