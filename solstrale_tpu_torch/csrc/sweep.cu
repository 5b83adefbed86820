// Brute-force closest-hit sweep (K2), constant-medium event (K3) and the
// fused scene hit (K4).
//
// Replace the TPU kernels solstrale_tpu/ops/pallas_sweep.py::_sweep_kernel
// (closest_hit_pallas), ::_medium_kernel (medium_hit_pallas) and
// ::_scene_hit_kernel (scene_hit_pallas). Same formulas as the TPU kernels
// (hit.cuh), so that with -fmad=false the results equal the plain PyTorch
// versions (ops/sweep.py) bit for bit on a given device.
//
// One thread per ray; a block of 256 rays stages tiles of the prim tables
// through shared memory, so each table row is read from device memory once
// per block rather than once per ray. On the scenes that take these
// kernels the work per ray is small (K2 sweeps the BVH scene's few spheres,
// K4 ~150 rows), so a launch lost most of its time to what surrounded it:
// the launches of the glue around the kernel. The kernels themselves are
// bound by arithmetic: ~30 f32 operations and one IEEE division per ray-prim
// pair against 16 bytes of shared-memory traffic (the tables stay in L2).
// The design answers both, without changing a value:
//
// - K2 in its BVH mode (k2_bvh_spheres, the one mode a route launches)
//   takes K1's planar (t, slot) and does bvh_closest_hit_pallas's
//   min-combine and decode itself (pallas_bvh.py:613-628): sphere_wins = t_s
//   <= t_p, idx = max(slot_s, 0) for a sphere, the planar slot clipped and
//   decoded by pl_is_tri and pl_idx. Its bounds are scalar arguments. The
//   wrapper allocates the three outputs and launches once: no fills, no
//   combine ops. The sphere table is staged whole into shared memory once
//   per block (in tiles only beyond kSphTileRows spheres).
// - K4 (k4_scene_hit) draws each medium's free-flight uniform in-kernel
//   (hit::uniform4 with purpose kMediumPurposeBase + m from the lane's
//   counters, each taken as its low 32 bits), culls a medium for a ray that
//   cannot reach the medium's padded box (hit::box_reach, as K5 does: a
//   culled medium's event is INF, which its sweeps would also give, and a
//   culled ray reads no counter and draws nothing), and decodes its slot
//   into (t, kind, idx) as scene_hit_fused does (pallas_sweep.py:563-575).
//   So integrator.scene_hit is this one launch: no RNG, stack or decode ops.
// - On a sweep whose lower bound is positive (the solid sweeps), a planar
//   row whose numerator and denominator differ in sign skips its IEEE
//   division and the rest of its test (hit::planar_ahead): its t could not
//   pass the bound (11% of K4's time on the kitchen, PERF.md).
// Measured on the card and left out as gaining nothing (PERF.md):
// staging K4's whole tables at once with bulk copies on an mbarrier (6%
// slower than these tiles), and testing a planar row's t before its hit
// point and functionals.
#include "hit.cuh"

namespace {

using hit::Ray;

constexpr int kThreads = 256;
constexpr int kTileRows = 256;       // prim rows staged per tile
constexpr int kSphTileRows = 1024;   // K2's BVH mode: spheres staged at once
// scene/compile.py's KIND_*; integrator's per-medium draw purposes
constexpr int KIND_SPHERE = 0, KIND_QUAD = 1, KIND_TRIANGLE = 2,
              KIND_MEDIUM = 3;
constexpr uint32_t kMediumPurposeBase = 16;   // rng.P_MEDIUM_BASE

__device__ __forceinline__ Ray load_ray(const float* ox, const float* oy,
                                        const float* oz, const float* dx,
                                        const float* dy, const float* dz,
                                        int i) {
  return hit::make_ray(ox[i], oy[i], oz[i], dx[i], dy[i], dz[i]);
}

// Stage rows [base, base+count) of a (rows, 4*width) float4 table.
__device__ __forceinline__ void stage(float4* tile, const float4* table,
                                      int base, int count, int width) {
  for (int k = threadIdx.x; k < count * width; k += blockDim.x)
    tile[k] = table[base * width + k];
}

// Closest hit of one ray over both tables with the TPU kernel's strict
// '<' (the first, smallest slot wins ties). lo/hi bound t. Every thread of
// the block calls it (it synchronises); ``live`` masks the ray's own tests.
template <bool kWithSlot>
__device__ __forceinline__ void sweep_tables(const Ray& r, bool live,
                                             float4* tile,
                                             const float4* sph, int n_sph,
                                             const float4* pln, int n_pl,
                                             float lo, float hi, bool hi_on_sphere,
                                             float* best_t, int* best_slot) {
  float best = CUDART_INF_F;
  int slot = -1;
  for (int base = 0; base < n_sph; base += kTileRows) {
    const int count = min(kTileRows, n_sph - base);
    __syncthreads();
    stage(tile, sph, base, count, 2);
    __syncthreads();
    if (live) {
      for (int p = 0; p < count; ++p) {
        float r1, r2;
        const bool ok = hit::sphere_roots(r, tile[2 * p], tile[2 * p + 1],
                                          &r1, &r2);
        const bool in1 = r1 >= lo && (!hi_on_sphere || r1 <= hi);
        const bool in2 = r2 >= lo && (!hi_on_sphere || r2 <= hi);
        const float t = (ok && in1) ? r1 : ((ok && in2) ? r2 : CUDART_INF_F);
        if (t < best) {
          best = t;
          if (kWithSlot) slot = base + p;
        }
      }
    }
  }
  for (int base = 0; base < n_pl; base += kTileRows) {
    const int count = min(kTileRows, n_pl - base);
    __syncthreads();
    stage(tile, pln, base, count, 4);
    __syncthreads();
    if (live) {
      for (int p = 0; p < count; ++p) {
        float num, denom;
        hit::planar_nd(r, tile[4 * p], &num, &denom);
        if (lo > 0.f && !hit::planar_ahead(num, denom)) continue;
        const float t = num / denom;
        if (hit::planar_inside(r, tile[4 * p + 1], tile[4 * p + 2],
                               tile[4 * p + 3], t, denom) &&
            t >= lo && t <= hi && t < best) {
          best = t;
          if (kWithSlot) slot = n_sph + base + p;
        }
      }
    }
  }
  *best_t = best;
  *best_slot = slot;
}

// One medium's event for a ray against its boundary tables: entry = the
// closest boundary hit on (-inf, inf), exit = the closest past entry + 1e-4
// (sphere roots take no upper bound, as in the TPU kernel).
__device__ __forceinline__ float medium_sweep(const Ray& r, bool live,
                                              float4* tile, const float4* sph,
                                              int n_sph, const float4* pln,
                                              int n_pl, float ts, float u,
                                              float neg_inv_density) {
  float t1, t2;
  int unused;
  sweep_tables<false>(r, live, tile, sph, n_sph, pln, n_pl, -CUDART_INF_F,
                      CUDART_INF_F, false, &t1, &unused);
  sweep_tables<false>(r, live, tile, sph, n_sph, pln, n_pl, t1 + 1e-4f,
                      CUDART_INF_F, false, &t2, &unused);
  return hit::medium_event(r, t1, t2, ts, u, neg_inv_density);
}

__global__ void k2_sweep(const float* ox, const float* oy, const float* oz,
                         const float* dx, const float* dy, const float* dz,
                         const float* tmin, const float* tmax,
                         const float4* sph, int n_sph, const float4* pln,
                         int n_pl, int n_rays, float* out_t, int* out_slot) {
  __shared__ float4 tile[kTileRows * 4];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n_rays;  // no early return: every thread stages
  Ray r = {};
  float lo = 0.f, hi = 0.f;
  if (live) {
    r = load_ray(ox, oy, oz, dx, dy, dz, i);
    lo = tmin[i];
    hi = tmax[i];
  }
  float best;
  int slot;
  sweep_tables<true>(r, live, tile, sph, n_sph, pln, n_pl, lo, hi, true,
                     &best, &slot);
  if (live) {
    out_t[i] = best;
    out_slot[i] = slot;
  }
}

// K2 in its BVH mode: the spheres-only sweep on [lo, hi], min-combined with
// K1's planar hit (t_p, pslot) and decoded to (t, kind, idx).
__global__ void k2_bvh_spheres(const float* ox, const float* oy,
                               const float* oz, const float* dx,
                               const float* dy, const float* dz, float lo,
                               float hi, const float4* sph, int n_sph,
                               const float* t_p, const int* pslot,
                               const int* pl_idx,
                               const unsigned char* pl_is_tri, int n_pl,
                               int n_rays, float* out_t, int* out_kind,
                               int* out_idx) {
  extern __shared__ __align__(16) float4 spheres[];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n_rays;  // no early return: every thread stages
  Ray r = {};
  if (live) r = load_ray(ox, oy, oz, dx, dy, dz, i);
  float best = CUDART_INF_F;
  int slot = -1;
  for (int base = 0; base < n_sph; base += kSphTileRows) {
    const int count = min(kSphTileRows, n_sph - base);
    if (base > 0) __syncthreads();
    stage(spheres, sph, base, count, 2);
    __syncthreads();
    if (!live) continue;
    for (int p = 0; p < count; ++p) {
      float r1, r2;
      const bool ok = hit::sphere_roots(r, spheres[2 * p],
                                        spheres[2 * p + 1], &r1, &r2);
      const bool in1 = r1 >= lo && r1 <= hi;
      const bool in2 = r2 >= lo && r2 <= hi;
      const float t = (ok && in1) ? r1 : ((ok && in2) ? r2 : CUDART_INF_F);
      if (t < best) {
        best = t;
        slot = base + p;
      }
    }
  }
  if (!live) return;
  const float tp = t_p[i];
  if (best <= tp) {   // the sphere wins ties, and a miss of both
    out_t[i] = best;
    out_kind[i] = KIND_SPHERE;
    out_idx[i] = slot < 0 ? 0 : slot;
  } else {
    const int ps = min(max(pslot[i], 0), n_pl - 1);
    out_t[i] = tp;
    out_kind[i] = pl_is_tri[ps] ? KIND_TRIANGLE : KIND_QUAD;
    out_idx[i] = pl_idx[ps];
  }
}

// K3: one medium's event per ray, clipped to the ray's solid hit t_solid.
__global__ void k3_medium(const float* ox, const float* oy, const float* oz,
                          const float* dx, const float* dy, const float* dz,
                          const float* t_solid, const float* u_flight,
                          const float4* sph, int n_sph, const float4* pln,
                          int n_pl, const float* neg_inv_density, int n_rays,
                          float* out_t) {
  __shared__ float4 tile[kTileRows * 4];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n_rays;
  Ray r = {};
  float ts = 0.f, u = 0.f;
  if (live) {
    r = load_ray(ox, oy, oz, dx, dy, dz, i);
    ts = t_solid[i];
    ts = isfinite(ts) ? ts : CUDART_INF_F;
    u = u_flight[i];
  }
  const float t = medium_sweep(r, live, tile, sph, n_sph, pln, n_pl, ts, u,
                               neg_inv_density[0]);
  if (live) out_t[i] = t;
}

// A lane counter (pixel, sample or bounce): an (R,) int32 (size 4) or
// int64 (size 8) array; taken as its low 32 bits, as rng._u32 does.
struct Counter {
  const void* p;
  int size;

  __device__ __forceinline__ uint32_t at(int i) const {
    if (size == 8) return static_cast<uint32_t>(
        static_cast<const long long*>(p)[i]);
    return static_cast<uint32_t>(static_cast<const int*>(p)[i]);
  }
};

// K4's scene: the solid tables, and every medium's boundary packed into one
// sphere and one planar table (medium m owns rows [sph_off[m],
// sph_off[m+1]) and [pl_off[m], pl_off[m+1])), its neg_inv_density and its
// padded box (lo xyz 0 hi xyz 0).
struct Scene {
  const float4* sph;
  int n_sph;
  const float4* pln;
  int n_pl;
  const int* pl_idx;
  const float4* msph;
  const float4* mpln;
  const int* sph_off;
  const int* pl_off;
  const float* nid;
  const float4* box;
  int n_media;
};

// K4: the solid sweep on [RAY_T_MIN, inf), then every medium in order, each
// clipped to the best t so far (pallas_sweep.py:459-482).
__global__ void k4_scene_hit(const float* ox, const float* oy, const float* oz,
                             const float* dx, const float* dy, const float* dz,
                             Counter pix, Counter sample, Counter bounce,
                             uint32_t seed, Scene sc, int n_rays,
                             float* out_t, int* out_kind, int* out_idx) {
  __shared__ float4 tile[kTileRows * 4];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n_rays;  // no early return: every thread stages
  Ray r = {};
  if (live) r = load_ray(ox, oy, oz, dx, dy, dz, i);
  float best;
  int slot;
  sweep_tables<true>(r, live, tile, sc.sph, sc.n_sph, sc.pln, sc.n_pl,
                     hit::kRayTMin, CUDART_INF_F, true, &best, &slot);
  int medium = -1;
  const float inv0 = 1.f / r.d0, inv1 = 1.f / r.d1, inv2 = 1.f / r.d2;
  for (int m = 0; m < sc.n_media; ++m) {
    const int s0 = sc.sph_off[m], ns = sc.sph_off[m + 1] - s0;
    const int p0 = sc.pl_off[m], np = sc.pl_off[m + 1] - p0;
    // a ray that cannot reach the box before best has the event INF
    const bool reach = live && hit::box_reach(r, inv0, inv1, inv2,
                                              sc.box[2 * m],
                                              sc.box[2 * m + 1], best);
    float t1, t2;
    int unused;
    sweep_tables<false>(r, reach, tile, sc.msph + 2 * s0, ns,
                        sc.mpln + 4 * p0, np, -CUDART_INF_F, CUDART_INF_F,
                        false, &t1, &unused);
    sweep_tables<false>(r, reach, tile, sc.msph + 2 * s0, ns,
                        sc.mpln + 4 * p0, np, t1 + 1e-4f, CUDART_INF_F, false,
                        &t2, &unused);
    if (!reach) continue;
    const float u = hit::uniform4(pix.at(i), sample.at(i), bounce.at(i),
                                  kMediumPurposeBase + m, seed).x;
    const float t_m = hit::medium_event(r, t1, t2, best, u, sc.nid[m]);
    if (t_m < best) {
      best = t_m;
      medium = m;
    }
  }
  if (!live) return;
  int kind, idx;
  if (medium >= 0) {
    kind = KIND_MEDIUM;
    idx = medium;
  } else if (slot < sc.n_sph) {   // a sphere, or a miss (slot -1)
    kind = KIND_SPHERE;
    idx = slot < 0 ? 0 : slot;
  } else {   // the planar row's is_tri column and pl_idx
    const int ps = slot - sc.n_sph;
    kind = sc.pln[4 * ps + 3].x > 0.5f ? KIND_TRIANGLE : KIND_QUAD;
    idx = sc.pl_idx[ps];
  }
  out_t[i] = best;
  out_kind[i] = kind;
  out_idx[i] = idx;
}

inline int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

extern "C" int k2_sweep_launch(const float* ox, const float* oy,
                               const float* oz, const float* dx,
                               const float* dy, const float* dz,
                               const float* tmin, const float* tmax,
                               const float* sph, int n_sph, const float* pln,
                               int n_pl, int n_rays, float* out_t,
                               int* out_slot, void* stream) {
  if (n_rays > 0) {
    k2_sweep<<<blocks_for(n_rays), kThreads, 0,
               static_cast<cudaStream_t>(stream)>>>(
        ox, oy, oz, dx, dy, dz, tmin, tmax,
        reinterpret_cast<const float4*>(sph), n_sph,
        reinterpret_cast<const float4*>(pln), n_pl, n_rays, out_t, out_slot);
  }
  return static_cast<int>(cudaGetLastError());
}

// n_pl >= 1: the planar table K1 walked (pl_idx, pl_is_tri (bool bytes)).
extern "C" int k2_bvh_spheres_launch(
    const float* ox, const float* oy, const float* oz, const float* dx,
    const float* dy, const float* dz, float tmin, float tmax,
    const float* sph, int n_sph, const float* t_p, const int* pslot,
    const int* pl_idx, const unsigned char* pl_is_tri, int n_pl, int n_rays,
    float* out_t, int* out_kind, int* out_idx, void* stream) {
  if (n_rays > 0) {
    const int smem = (n_sph < kSphTileRows ? n_sph : kSphTileRows) * 32;
    k2_bvh_spheres<<<blocks_for(n_rays), kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
        ox, oy, oz, dx, dy, dz, tmin, tmax,
        reinterpret_cast<const float4*>(sph), n_sph, t_p, pslot, pl_idx,
        pl_is_tri, n_pl, n_rays, out_t, out_kind, out_idx);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int k3_medium_launch(const float* ox, const float* oy,
                                const float* oz, const float* dx,
                                const float* dy, const float* dz,
                                const float* t_solid, const float* u_flight,
                                const float* sph, int n_sph, const float* pln,
                                int n_pl, const float* neg_inv_density,
                                int n_rays, float* out_t, void* stream) {
  if (n_rays > 0) {
    k3_medium<<<blocks_for(n_rays), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
        ox, oy, oz, dx, dy, dz, t_solid, u_flight,
        reinterpret_cast<const float4*>(sph), n_sph,
        reinterpret_cast<const float4*>(pln), n_pl, neg_inv_density, n_rays,
        out_t);
  }
  return static_cast<int>(cudaGetLastError());
}

// Counters: (pointer, element size 4 or 8).
extern "C" int k4_scene_hit_launch(
    const float* ox, const float* oy, const float* oz, const float* dx,
    const float* dy, const float* dz, const void* pix, int pix_size,
    const void* sample, int sample_size, const void* bounce, int bounce_size,
    unsigned int seed, const float* sph, int n_sph,
    const float* pln, int n_pl, const int* pl_idx, const float* msph,
    const float* mpln, const int* sph_off, const int* pl_off,
    const float* nid, const float* box, int n_media, int n_rays,
    float* out_t, int* out_kind, int* out_idx, void* stream) {
  if (n_rays > 0) {
    const Scene sc{reinterpret_cast<const float4*>(sph), n_sph,
                   reinterpret_cast<const float4*>(pln), n_pl, pl_idx,
                   reinterpret_cast<const float4*>(msph),
                   reinterpret_cast<const float4*>(mpln), sph_off, pl_off,
                   nid, reinterpret_cast<const float4*>(box), n_media};
    k4_scene_hit<<<blocks_for(n_rays), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
        ox, oy, oz, dx, dy, dz, Counter{pix, pix_size},
        Counter{sample, sample_size}, Counter{bounce, bounce_size}, seed, sc,
        n_rays, out_t, out_kind, out_idx);
  }
  return static_cast<int>(cudaGetLastError());
}
