// The BVH route's sphere sweep (K2), every medium's event on the BVH route
// (K3) and the fused scene hit (K4).
//
// Replace the TPU kernels solstrale_tpu/ops/pallas_sweep.py::_sweep_kernel
// (closest_hit_pallas), ::_medium_kernel (medium_hit_pallas) and
// ::_scene_hit_kernel (scene_hit_pallas). Same formulas as the TPU kernels
// (hit.cuh), so that with -fmad=false the results equal the plain PyTorch
// versions (ops/sweep.py) bit for bit on a given device.
//
// One thread per ray. On the scenes that take these kernels the work per
// ray is small (K2 sweeps the BVH scene's few spheres, K3 a medium's few
// boundary rows, K4 ~150 rows), so a launch lost most of its time to what
// surrounded it: the launches of the glue around the kernel. The kernels
// themselves are bound by arithmetic: ~30 f32 operations and one IEEE
// division per ray-prim pair against 16 bytes of shared-memory traffic
// (the tables stay in L2). The design answers both, without changing a
// value:
//
// - K2 (k2_bvh_spheres) takes K1's planar (t, slot) and does
//   bvh_closest_hit_pallas's min-combine and decode itself
//   (pallas_bvh.py:613-628): sphere_wins = t_s <= t_p, idx = max(slot_s, 0)
//   for a sphere, the planar slot clipped and decoded by pl_is_tri and
//   pl_idx. Its bounds are scalar arguments. The wrapper allocates the
//   three outputs and launches once: no fills, no combine ops. The sphere
//   table is staged whole into shared memory once per block (in tiles only
//   beyond kSphTileRows spheres).
// - K3 (k3_media) takes K2's (t, kind, idx) and runs every medium of the
//   scene in order in one launch (integrator.py:153-165 of the JAX
//   package): the media's boundary rows are staged into shared memory once
//   per block (read from device memory, unstaged, beyond kMediaSmemBytes),
//   so the media loop has no barrier; a ray that cannot reach a medium's
//   padded box skips it; the flight uniform is drawn in-kernel; a medium
//   wins by a strict '<' and sets (t, KIND_MEDIUM, m). So the media part
//   of a BVH scene's hit is this one launch: no RNG, compare or where ops.
// - K4 (k4_scene_hit) runs the solid sweep in shared-memory tiles, then the
//   same media loop as K3 (media_events) on once-staged boundary rows, and
//   decodes its slot into (t, kind, idx) as scene_hit_fused does
//   (pallas_sweep.py:563-575). So integrator.scene_hit is this one launch.
// - The media loop draws each medium's free-flight uniform in-kernel
//   (hit::uniform4 with purpose kMediumPurposeBase + m from the lane's
//   counters, each taken as its low 32 bits) and culls a medium for a ray
//   that cannot reach the medium's padded box (hit::box_reach, as K5 does:
//   a culled medium's event is INF, which its sweeps would also give, and a
//   culled ray reads no counter and draws nothing).
// - On a sweep whose lower bound is positive (the solid sweeps, a medium's
//   exit sweep), a planar row whose numerator and denominator differ in
//   sign skips its IEEE division and the rest of its test
//   (hit::planar_ahead): its t could not pass the bound (11% of K4's time
//   on the kitchen, PERF.md).
// - A parked lane (zero direction: trace parks a lane whose path ended)
//   skips its tests and writes what they would give (parked()), as K1
//   does, and a block of parked lanes stages nothing: the fixed trip's
//   bounces past a path's end cost a launch and the rays' loads.
// Measured on the card and left out as gaining nothing (PERF.md):
// staging K4's whole solid tables at once with bulk copies on an mbarrier
// (6% slower than these tiles), and testing a planar row's t before its hit
// point and functionals.
#include "hit.cuh"

namespace {

using hit::Counter;
using hit::Ray;

constexpr int kThreads = 256;
constexpr int kTileRows = 256;       // K4's solid rows staged per tile
constexpr int kSphTileRows = 1024;   // K2: spheres staged at once
// K3 and K4 stage the media's boundary rows whole into dynamic shared
// memory up to this size (512 planar rows; with K4's 16 KB of tiles a block
// stays within the 48 KB it may use without opting in); beyond it they
// read the rows from device memory.
constexpr int kMediaSmemBytes = 32 * 1024;
// scene/compile.py's KIND_*; integrator's per-medium draw purposes
constexpr int KIND_SPHERE = 0, KIND_QUAD = 1, KIND_TRIANGLE = 2,
              KIND_MEDIUM = 3;
constexpr uint32_t kMediumPurposeBase = 16;   // rng.P_MEDIUM_BASE

// Whether a lane is parked (zero direction). Such a ray hits nothing: each
// sphere's roots are 0 / 0 = NaN, each planar row has d.n = 0 <
// ALMOST_ZERO, so each medium's entry is INF and its event INF too. Its
// hit is thus (INF, KIND_SPHERE, 0) from the sweeps, the input's from K3.
__device__ __forceinline__ bool parked(const Ray& r) {
  return r.d0 == 0.f && r.d1 == 0.f && r.d2 == 0.f;
}

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

// Fold sphere rows [0, count) into the running (best, slot) with the TPU
// kernel's strict '<' (the first, smallest slot wins ties); row p is slot
// slot0 + p. A root counts on [lo, hi], or on [lo, inf) unless
// ``hi_on_sphere``.
template <bool kWithSlot>
__device__ __forceinline__ void sphere_rows(const Ray& r, const float4* rows,
                                            int count, int slot0, float lo,
                                            float hi, bool hi_on_sphere,
                                            float* best, int* slot) {
  for (int p = 0; p < count; ++p) {
    float r1, r2;
    const bool ok = hit::sphere_roots(r, rows[2 * p], rows[2 * p + 1], &r1,
                                      &r2);
    const bool in1 = r1 >= lo && (!hi_on_sphere || r1 <= hi);
    const bool in2 = r2 >= lo && (!hi_on_sphere || r2 <= hi);
    const float t = (ok && in1) ? r1 : ((ok && in2) ? r2 : CUDART_INF_F);
    if (t < *best) {
      *best = t;
      if (kWithSlot) *slot = slot0 + p;
    }
  }
}

// The same for planar rows on [lo, hi]; with lo > 0 a row whose t cannot be
// positive skips its division (hit::planar_ahead).
template <bool kWithSlot>
__device__ __forceinline__ void planar_rows(const Ray& r, const float4* rows,
                                            int count, int slot0, float lo,
                                            float hi, float* best,
                                            int* slot) {
  for (int p = 0; p < count; ++p) {
    float num, denom;
    hit::planar_nd(r, rows[4 * p], &num, &denom);
    if (lo > 0.f && !hit::planar_ahead(num, denom)) continue;
    const float t = num / denom;
    if (hit::planar_inside(r, rows[4 * p + 1], rows[4 * p + 2],
                           rows[4 * p + 3], t, denom) &&
        t >= lo && t <= hi && t < *best) {
      *best = t;
      if (kWithSlot) *slot = slot0 + p;
    }
  }
}

// Closest hit of one ray over both tables on [lo, hi], staged tile by tile
// through shared memory. Every thread of the block calls it (it
// synchronises); ``live`` masks the ray's own tests.
__device__ __forceinline__ void sweep_tables(const Ray& r, bool live,
                                             float4* tile,
                                             const float4* sph, int n_sph,
                                             const float4* pln, int n_pl,
                                             float lo, float hi,
                                             float* best_t, int* best_slot) {
  float best = CUDART_INF_F;
  int slot = -1;
  for (int base = 0; base < n_sph; base += kTileRows) {
    const int count = min(kTileRows, n_sph - base);
    __syncthreads();
    stage(tile, sph, base, count, 2);
    __syncthreads();
    if (live)
      sphere_rows<true>(r, tile, count, base, lo, hi, true, &best, &slot);
  }
  for (int base = 0; base < n_pl; base += kTileRows) {
    const int count = min(kTileRows, n_pl - base);
    __syncthreads();
    stage(tile, pln, base, count, 4);
    __syncthreads();
    if (live)
      planar_rows<true>(r, tile, count, n_sph + base, lo, hi, &best, &slot);
  }
  *best_t = best;
  *best_slot = slot;
}

// The lanes' counters and the seed: medium m's flight uniform for lane i
// is rng.uniform(pixel, sample, bounce, P_MEDIUM_BASE + m, seed).
struct Draw {
  Counter pix, sample, bounce;
  uint32_t seed;

  __device__ __forceinline__ float flight(int i, int m) const {
    return hit::uniform4(pix.at(i), sample.at(i), bounce.at(i),
                         kMediumPurposeBase + m, seed).x;
  }
};

// Every medium's boundary packed into one sphere and one planar table
// (ops/sweep.py::MediaTables): medium m owns rows [sph_off[m],
// sph_off[m+1]) and [pl_off[m], pl_off[m+1]), its neg_inv_density and its
// padded box (lo xyz 0 hi xyz 0).
struct Media {
  const float4* sph;
  int n_sph;
  const float4* pln;
  int n_pl;
  const int* sph_off;
  const int* pl_off;
  const float* nid;
  const float4* box;
  int n_media;
};

// Bytes of dynamic shared memory the media's rows take when staged: 0 (not
// staged) beyond kMediaSmemBytes.
__host__ __device__ __forceinline__ int media_smem_bytes(int n_sph,
                                                         int n_pl) {
  const int bytes = n_sph * 32 + n_pl * 64;
  return bytes <= kMediaSmemBytes ? bytes : 0;
}

// The media with their rows staged into ``rows`` (dynamic shared memory of
// media_smem_bytes) when they fit; the caller synchronises before use.
__device__ __forceinline__ Media stage_media(Media md, float4* rows) {
  if (media_smem_bytes(md.n_sph, md.n_pl) == 0) return md;
  stage(rows, md.sph, 0, md.n_sph, 2);
  stage(rows + 2 * md.n_sph, md.pln, 0, md.n_pl, 4);
  md.sph = rows;
  md.pln = rows + 2 * md.n_sph;
  return md;
}

// Closest boundary t >= lo of one medium (no upper bound; sphere roots take
// none either, as in the TPU kernel), one thread alone: no barrier.
__device__ __forceinline__ float boundary_t(const Ray& r, const float4* sph,
                                            int n_sph, const float4* pln,
                                            int n_pl, float lo) {
  float best = CUDART_INF_F;
  int unused;
  sphere_rows<false>(r, sph, n_sph, 0, lo, CUDART_INF_F, false, &best,
                     &unused);
  planar_rows<false>(r, pln, n_pl, 0, lo, CUDART_INF_F, &best, &unused);
  return best;
}

// Every medium in order against the ray's best t so far (*best; a
// non-finite t clips as INF), each clipped to the best t before it
// (pallas_sweep.py:459-482): a ray that cannot reach medium m's padded box
// skips it; else the entry t1 = the closest boundary hit on (-inf, inf),
// the exit t2 = the closest past t1 + 1e-4, the flight uniform and the
// event, which replaces the best by a strict '<'. Returns the last medium
// that did, -1 if none.
__device__ __forceinline__ int media_events(const Ray& r, const Media& md,
                                            const Draw& draw, int i,
                                            float* best) {
  int medium = -1;
  const float inv0 = 1.f / r.d0, inv1 = 1.f / r.d1, inv2 = 1.f / r.d2;
  for (int m = 0; m < md.n_media; ++m) {
    const float ts = isfinite(*best) ? *best : CUDART_INF_F;
    if (!hit::box_reach(r, inv0, inv1, inv2, md.box[2 * m],
                        md.box[2 * m + 1], ts))
      continue;
    const int s0 = md.sph_off[m], ns = md.sph_off[m + 1] - s0;
    const int p0 = md.pl_off[m], np = md.pl_off[m + 1] - p0;
    const float4* sph = md.sph + 2 * s0;
    const float4* pln = md.pln + 4 * p0;
    const float t1 = boundary_t(r, sph, ns, pln, np, -CUDART_INF_F);
    const float t2 = boundary_t(r, sph, ns, pln, np, t1 + 1e-4f);
    const float t_m = hit::medium_event(r, t1, t2, ts, draw.flight(i, m),
                                        md.nid[m]);
    if (t_m < *best) {
      *best = t_m;
      medium = m;
    }
  }
  return medium;
}

// K2: the spheres-only sweep on [lo, hi], min-combined with K1's planar hit
// (t_p, pslot) and decoded to (t, kind, idx).
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
  const bool test = live && !parked(r);
  float best = CUDART_INF_F;
  int slot = -1;
  const int n_stage = __syncthreads_or(test) ? n_sph : 0;
  for (int base = 0; base < n_stage; base += kSphTileRows) {
    const int count = min(kSphTileRows, n_sph - base);
    if (base > 0) __syncthreads();
    stage(spheres, sph, base, count, 2);
    __syncthreads();
    if (test)
      sphere_rows<true>(r, spheres, count, base, lo, hi, true, &best, &slot);
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

// K3: every medium's event on top of the solid hit (t, kind, idx); a medium
// that wins sets kind KIND_MEDIUM and idx its index.
__global__ void k3_media(const float* ox, const float* oy, const float* oz,
                         const float* dx, const float* dy, const float* dz,
                         Draw draw, Media md, const float* t_in,
                         const int* kind_in, const int* idx_in, int n_rays,
                         float* out_t, int* out_kind, int* out_idx) {
  extern __shared__ __align__(16) float4 media_rows[];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n_rays;  // no early return: every thread stages
  Ray r = {};
  if (live) r = load_ray(ox, oy, oz, dx, dy, dz, i);
  const bool test = live && !parked(r);
  const bool stages = __syncthreads_or(test);   // block-uniform
  const Media smd = stages ? stage_media(md, media_rows) : md;
  if (stages) __syncthreads();
  if (!live) return;
  float best = t_in[i];
  const int medium = test ? media_events(r, smd, draw, i, &best) : -1;
  out_t[i] = best;
  out_kind[i] = medium >= 0 ? KIND_MEDIUM : kind_in[i];
  out_idx[i] = medium >= 0 ? medium : idx_in[i];
}

// K4: the solid sweep on [RAY_T_MIN, inf), then every medium in order
// (media_events), and the decode.
__global__ void k4_scene_hit(const float* ox, const float* oy, const float* oz,
                             const float* dx, const float* dy, const float* dz,
                             Draw draw, const float4* sph, int n_sph,
                             const float4* pln, int n_pl, const int* pl_idx,
                             Media md, int n_rays, float* out_t,
                             int* out_kind, int* out_idx) {
  __shared__ float4 tile[kTileRows * 4];
  extern __shared__ __align__(16) float4 media_rows[];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n_rays;  // no early return: every thread stages
  Ray r = {};
  if (live) r = load_ray(ox, oy, oz, dx, dy, dz, i);
  const bool test = live && !parked(r);
  float best = CUDART_INF_F;
  int slot = -1;
  int medium = -1;
  if (__syncthreads_or(test)) {   // block-uniform: a barrier may follow
    const Media smd = stage_media(md, media_rows);
    __syncthreads();
    sweep_tables(r, test, tile, sph, n_sph, pln, n_pl, hit::kRayTMin,
                 CUDART_INF_F, &best, &slot);
    if (test) medium = media_events(r, smd, draw, i, &best);
  }
  if (!live) return;
  int kind, idx;
  if (medium >= 0) {
    kind = KIND_MEDIUM;
    idx = medium;
  } else if (slot < n_sph) {   // a sphere, or a miss (slot -1)
    kind = KIND_SPHERE;
    idx = slot < 0 ? 0 : slot;
  } else {   // the planar row's is_tri column and pl_idx
    const int ps = slot - n_sph;
    kind = pln[4 * ps + 3].x > 0.5f ? KIND_TRIANGLE : KIND_QUAD;
    idx = pl_idx[ps];
  }
  out_t[i] = best;
  out_kind[i] = kind;
  out_idx[i] = idx;
}

inline int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

Media media_of(const float* msph, int n_msph, const float* mpln, int n_mpl,
               const int* sph_off, const int* pl_off, const float* nid,
               const float* box, int n_media) {
  return Media{reinterpret_cast<const float4*>(msph), n_msph,
               reinterpret_cast<const float4*>(mpln), n_mpl, sph_off, pl_off,
               nid, reinterpret_cast<const float4*>(box), n_media};
}

}  // namespace

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

// Counters: (pointer, element size 4 or 8), one value a lane. The media:
// MediaTables' packed tables, offsets (int32), neg_inv_density and boxes.
extern "C" int k3_media_launch(
    const float* ox, const float* oy, const float* oz, const float* dx,
    const float* dy, const float* dz, const void* pix, int pix_size,
    const void* sample, int sample_size, const void* bounce, int bounce_size,
    unsigned int seed, const float* msph, int n_msph, const float* mpln,
    int n_mpl, const int* sph_off, const int* pl_off, const float* nid,
    const float* box, int n_media, const float* t_in, const int* kind_in,
    const int* idx_in, int n_rays, float* out_t, int* out_kind, int* out_idx,
    void* stream) {
  if (n_rays > 0) {
    k3_media<<<blocks_for(n_rays), kThreads, media_smem_bytes(n_msph, n_mpl),
               static_cast<cudaStream_t>(stream)>>>(
        ox, oy, oz, dx, dy, dz,
        Draw{Counter{pix, pix_size, 1, 0u},
             Counter{sample, sample_size, 1, 0u},
             Counter{bounce, bounce_size, 1, 0u}, seed},
        media_of(msph, n_msph, mpln, n_mpl, sph_off, pl_off, nid, box,
                 n_media),
        t_in, kind_in, idx_in, n_rays, out_t, out_kind, out_idx);
  }
  return static_cast<int>(cudaGetLastError());
}

// Counters: (pointer, element size 4 or 8), one value a lane.
extern "C" int k4_scene_hit_launch(
    const float* ox, const float* oy, const float* oz, const float* dx,
    const float* dy, const float* dz, const void* pix, int pix_size,
    const void* sample, int sample_size, const void* bounce, int bounce_size,
    unsigned int seed, const float* sph, int n_sph,
    const float* pln, int n_pl, const int* pl_idx, const float* msph,
    int n_msph, const float* mpln, int n_mpl, const int* sph_off,
    const int* pl_off, const float* nid, const float* box, int n_media,
    int n_rays, float* out_t, int* out_kind, int* out_idx, void* stream) {
  if (n_rays > 0) {
    k4_scene_hit<<<blocks_for(n_rays), kThreads,
                   media_smem_bytes(n_msph, n_mpl),
                   static_cast<cudaStream_t>(stream)>>>(
        ox, oy, oz, dx, dy, dz,
        Draw{Counter{pix, pix_size, 1, 0u},
             Counter{sample, sample_size, 1, 0u},
             Counter{bounce, bounce_size, 1, 0u}, seed},
        reinterpret_cast<const float4*>(sph), n_sph,
        reinterpret_cast<const float4*>(pln), n_pl, pl_idx,
        media_of(msph, n_msph, mpln, n_mpl, sph_off, pl_off, nid, box,
                 n_media),
        n_rays, out_t, out_kind, out_idx);
  }
  return static_cast<int>(cudaGetLastError());
}
