// Brute-force closest-hit sweep (K2), constant-medium event (K3) and the
// fused scene hit (K4).
//
// Replace the TPU kernels solstrale_tpu/ops/pallas_sweep.py::_sweep_kernel
// (closest_hit_pallas), ::_medium_kernel (medium_hit_pallas) and
// ::_scene_hit_kernel (scene_hit_pallas). Same formulas as the TPU kernels
// (hit.cuh), so that with -fmad=false the results equal the plain PyTorch
// versions (ops/sweep.py) bit for bit on a given device.
//
// Design: one thread per ray; a block of 256 rays stages tiles of the prim
// tables through shared memory, so each table row is read from device
// memory once per block rather than once per ray. The kernels are bound by
// arithmetic (~30 flops and one IEEE division per ray-prim pair against 16
// bytes of shared-memory traffic): the tables are small (a few hundred rows
// on the scenes that take these paths) and stay resident in L2.
//
// K4 is K2 over the solid tables followed by K3 for every medium, in medium
// order, in one launch: medium m clips against the best t so far, which
// already holds the events of the media before it (pallas_sweep.py:459-482).
// Its slot is a sphere [0, S), a planar row [S, S+P), medium m at S+P+m, or
// -1 for a miss.
#include "hit.cuh"

namespace {

using hit::Ray;

constexpr int kThreads = 256;
constexpr int kTileRows = 256;       // prim rows staged per tile

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
        float t;
        const bool ok = hit::planar_hit(r, tile[4 * p], tile[4 * p + 1],
                                        tile[4 * p + 2], tile[4 * p + 3], &t);
        if (ok && t >= lo && t <= hi && t < best) {
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

// K4: the solid sweep on [RAY_T_MIN, inf), then every medium in order. The
// media's boundary tables are packed into one sphere and one planar table;
// medium m owns rows [sph_off[m], sph_off[m+1]) and [pl_off[m],
// pl_off[m+1]). u_flight is (n_media, n_rays).
__global__ void k4_scene_hit(const float* ox, const float* oy, const float* oz,
                             const float* dx, const float* dy, const float* dz,
                             const float* u_flight, const float4* sph,
                             int n_sph, const float4* pln, int n_pl,
                             const float4* msph, const float4* mpln,
                             const int* sph_off, const int* pl_off,
                             const float* neg_inv_density, int n_media,
                             int n_rays, float* out_t, int* out_slot) {
  __shared__ float4 tile[kTileRows * 4];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n_rays;
  Ray r = {};
  if (live) r = load_ray(ox, oy, oz, dx, dy, dz, i);
  float best;
  int slot;
  sweep_tables<true>(r, live, tile, sph, n_sph, pln, n_pl, hit::kRayTMin,
                     CUDART_INF_F, true, &best, &slot);
  for (int m = 0; m < n_media; ++m) {
    const int s0 = sph_off[m], s1 = sph_off[m + 1];
    const int p0 = pl_off[m], p1 = pl_off[m + 1];
    const float u = live ? u_flight[static_cast<size_t>(m) * n_rays + i] : 0.f;
    const float t_m = medium_sweep(r, live, tile, msph + 2 * s0, s1 - s0,
                                   mpln + 4 * p0, p1 - p0, best, u,
                                   neg_inv_density[m]);
    if (t_m < best) {
      best = t_m;
      slot = n_sph + n_pl + m;
    }
  }
  if (live) {
    out_t[i] = best;
    out_slot[i] = slot;
  }
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

extern "C" int k4_scene_hit_launch(const float* ox, const float* oy,
                                   const float* oz, const float* dx,
                                   const float* dy, const float* dz,
                                   const float* u_flight, const float* sph,
                                   int n_sph, const float* pln, int n_pl,
                                   const float* msph, const float* mpln,
                                   const int* sph_off, const int* pl_off,
                                   const float* neg_inv_density, int n_media,
                                   int n_rays, float* out_t, int* out_slot,
                                   void* stream) {
  if (n_rays > 0) {
    k4_scene_hit<<<blocks_for(n_rays), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
        ox, oy, oz, dx, dy, dz, u_flight,
        reinterpret_cast<const float4*>(sph), n_sph,
        reinterpret_cast<const float4*>(pln), n_pl,
        reinterpret_cast<const float4*>(msph),
        reinterpret_cast<const float4*>(mpln), sph_off, pl_off,
        neg_inv_density, n_media, n_rays, out_t, out_slot);
  }
  return static_cast<int>(cudaGetLastError());
}
