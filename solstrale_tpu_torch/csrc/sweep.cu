// Brute-force closest-hit sweep (K2) and constant-medium event (K3).
//
// Replace the TPU kernels solstrale_tpu/ops/pallas_sweep.py::_sweep_kernel
// (closest_hit_pallas) and ::_medium_kernel (medium_hit_pallas). Same
// formulas as the TPU kernels (pallas_sweep.py:86-138 and :249-313), op for
// op, so that with -fmad=false the results equal the plain PyTorch versions
// (ops/sweep.py) bit for bit on a given device.
//
// Design: one thread per ray; a block of 256 rays stages tiles of the prim
// tables through shared memory, so each table row is read from device
// memory once per block rather than once per ray. Both kernels are bound by
// arithmetic (~30 flops and one IEEE division per ray-prim pair against 16
// bytes of shared-memory traffic): the tables are small (a few hundred rows
// on the scenes that take this path) and stay resident in L2.
//
// Tables (f32, row-major, 16-byte aligned rows):
//   spheres (S, 8):  cx cy cz radius valid 0 0 0
//   planar  (P, 16): nx ny nz d  g1x g1y g1z g1o  g2x g2y g2z g2o
//                    is_tri valid 0 0
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileRows = 256;       // prim rows staged per tile
constexpr float kAlmostZero = 1e-8f;  // geo.ALMOST_ZERO (vec3.rs:21)

struct Ray {
  float o0, o1, o2, d0, d1, d2;
  float dd, od, oo;
};

__device__ __forceinline__ Ray load_ray(const float* ox, const float* oy,
                                        const float* oz, const float* dx,
                                        const float* dy, const float* dz,
                                        int i) {
  Ray r;
  r.o0 = ox[i]; r.o1 = oy[i]; r.o2 = oz[i];
  r.d0 = dx[i]; r.d1 = dy[i]; r.d2 = dz[i];
  r.dd = r.d0 * r.d0 + r.d1 * r.d1 + r.d2 * r.d2;
  r.od = r.o0 * r.d0 + r.o1 * r.d1 + r.o2 * r.d2;
  r.oo = r.o0 * r.o0 + r.o1 * r.o1 + r.o2 * r.o2;
  return r;
}

// max(x, 0) that keeps NaN, like jnp.maximum / torch.clamp
__device__ __forceinline__ float clamp0(float x) { return x < 0.f ? 0.f : x; }

// Sphere roots in the expanded form of pallas_sweep.py:93-101. Returns
// false when the discriminant is negative (or NaN) or the row is padding.
__device__ __forceinline__ bool sphere_roots(const Ray& r, float4 a, float4 b,
                                             float* r1, float* r2) {
  const float cx = a.x, cy = a.y, cz = a.z, radius = a.w, valid = b.x;
  const float cd = cx * r.d0 + cy * r.d1 + cz * r.d2;
  const float co = cx * r.o0 + cy * r.o1 + cz * r.o2;
  const float half_b = r.od - cd;
  const float c2 = r.oo - 2.0f * co + (cx * cx + cy * cy + cz * cz)
                   - radius * radius;
  const float disc = half_b * half_b - r.dd * c2;
  const float sq = sqrtf(clamp0(disc));
  *r1 = (-half_b - sq) / r.dd;
  *r2 = (-half_b + sq) / r.dd;
  return (disc >= 0.f) && (valid > 0.5f);
}

// Unified quad/triangle plane test (pallas_sweep.py:115-135): t on the
// plane, then two affine barycentric functionals of the hit point.
// Sets *t; returns whether the hit lies inside the prim (and the row is
// valid, the ray not parallel).
__device__ __forceinline__ bool planar_hit(const Ray& r, float4 a, float4 b,
                                           float4 c, float4 e, float* t) {
  const float denom = a.x * r.d0 + a.y * r.d1 + a.z * r.d2;
  const float tt = (a.w - (a.x * r.o0 + a.y * r.o1 + a.z * r.o2)) / denom;
  const float hx = r.o0 + tt * r.d0;
  const float hy = r.o1 + tt * r.d1;
  const float hz = r.o2 + tt * r.d2;
  const float u = hx * b.x + hy * b.y + hz * b.z + b.w;
  const float v = hx * c.x + hy * c.y + hz * c.z + c.w;
  const bool tri = e.x > 0.5f;
  const bool valid = e.y > 0.5f;
  const bool contain = (u >= 0.f) && (u <= 1.f) && (v >= 0.f) &&
                       (tri ? (u + v <= 1.f) : (v <= 1.f));
  *t = tt;
  return (fabsf(denom) >= kAlmostZero) && valid && contain;
}

// Stage rows [base, base+count) of a (rows, 4*width) float4 table.
__device__ __forceinline__ void stage(float4* tile, const float4* table,
                                      int base, int count, int width) {
  for (int k = threadIdx.x; k < count * width; k += blockDim.x)
    tile[k] = table[base * width + k];
}

// Closest hit of one ray over both tables with the TPU kernel's strict
// '<' (the first, smallest slot wins ties). lo/hi bound t.
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
        const bool ok = sphere_roots(r, tile[2 * p], tile[2 * p + 1], &r1,
                                     &r2);
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
        const bool ok = planar_hit(r, tile[4 * p], tile[4 * p + 1],
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

// K3: entry = closest boundary hit on (-inf, inf); exit = closest past
// entry + 1e-4; exponential free flight inside [entry, exit] clamped to
// [RAY_T_MIN, t_solid] (constant_medium.rs:35-79, pallas_sweep.py:299-313).
// Sphere roots take no upper bound here, as in the TPU kernel.
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
  float t1, t2;
  int unused;
  sweep_tables<false>(r, live, tile, sph, n_sph, pln, n_pl, -CUDART_INF_F,
                      CUDART_INF_F, false, &t1, &unused);
  sweep_tables<false>(r, live, tile, sph, n_sph, pln, n_pl, t1 + 1e-4f,
                      CUDART_INF_F, false, &t2, &unused);
  if (!live) return;
  const bool both = (t1 < CUDART_INF_F) && (t2 < CUDART_INF_F);
  float t1c = fmaxf(t1, 1e-3f);  // RAY_T_MIN
  const float t2c = fminf(t2, ts);
  const bool ordered = t1c < t2c;
  t1c = fmaxf(t1c, 0.f);
  const float r_len = sqrtf(r.dd);
  const float dist_inside = (t2c - t1c) * r_len;
  // logf, not __logf: the plain version uses the IEEE-accurate log
  const float hit_dist = neg_inv_density[0] * logf(fmaxf(u, 1e-38f));
  const bool scatters = hit_dist <= dist_inside;
  const float t = t1c + hit_dist / r_len;
  out_t[i] = (both && ordered && scatters) ? t : CUDART_INF_F;
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
