// Ray-primitive tests shared by the sweep kernels (K2-K4, sweep.cu) and the
// render megakernel (K5, megakernel.cu).
//
// The formulas are the TPU kernels' (solstrale_tpu/ops/pallas_sweep.py:86-138
// and :249-313), op for op, so that with -fmad=false a kernel returns the
// plain PyTorch versions' values (ops/sweep.py) bit for bit on a device.
//
// Tables (f32, row-major, 16-byte aligned rows):
//   spheres: cx cy cz radius | valid ...          (2 float4 per row)
//   planar:  nx ny nz d | g1x g1y g1z g1o | g2x g2y g2z g2o | is_tri valid ..
//            (the first 4 float4 of a row)
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace hit {

constexpr float kAlmostZero = 1e-8f;  // geo.ALMOST_ZERO (vec3.rs:21)
constexpr float kRayTMin = 1e-3f;     // geo.RAY_T_MIN

struct Ray {
  float o0, o1, o2, d0, d1, d2;
  float dd, od, oo;
};

__device__ __forceinline__ Ray make_ray(float o0, float o1, float o2,
                                        float d0, float d1, float d2) {
  Ray r;
  r.o0 = o0; r.o1 = o1; r.o2 = o2;
  r.d0 = d0; r.d1 = d1; r.d2 = d2;
  r.dd = d0 * d0 + d1 * d1 + d2 * d2;
  r.od = o0 * d0 + o1 * d1 + o2 * d2;
  r.oo = o0 * o0 + o1 * o1 + o2 * o2;
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

// A constant medium's free-flight event from its entry t1 and exit t2
// boundary hits (constant_medium.rs:35-79, pallas_sweep.py:299-313):
// exponential flight inside [entry, exit] clamped to [RAY_T_MIN, ts].
// Returns INF when the ray does not scatter in the medium.
__device__ __forceinline__ float medium_event(const Ray& r, float t1, float t2,
                                              float ts, float u,
                                              float neg_inv_density) {
  const bool both = (t1 < CUDART_INF_F) && (t2 < CUDART_INF_F);
  float t1c = fmaxf(t1, kRayTMin);
  const float t2c = fminf(t2, ts);
  const bool ordered = t1c < t2c;
  t1c = fmaxf(t1c, 0.f);
  const float r_len = sqrtf(r.dd);
  const float dist_inside = (t2c - t1c) * r_len;
  // logf, not __logf: the plain version uses the IEEE-accurate log
  const float hit_dist = neg_inv_density * logf(fmaxf(u, 1e-38f));
  const bool scatters = hit_dist <= dist_inside;
  const float t = t1c + hit_dist / r_len;
  return (both && ordered && scatters) ? t : CUDART_INF_F;
}

}  // namespace hit
