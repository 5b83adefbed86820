// Ray-primitive tests, the medium cull and the counter RNG shared by the
// sweep kernels (K2-K4, sweep.cu), the render megakernel (K5,
// megakernel.cu), the draw kernel (rng.cu) and the step kernels (step.cu).
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

#include <cstdint>

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

// The unified quad/triangle plane test (pallas_sweep.py:115-135) in
// parts. planar_nd: t = num / denom on the plane, denom = d.n.
__device__ __forceinline__ void planar_nd(const Ray& r, float4 a, float* num,
                                          float* denom) {
  *denom = a.x * r.d0 + a.y * r.d1 + a.z * r.d2;
  *num = a.w - (a.x * r.o0 + a.y * r.o1 + a.z * r.o2);
}

// Whether num / denom can be a positive finite t: num and denom of one
// sign, neither zero nor NaN. A quotient this rejects is <= 0, infinite
// or NaN, so it can pass no bound lo > 0 and beat no best t: a sweep on
// [lo > 0, ...) may skip the row's division.
__device__ __forceinline__ bool planar_ahead(float num, float denom) {
  return (num > 0.f && denom > 0.f) || (num < 0.f && denom < 0.f);
}

// planar_inside: the two affine barycentric functionals of the hit point at
// t; whether it lies inside the prim (and the row is valid, the ray not
// parallel).
__device__ __forceinline__ bool planar_inside(const Ray& r, float4 b,
                                              float4 c, float4 e, float t,
                                              float denom) {
  const float hx = r.o0 + t * r.d0;
  const float hy = r.o1 + t * r.d1;
  const float hz = r.o2 + t * r.d2;
  const float u = hx * b.x + hy * b.y + hz * b.z + b.w;
  const float v = hx * c.x + hy * c.y + hz * c.z + c.w;
  const bool tri = e.x > 0.5f;
  const bool valid = e.y > 0.5f;
  const bool contain = (u >= 0.f) && (u <= 1.f) && (v >= 0.f) &&
                       (tri ? (u + v <= 1.f) : (v <= 1.f));
  return (fabsf(denom) >= kAlmostZero) && valid && contain;
}

// The whole test: sets *t; returns whether the hit lies inside the prim.
__device__ __forceinline__ bool planar_hit(const Ray& r, float4 a, float4 b,
                                           float4 c, float4 e, float* t) {
  float num, denom;
  planar_nd(r, a, &num, &denom);
  *t = num / denom;
  return planar_inside(r, b, c, e, *t, denom);
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

// One axis of the slab test: narrow [tn, tf] to the parameters where the
// line is between lo and hi. fminf/fmaxf drop the NaN of 0 * inf (a
// direction parallel to the axis from an origin on a face).
__device__ __forceinline__ void slab(float o, float inv, float lo, float hi,
                                     float* tn, float* tf) {
  const float a = (lo - o) * inv;
  const float b = (hi - o) * inv;
  *tn = fmaxf(*tn, fminf(a, b));
  *tf = fminf(*tf, fmaxf(a, b));
}

// Whether a medium's padded box [lo, hi] (ops/sweep.py::medium_boxes) can
// hold the medium's event for a ray with direction reciprocals inv0..2:
// the ray's line meets the box at some parameter in [0, ts]. Every boundary
// hit the two sweeps accept lies inside the padded box, at a parameter in
// [tn, tf]; an event needs an exit hit beyond RAY_T_MIN (so tf >= 0) and an
// entry below ts (so tn <= ts). A NaN ray hits no boundary, and fails here
// too. So a medium this test rejects has the event INF.
__device__ __forceinline__ bool box_reach(const Ray& r, float inv0,
                                          float inv1, float inv2, float4 lo,
                                          float4 hi, float ts) {
  float tn = -CUDART_INF_F, tf = CUDART_INF_F;
  slab(r.o0, inv0, lo.x, hi.x, &tn, &tf);
  slab(r.o1, inv1, lo.y, hi.y, &tn, &tf);
  slab(r.o2, inv2, lo.z, hi.z, &tn, &tf);
  return tn <= tf && tf >= 0.0f && tn <= ts;
}

// Counter RNG: four uniforms in [0, 1) from PCG4D of (pixel, sample,
// bounce, purpose, seed), each taken as its low 32 bits; bit-equal to
// ops/rng.py::uniform4.
__device__ __forceinline__ float4 uniform4(uint32_t pix, uint32_t sample,
                                           uint32_t bounce, uint32_t purpose,
                                           uint32_t seed) {
  uint32_t a = pix, b = sample, c = (bounce << 8) | purpose, d = seed;
  a = a * 1664525u + 1013904223u;
  b = b * 1664525u + 1013904223u;
  c = c * 1664525u + 1013904223u;
  d = d * 1664525u + 1013904223u;
  a += b * d; b += c * a; c += a * b; d += b * c;
  a ^= a >> 16; b ^= b >> 16; c ^= c >> 16; d ^= d >> 16;
  a += b * d; b += c * a; c += a * b; d += b * c;
  const float s = 1.0f / 16777216.0f;
  return make_float4(static_cast<float>(a >> 8) * s,
                     static_cast<float>(b >> 8) * s,
                     static_cast<float>(c >> 8) * s,
                     static_cast<float>(d >> 8) * s);
}

// A counter of uniform4 (pixel, sample, bounce or seed) for lane i: an
// int32 (size 4) or int64 (size 8) array read at i * stride (stride 1: one
// value a lane; stride 0: one value for every lane, a broadcast scalar or a
// 0-dim tensor read on the device), or without an array (p null) the
// constant ``value``; taken as its low 32 bits, as ops/rng.py::_u32 does.
struct Counter {
  const void* p;
  int size;
  int stride;
  uint32_t value;

  __device__ __forceinline__ uint32_t at(long long i) const {
    if (p == nullptr) return value;
    const long long j = i * stride;
    if (size == 8) return static_cast<uint32_t>(
        static_cast<const long long*>(p)[j]);
    return static_cast<uint32_t>(static_cast<const int*>(p)[j]);
  }
};

}  // namespace hit
