// The render megakernel (K5): a whole progressive sample batch of a small
// scene in one launch.
//
// Replaces the TPU kernel solstrale_tpu/renderer/megakernel.py::_render_kernel
// (render_batch_megakernel). What it computes is the port's plain version,
// renderer/megakernel.py::render_batch_megakernel_plain, i.e.
// renderer/integrator.py::path_step per bounce: camera ray (thin lens),
// brute-force scene hit with every constant medium, hit attributes, blend
// resolution, texture lookup, the material scatter with the 50/50 NEE
// mixture and its light pdf, the forward clamp-fold, accumulation and
// regeneration, with the counter-hash PCG4D in native uint32. The formulas
// follow the plain version expression for expression (and -fmad=false keeps
// nvcc from contracting them), so the kernel returns its values; those it
// shares with the wavefront step's kernels (step.cu) are in shade.cuh.
//
// What bounds it: arithmetic. Per segment a lane runs the solid sweep (~30
// flops and one division per prim), per medium boundary prim two more, the
// attributes and the scatter (a few hundred flops and ~10 transcendental
// calls) and NEE over every light; it reads no per-pixel data from memory
// and writes 16 bytes per pixel at the end. Three things keep the card from
// that arithmetic rate, and the design answers each:
//
// - Path length differs from pixel to pixel, and a warp runs as long as its
//   longest lane. So the grid is persistent (as many blocks as stay
//   resident) and pixels are handed out as a queue: a warp claims a run of
//   32 consecutive pixel ids with one atomicAdd, and a lane whose pixel is
//   done takes the next unclaimed pixel of its warp's run (ballot, then
//   __popc for its rank), the warp claiming the next run when this one is
//   used up. A warp stays full until the queue drains, and its lanes still
//   hold neighbouring pixels, so their rays stay coherent.
// - Most segments never come near a medium, yet each medium costs two
//   boundary sweeps. A lane first slab-tests its ray against the medium's
//   padded box (hit::box_reach; MediaTables.box, the boxes K4 culls with
//   too): a ray that cannot reach the box in
//   front of its closest hit skips both sweeps and the flight draw. The
//   pad exceeds every rounding of a boundary hit point, so every hit the
//   sweeps could accept lies strictly inside the box, and a skipped medium
//   is one whose event would have been INF: the result does not change.
//   Lanes of a warp hold neighbouring pixels, so they tend to skip together.
// - Each segment is long chains of IEEE divisions, square roots and
//   transcendentals, so latency is hidden by warps in flight; the block
//   size and register budget were chosen on the card (PERF.md).
//
// Each pixel is still traced by one lane, its n_samples paths back to back
// in registers, each finished path's color added to the pixel's own
// accumulator in sample order; so which lane takes which pixel changes no
// value. Each pixel's segment count is written as an int32 (the wrapper sums
// them). There are no float atomics and a repeated launch is bit-identical;
// the integer atomics only hand out pixels and count work (warp iterations
// and medium sweeps, for the active-lane efficiency). The scene tables are
// read through const __restrict__ pointers, none staged in shared memory and
// no array here sized by a table: every lane of a warp reads the same row at
// the same time, which the L1 broadcasts. (The TPU kernel kept them in SMEM
// and its gate bounded each table by that; the port's gate bounds planar
// rows, spheres and lights where the gate sweep measured K5 falling behind
// the wavefront on the H100, renderer/megakernel.py.)
//
// Normal maps (the kNormalMaps instantiation, for scenes whose features say
// "normal_maps"): a scattering lane's shading normal is S1's
// (step.cu::shade_lane): normal_mapped through the hit's tangent frame,
// with the material of the normal draw's blend walk (P_BLEND_NORMAL) where
// the scene has blends; metal, dielectric, the ONB and the NEE mixture's
// cosines use it, emission's and the dielectric's front face stay
// geometric. The frame is built only on that path, from the (P, 8) frame
// table (pl_attr's tangent and bitangent) for a planar hit, from the hit
// point for a sphere (sphere_attrs' formulas), (1, 1, 1) for a medium. A
// scene without maps runs the other instantiation, the code without any of
// it.
//
// TPU workarounds left behind: the masked-row table lookups (direct
// indexing here), the u8 SMEM texture arena and its DMA round trips (the
// f32 texel table is read directly), the Cephes acos/atan2 (acosf/atan2f),
// masks carried as f32, and the per-tile segment count.
#include <cstdint>

#include "hit.cuh"
#include "shade.cuh"

namespace {

using hit::Ray;
using namespace shade;  // the shading step's functions (shade.cuh)

// Launch shape, chosen on an H100 80GB HBM3 at 700 W over 14 shapes of
// block size and __launch_bounds__ minimum (PERF.md): 128 threads and
// a minimum of 1 block per SM (96 registers, no spills, 20 warps per SM) is
// the fastest at 400x266x8 on both kitchen-sink scenes and at 1080p x 8 on
// the solid one; capping registers for more warps (512 threads, 2 blocks)
// gains the textured scene ~7% at 1080p but costs the solid one ~20% at
// 400x266. The minimum must be stated: with the block size alone ptxas
// settles on 80 registers and spills, ~10% slower at 400x266.
constexpr int kThreads = 128;
constexpr int kMinBlocks = 1;   // __launch_bounds__ minimum blocks per SM
constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;

// Closest solid hit on [RAY_T_MIN, inf): slot < S sphere, S + p planar row
// p, -1 miss (the K2 sweep, ties to the first slot)
__device__ __forceinline__ float solid_sweep(const Scene& sc, const Ray& r,
                                             int* slot_out) {
  float best = CUDART_INF_F;
  int slot = -1;
  const float lo = hit::kRayTMin;
  for (int p = 0; p < sc.n_sph; ++p) {
    float r1, r2;
    const bool ok = hit::sphere_roots(r, sc.sph[2 * p], sc.sph[2 * p + 1],
                                      &r1, &r2);
    const bool in1 = r1 >= lo && r1 <= CUDART_INF_F;
    const bool in2 = r2 >= lo && r2 <= CUDART_INF_F;
    const float t = (ok && in1) ? r1 : ((ok && in2) ? r2 : CUDART_INF_F);
    if (t < best) {
      best = t;
      slot = p;
    }
  }
  for (int p = 0; p < sc.n_pl; ++p) {
    const float4* row = sc.pln + kPlnRow * p;
    float t;
    const bool ok = hit::planar_hit(r, row[0], row[1], row[2], row[3], &t);
    if (ok && t >= lo && t <= CUDART_INF_F && t < best) {
      best = t;
      slot = sc.n_sph + p;
    }
  }
  *slot_out = slot;
  return best;
}

// Closest boundary t >= lo of one medium (one K3 sweep)
__device__ __forceinline__ float boundary_sweep(const float4* sph, int n_sph,
                                                const float4* pln, int n_pl,
                                                const Ray& r, float lo) {
  float best = CUDART_INF_F;
  for (int p = 0; p < n_sph; ++p) {
    float r1, r2;
    const bool ok = hit::sphere_roots(r, sph[2 * p], sph[2 * p + 1], &r1, &r2);
    const float t = (ok && r1 >= lo) ? r1 : ((ok && r2 >= lo) ? r2 : CUDART_INF_F);
    if (t < best) best = t;
  }
  for (int p = 0; p < n_pl; ++p) {
    float t;
    const bool ok = hit::planar_hit(r, pln[4 * p], pln[4 * p + 1],
                                    pln[4 * p + 2], pln[4 * p + 3], &t);
    if (ok && t >= lo && t <= CUDART_INF_F && t < best) best = t;
  }
  return best;
}


// work[] counters of a launch (int64, zeroed by the wrapper)
constexpr int kWorkNextPixel = 0;   // the pixel queue's head
constexpr int kWorkIterations = 1;  // warp iterations that traced a segment
constexpr int kWorkSweeps = 2;      // (segment, medium) pairs swept
constexpr int kWorkWarpSweeps = 3;  // warp iterations in which a lane swept

// The hit's tangent frame for the normal map (full_hit_attributes): a
// medium's unit tangents, a sphere's from its center (sphere_attrs), a
// planar row's from the (P, 8) frame table: tangent 0 bitangent 0
__device__ __forceinline__ void hit_frame(const Scene& sc,
                                          const float4* __restrict__ frame,
                                          int medium, int slot, V3 point,
                                          V3* tangent, V3* bitangent) {
  if (medium >= 0) {
    *tangent = *bitangent = v3(1.0f, 1.0f, 1.0f);
  } else if (slot < sc.n_sph) {
    const float4 a = sc.sph[2 * slot];
    const V3 n_raw = sub(point, v3(a.x, a.y, a.z));
    *tangent = unit(v3(n_raw.z, 0.0f, -n_raw.x));
    *bitangent = cross(n_raw, *tangent);
  } else {
    const float4* f = frame + 2 * (slot - sc.n_sph);
    const float4 t = f[0], b = f[1];
    *tangent = v3(t.x, t.y, t.z);
    *bitangent = v3(b.x, b.y, b.z);
  }
}

// Persistent: each warp drains the pixel queue (see the note at the top).
// n_samples > 0 (the wrapper returns zeros itself otherwise). kNormalMaps:
// the shading normal of a scene with normal maps (see the note at the top);
// ``frame`` is read only by that instantiation.
template <bool kNormalMaps>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    k5_render(Scene sc, const float4* __restrict__ frame, int width,
              int height, int sample_start, int n_samples, int max_depth,
              uint32_t seed, float* out_accum, int* out_segments,
              unsigned long long* work) {
  const long long n_pix = static_cast<long long>(width) * height;
  const unsigned lane = threadIdx.x & (kWarp - 1);
  const float* bg = sc.cam + 19;
  const int sample_end = sample_start + n_samples;

  // the warp's run of pixel ids [run, run + kWarp), unclaimed from cursor
  long long run = 0;
  int cursor = kWarp;
  bool drained = false;   // every pixel id left is >= n_pix
  unsigned long long iterations = 0, warp_sweeps = 0;
  unsigned sweeps = 0;
  bool swept = false;     // this lane swept a medium in the last iteration

  int pix = -1;           // this lane's pixel, -1 none
  bool fresh = false;     // the next segment starts with a camera ray
  int sample = 0;
  int bounce = 0;
  int segments = 0;
  V3 o = v3(0.0f, 0.0f, 0.0f), d = o;
  float acc_len = 0.0f;
  float A[3] = {1.0f, 1.0f, 1.0f};
  float B[3] = {CUDART_INF_F, CUDART_INF_F, CUDART_INF_F};
  bool dead[3] = {false, false, false};
  bool outer = false;
  float acc[3] = {0.0f, 0.0f, 0.0f};

  while (true) {
    // --- lanes without a pixel take the next ones of the warp's run -------
    if (!drained) {
      const unsigned want = __ballot_sync(kFull, pix < 0);
      if (want != 0u) {
        const int n_want = __popc(want);
        const int rank = __popc(want & ((1u << lane) - 1u));
        long long mine = run + cursor + rank;
        if (cursor + n_want > kWarp) {   // the run is used up: claim the next
          unsigned long long base = 0;
          if (lane == 0) base = atomicAdd(work + kWorkNextPixel,
                                          static_cast<unsigned long long>(kWarp));
          base = __shfl_sync(kFull, base, 0);
          if (cursor + rank >= kWarp)
            mine = static_cast<long long>(base) + (cursor + rank - kWarp);
          run = static_cast<long long>(base);
          cursor += n_want - kWarp;
        } else {
          cursor += n_want;
        }
        // runs are claimed in increasing order, so nothing below n_pix is
        // left once this run's cursor passes it
        drained = run + cursor >= n_pix;
        if (pix < 0 && mine < n_pix) {
          pix = static_cast<int>(mine);
          sample = sample_start;
          segments = 0;
          acc[0] = acc[1] = acc[2] = 0.0f;
          fresh = true;
        }
      }
    }
    if (__any_sync(kFull, swept)) ++warp_sweeps;
    swept = false;
    if (!__any_sync(kFull, pix >= 0)) break;
    ++iterations;
    if (pix < 0) continue;

    if (fresh) {
      camera_ray(sc, pix, sample, seed, width, height, &o, &d);
      fresh = false;
    }
    ++segments;
    // --- scene hit: solids, then every medium in order -------------------
    const Ray ray = hit::make_ray(o.x, o.y, o.z, d.x, d.y, d.z);
    int slot;
    float t = solid_sweep(sc, ray, &slot);
    int medium = -1;
    const V3 inv = sc.n_media > 0 ? v3(1.0f / d.x, 1.0f / d.y, 1.0f / d.z)
                                  : v3(0.0f, 0.0f, 0.0f);
    for (int m = 0; m < sc.n_media; ++m) {
      // a ray that cannot reach the box before t has the event INF
      if (!hit::box_reach(ray, inv.x, inv.y, inv.z, sc.mbox[2 * m],
                          sc.mbox[2 * m + 1], t))
        continue;
      swept = true;
      ++sweeps;
      const int s0 = sc.msph_off[m], s1 = sc.msph_off[m + 1];
      const int p0 = sc.mpln_off[m], p1 = sc.mpln_off[m + 1];
      const float4* ms = sc.msph + 2 * s0;
      const float4* mp = sc.mpln + 4 * p0;
      const float t1 = boundary_sweep(ms, s1 - s0, mp, p1 - p0, ray, -CUDART_INF_F);
      const float t2 = boundary_sweep(ms, s1 - s0, mp, p1 - p0, ray,
                                      t1 + 1e-4f);
      const float u = uniform4(pix, sample, bounce, P_MEDIUM_BASE + m,
                               seed).x;
      const float t_m = hit::medium_event(ray, t1, t2, t, u, sc.med[4 * m]);
      if (t_m < t) {
        t = t_m;
        medium = m;
      }
    }

    const bool finite = isfinite(t);
    const float t_safe = finite ? t : 0.0f;
    const float total_len = acc_len + t_safe;
    bool terminal = true;
    float term[3] = {0.0f, 0.0f, 0.0f};
    float term_af = 0.0f;

    if (!finite) {
      term[0] = bg[0]; term[1] = bg[1]; term[2] = bg[2];
    } else if (bounce >= max_depth) {
      // depth cap: a zero terminal color
    } else {
      // --- hit attributes (hit_attributes_soa + medium overrides) ---------
      const V3 point = v3(o.x + d.x * t_safe, o.y + d.y * t_safe,
                          o.z + d.z * t_safe);
      V3 normal;
      float tu, tv;
      bool front;
      int mat;
      if (medium >= 0) {
        const float4 pr = uniform4(pix, sample, bounce, P_PHASE, seed);
        normal = unit_vector(pr.x, pr.y);
        tu = 0.0f;
        tv = 0.0f;
        front = false;
        mat = static_cast<int>(sc.med[4 * medium + 1]);
      } else if (slot < sc.n_sph) {
        const float4 a = sc.sph[2 * slot];
        const float4 b = sc.sph[2 * slot + 1];
        const V3 n_raw = sub(point, v3(a.x, a.y, a.z));
        const V3 n_unit = unit(n_raw);
        front = dot(d, n_unit) < 0.0f;
        normal = front ? n_unit : neg(n_unit);
        const float theta = acosf(clamp_max(clamp_min(-n_unit.y, -1.0f),
                                            1.0f));
        const float phi = -atan2f(n_unit.z, n_unit.x) + kPi;
        tu = div_scalar(phi, kTwoPi);
        tv = div_scalar(theta, kPi);
        mat = static_cast<int>(b.y);
      } else {
        // the planar sweep row is the attribute row: quads then triangles
        const float4* row = sc.pln + kPlnRow * (slot - sc.n_sph);
        const float4 g1 = row[1], g2 = row[2], e = row[3];
        const float4 nu = row[4], uv01 = row[5], uv2 = row[6];
        const V3 n = v3(nu.x, nu.y, nu.z);
        const float bu = dot(point, v3(g1.x, g1.y, g1.z)) + g1.w;
        const float bv = dot(point, v3(g2.x, g2.y, g2.z)) + g2.w;
        tu = uv01.x + bu * uv01.z + bv * uv2.x;
        tv = uv01.y + bu * uv01.w + bv * uv2.y;
        front = dot(d, n) < 0.0f;
        normal = front ? n : neg(n);
        mat = static_cast<int>(e.z);
      }

      // --- material (blend resolution, texture) ---------------------------
      const int hit_mat = mat;   // the normal draw's blend walk starts here
      if (sc.flags & kFlagBlend) {
        const float4 ub = uniform4(pix, sample, bounce, P_BLEND_SCATTER, seed);
        const float ul[kMaxBlendDepth] = {ub.x, ub.y, ub.z};
        for (int lvl = 0; lvl < kMaxBlendDepth; ++lvl) {
          const MatRow r = mat_row(sc, mat);
          if (r.kind == BLEND) mat = ul[lvl] > r.blend_factor ? r.m1 : r.m2;
        }
      }
      const MatRow row = mat_row(sc, mat);
      const V3 albedo = sample_texture(sc, row.albedo_tex, tu, tv);

      if (row.kind == DIFFUSE_LIGHT) {
        // emission (material/mod.rs:359-368)
        if (front) {
          term[0] = albedo.x; term[1] = albedo.y; term[2] = albedo.z;
        }
        term_af = row.atten;
      } else {
        terminal = false;
        // the shading normal (shading_normal_of), as S1 takes it
        V3 s_normal = normal;
        if (kNormalMaps) {
          int eff_n = mat;
          if (sc.flags & kFlagBlend)
            eff_n = blend_walk(sc, hit_mat, uniform4(pix, sample, bounce,
                                                     P_BLEND_NORMAL, seed));
          Attrs h;
          h.normal = normal;
          h.u = tu;
          h.v = tv;
          hit_frame(sc, frame, medium, slot, point, &h.tangent,
                    &h.bitangent);
          s_normal = normal_mapped(sc, h, eff_n);
        }
        const bool is_iso = row.kind == ISOTROPIC;
        const bool is_pdf = row.kind == LAMBERTIAN || is_iso;
        float prob = 1.0f;
        V3 new_dir;
        if (row.kind == METAL) {
          // metal (material/mod.rs:239-249)
          const float4 f = uniform4(pix, sample, bounce, P_FUZZ, seed);
          const V3 reflected = reflect(unit(d), s_normal);
          new_dir = add(reflected, scale(in_unit_sphere(f.x, f.y, f.z),
                                         row.fuzz));
        } else if (row.kind == DIELECTRIC) {
          // dielectric (material/mod.rs:279-316)
          const float ior = row.ior;
          const float rr = front ? 1.0f / ior : ior;
          const V3 udir = unit(d);
          const float cos_t = clamp_max(dot(neg(udir), s_normal), 1.0f);
          const float sin_t = sqrtf(clamp_min(1.0f - cos_t * cos_t, 0.0f));
          const bool cannot = rr * sin_t > 1.0f;
          float r0 = (1.0f - rr) / (1.0f + rr);
          r0 = r0 * r0;
          const float q = 1.0f - cos_t;
          const float q2 = q * q;
          const float reflectance = r0 + (1.0f - r0) * (q * (q2 * q2));
          const float u_d = uniform4(pix, sample, bounce, P_DIELECTRIC,
                                     seed).x;
          new_dir = (cannot || reflectance > u_d)
                        ? reflect(udir, s_normal)
                        : refract(udir, s_normal, rr);
        } else {
          // pdf-mixture scatter (material/mod.rs:191-207, 396-410)
          const float4 rc = uniform4(pix, sample, bounce, P_COSINE, seed);
          V3 ct, cb, cn;
          onb_from_w(s_normal, &ct, &cb, &cn);
          const V3 bsdf_dir =
              is_iso ? unit_vector(rc.x, rc.y)
                     : onb_local(ct, cb, cn, cosine_direction(rc.x, rc.y));
          const float u_pick = uniform4(pix, sample, bounce, P_LIGHT_PICK,
                                        seed).x;
          int pick = static_cast<int>(u_pick *
                                      static_cast<float>(sc.n_light));
          pick = pick > sc.n_light - 1 ? sc.n_light - 1 : pick;
          const float4 l = uniform4(pix, sample, bounce, P_LIGHT_SAMPLE,
                                    seed);
          const V3 light_dir = sample_light(sc, point, pick, l.x, l.y);
          const float u_coin = uniform4(pix, sample, bounce, P_MIX_COIN,
                                        seed).x;
          const V3 pdf_dir = sel(u_coin < 0.5f, light_dir, bsdf_dir);
          const float light_val = light_pdf_mean(sc, point, pdf_dir);
          const V3 unit_pdf_dir = unit(pdf_dir);
          const float cos_value =
              div_scalar(clamp_min(dot(unit_pdf_dir, unit(s_normal)), 0.0f),
                         kPi);
          const float bsdf_val = is_iso ? kSphereValue : cos_value;
          const float mix_val = 0.5f * light_val + 0.5f * bsdf_val;
          const float cos_sc = dot(s_normal, unit_pdf_dir);
          const float lamb_sc =
              cos_sc < 0.0f ? 0.0f : div_scalar(cos_sc, kPi);
          const float scat_pdf = is_iso ? kSphereValue : lamb_sc;
          if (is_pdf) prob = scat_pdf / mix_val;
          new_dir = pdf_dir;
        }
        // fold this scatter level (integrator.fold_scatter)
        const float tape[3] = {albedo.x, albedo.y, albedo.z};
        for (int c = 0; c < 3; ++c) {
          const float a = tape[c] * prob;
          const bool nan_a = a != a;
          if (is_pdf) B[c] = nan_min(B[c], 3.0f * A[c]);
          dead[c] = dead[c] || (is_pdf && nan_a) || (!is_pdf && nan_a && outer);
          A[c] = A[c] * a;
        }
        outer = outer || is_pdf;
        o = point;
        d = new_dir;
        bounce += 1;
        acc_len = total_len;
      }
    }

    if (terminal) {
      // the terminal color through the folded clamps (fold_resolve)
      const float att = term_af > 0.0f
                            ? 1.0f / (1.0f + term_af * total_len) : 1.0f;
      for (int c = 0; c < 3; ++c) {
        const bool dead_t = dead[c] || ((term[c] != term[c]) && outer);
        const float L = dead_t ? 0.0f : nan_min(A[c] * term[c], B[c]);
        acc[c] = acc[c] + L * att;
        A[c] = 1.0f;
        B[c] = CUDART_INF_F;
        dead[c] = false;
      }
      outer = false;
      bounce = 0;
      acc_len = 0.0f;
      ++sample;
      if (sample < sample_end) {
        fresh = true;
      } else {   // the pixel is done
        out_accum[3 * pix] = acc[0];
        out_accum[3 * pix + 1] = acc[1];
        out_accum[3 * pix + 2] = acc[2];
        out_segments[pix] = segments;
        pix = -1;
      }
    }
  }
  sweeps = __reduce_add_sync(kFull, sweeps);
  if (lane == 0) {
    atomicAdd(work + kWorkIterations, iterations);
    atomicAdd(work + kWorkSweeps, static_cast<unsigned long long>(sweeps));
    atomicAdd(work + kWorkWarpSweeps, warp_sweeps);
  }
}

// The persistent grid for n_pix pixels on the current device: the blocks
// of one instantiation that stay resident on one SM (computed once per
// device) times the SMs, but no more blocks than the pixels fill.
template <bool kNormalMaps>
cudaError_t resident_grid(long long n_pix, int* blocks, int* per_sm) {
  constexpr int kMaxDevices = 64;
  static int occupancy[kMaxDevices] = {};   // 0: not computed yet
  static int sms[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (occupancy[dev] == 0) {
    int n = 0, s = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, k5_render<kNormalMaps>, kThreads, 0);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&s, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    sms[dev] = s;
    occupancy[dev] = n;
  }
  const long long fill = (n_pix + kThreads - 1) / kThreads;
  *per_sm = occupancy[dev];
  *blocks = static_cast<int>(
      fill < static_cast<long long>(occupancy[dev]) * sms[dev]
          ? fill : static_cast<long long>(occupancy[dev]) * sms[dev]);
  return cudaSuccess;
}

}  // namespace

// work: 4 int64 counters, zeroed (kWork*); grid (host): receives the
// launch's blocks and the blocks per SM it was sized from; frame: the (P, 8)
// planar tangent frames, read where flags has kFlagNormalMaps
extern "C" int k5_render_launch(
    const float* cam, const float* sph, int n_sph, const float* pln, int n_pl,
    const float* frame, const float* mats, int n_mat, const float* tex_attr,
    int n_tex, const float* texels, int n_texels, const float* lights,
    int n_light,
    const float* msph, const float* mpln, const int* msph_off,
    const int* mpln_off, const float* med, const float* mbox, int n_media,
    int width, int height, int sample_start, int n_samples, int max_depth,
    int seed, int flags, float* out_accum, int* out_segments,
    unsigned long long* work, int* grid, void* stream) {
  const long long n_pix = static_cast<long long>(width) * height;
  if (n_pix > 0 && n_samples > 0) {
    const bool maps = (flags & kFlagNormalMaps) != 0;
    const cudaError_t err =
        maps ? resident_grid<true>(n_pix, &grid[0], &grid[1])
             : resident_grid<false>(n_pix, &grid[0], &grid[1]);
    if (err != cudaSuccess) return static_cast<int>(err);
    Scene sc;
    sc.cam = cam;
    sc.sph = reinterpret_cast<const float4*>(sph);
    sc.n_sph = n_sph;
    sc.pln = reinterpret_cast<const float4*>(pln);
    sc.n_pl = n_pl;
    sc.mats = mats;
    sc.n_mat = n_mat;
    sc.tex_attr = tex_attr;
    sc.n_tex = n_tex;
    sc.texels = texels;
    sc.n_texels = n_texels;
    sc.lights = lights;
    sc.n_light = n_light;
    sc.msph = reinterpret_cast<const float4*>(msph);
    sc.mpln = reinterpret_cast<const float4*>(mpln);
    sc.msph_off = msph_off;
    sc.mpln_off = mpln_off;
    sc.med = med;
    sc.mbox = reinterpret_cast<const float4*>(mbox);
    sc.n_media = n_media;
    sc.flags = flags;
    const float4* fr = reinterpret_cast<const float4*>(frame);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const uint32_t s = static_cast<uint32_t>(seed);
    if (maps)
      k5_render<true><<<grid[0], kThreads, 0, st>>>(
          sc, fr, width, height, sample_start, n_samples, max_depth, s,
          out_accum, out_segments, work);
    else
      k5_render<false><<<grid[0], kThreads, 0, st>>>(
          sc, fr, width, height, sample_start, n_samples, max_depth, s,
          out_accum, out_segments, work);
  }
  return static_cast<int>(cudaGetLastError());
}
