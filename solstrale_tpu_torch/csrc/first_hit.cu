// The first hit's kernels: CR (camera_rays), the jittered thin-lens camera
// rays of a list of pixel ids, and FH (first_hit_shade), the shading at
// depth 0 that the aux planes and the debug shaders read; and their
// reverses, CRB (camera_rays_backward) and FHB (first_hit_backward), the
// backwards of ops/first_hit.py's autograd Functions.
//
// Replace what XLA fuses in the JAX package's forward renderer
// (solstrale_tpu/renderer/integrator.py): camera_rays :401 (two PCG4D draws
// and the thin-lens ray) and first_hit_aux :515, shade_albedo :538,
// shade_normal :543 and shade_simple :556 (the hit attributes, the blend
// walks, the albedo texel and the shading normal through the normal map,
// each selected against the background on a miss), and their transposes
// under jax.grad. The port's plain versions (renderer/integrator.py:
// camera_rays_plain, first_hit_aux_plain, shade_albedo_plain,
// shade_normal_plain, shade_simple_plain; ops/first_hit.py:
// camera_rays_backward_plain, first_hit_backward_plain) run them as chains
// of torch ops, a draw-kernel launch for each draw, over every pixel of
// the image.
//
// Every draw is computed in registers (hit::uniform4). The device
// functions are S1's and S2's (shade.cuh: camera_ray, decode_hit_values,
// hit_attrs, blend_walk, normal_mapped, sample_texture), compiled with
// -fmad=false, so the kernels return their plain versions' values bit for
// bit on the card (the backwards' sums, added by atomics in another order,
// to their rounding). The plain versions compute every branch of every lane
// and select; the kernels compute the branch a lane takes and only the
// planes asked for.
//
// What bounds them: bytes. CR reads a lane's pixel id (and its sample,
// where that is a lane array) and writes its ray, 24 bytes, one thread a
// lane, each ray component a coalesced row store. FH reads a lane's t, and
// on a hit its (kind, idx), ray (24 bytes) and pixel id, its attribute row
// (112 bytes for a planar prim, shared by the lanes that hit it), a
// material row, the albedo texel and the normal-map texel, and writes up
// to three (R, 3) planes. Both run at 1080p over 2,073,600 lanes, many
// waves. FH's lane is a chain of dependent loads (t, idx, the row, the
// texels), so its design keeps loads in flight and spends nothing per lane
// beyond them: a persistent grid (first_grid: the blocks that stay
// resident), each block staging the small tables (camera, materials,
// texture attributes) in shared memory once, as S1 does, and each thread
// walking its lanes with the next lane's inputs loaded while this lane
// waits on its texels. CRB reads what CR reads and the rays' gradients;
// FHB what FH reads and the planes' gradients, and writes the rays'
// gradients and its sums. Both are simple: one thread a lane (CRB's
// threads a grid of lanes apart), their sums taken in the warp or the
// block before one atomic add.
#include <cstdint>

#include "hit.cuh"
#include "shade.cuh"

namespace {

using namespace shade;

constexpr int kCamThreads = 256;
constexpr int kFirstThreads = 256;
// the most bytes of small tables FH stages (ops.step.STAGE_MAX_BYTES)
constexpr int kMaxStageBytes = 12288;

// integrator.SHADER_*: the debug shader FH writes into its color plane
constexpr int SHADER_ALBEDO = 1, SHADER_NORMAL = 2, SHADER_SIMPLE = 3;

struct Cam {
  Scene sc;                      // cam
  const long long* pixel;        // (R,) pixel ids
  hit::Counter sample, seed;
  float* out;                    // (6, R): o0 o1 o2 d0 d1 d2
  long long n;
  int width, height;
};

// CR: integrator.camera_rays_plain, one thread a pixel id
__global__ void __launch_bounds__(kCamThreads) camera_rays(const Cam a) {
  const long long i = static_cast<long long>(blockIdx.x) * kCamThreads +
                      threadIdx.x;
  if (i >= a.n) return;
  V3 o, d;
  camera_ray(a.sc, a.pixel[i], static_cast<int>(a.sample.at(i)),
             a.seed.at(i), a.width, a.height, &o, &d);
  a.out[i] = o.x;
  a.out[a.n + i] = o.y;
  a.out[2 * a.n + i] = o.z;
  a.out[3 * a.n + i] = d.x;
  a.out[4 * a.n + i] = d.y;
  a.out[5 * a.n + i] = d.z;
}

struct First {
  Scene sc;                        // cam mats textures (lights: staged
                                   // with the rest, not read), flags
  const float* __restrict__ sph;   // (S, 8) sph_attr
  int n_sph;
  const float* __restrict__ pln;   // (P, 28) pl_attr
  int n_pl;
  int n_q;                         // quads: the planar rows before triangles
  const int* __restrict__ pl_row;  // (P,) K1's slot -> its pln row
  const float* small;              // the packed small tables sc points into
  int stage_floats;                // staged in shared memory (0: none)
  const int* __restrict__ med_mat; // (M,) phase materials
  int n_media;
  const float* t;
  const int* kind;                 // null: idx holds K1's planar slot
  const int* idx;
  const float* o[3];
  const float* d[3];
  hit::Counter pixel, sample, seed;
  float* color;                    // (R, 3) the debug shader's, or null
  float* albedo;                   // (R, 3) the aux albedo, or null
  float* normal;                   // (R, 3) the aux normal, or null
  int shader;                      // SHADER_*: the color plane's shader
  long long n;
};

// A lane's inputs, loaded a grid's lanes ahead of its shading (load_in):
// its t and, on a hit, its (kind, idx), its ray and its three draw counters
struct In {
  float t;
  int kind, idx;
  V3 o, d;
  uint32_t pix, smp, seed;
};

// Lane i's t (NaN past the end: no loads, no stores)
__device__ __forceinline__ float lane_t(const First& a, long long i) {
  return i < a.n ? a.t[i] : CUDART_NAN_F;
}

// Lane i's inputs with its t already loaded: a miss reads only t
__device__ __forceinline__ In load_in(const First& a, long long i, float t) {
  In x = {t, 0, 0, v3(0.0f, 0.0f, 0.0f), v3(0.0f, 0.0f, 0.0f), 0u, 0u, 0u};
  if (isfinite(t)) {
    if (a.kind != nullptr) x.kind = a.kind[i];
    x.idx = a.idx[i];
    x.o = v3(a.o[0][i], a.o[1][i], a.o[2][i]);
    x.d = v3(a.d[0][i], a.d[1][i], a.d[2][i]);
    x.pix = a.pixel.at(i);
    x.smp = a.sample.at(i);
    x.seed = a.seed.at(i);
  }
  return x;
}

// One lane of FH at depth 0 (integrator.first_hit_aux_plain and the debug
// shaders' plain versions), lane i from its inputs x:
//   albedo = hit ? (light ? (front ? texel : 0) : texel) : bg
//   normal = hit ? shading normal : 0
//   color  = albedo (SHADER_ALBEDO), hit ? shading normal : bg
//            (SHADER_NORMAL), or hit ? (light ? (front ? texel : 0) :
//            texel * ((n0 * 1 + n1 * 1 + n2 * -1) * 0.5 + 0.75)) : bg
//            (SHADER_SIMPLE)
// with the material of the blend walk on P_BLEND_SCATTER for the texel and
// the light test, and the normal map of the walk on P_BLEND_NORMAL. Once
// the hit's attributes are in, it loads lane j's inputs (t_next its t) into
// ``next``, so that they are in flight while this lane waits on its texels.
__device__ __forceinline__ void first_lane(const First& a, const Scene& sc,
                                           const In& x, long long i,
                                           long long j, float t_next,
                                           In* next) {
  const float* bg = sc.cam + 19;
  float alb[3] = {bg[0], bg[1], bg[2]};
  float nrm[3] = {0.0f, 0.0f, 0.0f};
  float col[3] = {bg[0], bg[1], bg[2]};
  const bool hit = isfinite(x.t);
  Attrs h;
  if (hit) {
    int kind, idx, slot;
    decode_hit_values(a.kind != nullptr, x.kind, x.idx, a.pl_row, a.n_q,
                      a.n_pl, &kind, &idx, &slot);
    const V3 point = v3(x.o.x + x.d.x * x.t, x.o.y + x.d.y * x.t,
                        x.o.z + x.d.z * x.t);
    h = hit_attrs(sc.flags, a.sph, a.n_sph, a.pln, a.n_pl, a.med_mat,
                  a.n_media, kind, idx, slot, point, x.d, x.pix, x.smp, 0u,
                  x.seed);
  }
  *next = load_in(a, j, t_next);
  if (hit) {
    const bool want_alb = a.albedo != nullptr ||
                          (a.color != nullptr && a.shader != SHADER_NORMAL);
    const bool want_n = a.normal != nullptr ||
                        (a.color != nullptr && a.shader != SHADER_ALBEDO);
    float tex[3] = {0.0f, 0.0f, 0.0f};
    bool light = false;
    if (want_alb) {
      int eff = h.mat;
      if (sc.flags & kFlagBlend)
        eff = blend_walk(sc, eff, uniform4(x.pix, x.smp, 0u, P_BLEND_SCATTER,
                                           x.seed));
      const MatRow row = mat_row(sc, eff);
      const V3 t = sample_texture(sc, row.albedo_tex, h.u, h.v);
      tex[0] = t.x; tex[1] = t.y; tex[2] = t.z;
      light = row.kind == DIFFUSE_LIGHT;
      for (int c = 0; c < 3; ++c)
        alb[c] = light ? (h.front ? tex[c] : 0.0f) : tex[c];
    }
    V3 s_normal = h.normal;
    if (want_n && (sc.flags & kFlagNormalMaps)) {
      const int eff_n =
          (sc.flags & kFlagBlend)
              ? blend_walk(sc, h.mat, uniform4(x.pix, x.smp, 0u,
                                               P_BLEND_NORMAL, x.seed))
              : h.mat;
      s_normal = normal_mapped(sc, h, eff_n);
    }
    nrm[0] = s_normal.x; nrm[1] = s_normal.y; nrm[2] = s_normal.z;
    if (a.shader == SHADER_ALBEDO) {
      for (int c = 0; c < 3; ++c) col[c] = alb[c];
    } else if (a.shader == SHADER_NORMAL) {
      for (int c = 0; c < 3; ++c) col[c] = nrm[c];
    } else if (a.shader == SHADER_SIMPLE) {
      const float f =
          (nrm[0] * 1.0f + nrm[1] * 1.0f + nrm[2] * -1.0f) * 0.5f + 0.75f;
      for (int c = 0; c < 3; ++c) col[c] = light ? alb[c] : tex[c] * f;
    }
  }
  for (int c = 0; c < 3; ++c) {
    if (a.albedo != nullptr) a.albedo[3 * i + c] = alb[c];
    if (a.normal != nullptr) a.normal[3 * i + c] = nrm[c];
    if (a.color != nullptr) a.color[3 * i + c] = col[c];
  }
}

// FH on a persistent grid (first_grid): with a.stage_floats > 0 each block
// stages the small tables in shared memory once (stage_small, as S1 does);
// then each thread walks its lanes a grid's threads apart, loading the
// next lane's inputs while it shades this one.
__global__ void __launch_bounds__(kFirstThreads)
    first_hit_shade(const First a) {
  extern __shared__ __align__(16) float4 staged[];
  Scene sc = a.sc;
  if (a.stage_floats > 0)
    stage_small(&sc, a.small, a.stage_floats, staged, kFirstThreads);
  const long long step = static_cast<long long>(gridDim.x) * kFirstThreads;
  long long i = static_cast<long long>(blockIdx.x) * kFirstThreads +
                threadIdx.x;
  In x = load_in(a, i, lane_t(a, i));
  for (; i < a.n; i += step) {
    In next;
    first_lane(a, sc, x, i, i + step, lane_t(a, i + step), &next);
    x = next;
  }
}

// FH's persistent grid on the current device: the blocks that stay
// resident on one SM with FH's most shared memory (kMaxStageBytes of
// staged tables; queried once a device, at its first launch), times the
// SMs, but no more blocks than the lanes fill. Also gives the blocks a SM
// and the SMs (per_sm, sms; either may be null).
cudaError_t first_grid(long long n, unsigned int* blocks, int* per_sm,
                       int* sms) {
  constexpr int kMaxDevices = 64;
  static int resident[kMaxDevices][2] = {};   // {0, 0}: not queried yet
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  int* r = resident[dev];
  if (r[0] == 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &r[0], first_hit_shade, kFirstThreads, kMaxStageBytes);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&r[1], cudaDevAttrMultiProcessorCount,
                                   dev);
    if (err != cudaSuccess) {
      r[0] = 0;
      return err;
    }
  }
  const long long fill = (n + kFirstThreads - 1) / kFirstThreads;
  const long long most = static_cast<long long>(r[0]) * r[1];
  *blocks = static_cast<unsigned int>(fill < most ? fill : most);
  if (per_sm != nullptr) *per_sm = r[0];
  if (sms != nullptr) *sms = r[1];
  return cudaSuccess;
}

// --- the reverse: CRB and FHB ------------------------------------------------

// CRB's block, and the most blocks it launches: each thread sums the lanes
// a grid apart, and each block adds its sums with one atomic a value
constexpr int kCamBackThreads = 256;
constexpr int kCamBackBlocks = 1024;
// the camera values CRB sums: origin, lower_left, horizontal, vertical, u,
// v (3 each) and lens_radius, camera_table's first 19
constexpr int kCamValues = 19;

struct CamBack {
  const float* cam;              // (24,) camera_table: the values read
  const long long* pixel;        // (R,) pixel ids
  hit::Counter sample, seed;
  const float* g;                // (6, R): the gradients of o0 .. d2
  float* g_cam;                  // (19,) the camera's gradients, added to
  long long n;
  int width, height;
};

// CRB: the reverse of camera_rays_plain (ops.first_hit's plain version
// camera_rays_backward_plain), the draws redrawn in registers as CR draws
// them (camera_ray). With g_off = g_o - g_d, a lane's products:
//   origin += g_off, lower_left += g_d, horizontal += g_d u,
//   vertical += g_d v, and where lens_radius > 0 (else no gradient: the
//   untaken side of torch.where): u += g_off rd0, v += g_off rd1,
//   lens_radius += (g_off . cam_u) disc0 + (g_off . cam_v) disc1,
// rd = disc * lens_radius. Each thread sums its lanes, each block its
// threads (warp shuffles, then the warps in order), and a block adds each
// of the 19 sums with one atomic.
__global__ void __launch_bounds__(kCamBackThreads)
    camera_rays_backward(const CamBack a) {
  __shared__ float warp_sum[kCamBackThreads / 32][kCamValues];
  float acc[kCamValues];
  for (int k = 0; k < kCamValues; ++k) acc[k] = 0.0f;
  const float* c = a.cam;
  const float lr = c[18];
  const bool use_lens = lr > 0.0f;
  const long long stride = static_cast<long long>(gridDim.x) *
                           kCamBackThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kCamBackThreads +
                     threadIdx.x;
       i < a.n; i += stride) {
    const long long pixel = a.pixel[i];
    const int sample = static_cast<int>(a.sample.at(i));
    const uint32_t seed = a.seed.at(i);
    const uint32_t pix = static_cast<uint32_t>(pixel);
    const float x = static_cast<float>(pixel % a.width);
    const float y = static_cast<float>(pixel / a.width);
    const float4 j = uniform4(pix, sample, 0, P_JITTER, seed);
    const float u = div_scalar(x + j.x, static_cast<float>(a.width - 1));
    const float v = div_scalar(y + j.y, static_cast<float>(a.height - 1));
    const float4 l = uniform4(pix, sample, 0, P_LENS, seed);
    const float r = sqrtf(l.x);
    const float phi = kTwoPi * l.y;
    const float disc0 = r * cosf(phi), disc1 = r * sinf(phi);
    const float rd0 = disc0 * lr, rd1 = disc1 * lr;
    float g_rd0 = 0.0f, g_rd1 = 0.0f;
    for (int k = 0; k < 3; ++k) {
      const float go = a.g[k * a.n + i], gd = a.g[(3 + k) * a.n + i];
      const float g_off = go - gd;
      acc[k] += g_off;
      acc[3 + k] += gd;
      acc[6 + k] += gd * u;
      acc[9 + k] += gd * v;
      if (use_lens) {
        acc[12 + k] += g_off * rd0;
        acc[15 + k] += g_off * rd1;
        g_rd0 += g_off * c[12 + k];
        g_rd1 += g_off * c[15 + k];
      }
    }
    if (use_lens) acc[18] += g_rd0 * disc0 + g_rd1 * disc1;
  }
  for (int k = 0; k < kCamValues; ++k)
    for (int off = 16; off > 0; off >>= 1)
      acc[k] += __shfl_down_sync(0xffffffffu, acc[k], off);
  if (threadIdx.x % 32 == 0)
    for (int k = 0; k < kCamValues; ++k)
      warp_sum[threadIdx.x / 32][k] = acc[k];
  __syncthreads();
  if (threadIdx.x < kCamValues) {
    float sum = 0.0f;
    for (int w = 0; w < kCamBackThreads / 32; ++w)
      sum += warp_sum[w][threadIdx.x];
    if (sum != 0.0f) atomicAdd(a.g_cam + threadIdx.x, sum);
  }
}

// FHB's block
constexpr int kBackThreads = 256;
// the columns of Solids.sph_attr (center 0:3) and Solids.pl_attr (unit
// normal 0:3, tangent 11:14, bitangent 14:17) FHB adds gradients to
constexpr int kSphAttrCols = 5, kPlAttrCols = 25;
constexpr int kPlNormal = 0, kPlTangent = 11, kPlBitangent = 14;

struct FirstBack {
  Scene sc;                        // mats tex_attr, texels: the arena
                                   // autograd holds, flags
  const float* __restrict__ sph;   // (S, 8) sph_attr padded (the values)
  int n_sph;
  const float* __restrict__ pln;   // (P, 28) pl_attr padded
  int n_pl;
  int n_q;
  const int* __restrict__ pl_row;
  const int* __restrict__ med_mat;
  int n_media;
  const float* t;
  const int* kind;                 // null: idx holds K1's planar slot
  const int* idx;
  const float* o[3];
  const float* d[3];
  hit::Counter pixel, sample, seed;
  const float* g_color;            // (R, 3) upstream gradients, or null
  const float* g_albedo;
  const float* g_normal;
  int shader;                      // the color plane's SHADER_*
  float* g_texels;                 // (N, 3) the arena's sums, or null
  float* g_bg;                     // (3,) the background's sums, or null
  float* g_o[3];                   // (R,) each, or null
  float* g_d[3];
  float* g_sph;                    // (S, 5) sph_attr's gradient, or null
  float* g_pl;                     // (P, 25) pl_attr's gradient, or null
  long long n;
};

// One lane's gradients: the albedo texel's (row r_alb) and the normal
// map's (r_nrm), the background's, the sphere row's center (sph_row) or
// the planar row's frame (pl_slot: normal, tangent, bitangent), and the
// ray's. A row of -1 takes nothing.
struct BackLane {
  int r_alb, r_nrm, sph_row, pl_slot;
  float g_alb[3], g_nrm[3], g_bg[3], g_c[3], g_pl[9], g_o[3], g_d[3];
};

__device__ __forceinline__ float load3(const float* p, long long i, int c) {
  return p != nullptr ? p[3 * i + c] : 0.0f;
}

// FHB, one lane: FH's forward at depth 0 recomputed from FH's inputs
// (first_lane; the texels read from the arena autograd holds), then its
// reverse as ops.first_hit.first_hit_backward_plain writes it out:
//
// - on a miss the background takes the albedo plane's and the color's
//   gradients (every debug shader shows it there);
// - on a hit the albedo texel takes the albedo plane's, the albedo
//   shader's and the simple shader's (times its factor; a light's front
//   face: the emission, its back face: 0) gradients, and the shading
//   normal the normal plane's, the normal shader's and the simple
//   shader's factor's (sum_c g_c texel_c, times 0.5 times (1, 1, -1));
// - through the normal map, s = T tn.x + B tn.y + N tn.z with tn the
//   texel times 2 less 1, the normal map's texel takes 2 (g_s . T, g_s .
//   B, g_s . N) and the frame g_s tn; without one the normal takes g_s;
// - a planar row's normal takes the face-forwarded normal's gradient
//   (negated on a back face), its tangent and bitangent theirs;
// - a sphere's frame is a function of n_raw = o + d t - center (t
//   detached): the unit normal (face-forwarded), the unit tangent of
//   (n_raw.z, 0, -n_raw.x) and the bitangent cross(n_raw, tangent); the
//   ray takes n_raw's gradient (d times t) and the center its negation;
// - a medium's frame is a draw and constants: nothing.
__device__ __forceinline__ void first_back_lane(const FirstBack& a,
                                                long long i, BackLane* b) {
  b->r_alb = b->r_nrm = b->sph_row = b->pl_slot = -1;
  for (int c = 0; c < 3; ++c)
    b->g_alb[c] = b->g_nrm[c] = b->g_bg[c] = b->g_c[c] = b->g_o[c] =
        b->g_d[c] = 0.0f;
  for (int k = 0; k < 9; ++k) b->g_pl[k] = 0.0f;
  if (i >= a.n) return;
  const Scene& sc = a.sc;
  const float t = a.t[i];
  float gc[3], ga[3], gn[3];
  for (int c = 0; c < 3; ++c) {
    gc[c] = load3(a.g_color, i, c);
    ga[c] = load3(a.g_albedo, i, c);
    gn[c] = load3(a.g_normal, i, c);
  }
  const bool has_c = a.g_color != nullptr;
  if (!isfinite(t)) {
    for (int c = 0; c < 3; ++c) b->g_bg[c] = ga[c] + gc[c];
    return;
  }
  int kind, idx, slot;
  decode_hit_values(a.kind != nullptr, a.kind != nullptr ? a.kind[i] : 0,
                    a.idx[i], a.pl_row, a.n_q, a.n_pl, &kind, &idx, &slot);
  const V3 o = v3(a.o[0][i], a.o[1][i], a.o[2][i]);
  const V3 d = v3(a.d[0][i], a.d[1][i], a.d[2][i]);
  const V3 point = v3(o.x + d.x * t, o.y + d.y * t, o.z + d.z * t);
  const uint32_t pix = a.pixel.at(i), smp = a.sample.at(i),
                 seed = a.seed.at(i);
  const Attrs h = hit_attrs(sc.flags, a.sph, a.n_sph, a.pln, a.n_pl,
                            a.med_mat, a.n_media, kind, idx, slot, point, d,
                            pix, smp, 0u, seed);
  const bool want_alb = a.g_albedo != nullptr ||
                        (has_c && a.shader != SHADER_NORMAL);
  const bool want_n = a.g_normal != nullptr ||
                      (has_c && a.shader != SHADER_ALBEDO);
  float tex[3] = {0.0f, 0.0f, 0.0f};
  bool light = false;
  if (want_alb) {
    int eff = h.mat;
    if (sc.flags & kFlagBlend)
      eff = blend_walk(sc, eff, uniform4(pix, smp, 0u, P_BLEND_SCATTER,
                                         seed));
    const MatRow row = mat_row(sc, eff);
    b->r_alb = texel_row(sc, row.albedo_tex, h.u, h.v);
    const float* px = sc.texels + 3 * static_cast<size_t>(b->r_alb);
    tex[0] = px[0]; tex[1] = px[1]; tex[2] = px[2];
    light = row.kind == DIFFUSE_LIGHT;
  }
  const V3 N = h.normal, T = h.tangent, B = h.bitangent;
  V3 s = N, tn = v3(0.0f, 0.0f, 0.0f);
  bool mapped = false;
  if (want_n && (sc.flags & kFlagNormalMaps)) {
    const int eff_n =
        (sc.flags & kFlagBlend)
            ? blend_walk(sc, h.mat, uniform4(pix, smp, 0u, P_BLEND_NORMAL,
                                             seed))
            : h.mat;
    const int ntex = normal_tex(sc, eff_n);
    if (ntex >= 0) {
      mapped = true;
      b->r_nrm = texel_row(sc, ntex, h.u, h.v);
      const float* px = sc.texels + 3 * static_cast<size_t>(b->r_nrm);
      tn = v3(px[0] * 2.0f - 1.0f, px[1] * 2.0f - 1.0f, px[2] * 2.0f - 1.0f);
      s = onb_local(T, B, N, tn);
    }
  }
  // the planes' gradients to the albedo texel and the shading normal
  const bool take = !light || h.front;
  float g_s[3];
  for (int c = 0; c < 3; ++c) {
    b->g_alb[c] = take ? ga[c] : 0.0f;
    g_s[c] = gn[c];
  }
  if (has_c && a.shader == SHADER_ALBEDO) {
    for (int c = 0; c < 3; ++c) b->g_alb[c] += take ? gc[c] : 0.0f;
  } else if (has_c && a.shader == SHADER_NORMAL) {
    for (int c = 0; c < 3; ++c) g_s[c] += gc[c];
  } else if (has_c && a.shader == SHADER_SIMPLE) {
    if (light) {
      for (int c = 0; c < 3; ++c) b->g_alb[c] += h.front ? gc[c] : 0.0f;
    } else {
      const float f = (s.x * 1.0f + s.y * 1.0f + s.z * -1.0f) * 0.5f + 0.75f;
      for (int c = 0; c < 3; ++c) b->g_alb[c] += gc[c] * f;
      const float g_f =
          (gc[0] * tex[0] + gc[1] * tex[1] + gc[2] * tex[2]) * 0.5f;
      g_s[0] += g_f;
      g_s[1] += g_f;
      g_s[2] += -g_f;
    }
  }
  // through the normal map to the frame and the map's texel
  const V3 gs = v3(g_s[0], g_s[1], g_s[2]);
  V3 gN = gs, gT = v3(0.0f, 0.0f, 0.0f), gB = gT;
  if (mapped) {
    gT = scale(gs, tn.x);
    gB = scale(gs, tn.y);
    gN = scale(gs, tn.z);
    b->g_nrm[0] = dot(gs, T) * 2.0f;
    b->g_nrm[1] = dot(gs, B) * 2.0f;
    b->g_nrm[2] = dot(gs, N) * 2.0f;
  }
  const V3 g_face = h.front ? gN : neg(gN);
  if (a.n_media > 0 && kind == KIND_MEDIUM) return;
  if ((sc.flags & kFlagSpheres) && kind == KIND_SPHERE) {
    int row = idx < 0 ? 0 : idx;
    row = row > a.n_sph - 1 ? a.n_sph - 1 : row;
    if (row < 0) return;
    const float* sp = a.sph + kSphCols * static_cast<size_t>(row);
    const V3 n_raw = sub(point, v3(sp[0], sp[1], sp[2]));
    const float l1 = sqrtf(dot(n_raw, n_raw));
    const float inv1 = 1.0f / l1;
    const V3 tr = v3(n_raw.z, 0.0f, -n_raw.x);
    const float l2 = sqrtf(dot(tr, tr));
    const float inv2 = 1.0f / l2;
    const V3 tng = scale(tr, inv2);
    // bitangent = cross(n_raw, tng)
    V3 g_a = cross(tng, gB);
    const V3 g_tan = add(gT, cross(gB, n_raw));
    // tng = tr * inv2, inv2 = 1 / sqrt(tr . tr)
    const float g_l2 = -dot(g_tan, tr) * (inv2 * inv2);
    const float g_s2 = g_l2 / (2.0f * l2);
    const V3 g_tr = add(scale(g_tan, inv2), scale(scale(tr, g_s2), 2.0f));
    g_a.z = g_a.z + g_tr.x;
    g_a.x = g_a.x + -g_tr.z;
    // unit normal = n_raw * inv1, inv1 = 1 / sqrt(n_raw . n_raw)
    const float g_l1 = -dot(g_face, n_raw) * (inv1 * inv1);
    const float g_s1 = g_l1 / (2.0f * l1);
    g_a = add(g_a, add(scale(g_face, inv1), scale(scale(n_raw, g_s1), 2.0f)));
    b->sph_row = row;
    b->g_c[0] = -g_a.x; b->g_c[1] = -g_a.y; b->g_c[2] = -g_a.z;
    b->g_o[0] = g_a.x; b->g_o[1] = g_a.y; b->g_o[2] = g_a.z;
    b->g_d[0] = g_a.x * t; b->g_d[1] = g_a.y * t; b->g_d[2] = g_a.z * t;
    return;
  }
  if (slot < 0 || slot >= a.n_pl) return;
  b->pl_slot = slot;
  const float g9[9] = {g_face.x, g_face.y, g_face.z, gT.x, gT.y, gT.z,
                       gB.x, gB.y, gB.z};
  for (int k = 0; k < 9; ++k) b->g_pl[k] = g9[k];
}

// v added to row ``row`` of the (., cols) table ``out`` at column ``col``
// by the lowest lane of each group of a warp's lanes that share the row
// (their sum, peer_sums); a row of -1 adds nothing. Every lane of the warp
// calls it.
template <int K>
__device__ __forceinline__ void add_rows(float* out, int cols, int col,
                                         int row, float (&v)[K]) {
  if (out == nullptr || !__any_sync(0xffffffffu, row >= 0)) return;
  const unsigned peers = __match_any_sync(0xffffffffu, row);
  peer_sums(peers, v);
  const unsigned lane = threadIdx.x % 32;
  if (row < 0 || (peers & ((1u << lane) - 1u)) != 0u) return;
  for (int k = 0; k < K; ++k)
    if (v[k] != 0.0f)
      atomicAdd(out + static_cast<size_t>(row) * cols + col + k, v[k]);
}

// FHB: first_back_lane, one thread a lane. The sums: each texel row,
// sphere row and planar row a warp's lanes share summed in the warp and
// added once (add_rows); the background's summed over the block (warp
// shuffles, then the warps in order) and added once a block with a miss.
__global__ void __launch_bounds__(kBackThreads)
    first_hit_backward(const FirstBack a) {
  __shared__ float warp_bg[kBackThreads / 32][3];
  const long long i = static_cast<long long>(blockIdx.x) * kBackThreads +
                      threadIdx.x;
  BackLane b;
  first_back_lane(a, i, &b);
  if (i < a.n)
    for (int c = 0; c < 3; ++c) {
      if (a.g_o[c] != nullptr) a.g_o[c][i] = b.g_o[c];
      if (a.g_d[c] != nullptr) a.g_d[c][i] = b.g_d[c];
    }
  add_rows(a.g_texels, 3, 0, b.r_alb, b.g_alb);
  add_rows(a.g_texels, 3, 0, b.r_nrm, b.g_nrm);
  add_rows(a.g_sph, kSphAttrCols, 0, b.sph_row, b.g_c);
  float g_frame[3][3] = {{b.g_pl[0], b.g_pl[1], b.g_pl[2]},
                         {b.g_pl[3], b.g_pl[4], b.g_pl[5]},
                         {b.g_pl[6], b.g_pl[7], b.g_pl[8]}};
  add_rows(a.g_pl, kPlAttrCols, kPlNormal, b.pl_slot, g_frame[0]);
  add_rows(a.g_pl, kPlAttrCols, kPlTangent, b.pl_slot, g_frame[1]);
  add_rows(a.g_pl, kPlAttrCols, kPlBitangent, b.pl_slot, g_frame[2]);
  if (a.g_bg == nullptr) return;
  const bool missed = b.g_bg[0] != 0.0f || b.g_bg[1] != 0.0f ||
                      b.g_bg[2] != 0.0f;
  if (!__syncthreads_or(missed)) return;
  for (int c = 0; c < 3; ++c) {
    float v = b.g_bg[c];
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
    if (threadIdx.x % 32 == 0) warp_bg[threadIdx.x / 32][c] = v;
  }
  __syncthreads();
  if (threadIdx.x < 3) {
    float sum = 0.0f;
    for (int w = 0; w < kBackThreads / 32; ++w)
      sum += warp_bg[w][threadIdx.x];
    if (sum != 0.0f) atomicAdd(a.g_bg + threadIdx.x, sum);
  }
}

hit::Counter counter_at(const void* p, const long long* v) {
  return hit::Counter{p, static_cast<int>(v[0]), static_cast<int>(v[1]),
                      static_cast<uint32_t>(v[2])};
}

}  // namespace

// CR's arguments, by index into p (pointers) and v (int64 values); the
// names match ops/first_hit.py's CAM_PTRS and CAM_INTS.
enum CamPtr { CP_CAM, CP_PIXEL, CP_SAMPLE, CP_SEED, CP_OUT, CP_COUNT };
enum CamInt {
  CV_N, CV_WIDTH, CV_HEIGHT, CV_SAMPLE, CV_SEED = CV_SAMPLE + 3,
  CV_COUNT = CV_SEED + 3
};

// FH's arguments, as ops/first_hit.py's FIRST_PTRS and FIRST_INTS name them
// (the ray: o0 o1 o2 d0 d1 d2).
enum FirstPtr {
  FHP_CAM, FHP_SPH, FHP_PLN, FHP_MATS, FHP_TEX_ATTR, FHP_TEXELS, FHP_LIGHTS,
  FHP_MED_MAT, FHP_PL_ROW, FHP_SMALL, FHP_T, FHP_KIND, FHP_IDX, FHP_RAY,
  FHP_PIXEL = FHP_RAY + 6, FHP_SAMPLE, FHP_SEED, FHP_COLOR, FHP_ALBEDO,
  FHP_NORMAL, FHP_COUNT
};
enum FirstInt {
  FHV_N, FHV_FLAGS, FHV_SHADER, FHV_N_SPH, FHV_N_PL, FHV_N_Q, FHV_N_MAT,
  FHV_N_TEX, FHV_N_TEXELS, FHV_N_MEDIA, FHV_STAGE, FHV_PIXEL,
  FHV_SAMPLE = FHV_PIXEL + 3, FHV_SEED = FHV_SAMPLE + 3,
  FHV_COUNT = FHV_SEED + 3
};

// CRB's arguments, as ops/first_hit.py's CAM_BACK_PTRS and CAM_INTS name
// them (CR's int64 values)
enum CamBackPtr {
  CBP_CAM, CBP_PIXEL, CBP_SAMPLE, CBP_SEED, CBP_G_RAY, CBP_G_CAM, CBP_COUNT
};

// FHB's arguments, as ops/first_hit.py's FIRST_BACK_PTRS and
// FIRST_BACK_INTS name them (the ray and its gradients: o0 o1 o2 d0 d1 d2)
enum BackPtr {
  FBP_SPH, FBP_PLN, FBP_MATS, FBP_TEX_ATTR, FBP_TEXELS, FBP_MED_MAT,
  FBP_PL_ROW, FBP_T, FBP_KIND, FBP_IDX, FBP_RAY, FBP_PIXEL = FBP_RAY + 6,
  FBP_SAMPLE, FBP_SEED, FBP_G_COLOR, FBP_G_ALBEDO, FBP_G_NORMAL,
  FBP_G_TEXELS, FBP_G_BG, FBP_G_RAY, FBP_G_SPH = FBP_G_RAY + 6, FBP_G_PLN,
  FBP_COUNT
};
enum BackInt {
  FBV_N, FBV_FLAGS, FBV_SHADER, FBV_N_SPH, FBV_N_PL, FBV_N_Q, FBV_N_MAT,
  FBV_N_TEX, FBV_N_TEXELS, FBV_N_MEDIA, FBV_PIXEL,
  FBV_SAMPLE = FBV_PIXEL + 3, FBV_SEED = FBV_SAMPLE + 3,
  FBV_COUNT = FBV_SEED + 3
};

extern "C" int camera_rays_launch(const void* const* p, const long long* v,
                                  void* stream) {
  const long long n = v[CV_N];
  if (n > 0) {
    Cam a;
    a.sc = Scene{};
    a.sc.cam = static_cast<const float*>(p[CP_CAM]);
    a.pixel = static_cast<const long long*>(p[CP_PIXEL]);
    a.sample = counter_at(p[CP_SAMPLE], v + CV_SAMPLE);
    a.seed = counter_at(p[CP_SEED], v + CV_SEED);
    a.out = static_cast<float*>(const_cast<void*>(p[CP_OUT]));
    a.n = n;
    a.width = static_cast<int>(v[CV_WIDTH]);
    a.height = static_cast<int>(v[CV_HEIGHT]);
    const long long blocks = (n + kCamThreads - 1) / kCamThreads;
    camera_rays<<<static_cast<unsigned int>(blocks), kCamThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int first_hit_launch(const void* const* p, const long long* v,
                                void* stream) {
  const long long n = v[FHV_N];
  if (n > 0) {
    First a;
    a.sc = Scene{};
    a.sc.cam = static_cast<const float*>(p[FHP_CAM]);
    a.sc.mats = static_cast<const float*>(p[FHP_MATS]);
    a.sc.n_mat = static_cast<int>(v[FHV_N_MAT]);
    a.sc.tex_attr = static_cast<const float*>(p[FHP_TEX_ATTR]);
    a.sc.n_tex = static_cast<int>(v[FHV_N_TEX]);
    a.sc.texels = static_cast<const float*>(p[FHP_TEXELS]);
    a.sc.n_texels = static_cast<int>(v[FHV_N_TEXELS]);
    a.sc.lights = static_cast<const float*>(p[FHP_LIGHTS]);
    a.sc.flags = static_cast<int>(v[FHV_FLAGS]);
    a.sph = static_cast<const float*>(p[FHP_SPH]);
    a.n_sph = static_cast<int>(v[FHV_N_SPH]);
    a.pln = static_cast<const float*>(p[FHP_PLN]);
    a.n_pl = static_cast<int>(v[FHV_N_PL]);
    a.n_q = static_cast<int>(v[FHV_N_Q]);
    a.pl_row = static_cast<const int*>(p[FHP_PL_ROW]);
    a.small = static_cast<const float*>(p[FHP_SMALL]);
    a.stage_floats = static_cast<int>(v[FHV_STAGE]);
    a.med_mat = static_cast<const int*>(p[FHP_MED_MAT]);
    a.n_media = static_cast<int>(v[FHV_N_MEDIA]);
    a.t = static_cast<const float*>(p[FHP_T]);
    a.kind = static_cast<const int*>(p[FHP_KIND]);
    a.idx = static_cast<const int*>(p[FHP_IDX]);
    for (int c = 0; c < 3; ++c) {
      a.o[c] = static_cast<const float*>(p[FHP_RAY + c]);
      a.d[c] = static_cast<const float*>(p[FHP_RAY + 3 + c]);
    }
    a.pixel = counter_at(p[FHP_PIXEL], v + FHV_PIXEL);
    a.sample = counter_at(p[FHP_SAMPLE], v + FHV_SAMPLE);
    a.seed = counter_at(p[FHP_SEED], v + FHV_SEED);
    a.color = static_cast<float*>(const_cast<void*>(p[FHP_COLOR]));
    a.albedo = static_cast<float*>(const_cast<void*>(p[FHP_ALBEDO]));
    a.normal = static_cast<float*>(const_cast<void*>(p[FHP_NORMAL]));
    a.shader = static_cast<int>(v[FHV_SHADER]);
    a.n = n;
    const int stage = a.stage_floats * static_cast<int>(sizeof(float));
    if (stage > kMaxStageBytes) return static_cast<int>(cudaErrorInvalidValue);
    unsigned int blocks = 0;
    const cudaError_t err = first_grid(n, &blocks, nullptr, nullptr);
    if (err != cudaSuccess) return static_cast<int>(err);
    first_hit_shade<<<blocks, kFirstThreads, stage,
                      static_cast<cudaStream_t>(stream)>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// FH's grid for n lanes on the current device: out = {blocks, blocks a
// SM, SMs} (the first call queries the device)
extern "C" int first_hit_grid(long long n, int* out) {
  unsigned int blocks = 0;
  const cudaError_t err = first_grid(n, &blocks, &out[1], &out[2]);
  out[0] = static_cast<int>(blocks);
  return static_cast<int>(err);
}

extern "C" int camera_rays_backward_launch(const void* const* p,
                                           const long long* v,
                                           void* stream) {
  const long long n = v[CV_N];
  if (n > 0) {
    CamBack a;
    a.cam = static_cast<const float*>(p[CBP_CAM]);
    a.pixel = static_cast<const long long*>(p[CBP_PIXEL]);
    a.sample = counter_at(p[CBP_SAMPLE], v + CV_SAMPLE);
    a.seed = counter_at(p[CBP_SEED], v + CV_SEED);
    a.g = static_cast<const float*>(p[CBP_G_RAY]);
    a.g_cam = static_cast<float*>(const_cast<void*>(p[CBP_G_CAM]));
    a.n = n;
    a.width = static_cast<int>(v[CV_WIDTH]);
    a.height = static_cast<int>(v[CV_HEIGHT]);
    const long long fill = (n + kCamBackThreads - 1) / kCamBackThreads;
    const long long blocks = fill < kCamBackBlocks ? fill : kCamBackBlocks;
    camera_rays_backward<<<static_cast<unsigned int>(blocks),
                           kCamBackThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int first_hit_backward_launch(const void* const* p,
                                         const long long* v, void* stream) {
  const long long n = v[FBV_N];
  if (n > 0) {
    FirstBack a;
    a.sc = Scene{};
    a.sc.mats = static_cast<const float*>(p[FBP_MATS]);
    a.sc.n_mat = static_cast<int>(v[FBV_N_MAT]);
    a.sc.tex_attr = static_cast<const float*>(p[FBP_TEX_ATTR]);
    a.sc.n_tex = static_cast<int>(v[FBV_N_TEX]);
    a.sc.texels = static_cast<const float*>(p[FBP_TEXELS]);
    a.sc.n_texels = static_cast<int>(v[FBV_N_TEXELS]);
    a.sc.flags = static_cast<int>(v[FBV_FLAGS]);
    a.sph = static_cast<const float*>(p[FBP_SPH]);
    a.n_sph = static_cast<int>(v[FBV_N_SPH]);
    a.pln = static_cast<const float*>(p[FBP_PLN]);
    a.n_pl = static_cast<int>(v[FBV_N_PL]);
    a.n_q = static_cast<int>(v[FBV_N_Q]);
    a.pl_row = static_cast<const int*>(p[FBP_PL_ROW]);
    a.med_mat = static_cast<const int*>(p[FBP_MED_MAT]);
    a.n_media = static_cast<int>(v[FBV_N_MEDIA]);
    a.t = static_cast<const float*>(p[FBP_T]);
    a.kind = static_cast<const int*>(p[FBP_KIND]);
    a.idx = static_cast<const int*>(p[FBP_IDX]);
    for (int c = 0; c < 3; ++c) {
      a.o[c] = static_cast<const float*>(p[FBP_RAY + c]);
      a.d[c] = static_cast<const float*>(p[FBP_RAY + 3 + c]);
      a.g_o[c] = static_cast<float*>(const_cast<void*>(p[FBP_G_RAY + c]));
      a.g_d[c] =
          static_cast<float*>(const_cast<void*>(p[FBP_G_RAY + 3 + c]));
    }
    a.pixel = counter_at(p[FBP_PIXEL], v + FBV_PIXEL);
    a.sample = counter_at(p[FBP_SAMPLE], v + FBV_SAMPLE);
    a.seed = counter_at(p[FBP_SEED], v + FBV_SEED);
    a.g_color = static_cast<const float*>(p[FBP_G_COLOR]);
    a.g_albedo = static_cast<const float*>(p[FBP_G_ALBEDO]);
    a.g_normal = static_cast<const float*>(p[FBP_G_NORMAL]);
    a.shader = static_cast<int>(v[FBV_SHADER]);
    a.g_texels = static_cast<float*>(const_cast<void*>(p[FBP_G_TEXELS]));
    a.g_bg = static_cast<float*>(const_cast<void*>(p[FBP_G_BG]));
    a.g_sph = static_cast<float*>(const_cast<void*>(p[FBP_G_SPH]));
    a.g_pl = static_cast<float*>(const_cast<void*>(p[FBP_G_PLN]));
    a.n = n;
    const long long blocks = (n + kBackThreads - 1) / kBackThreads;
    first_hit_backward<<<static_cast<unsigned int>(blocks), kBackThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
