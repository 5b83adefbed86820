// The first hit's kernels: CR (camera_rays), the jittered thin-lens camera
// rays of a list of pixel ids, and FH (first_hit_shade), the shading at
// depth 0 that the aux planes and the debug shaders read.
//
// Replace what XLA fuses in the JAX package's forward renderer
// (solstrale_tpu/renderer/integrator.py): camera_rays :401 (two PCG4D draws
// and the thin-lens ray) and first_hit_aux :515, shade_albedo :538,
// shade_normal :543 and shade_simple :556 (the hit attributes, the blend
// walks, the albedo texel and the shading normal through the normal map,
// each selected against the background on a miss). The port's plain
// versions (renderer/integrator.py: camera_rays_plain, first_hit_aux_plain,
// shade_albedo_plain, shade_normal_plain, shade_simple_plain) run them as
// chains of torch ops, a draw-kernel launch for each draw, over every pixel
// of the image.
//
// Every draw is computed in registers (hit::uniform4). The device
// functions are S1's and S2's (shade.cuh: camera_ray, decode_hit_values,
// hit_attrs, blend_walk, normal_mapped, sample_texture), compiled with
// -fmad=false, so both kernels return their plain versions' values bit for
// bit on the card. The plain versions compute every branch of every lane
// and select; FH computes the branch a lane takes and only the planes it is
// asked for.
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
// waits on its texels.
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
