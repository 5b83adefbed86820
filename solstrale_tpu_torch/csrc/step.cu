// The wavefront step's shading and regeneration: S1 (step_shade) and S2
// (step_regen), the body of renderer/integrator.py::_Wavefront.step around
// the scene-hit kernels (K1-K3 or K4); and S1's backward, S1B
// (step_shade_backward), the differentiable route's reverse of a bounce.
//
// Replaces the step body of the JAX package's one-program wavefront
// (solstrale_tpu/renderer/integrator.py:765-836, one_step inside
// trace_queued), which XLA fuses into a few fusions per step: the hit
// attributes, the material scatter with its draws, the clamp-fold, the
// accumulation store and the regeneration. The port's plain versions run the
// same step as ~700-1,300 torch kernels:
//
// - S1: integrator.shade_plain, everything path_step does after the scene
//   hit: full_hit_attributes (the planar and sphere rows of the Solids
//   tables, the medium overrides), scatter (the blend walk, the shading
//   normal with its normal map, the texture lookup, the 50/50 NEE mixture,
//   metal fuzz, dielectric), the terminal classification and the fold
//   (fold_resolve, fold_scatter, the reset of terminal lanes);
// - S2: integrator._Wavefront.regen_plain, the rest of the step: the
//   exclusive scan of the terminal flags, the finished colors into their
//   accumulation rows, the next queue positions and their camera rays
//   (parked lanes with a zero direction), the write-back of the pool, and
//   the segment and queue counters; with ``reset`` set, the pool's first
//   camera rays (_Wavefront.reset_plain).
//
// One thread a lane. Every draw is the counter hash computed in registers
// (hit::uniform4); no draw goes through memory. The formulas are the plain
// versions' expression for expression (shade.cuh; -fmad=false), so the
// kernels return their values bit for bit on the card; the plain versions
// run every branch for every lane and select, the kernels run the branch a
// lane takes (and S1's light pdf skips the divisions of a light the
// direction misses, whose term is 0 either way).
//
// S1B replaces the transpose of the bounce body that XLA fuses under
// jax.value_and_grad in the JAX package's inverse step
// (solstrale_tpu/renderer/integrator.py:364 bounce_step, differentiated by
// solstrale_tpu/diff/__init__.py:54-66), which the port ran as autograd
// through the torch composition. On the differentiable route S1 also
// writes a 16-byte record a lane (the albedo texel row, the pdf weight or
// the terminal path length, the attenuation and the branch flags with the
// attenuated emitter's material) and S1B reads it back with the fold's A
// and B, so the backward re-evaluates none of the shading.
//
// trace's bounce (solstrale_tpu/renderer/integrator.py:428-512, one fused
// scan body in the JAX package) is S1 in its carry form, step_shade_trace:
// it also takes each lane's carried color, keeps it on a lane that does
// not end, writes the terminal color on one that does, and parks the
// direction of a lane that does not go on, so no torch op of trace's runs
// between two bounces; S1B returns the carried color's gradient. The
// wavefront pool's form, step_shade, is compiled without the carry and the
// record.
//
// What bounds them. S1 reads a lane's ~100 bytes of state and hit, one
// attribute row (112 bytes for a planar prim) and a few material, texel
// and light rows, and writes ~80 bytes; its arithmetic (a few hundred
// flops and ~10 transcendentals, plus ~60 flops a light for the NEE pdf)
// is under the byte time at the card's f32 rate except with many lights.
// At the wavefront's widths what holds it back is latency: the launch must
// fit on the card in one wave, and each lane walks a chain of dependent
// loads (slot, row, material, texture, texel). So S1 is compiled to 64
// registers (8 blocks of 128 an SM: the wide pool's 1,024 blocks in one
// wave) by reading the fold only after the scatter (it is not live across
// the NEE block); K1's slot goes to its attribute row through one (P,)
// map; and a block stages the small tables (camera, materials, texture
// attributes, lights) in shared memory with cp.async. The lane state is
// structure-of-arrays, so a warp's loads and stores of it coalesce; the
// attribute tables are read through const __restrict__ pointers with no
// cap on their size (sponza's 262,092 planar rows). S2 reads ~30 bytes a
// lane and writes ~80 bytes for each lane that ends; it is latency too:
// its scan is one pass (decoupled look-back, no second launch), and its
// queue arithmetic has no 64-bit division. S1B reads at most 100 bytes a
// lane (record, fold, upstream gradients) and one texel row, and writes 24;
// it adds the arena's and the background's gradients into sums that one
// backward pass owns (ops.step.GradSums), so it zeroes nothing. The carry
// form adds 12 bytes a lane to each: S1 reads the carried color of a lane
// that does not end, S1B writes the carried color's gradient. Without
// its arena sums it runs at 1.2-1.4x its byte bound; with them, where each
// warp added its rows straight to the sums, it ran 5-10x, because most
// warps add to one hot row (a solid colour) and atomic adds to one address
// serialise (in the L2, by sector). So a warp first sums each row its lanes
// read (log2 steps), a block sums its warps' rows in a table in shared
// memory over all the lanes it takes (a resident grid of large blocks,
// each looping), and adds each row once. A lane whose record has no
// branch, the inverse step's parked lanes, passes its fold gradients
// through and does not read the fold.
//
// The wavefront passes its pool as both the input and the output of S1
// (the update is in place): a thread reads each array of its lane's state
// before it writes that array, and no thread reads another lane's. S2
// reads the queue head once a block; the block with the last ticket writes
// the new head after its look-back has seen every block's status word.
#include <cstdint>

#include "hit.cuh"
#include "shade.cuh"

namespace {

using namespace shade;

// S1's block and the blocks an SM it is compiled to keep resident
// (__launch_bounds__: 64 registers, no spills; chosen on the H100 by a
// sweep of block sizes and minimums, PERF.md)
constexpr int kShadeThreads = 128;
constexpr int kShadeMinBlocks = 8;
constexpr int kRegenThreads = 256;

// A lane's state in the pool's order: o, d, bounce, acc_len and the fold
// (A, B, dead, outer), one (R,) array each.
struct Lanes {
  float* o[3];
  float* d[3];
  int* bounce;
  float* acc_len;
  float* A[3];
  float* B[3];
  bool* dead[3];
  bool* outer;
};
constexpr int kLaneArrays = 18;

struct Shade {
  Scene sc;                        // cam mats textures lights, flags
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
  hit::Counter pixel, sample, seed;
  const bool* active;              // null: qpos < total_q
  const long long* qpos;
  long long total_q;
  Lanes in, out;
  float* color;                    // (R, 3)
  const float* carry;              // (R, 3) trace's carried color, or null
  bool* flag[6];                   // terminal miss capped emit scat is_pdf
  const float* bg;                 // (3,), or null: the camera table's
  int* rec;                        // (4, R) S1B's record, or null
  long long n;
  int max_depth;
};

// S1's record of a lane for its backward (S1B), four int32 rows of (4, R):
// the albedo texel row (-1 where the lane reads none), as f32 bits the
// scatter level's pdf weight prob_scat on a lane that scatters and the
// terminal path length term_acc on one whose emitter attenuates (else 0),
// and the terminal attenuation att, and the flag word below (ops/step.py's
// REC_* bits); on a lane whose emitter attenuates, the word's bits from
// kRecMatShift up hold its effective material's row
constexpr int kRecMiss = 1, kRecEmitFront = 2, kRecScat = 4, kRecPdf = 8,
              kRecTerminal = 16, kRecDeadT = 32, kRecDead = 256,
              kRecAtten = 2048, kRecMatShift = 12;
// the branch bits: a lane with none of them (and no texel row, and a zero
// pdf weight) shades nothing this bounce
constexpr int kRecBranch =
    kRecMiss | kRecEmitFront | kRecScat | kRecPdf | kRecTerminal;

// One lane of S1. The lane's state is read where it is first needed: the
// fold (A, B, dead, outer) only after the scatter, so it is not live across
// the NEE block. A lane reads each array of its own state before it writes
// that array, and no other lane's, so the update may be in place (the pool
// is both ``in`` and ``out``; they are not __restrict__).
//
// kTrace: trace's form (a bool active flag a lane, the carried color, the
// record where a.rec is set), else the wavefront pool's (a queue position
// a lane), compiled without either so that its registers stay as they were.
template <bool kTrace>
__device__ __forceinline__ void shade_lane(const Shade& a, const Scene& sc,
                                           long long i) {
  // --- the hit, its attribute row, the ray --------------------------------
  const float t = a.t[i];
  int kind, idx, slot;
  decode_hit(a.kind, a.idx, a.pl_row, a.n_q, a.n_pl, i, &kind, &idx, &slot);
  const V3 o = v3(a.in.o[0][i], a.in.o[1][i], a.in.o[2][i]);
  const V3 d = v3(a.in.d[0][i], a.in.d[1][i], a.in.d[2][i]);
  const int bounce = a.in.bounce[i];
  const float acc_len = a.in.acc_len[i];
  const bool active = kTrace ? a.active[i] : a.qpos[i] < a.total_q;
  const uint32_t pix = a.pixel.at(i), smp = a.sample.at(i),
                 seed = a.seed.at(i), bnc = static_cast<uint32_t>(bounce);

  // --- hit attributes (full_hit_attributes), on every lane ---------------
  const bool finite = isfinite(t);
  const bool miss = active && !finite;
  const float t_safe = finite ? t : 0.0f;
  const V3 point = v3(o.x + d.x * t_safe, o.y + d.y * t_safe,
                      o.z + d.z * t_safe);
  const Attrs h = hit_attrs(sc.flags, a.sph, a.n_sph, a.pln, a.n_pl,
                            a.med_mat, a.n_media, kind, idx, slot, point, d,
                            pix, smp, bnc, seed);

  // --- material and the terminal classification --------------------------
  int eff = h.mat;
  if (sc.flags & kFlagBlend)
    eff = blend_walk(sc, eff, uniform4(pix, smp, bnc, P_BLEND_SCATTER, seed));
  const MatRow row = mat_row(sc, eff);
  const bool is_light = row.kind == DIFFUSE_LIGHT;
  const bool is_iso = row.kind == ISOTROPIC;
  const bool is_pdf = row.kind == LAMBERTIAN || is_iso;
  const bool capped = active && finite && bounce >= a.max_depth;
  const bool emit = active && finite && !capped && is_light;
  const bool scat = active && finite && !capped && !is_light;
  const bool terminal = miss || capped || emit;
  const float total_len = acc_len + t_safe;
  const int alb_row =
      (emit || scat) ? texel_row(sc, row.albedo_tex, h.u, h.v) : -1;
  float alb[3] = {0.0f, 0.0f, 0.0f};
  if (alb_row >= 0)
    for (int c = 0; c < 3; ++c)
      alb[c] = sc.texels[3 * static_cast<size_t>(alb_row) + c];

  // the ray's and the path length's next state (o and acc_len are not read
  // again)
  const V3 o2 = scat ? point : o;
  a.out.o[0][i] = o2.x; a.out.o[1][i] = o2.y; a.out.o[2][i] = o2.z;
  a.out.bounce[i] = scat ? bounce + 1 : bounce;
  a.out.acc_len[i] = scat ? total_len : acc_len;

  // --- scatter (material/mod.rs), on lanes that go on --------------------
  V3 new_dir = d;
  float prob = 1.0f;
  if (scat) {
    V3 s_normal = h.normal;
    if (sc.flags & kFlagNormalMaps) {
      // shading_normal_of, with the material the normal draw's blend walk
      // picks
      int eff_n = eff;
      if (sc.flags & kFlagBlend)
        eff_n = blend_walk(sc, h.mat,
                           uniform4(pix, smp, bnc, P_BLEND_NORMAL, seed));
      s_normal = normal_mapped(sc, h, eff_n);
    }
    if (row.kind == METAL) {
      // metal (material/mod.rs:239-249)
      const float4 f = uniform4(pix, smp, bnc, P_FUZZ, seed);
      const V3 reflected = reflect(unit(d), s_normal);
      new_dir = add(reflected, scale(in_unit_sphere(f.x, f.y, f.z),
                                     row.fuzz));
    } else if (row.kind == DIELECTRIC) {
      // dielectric (material/mod.rs:279-316)
      const float ior = row.ior;
      const float rr = h.front ? 1.0f / ior : ior;
      const V3 udir = unit(d);
      const float cos_t = clamp_max(dot(neg(udir), s_normal), 1.0f);
      const float sin_t = sqrtf(clamp_min(1.0f - cos_t * cos_t, 0.0f));
      const bool cannot = rr * sin_t > 1.0f;
      float r0 = (1.0f - rr) / (1.0f + rr);
      r0 = r0 * r0;
      const float q = 1.0f - cos_t;
      const float q2 = q * q;
      const float reflectance = r0 + (1.0f - r0) * (q * (q2 * q2));
      const float u_d = uniform4(pix, smp, bnc, P_DIELECTRIC, seed).x;
      new_dir = (cannot || reflectance > u_d) ? reflect(udir, s_normal)
                                              : refract(udir, s_normal, rr);
    } else {
      // pdf-mixture scatter (material/mod.rs:191-207, 396-410)
      const float4 rc = uniform4(pix, smp, bnc, P_COSINE, seed);
      V3 ct, cb, cn;
      onb_from_w(s_normal, &ct, &cb, &cn);
      const V3 bsdf_dir =
          is_iso ? unit_vector(rc.x, rc.y)
                 : onb_local(ct, cb, cn, cosine_direction(rc.x, rc.y));
      const float u_pick = uniform4(pix, smp, bnc, P_LIGHT_PICK, seed).x;
      int pick = static_cast<int>(u_pick * static_cast<float>(sc.n_light));
      pick = pick > sc.n_light - 1 ? sc.n_light - 1 : pick;
      const float4 l = uniform4(pix, smp, bnc, P_LIGHT_SAMPLE, seed);
      const V3 light_dir = sample_light(sc, point, pick, l.x, l.y);
      const float u_coin = uniform4(pix, smp, bnc, P_MIX_COIN, seed).x;
      const V3 pdf_dir = sel(u_coin < 0.5f, light_dir, bsdf_dir);
      const float light_val = light_pdf_mean<true>(sc, point, pdf_dir);
      const V3 unit_pdf_dir = unit(pdf_dir);
      const float cos_value = div_scalar(
          clamp_min(dot(unit_pdf_dir, unit(s_normal)), 0.0f), kPi);
      const float bsdf_val = is_iso ? kSphereValue : cos_value;
      const float mix_val = 0.5f * light_val + 0.5f * bsdf_val;
      const float cos_sc = dot(s_normal, unit_pdf_dir);
      const float lamb_sc = cos_sc < 0.0f ? 0.0f : div_scalar(cos_sc, kPi);
      const float scat_pdf = is_iso ? kSphereValue : lamb_sc;
      if (is_pdf) prob = scat_pdf / mix_val;
      new_dir = pdf_dir;
    }
  }
  // trace's carry form parks the direction of a lane that does not go on
  // (alive' = alive && !terminal, which is scat)
  const V3 d2 = scat ? new_dir
                     : (kTrace && a.carry != nullptr ? v3(0.0f, 0.0f, 0.0f)
                                                     : d);
  a.out.d[0][i] = d2.x; a.out.d[1][i] = d2.y; a.out.d[2][i] = d2.z;

  // --- the fold: the terminal color through the folded clamps
  // (fold_resolve), then this bounce's scatter level (fold_scatter) and the
  // reset of terminal lanes -----------------------------------------------
  float A[3], B[3];
  bool dead[3];
  for (int c = 0; c < 3; ++c) {
    A[c] = a.in.A[c][i];
    B[c] = a.in.B[c][i];
    dead[c] = a.in.dead[c][i];
  }
  const bool outer = a.in.outer[i];
  const float* bg = a.bg != nullptr ? a.bg : sc.cam + 19;
  const float term_af = emit ? row.atten : 0.0f;
  const float term_acc = emit ? total_len : 0.0f;
  const bool atten = term_af > 0.0f;
  const float att = atten ? 1.0f / (1.0f + term_af * term_acc) : 1.0f;
  int rec = 0;
  if (kTrace)
    rec = (miss ? kRecMiss : 0) | (emit && h.front ? kRecEmitFront : 0) |
          (scat ? kRecScat : 0) | (terminal ? kRecTerminal : 0) |
          (atten ? kRecAtten | (eff << kRecMatShift) : 0);
  for (int c = 0; c < 3; ++c) {
    const float term = miss ? bg[c] : (emit && h.front ? alb[c] : 0.0f);
    const bool dead_t = dead[c] || ((term != term) && outer);
    if (dead_t) rec |= kRecDeadT << c;
    const float tc = dead_t ? 0.0f : term;
    const float L = dead_t ? 0.0f : nan_min(A[c] * tc, B[c]);
    // the carry form keeps the carried color of a lane that does not end
    a.color[3 * i + c] = !kTrace || terminal || a.carry == nullptr
                             ? L * att : a.carry[3 * i + c];
  }
  const bool pdf_lvl = scat && is_pdf;
  const bool basic_lvl = scat && !is_pdf;
  const float prob_scat = scat ? prob : 0.0f;
  for (int c = 0; c < 3; ++c) {
    const float ap = alb[c] * prob;
    const bool nan_a = ap != ap;
    if (pdf_lvl) B[c] = nan_min(B[c], 3.0f * A[c]);
    dead[c] = dead[c] || (pdf_lvl && nan_a) || (basic_lvl && nan_a && outer);
    if (dead[c]) rec |= kRecDead << c;
    if (scat) A[c] = A[c] * (alb[c] * (dead[c] ? 0.0f : prob_scat));
    if (terminal) {
      A[c] = 1.0f;
      B[c] = CUDART_INF_F;
      dead[c] = false;
    }
    a.out.A[c][i] = A[c];
    a.out.B[c][i] = B[c];
    a.out.dead[c][i] = dead[c];
  }
  a.out.outer[i] = (outer || pdf_lvl) && !terminal;

  const bool flags[6] = {terminal, miss, capped, emit, scat, is_pdf};
  for (int k = 0; k < 6; ++k)
    if (a.flag[k] != nullptr) a.flag[k][i] = flags[k];
  if (kTrace && a.rec != nullptr) {
    a.rec[i] = alb_row;
    a.rec[a.n + i] =
        __float_as_int(scat ? prob_scat : (atten ? term_acc : 0.0f));
    a.rec[2 * a.n + i] = __float_as_int(att);
    a.rec[3 * a.n + i] = rec | (pdf_lvl ? kRecPdf : 0);
  }
}

// S1: with a.stage_floats > 0 the block first stages the small tables in
// shared memory (stage_small), so shade.cuh's lookups (and the light loop
// of every NEE lane) read shared memory; then each thread shades its lane.
template <bool kTrace>
__device__ __forceinline__ void shade_block(const Shade& a) {
  extern __shared__ __align__(16) float4 staged[];
  Scene sc = a.sc;
  if (a.stage_floats > 0)
    stage_small(&sc, a.small, a.stage_floats, staged, kShadeThreads);
  const long long i = static_cast<long long>(blockIdx.x) * kShadeThreads +
                      threadIdx.x;
  if (i < a.n) shade_lane<kTrace>(a, sc, i);
}

// S1 in the wavefront pool's form (trace_queued's step)
__global__ void __launch_bounds__(kShadeThreads, kShadeMinBlocks)
    step_shade(const Shade a) {
  shade_block<false>(a);
}

// S1 in trace's form: the carry, and the record for S1B
__global__ void __launch_bounds__(kShadeThreads, kShadeMinBlocks)
    step_shade_trace(const Shade a) {
  shade_block<true>(a);
}

// S1B's arguments: S1's record and its inputs that the backward reads (the
// fold's A and B, the arena, the background), the upstream gradients of
// S1's differentiable outputs (color, the fold's A' and B'; a null pointer
// is a zero gradient), the sums it adds the arena's, the background's and
// the materials' attenuation gradients into, and the gradients it writes
// of the carried color and the fold (a null pointer: not wanted).
struct ShadeBack {
  const int* rec;                  // (4, R)
  const float* texels;             // (N, 3) the arena
  const float* bg;                 // (3,)
  const float* g_color;            // (R, 3)
  float* g_texels;                 // (N, 3) the pass's sums, added into
  float* g_bg;                     // (3,) the pass's sums, added into
  float* g_mats;                   // (M, 9) the pass's sums of the
                                   // material table, added into column 5
  float* g_carry;                  // (R, 3) the carried color's
  const float* A[3];
  const float* B[3];
  const float* g_A_out[3];
  const float* g_B_out[3];
  float* g_A[3];
  float* g_B[3];
  long long n;
};

// torch.minimum's backward (derivatives.yaml): the gradient g of min(x, y)
// to each side, halved at a tie, whole to both sides where either is NaN
__device__ __forceinline__ void min_grads(float x, float y, float g,
                                          float* gx, float* gy) {
  const float h = x == y ? g * 0.5f : g;
  *gx = x > y ? 0.0f : h;
  *gy = x < y ? 0.0f : h;
}

// S1B's block table of texel-row sums in shared memory: kBackSlots rows
// (open addressing, a multiplicative hash, kBackProbes probes); a row that
// finds no slot is added to the pass's sums directly
constexpr int kBackSlotBits = 10;
constexpr int kBackSlots = 1 << kBackSlotBits;
constexpr int kBackProbes = 8;
// S1B's block, and the blocks it is compiled to keep resident on a SM (32
// registers a thread, no spills without the materials' sums; at 40
// registers, a block stays alone on its SM and the parked lanes' bounces
// stream slower). Large blocks add
// each hot texel row to the pass's sums fewer times; the inverse step runs
// S1B at 106,400 lanes and more, where 1,024 threads took 0.55-0.92x the
// time of 256 (PERF.md)
constexpr int kBackThreads = 1024;
constexpr int kBackMinBlocks = 2;
struct RowTable {
  int row[kBackSlots];
  float sum[kBackSlots][3];
};

// v added to row ``row``'s slot of the block's table, or to the pass's
// sums ``g_texels`` where the probes find no slot for it
__device__ __forceinline__ void add_row(RowTable& t, float* g_texels, int row,
                                        const float v[3]) {
  if (v[0] == 0.0f && v[1] == 0.0f && v[2] == 0.0f) return;
  unsigned h = (static_cast<unsigned>(row) * 2654435761u) >>
               (32 - kBackSlotBits);
  for (int p = 0; p < kBackProbes; ++p) {
    const int k = atomicCAS(&t.row[h], -1, row);
    if (k == -1 || k == row) {
      for (int c = 0; c < 3; ++c)
        if (v[c] != 0.0f) atomicAdd(&t.sum[h][c], v[c]);
      return;
    }
    h = (h + 1u) & (kBackSlots - 1);
  }
  for (int c = 0; c < 3; ++c)
    if (v[c] != 0.0f)
      atomicAdd(g_texels + 3 * static_cast<size_t>(row) + c, v[c]);
}

// S1B: the reverse of S1's differentiable part in trace's carry form, lane
// by lane, as autograd runs it through the plain version
// (integrator.shade_plain; plain ops.step.step_shade_backward_plain): per
// channel c,
//
//   color' = terminal ? L * att : color, L = dead_t ? 0 : min(A * t_c, B),
//           t_c = dead_t ? 0 : term,
//           term = miss ? bg : (emit && front ? albedo : 0)
//   att = atten > 0 ? 1 / (1 + atten * term_acc) : 1 (atten: the emitter's
//           effective material's factor, 0 on a lane that does not emit)
//   A' = terminal ? 1 : (scat ? A * (albedo * m) : A), m = dead ? 0 : prob
//   B' = terminal ? inf : (pdf ? min(B, 3 A) : B)
//
// with every product's gradient taken as torch's backward takes it (so a
// masked branch's zero meets the same operands), torch.minimum's tie and
// NaN rule, and the sum of each input's contributions (at most two of them
// non-zero on a lane, so their order is immaterial). prob, att and the
// directions carry no gradient (the JAX package's stop_gradients), and the
// shading normal reaches only them, so a normal map's texels get none.
//
// A lane with no branch bit, no texel row and a zero prob (a lane parked
// by the fixed trip) whose channel's color gradient times att, g, is 0:
// every term of that channel's fold gradients but the upstream one is +0
// (t_c = 0, so gx and gy are +-0 whatever A and B are, and gx t_c, go 3,
// g_p (alb m), gs are +-0 too), so they are g_A_out + 0 and g_B_out + 0,
// the same bits (-0 becomes +0 as in the full sum), without reading A and
// B. A non-zero g, NaN included, takes the full formula (min_grads' NaN
// rule reaches the result through gx t_c).
//
// The carried color's gradient is the upstream one on a lane that does not
// end and 0 on one that does; L * att takes it on the lanes that end. It is
// written first, in a loop of its own, and the channel loop reads the
// upstream again only on a lane that ends: so nothing of it is live across
// that loop (no spills; 8-9% faster at 2,073,600 lanes than writing it
// there, PERF.md). On a
// lane whose emitter attenuates, the factor's gradient is
// -(sum_c g_c L_c) * att^2 * term_acc, as torch's backward takes it through
// the reciprocal (the reverse of the record's att).
//
// Returns the albedo texel's gradient in g_alb, the background's in g_bg (0
// unless the lane missed) and, with kMats (g_mats set), the attenuation
// factor's in g_atten and its material row in mat (-1: none).
template <bool kMats>
__device__ __forceinline__ void shade_back_lane(const ShadeBack& a,
                                                long long i, int row,
                                                float g_alb[3], float g_bg[3],
                                                float* g_atten, int* mat) {
  const float r1 = __int_as_float(a.rec[a.n + i]);
  const float att = __int_as_float(a.rec[2 * a.n + i]);
  const int f = a.rec[3 * a.n + i];
  const bool miss = f & kRecMiss, emit_front = f & kRecEmitFront,
             scat = f & kRecScat, pdf = f & kRecPdf,
             terminal = f & kRecTerminal;
  const bool atten = kMats && (f & kRecAtten);
  const float prob = scat ? r1 : 0.0f;
  const bool quiet = (f & kRecBranch) == 0 && row < 0;
  if (a.g_carry != nullptr)
    for (int c = 0; c < 3; ++c)
      a.g_carry[3 * i + c] = terminal || a.g_color == nullptr
                                 ? 0.0f : a.g_color[3 * i + c];
  float g_att = 0.0f;
  for (int c = 0; c < 3; ++c) {
    const bool dead_t = f & (kRecDeadT << c), dead = f & (kRecDead << c);
    const float g_end =
        terminal && a.g_color != nullptr ? a.g_color[3 * i + c] : 0.0f;
    const float g_l = g_end * att;
    const float g = dead_t ? 0.0f : g_l;
    const float g_a2 = terminal || a.g_A_out[c] == nullptr
                           ? 0.0f : a.g_A_out[c][i];
    const float g_b2 = terminal || a.g_B_out[c] == nullptr
                           ? 0.0f : a.g_B_out[c][i];
    g_alb[c] = g_bg[c] = 0.0f;
    if (quiet && g == 0.0f) {
      if (a.g_A[c] != nullptr) a.g_A[c][i] = g_a2 + 0.0f;
      if (a.g_B[c] != nullptr) a.g_B[c][i] = g_b2 + 0.0f;
      continue;
    }
    const float A = a.A[c][i], B = a.B[c][i];
    const float alb =
        row >= 0 ? a.texels[3 * static_cast<size_t>(row) + c] : 0.0f;
    // fold_resolve
    const float term = miss ? a.bg[c] : (emit_front ? alb : 0.0f);
    const float t_c = dead_t ? 0.0f : term;
    float gx, gy;
    min_grads(A * t_c, B, g, &gx, &gy);
    if (atten) g_att += g_end * (dead_t ? 0.0f : nan_min(A * t_c, B));
    const float g_term = dead_t ? 0.0f : gx * A;
    if (miss) g_bg[c] = g_term;
    // the terminal reset and fold_scatter
    const float m = dead ? 0.0f : prob;
    const float g_p = scat ? g_a2 : 0.0f;
    float gs, go;
    min_grads(B, 3.0f * A, pdf ? g_b2 : 0.0f, &gs, &go);
    g_alb[c] = (emit_front ? g_term : 0.0f) + (g_p * A) * m;
    if (a.g_A[c] != nullptr)
      a.g_A[c][i] = gx * t_c + go * 3.0f + g_p * (alb * m) +
                    (scat ? 0.0f : g_a2);
    if (a.g_B[c] != nullptr) a.g_B[c][i] = gy + gs + (pdf ? 0.0f : g_b2);
  }
  *g_atten = atten ? ((-g_att) * (att * att)) * r1 : 0.0f;
  *mat = atten ? static_cast<int>(static_cast<unsigned>(f) >> kRecMatShift)
               : -1;
}

// S1B over every lane (shade_back_lane): a resident grid of blocks that
// each loop over the lanes (backward_grid). The albedo texels' gradients
// meet in few rows (a solid colour is one row that most lanes read), and
// atomic adds to one address serialise, so they are summed first: within a
// warp, one sum for each row its lanes read (peer_sums, only in a warp
// with a lane that read one), then in the block's table over all the lanes
// it takes, and each row of the table is added to the pass's sums once, at
// the block's end (a row the table has no slot for goes there directly).
// The background's gradient is summed a thread over its lanes, then a
// warp, then, after the block's last barrier, over the warps in order, and
// added once a block with a lane that missed (a non-zero term). Two
// barriers a block. With kMats, the attenuation factor's (few lanes: those
// that end on an attenuated emitter) is summed a warp a material row and
// added at once; the inverse step, whose material table wants no gradient,
// runs the kernel compiled without it.
template <bool kMats>
__device__ __forceinline__ void shade_back_block(const ShadeBack& a) {
  __shared__ RowTable table;
  __shared__ float warp_bg[kBackThreads / 32][3];
  const unsigned lane = threadIdx.x % 32;
  const bool sums = a.g_texels != nullptr;
  if (sums) {
    for (int s = threadIdx.x; s < kBackSlots; s += kBackThreads) {
      table.row[s] = -1;
      table.sum[s][0] = table.sum[s][1] = table.sum[s][2] = 0.0f;
    }
    __syncthreads();
  }
  float bg[3] = {0.0f, 0.0f, 0.0f};
  bool missed = false;
  const long long stride = static_cast<long long>(gridDim.x) * kBackThreads;
  for (long long base = static_cast<long long>(blockIdx.x) * kBackThreads;
       base < a.n; base += stride) {
    const long long i = base + threadIdx.x;
    float g_alb[3] = {0.0f, 0.0f, 0.0f}, g_bg[3], g_atten[1] = {0.0f};
    int row = -1, mat = -1;
    if (i < a.n) {
      row = a.rec[i];
      shade_back_lane<kMats>(a, i, row, g_alb, g_bg, g_atten, &mat);
      for (int c = 0; c < 3; ++c) {
        bg[c] += g_bg[c];
        missed |= g_bg[c] != 0.0f;
      }
    }
    if (sums && __any_sync(0xffffffffu, row >= 0)) {
      const unsigned peers = __match_any_sync(0xffffffffu, row);
      peer_sums(peers, g_alb);
      if ((peers & ((1u << lane) - 1u)) == 0u && row >= 0)
        add_row(table, a.g_texels, row, g_alb);
    }
    if (kMats && __any_sync(0xffffffffu, mat >= 0)) {
      const unsigned peers = __match_any_sync(0xffffffffu, mat);
      peer_sums(peers, g_atten);
      if ((peers & ((1u << lane) - 1u)) == 0u && mat >= 0 &&
          g_atten[0] != 0.0f)
        atomicAdd(a.g_mats + 9 * static_cast<size_t>(mat) + 5, g_atten[0]);
    }
  }
  if (a.g_bg != nullptr && __any_sync(0xffffffffu, missed))
    for (int c = 0; c < 3; ++c)
      for (int k = 16; k > 0; k >>= 1)
        bg[c] += __shfl_down_sync(0xffffffffu, bg[c], k);
  if (lane == 0)
    for (int c = 0; c < 3; ++c) warp_bg[threadIdx.x / 32][c] = bg[c];
  // the block's last barrier: the table's adds and the warps' sums are
  // in, and it tells whether a lane of the block added a background term
  const bool block_missed = __syncthreads_or(missed);
  if (sums)
    for (int s = threadIdx.x; s < kBackSlots; s += kBackThreads) {
      const int row = table.row[s];
      if (row < 0) continue;
      for (int c = 0; c < 3; ++c)
        if (table.sum[s][c] != 0.0f)
          atomicAdd(a.g_texels + 3 * static_cast<size_t>(row) + c,
                    table.sum[s][c]);
    }
  if (a.g_bg != nullptr && block_missed && threadIdx.x == 0)
    for (int c = 0; c < 3; ++c) {
      float s = 0.0f;
      for (int w = 0; w < kBackThreads / 32; ++w) s += warp_bg[w][c];
      if (s != 0.0f) atomicAdd(a.g_bg + c, s);
    }
}

// S1B without the materials' sums (the arena, the background, the carried
// color and the fold), and S1B with them
__global__ void __launch_bounds__(kBackThreads, kBackMinBlocks)
    step_shade_backward(const ShadeBack a) {
  shade_back_block<false>(a);
}

__global__ void __launch_bounds__(kBackThreads, kBackMinBlocks)
    step_shade_backward_mats(const ShadeBack a) {
  shade_back_block<true>(a);
}

// S1B's resident grid on the current device for the kernel ``mats`` says:
// the blocks that stay resident on one SM (computed once a device) times
// the SMs, but no more blocks than the lanes fill
cudaError_t backward_grid(long long n, bool mats, unsigned int* blocks) {
  constexpr int kMaxDevices = 64;
  static long long resident[2][kMaxDevices] = {};   // 0: not computed yet
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  long long& res = resident[mats][dev];
  if (res == 0) {
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, mats ? step_shade_backward_mats : step_shade_backward,
        kBackThreads, 0);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    res = static_cast<long long>(per_sm) * sms;
  }
  const long long fill = (n + kBackThreads - 1) / kBackThreads;
  *blocks = static_cast<unsigned int>(fill < res ? fill : res);
  return cudaSuccess;
}

struct Regen {
  Scene sc;                          // cam
  Lanes pool;
  long long* qpos;
  long long* pixel;
  long long* sample;
  const bool* terminal;              // step mode: S1's flags
  const float* color;                // (R, 3)
  float* accum;                      // (total_q + 1, 3)
  long long* next_q;
  long long* segments;
  unsigned int* ticket;              // (2,) started blocks (0 between
                                     // launches), the launch count
  unsigned long long* status;        // the scan's words, one a block
  const long long* start;            // first sample id
  const long long* pix_ids;          // a shard's pixel ids, or null
  long long n, total_q;
  unsigned long long npix_magic;     // q / n_pix = (t + ((q - t) >> sh1))
  int npix_sh1, npix_sh2;            //   >> sh2, t = umulhi(magic, q)
  unsigned int n_pix;
  int width, height;
  int swizzle, tile_wl, tile_hl;     // the tile's log2 width and height
  uint32_t seed;
  int reset;
};

// q / n_pix for any queue position, exactly, by a multiply-high with the
// host's round-up constant (Granlund and Montgomery, 1994, fig. 4.1;
// ops.step.div_magic): no 64-bit division, which the card emulates
__device__ __forceinline__ unsigned long long div_npix(const Regen& a,
                                                       unsigned long long q) {
  const unsigned long long t = __umul64hi(a.npix_magic, q);
  return (t + ((q - t) >> a.npix_sh1)) >> a.npix_sh2;
}

// _Wavefront.assignment / queue_assignment: queue position q -> (pixel id,
// q / n_pix), tile-swizzled in the full image. Past the division, 32-bit:
// the slot is below n_pix < 2^31, and a tile's sides are powers of two.
__device__ __forceinline__ unsigned int assignment(const Regen& a,
                                                   long long q,
                                                   unsigned long long* qq) {
  *qq = div_npix(a, static_cast<unsigned long long>(q));
  const unsigned int pslot = static_cast<unsigned int>(q) -
                             static_cast<unsigned int>(*qq) * a.n_pix;
  if (a.pix_ids != nullptr) return static_cast<unsigned int>(
      a.pix_ids[pslot]);
  if (!a.swizzle) return pslot;
  const int tl = a.tile_wl + a.tile_hl;
  const unsigned int tile = pslot >> tl;
  const unsigned int within = pslot & ((1u << tl) - 1u);
  const unsigned int tiles_x = static_cast<unsigned int>(a.width) >> a.tile_wl;
  const unsigned int ty = tile / tiles_x, tx = tile - ty * tiles_x;
  return ((ty << a.tile_hl) + (within >> a.tile_wl)) *
             static_cast<unsigned int>(a.width) +
         (tx << a.tile_wl) + (within & ((1u << a.tile_wl) - 1u));
}

// The scan's status word of a block, one 64-bit word so that no reader sees
// a flag without its count: the launch's tag (bits 32-63), the flag (30-31:
// 0 nothing yet, 1 the block's own count, 2 the count of it and every
// block before it) and the count (0-29). A word with another launch's tag
// reads as nothing yet, so the words need no clearing between launches.
constexpr unsigned int kAggregate = 1u, kInclusive = 2u;
constexpr unsigned int kCountBits = 30, kCountMask = (1u << kCountBits) - 1u;

__device__ __forceinline__ void publish(unsigned long long* status, int b,
                                        unsigned int tag, unsigned int flag,
                                        unsigned int count) {
  *reinterpret_cast<volatile unsigned long long*>(status + b) =
      (static_cast<unsigned long long>(tag) << 32) |
      (static_cast<unsigned long long>(flag) << kCountBits) | count;
}

// The terminal lanes of the blocks before logical block b (decoupled
// look-back, Merrill and Garland 2016), by one warp: each lane reads one
// predecessor's word, nearest first, 32 at a time; the window up to the
// nearest inclusive count is summed once none of it is still unpublished.
// Only blocks with a smaller ticket are waited on, and those have started.
__device__ __forceinline__ unsigned int look_back(
    const unsigned long long* status, int b, unsigned int tag, int lane) {
  unsigned int excl = 0;
  for (int j = b - 1;; j -= 32) {
    unsigned int flag, count, incl, mask;
    do {
      const int k = j - lane;
      flag = kInclusive;   // before block 0: an inclusive 0
      count = 0u;
      if (k >= 0) {
        const unsigned long long w =
            *reinterpret_cast<const volatile unsigned long long*>(status + k);
        const bool mine = static_cast<unsigned int>(w >> 32) == tag;
        flag = mine ? static_cast<unsigned int>(w >> kCountBits) & 3u : 0u;
        count = static_cast<unsigned int>(w) & kCountMask;
      }
      incl = __ballot_sync(0xffffffffu, flag == kInclusive);
      // the lanes up to the nearest inclusive count (all 32 without one)
      mask = incl ? ((incl & (0u - incl)) << 1) - 1u : 0xffffffffu;
    } while (__ballot_sync(0xffffffffu, flag == 0u) & mask);
    unsigned int v = (mask >> lane) & 1u ? count : 0u;
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    excl += v;
    if (incl) return excl;
  }
}

// One regenerated lane: queue position q, its camera ray (parked with a
// zero direction past the queue), the pool's write-back
__device__ __forceinline__ void regen_lane(const Regen& a, long long i,
                                           long long q) {
  unsigned long long qq;
  const unsigned int px =
      assignment(a, q < a.total_q - 1 ? q : a.total_q - 1, &qq);
  const long long sp = *a.start + static_cast<long long>(qq);
  V3 o, d;
  camera_ray(a.sc, static_cast<int>(px), static_cast<int>(sp), a.seed,
             a.width, a.height, &o, &d);
  if (q >= a.total_q) d = v3(0.0f, 0.0f, 0.0f);   // parked
  a.qpos[i] = q;
  a.pixel[i] = px;
  a.sample[i] = sp;
  a.pool.o[0][i] = o.x; a.pool.o[1][i] = o.y; a.pool.o[2][i] = o.z;
  a.pool.d[0][i] = d.x; a.pool.d[1][i] = d.y; a.pool.d[2][i] = d.z;
  a.pool.bounce[i] = 0;
  a.pool.acc_len[i] = 0.0f;
}

// S2. Reset mode: every lane on its own queue position, fold identity.
// Step mode: blocks take their lanes in ticket order; each finished lane
// stores its color in its row, and the block's terminal lanes take the
// next queue positions in lane order, ranked by a single-pass scan
// (decoupled look-back) over the blocks' status words. The block with the
// last ticket, whose look-back has seen every other block's word (each
// written after that block read the queue head and the launch count),
// writes the new queue head, puts the ticket back to 0 and counts the
// launch, so the launch needs no host set-up and a CUDA graph replays it
// as it is.
__global__ void __launch_bounds__(kRegenThreads)
    step_regen(const Regen a) {
  constexpr int kWarps = kRegenThreads / 32;
  __shared__ long long s_base;              // the queue head before the step
  __shared__ int s_block;                   // this block's ticket
  __shared__ unsigned int s_tag;            // this launch's tag
  __shared__ unsigned int s_term[kWarps];   // a warp's terminal lanes, then
                                            // those before it in the block
  __shared__ unsigned int s_active[kWarps];
  __shared__ unsigned int s_excl;           // ... before this block
  if (a.reset) {
    const long long i = static_cast<long long>(blockIdx.x) * kRegenThreads +
                        threadIdx.x;
    if (i >= a.n) return;
    regen_lane(a, i, i);
    for (int c = 0; c < 3; ++c) {
      a.pool.A[c][i] = 1.0f;
      a.pool.B[c][i] = CUDART_INF_F;
      a.pool.dead[c][i] = false;
    }
    a.pool.outer[i] = false;
    return;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) {
    s_block = static_cast<int>(atomicAdd(a.ticket, 1u));
    s_base = *a.next_q;
    s_tag = *reinterpret_cast<volatile unsigned int*>(a.ticket + 1) + 1u;
  }
  __syncthreads();
  const int b = s_block;
  const long long i = static_cast<long long>(b) * kRegenThreads + threadIdx.x;
  const bool in = i < a.n;
  const long long q = in ? a.qpos[i] : a.total_q;
  const bool term = in && a.terminal[i];
  float color[3] = {0.0f, 0.0f, 0.0f};
  if (term)
    for (int c = 0; c < 3; ++c) color[c] = a.color[3 * i + c];
  const unsigned int ballot = __ballot_sync(0xffffffffu, term);
  const unsigned int act = __ballot_sync(0xffffffffu, q < a.total_q);
  if (lane == 0) {
    s_term[warp] = __popc(ballot);
    s_active[warp] = __popc(act);
  }
  __syncthreads();
  if (warp == 0) {
    // the warps' exclusive offsets, the block's count, its status word
    const unsigned int v = lane < kWarps ? s_term[lane] : 0u;
    unsigned int incl = v;
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned int x = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += x;
    }
    const unsigned int agg = __shfl_sync(0xffffffffu, incl, 31);
    if (lane < kWarps) s_term[lane] = incl - v;
    const unsigned int tag = s_tag;
    if (lane == 0)
      publish(a.status, b, tag, b == 0 ? kInclusive : kAggregate, agg);
    const unsigned int excl = look_back(a.status, b, tag, lane);
    unsigned int n_act = lane < kWarps ? s_active[lane] : 0u;
    for (int o = 16; o > 0; o >>= 1)
      n_act += __shfl_xor_sync(0xffffffffu, n_act, o);
    if (lane == 0) {
      if (b > 0) publish(a.status, b, tag, kInclusive, excl + agg);
      s_excl = excl;
      // the segments of this step: its active lanes
      if (n_act > 0)
        atomicAdd(reinterpret_cast<unsigned long long*>(a.segments),
                  static_cast<unsigned long long>(n_act));
      if (b == static_cast<int>(gridDim.x) - 1) {
        *a.next_q = s_base + static_cast<long long>(excl + agg);
        a.ticket[0] = 0u;
        a.ticket[1] = tag;
      }
    }
  }
  __syncthreads();
  if (!term) return;
  // the finished color into its row (row_of: sample-major by pixel id in
  // the full image, by queue position in a shard), then the next position
  long long row = q;
  if (a.pix_ids == nullptr) {
    unsigned long long qq;
    const unsigned int px = assignment(a, q, &qq);
    row = static_cast<long long>(qq * a.n_pix) + px;
  }
  for (int c = 0; c < 3; ++c) a.accum[3 * row + c] = color[c];
  regen_lane(a, i, s_base + s_excl + s_term[warp] +
                       __popc(ballot & ((1u << lane) - 1u)));
}

Lanes lanes_at(const void* const* p) {
  Lanes s;
  for (int c = 0; c < 3; ++c) {
    s.o[c] = static_cast<float*>(const_cast<void*>(p[c]));
    s.d[c] = static_cast<float*>(const_cast<void*>(p[3 + c]));
    s.A[c] = static_cast<float*>(const_cast<void*>(p[8 + c]));
    s.B[c] = static_cast<float*>(const_cast<void*>(p[11 + c]));
    s.dead[c] = static_cast<bool*>(const_cast<void*>(p[14 + c]));
  }
  s.bounce = static_cast<int*>(const_cast<void*>(p[6]));
  s.acc_len = static_cast<float*>(const_cast<void*>(p[7]));
  s.outer = static_cast<bool*>(const_cast<void*>(p[17]));
  return s;
}

// The scene tables both kernels read: cam, materials, textures, lights.
Scene scene_at(const void* const* p, const long long* v, int i_cam,
               int i_mats, int i_tex_attr, int i_texels, int i_lights,
               int v_mat, int v_tex, int v_texels, int v_light, int flags) {
  Scene sc = {};
  sc.cam = static_cast<const float*>(p[i_cam]);
  sc.mats = static_cast<const float*>(p[i_mats]);
  sc.n_mat = static_cast<int>(v[v_mat]);
  sc.tex_attr = static_cast<const float*>(p[i_tex_attr]);
  sc.n_tex = static_cast<int>(v[v_tex]);
  sc.texels = static_cast<const float*>(p[i_texels]);
  sc.n_texels = static_cast<int>(v[v_texels]);
  sc.lights = static_cast<const float*>(p[i_lights]);
  sc.n_light = static_cast<int>(v[v_light]);
  sc.flags = flags;
  return sc;
}

hit::Counter counter_at(const void* p, const long long* v) {
  return hit::Counter{p, static_cast<int>(v[0]), static_cast<int>(v[1]),
                      static_cast<uint32_t>(v[2])};
}

}  // namespace

// S1's arguments, by index into p (pointers) and v (int64 values); the
// names match ops/step.py's SHADE_PTRS and SHADE_INTS.
enum ShadePtr {
  SP_CAM, SP_SPH, SP_PLN, SP_MATS, SP_TEX_ATTR, SP_TEXELS, SP_LIGHTS,
  SP_MED_MAT, SP_PL_ROW, SP_SMALL, SP_T, SP_KIND, SP_IDX, SP_PIXEL,
  SP_SAMPLE, SP_SEED, SP_ACTIVE, SP_QPOS, SP_COLOR, SP_TERMINAL, SP_MISS,
  SP_CAPPED, SP_EMIT, SP_SCAT, SP_IS_PDF, SP_IN, SP_OUT = SP_IN + 18,
  SP_BG = SP_OUT + 18, SP_REC, SP_CARRY, SP_COUNT
};
enum ShadeInt {
  SV_N, SV_MAX_DEPTH, SV_FLAGS, SV_N_SPH, SV_N_PL, SV_N_Q, SV_N_MAT,
  SV_N_TEX, SV_N_TEXELS, SV_N_LIGHT, SV_N_MEDIA, SV_TOTAL_Q, SV_STAGE,
  SV_PIXEL, SV_SAMPLE = SV_PIXEL + 3, SV_SEED = SV_SAMPLE + 3,
  SV_COUNT = SV_SEED + 3
};

// S2's arguments, as ops/step.py's REGEN_PTRS and REGEN_INTS name them.
enum RegenPtr {
  RP_CAM, RP_QPOS, RP_PIXEL, RP_SAMPLE, RP_TERMINAL, RP_COLOR, RP_ACCUM,
  RP_NEXT_Q, RP_SEGMENTS, RP_TICKET, RP_STATUS, RP_START, RP_PIX_IDS,
  RP_POOL, RP_COUNT = RP_POOL + 18
};
enum RegenInt {
  RV_N, RV_TOTAL_Q, RV_N_PIX, RV_NPIX_MAGIC, RV_NPIX_SH1, RV_NPIX_SH2,
  RV_WIDTH, RV_HEIGHT, RV_SWIZZLE, RV_TILE_WL, RV_TILE_HL, RV_N_STATUS,
  RV_SEED, RV_RESET, RV_COUNT
};

// S1B's arguments, as ops/step.py's BACK_PTRS and BACK_INTS name them
// (each fold group: a0 a1 a2 b0 b1 b2).
enum BackPtr {
  BP_REC, BP_TEXELS, BP_BG, BP_G_COLOR, BP_G_TEXELS, BP_G_BG, BP_G_MATS,
  BP_G_CARRY, BP_IN,
  BP_G_OUT = BP_IN + 6, BP_G_IN = BP_G_OUT + 6, BP_COUNT = BP_G_IN + 6
};
enum BackInt { BV_N, BV_COUNT };

extern "C" int step_shade_launch(const void* const* p, const long long* v,
                                 void* stream) {
  static_assert(SP_OUT - SP_IN == kLaneArrays, "lane arrays");
  static_assert(RP_COUNT - RP_POOL == kLaneArrays, "lane arrays");
  const long long n = v[SV_N];
  if (n > 0) {
    Shade a;
    a.sc = scene_at(p, v, SP_CAM, SP_MATS, SP_TEX_ATTR, SP_TEXELS,
                    SP_LIGHTS, SV_N_MAT, SV_N_TEX, SV_N_TEXELS, SV_N_LIGHT,
                    static_cast<int>(v[SV_FLAGS]));
    a.sph = static_cast<const float*>(p[SP_SPH]);
    a.n_sph = static_cast<int>(v[SV_N_SPH]);
    a.pln = static_cast<const float*>(p[SP_PLN]);
    a.n_pl = static_cast<int>(v[SV_N_PL]);
    a.n_q = static_cast<int>(v[SV_N_Q]);
    a.pl_row = static_cast<const int*>(p[SP_PL_ROW]);
    a.small = static_cast<const float*>(p[SP_SMALL]);
    a.stage_floats = static_cast<int>(v[SV_STAGE]);
    a.med_mat = static_cast<const int*>(p[SP_MED_MAT]);
    a.n_media = static_cast<int>(v[SV_N_MEDIA]);
    a.t = static_cast<const float*>(p[SP_T]);
    a.kind = static_cast<const int*>(p[SP_KIND]);
    a.idx = static_cast<const int*>(p[SP_IDX]);
    a.pixel = counter_at(p[SP_PIXEL], v + SV_PIXEL);
    a.sample = counter_at(p[SP_SAMPLE], v + SV_SAMPLE);
    a.seed = counter_at(p[SP_SEED], v + SV_SEED);
    a.active = static_cast<const bool*>(p[SP_ACTIVE]);
    a.qpos = static_cast<const long long*>(p[SP_QPOS]);
    a.total_q = v[SV_TOTAL_Q];
    a.in = lanes_at(p + SP_IN);
    a.out = lanes_at(p + SP_OUT);
    a.color = static_cast<float*>(const_cast<void*>(p[SP_COLOR]));
    a.carry = static_cast<const float*>(p[SP_CARRY]);
    a.bg = static_cast<const float*>(p[SP_BG]);
    a.rec = static_cast<int*>(const_cast<void*>(p[SP_REC]));
    for (int k = 0; k < 6; ++k)
      a.flag[k] = static_cast<bool*>(const_cast<void*>(p[SP_TERMINAL + k]));
    a.n = n;
    a.max_depth = static_cast<int>(v[SV_MAX_DEPTH]);
    const int smem = a.stage_floats * static_cast<int>(sizeof(float));
    const long long blocks = (n + kShadeThreads - 1) / kShadeThreads;
    // trace's form where the lanes come with a bool active flag; the pool's
    // has neither a carry nor a record
    if (a.active != nullptr)
      step_shade_trace<<<static_cast<unsigned int>(blocks), kShadeThreads,
                         smem, static_cast<cudaStream_t>(stream)>>>(a);
    else if (a.carry == nullptr && a.rec == nullptr)
      step_shade<<<static_cast<unsigned int>(blocks), kShadeThreads, smem,
                   static_cast<cudaStream_t>(stream)>>>(a);
    else
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int step_regen_launch(const void* const* p, const long long* v,
                                 void* stream) {
  const long long n = v[RV_N];
  if (n > 0) {
    Regen a;
    a.sc = Scene{};
    a.sc.cam = static_cast<const float*>(p[RP_CAM]);
    a.pool = lanes_at(p + RP_POOL);
    a.qpos = static_cast<long long*>(const_cast<void*>(p[RP_QPOS]));
    a.pixel = static_cast<long long*>(const_cast<void*>(p[RP_PIXEL]));
    a.sample = static_cast<long long*>(const_cast<void*>(p[RP_SAMPLE]));
    a.terminal = static_cast<const bool*>(p[RP_TERMINAL]);
    a.color = static_cast<const float*>(p[RP_COLOR]);
    a.accum = static_cast<float*>(const_cast<void*>(p[RP_ACCUM]));
    a.next_q = static_cast<long long*>(const_cast<void*>(p[RP_NEXT_Q]));
    a.segments = static_cast<long long*>(const_cast<void*>(p[RP_SEGMENTS]));
    a.ticket = static_cast<unsigned int*>(const_cast<void*>(p[RP_TICKET]));
    a.status = static_cast<unsigned long long*>(
        const_cast<void*>(p[RP_STATUS]));
    a.start = static_cast<const long long*>(p[RP_START]);
    a.pix_ids = static_cast<const long long*>(p[RP_PIX_IDS]);
    a.n = n;
    a.total_q = v[RV_TOTAL_Q];
    a.n_pix = static_cast<unsigned int>(v[RV_N_PIX]);
    a.npix_magic = static_cast<unsigned long long>(v[RV_NPIX_MAGIC]);
    a.npix_sh1 = static_cast<int>(v[RV_NPIX_SH1]);
    a.npix_sh2 = static_cast<int>(v[RV_NPIX_SH2]);
    a.width = static_cast<int>(v[RV_WIDTH]);
    a.height = static_cast<int>(v[RV_HEIGHT]);
    a.swizzle = static_cast<int>(v[RV_SWIZZLE]);
    a.tile_wl = static_cast<int>(v[RV_TILE_WL]);
    a.tile_hl = static_cast<int>(v[RV_TILE_HL]);
    a.seed = static_cast<uint32_t>(v[RV_SEED]);
    a.reset = static_cast<int>(v[RV_RESET]);
    const long long blocks = (n + kRegenThreads - 1) / kRegenThreads;
    // the scan's words: one a block; its counts: 30 bits
    if (!a.reset && (blocks > v[RV_N_STATUS] || n > kCountMask))
      return static_cast<int>(cudaErrorInvalidValue);
    step_regen<<<static_cast<unsigned int>(blocks), kRegenThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int step_shade_backward_launch(const void* const* p,
                                          const long long* v, void* stream) {
  const long long n = v[BV_N];
  if (n > 0) {
    ShadeBack a;
    a.rec = static_cast<const int*>(p[BP_REC]);
    a.texels = static_cast<const float*>(p[BP_TEXELS]);
    a.bg = static_cast<const float*>(p[BP_BG]);
    a.g_color = static_cast<const float*>(p[BP_G_COLOR]);
    a.g_texels = static_cast<float*>(const_cast<void*>(p[BP_G_TEXELS]));
    a.g_bg = static_cast<float*>(const_cast<void*>(p[BP_G_BG]));
    a.g_mats = static_cast<float*>(const_cast<void*>(p[BP_G_MATS]));
    a.g_carry = static_cast<float*>(const_cast<void*>(p[BP_G_CARRY]));
    for (int c = 0; c < 3; ++c) {
      a.A[c] = static_cast<const float*>(p[BP_IN + c]);
      a.B[c] = static_cast<const float*>(p[BP_IN + 3 + c]);
      a.g_A_out[c] = static_cast<const float*>(p[BP_G_OUT + c]);
      a.g_B_out[c] = static_cast<const float*>(p[BP_G_OUT + 3 + c]);
      a.g_A[c] = static_cast<float*>(const_cast<void*>(p[BP_G_IN + c]));
      a.g_B[c] = static_cast<float*>(const_cast<void*>(p[BP_G_IN + 3 + c]));
    }
    a.n = n;
    unsigned int blocks = 0;
    const bool mats = a.g_mats != nullptr;
    const cudaError_t err = backward_grid(n, mats, &blocks);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (mats)
      step_shade_backward_mats<<<blocks, kBackThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(a);
    else
      step_shade_backward<<<blocks, kBackThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
