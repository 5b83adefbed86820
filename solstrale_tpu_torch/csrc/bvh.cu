// Closest planar (quad + triangle) hit through the BVH (K1).
//
// Replaces the TPU kernel solstrale_tpu/ops/pallas_bvh.py::_bvh_kernel
// (launched by _bvh_chunk, reached through bvh_planar_hit_pallas). Output
// contract of that kernel: per ray the closest t >= tmin over every planar
// prim (no upper bound) and its planar slot, ties to the smallest slot;
// INF / -1 on a miss.
//
// What bounds it on the card: latency. Every ray chases its own chain of
// dependent node loads down the tree (a visit's 64 bytes decide the next
// address), so the card waits on memory far more than it computes: ~30
// f32 operations a visit, ~32 a prim test. A launch lasts as long as its
// longest chains, those of bounce rays that graze the surface across many
// boxes, so 16,384 lanes take nearly as long as 131,072. The design
// shortens those chains:
// - the tree is the port's own (accel.build_kernel_bvh): the median split
//   continued down to leaves of kWalkLeaf prims, so a ray tests a few
//   prims where a leaf of the TPU treelet layout held 8 in no spatial order;
// - child boxes in the parent (Aila & Laine, HPG 2009): an internal node's
//   64-byte row holds both children's boxes, [Lminx Rminx Lmaxx Rmaxx],
//   the same for y and z, and the children's prim counts. One visit
//   slab-tests both children from three 16-byte loads, descends into the
//   nearer entered child and pushes the other only if the ray enters it,
//   so a missed child costs no load of its own; a leaf child's prims are
//   tested at once, the count from the row (no padding row is loaded);
// - the top kTopLevels levels live in shared memory: at block start one
//   thread copies their rows (63 rows, 4 KB) with one asynchronous bulk
//   copy (cp.async.bulk, completed on an mbarrier) while the block reads
//   its rays; below them rows and prims are read with __ldg. On the H100
//   this gains nothing measurable (0, 4 and 6 levels lie within noise,
//   PERF.md): the time is in the deep, divergent visits;
// - a short stack in shared memory, one column per thread (entry k of
//   thread t at k * blockDim + t, so a warp's accesses hit distinct
//   banks): the tree's internal levels bound it (a visit pushes at most
//   one sibling per level), 8 bytes an entry with the pushed child's
//   entry distance, so a popped child the best t has passed is skipped
//   without a load.
// Entering is strict against the best t, widened by a few ulps (near <=
// best * kBestScale), and the slab interval by kFarScale; the build pads
// every prim box (accel.BOX_PAD) and rounds boxes outwards. A box that
// holds a prim at the best t is therefore always entered, and exact ties
// resolve to the smallest slot as the brute force resolves them.
//
// Leaves use the TPU kernel's unified formula (pallas_bvh.py:250-264):
// t = (d_pl - o.n)/(d.n), u = o.g1 + t*(d.g1) + g1o, v likewise,
// containment by is_tri.
//
// Tables (f32, 16-byte aligned rows; built by accel.build_kernel_bvh):
//   nodes (n_int, 16): the internal nodes' rows above (children of node i
//         are 2i+1 and 2i+2; node ids >= n_int are leaves), empty subtrees
//         as a far-away point box (always missed, count 0)
//   prims (n_leaves*kWalkLeaf, 16): nx ny nz d g1xyz g1o g2xyz g2o
//         is_tri valid slot 0, a leaf's valid rows first
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr float kAlmostZero = 1e-8f;   // geo.ALMOST_ZERO (vec3.rs:21)
constexpr float kFarScale = 1.0000004f;   // accel.FAR_SCALE
constexpr float kBestScale = 1.000002f;   // accel.BEST_SCALE
constexpr int kWalkLeaf = 2;   // prims per leaf, accel.WALK_LEAF
// levels staged in shared memory (chosen on the H100, PERF.md), their rows
constexpr int kTopLevels = 6;
constexpr int kTopRows = (1 << kTopLevels) - 1;

// rows staged for a tree of n_int internal nodes
__host__ __device__ __forceinline__ int top_rows(int n_int) {
  return n_int < kTopRows ? n_int : kTopRows;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// near/far of the ray through both children's boxes from the three rows
// of one axis each: (Lmin, Rmin, Lmax, Rmax)
__device__ __forceinline__ void slab2(float4 b, float o, float inv,
                                      float& nl, float& fl, float& nr,
                                      float& fr, bool first) {
  const float a0 = (b.x - o) * inv, a1 = (b.z - o) * inv;
  const float b0 = (b.y - o) * inv, b1 = (b.w - o) * inv;
  if (first) {
    nl = fminf(a0, a1); fl = fmaxf(a0, a1);
    nr = fminf(b0, b1); fr = fmaxf(b0, b1);
  } else {
    nl = fmaxf(nl, fminf(a0, a1)); fl = fminf(fl, fmaxf(a0, a1));
    nr = fmaxf(nr, fminf(b0, b1)); fr = fminf(fr, fmaxf(b0, b1));
  }
}

struct Ray {
  float o0, o1, o2, d0, d1, d2, tmin;
};

// test `count` prims from row `base` on; keep the closest (t, slot)
__device__ __forceinline__ void leaf(const float4* __restrict__ prims,
                                     int base, int count, const Ray& r,
                                     float& best, int& best_slot) {
  for (int k = 0; k < count; ++k) {
    const float4* row = prims + 4 * (base + k);
    const float4 n = __ldg(&row[0]);
    const float4 g1 = __ldg(&row[1]);
    const float4 g2 = __ldg(&row[2]);
    const float4 e = __ldg(&row[3]);  // is_tri valid slot 0
    const float on = r.o0 * n.x + r.o1 * n.y + r.o2 * n.z;
    const float dn = r.d0 * n.x + r.d1 * n.y + r.d2 * n.z;
    const float og1 = r.o0 * g1.x + r.o1 * g1.y + r.o2 * g1.z;
    const float dg1 = r.d0 * g1.x + r.d1 * g1.y + r.d2 * g1.z;
    const float og2 = r.o0 * g2.x + r.o1 * g2.y + r.o2 * g2.z;
    const float dg2 = r.d0 * g2.x + r.d1 * g2.y + r.d2 * g2.z;
    const float t = (n.w - on) / dn;
    const float u = og1 + t * dg1 + g1.w;
    const float v = og2 + t * dg2 + g2.w;
    const bool tri = e.x > 0.5f;
    const bool contain = (u >= 0.f) && (u <= 1.f) && (v >= 0.f) &&
                         (tri ? (u + v <= 1.f) : (v <= 1.f));
    if (!(fabsf(dn) >= kAlmostZero) || !contain || !(t >= r.tmin)) continue;
    const int slot = static_cast<int>(e.z);
    if (t < best || (t == best && slot < best_slot)) {
      best = t;
      best_slot = slot;
    }
  }
}

__global__ void k1_bvh(const float* ox, const float* oy, const float* oz,
                       const float* dx, const float* dy, const float* dz,
                       const float* tmin_arr, float tmin,
                       const float4* __restrict__ nodes,
                       const float4* __restrict__ prims, int n_int, int n_rays,
                       float* out_t, int* out_slot) {
  extern __shared__ __align__(128) float4 smem[];
  __shared__ __align__(8) uint64_t bar;
  const int n_top = top_rows(n_int);
  const float4* top = smem;  // n_top rows of 4 float4
  int2* stack = reinterpret_cast<int2*>(smem + 4 * n_top);
  const int tid = threadIdx.x;
  const int stride = blockDim.x;

  // stage the top levels: one thread starts the bulk copy, every thread
  // reads its ray meanwhile, then all wait on the barrier's first phase
  const uint32_t bar_a = smem_addr(&bar);
  if (tid == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar_a)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    const uint32_t bytes = static_cast<uint32_t>(n_top) * 64u;
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 ::"r"(bar_a), "r"(bytes) : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::"
        "bytes [%0], [%1], %2, [%3];" ::"r"(smem_addr(smem)),
        "l"(nodes), "r"(bytes), "r"(bar_a)
        : "memory");
  }
  __syncthreads();  // the barrier is initialised before anyone waits
  const int i = blockIdx.x * blockDim.x + tid;
  Ray r{0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (i < n_rays) {
    r = Ray{ox[i], oy[i], oz[i], dx[i], dy[i], dz[i],
            tmin_arr != nullptr ? tmin_arr[i] : tmin};
  }
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(bar_a)
        : "memory");
  }
  if (i >= n_rays) return;

  float best = CUDART_INF_F;
  int best_slot = -1;
  // a parked lane (zero direction) can hit nothing: |d.n| < ALMOST_ZERO
  // for every prim
  if (r.d0 == 0.f && r.d1 == 0.f && r.d2 == 0.f) {
    out_t[i] = best;
    out_slot[i] = best_slot;
    return;
  }
  const float inv0 = 1.f / r.d0, inv1 = 1.f / r.d1, inv2 = 1.f / r.d2;

  int node = 0;
  int sp = 0;
  while (true) {
    const bool shared = node < n_top;
    float4 bx, by, bz;
    if (shared) {
      bx = top[4 * node];
      by = top[4 * node + 1];
      bz = top[4 * node + 2];
    } else {
      bx = __ldg(&nodes[4 * node]);
      by = __ldg(&nodes[4 * node + 1]);
      bz = __ldg(&nodes[4 * node + 2]);
    }
    float nl, fl, nr, fr;
    slab2(bx, r.o0, inv0, nl, fl, nr, fr, true);
    slab2(by, r.o1, inv1, nl, fl, nr, fr, false);
    slab2(bz, r.o2, inv2, nl, fl, nr, fr, false);
    nl = fmaxf(nl, 0.f);
    nr = fmaxf(nr, 0.f);
    const float lim = best * kBestScale;
    const bool hl = nl < fl * kFarScale && nl <= lim;
    const bool hr = nr < fr * kFarScale && nr <= lim;
    // the nearer entered child first (the left one on a tie)
    const bool r_first = hr && (!hl || nr < nl);
    const int left = 2 * node + 1;
    const int first = r_first ? left + 1 : left;
    const float near2 = r_first ? nl : nr;

    if (left >= n_int) {  // both children are leaves: test them now
      if (hl || hr) {
        const float4 cnt =
            shared ? top[4 * node + 3] : __ldg(&nodes[4 * node + 3]);
        const int c1 = static_cast<int>(r_first ? cnt.y : cnt.x);
        const int c2 = static_cast<int>(r_first ? cnt.x : cnt.y);
        leaf(prims, (first - n_int) * kWalkLeaf, c1, r, best, best_slot);
        if (hl && hr && near2 <= best * kBestScale) {
          leaf(prims, (2 * left + 1 - first - n_int) * kWalkLeaf, c2, r,
               best, best_slot);
        }
      }
    } else if (hl || hr) {
      if (hl && hr) {
        stack[sp * stride + tid] =
            make_int2(2 * left + 1 - first, __float_as_int(near2));
        ++sp;
      }
      node = first;
      continue;
    }
    // pop until an entry the best t has not passed
    bool found = false;
    while (sp > 0) {
      const int2 e = stack[--sp * stride + tid];
      if (__int_as_float(e.y) <= best * kBestScale) {
        node = e.x;
        found = true;
        break;
      }
    }
    if (!found) break;
  }
  out_t[i] = best;
  out_slot[i] = best_slot;
}

}  // namespace

// tmin_arr: a bound a ray, or null for the one bound tmin; levels: the
// tree's internal levels (the stack's depth); threads: the block size.
extern "C" int k1_bvh_launch(const float* ox, const float* oy,
                             const float* oz, const float* dx,
                             const float* dy, const float* dz,
                             const float* tmin_arr, float tmin,
                             const float* nodes,
                             const float* prims, int n_int, int levels,
                             int threads, int n_rays, float* out_t,
                             int* out_slot, void* stream) {
  if (n_rays <= 0) return static_cast<int>(cudaGetLastError());
  if (n_int < 1) return static_cast<int>(cudaErrorInvalidValue);
  // the staged rows, then the stack; above the default 48 KB a block may
  // take only after the attribute is raised (trees of more than ~2^22
  // leaves at 256 threads)
  const int smem = top_rows(n_int) * 64 + levels * threads * 8;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        k1_bvh, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (n_rays + threads - 1) / threads;
  k1_bvh<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      ox, oy, oz, dx, dy, dz, tmin_arr, tmin,
      reinterpret_cast<const float4*>(nodes),
      reinterpret_cast<const float4*>(prims), n_int, n_rays, out_t,
      out_slot);
  return static_cast<int>(cudaGetLastError());
}
