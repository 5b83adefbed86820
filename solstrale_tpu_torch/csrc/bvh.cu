// Closest planar (quad + triangle) hit through the BVH (K1).
//
// Replaces the TPU kernel solstrale_tpu/ops/pallas_bvh.py::_bvh_kernel
// (launched by _bvh_chunk, reached through bvh_planar_hit_pallas). Output
// contract of that kernel: per ray the closest t >= tmin over every planar
// prim (no upper bound) and its planar slot, ties to the smallest slot;
// INF / -1 on a miss.
//
// Design: one thread per ray walking the complete binary tree (children of
// node i are 2i+1 and 2i+2) with an explicit per-ray stack. At each pop the
// node's box gets the slab test; a node whose entry distance is at or
// beyond the ray's current best t is pruned. Internal nodes push the far
// child first, so the near child -- by the sign of the ray direction along
// the node's split axis -- is visited first and tightens the best t early.
// Leaves brute-force their prims with the TPU kernel's unified formula
// (pallas_bvh.py:250-264): t = (d_pl - o.n)/(d.n), u = o.g1 + t*(d.g1) +
// g1o, v likewise, containment by is_tri.
//
// What bounds it on the card: the latency of divergent, data-dependent node
// and prim loads (every thread chases its own path through the tree), not
// FLOPs -- a leaf test is ~40 flops against 64 bytes of prim data. The
// design keeps nodes (32 B) and prims (64 B) as aligned float4 rows so each
// visit is two or four 16-byte loads, and lets the read-only path and the
// 50 MB L2 hold the upper tree. Packet traversal, ray sorting and a wider
// tree are later work.
//
// Tables (f32, 16-byte aligned rows; built by accel.build_kernel_bvh):
//   nodes (2*n_leaves-1, 8): minx miny minz maxx maxy maxz split_axis 0,
//         empty subtrees stored as a far-away point box (always missed)
//   prims (n_leaves*leaf_size, 16): nx ny nz d g1xyz g1o g2xyz g2o
//         is_tri valid slot 0
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 128;
constexpr int kStack = 64;            // > tree depth + 1 (checked on the host)
constexpr float kAlmostZero = 1e-8f;  // geo.ALMOST_ZERO (vec3.rs:21)
// far-plane widening (a few ulps) so rounding in the slab test never drops
// a box the ray really crosses: traversal stays conservative
constexpr float kFarScale = 1.0000004f;

__global__ void k1_bvh(const float* ox, const float* oy, const float* oz,
                       const float* dx, const float* dy, const float* dz,
                       const float* tmin_arr, const float4* __restrict__ nodes,
                       const float4* __restrict__ prims, int n_leaves,
                       int leaf_size, int n_rays, float* out_t,
                       int* out_slot) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;
  const float o0 = ox[i], o1 = oy[i], o2 = oz[i];
  const float d0 = dx[i], d1 = dy[i], d2 = dz[i];
  const float tmin = tmin_arr[i];
  float best = CUDART_INF_F;
  int best_slot = -1;
  // a parked lane (zero direction) can hit nothing: |d.n| < ALMOST_ZERO
  // for every prim
  if (d0 == 0.f && d1 == 0.f && d2 == 0.f) {
    out_t[i] = best;
    out_slot[i] = best_slot;
    return;
  }
  const float inv0 = 1.f / d0, inv1 = 1.f / d1, inv2 = 1.f / d2;
  const int first_leaf = n_leaves - 1;

  int stack[kStack];
  int sp = 0;
  stack[sp++] = 0;
  while (sp > 0) {
    const int node = stack[--sp];
    const float4 a = __ldg(&nodes[2 * node]);      // minx miny minz maxx
    const float4 b = __ldg(&nodes[2 * node + 1]);  // maxy maxz axis 0
    float t0 = (a.x - o0) * inv0, t1 = (a.w - o0) * inv0;
    float near = fminf(t0, t1), far = fmaxf(t0, t1);
    t0 = (a.y - o1) * inv1; t1 = (b.x - o1) * inv1;
    near = fmaxf(near, fminf(t0, t1)); far = fminf(far, fmaxf(t0, t1));
    t0 = (a.z - o2) * inv2; t1 = (b.y - o2) * inv2;
    near = fmaxf(near, fminf(t0, t1)); far = fminf(far, fmaxf(t0, t1));
    near = fmaxf(near, 0.f);
    // non-empty interval (strict, like Aabb::hit) that can still beat best
    if (!(near < far * kFarScale) || near >= best) continue;

    if (node < first_leaf) {
      const int axis = static_cast<int>(b.z);
      const float s = axis == 0 ? d0 : (axis == 1 ? d1 : d2);
      const int left = 2 * node + 1;
      const int near_child = s < 0.f ? left + 1 : left;
      stack[sp++] = s < 0.f ? left : left + 1;  // far child, popped later
      stack[sp++] = near_child;
      continue;
    }
    const int base = (node - first_leaf) * leaf_size;
    for (int k = 0; k < leaf_size; ++k) {
      const float4* row = prims + 4 * (base + k);
      const float4 e = __ldg(&row[3]);  // is_tri valid slot 0
      if (!(e.y > 0.5f)) continue;      // padding slot
      const float4 n = __ldg(&row[0]);
      const float4 g1 = __ldg(&row[1]);
      const float4 g2 = __ldg(&row[2]);
      const float on = o0 * n.x + o1 * n.y + o2 * n.z;
      const float dn = d0 * n.x + d1 * n.y + d2 * n.z;
      const float og1 = o0 * g1.x + o1 * g1.y + o2 * g1.z;
      const float dg1 = d0 * g1.x + d1 * g1.y + d2 * g1.z;
      const float og2 = o0 * g2.x + o1 * g2.y + o2 * g2.z;
      const float dg2 = d0 * g2.x + d1 * g2.y + d2 * g2.z;
      const float t = (n.w - on) / dn;
      const float u = og1 + t * dg1 + g1.w;
      const float v = og2 + t * dg2 + g2.w;
      const bool tri = e.x > 0.5f;
      const bool contain = (u >= 0.f) && (u <= 1.f) && (v >= 0.f) &&
                           (tri ? (u + v <= 1.f) : (v <= 1.f));
      if (!(fabsf(dn) >= kAlmostZero) || !contain || !(t >= tmin)) continue;
      const int slot = static_cast<int>(e.z);
      if (t < best || (t == best && slot < best_slot)) {
        best = t;
        best_slot = slot;
      }
    }
  }
  out_t[i] = best;
  out_slot[i] = best_slot;
}

}  // namespace

extern "C" int k1_bvh_launch(const float* ox, const float* oy,
                             const float* oz, const float* dx,
                             const float* dy, const float* dz,
                             const float* tmin, const float* nodes,
                             const float* prims, int n_leaves, int leaf_size,
                             int n_rays, float* out_t, int* out_slot,
                             void* stream) {
  if (n_rays > 0) {
    const int blocks = (n_rays + kThreads - 1) / kThreads;
    k1_bvh<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        ox, oy, oz, dx, dy, dz, tmin, reinterpret_cast<const float4*>(nodes),
        reinterpret_cast<const float4*>(prims), n_leaves, leaf_size, n_rays,
        out_t, out_slot);
  }
  return static_cast<int>(cudaGetLastError());
}
