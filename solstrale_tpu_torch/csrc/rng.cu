// The counter-hash draws: four uniforms in [0, 1) per lane from PCG4D of
// (pixel, sample, bounce, purpose, seed), in one launch.
//
// Replaces the JAX package's PCG4D chains (solstrale_tpu/ops/rng.py:68
// uniform4: _pcg4d and _to_unit_float), which XLA fuses into one fusion
// per draw inside the jitted batch. The port's plain version
// (ops/rng.py::uniform4_plain) runs the same chain as ~67 int64 and f32
// torch kernels: uint32 lanes held in int64 and masked after every
// multiply and add. This kernel computes the words in uint32 registers with
// the device function K3-K5 already draw with (hit::uniform4), so each
// draw of the wavefront is one launch, bit-equal to the plain chain.
//
// Bound by bytes: per lane the counters are read once (4 or 8 bytes each,
// none for a scalar) and four f32 are written (16 bytes); the hash is ~30
// integer operations a lane. One thread a lane; the four outputs are rows
// of a (4, n) array, so each row's stores coalesce.
#include "hit.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    rng_uniform4(hit::Counter pix, hit::Counter sample, hit::Counter bounce,
                 uint32_t purpose, hit::Counter seed, long long n,
                 float* out) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (i >= n) return;
  const float4 u = hit::uniform4(pix.at(i), sample.at(i), bounce.at(i),
                                 purpose, seed.at(i));
  out[i] = u.x;
  out[n + i] = u.y;
  out[2 * n + i] = u.z;
  out[3 * n + i] = u.w;
}

}  // namespace

// Each counter: (pointer or null, element size 4 or 8, stride 0 or 1,
// value when the pointer is null). out: (4, n) f32.
extern "C" int rng_uniform4_launch(
    const void* pix, int pix_size, int pix_stride, unsigned int pix_value,
    const void* sample, int sample_size, int sample_stride,
    unsigned int sample_value, const void* bounce, int bounce_size,
    int bounce_stride, unsigned int bounce_value, unsigned int purpose,
    const void* seed, int seed_size, int seed_stride,
    unsigned int seed_value, long long n, float* out, void* stream) {
  if (n > 0) {
    const long long blocks = (n + kThreads - 1) / kThreads;
    rng_uniform4<<<static_cast<unsigned int>(blocks), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
        hit::Counter{pix, pix_size, pix_stride, pix_value},
        hit::Counter{sample, sample_size, sample_stride, sample_value},
        hit::Counter{bounce, bounce_size, bounce_stride, bounce_value},
        purpose,
        hit::Counter{seed, seed_size, seed_stride, seed_value}, n, out);
  }
  return static_cast<int>(cudaGetLastError());
}
