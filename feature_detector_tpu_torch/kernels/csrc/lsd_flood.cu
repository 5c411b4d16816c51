// LSD path-running-mean region flood: one Jacobi sweep per launch, one
// thread per pixel of the gradient grid.
//
// Replaces the Pallas TPU kernel of the JAX package:
//   K3 feature_detector_tpu/kernels/lsd_pallas.py:56 _sweep_kernel
//      (entry propagate_running_pallas :97; the LSD line detector's flood).
// Semantics of sweep_running (feature_detector_tpu/kernels/lsd.py:156-188):
// four state planes (seed priority, seed index, gate angle, path length);
// each valid pixel visits its 8 neighbours in the order of _SHIFTS and adopts
// a neighbour whose gate angle lies within tol of its own angle, wrapped to
// [-pi, pi], when the neighbour's priority is higher than the best so far, or
// equal with a lower seed index.  The best so far starts as the pixel's own
// state.  Adoption sets g = wrap(g_n + d / m), m = cnt_n + 1.
//
// Design.  The Pallas kernel keeps the padded grid (488 x 768 x 6 planes)
// in VMEM for a chunk of sweeps and rolls whole planes.  Here a sweep is one
// launch over the (rows, cols) grid, reading the previous sweep's planes and
// writing the other buffer of a ping-pong pair, so every sweep sees only the
// previous sweep's state (Jacobi, as the reference; an in-place update would
// give other labels).  Out-of-grid neighbours are skipped, which is what
// the JAX package's sentinels (priority -1, seed big) amount to, since the
// gate rejects a seed of big.  Labels stay original-grid flat indices.
// Exactly n_sweeps launches run.
//
// Exactness.  Float32 only: pi and 2 pi are float32 constants, tol arrives
// as a float, and the build uses no fast-math flag, so d / m is IEEE
// division and the comparisons happen in float32 as in XLA.  No
// multiply-add is left for -fmad to contract.
//
// Bound.  Per function call (n sweeps): the inputs are read once and the
// state written once, 37 bytes a pixel (13 MB on a 752x480 frame, 4 us at
// 3.35 TB/s); the gate work is about 20 float32 operations per valid pixel
// and neighbour per sweep (256 sweeps x ~5k valid pixels x 8 on the scenes
// of chip_smoke.py: ~0.2 G operations, 3 us at 67 TFLOP/s).  This kernel
// instead streams the whole state through L2 on every sweep (the 7.6 MB of
// state fits in the 50 MB L2) and pays one launch per sweep, so it sits far
// above that bound: it is launch- and latency-bound.  Several sweeps per
// launch over tiles with halos as wide as their sweep count, skipping
// invalid tiles, or a CUDA graph of the launches, are later work.

#include <cuda_runtime.h>

namespace {

constexpr float kPi = 0x1.921fb6p+1f;     // float32(pi)
constexpr float kTwoPi = 0x1.921fb6p+2f;  // float32(2 pi)

__device__ __forceinline__ float wrap(float d) {
  d = d > kPi ? d - kTwoPi : d;
  return d < -kPi ? d + kTwoPi : d;
}

__global__ void __launch_bounds__(256)
flood_sweep(const float* __restrict__ angle, const unsigned char* __restrict__ valid,
            const float* __restrict__ pri, const int* __restrict__ seed,
            const float* __restrict__ gang, const float* __restrict__ cnt,
            float* __restrict__ pri_o, int* __restrict__ seed_o,
            float* __restrict__ gang_o, float* __restrict__ cnt_o,
            int rows, int cols, float tol, int big) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y * blockDim.y + threadIdx.y;
  if (r >= rows || c >= cols) return;
  const int i = r * cols + c;
  float bp = pri[i];
  int bs = seed[i];
  float bg = gang[i];
  float bm = cnt[i];
  if (valid[i]) {
    const float a = angle[i];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      // _SHIFTS order: (-1,-1) (-1,0) (-1,1) (0,-1) (0,1) (1,-1) (1,0) (1,1).
      const int cell = k < 4 ? k : k + 1;
      const int rr = r + cell / 3 - 1;
      const int cc = c + cell % 3 - 1;
      if (rr < 0 || rr >= rows || cc < 0 || cc >= cols) continue;
      const int j = rr * cols + cc;
      const int ns = seed[j];
      if (ns >= big) continue;
      const float ng = gang[j];
      const float d = wrap(a - ng);
      if (!(fabsf(d) <= tol)) continue;
      const float np = pri[j];
      if (np > bp || (np == bp && ns < bs)) {
        const float m = cnt[j] + 1.0f;
        bp = np;
        bs = ns;
        bg = wrap(ng + d / m);
        bm = m;
      }
    }
  }
  pri_o[i] = bp;
  seed_o[i] = bs;
  gang_o[i] = bg;
  cnt_o[i] = bm;
}

}  // namespace

// C interface, loaded with ctypes.  All planes [rows, cols], contiguous, on
// one device: angle f32, valid bool (one byte), the input state (pri f32,
// seed int32, gang f32, cnt f32) and two output buffer sets A and B of the
// same types.  Sweep s reads the input state (s = 0) or the buffer the sweep
// before wrote, and writes A when s is even, B when odd; the input is never
// written.  The caller reads the result from A when n_sweeps is odd, from B
// when it is even (A and B may be the same set when n_sweeps is 1).
// Returns the first failing launch's cudaError_t, 0 on success.
extern "C" int fd_lsd_flood(const void* angle, const void* valid,
                            const void* pri, const void* seed, const void* gang, const void* cnt,
                            void* pri_a, void* seed_a, void* gang_a, void* cnt_a,
                            void* pri_b, void* seed_b, void* gang_b, void* cnt_b,
                            int rows, int cols, int n_sweeps, float tol, void* stream) {
  const dim3 block(32, 8);
  const dim3 grid((cols + block.x - 1) / block.x, (rows + block.y - 1) / block.y);
  const int big = rows * cols + 1;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const void* src[4] = {pri, seed, gang, cnt};
  void* const dst_a[4] = {pri_a, seed_a, gang_a, cnt_a};
  void* const dst_b[4] = {pri_b, seed_b, gang_b, cnt_b};
  for (int s = 0; s < n_sweeps; ++s) {
    void* const* dst = (s % 2 == 0) ? dst_a : dst_b;
    flood_sweep<<<grid, block, 0, st>>>(
        static_cast<const float*>(angle), static_cast<const unsigned char*>(valid),
        static_cast<const float*>(src[0]), static_cast<const int*>(src[1]),
        static_cast<const float*>(src[2]), static_cast<const float*>(src[3]),
        static_cast<float*>(dst[0]), static_cast<int*>(dst[1]),
        static_cast<float*>(dst[2]), static_cast<float*>(dst[3]), rows, cols, tol, big);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    for (int p = 0; p < 4; ++p) src[p] = dst[p];
  }
  return 0;
}
