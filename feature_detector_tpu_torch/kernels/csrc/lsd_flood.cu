// LSD path-running-mean region flood: 16 Jacobi sweeps per launch over
// 32x32 tiles held with a 16-pixel halo in shared memory.
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
// state.  Adoption sets g = wrap(g_n + d / m), m = cnt_n + 1.  Sweeps are
// Jacobi: each reads only the previous sweep's state.
//
// Bound.  Per call (n sweeps): the inputs are read once and the state
// written once, 37 bytes a pixel (13 MB on a 752x480 frame, 4 us at
// 3.35 TB/s); the gate work is about 20 float32 operations per valid pixel
// and neighbour per sweep (~0.2 G operations for 256 sweeps on the scenes
// of chip_smoke.py, 3 us at 67 TFLOP/s).  One launch per sweep, each
// streaming the whole state through L2, was launch- and latency-bound at
// about 7 us a sweep on an H100 (PERF.md), nearly all of it on pixels that
// cannot change: an invalid pixel never changes its state, and 98-99% of a
// frame's pixels are invalid.  This design is latency-bound too, on the
// chain of shared-memory reads and the two block barriers of each sweep in
// the few tiles that hold most of a frame's valid pixels.
//
// Design.
//   - Temporal blocking.  A launch runs up to K = 16 sweeps (8 and 32 were
//     slower on an H100, PERF.md).  A block loads its tile's region, the
//     tile grown by K pixels on each side and clipped to the grid, into
//     shared memory, runs the sweeps there and writes back only the tile.
//     Neighbours outside the region are skipped: at the grid's edge that is
//     the reference's rule, and elsewhere the error it makes moves inward
//     one pixel a sweep, so after s <= K sweeps it has not reached the
//     tile.  For the same reason sweep t of s computes only the pixels
//     within s - t of the tile: the tile never reads the others again.
//     ceil(n / K) launches run exactly n sweeps.
//   - Work only where pixels change.  A tile with no valid pixel keeps its
//     state: the first launch copies it into both output buffers and every
//     launch skips it.  In a live tile 1,024 threads loop over a list of the
//     region's valid pixels built at load (one shared atomic a warp), not
//     over the whole region.  A thread keeps its pixels' new state in
//     registers between the sweep's two barriers (read all, then write all).
//   - Latency.  Every load of the region, and of a pixel's eight neighbours,
//     is issued before any is used.  The region's rows are padded to an odd
//     pitch, so that a vertical edge, listed one row after another, spreads
//     over all 32 banks.

// Exactness.  Float32 only: pi and 2 pi are float32 constants, tol arrives
// as a float, and the build uses no fast-math flag, so d / m is IEEE
// division and the comparisons happen in float32 as in XLA.  No
// multiply-add is left for -fmad to contract.  Each plane equals the plain
// version bit for bit.

#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr float kPi = 0x1.921fb6p+1f;     // float32(pi)
constexpr float kTwoPi = 0x1.921fb6p+2f;  // float32(2 pi)
constexpr int kTileSide = 32;
constexpr int kThreads = 1024;
constexpr int K = 16;  // sweeps per launch, and the halo's width

// Neighbour k in _SHIFTS order: (-1,-1) (-1,0) (-1,1) (0,-1) (0,1) (1,-1)
// (1,0) (1,1); cell k < 4 ? k : k + 1 of the 3x3 window.
__host__ __device__ constexpr int shift_r(int k) { return (k < 4 ? k : k + 1) / 3 - 1; }
__host__ __device__ constexpr int shift_c(int k) { return (k < 4 ? k : k + 1) % 3 - 1; }

__device__ __forceinline__ float wrap(float d) {
  d = d > kPi ? d - kTwoPi : d;
  return d < -kPi ? d + kTwoPi : d;
}

constexpr int kSide = kTileSide + 2 * K;  // region side
// Row pitch in shared memory: odd, so that a column of pixels (a vertical
// edge, listed one row after another) spreads over all 32 banks.
constexpr int kPitch = kSide + 1;
constexpr int kArea = kSide * kPitch;
constexpr int kSlots = (kSide * kSide + kThreads - 1) / kThreads;  // list entries per thread
// 4 state planes per pixel; angle and position per list entry.
constexpr size_t kSmem = (size_t)kArea * (4 * 4 + 4 + 2);

struct Planes {
  float* pri;
  int* seed;
  float* gang;
  float* cnt;
};

__device__ __forceinline__ void copy_pixel(const Planes& src, const Planes& dst, size_t g) {
  dst.pri[g] = src.pri[g];
  dst.seed[g] = src.seed[g];
  dst.gang[g] = src.gang[g];
  dst.cnt[g] = src.cnt[g];
}

// One launch: s sweeps of tile (blockIdx.y, blockIdx.x), reading src and
// writing the tile's state to dst.  On the first launch (fill.pri set) a
// tile without valid pixels copies src into dst and fill instead.
__global__ void __launch_bounds__(kThreads, 1)
flood_tiles(const float* __restrict__ angle, const unsigned char* __restrict__ valid, Planes src, Planes dst,
            Planes fill, int rows, int cols, int s, float tol, int big) {
  constexpr int R = kPitch, T = kThreads, S = kSlots;
  extern __shared__ float smem[];
  float* s_pri = smem;
  int* s_seed = reinterpret_cast<int*>(s_pri + kArea);
  float* s_gang = reinterpret_cast<float*>(s_seed + kArea);
  float* s_cnt = s_gang + kArea;
  float* s_ang = s_cnt + kArea;  // angle of list entry p
  unsigned short* s_list = reinterpret_cast<unsigned short*>(s_ang + kArea);  // position of entry p
  __shared__ int s_n;

  const int tid = threadIdx.x, lane = tid & 31;
  const int ir0 = blockIdx.y * kTileSide, ic0 = blockIdx.x * kTileSide;
  const int iw = min(cols, ic0 + kTileSide) - ic0;
  const int n_in = (min(rows, ir0 + kTileSide) - ir0) * iw;

  // 1. A tile without valid pixels never changes.
  int live = 0;
  for (int q = tid; q < n_in; q += T) live |= valid[(size_t)(ir0 + q / iw) * cols + ic0 + q % iw];
  if (!__syncthreads_or(live)) {
    if (fill.pri != nullptr) {
      for (int q = tid; q < n_in; q += T) {
        const size_t g = (size_t)(ir0 + q / iw) * cols + ic0 + q % iw;
        copy_pixel(src, dst, g);
        copy_pixel(src, fill, g);
      }
    }
    return;
  }

  // 2. Load the region; list its valid pixels (one shared atomic a warp)
  //    with their angles.
  const int r_lo = max(0, ir0 - K), c_lo = max(0, ic0 - K);
  const int rh = min(rows, ir0 + kTileSide + K) - r_lo, rw = min(cols, ic0 + kTileSide + K) - c_lo;
  // Distance of region position q from the tile, in rows or columns.
  const int t_r = ir0 - r_lo, t_c = ic0 - c_lo;  // the tile's first row and column in the region
  auto dist = [&](int q) {
    const int lr = q / R, lc = q % R;
    return max(max(max(t_r - lr, lr - (t_r + kTileSide - 1)), max(t_c - lc, lc - (t_c + kTileSide - 1))), 0);
  };
  if (tid == 0) s_n = 0;
  __syncthreads();
  constexpr int L = (kArea + T - 1) / T;  // region pixels per thread
  bool v[L];
  float ang[L];
#pragma unroll
  for (int it = 0; it < L; ++it) {  // every load in flight at once
    const int q = it * T + tid, lc = q % R;
    v[it] = false;
    if (q < rh * R && lc < rw) {
      const size_t g = (size_t)(r_lo + q / R) * cols + c_lo + lc;
      s_pri[q] = src.pri[g];
      s_seed[q] = src.seed[g];
      s_gang[q] = src.gang[g];
      s_cnt[q] = src.cnt[g];
      ang[it] = angle[g];
      v[it] = valid[g];
    }
  }
#pragma unroll
  for (int it = 0; it < L; ++it) {
    const unsigned ballot = __ballot_sync(0xffffffffu, v[it]);
    int base = 0;
    if (lane == 0 && ballot != 0u) base = atomicAdd(&s_n, __popc(ballot));
    base = __shfl_sync(0xffffffffu, base, 0);
    if (v[it]) {
      const int p = base + __popc(ballot & ((1u << lane) - 1u));
      s_list[p] = (unsigned short)(it * T + tid);
      s_ang[p] = ang[it];
    }
  }
  __syncthreads();
  const int n = s_n;

  // 3. s Jacobi sweeps: every listed pixel reads the previous state, then
  //    all write.  A pixel d rows or columns outside the tile reaches the
  //    tile in d more sweeps, so its state after sweep t (1-based) matters
  //    only while d <= s - t.  Sweep t computes only those pixels; the
  //    others keep a state that nothing reads any more.
  float np[S], ng[S], nm[S];
  int ns[S];
  for (int sweep = 0; sweep < s; ++sweep) {
    const int reach = s - 1 - sweep;  // farthest distance still needed
#pragma unroll
    for (int m = 0; m < S; ++m) {
      const int p = tid + m * T;
      if (p >= n) continue;
      const int q = s_list[p];
      if (dist(q) > reach) continue;
      // Every neighbour's seed, gate angle and priority first (independent
      // loads); a neighbour outside the region gets the sentinel seed.
      const int lr = q / R, lc = q % R;
      int nsv[8];
      float ngv[8], npv[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int dr = shift_r(k), dc = shift_c(k);
        const bool inside = lr + dr >= 0 && lr + dr < rh && lc + dc >= 0 && lc + dc < rw;
        const int j = inside ? q + dr * R + dc : q;
        const int seed_j = s_seed[j];
        nsv[k] = inside ? seed_j : big;
        ngv[k] = s_gang[j];
        npv[k] = s_pri[j];
      }
      const float a = s_ang[p];
      float bp = s_pri[q];
      int bs = s_seed[q];
      float bg = s_gang[q];
      float bm = s_cnt[q];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        if (nsv[k] >= big) continue;
        const float d = wrap(a - ngv[k]);
        if (!(fabsf(d) <= tol)) continue;
        if (npv[k] > bp || (npv[k] == bp && nsv[k] < bs)) {
          const float mm = s_cnt[q + shift_r(k) * R + shift_c(k)] + 1.0f;
          bp = npv[k];
          bs = nsv[k];
          bg = wrap(ngv[k] + d / mm);
          bm = mm;
        }
      }
      np[m] = bp;
      ns[m] = bs;
      ng[m] = bg;
      nm[m] = bm;
    }
    __syncthreads();
#pragma unroll
    for (int m = 0; m < S; ++m) {
      const int p = tid + m * T;
      if (p >= n) continue;
      const int q = s_list[p];
      if (dist(q) > reach) continue;
      s_pri[q] = np[m];
      s_seed[q] = ns[m];
      s_gang[q] = ng[m];
      s_cnt[q] = nm[m];
    }
    __syncthreads();
  }

  // 4. Write back the tile.
  for (int q = tid; q < n_in; q += T) {
    const int gr = ir0 + q / iw, gc = ic0 + q % iw;
    const int l = (gr - r_lo) * R + gc - c_lo;
    const size_t g = (size_t)gr * cols + gc;
    dst.pri[g] = s_pri[l];
    dst.seed[g] = s_seed[l];
    dst.gang[g] = s_gang[l];
    dst.cnt[g] = s_cnt[l];
  }
}

}  // namespace

// C interface, loaded with ctypes.  All planes [rows, cols], contiguous, on
// one device: angle f32, valid bool (one byte), the input state (pri f32,
// seed int32, gang f32, cnt f32) and two output buffer sets A and B of the
// same types.  Launch j (of ceil(n_sweeps / 16)) reads the input state
// (j = 0) or the set the launch before wrote, and writes A when j is even, B
// when odd; the input is never written.  The caller reads the result from A
// when the launch count is odd, from B when it is even (A and B may be the
// same set when there is one launch).  Returns the first failing launch's
// cudaError_t, 0 on success.
extern "C" int fd_lsd_flood(const void* angle_, const void* valid_,
                            const void* pri, const void* seed, const void* gang, const void* cnt,
                            void* pri_a, void* seed_a, void* gang_a, void* cnt_a,
                            void* pri_b, void* seed_b, void* gang_b, void* cnt_b,
                            int rows, int cols, int n_sweeps, float tol, void* stream) {
  const Planes in = {const_cast<float*>(static_cast<const float*>(pri)), const_cast<int*>(static_cast<const int*>(seed)),
                     const_cast<float*>(static_cast<const float*>(gang)), const_cast<float*>(static_cast<const float*>(cnt))};
  const Planes a = {static_cast<float*>(pri_a), static_cast<int*>(seed_a), static_cast<float*>(gang_a),
                    static_cast<float*>(cnt_a)};
  const Planes b = {static_cast<float*>(pri_b), static_cast<int*>(seed_b), static_cast<float*>(gang_b),
                    static_cast<float*>(cnt_b)};
  const float* angle = static_cast<const float*>(angle_);
  const unsigned char* valid = static_cast<const unsigned char*>(valid_);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t attr = cudaFuncSetAttribute(flood_tiles, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((cols + kTileSide - 1) / kTileSide, (rows + kTileSide - 1) / kTileSide);
  const int big = rows * cols + 1;
  const Planes none = {nullptr, nullptr, nullptr, nullptr};
  Planes src = in;
  for (int j = 0; j * K < n_sweeps; ++j) {
    const Planes dst = (j % 2 == 0) ? a : b;
    flood_tiles<<<grid, kThreads, kSmem, st>>>(angle, valid, src, dst, j == 0 ? b : none, rows, cols,
                                               std::min(K, n_sweeps - j * K), tol, big);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    src = dst;
  }
  return 0;
}
