// Greedy response-ordered feature selection with square suppression: a key
// pass over the whole card, then one pick chain per frame on keys held in
// shared memory.
//
// Replaces the two Pallas TPU kernels of the JAX package:
//   K1 feature_detector_tpu/kernels/greedy_pallas.py:145 _kernel_batched
//      (batched front-end, detect_good_features_batch), and
//   K2 feature_detector_tpu/kernels/greedy_pallas.py:35 _kernel
//      (single frame and incremental re-detect; launched here with B = 1).
// Semantics of greedy_select_lax (feature_detector_tpu/kernels/detect.py:228):
// per frame, up to max_picks picks; each takes the global maximum of the
// working map, first in row-major order, if val > 0 and i < n_stop[f], and
// zeroes the clipped (2r+1)^2 square around it.  A frame stops at its first
// untaken pick; the output slots after it stay 0 (the wrapper zero-fills).
//
// Bound.  The least work is one read of every map (92 MB at 64 x 480 x 752,
// 0.028 ms at 3.35 TB/s).  The picks of a frame are a chain of dependent
// steps, each two block barriers and a few shared-memory round trips, so
// the chain's latency, not bytes or operations, bounds the kernel: the
// batch lasts as long as its longest chain.
//
// Design.
//   - Keys.  A candidate is one 64-bit key, (float bits of val) << 32 |
//     (0xFFFFFFFF - flat index).  Positive floats order as their bits, so
//     the largest key is the largest value, first in row-major order among
//     equals.  Values <= 0 (-0 included) and NaN key to 0 and are never
//     taken: the plain version's val > 0 stop.  A frame must hold fewer than
//     2^32 - 1 pixels (the wrapper checks).  A warp's largest key takes two
//     redux.sync instructions, high word then low word.
//   - Launch 1 (tile_keys_kernel) spreads over the whole card: one warp per
//     16x16 tile reads the map once and writes the tile's largest key, its
//     kCache largest keys and its count of positive pixels.
//   - Launch 2 (pick_kernel), one block per frame, keeps in shared memory
//     the tile keys (1,410 at 480x752), one key per group of 32 tiles, the
//     tiles' cached keys and a suppression bitmap (1 bit a pixel); the
//     caller's map is only read.  A pick is the largest group key, computed
//     by every warp at once so that no barrier broadcasts it; the key itself
//     gives the value and the index.  Then one warp per tile the square
//     touches (<= 16 at r <= 24) sets the square's bits in that tile and
//     recomputes the tile's key, masking the earlier picks' bits and the new
//     square: from its cached keys when they hold all its positive pixels
//     (nearly every tile of a sparse candidate map), else from the map in
//     L2.  Last, the touched group keys.  Two barriers a pick.
//   - A map whose state does not fit in shared memory keeps the same state
//     in a global workspace instead (the wrapper allocates it).
// Values are copied, never computed, so the outputs equal the plain version
// bit for bit.

#include <cuda_runtime.h>

#include <algorithm>

namespace {

typedef unsigned long long u64;

constexpr int kTile = 16;      // tile side, px; one warp covers a tile
constexpr int kCache = 4;      // largest keys kept per tile
constexpr int kGroup = 32;     // tile keys per group key
constexpr int kKeyWarps = 8;   // warps per block of the key pass
constexpr int kThreads = 512;  // pick-chain block
constexpr int kWarps = kThreads / 32;

// A frame's workspace: tile keys [n_tiles], cached keys [n_tiles][kCache],
// positive counts [n_tiles] (int32), all written by launch 1; then group
// keys [n_groups] and the bitmap [rows][words_per_row], used by launch 2.
struct Layout {
  int tiles_x, n_tiles, n_groups, words_per_row;
  size_t n_words;      // suppression bitmap, 32-bit words
  size_t keys_bytes;   // what launch 1 writes
  size_t state_bytes;  // all of launch 2's state
};

Layout layout(int rows, int cols) {
  Layout l;
  l.tiles_x = (cols + kTile - 1) / kTile;
  l.n_tiles = l.tiles_x * ((rows + kTile - 1) / kTile);
  l.n_groups = (l.n_tiles + kGroup - 1) / kGroup;
  l.words_per_row = (cols + 31) / 32;
  l.n_words = (size_t)rows * l.words_per_row;
  l.keys_bytes = 8 * (size_t)l.n_tiles * (1 + kCache) + 8 * (((size_t)l.n_tiles + 1) / 2);
  l.state_bytes = l.keys_bytes + 8 * (size_t)l.n_groups + 4 * ((l.n_words + 1) & ~(size_t)1);
  return l;
}

__device__ __forceinline__ u64 max_key(u64 a, u64 b) { return a > b ? a : b; }

// The largest key across the warp: largest high word, then the largest low
// word among the lanes that hold it.
__device__ __forceinline__ u64 warp_max(u64 k) {
  const unsigned hi = __reduce_max_sync(0xffffffffu, (unsigned)(k >> 32));
  const unsigned lo = __reduce_max_sync(0xffffffffu, (unsigned)(k >> 32) == hi ? (unsigned)k : 0u);
  return ((u64)hi << 32) | lo;
}

__device__ __forceinline__ u64 key_of(float v, unsigned flat) {
  return ((u64)__float_as_uint(v) << 32) | (0xFFFFFFFFu - flat);
}

// The keys of tile (ty, tx) for one warp: lane covers column lane % 16 and
// rows lane / 16 + 2 j.  Every load is issued before the first key is
// formed.  Pixels inside the box y0..y1 x x0..x1, or whose bit is set in
// `bits` (when given), key to 0.
__device__ __forceinline__ void pixel_keys(const float* __restrict__ map, int rows, int cols, int ty, int tx,
                                           const unsigned* bits, int words_per_row,
                                           int y0, int y1, int x0, int x1, u64 k[kTile / 2]) {
  const int lane = threadIdx.x & 31;
  const int c = tx * kTile + (lane & 15);
  const int r0 = ty * kTile + (lane >> 4);
  float v[kTile / 2];
#pragma unroll
  for (int j = 0; j < kTile / 2; ++j) {
    const int r = r0 + 2 * j;
    v[j] = (r < rows && c < cols) ? __ldg(map + (size_t)r * cols + c) : 0.0f;
  }
#pragma unroll
  for (int j = 0; j < kTile / 2; ++j) {
    const int r = r0 + 2 * j;
    bool live = v[j] > 0.0f && !(r >= y0 && r <= y1 && c >= x0 && c <= x1);
    if (bits != nullptr && live) live = !((bits[(size_t)r * words_per_row + (c >> 5)] >> (c & 31)) & 1u);
    k[j] = live ? key_of(v[j], (unsigned)r * (unsigned)cols + (unsigned)c) : 0ull;
  }
}

__device__ __forceinline__ u64 lane_max(const u64 k[kTile / 2]) {
  u64 b = 0;
#pragma unroll
  for (int j = 0; j < kTile / 2; ++j) b = max_key(b, k[j]);
  return b;
}

// Launch 1: per tile of every frame, the largest key, the kCache largest
// keys (0 past the last positive pixel) and the count of positive pixels.
__global__ void __launch_bounds__(kKeyWarps * 32)
tile_keys_kernel(const float* __restrict__ cand, u64* __restrict__ ws, size_t ws_stride,
                 int batch, int rows, int cols, Layout l) {
  const int t = blockIdx.x * kKeyWarps + (threadIdx.x >> 5);
  if (t >= l.n_tiles) return;  // uniform across the warp
  const int lane = threadIdx.x & 31;
  for (int f = blockIdx.y; f < batch; f += gridDim.y) {
    u64 k[kTile / 2];
    pixel_keys(cand + (size_t)f * rows * cols, rows, cols, t / l.tiles_x, t % l.tiles_x, nullptr, 0, 1, 0, 1, 0, k);
    u64* w = ws + f * ws_stride;
    int n = 0;
#pragma unroll
    for (int j = 0; j < kTile / 2; ++j) n += k[j] != 0ull;
    n = __reduce_add_sync(0xffffffffu, n);
    u64 top = warp_max(lane_max(k));
    if (lane == 0) w[t] = top;
#pragma unroll
    for (int c = 0; c < kCache; ++c) {  // keys are distinct: drop the top one, take the next
      if (lane == 0) w[l.n_tiles + (size_t)t * kCache + c] = top;
#pragma unroll
      for (int j = 0; j < kTile / 2; ++j) k[j] = k[j] == top ? 0ull : k[j];
      top = warp_max(lane_max(k));
    }
    if (lane == 0) reinterpret_cast<int*>(w + (size_t)l.n_tiles * (1 + kCache))[t] = n;
  }
}

// Recomputes group key g from the tile keys, one warp.
__device__ __forceinline__ void group_key(const u64* tk, u64* gk, int g, int n_tiles) {
  const int t = g * kGroup + (threadIdx.x & 31);
  const u64 k = warp_max(t < n_tiles ? tk[t] : 0ull);
  if ((threadIdx.x & 31) == 0) gk[g] = k;
}

// Launch 2: the pick chain of frame blockIdx.x.  With kShared the block
// copies launch 1's part of the workspace into shared memory and keeps the
// rest of its state there too; otherwise all of it stays in the workspace.
template <bool kShared>
__global__ void __launch_bounds__(kThreads)
pick_kernel(const float* __restrict__ cand, const int* __restrict__ n_stop, u64* ws, size_t ws_stride,
            float* __restrict__ out, int rows, int cols, int max_picks, int radius, Layout l) {
  extern __shared__ u64 smem[];
  const int f = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* map = cand + (size_t)f * rows * cols;
  float* o = out + (size_t)f * max_picks * 4;
  const int stop = n_stop[f];
  u64* frame_ws = ws + (size_t)f * ws_stride;
  u64* tk = kShared ? smem : frame_ws;
  const u64* cache = tk + l.n_tiles;
  const int* count = reinterpret_cast<const int*>(cache + (size_t)l.n_tiles * kCache);
  u64* gk = tk + l.keys_bytes / 8;
  unsigned* bits = reinterpret_cast<unsigned*>(gk + l.n_groups);

  if (kShared) {
    for (size_t w = tid; w < l.keys_bytes / 8; w += kThreads) tk[w] = frame_ws[w];
  }
  for (size_t w = tid; w < l.n_words; w += kThreads) bits[w] = 0u;
  __syncthreads();
  for (int g = warp; g < l.n_groups; g += kWarps) group_key(tk, gk, g, l.n_tiles);
  __syncthreads();

  for (int i = 0; i < max_picks; ++i) {
    // 1. Every warp takes the largest group key: the pick, the same in all.
    u64 best = 0;
    for (int g = lane; g < l.n_groups; g += 32) best = max_key(best, gk[g]);
    best = warp_max(best);
    if (best == 0ull || i >= stop) break;  // uniform across the block
    const unsigned flat = 0xFFFFFFFFu - (unsigned)best;
    const int y = (int)(flat / (unsigned)cols), x = (int)(flat % (unsigned)cols);
    if (tid == 0) {
      o[4 * i + 0] = (float)x;
      o[4 * i + 1] = (float)y;
      o[4 * i + 2] = __uint_as_float((unsigned)(best >> 32));
      o[4 * i + 3] = 1.0f;
    }
    const int y0 = max(0, y - radius), y1 = min(rows - 1, y + radius);
    const int x0 = max(0, x - radius), x1 = min(cols - 1, x + radius);
    const int ty0 = y0 / kTile, ty1 = y1 / kTile, tx0 = x0 / kTile, tx1 = x1 / kTile;
    const int ntx = tx1 - tx0 + 1;
    const int n_touch = (ty1 - ty0 + 1) * ntx;

    // 2. One warp per touched tile.
    for (int tt = warp; tt < n_touch; tt += kWarps) {
      const int ty = ty0 + tt / ntx, tx = tx0 + tt % ntx;
      const int t = ty * l.tiles_x + tx;
      // Set the square's bits in this tile for the later picks, one row a
      // lane: a tile's 16 columns lie in one 32-bit word.  A tile read
      // below may see some of them already; it masks the square anyway.
      const int r = ty * kTile + lane;
      if (lane < kTile && r >= y0 && r <= y1) {
        const int c0 = max(x0, tx * kTile), c1 = min(x1, tx * kTile + kTile - 1), w = c0 >> 5;
        atomicOr(bits + (size_t)r * l.words_per_row + w,
                 (0xFFFFFFFFu >> (31 - (c1 - 32 * w))) & (0xFFFFFFFFu << (c0 - 32 * w)));
      }
      u64 key;
      if (count[t] <= kCache) {
        // The cache holds every positive pixel of the tile.
        u64 k = lane < kCache ? cache[(size_t)t * kCache + lane] : 0ull;
        if (k != 0ull) {
          const unsigned kf = 0xFFFFFFFFu - (unsigned)k;
          const int kr = (int)(kf / (unsigned)cols), kc = (int)(kf % (unsigned)cols);
          if ((kr >= y0 && kr <= y1 && kc >= x0 && kc <= x1) ||
              ((bits[(size_t)kr * l.words_per_row + (kc >> 5)] >> (kc & 31)) & 1u)) {
            k = 0ull;
          }
        }
        key = warp_max(k);
      } else {
        u64 k[kTile / 2];
        pixel_keys(map, rows, cols, ty, tx, bits, l.words_per_row, y0, y1, x0, x1, k);
        key = warp_max(lane_max(k));
      }
      if (lane == 0) tk[t] = key;
    }
    __syncthreads();

    // 3. The group keys over the touched tiles' index range.
    const int g0 = (ty0 * l.tiles_x + tx0) / kGroup, g1 = (ty1 * l.tiles_x + tx1) / kGroup;
    for (int g = g0 + warp; g <= g1; g += kWarps) group_key(tk, gk, g, l.n_tiles);
    __syncthreads();
  }
}

bool state_fits_shared(const Layout& l) {
  int dev = 0, smem_max = 48 * 1024;
  if (cudaGetDevice(&dev) == cudaSuccess) {
    cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  return l.state_bytes <= (size_t)smem_max;
}

}  // namespace

// Bytes of device workspace per frame: what launch 1 writes, plus the group
// keys and the bitmap when launch 2's state does not fit in one block's
// shared memory on the current device.  A multiple of 8.
extern "C" long long fd_greedy_workspace_bytes(int rows, int cols) {
  const Layout l = layout(rows, cols);
  return (long long)(state_fits_shared(l) ? l.keys_bytes : l.state_bytes);
}

// C interface, loaded with ctypes.  cand: [B, rows, cols] f32 (contiguous,
// rows * cols < 2^32 - 1); n_stop: [B] int32; ws: B x
// fd_greedy_workspace_bytes bytes; out: [B, max_picks, 4] f32, zero-filled
// by the caller, written as (x, y, response, 1) for each taken pick.  Two
// launches.  Returns the first failing launch's cudaError_t (0 on success).
extern "C" int fd_greedy_select(const void* cand, const void* n_stop, void* ws, void* out,
                                int batch, int rows, int cols, int max_picks, int radius,
                                void* stream) {
  const Layout l = layout(rows, cols);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* map = static_cast<const float*>(cand);
  u64* work = static_cast<u64*>(ws);
  const bool shared = state_fits_shared(l);
  const size_t stride = (shared ? l.keys_bytes : l.state_bytes) / 8;
  radius = std::min(radius, std::max(rows, cols));  // the same squares, no overflow

  const dim3 key_grid((l.n_tiles + kKeyWarps - 1) / kKeyWarps, std::min(batch, 65535));
  tile_keys_kernel<<<key_grid, kKeyWarps * 32, 0, st>>>(map, work, stride, batch, rows, cols, l);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  if (shared) {
    if (l.state_bytes > 48 * 1024) {
      e = cudaFuncSetAttribute(pick_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)l.state_bytes);
      if (e != cudaSuccess) return (int)e;
    }
    pick_kernel<true><<<batch, kThreads, l.state_bytes, st>>>(
        map, static_cast<const int*>(n_stop), work, stride, static_cast<float*>(out), rows, cols, max_picks, radius, l);
  } else {
    pick_kernel<false><<<batch, kThreads, 0, st>>>(
        map, static_cast<const int*>(n_stop), work, stride, static_cast<float*>(out), rows, cols, max_picks, radius, l);
  }
  return (int)cudaGetLastError();
}
