// Greedy response-ordered feature selection with square suppression, one
// thread block per frame.
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
// Design.  The Pallas kernel keeps the whole map in VMEM; a 480x752 f32 map
// (1.44 MB) does not fit in one SM's 227 KB of shared memory, so:
//   - the working map lives in a global scratch buffer (allocated by the
//     wrapper), which the block first fills from the caller's map;
//   - the per-row maxima (H floats) live in shared memory;
//   - a pick is a block argmax over the row maxima (largest value, smallest
//     row on ties), then a block scan of that row for the smallest column
//     holding the value, so ties break by index and never by thread order;
//   - suppression zeroes the square and recomputes the row maxima of the
//     rows it touched, one warp per row.
// Values are copied, never computed, so the outputs equal the plain version
// bit for bit.
//
// Bound.  Each frame is a chain of up to max_picks dependent picks, each a
// few block-wide barriers and reductions: the kernel is latency-bound, not
// bound by bytes or operations.  One block per frame keeps only B of the
// 132 SMs busy (64 at the main path's batch, 1 on the single-frame path).
// Faster forms (sparse candidate compaction, several frames per block, a
// cluster per frame) are later work.
//
// Inputs are finite floats (candidate maps are >= 0); fmaxf drops NaNs.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

// Largest value, then smallest index, across a warp.
__device__ __forceinline__ void warp_argmax(float& v, int& idx) {
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, v, off);
    const int oi = __shfl_down_sync(0xffffffffu, idx, off);
    if (ov > v || (ov == v && oi < idx)) {
      v = ov;
      idx = oi;
    }
  }
}

__device__ __forceinline__ int warp_min(int v) {
  for (int off = 16; off > 0; off >>= 1) v = min(v, __shfl_down_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__global__ void __launch_bounds__(kThreads)
greedy_select_kernel(const float* __restrict__ cand, const int* __restrict__ n_stop,
                     float* __restrict__ work, float* __restrict__ out,
                     int rows, int cols, int max_picks, int radius) {
  extern __shared__ float rowmax[];  // [rows]
  __shared__ float s_val[kWarps];
  __shared__ int s_idx[kWarps];
  __shared__ float s_pick_val;
  __shared__ int s_pick_y;
  __shared__ int s_pick_x;

  const int f = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t plane = (size_t)rows * cols;
  const float* src = cand + f * plane;
  float* map = work + f * plane;
  float* o = out + (size_t)f * max_picks * 4;
  const int stop = n_stop[f];

  // Copy the frame into the working map and take its row maxima.
  for (int r = warp; r < rows; r += kWarps) {
    float m = -INFINITY;
    for (int c = lane; c < cols; c += 32) {
      const float v = src[(size_t)r * cols + c];
      map[(size_t)r * cols + c] = v;
      m = fmaxf(m, v);
    }
    m = warp_max(m);
    if (lane == 0) rowmax[r] = m;
  }
  __syncthreads();

  for (int i = 0; i < max_picks; ++i) {
    // 1. (val, y): largest row maximum, smallest row among equals.  Each
    //    thread walks its rows in increasing order and keeps the first.
    float v = -INFINITY;
    int y = rows;
    for (int r = tid; r < rows; r += kThreads) {
      const float rv = rowmax[r];
      if (rv > v) {
        v = rv;
        y = r;
      }
    }
    warp_argmax(v, y);
    if (lane == 0) {
      s_val[warp] = v;
      s_idx[warp] = y;
    }
    __syncthreads();
    if (warp == 0) {
      v = lane < kWarps ? s_val[lane] : -INFINITY;
      y = lane < kWarps ? s_idx[lane] : rows;
      warp_argmax(v, y);
      if (lane == 0) {
        s_pick_val = v;
        s_pick_y = y;
      }
    }
    __syncthreads();
    const float val = s_pick_val;
    y = s_pick_y;
    // A stop is uniform across the block: every thread reads the same
    // shared values.  y == rows only when no row holds a finite value.
    if (!(val > 0.0f) || i >= stop || y >= rows) break;

    // 2. x: smallest column of row y holding val.
    int x = cols;
    for (int c = tid; c < cols; c += kThreads) {
      if (map[(size_t)y * cols + c] == val) {
        x = c;
        break;
      }
    }
    x = warp_min(x);
    __syncthreads();  // s_idx is reused below
    if (lane == 0) s_idx[warp] = x;
    __syncthreads();
    if (warp == 0) {
      x = lane < kWarps ? s_idx[lane] : cols;
      x = warp_min(x);
      if (lane == 0) {
        s_pick_x = x;
        o[4 * i + 0] = (float)x;
        o[4 * i + 1] = (float)y;
        o[4 * i + 2] = val;
        o[4 * i + 3] = 1.0f;
      }
    }
    __syncthreads();
    x = s_pick_x;

    // 3. Zero the clipped square.
    const int y0 = max(0, y - radius), y1 = min(rows - 1, y + radius);
    const int x0 = max(0, x - radius), x1 = min(cols - 1, x + radius);
    const int sw = x1 - x0 + 1;
    const int n_sq = (y1 - y0 + 1) * sw;
    for (int k = tid; k < n_sq; k += kThreads) {
      map[(size_t)(y0 + k / sw) * cols + x0 + k % sw] = 0.0f;
    }
    __syncthreads();

    // 4. Recompute the row maxima of the touched rows, one warp per row.
    for (int r = y0 + warp; r <= y1; r += kWarps) {
      float m = -INFINITY;
      for (int c = lane; c < cols; c += 32) m = fmaxf(m, map[(size_t)r * cols + c]);
      m = warp_max(m);
      if (lane == 0) rowmax[r] = m;
    }
    __syncthreads();
  }
}

}  // namespace

// C interface, loaded with ctypes.  cand, work: [B, rows, cols] f32
// (contiguous); n_stop: [B] int32; out: [B, max_picks, 4] f32, zero-filled
// by the caller, written as (x, y, response, 1) for each taken pick.
// Returns the launch's cudaError_t (0 on success).
extern "C" int fd_greedy_select(const void* cand, const void* n_stop, void* work, void* out,
                                int batch, int rows, int cols, int max_picks, int radius,
                                void* stream) {
  const size_t smem = (size_t)rows * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        greedy_select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  greedy_select_kernel<<<batch, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cand), static_cast<const int*>(n_stop),
      static_cast<float*>(work), static_cast<float*>(out), rows, cols, max_picks, radius);
  return (int)cudaGetLastError();
}
