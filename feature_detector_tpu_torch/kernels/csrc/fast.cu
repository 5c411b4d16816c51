// FAST segment test over a uint8 frame stack: the candidate map that the
// greedy selection reads, and on request the response map, in one launch.
//
// Replaces no Pallas kernel.  The JAX package computes FAST as jnp ops
// (feature_detector_tpu/kernels/detect.py:124 fast_response, :196
// fast_candidates); the port's plain version is kernels/detect.py
// fast_response + fast_candidates, which this kernel equals bit for bit.
// Per pixel p of the interior (3 pixels from every edge) whose mask entry is
// not 0: bit k of the bright ring mask is ring[k] > p + d and of the dark one
// ring[k] < p - d, in int (no uint8 wraparound), ring in the order of
// _FAST_CIRCLE; when n >= 12 both masks are 0 unless bits 4, 8 and 12 of one
// of them are all set (the compass pre-check); the response is the longer
// of the two masks' longest circular runs (16 when every bit is set).  Every
// other pixel responds 0.  The candidate map is the response where
// response >= threshold (compared in float32) and response > 0, else 0.
//
// Bound.  One read of every uint8 frame and one float32 write of the
// candidate map (two with the response): 5 bytes a pixel, or at 64 frames
// of 480x752 115 MB, 0.034 ms at 3.35 TB/s.  The ring test costs some 200
// integer operations a pixel done plainly, about 0.3 ms for that batch at
// the card's integer rate, so the design spends operations only where the
// result can be non-zero and keeps every byte it reads on chip.
//
// Design.
//   - One block of 256 threads per 32 x 128 tile of one frame.  The tile
//     and a halo of 3 pixels go into shared memory as uint8, 16-byte loads
//     where rows are 16-byte aligned (752-pixel rows are), byte loads
//     otherwise; pixels outside the frame load as 0 and are never tested.
//   - Each warp owns 4 rows of the tile, each lane 4 adjacent columns of
//     them: 16 pixels.  A lane first gates its pixels: interior, mask, and
//     (n >= 12) the compass pre-check, read from 4 aligned 32-bit words of
//     shared memory a row.  Most pixels of a frame fail the pre-check.
//   - The pixels that pass are compacted into a list per warp (a prefix sum
//     of their counts over the lanes), and the warp's lanes share the list
//     for the full 16-pixel ring test, so a lane does not idle while its
//     neighbours test.  The longest run takes log steps: the doubled 32-bit
//     mask's runs of 2, 4, 8 and 16 bits, then binary lifting over 8, 4, 2
//     and 1.  Responses (0..16) go to shared memory as bytes.
//   - Each lane converts its own 16 pixels to float32, gates the candidates
//     and stores them as float4 where rows are 4-float aligned, else as
//     floats; ragged edges are masked.
// Nothing is allocated and nothing synchronises the host; the launch goes
// on the caller's stream.

#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kTileRows = 32;
constexpr int kTileCols = 128;
constexpr int kHalo = 3;                          // the ring's radius
constexpr int kPad = 16;                          // columns loaded either side, for 16-byte loads
constexpr int kPitch = kTileCols + 2 * kPad;      // bytes of a shared row
constexpr int kRows = kTileRows + 2 * kHalo;      // shared rows
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kWarpRows = kTileRows / kWarps;     // rows a warp owns
constexpr int kLanePixels = kWarpRows * 4;        // pixels a lane owns: its rows x 4 columns
static_assert(kTileCols == 32 * 4, "a lane owns 4 adjacent columns of every row of its warp");
static_assert(kLanePixels <= 16, "a lane's pixel flags fit 16 bits");

// The ring of kernels/detect.py _FAST_CIRCLE: (dcol, drow) of bit k.
__device__ __forceinline__ int ring_dc(int k) {
  constexpr int dc[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
  return dc[k];
}
__device__ __forceinline__ int ring_dr(int k) {
  constexpr int dr[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};
  return dr[k];
}

// Longest circular run of set bits in a 16-bit ring mask, as
// kernels/detect.py _max_run counts it: the number of rounds x &= x << 1 of
// the doubled 32-bit mask that leave it non-zero, at most 16.  x_s marks the
// ends of runs of s bits; x_{a+b} = x_b & (x_a << b).
__device__ __forceinline__ int max_run(unsigned b16) {
  const unsigned x1 = b16 | (b16 << 16);
  const unsigned x2 = x1 & (x1 << 1);
  const unsigned x4 = x2 & (x2 << 2);
  const unsigned x8 = x4 & (x4 << 4);
  if (x8 & (x8 << 8)) return 16;
  int n = 0;
  unsigned cur = 0;  // x_n
  if (x8) { n = 8; cur = x8; }
  unsigned t = n ? (x4 & (cur << 4)) : x4;
  if (t) { n += 4; cur = t; }
  t = n ? (x2 & (cur << 2)) : x2;
  if (t) { n += 2; cur = t; }
  t = n ? (x1 & (cur << 1)) : x1;
  if (t) n += 1;
  return n;
}

// Byte b (0..11) of the 12 bytes w0, w1, w2 (little-endian).
__device__ __forceinline__ int byte_at(unsigned w0, unsigned w1, unsigned w2, int b) {
  const unsigned w = b < 4 ? w0 : (b < 8 ? w1 : w2);
  return (int)((w >> (8 * (b & 3))) & 0xFFu);
}

__global__ void __launch_bounds__(kThreads)
fast_kernel(const uint8_t* __restrict__ image, const int* __restrict__ mask, long long mask_frame_stride,
            float* __restrict__ cand, float* __restrict__ resp, int batch, int rows, int cols,
            int precheck, int d, float threshold, int vector_in, int vector_out) {
  __shared__ __align__(16) uint8_t tile[kRows * kPitch];
  __shared__ __align__(16) uint8_t out[kTileRows * kTileCols];
  __shared__ unsigned short lists[kWarps][kWarpRows * kTileCols];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r0 = blockIdx.y * kTileRows;
  const int c0 = blockIdx.x * kTileCols;
  const int col = 4 * lane;  // the lane's first column in the tile

  for (int f = blockIdx.z; f < batch; f += gridDim.z) {
    const uint8_t* frame = image + (size_t)f * rows * cols;

    // 1. The tile and its halo into shared memory; 0 outside the frame.
    if (vector_in) {
      constexpr int kChunks = kPitch / 16;
      for (int i = threadIdx.x; i < kRows * kChunks; i += kThreads) {
        const int r = r0 - kHalo + i / kChunks;
        const int c = c0 - kPad + 16 * (i % kChunks);
        uint4 v = make_uint4(0, 0, 0, 0);
        if (r >= 0 && r < rows && c >= 0 && c < cols)  // cols % 16 == 0: the whole chunk is inside
          v = __ldg(reinterpret_cast<const uint4*>(frame + (size_t)r * cols + c));
        *reinterpret_cast<uint4*>(tile + (i / kChunks) * kPitch + 16 * (i % kChunks)) = v;
      }
    } else {
      for (int i = threadIdx.x; i < kRows * kPitch; i += kThreads) {
        const int r = r0 - kHalo + i / kPitch;
        const int c = c0 - kPad + i % kPitch;
        tile[i] = (r >= 0 && r < rows && c >= 0 && c < cols) ? __ldg(frame + (size_t)r * cols + c) : (uint8_t)0;
      }
    }
    __syncthreads();

    // 2. Gate the lane's 16 pixels: interior, mask, compass pre-check.
    unsigned live = 0;
#pragma unroll
    for (int i = 0; i < kWarpRows; ++i) {
      const int tr = warp * kWarpRows + i;
      const int r = r0 + tr;
      const uint8_t* crow = tile + (tr + kHalo) * kPitch + kPad + col;
      const unsigned w0 = *reinterpret_cast<const unsigned*>(crow - 4);
      const unsigned w1 = *reinterpret_cast<const unsigned*>(crow);
      const unsigned w2 = *reinterpret_cast<const unsigned*>(crow + 4);
      const unsigned ws = *reinterpret_cast<const unsigned*>(crow + kHalo * kPitch);
      *reinterpret_cast<unsigned*>(out + tr * kTileCols + col) = 0u;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = c0 + col + j;
        bool ok = r >= kHalo && r < rows - kHalo && c >= kHalo && c < cols - kHalo;
        if (ok && mask != nullptr) ok = mask[f * mask_frame_stride + (long long)r * cols + c] != 0;
        if (ok && precheck) {
          const int p = byte_at(w0, w1, w2, 4 + j);
          const int east = byte_at(w0, w1, w2, 7 + j);  // bit 4, (3, 0)
          const int south = (int)((ws >> (8 * j)) & 0xFFu);  // bit 8, (0, 3)
          const int west = byte_at(w0, w1, w2, 1 + j);  // bit 12, (-3, 0)
          const int hi = p + d, lo = p - d;
          ok = (east > hi && south > hi && west > hi) || (east < lo && south < lo && west < lo);
        }
        live |= (unsigned)ok << (4 * i + j);
      }
    }

    // 3. The warp's live pixels into one list, shared by its lanes for the ring test.
    const int count = __popc(live);
    int incl = count;
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, s);
      if (lane >= s) incl += v;
    }
    const int total = __shfl_sync(0xffffffffu, incl, 31);
    unsigned short* list = lists[warp];
    for (int slot = incl - count; live; live &= live - 1) {
      const int b = __ffs(live) - 1;
      list[slot++] = (unsigned short)(((b >> 2) << 8) | (col + (b & 3)));  // (row of the warp, column)
    }
    __syncwarp();
    for (int q = lane; q < total; q += 32) {
      const int tr = warp * kWarpRows + (list[q] >> 8);
      const int tc = list[q] & 0xFF;
      const uint8_t* center = tile + (tr + kHalo) * kPitch + kPad + tc;
      const int p = *center;
      const int hi = p + d, lo = p - d;
      unsigned bright = 0, dark = 0;
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const int v = center[ring_dr(k) * kPitch + ring_dc(k)];
        bright |= (unsigned)(v > hi) << k;
        dark |= (unsigned)(v < lo) << k;
      }
      const int a = max_run(bright), b = max_run(dark);
      out[tr * kTileCols + tc] = (uint8_t)(a > b ? a : b);
    }
    __syncwarp();

    // 4. The lane's own pixels out as float32: candidates, and the response on request.
#pragma unroll
    for (int i = 0; i < kWarpRows; ++i) {
      const int tr = warp * kWarpRows + i;
      const int r = r0 + tr;
      const int c = c0 + col;
      if (r >= rows || c >= cols) continue;
      const unsigned bytes = *reinterpret_cast<const unsigned*>(out + tr * kTileCols + col);
      float rv[4], cv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        rv[j] = (float)((bytes >> (8 * j)) & 0xFFu);
        cv[j] = (rv[j] >= threshold && rv[j] > 0.0f) ? rv[j] : 0.0f;
      }
      const size_t at = ((size_t)f * rows + r) * cols + c;
      if (vector_out) {  // cols % 4 == 0: the 4 columns are inside the row
        *reinterpret_cast<float4*>(cand + at) = make_float4(cv[0], cv[1], cv[2], cv[3]);
        if (resp != nullptr) *reinterpret_cast<float4*>(resp + at) = make_float4(rv[0], rv[1], rv[2], rv[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (c + j < cols) {
            cand[at + j] = cv[j];
            if (resp != nullptr) resp[at + j] = rv[j];
          }
        }
      }
    }
    __syncthreads();  // the next frame reuses the shared tile
  }
}

}  // namespace

// C interface, loaded with ctypes.  image: [B, rows, cols] uint8; mask:
// int32 [rows, cols] (mask_frame_stride 0) or [B, rows, cols] (stride
// rows * cols), or null for none; cand and resp (null when not wanted):
// [B, rows, cols] f32.  All contiguous; rows * cols < 2^31, rows <= 65535 *
// 32.  precheck: n >= 12.  d: min_pixel_diff_value, clamped to [-256, 256] by
// the caller (which changes no comparison of uint8 values).  One launch on
// `stream`.  Returns its cudaError_t (0 on success).
extern "C" int fd_fast_maps(const void* image, const void* mask, long long mask_frame_stride, void* cand,
                            void* resp, int batch, int rows, int cols, int precheck, int d, float threshold,
                            void* stream) {
  const dim3 grid((cols + kTileCols - 1) / kTileCols, (rows + kTileRows - 1) / kTileRows,
                  batch < 65535 ? batch : 65535);
  const int vector_in = cols % 16 == 0 && ((uintptr_t)image & 15) == 0;
  const int vector_out = cols % 4 == 0 && ((uintptr_t)cand & 15) == 0 && ((uintptr_t)resp & 15) == 0;
  fast_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(image), static_cast<const int*>(mask), mask_frame_stride,
      static_cast<float*>(cand), static_cast<float*>(resp), batch, rows, cols, precheck, d, threshold,
      vector_in, vector_out);
  return (int)cudaGetLastError();
}
