// Fixed-order float32 contraction (K4) and dense LU solve (K5): arithmetic
// whose bits for one problem do not depend on how many problems share the
// batch.
//
// These replace no Pallas kernel of the JAX package.  They were added for the
// fused VO's chunk solver (feature_detector_tpu_torch/slam/vo_fused.py
// solve_chunks), whose float32 products, sums and small dense solves went to
// cuBLAS, torch's reductions and cuSOLVER.  Those choose their algorithm, and
// so their order of operations, by the batch's size: the same chunk solved
// among 17 rounded otherwise than among 5 or alone, and a rank of a mesh that
// solved its share parted from one card.  Here the order of every sum is a
// function of the problem's own shape only, each problem is computed by its
// own threads, and every product and sum is an explicit round-to-nearest
// intrinsic (__fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn), so that nvcc
// contracts nothing into an FMA.  No split-K, no atomics.  The plain PyTorch
// versions (kernels/fixed_order.py) repeat the same order in elementwise
// torch ops, and the card's results equal them bit for bit.
//
// K4 fixed_contract: out[b, m, n] = sum_k a[b, m, k] * c[b, k, n] (or, with
// c == NULL, sum_k a[b, m, k] with n = 1).  The order depends on K alone:
//   - K <= kSerialMaxK: one thread an output, acc = t_0, then acc += t_k for
//     k = 1 ... K - 1;
//   - K > kSerialMaxK: one warp an output; lane p sums t_{p + 32 s} over
//     s = 0, 1, ... (a term past K is +0), then the 32 lanes fold by
//     __shfl_down at offsets 16, 8, 4, 2, 1 (lane p adds lane p + offset).
//   Bound: bytes.  The least work is one read of a and c and one write of
//   out; the chunk solver's largest call (the reduced camera system of
//   34 problems, M = N = 72, K = 1536) moves about 30 MB, 0.009 ms at
//   3.35 TB/s.  This first version reads a and c with general strides from
//   L2 (a warp reads 32 consecutive k when the wrapper hands k-contiguous
//   operands), without shared-memory tiling: every output re-reads its row
//   and column.
//
// K5 fixed_lu_solve: x = a^-1 b for [B, n, n] a and [B, n] b, n <=
// kLuMaxN.  One block a system holds [a | b] in shared memory; column by
// column, thread 0 picks the pivot (the first row of largest |a_ij|; a NaN
// counts as largest, as torch.argmax), the block swaps the two rows, then
// updates a_ik -= (a_ij / a_jj) a_jk over the trailing block and the
// right-hand side; back substitution goes column by column from the last.
// A singular system gives inf/NaN, as the elimination's arithmetic does.
// Bound: latency.  The chain of n pivot steps, each two or three block
// barriers and a serial pivot scan, sets the time, not bytes (B n^2 floats)
// or operations (2/3 n^3 a system).

#include <cuda_runtime.h>

namespace {

constexpr int kSerialMaxK = 16;  // K at and below which one thread sums serially
constexpr int kLanes = 32;       // lanes of one output above it
constexpr int kThreads = 256;    // K4 block
constexpr int kLuMaxN = 104;     // [n][n + 1] floats fit the 48 KB of static shared memory

struct Operands {
  const float* a;
  const float* c;
  long long sab, sam, sak, scb, sck, scn;
};

__device__ __forceinline__ float term(const Operands& o, const float* pa, const float* pc, int k) {
  return o.c ? __fmul_rn(pa[k * o.sak], pc[k * o.sck]) : pa[k * o.sak];
}

__global__ void contract_serial(Operands o, float* out, long long n_out, int m_dim, int n_dim, int k_dim) {
  const long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (idx >= n_out) return;
  const int n = (int)(idx % n_dim);
  const long long bm = idx / n_dim;
  const int m = (int)(bm % m_dim);
  const long long b = bm / m_dim;
  const float* pa = o.a + b * o.sab + m * o.sam;
  const float* pc = o.c ? o.c + b * o.scb + n * o.scn : nullptr;
  float acc = term(o, pa, pc, 0);
  for (int k = 1; k < k_dim; ++k) acc = __fadd_rn(acc, term(o, pa, pc, k));
  out[idx] = acc;
}

__global__ void contract_lanes(Operands o, float* out, long long n_out, int m_dim, int n_dim, int k_dim) {
  const long long idx = (blockIdx.x * (long long)blockDim.x + threadIdx.x) / kLanes;
  const int lane = threadIdx.x % kLanes;
  if (idx >= n_out) return;  // uniform across the warp
  const int n = (int)(idx % n_dim);
  const long long bm = idx / n_dim;
  const int m = (int)(bm % m_dim);
  const long long b = bm / m_dim;
  const float* pa = o.a + b * o.sab + m * o.sam;
  const float* pc = o.c ? o.c + b * o.scb + n * o.scn : nullptr;
  float acc = lane < k_dim ? term(o, pa, pc, lane) : 0.0f;
  for (int k = kLanes + lane; k - lane < k_dim; k += kLanes)
    acc = __fadd_rn(acc, k < k_dim ? term(o, pa, pc, k) : 0.0f);
  for (int offset = kLanes / 2; offset > 0; offset /= 2)
    acc = __fadd_rn(acc, __shfl_down_sync(0xffffffffu, acc, offset));
  if (lane == 0) out[idx] = acc;
}

__global__ void lu_solve_kernel(const float* a, const float* b, float* x, int n, long long sab, long long sar,
                                long long sac, long long sbb, long long sbr) {
  __shared__ float s[kLuMaxN * (kLuMaxN + 1)];  // [a | b], row stride w
  __shared__ int pivot;
  const int w = n + 1;
  const long long sys = blockIdx.x;
  for (int e = threadIdx.x; e < n * w; e += blockDim.x) {
    const int r = e / w, col = e % w;
    s[e] = col < n ? a[sys * sab + r * sar + col * sac] : b[sys * sbb + r * sbr];
  }
  __syncthreads();
  for (int j = 0; j < n; ++j) {
    if (threadIdx.x == 0) {
      int p = j;
      float best = fabsf(s[j * w + j]);
      for (int i = j + 1; i < n; ++i) {
        const float v = fabsf(s[i * w + j]);
        if (!isnan(best) && (isnan(v) || v > best)) {
          best = v;
          p = i;
        }
      }
      pivot = p;
    }
    __syncthreads();
    const int p = pivot;
    if (p != j) {
      for (int col = j + threadIdx.x; col < w; col += blockDim.x) {
        const float t = s[j * w + col];
        s[j * w + col] = s[p * w + col];
        s[p * w + col] = t;
      }
    }
    __syncthreads();
    const int rows = n - j - 1, cols = w - j - 1;  // rows below j; columns right of j, b included
    for (int e = threadIdx.x; e < rows * cols; e += blockDim.x) {
      const int i = j + 1 + e / cols, col = j + 1 + e % cols;
      const float l = __fdiv_rn(s[i * w + j], s[j * w + j]);
      s[i * w + col] = __fsub_rn(s[i * w + col], __fmul_rn(l, s[j * w + col]));
    }
    __syncthreads();
  }
  for (int j = n - 1; j >= 0; --j) {
    if (threadIdx.x == 0) s[j * w + n] = __fdiv_rn(s[j * w + n], s[j * w + j]);
    __syncthreads();
    for (int i = threadIdx.x; i < j; i += blockDim.x)
      s[i * w + n] = __fsub_rn(s[i * w + n], __fmul_rn(s[i * w + j], s[j * w + n]));
    __syncthreads();
  }
  for (int i = threadIdx.x; i < n; i += blockDim.x) x[sys * n + i] = s[i * w + n];
}

}  // namespace

// C interface, loaded with ctypes.  Strides are in elements.
//
// a: [n_batch, m, k] f32 at strides (sab, sam, sak); c: [n_batch, k, n] f32
// at (scb, sck, scn), or NULL to sum a over k (n must be 1); out: [n_batch,
// m, n] f32, contiguous, written whole.  k >= 1.  One launch.  Returns the
// launch's cudaError_t (0 on success).
extern "C" int fd_fixed_contract(const void* a, const void* c, void* out, long long n_batch, int m, int n, int k,
                                 long long sab, long long sam, long long sak, long long scb, long long sck,
                                 long long scn, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Operands o{static_cast<const float*>(a), static_cast<const float*>(c), sab, sam, sak, scb, sck, scn};
  const long long n_out = n_batch * m * n;
  if (k <= kSerialMaxK) {
    const long long blocks = (n_out + kThreads - 1) / kThreads;
    contract_serial<<<(unsigned)blocks, kThreads, 0, st>>>(o, static_cast<float*>(out), n_out, m, n, k);
  } else {
    const long long blocks = (n_out * kLanes + kThreads - 1) / kThreads;
    contract_lanes<<<(unsigned)blocks, kThreads, 0, st>>>(o, static_cast<float*>(out), n_out, m, n, k);
  }
  return (int)cudaGetLastError();
}

// a: [n_sys, n, n] f32 at strides (sab, sar, sac); b: [n_sys, n] f32 at
// (sbb, sbr); x: [n_sys, n] f32, contiguous.  1 <= n <= fd_fixed_lu_max_n().
// One launch.  Returns the launch's cudaError_t (0 on success).
extern "C" int fd_fixed_lu_solve(const void* a, const void* b, void* x, long long n_sys, int n, long long sab,
                                 long long sar, long long sac, long long sbb, long long sbr, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = n <= 16 ? 32 : 128;
  lu_solve_kernel<<<(unsigned)n_sys, threads, 0, st>>>(static_cast<const float*>(a), static_cast<const float*>(b),
                                                      static_cast<float*>(x), n, sab, sar, sac, sbb, sbr);
  return (int)cudaGetLastError();
}

extern "C" int fd_fixed_lu_max_n() { return kLuMaxN; }
