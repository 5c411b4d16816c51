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
// contracts nothing into an FMA.  No split-K, no atomics, and no partial's
// serial chain is split across warps or blocks.  The plain PyTorch versions
// (kernels/fixed_order.py) repeat the same order in elementwise torch ops,
// and the card's results equal them bit for bit.
//
// No tensor cores: wgmma and mma.sync sum their products in an order of their
// own and round once per fused multiply-add (or keep wider partials), so they
// cannot give these bits.  No FMA for the same reason: a fused a * c + acc
// rounds once where the specification rounds twice.
//
// Every call is one launch.  Operands come as strided views with up to
// kMaxBatchDims batch axes (the wrapper merges what it can; broadcast axes
// have stride 0), so the wrapper copies nothing.
//
// K4 fixed_contract: out[b, m, n] = sum_k a[b, m, k] * c[b, k, n] (or, with
// c == NULL, sum_k a[b, m, k] with n = 1).  The order depends on K alone:
//   - K <= kSerialMaxK: acc = t_0, then acc += t_k for k = 1 ... K - 1;
//   - K > kSerialMaxK: partial p (p < 32) starts as t_p and adds t_{p + 32 s}
//     for s = 1, 2, ... in order, up to step ceil(K / 32) - 1 (a term past K
//     is +0, and is added: -0 + +0 is +0); then the 32 partials fold, p adding
//     p + 16, then p + 8, 4, 2, 1.
// contract_serial (K <= 16) runs one thread an output.  contract_tiled (K >
// 16) runs a block of WM x WN warps over a BM x BN tile of one problem's
// outputs: each warp owns an RM x RN register tile, and lane p of the warp
// keeps partial p of each of its outputs.  The block stages its rows of a
// and columns of c in shared memory, kc = 32, 64 or 128 terms at a time,
// in a ring of three chunks filled by cp.async (16 bytes a copy along the
// operand's contiguous axis where the strides and alignment allow, else 4),
// so that a transposed, strided or broadcast view is read as it lies and no
// copy precedes the launch.  An operand whose terms are contiguous is kept
// row major (tile[r][kk], lane p reads 32 neighbouring words); one whose
// rows are contiguous, term major (tile[kk][r] with a row stride of 4 mod 8,
// lane p reads its eight rows as two float4s, each quarter warp on all 32
// banks once).  At step s lane p reads a[r, p + 32 s] and c[p + 32 s, q];
// after the last step the warp folds each output by the tree with
// __shfl_xor, splitting the outputs between the lanes of a pair while it can
// (Fold), so that a lane ends up storing 1/32 of them.  The partials
// start at -0, because -0 + t == t for every float t: the first step sets
// them to their first term.  The host picks the register tile (1, 3, 6 or 8
// a side) from M and N; where a problem has many register tiles, a block of
// 3 x 2 warps with 8 x 12 tiles (24 x 24 outputs, two blocks an SM), else
// one warp.  Each mapping evaluates the same tree.
//   Bound.  The reduced camera system (34 problems, [72, 1536] @ [1536, 72],
//   the chunk solver's largest call) moves 30.8 MB, 0.009190 ms at
//   3.35 TB/s; without FMA its 2 x 34 x 72 x 72 x 1536 = 541 M float32
//   operations take 0.0162 ms at 33.5 T separate operations/s (half the
//   67 TFLOP/s that counts an FMA as two).  Operations bound it: a 24 x 24
//   tile reads each operand byte from L2 three times, and a step spends 11
//   shared loads on 192 arithmetic instructions of an 8 x 12 register tile.
//   On an H100 it reaches about a third of that rate (PERF.md section 6):
//   the compiler pairs each add closely with its product, and the 306 tiles
//   take two rounds of the 264 block slots.  Calls with few outputs and large
//   batches (a landmark's [3, 24] @ [24, 3], 17,408 problems) are bound by
//   their bytes: one warp a problem.
//
// K5 fixed_lu_solve: x = a^-1 b for [B, n, n] a and [B, n] b, n <= kLuMaxN,
// by LU with partial pivoting.  Column j: the pivot is the first row, in the
// current row order, of largest |a_ij| (a NaN counts as largest and the first
// NaN wins, as torch.argmax); rows j and p swap; every row i below j updates
// a_ik -= l_i a_jk over the trailing columns and the right-hand side, with
// l_i = a_ij / a_jj (one division a row and step: the quotient an element
// would compute has the same operands, so the same bits).  Back substitution
// runs from the last column: x_j /= a_jj, then x_i -= a_ij x_j for i < j.
// [a | b] sits in shared memory, one thread a row (the row's owner).  Rows
// do not move: a swap exchanges the two rows' logical positions, which the
// pivot rule reads.  The pivot is a reduction of 64-bit keys (|a_ij|'s bits,
// every NaN alike and above +inf, then the lower logical row, then the
// owner) by max (two 32-bit redux.sync a warp, or __shfl_xor), so ties go to
// the lower row as in the serial scan.  lu_solve_block (n > 32) runs one system a block of
// ceil(n / 32) warps with one block barrier a pivot step (the warps' best
// keys meet in shared memory, double buffered by the step's parity);
// lu_solve_warp (n <= 32) packs 32 / g systems into a one-warp block, g the
// power of two at or above n, each in g lanes, with only __syncwarp.  A row
// update issues eight columns' loads before their stores.  Back
// substitution runs in one warp (or the system's g lanes) with shuffles.
// A singular system gives inf/NaN, as the elimination's arithmetic does.
//   Bound: latency.  n dependent pivot steps, each a key reduction (five
//   64-bit shuffles), a barrier and the row updates (n - j mul/sub pairs a
//   thread), then n dependent back-substitution steps; bytes (B n^2 floats)
//   and operations (2/3 n^3 a system) are far below.

#include <cuda_runtime.h>

#include <cstring>

namespace {

constexpr int kSerialMaxK = 16;   // K at and below which one thread sums serially
constexpr int kLanes = 32;        // partials of one output above it
constexpr int kSerialThreads = 256;
constexpr int kLuMaxN = 104;      // [n][n + 2] floats fit the 48 KB of shared memory a block gets by default
constexpr int kLuWarpThreads = 32;  // n <= 32: one warp a block, so that few systems still spread over the SMs
constexpr int kMaxBatchDims = 8;
constexpr unsigned kFull = 0xffffffffu;

// Batch axes, innermost last, with the strides of two operands (a and c, or a
// and b); the output is contiguous over them.
struct Batch {
  int nd;
  int size[kMaxBatchDims];
  long long s0[kMaxBatchDims], s1[kMaxBatchDims];
};

__device__ __forceinline__ void batch_offsets(const Batch& d, unsigned b, long long& o0, long long& o1) {
  o0 = 0;
  o1 = 0;
  for (int i = d.nd - 1; i >= 0; --i) {
    const unsigned s = (unsigned)d.size[i], q = b / s, r = b - q * s;
    o0 += r * d.s0[i];
    o1 += r * d.s1[i];
    b = q;
  }
}

struct Contract {
  const float* a;
  const float* c;  // NULL: sum a over k
  float* out;      // [batch, m, n], contiguous
  int m, n, k;
  long long sam, sak, sck, scn;
  Batch batch;
};

__global__ void contract_serial(Contract o, unsigned n_out) {
  const unsigned idx = blockIdx.x * kSerialThreads + threadIdx.x;
  if (idx >= n_out) return;
  const unsigned n = idx % o.n, bm = idx / o.n, m = bm % o.m, b = bm / o.m;
  long long oa, oc;
  batch_offsets(o.batch, b, oa, oc);
  const float* pa = o.a + oa + m * o.sam;
  float acc;
  if (o.c) {
    const float* pc = o.c + oc + n * o.scn;
    acc = __fmul_rn(pa[0], pc[0]);
    for (int k = 1; k < o.k; ++k) acc = __fadd_rn(acc, __fmul_rn(pa[k * o.sak], pc[k * o.sck]));
  } else {
    acc = pa[0];
    for (int k = 1; k < o.k; ++k) acc = __fadd_rn(acc, pa[k * o.sak]);
  }
  o.out[idx] = acc;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

__device__ __forceinline__ void zero4(float* d) { *reinterpret_cast<float4*>(d) = make_float4(0.0f, 0.0f, 0.0f, 0.0f); }

constexpr int kStages = 3;  // chunks in flight: one computed, two staging
constexpr int kMaxChunkSteps = 4;  // steps of 32 terms in a chunk: kc <= 128
constexpr int kMaxOptInShm = 227 * 1024;  // the shared memory a Hopper block may opt in to

// How a block stages an operand's chunk: one term (4 bytes) a copy with
// neighbouring threads on neighbouring terms (kScalarK) or rows (kScalarR),
// or four (16 bytes) along the operand's contiguous axis (kVector).
enum Staging : int { kScalarK = 0, kScalarR = 1, kVector = 2 };

// One operand as a block sees it: rows r (of M for a, of N for c) and terms
// k, from the block's first row and term 0.  Offsets inside an operand fit 32
// bits (the host refuses larger operands).
struct Operand {
  const float* base;
  int s_row, s_k;
  int rows;  // valid rows of the block's tile
  int staging;
};

// Layout "row major" (RK): dst[r * ld + kk], ld = kc + 4.  Lane p reads
// dst[r * ld + 32 s + p]: 32 neighbouring words, no bank conflict.
template <int BR, int kThreadsT>
__device__ __forceinline__ void stage_rk(float* dst, int ld, const Operand& x, int k0, int terms, int kc_log2) {
  if (x.staging == kVector) {  // s_k == 1; rows, k0 and terms 4-aligned
    const int q_log2 = kc_log2 - 2, total = BR << q_log2;
    for (int e = threadIdx.x; e < total; e += kThreadsT) {
      const int r = e >> q_log2, kk = (e & ((1 << q_log2) - 1)) * 4;
      float* d = dst + r * ld + kk;
      if (r < x.rows && kk < terms)
        cp_async16(d, x.base + (r * x.s_row + k0 + kk));
      else
        zero4(d);
    }
  } else {
    const int total = BR << kc_log2;
    for (int e = threadIdx.x; e < total; e += kThreadsT) {
      int r, kk;
      if (x.staging == kScalarK) {
        r = e >> kc_log2;
        kk = e & ((1 << kc_log2) - 1);
      } else {
        r = e % BR;
        kk = e / BR;
      }
      float* d = dst + r * ld + kk;
      if (r < x.rows && kk < terms)
        cp_async4(d, x.base + (r * x.s_row + (k0 + kk) * x.s_k));
      else
        *d = 0.0f;
    }
  }
}

// Layout "term major" (KR), for an operand whose rows are contiguous in
// memory: dst[kk * ld + r], ld % 8 == 4.  Lane p reads the row tile of term
// 32 s + p as float4s: each quarter warp covers the 32 banks once.
template <int BR, int kThreadsT>
__device__ __forceinline__ void stage_kr(float* dst, int ld, const Operand& x, int k0, int terms, int kc_log2) {
  if (x.staging == kVector) {  // s_row == 1; s_k, rows and the tile's first row 4-aligned
    constexpr int kQ = BR / 4;
    const int total = kQ << kc_log2;
    for (int e = threadIdx.x; e < total; e += kThreadsT) {
      const int kk = e / kQ, r = (e % kQ) * 4;
      float* d = dst + kk * ld + r;
      if (kk < terms && r < x.rows)
        cp_async16(d, x.base + ((k0 + kk) * x.s_k + r));
      else
        zero4(d);
    }
  } else {
    const int total = BR << kc_log2;
    for (int e = threadIdx.x; e < total; e += kThreadsT) {
      const int kk = e / BR, r = e % BR;
      float* d = dst + kk * ld + r;
      if (kk < terms && r < x.rows)
        cp_async4(d, x.base + ((k0 + kk) * x.s_k + r * x.s_row));
      else
        *d = 0.0f;
    }
  }
}

template <int R, bool kKR>
__device__ __forceinline__ void read_tile(float (&v)[R], const float* tile, int ld, int first, int kk) {
  if (kKR) {
    const float4* q = reinterpret_cast<const float4*>(tile + kk * ld + first);
#pragma unroll
    for (int i = 0; i < R / 4; ++i) {
      const float4 f = q[i];
      v[4 * i] = f.x;
      v[4 * i + 1] = f.y;
      v[4 * i + 2] = f.z;
      v[4 * i + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < R; ++i) v[i] = tile[(first + i) * ld + kk];
  }
}

// One step of K4's lanes over a warp's register tile: acc[i][j] += a[i, kk] *
// c[kk, j] (or += a[i, kk]).  A row's products are formed before they are
// added, so that each add waits on a product issued RN instructions earlier.
template <int RM, int RN, bool kHasC, bool kAKR, bool kCKR>
__device__ __forceinline__ void tile_step(float (&acc)[RM][RN], const float* sa, const float* sc, int lda, int ldc,
                                          int a0, int c0, int kk) {
  float av[RM], cv[RN];
  read_tile<RM, kAKR>(av, sa, lda, a0, kk);
  if (kHasC) read_tile<RN, kCKR>(cv, sc, ldc, c0, kk);
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    float prod[RN];
#pragma unroll
    for (int j = 0; j < RN; ++j) prod[j] = kHasC ? __fmul_rn(av[i], cv[j]) : av[i];
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = __fadd_rn(acc[i][j], prod[j]);
  }
}

// Where a warp stores its register tile: out[first + r * ld + q] for r <
// rows, q < cols.
struct TileOut {
  float* base;
  int ld, rows, cols;
  long long first;
};

// K4's fold of a warp's 32 partials of T outputs (output i is (i / RN, i %
// RN) of the register tile), then the store.  At offset H lane p adds lane p
// + H (p < H) for H = 16, 8, 4, 2, 1.  While a lane holds an even number of
// outputs, the two lanes of a pair split them: each keeps one half, adds its
// partner's partials of that half, and passes the other half on; IEEE
// addition commutes, so the upper lane's sum has the lower lane's bits.  Once
// the count is odd, both lanes of a pair add the whole set (a butterfly) and
// one of them stores.  A lane ends with T / 2^s outputs, s the levels split.
template <int T, int RN, int H>
struct Fold {
  static __device__ __forceinline__ void run(float (&v)[T], int lane, int first, int shared, const TileOut& out) {
    if constexpr (H == 0) {
      if (lane & shared) return;  // a butterfly partner holds the same sums
#pragma unroll
      for (int i = 0; i < T; ++i) {
        const int r = (first + i) / RN, q = (first + i) % RN;
        if (r < out.rows && q < out.cols) out.base[out.first + r * out.ld + q] = v[i];
      }
    } else if constexpr (T % 2 == 0) {
      constexpr int U = T / 2;
      const bool upper = lane & H;
      float w[U];
#pragma unroll
      for (int i = 0; i < U; ++i) {
        const float keep = upper ? v[U + i] : v[i], pass = upper ? v[i] : v[U + i];
        w[i] = __fadd_rn(keep, __shfl_xor_sync(kFull, pass, H));
      }
      Fold<U, RN, H / 2>::run(w, lane, upper ? first + U : first, shared, out);
    } else {
#pragma unroll
      for (int i = 0; i < T; ++i) v[i] = __fadd_rn(v[i], __shfl_xor_sync(kFull, v[i], H));
      Fold<T, RN, H / 2>::run(v, lane, first, shared | H, out);
    }
  }
};

struct Tiling {
  int tiles_m, tiles_n, kc_log2, lda, ldc, a_stage, c_stage;  // a_stage, c_stage: floats of a stage's tiles
  int a_staging, c_staging;
};

// kAKR / kCKR: a's / c's tiles in the term-major layout (rows contiguous in
// memory; RM / RN a multiple of 4), else row major.
template <int RM, int RN, int WM, int WN, bool kHasC, bool kAKR, bool kCKR>
__global__ void __launch_bounds__(WM* WN * 32, WM* WN > 1 ? 2 : 1) contract_tiled(Contract o, Tiling t) {
  constexpr int BM = WM * RM, BN = WN * RN, kThreadsT = WM * WN * 32;
  extern __shared__ __align__(16) float smem[];
  unsigned tile = blockIdx.x;
  const int tn = tile % t.tiles_n;
  tile /= t.tiles_n;
  const int tm = tile % t.tiles_m;
  const unsigned b = tile / t.tiles_m;
  long long oa, oc;
  batch_offsets(o.batch, b, oa, oc);
  const int m0 = tm * BM, n0 = tn * BN;
  const Operand xa{o.a + oa + m0 * o.sam, (int)o.sam, (int)o.sak, min(BM, o.m - m0), t.a_staging};
  const Operand xc{kHasC ? o.c + oc + n0 * o.scn : nullptr, (int)o.scn, (int)o.sck, min(BN, o.n - n0), t.c_staging};
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, wm = warp / WN, wn = warp % WN;
  const int kc = 1 << t.kc_log2, chunk_steps = kc / kLanes;
  const int steps = (o.k + kLanes - 1) / kLanes, chunks = (o.k + kc - 1) >> t.kc_log2;
  float* const as = smem;
  float* const cs = smem + kStages * t.a_stage;

  auto load = [&](int ch) {
    if (ch < chunks) {
      const int k0 = ch << t.kc_log2, terms = min(kc, o.k - k0), slot = ch % kStages;
      if (kAKR)
        stage_kr<BM, kThreadsT>(as + slot * t.a_stage, t.lda, xa, k0, terms, t.kc_log2);
      else
        stage_rk<BM, kThreadsT>(as + slot * t.a_stage, t.lda, xa, k0, terms, t.kc_log2);
      if (kHasC) {
        if (kCKR)
          stage_kr<BN, kThreadsT>(cs + slot * t.c_stage, t.ldc, xc, k0, terms, t.kc_log2);
        else
          stage_rk<BN, kThreadsT>(cs + slot * t.c_stage, t.ldc, xc, k0, terms, t.kc_log2);
      }
    }
    cp_async_commit();  // one group a chunk, empty past the last, so that the wait below counts chunks
  };

  float acc[RM][RN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = -0.0f;  // -0 + t == t: the first step sets each partial to t_p

#pragma unroll
  for (int ch = 0; ch < kStages - 1; ++ch) load(ch);
  for (int ch = 0; ch < chunks; ++ch) {
    cp_async_wait<kStages - 2>();  // this thread's copies of chunk ch have landed
    __syncthreads();               // everyone's have, and everyone is done with chunk ch - 1's slot
    load(ch + kStages - 1);        // into chunk ch - 1's slot
    const int slot = ch % kStages;
    const float* sa = as + slot * t.a_stage;
    const float* sc = cs + slot * t.c_stage;
    const int n_steps = min(chunk_steps, steps - ch * chunk_steps);
    if (n_steps == kMaxChunkSteps) {  // straight-line, so that the compiler can read ahead of the arithmetic
#pragma unroll
      for (int s = 0; s < kMaxChunkSteps; ++s)
        tile_step<RM, RN, kHasC, kAKR, kCKR>(acc, sa, sc, t.lda, t.ldc, wm * RM, wn * RN, s * kLanes + lane);
    } else {
      for (int s = 0; s < n_steps; ++s)
        tile_step<RM, RN, kHasC, kAKR, kCKR>(acc, sa, sc, t.lda, t.ldc, wm * RM, wn * RN, s * kLanes + lane);
    }
  }
  const TileOut out{o.out + (long long)b * o.m * o.n, o.n, o.m - m0 - wm * RM, o.n - n0 - wn * RN,
                    (m0 + wm * RM) * o.n + n0 + wn * RN};
  Fold<RM * RN, RN, kLanes / 2>::run(reinterpret_cast<float(&)[RM * RN]>(acc), lane, 0, 0, out);
}

bool aligned4(const Batch& d, bool second) {
  for (int i = 0; i < d.nd; ++i)
    if ((second ? d.s1[i] : d.s0[i]) % 4) return false;
  return true;
}

// The staging of an operand with rows at s_row and terms at s_k (``second``:
// c's batch strides).  Term major (kr) only where the rows are contiguous.
int staging_of(const void* p, const Batch& d, bool second, long long s_row, long long s_k, int rows_total, int k,
               bool kr) {
  const bool base = reinterpret_cast<unsigned long long>(p) % 16 == 0 && aligned4(d, second);
  if (kr) return base && s_k % 4 == 0 && rows_total % 4 == 0 ? kVector : kScalarR;
  if (s_k == 1) return base && s_row % 4 == 0 && k % 4 == 0 ? kVector : kScalarK;
  return s_row == 1 ? kScalarR : kScalarK;
}

int round_to_4_mod_8(int x) { return x + ((4 - x % 8) + 8) % 8; }

template <int RM, int RN, int WM, int WN, bool kHasC, bool kAKR, bool kCKR>
cudaError_t launch_tiled(const Contract& o, unsigned n_batch, cudaStream_t st) {
  constexpr int BM = WM * RM, BN = WN * RN;
  Tiling t{};
  t.kc_log2 = o.k <= 32 ? 5 : o.k <= 64 ? 6 : 7;
  const int kc = 1 << t.kc_log2;
  t.tiles_m = (o.m + BM - 1) / BM;
  t.tiles_n = (o.n + BN - 1) / BN;
  t.lda = kAKR ? round_to_4_mod_8(BM) : kc + 4;
  t.ldc = kCKR ? round_to_4_mod_8(BN) : kc + 4;
  t.a_stage = kAKR ? kc * t.lda : BM * t.lda;
  t.c_stage = kHasC ? (kCKR ? kc * t.ldc : BN * t.ldc) : 0;
  t.a_staging = staging_of(o.a, o.batch, false, o.sam, o.sak, o.m, o.k, kAKR);
  t.c_staging = kHasC ? staging_of(o.c, o.batch, true, o.scn, o.sck, o.n, o.k, kCKR) : kScalarK;
  const unsigned long long blocks = (unsigned long long)n_batch * t.tiles_m * t.tiles_n;
  if (blocks > 0x7fffffffull) return cudaErrorInvalidConfiguration;
  const int shm = kStages * (t.a_stage + t.c_stage) * (int)sizeof(float);
  auto kernel = contract_tiled<RM, RN, WM, WN, kHasC, kAKR, kCKR>;
  if (shm > 48 * 1024) {  // opt in to more shared memory, once a card (racing callers set the same value)
    static unsigned long long opted_in = 0;  // a bit a device
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev >= 64 || !(opted_in >> dev & 1ull)) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxOptInShm);
      if (err != cudaSuccess) return err;
      if (dev < 64) opted_in |= 1ull << dev;
    }
  }
  kernel<<<(unsigned)blocks, WM * WN * 32, shm, st>>>(o, t);
  return cudaGetLastError();
}

int register_tile(int x) { return x == 1 ? 1 : x <= 3 ? 3 : x <= 6 ? 6 : 8; }

// A problem with many register tiles: a block of warps that shares its staged
// operands, with term-major tiles for an operand whose rows are contiguous.
template <int RM, int RN, int WM, int WN>
cudaError_t launch_block(const Contract& o, unsigned n_batch, cudaStream_t st) {
  constexpr bool kAKR = RM % 4 == 0, kCKR = RN % 4 == 0;  // float4 reads of a term-major tile
  const bool akr = kAKR && o.sam == 1 && o.sak != 1, ckr = kCKR && o.scn == 1 && o.sck != 1;
  if (akr && ckr) return launch_tiled<RM, RN, WM, WN, true, kAKR, kCKR>(o, n_batch, st);
  if (akr) return launch_tiled<RM, RN, WM, WN, true, kAKR, false>(o, n_batch, st);
  if (ckr) return launch_tiled<RM, RN, WM, WN, true, false, kCKR>(o, n_batch, st);
  return launch_tiled<RM, RN, WM, WN, true, false, false>(o, n_batch, st);
}

// One warp a (problem, register tile), or for the shapes with many register
// tiles a problem, a block of warps.
template <int RM, int RN>
cudaError_t launch_tiled_for(const Contract& o, unsigned n_batch, cudaStream_t st) {
  const long long warp_tiles = (long long)((o.m + RM - 1) / RM) * ((o.n + RN - 1) / RN);
  if (warp_tiles >= 4) {
    if (RM == 8 && RN == 8) return launch_block<8, 12, 3, 2>(o, n_batch, st);
    if (RM == 8 && RN == 1) return launch_block<8, 1, 4, 1>(o, n_batch, st);
    if (RM == 1 && RN == 8) return launch_block<1, 8, 1, 4>(o, n_batch, st);
  }
  return launch_tiled<RM, RN, 1, 1, true, false, false>(o, n_batch, st);
}

template <int RM>
cudaError_t launch_tiled_rows(const Contract& o, unsigned n_batch, cudaStream_t st) {
  switch (register_tile(o.n)) {
    case 1: return launch_tiled_for<RM, 1>(o, n_batch, st);
    case 3: return launch_tiled_for<RM, 3>(o, n_batch, st);
    case 6: return launch_tiled_for<RM, 6>(o, n_batch, st);
    default: return launch_tiled_for<RM, 8>(o, n_batch, st);
  }
}

// The largest element offset of an operand's (row, term) tile: rows of
// s_row, terms of s_k.
long long tile_span(int rows, int k, long long s_row, long long s_k) { return (rows - 1) * s_row + (k - 1) * s_k; }

cudaError_t launch_contract(const Contract& o, unsigned n_batch, cudaStream_t st) {
  if (tile_span(o.m, o.k, o.sam, o.sak) >= 0x7fffffffll ||
      (o.c != nullptr && tile_span(o.n, o.k, o.scn, o.sck) >= 0x7fffffffll))
    return cudaErrorInvalidValue;  // the tiles address a problem's operands with 32-bit offsets
  if (o.c == nullptr) {  // a sum: M outputs a problem, N = 1
    if (o.m >= 32) {
      if (o.sam == 1 && o.sak != 1) return launch_tiled<8, 1, 4, 1, false, true, false>(o, n_batch, st);
      return launch_tiled<8, 1, 4, 1, false, false, false>(o, n_batch, st);
    }
    switch (register_tile(o.m)) {
      case 1: return launch_tiled<1, 1, 1, 1, false, false, false>(o, n_batch, st);
      case 3: return launch_tiled<3, 1, 1, 1, false, false, false>(o, n_batch, st);
      case 6: return launch_tiled<6, 1, 1, 1, false, false, false>(o, n_batch, st);
      default: return launch_tiled<8, 1, 1, 1, false, false, false>(o, n_batch, st);
    }
  }
  switch (register_tile(o.m)) {
    case 1: return launch_tiled_rows<1>(o, n_batch, st);
    case 3: return launch_tiled_rows<3>(o, n_batch, st);
    case 6: return launch_tiled_rows<6>(o, n_batch, st);
    default: return launch_tiled_rows<8>(o, n_batch, st);
  }
}

struct Solve {
  const float* a;
  const float* b;
  float* x;  // [batch, n], contiguous
  int n;
  long long sar, sac, sbr;
  Batch batch;
};

__host__ __device__ __forceinline__ int lu_stride(int n) { return (n + 1) | 1; }  // odd: rows on distinct banks

// The pivot rule's order as a 64-bit key, larger first: |v| (every NaN alike,
// above +inf), then the lower logical row; the low bits carry the owner.  0
// is below every candidate.
__device__ __forceinline__ unsigned long long pivot_key(float v, int pos, int owner) {
  unsigned mag = __float_as_uint(fabsf(v));
  if (mag > 0x7f800000u) mag = 0x7fc00000u;
  return ((unsigned long long)mag << 32) | ((unsigned long long)(0xffffu - pos) << 16) | (unsigned)owner;
}

__device__ __forceinline__ int key_owner(unsigned long long key) { return (int)(key & 0xffffu); }
__device__ __forceinline__ int key_pos(unsigned long long key) { return 0xffff - (int)((key >> 16) & 0xffffu); }

__device__ __forceinline__ unsigned long long max_key(unsigned long long a, unsigned long long b) { return a > b ? a : b; }

// The warp's largest key by two 32-bit warp reductions: the largest
// magnitude, then the largest low half (the lowest position) among the
// lanes that hold it.
__device__ __forceinline__ unsigned long long warp_max_key(unsigned long long key) {
  const unsigned mag = (unsigned)(key >> 32), low = (unsigned)key;
  const unsigned best = __reduce_max_sync(kFull, mag);
  return ((unsigned long long)best << 32) | __reduce_max_sync(kFull, mag == best ? low : 0u);
}

// Row update of pivot step j over columns j + 1 .. w - 1 (b is column n),
// eight columns' loads issued before their stores so that their latencies
// overlap (the compiler cannot tell that row and piv never alias).
__device__ __forceinline__ void eliminate(float* __restrict__ row, const float* __restrict__ piv, int j, int w) {
  constexpr int kIlp = 8;
  const float l = __fdiv_rn(row[j], piv[j]);
  int col = j + 1;
  for (; col + kIlp <= w; col += kIlp) {
    float r[kIlp], q[kIlp];
#pragma unroll
    for (int i = 0; i < kIlp; ++i) {
      r[i] = row[col + i];
      q[i] = piv[col + i];
    }
#pragma unroll
    for (int i = 0; i < kIlp; ++i) row[col + i] = __fsub_rn(r[i], __fmul_rn(l, q[i]));
  }
  for (; col < w; ++col) row[col] = __fsub_rn(row[col], __fmul_rn(l, piv[col]));
}

// Loads system [a | b] into s (row stride ws), elements e = first, first +
// step, ..., every copy in flight at once (cp.async); the caller's barrier
// then makes them visible.
__device__ __forceinline__ void load_system(float* s, int ws, const Solve& o, long long oa, long long ob, int first,
                                            int step) {
  const int n = o.n, w = n + 1;
  for (int e = first; e < n * w; e += step) {
    const int r = e / w, col = e - r * w;
    cp_async4(s + r * ws + col, col < n ? o.a + oa + r * o.sar + col * o.sac : o.b + ob + r * o.sbr);
  }
  cp_async_commit();
  cp_async_wait<0>();
}

// n > 32: one system a block of ceil(n / 32) warps, thread t owns row t.
__global__ void lu_solve_block(Solve o) {
  extern __shared__ float smem[];
  __shared__ unsigned long long best[2][(kLuMaxN + 31) / 32];
  const int n = o.n, ws = lu_stride(n), t = threadIdx.x, lane = t % 32, warp = t / 32, warps = blockDim.x / 32;
  float* s = smem;
  int* phys_of = reinterpret_cast<int*>(smem + n * ws);
  long long oa, ob;
  batch_offsets(o.batch, blockIdx.x, oa, ob);
  load_system(s, ws, o, oa, ob, t, blockDim.x);
  __syncthreads();
  float* row = s + t * ws;
  int pos = t;  // the logical position of row t
  for (int j = 0; j < n; ++j) {
    unsigned long long key = warp_max_key(t < n && pos >= j ? pivot_key(row[j], pos, t) : 0ull);
    if (lane == 0) best[j & 1][warp] = key;
    __syncthreads();
    key = best[j & 1][0];
    for (int w = 1; w < warps; ++w) key = max_key(key, best[j & 1][w]);
    const int owner = key_owner(key), p = key_pos(key);
    if (pos == j)
      pos = p;
    else if (t == owner)
      pos = j;
    if (t < n && pos > j) eliminate(row, s + owner * ws, j, n + 1);
  }
  if (t < n) phys_of[pos] = t;
  __syncthreads();
  if (warp != 0) return;
  // Back substitution in warp 0: lane l holds x of logical rows l, l + 32, ...
  constexpr int kRows = (kLuMaxN + 31) / 32;
  float x[kRows];
  int ph[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = lane + 32 * r;
    ph[r] = i < n ? phys_of[i] : 0;
    x[r] = i < n ? s[ph[r] * ws + n] : 0.0f;
  }
  for (int j = n - 1; j >= 0; --j) {
    const int oj = j % 32, rj = j / 32;
    float v = 0.0f;
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if (r == rj) {
        if (lane == oj) x[r] = __fdiv_rn(x[r], s[ph[r] * ws + j]);
        v = x[r];
      }
    const float xj = __shfl_sync(kFull, v, oj);
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if (lane + 32 * r < j) x[r] = __fsub_rn(x[r], __fmul_rn(s[ph[r] * ws + j], xj));
  }
  float* out = o.x + (long long)blockIdx.x * n;
#pragma unroll
  for (int r = 0; r < kRows; ++r)
    if (lane + 32 * r < n) out[lane + 32 * r] = x[r];
}

// n <= 32: 32 / g systems a warp, g (a power of two, n <= g <= 32) lanes a
// system, lane t of a system owns its row t.
__global__ void lu_solve_warp(Solve o, int g, unsigned n_sys) {
  extern __shared__ float smem[];
  const int n = o.n, ws = lu_stride(n), per_block = kLuWarpThreads / g, slot = threadIdx.x / g, t = threadIdx.x % g;
  const unsigned sys = blockIdx.x * per_block + slot;
  const bool live = sys < n_sys;
  float* s = smem + slot * n * ws;
  int* phys_of = reinterpret_cast<int*>(smem + per_block * n * ws) + slot * 32;
  if (live) {
    long long oa, ob;
    batch_offsets(o.batch, sys, oa, ob);
    load_system(s, ws, o, oa, ob, t, g);
  }
  __syncwarp();
  float* row = s + t * ws;
  const bool owns = live && t < n;
  int pos = t;
  for (int j = 0; j < n; ++j) {
    unsigned long long key = owns && pos >= j ? pivot_key(row[j], pos, t) : 0ull;
    for (int offset = g / 2; offset > 0; offset /= 2) key = max_key(key, __shfl_xor_sync(kFull, key, offset, g));
    const int owner = key_owner(key), p = key_pos(key);
    if (pos == j)
      pos = p;
    else if (t == owner)
      pos = j;
    if (owns && pos > j) eliminate(row, s + owner * ws, j, n + 1);
    __syncwarp();
  }
  if (owns) phys_of[pos] = t;
  __syncwarp();
  const int ph = owns ? phys_of[t] : 0;
  float x = owns ? s[ph * ws + n] : 0.0f;
  for (int j = n - 1; j >= 0; --j) {
    if (owns && t == j) x = __fdiv_rn(x, s[ph * ws + j]);
    const float xj = __shfl_sync(kFull, x, j, g);
    if (owns && t < j) x = __fsub_rn(x, __fmul_rn(s[ph * ws + j], xj));
  }
  if (owns) o.x[(long long)sys * n + t] = x;
}

Batch batch_of(const long long* p, int nd) {
  Batch d{};
  d.nd = nd;
  for (int i = 0; i < nd; ++i) {
    d.size[i] = (int)p[i];
    d.s0[i] = p[kMaxBatchDims + i];
    d.s1[i] = p[2 * kMaxBatchDims + i];
  }
  return d;
}

}  // namespace

// C interface, loaded with ctypes.  Strides are in elements.  Each returns the
// launch's cudaError_t (0 on success).
//
// params holds, as 64-bit integers: n_batch, m, n, k, sam, sak, sck, scn, nd,
// then the batch sizes [kMaxBatchDims] (innermost last), a's batch strides
// [kMaxBatchDims] and c's [kMaxBatchDims].  a: [batch, m, k] f32; c: [batch,
// k, n] f32, or NULL to sum a over k (n must be 1); out: [batch, m, n] f32,
// contiguous, written whole.  k >= 1, n_batch * m * n < 2^31.  One launch.
extern "C" int fd_fixed_contract(const void* a, const void* c, void* out, const void* params, void* stream) {
  long long p[9 + 3 * kMaxBatchDims];
  std::memcpy(p, params, sizeof p);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  Contract o{static_cast<const float*>(a), static_cast<const float*>(c), static_cast<float*>(out),
             (int)p[1], (int)p[2], (int)p[3], p[4], p[5], p[6], p[7], batch_of(p + 9, (int)p[8])};
  const unsigned n_batch = (unsigned)p[0];
  if (o.k <= kSerialMaxK) {
    const unsigned n_out = n_batch * (unsigned)o.m * (unsigned)o.n;
    contract_serial<<<(n_out + kSerialThreads - 1) / kSerialThreads, kSerialThreads, 0, st>>>(o, n_out);
    return (int)cudaGetLastError();
  }
  return (int)launch_contract(o, n_batch, st);
}

// params holds: n_sys, n, sar, sac, sbr, nd, then the batch sizes, a's and
// b's batch strides ([kMaxBatchDims] each).  a: [batch, n, n] f32; b: [batch,
// n] f32; x: [batch, n] f32, contiguous.  1 <= n <= fd_fixed_lu_max_n().  One
// launch.
extern "C" int fd_fixed_lu_solve(const void* a, const void* b, void* x, const void* params, void* stream) {
  long long p[6 + 3 * kMaxBatchDims];
  std::memcpy(p, params, sizeof p);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Solve o{static_cast<const float*>(a), static_cast<const float*>(b), static_cast<float*>(x),
                (int)p[1], p[2], p[3], p[4], batch_of(p + 6, (int)p[5])};
  const unsigned n_sys = (unsigned)p[0];
  const int n = o.n, ws = lu_stride(n);
  if (n > 32) {
    const size_t shm = (size_t)n * ws * sizeof(float) + n * sizeof(int);
    lu_solve_block<<<n_sys, (n + 31) / 32 * 32, shm, st>>>(o);
  } else {
    int g = 1;
    while (g < n) g *= 2;
    const int per_block = kLuWarpThreads / g;
    const size_t shm = (size_t)per_block * n * ws * sizeof(float) + per_block * 32 * sizeof(int);
    lu_solve_warp<<<(n_sys + per_block - 1) / per_block, kLuWarpThreads, shm, st>>>(o, g, n_sys);
  }
  return (int)cudaGetLastError();
}

extern "C" int fd_fixed_lu_max_n() { return kLuMaxN; }
