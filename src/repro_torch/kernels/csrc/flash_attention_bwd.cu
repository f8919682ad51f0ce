// The backward pass of flash attention (causal / sliding-window GQA),
// hand-written for Hopper.
//
// Replaces: no Pallas kernel.  The reference's LM differentiates its
// pure-JAX online-softmax scan `flash_attention`
// (src/repro/models/lm/attention.py:56-107) by autodiff; the port's
// forward runs flash_attention.cu, so its training step needs this kernel
// for dQ, dK and dV.
//
// Computes, for q (B, S, Hq, hd), k/v (B, T, Kh, hd), the forward's output
// o and the upstream gradient dO (B, S, Hq, hd), and the forward's per-row
// log-sum-exp L (B, Hq, S) f32:
//   D_i   = sum_d dO_id O_id                                      (pass 1)
//   P_ij  = exp(scale q_i.k_j - L_i) where key j is unmasked, else 0
//   dS_ij = P_ij (dO_i.v_j - D_i)
//   dV_j  = sum_i P_ij dO_i,   dK_j = scale sum_i dS_ij q_i       (pass 2)
//   dQ_i  = scale sum_j dS_ij k_j                                  (pass 3)
// under the forward's mask (causal: j <= pos_i; window > 0: j > pos_i -
// window; keys 0 .. T-1, query positions from q_pos).  Query head h reads
// KV head h / G (G = Hq / Kh); dK and dV sum over the G heads of a group.
//
// Determinism: no atomics.  Pass 2 runs one block per (key block, KV
// head, batch row), which visits the G heads and then the query tiles in a
// fixed order with its dK and dV in registers; pass 3 one block per
// (query block, query head, batch row).  Two launches on the same inputs
// are bitwise equal.  Each of passes 2 and 3 recomputes S and dP for its
// tiles, 14 hd flops a (query, key) pair in all against the 10 hd of a
// pass that keeps them: the price of no atomics and no (S, T) buffer.
// Band skipping: pass 1 also writes each 64-row query tile's least and
// greatest position, and passes 2 and 3 visit only the (query tile, key
// tile) pairs whose band [pmin - window + 1, pmax] meets.
//
// What bounds it on the H100: operations.  The five products take 10 hd
// flops a pair (2.5 x the forward's 4 hd); at the TinyLlama layer (B = 4,
// S = T = 2048, 32 / 4 heads of 64, causal: 2.686e8 pairs) that is 1.72e11
// flops, 0.174 ms at the 989 TFLOP/s bf16 tensor-core peak, against 0.15
// GB of traffic, 0.05 ms at 3.35 TB/s.  Two routes, by the inputs' type,
// both on the tensor cores and fed by TMA, both with pass 1
// (`bwd_rows_kernel`, a template on the element type) writing, for each
// query row, the pair (L log2 e, D) into a (B, Hq, S padded to 64, 2)
// scratch, rows past S as (+inf, 0), so that their P is exp2(-inf) = 0.
// Tiles are stored as 128-byte rows under the 128-byte swizzle (64 bf16
// or 32 f32 columns a chunk of hd padded to 64 or 128); the tensor maps'
// head_dim is a dimension of size hd, so pad columns and rows past S or T
// arrive as zeros.  The producer of each ring is thread 0, not a warp of
// its own: with a ninth warp a thread may hold 168 registers (an SM's four
// register partitions, three warps on one); at 8 warps it may hold 255.
// For 128 < hd <= 256 each route has a wide form at hd padded to 256 (the
// sections "f32 route, 128 < hd <= 256" and "bf16 route, 128 < hd <= 256"
// at their kernels).
//
// bf16 (the training path), in the shape of the forward's bf16 route
// (flash_attention.cu, flash_tc_kernel).  Pass 2 (`bwd_dkdv_tc_kernel`):
// a block of 256 threads owns 128 keys of one KV head, 64 for each of two
// warpgroups.  Thread 0 loads K and V once by TMA, then streams the (Q,
// dO) tiles of 64 rows of the visited (head, query tile) pairs, each with
// its 64 (L log2 e, D) pairs (a 1-D bulk copy), through a ring of 3
// stages with "full" mbarriers (the copies' bytes) and "empty" ones (the
// 8 warps' releases).  A warpgroup computes the transposed scores, so
// that P and dS come out in the layout of a register A operand:
//   S^T = K Q^T, dP^T = V dO^T    wgmma m64n64k16, both operands from
//                                 shared memory, K-major;
//   P^T = exp2(S^T scale log2 e - L log2 e), dS^T = P^T (dP^T - D)  f32,
//                                 masked by selects in warps whose keys
//                                 meet the tile's band edge;
//   dV += P^T dO, dK += dS^T Q    wgmma m64n{64,128}k16, A (P, dS rounded
//                                 to bf16) from registers, B (dO, Q) read
//                                 MN-major from shared memory.
// dK and dV stay in registers (64 + 64 a thread at hd 128) and are stored
// as bf16 once, dK times the scale.  Pass 3 (`bwd_dq_tc_kernel`): a block
// of 256 threads owns 128 query rows of one head, 64 a warpgroup; thread 0
// loads Q and dO once and streams the 64-key K and V tiles of the block's
// band through the same ring; S = Q K^T and dP = dO V^T (SS), P and dS in
// f32 registers, dQ += bf16(dS) K (RS, K MN-major), dQ times the scale
// stored as bf16.  Pass 2 needs ~230 registers a thread at hd 128.
// Arithmetic: P and dS are rounded to bf16 before the three products that
// read them (P dO, dS Q, dS K), as the forward rounds P before P V; the
// reference keeps them in f32.  S, dP, the sums, L, D and the rescales
// stay f32; each output is rounded to bf16 once.
// `ref.py::attention_bwd_bf16_ref` is this arithmetic on the CPU.
//
// f32 (federated LM and f32 training): split-TF32 products on the tensor
// cores, the arithmetic of the forward's f32 route.  Each f32 product a.b
// is taken as a_hi b_hi + a_hi b_lo + a_lo b_hi, a_hi = a rounded to TF32
// (cvt.rna, 10 mantissa bits), a_lo = a - a_hi exactly; P, dS, L, D, the
// rescales and the outputs stay f32.  At the TinyLlama layer in f32 that
// is 3 x 14 hd flops a pair, 7.22e11, 1.46 ms at the 495 TFLOP/s TF32
// peak (the bound, 3 x 10 hd, 1.04 ms); the same flops as f32 FMA on the
// CUDA cores would take 10.8 ms at 67 TFLOP/s.
//
// Operand layouts.  wgmma takes .tf32 operands from shared memory only
// K-major (no transpose bit), and each split operand needs its hi and lo
// where the product reads it.  So each product is put in the form whose
// shared-memory operand is stored K-major as loaded (hd contiguous), and
// the other operand comes from registers:
//   pass 2 (`bwd_dkdv_f32_kernel`): a block of 256 threads owns 64 keys
//   of one KV head and streams (Q, dO) tiles of R query rows (R = 64 at
//   hd padded to 64, 32 at 128) through a TMA ring of 2 stages; all 256
//   threads split each tile in place (hi where TMA put it, lo beside it).
//   The two warpgroups take different products of the same 64 keys:
//     warpgroup 0: S^T = K Q^T    A = K from registers (loaded once,
//                                 split per group of k8 steps), B = Q hi /
//                                 lo; P^T = exp2(S^T scale log2 e - L
//                                 log2 e), masked;
//     warpgroup 1: dP^T = V dO^T  A = V, B = dO; dS^T = P^T (dP^T - D),
//                                 P^T handed over through shared memory;
//   each writes its P^T or dS^T, split, as a B operand (rows of 64 keys,
//   K = the tile's rows), and then
//     warpgroup 0: dV^T += dO^T P   M = hd, N = 64 keys, K = the rows: A
//     warpgroup 1: dK^T += Q^T dS   (dO^T or Q^T) gathered into registers
//                                   from the split tile (its hi and lo),
//                                   B = P^T or dS^T hi / lo.
//   The transposed outputs dV^T and dK^T (hd rows, 32 + 32 registers a
//   thread a 64-row block of hd) avoid a transposed copy of Q and dO, which
//   .tf32 would need as the B operand of dV = P^T dO: at hd 128 a tile's
//   Q, dO, Q^T and dO^T, hi and lo, would take 128 KB for 32 rows.
//   Pass 3 (`bwd_dq_f32_kernel`): a block of 256 threads owns 64 query
//   rows of one head and streams 32-key (K, V) tiles; all threads split K
//   and V in place and write K^T hi and lo (hd rows of the tile's 32 keys,
//   in the order 0 2 4 6 1 3 5 7 within each 8, so that dS goes from the
//   accumulator to the A layout as the forward's P does);
//     warpgroup 0: S = Q K^T, P    A = Q from registers, B = K hi / lo;
//     warpgroup 1: dP = dO V^T, dS = P (dP - D), P handed over;
//   dS handed back, then each warpgroup takes half the head dim of
//     dQ += dS K                    A = dS split in registers, B = K^T.
// Registers: the A operand of the scores (hd / 2 a thread, as loaded) is
// split a group of k8 steps at a time (all 8 at hd 64, 4 at 128), since
// an A fragment must stay in its registers until its product completes.
// ptxas: dK / dV 243 registers at hd 64 and 248 at 128, no spill; dQ 168
// at 64, and at 128 255 with 88 bytes spilled (groups of 2 steps spill
// as much).
//
// Short sums.  The tensor core truncates the sums it accumulates, so no
// accumulator runs over a row's or key's whole band: S and dP sum over hd
// (<= 16 k8 steps, 3 products each) in one accumulator; each tile's dV^T,
// dK^T (R rows) and dQ (32 keys) go into a fresh accumulator, which meets
// the running sum in an f32 add.  Error analysis: |a_lo| <= 2^-11 |a|;
// a_hi b_lo and a_lo b_hi read the lo truncated to 10 mantissa bits (<=
// 2^-21 |a b| each) and the dropped a_lo b_lo is <= 2^-22 |a b|, so each
// product is within ~2^-20 of exact, and with random signs a sum of n
// products within ~2^-20 sqrt(n) of its terms' magnitudes; a k8 step of
// the tensor core truncates its sum (~2^-23 of the running sum, <= 48
// truncations in S and dP, 24 in a tile's dV^T or dK^T, 12 in dQ); the
// running sums' f32 adds round to nearest.  An error e in a score moves P
// by e P, and so dV and dK by e times their terms.  All of it is of the
// order of f32 rounding over the same sums: the route's rule, 2e-5 of max
// |grad| per element against `attention_bwd_ref`, holds with room (on
// the H100 at most 0.32 of the limit, at the TinyLlama, Danube and
// hd-128 shapes).  `ref.py::attention_bwd_split_tf32` emulates the operands'
// split on the CPU (not the tensor core's sums), where the tests hold it
// to the rule against jax.grad at scores scaled to |s| = 30.
//
// Shared memory: pass 2 at hd 128 two 65 KB stages (Q, dO, their lo, the
// rows), P^T and dS^T hi and lo 32 KB, the P hand-over 8 KB: 170 KB; at 64
// (R = 64) 211 KB.  Pass 3 two stages of K, V and K^T with their lo (96
// KB at hd 128, 48 at 64) and an 8 KB hand-over: 201 / 105 KB.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math_constants.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {


constexpr int kTile = 64;          // query rows a tile of pass 1 and the walk
constexpr int kThreads = 256;      // pass 1's block

// the least and greatest position of query tile qt's rows into bounds[2 qt]
// and bounds[2 qt + 1] (one warp)
__device__ __forceinline__ void tile_bounds(const int32_t* q_pos,
                                            int64_t s_len, int64_t qt,
                                            int32_t* bounds) {
  const int lane = threadIdx.x & 31;
  int32_t mn = INT_MAX, mx = INT_MIN;
  for (int r = lane; r < kTile; r += 32) {
    const int64_t row = qt * kTile + r;
    if (row < s_len) {
      mn = min(mn, q_pos[row]);
      mx = max(mx, q_pos[row]);
    }
  }
#pragma unroll
  for (int x = 16; x > 0; x >>= 1) {
    mn = min(mn, __shfl_xor_sync(0xffffffffu, mn, x));
    mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, x));
  }
  if (lane == 0) {
    bounds[2 * qt] = mn;
    bounds[2 * qt + 1] = mx;
  }
}

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// pass 1 of both routes: for 64 rows of one (batch row, head), the pairs
// (L log2 e, D = rowsum(dO o)) into `rows`, (B, Hq, S padded to 64, 2)
// f32, rows past S as (+inf, 0).  o and dO (bf16 or f32) are read through
// their strides (16-byte aligned, as TMA wants them), 8 lanes a row, 16
// bytes a lane.  The (0, 0) blocks write the tile's least and greatest
// positions.
template <typename T>
__global__ void __launch_bounds__(kThreads)
bwd_rows_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                const float* __restrict__ lse,
                const int32_t* __restrict__ q_pos, float* __restrict__ rows,
                int32_t* __restrict__ bounds, int64_t s_len, int64_t hd,
                Strides os, Strides ds) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int64_t hq = gridDim.y, s_pad = (int64_t)gridDim.x * kTile;
  float* out = rows + ((b * hq + h) * s_pad + qt * kTile) * 2;
  using W = Word<T>;
  for (int r = 4 * warp + (lane >> 3); r < kTile; r += kThreads / 8) {
    const int64_t row = qt * kTile + r;
    float acc = 0.0f;
    if (row < s_len) {
      const T* op = o + b * os.b + row * os.s + h * os.h;
      const T* dp = dout + b * ds.b + row * ds.s + h * ds.h;
      for (int64_t c = W::kN * (lane & 7); c < hd; c += 8 * W::kN) {
        float x[W::kN], y[W::kN];
        if (c + W::kN <= hd) {
          W::unpack(*reinterpret_cast<const uint4*>(op + c), x);
          W::unpack(*reinterpret_cast<const uint4*>(dp + c), y);
        } else {
#pragma unroll
          for (int e = 0; e < W::kN; ++e) {
            x[e] = c + e < hd ? widen(op[c + e]) : 0.0f;
            y[e] = c + e < hd ? widen(dp[c + e]) : 0.0f;
          }
        }
#pragma unroll
        for (int e = 0; e < W::kN; ++e) acc = fmaf(y[e], x[e], acc);
      }
    }
#pragma unroll
    for (int x = 4; x > 0; x >>= 1) {
      acc += __shfl_xor_sync(0xffffffffu, acc, x);
    }
    if ((lane & 7) == 0) {
      const bool ok = row < s_len;
      out[2 * r] = ok ? lse[(b * hq + h) * s_len + row] * kLog2e
                      : CUDART_INF_F;
      out[2 * r + 1] = ok ? acc : 0.0f;
    }
  }
  if (h == 0 && b == 0 && warp == 0) tile_bounds(q_pos, s_len, qt, bounds);
}

// The (head, query tile) pairs a pass-2 block visits, in order: for each
// of the G heads of its group, the 64-row query tiles whose key band meets
// the block's keys [k0, k_last].  All 32 lanes of a warp step it together
// (a ballot tests 32 tiles at once), so the loops over it are warp-uniform.
struct TileWalk {
  const int32_t* bounds;
  int64_t n_qt, k0, k_last, t_len, window;
  int group, causal;
  int g;             // the head of the group being walked
  int64_t base;      // the first of the 32 tiles `mask` covers
  uint32_t mask;     // those of them left to visit

  __device__ __forceinline__ bool next(int& g_out, int64_t& qt_out) {
    while (mask == 0) {
      if (g >= group) return false;
      base += 32;
      if (base >= n_qt) {
        base = 0;
        if (++g >= group) return false;
      }
      const int64_t qt = base + (threadIdx.x & 31);
      bool meets = false;
      if (qt < n_qt) {
        int64_t lo, hi;
        key_band(bounds[2 * qt], bounds[2 * qt + 1], t_len, causal, window,
                 lo, hi);
        meets = lo <= hi && hi >= k0 && lo <= k_last;
      }
      mask = __ballot_sync(0xffffffffu, meets);
    }
    g_out = g;
    qt_out = base + __ffs(mask) - 1;
    mask &= mask - 1;
    return true;
  }
};

// ----------------------------------------------------------- bf16 route --

constexpr int kTcThreads = 256;            // two consumer warpgroups
constexpr int kTcWarps = kTcThreads / 32;
constexpr int kTcStages = 3;               // streamed tiles in flight
constexpr int kTcBlock = 128;              // keys (pass 2), rows (pass 3)
constexpr int kRowBytes = kTile * 8;       // a tile's (L log2 e, D) pairs

// pass 2: K and V of the block's 128 keys, then a ring of (Q, dO) tiles of
// 64 rows and their (L log2 e, D) pairs
template <int HD_PAD>
struct KvLayout {
  static constexpr int kChunks = HD_PAD / 64;            // 64-column chunks
  static constexpr int kKVChunk = kTcBlock * kSwizzleRow;
  static constexpr int kKVBytes = kChunks * kKVChunk;    // K, or V
  static constexpr int kTChunk = kTile * kSwizzleRow;
  static constexpr int kTBytes = kChunks * kTChunk;      // a Q or dO tile
  static constexpr int kOffV = kKVBytes;
  static constexpr int kOffStage = 2 * kKVBytes;
  static constexpr int kStage = 2 * kTBytes;              // Q, then dO
  static constexpr int kOffRows = kOffStage + kTcStages * kStage;
  static constexpr int kOffBar = kOffRows + kTcStages * kRowBytes;
  static constexpr uint32_t kTx = 2 * kTBytes + kRowBytes;
  // 1 + 2 * stages mbarriers, slack to align to 1 KB
  static constexpr size_t kBytes = kOffBar + 8 * (1 + 2 * kTcStages) + 1024;
};

// pass 3: Q and dO of the block's 128 rows, then a ring of (K, V) tiles of
// 64 keys
template <int HD_PAD>
struct QLayout {
  static constexpr int kChunks = HD_PAD / 64;
  static constexpr int kQChunk = kTcBlock * kSwizzleRow;
  static constexpr int kQBytes = kChunks * kQChunk;      // Q, or dO
  static constexpr int kTChunk = kTile * kSwizzleRow;
  static constexpr int kTBytes = kChunks * kTChunk;      // a K or V tile
  static constexpr int kOffDo = kQBytes;
  static constexpr int kOffStage = 2 * kQBytes;
  static constexpr int kStage = 2 * kTBytes;              // K, then V
  static constexpr int kOffBar = kOffStage + kTcStages * kStage;
  static constexpr uint32_t kTx = 2 * kTBytes;
  static constexpr size_t kBytes = kOffBar + 8 * (1 + 2 * kTcStages) + 1024;
};


// the A fragments (bf16) of a k16 step from 64 columns of an f32
// accumulator: the accumulator layout of columns 16 kk .. 16 kk + 15 is the
// A-operand layout of a k16 step
__device__ __forceinline__ void pack_a(uint32_t (&a)[4][4],
                                       const float (&x)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      a[kk][j] = pack_bf16(x[8 * kk + 2 * j], x[8 * kk + 2 * j + 1]);
}

// Store a (64 x HD_PAD) accumulator's rows `row_a` and `row_a` + 8 (of
// len), columns < hd, times `mul`, as bf16 into a contiguous (B, len,
// heads, hd) tensor at (b, ., h)
template <int HD_PAD>
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst,
                                           const float (&acc)[HD_PAD / 2],
                                           float mul, int64_t b,
                                           int64_t row_a, int64_t len,
                                           int64_t h, int64_t heads,
                                           int64_t hd, int quad) {
#pragma unroll
  for (int j = 0; j < HD_PAD / 8; ++j) {
    const int64_t d = 8 * j + 2 * quad;
    if (d >= hd) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int64_t row = row_a + 8 * half;
      if (row >= len) continue;
      const float x0 = acc[4 * j + 2 * half] * mul;
      const float x1 = acc[4 * j + 2 * half + 1] * mul;
      __nv_bfloat16* p = dst + ((b * len + row) * heads + h) * hd + d;
      if ((hd & 1) == 0) {
        *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x0, x1);
      } else {
        p[0] = __float2bfloat16_rn(x0);
        if (d + 1 < hd) p[1] = __float2bfloat16_rn(x1);
      }
    }
  }
}

// pass 2: dK and dV of 128 keys of one KV head, 64 a warpgroup
template <int HD_PAD>
__global__ void __launch_bounds__(kTcThreads, 1)
bwd_dkdv_tc_kernel(const __grid_constant__ CUtensorMap q_map,
                   const __grid_constant__ CUtensorMap do_map,
                   const __grid_constant__ CUtensorMap k_map,
                   const __grid_constant__ CUtensorMap v_map,
                   const float* __restrict__ rows,
                   const int32_t* __restrict__ q_pos,
                   const int32_t* __restrict__ bounds,
                   __nv_bfloat16* __restrict__ dk,
                   __nv_bfloat16* __restrict__ dv, int64_t s_len,
                   int64_t t_len, int64_t hq, int64_t hd, int causal,
                   int64_t window, float scale) {
  using L = KvLayout<HD_PAD>;
  constexpr int kChunks = L::kChunks;
  extern __shared__ uint8_t smem_raw[];
  // 128-byte swizzled tiles need 1 KB alignment
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t k_base = base, v_base = base + L::kOffV;
  const uint32_t stage0 = base + L::kOffStage;
  const uint32_t rows0 = base + L::kOffRows;
  const uint32_t bar_kv = base + L::kOffBar;                // K, V arrived
  const uint32_t bar_full = bar_kv + 8;                     // [stage]
  const uint32_t bar_empty = bar_full + 8 * kTcStages;      // [stage]
  const float4* rows_s =
      reinterpret_cast<const float4*>(smem_raw + (rows0 - raw));

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // grid (Kh, B, key tiles): the first key tiles, whose causal bands are
  // the longest, are all launched first
  const int64_t k0 = (int64_t)blockIdx.z * kTcBlock;
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int group = (int)(hq / gridDim.x);
  const int64_t n_qt = (s_len + kTile - 1) / kTile;
  const int64_t s_pad = n_qt * kTile;
  const int64_t k_last = (k0 + kTcBlock < t_len ? k0 + kTcBlock : t_len) - 1;

  if (tid == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < kTcStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, kTcWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // thread 0 issues every copy: K and V now, and the (Q, dO, rows) of the
  // it-th visited (head, query tile) into stage it % stages
  const auto load_stage = [&](int it, int g, int64_t qt) {
    const int s = it % kTcStages;
    const uint32_t full = bar_full + 8 * s;
    const uint32_t st = stage0 + s * L::kStage;
    const int h = kvh * group + g;
    const int q0 = (int)(qt * kTile);
    mbar_expect_tx(full, L::kTx);
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      tma_load_4d(st + c * L::kTChunk, &q_map, full, 64 * c, q0, h, b);
      tma_load_4d(st + L::kTBytes + c * L::kTChunk, &do_map, full, 64 * c,
                  q0, h, b);
    }
    bulk_load(rows0 + s * kRowBytes,
              rows + (((int64_t)b * hq + h) * s_pad + qt * kTile) * 2,
              kRowBytes, full);
  };
  TileWalk walk{bounds, n_qt, k0, k_last, t_len, window, group, causal, 0,
                -32, 0u};
  TileWalk ahead = walk;            // the producer's, stages - 1 tiles on
  if (warp == 0) {
    if (lane == 0) {
      mbar_expect_tx(bar_kv, 2 * L::kKVBytes);
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        tma_load_4d(k_base + c * L::kKVChunk, &k_map, bar_kv, 64 * c,
                    (int)k0, kvh, b);
        tma_load_4d(v_base + c * L::kKVChunk, &v_map, bar_kv, 64 * c,
                    (int)k0, kvh, b);
      }
    }
    for (int i = 0; i < kTcStages - 1; ++i) {
      int g;
      int64_t qt;
      if (!ahead.next(g, qt)) break;
      if (lane == 0) load_stage(i, g, qt);
    }
    __syncwarp();
  }

  // ---- warpgroup wg owns keys k0 + 64 wg .. k0 + 64 wg + 63 ----
  const int wg = __shfl_sync(0xffffffffu, warp >> 2, 0);
  const int quad = lane & 3;
  const int64_t kw0 = k0 + 64 * wg;
  const int64_t kwarp = kw0 + 16 * (warp & 3);      // this warp's 16 keys
  const int64_t key_a = kwarp + (lane >> 2);        // and key_a + 8
  const uint32_t k_wg = k_base + wg * 64 * kSwizzleRow;
  const uint32_t v_wg = v_base + wg * 64 * kSwizzleRow;
  const float sl2 = scale * kLog2e;

  float adk[HD_PAD / 2], adv[HD_PAD / 2], st[32], dpt[32];
#pragma unroll
  for (int i = 0; i < HD_PAD / 2; ++i) adk[i] = adv[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < 32; ++i) st[i] = dpt[i] = 0.0f;

  mbar_wait(bar_kv, 0);
  for (int it = 0;; ++it) {
    int g;
    int64_t qt;
    if (!walk.next(g, qt)) break;
    const int s = it % kTcStages;
    if (warp == 0) {
      // tile it + stages - 1 into the stage tile it - 1 has released
      int g2;
      int64_t qt2;
      if (ahead.next(g2, qt2) && lane == 0) {
        const int j = it + kTcStages - 1;
        if (it >= 1) {
          mbar_wait(bar_empty + 8 * (j % kTcStages),
                    (uint32_t)(((it - 1) / kTcStages) & 1));
        }
        load_stage(j, g2, qt2);
      }
      __syncwarp();
    }
    mbar_wait(bar_full + 8 * s, (uint32_t)((it / kTcStages) & 1));

    const int32_t pmin = bounds[2 * qt], pmax = bounds[2 * qt + 1];
    int64_t lo, hi;
    key_band(pmin, pmax, t_len, causal, window, lo, hi);
    if (lo <= hi && hi >= kw0 && lo <= kw0 + 63) {     // warpgroup-uniform
      const uint32_t q_s = stage0 + s * L::kStage;
      const uint32_t do_s = q_s + L::kTBytes;

      // S^T = K Q^T and dP^T = V dO^T: 16 columns of hd a step, 32 bytes
      // into a 128-byte row
      fence_regs(st);
      fence_regs(dpt);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < HD_PAD / 16; ++ks) {
        const uint32_t col = (ks % 4) * 32;
        wgmma_ss_n64(st, desc128(k_wg + (ks / 4) * L::kKVChunk + col, 16,
                                 1024),
                     desc128(q_s + (ks / 4) * L::kTChunk + col, 16, 1024),
                     ks > 0);
      }
#pragma unroll
      for (int ks = 0; ks < HD_PAD / 16; ++ks) {
        const uint32_t col = (ks % 4) * 32;
        wgmma_ss_n64(dpt, desc128(v_wg + (ks / 4) * L::kKVChunk + col, 16,
                                  1024),
                     desc128(do_s + (ks / 4) * L::kTChunk + col, 16, 1024),
                     ks > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(st);
      fence_regs(dpt);

      // st[i], dpt[i]: key key_a (i & 2 == 0) or key_a + 8, query row q0 +
      // c, c = 8 (i / 4) + 2 quad + (i & 1); rows_s holds rows c, c + 1 of
      // column pair i / 4 as one float4 (L log2 e, D, L log2 e, D)
      const float4* rw = rows_s + s * (kRowBytes / 16);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 x = rw[4 * j + quad];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e;
          const float p = exp2f(fmaf(st[i], sl2, (e & 1) ? -x.z : -x.x));
          st[i] = p;
          dpt[i] = p * (dpt[i] - ((e & 1) ? x.w : x.y));
        }
      }
      // Where a key of this warp lies past the tile's band edge, mask by
      // selects (a masked p may be inf: it is replaced, not multiplied).
      // Rows past S have P = 0 already; keys past T are never stored.
      const bool open = (!causal || kwarp + 15 <= pmin) &&
                        (window <= 0 || kwarp > pmax - window);
      if (!open) {                                     // warp-uniform
        const int64_t q0 = qt * kTile;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * j + e;
            const int64_t row = q0 + 8 * j + 2 * quad + (e & 1);
            const int64_t pos = row < s_len ? q_pos[row] : 0;
            const int64_t key = key_a + ((e & 2) ? 8 : 0);
            const bool ok = (!causal || key <= pos) &&
                            (window <= 0 || key > pos - window);
            st[i] = ok ? st[i] : 0.0f;
            dpt[i] = ok ? dpt[i] : 0.0f;
          }
        }
      }

      // dV += P^T dO and dK += dS^T Q, P and dS rounded to bf16: 16 query
      // rows (2 KB of 128-byte rows) a step, B read MN-major
      uint32_t pa[4][4], sa[4][4];
      pack_a(pa, st);
      pack_a(sa, dpt);
      fence_regs(adv);
      fence_regs(adk);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_pv<HD_PAD>(adv, pa[kk],
                         desc128(do_s + kk * 16 * kSwizzleRow, L::kTChunk,
                                 1024));
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_pv<HD_PAD>(adk, sa[kk],
                         desc128(q_s + kk * 16 * kSwizzleRow, L::kTChunk,
                                 1024));
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(adv);
      fence_regs(adk);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty + 8 * s);   // this warp is done
  }

  const int64_t kh = gridDim.x;
  store_rows<HD_PAD>(dk, adk, scale, b, key_a, t_len, kvh, kh, hd, quad);
  store_rows<HD_PAD>(dv, adv, 1.0f, b, key_a, t_len, kvh, kh, hd, quad);
}

// pass 3: dQ of 128 query rows of one head, 64 a warpgroup
template <int HD_PAD>
__global__ void __launch_bounds__(kTcThreads, 1)
bwd_dq_tc_kernel(const __grid_constant__ CUtensorMap q_map,
                 const __grid_constant__ CUtensorMap do_map,
                 const __grid_constant__ CUtensorMap k_map,
                 const __grid_constant__ CUtensorMap v_map,
                 const float* __restrict__ rows,
                 const int32_t* __restrict__ q_pos,
                 const int32_t* __restrict__ bounds,
                 __nv_bfloat16* __restrict__ dq, int64_t s_len,
                 int64_t t_len, int64_t group, int64_t hd, int causal,
                 int64_t window, float scale) {
  using L = QLayout<HD_PAD>;
  constexpr int kChunks = L::kChunks;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t q_base = base, do_base = base + L::kOffDo;
  const uint32_t stage0 = base + L::kOffStage;
  const uint32_t bar_q = base + L::kOffBar;                 // Q, dO arrived
  const uint32_t bar_full = bar_q + 8;                      // [stage]
  const uint32_t bar_empty = bar_full + 8 * kTcStages;      // [stage]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int64_t n_qt = (s_len + kTile - 1) / kTile;
  const int64_t s_pad = n_qt * kTile;
  const int64_t n_blk = (s_len + kTcBlock - 1) / kTcBlock;
  // grid (Hq, B, query tiles): the last query tiles, whose causal bands
  // are the longest, are all launched first
  const int64_t q0 = (n_blk - 1 - (int64_t)blockIdx.z) * kTcBlock;
  const int h = blockIdx.x, b = blockIdx.y;
  const int kvh = h / (int)group;
  const int64_t hq = gridDim.x;

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kTcStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, kTcWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // each warpgroup's key band (its 64-row tile's), and the block's: the
  // union of the two
  int64_t lo[2], hi[2];
#pragma unroll
  for (int w = 0; w < 2; ++w) {
    const int64_t t = q0 / kTile + w;
    lo[w] = 1;
    hi[w] = 0;
    if (t < n_qt) {
      key_band(bounds[2 * t], bounds[2 * t + 1], t_len, causal, window,
               lo[w], hi[w]);
    }
  }
  int64_t b_lo = INT64_MAX, b_hi = -1;
#pragma unroll
  for (int w = 0; w < 2; ++w) {
    if (lo[w] <= hi[w]) {
      b_lo = lo[w] < b_lo ? lo[w] : b_lo;
      b_hi = hi[w] > b_hi ? hi[w] : b_hi;
    }
  }
  // tile counts as warp-uniform values (a shuffle from lane 0), so that
  // the compiler sees no divergent path around the wgmma instructions
  const int kt0 = __shfl_sync(
      0xffffffffu, (int)(b_hi >= 0 ? b_lo / kTile * kTile : 0), 0);
  const int n_tiles = __shfl_sync(
      0xffffffffu, (int)(b_hi >= 0 ? (b_hi - kt0) / kTile + 1 : 0), 0);

  // thread 0 issues every copy: Q and dO now, the K and V of key tile it
  // into stage it % stages
  const auto load_kv = [&](int it) {
    const int s = it % kTcStages;
    const uint32_t full = bar_full + 8 * s;
    const uint32_t st = stage0 + s * L::kStage;
    const int kt = kt0 + it * kTile;
    mbar_expect_tx(full, L::kTx);
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      tma_load_4d(st + c * L::kTChunk, &k_map, full, 64 * c, kt, kvh, b);
      tma_load_4d(st + L::kTBytes + c * L::kTChunk, &v_map, full, 64 * c,
                  kt, kvh, b);
    }
  };
  if (tid == 0) {
    mbar_expect_tx(bar_q, 2 * L::kQBytes);
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      tma_load_4d(q_base + c * L::kQChunk, &q_map, bar_q, 64 * c, (int)q0,
                  h, b);
      tma_load_4d(do_base + c * L::kQChunk, &do_map, bar_q, 64 * c,
                  (int)q0, h, b);
    }
    for (int i = 0; i < kTcStages - 1 && i < n_tiles; ++i) load_kv(i);
  }
  __syncwarp();

  // ---- warpgroup wg owns rows q0 + 64 wg .. q0 + 64 wg + 63 ----
  const int wg = __shfl_sync(0xffffffffu, warp >> 2, 0);
  const int r_a = 64 * wg + 16 * (warp & 3) + (lane >> 2);  // and r_a + 8
  const int quad = lane & 3;
  const int64_t row_a = q0 + r_a, row_b = row_a + 8;
  const int64_t pos_a = row_a < s_len ? q_pos[row_a] : 0;
  const int64_t pos_b = row_b < s_len ? q_pos[row_b] : 0;
  // (L log2 e, D) of the two rows; rows past S read (+inf, 0): P = 0
  const float2* rb =
      reinterpret_cast<const float2*>(rows) + ((int64_t)b * hq + h) * s_pad;
  const float2 ra = row_a < s_pad ? rb[row_a] : make_float2(CUDART_INF_F, 0.f);
  const float2 rr = row_b < s_pad ? rb[row_b] : make_float2(CUDART_INF_F, 0.f);
  const float sl2 = scale * kLog2e;
  const uint32_t q_wg = q_base + wg * 64 * kSwizzleRow;
  const uint32_t do_wg = do_base + wg * 64 * kSwizzleRow;

  // the tiles this warpgroup visits, it_first .. it_last, are a run of
  // the block's; it still waits for and releases the others
  const int64_t w_lo = wg ? lo[1] : lo[0], w_hi = wg ? hi[1] : hi[0];
  int it_first = n_tiles, it_last = -1;
  if (w_lo <= w_hi && n_tiles > 0) {
    it_first = (int)((w_lo - kt0) / kTile);
    it_last = (int)((w_hi - kt0) / kTile);
    if (it_last > n_tiles - 1) it_last = n_tiles - 1;
  }
  it_first = __shfl_sync(0xffffffffu, it_first, 0);
  it_last = __shfl_sync(0xffffffffu, it_last, 0);

  float adq[HD_PAD / 2], sc[32], dp[32];
#pragma unroll
  for (int i = 0; i < HD_PAD / 2; ++i) adq[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.0f;

  mbar_wait(bar_q, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % kTcStages;
    if (tid == 0 && it + kTcStages - 1 < n_tiles) {
      // tile it + stages - 1 into the stage tile it - 1 has released
      const int j = it + kTcStages - 1;
      if (it >= 1) {
        mbar_wait(bar_empty + 8 * (j % kTcStages),
                  (uint32_t)(((it - 1) / kTcStages) & 1));
      }
      load_kv(j);
    }
    __syncwarp();
    mbar_wait(bar_full + 8 * s, (uint32_t)((it / kTcStages) & 1));
    if (it >= it_first && it <= it_last) {
      const int64_t kt = kt0 + (int64_t)it * kTile;
      const uint32_t k_s = stage0 + s * L::kStage;
      const uint32_t v_s = k_s + L::kTBytes;

      // S = Q K^T and dP = dO V^T
      fence_regs(sc);
      fence_regs(dp);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < HD_PAD / 16; ++ks) {
        const uint32_t col = (ks % 4) * 32;
        wgmma_ss_n64(sc, desc128(q_wg + (ks / 4) * L::kQChunk + col, 16,
                                 1024),
                     desc128(k_s + (ks / 4) * L::kTChunk + col, 16, 1024),
                     ks > 0);
      }
#pragma unroll
      for (int ks = 0; ks < HD_PAD / 16; ++ks) {
        const uint32_t col = (ks % 4) * 32;
        wgmma_ss_n64(dp, desc128(do_wg + (ks / 4) * L::kQChunk + col, 16,
                                 1024),
                     desc128(v_s + (ks / 4) * L::kTChunk + col, 16, 1024),
                     ks > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);
      fence_regs(dp);

      // sc[i], dp[i]: row r_a (i & 2 == 0) or r_a + 8, key kt + 2 quad +
      // 8 (i / 4) + (i & 1); dS = P (dP - D) in f32
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const float2 r = (i & 2) ? rr : ra;
        dp[i] = exp2f(fmaf(sc[i], sl2, -r.x)) * (dp[i] - r.y);
      }
      // where any lane of the warp meets a masked key, mask by selects
      const bool open = tile_open<kTile>(kt, pos_a, t_len, causal, window) &&
                        tile_open<kTile>(kt, pos_b, t_len, causal, window);
      if (__any_sync(0xffffffffu, !open)) {
        const int64_t k0 = kt + 2 * quad;          // the key of dp[0]
        const int t_rel = clamp_rel(t_len - k0);
        const int far = 1 << 30;
        const int hi_a = causal ? clamp_rel(pos_a - k0) : far;
        const int hi_b = causal ? clamp_rel(pos_b - k0) : far;
        const int lo_a = window > 0 ? clamp_rel(pos_a - window + 1 - k0) : -far;
        const int lo_b = window > 0 ? clamp_rel(pos_b - window + 1 - k0) : -far;
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int c = 8 * (i >> 2) + (i & 1);
          const int hi_r = (i & 2) ? hi_b : hi_a, lo_r = (i & 2) ? lo_b : lo_a;
          const bool ok = c <= hi_r && c >= lo_r && c < t_rel;
          dp[i] = ok ? dp[i] : 0.0f;
        }
      }

      // dQ += dS K, dS rounded to bf16: 16 keys a step, K read MN-major
      uint32_t sa[4][4];
      pack_a(sa, dp);
      fence_regs(adq);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_pv<HD_PAD>(adq, sa[kk],
                         desc128(k_s + kk * 16 * kSwizzleRow, L::kTChunk,
                                 1024));
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(adq);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty + 8 * s);   // this warp is done
  }

  store_rows<HD_PAD>(dq, adq, scale, b, row_a, s_len, h, hq, hd, quad);
}

// ------------------------------------------------------------ f32 route --

constexpr int kF32Threads = 256;           // two warpgroups
constexpr int kF32Block = 64;              // keys (pass 2), rows (pass 3)
constexpr int kF32Keys = 32;               // keys a pass-3 tile: a row of K^T
constexpr int kF32Stages = 2;              // streamed tiles in flight
constexpr int kF32Cols = kSwizzleRow / 4;  // f32 columns in a 128-byte row
constexpr int kWgThreads = 128;

// pass 2: a ring of (Q, dO) tiles of R query rows, each split in place (hi
// where TMA put it, lo beside it), with the rows' (L log2 e, D) pairs;
// then P^T and dS^T, hi and lo, as the B operands of dV^T and dK^T (64
// keys x R rows), and the exchange of P from warpgroup 0 to warpgroup 1
template <int HD_PAD>
struct F32KvLayout {
  static constexpr int kR = HD_PAD == 64 ? 64 : 32;    // query rows a tile
  static constexpr int kGroup = HD_PAD == 64 ? 8 : 4;  // k8 steps a group
  static constexpr int kChunks = HD_PAD / kF32Cols;    // 32-column chunks
  static constexpr int kTChunk = kR * kSwizzleRow;
  static constexpr int kTBytes = kChunks * kTChunk;    // Q or dO, hi or lo
  // a stage: Q, Q lo, dO, dO lo, the rows' pairs (padded to 1 KB)
  static constexpr int kOffRows = 4 * kTBytes;
  static constexpr int kStage = kOffRows + 1024;
  static constexpr int kPChunk = kF32Block * kSwizzleRow;   // 32 rows
  static constexpr int kPBytes = (kR / kF32Cols) * kPChunk;
  static constexpr int kOffP = kF32Stages * kStage;    // P^T hi, lo, dS^T ..
  static constexpr int kOffX = kOffP + 4 * kPBytes;
  static constexpr int kOffBar = kOffX + kWgThreads * (kR / 2) * 4;
  static constexpr uint32_t kTx = 2 * kTBytes + kR * 8;
  static constexpr size_t kBytes = kOffBar + 8 * kF32Stages + 1024;
};

// pass 3: a ring of 32-key (K, V) tiles, K and V split in place with their
// lo beside them, and K^T hi and lo (HD_PAD rows of the tile's 32 keys);
// then the exchange of P and dS between the warpgroups
template <int HD_PAD>
struct F32QLayout {
  static constexpr int kGroup = HD_PAD == 64 ? 8 : 4;
  static constexpr int kChunks = HD_PAD / kF32Cols;
  static constexpr int kTChunk = kF32Keys * kSwizzleRow;     // 4 KB
  static constexpr int kTBytes = kChunks * kTChunk;  // K, V or K^T, hi or lo
  static constexpr int kOffV = 2 * kTBytes;
  static constexpr int kOffKt = 4 * kTBytes;
  static constexpr int kStage = 6 * kTBytes;
  static constexpr int kOffX = kF32Stages * kStage;
  static constexpr int kOffBar = kOffX + kWgThreads * (kF32Keys / 2) * 4;
  static constexpr uint32_t kTx = 2 * kTBytes;
  static constexpr size_t kBytes = kOffBar + 8 * kF32Stages + 1024;
};

// D (64 x 32, f32) += A (64 x 8, tf32 in registers) * B (32 x 8, tf32,
// K-major in shared memory through its descriptor); scale_d = 0 ignores D
__device__ __forceinline__ void wgmma_tf32_rs_n32x(float (&d)[16],
                                                   uint32_t a0, uint32_t a1,
                                                   uint32_t a2, uint32_t a3,
                                                   uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(scale_d));
}

// D (64 x N) (+)= A (64 x 8, the fragments a[0..3]) * B (N x 8), N = 32 or
// 64
template <int N>
__device__ __forceinline__ void wgmma_tf32(float (&d)[N / 2],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int scale_d) {
  if constexpr (N == 64) {
    wgmma_tf32_rs_n64(d, a[0], a[1], a[2], a[3], db, scale_d);
  } else {
    wgmma_tf32_rs_n32x(d, a[0], a[1], a[2], a[3], db, scale_d);
  }
}

// D (64 x N) = A B^T over the head dim, each f32 product as three TF32
// products: A's A-fragments `raw` (as loaded, rows m, head dim k) split here
// group by group, B (N rows of HD_PAD, hi; its lo `lo_off` bytes on) from
// shared memory in 32-column chunks of `chunk` bytes.  One accumulator: the
// sum runs over hd / 8 <= 16 steps.  A group's split fragments stay in
// registers until its products are done, so a group is GROUP steps.
template <int N, int HD_PAD, int GROUP>
__device__ __forceinline__ void split_scores(float (&d)[N / 2],
                                             const float (&raw)[HD_PAD / 2],
                                             uint32_t b_hi, int lo_off,
                                             int chunk) {
  fence_regs(d);
#pragma unroll
  for (int g0 = 0; g0 < HD_PAD / 8; g0 += GROUP) {
    uint32_t hi[GROUP][4], lo[GROUP][4];
#pragma unroll
    for (int j = 0; j < GROUP; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = raw[4 * (g0 + j) + e];
        const float x_hi = tf32_hi(x);
        hi[j][e] = __float_as_uint(x_hi);
        lo[j][e] = __float_as_uint(x - x_hi);
      }
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < GROUP; ++j) {
      const int ks = g0 + j;
      const uint32_t bh = b_hi + (ks / 4) * chunk + (ks % 4) * 32;
      wgmma_tf32<N>(d, hi[j], desc128(bh, 16, 1024), ks > 0);
      wgmma_tf32<N>(d, hi[j], desc128(bh + lo_off, 16, 1024), 1);
      wgmma_tf32<N>(d, lo[j], desc128(bh, 16, 1024), 1);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(d);
  }
}

// A-fragments of a (64 x HD_PAD) operand of a tile, rows m0 + 16 (warp) +
// 8 (e & 1) of the tile, head-dim columns 8 ks + quad + 4 (e >> 1), read
// through strides from global memory; zeros past `len` and past hd
template <int HD_PAD>
__device__ __forceinline__ void load_frags(float (&raw)[HD_PAD / 2],
                                           const float* src, Strides st,
                                           int64_t b, int64_t row_a,
                                           int64_t len, int64_t h,
                                           int64_t hd, int quad) {
#pragma unroll
  for (int ks = 0; ks < HD_PAD / 8; ++ks)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int64_t row = row_a + 8 * (e & 1);
      const int64_t d = 8 * ks + quad + 4 * (e >> 1);
      raw[4 * ks + e] = row < len && d < hd
                            ? __ldg(src + b * st.b + row * st.s + h * st.h + d)
                            : 0.0f;
    }
}

// TileWalk's 64-row query tiles cut into R-row units, in order
template <int R>
struct UnitWalk {
  TileWalk walk;
  int g, sub;
  int64_t qt;

  __device__ __forceinline__ bool next(int& g_out, int64_t& qt_out,
                                       int64_t& q0_out) {
    if (sub + 1 < kTile / R) {
      ++sub;
    } else {
      if (!walk.next(g, qt)) return false;      // and stays so
      sub = 0;
    }
    g_out = g;
    qt_out = qt;
    q0_out = qt * kTile + sub * R;
    return true;
  }
};

// pass 2: dK and dV of 64 keys of one KV head.  Warpgroup 0 computes S^T =
// K Q^T, P^T and dV^T += dO^T P; warpgroup 1 dP^T = V dO^T, dS^T = P^T
// (dP^T - D) and dK^T += Q^T dS.
template <int HD_PAD>
__global__ void __launch_bounds__(kF32Threads, 1)
bwd_dkdv_f32_kernel(const __grid_constant__ CUtensorMap q_map,
                    const __grid_constant__ CUtensorMap do_map,
                    const float* __restrict__ k, const float* __restrict__ v,
                    Strides ks, Strides vs, const float* __restrict__ rows,
                    const int32_t* __restrict__ q_pos,
                    const int32_t* __restrict__ bounds,
                    float* __restrict__ dk, float* __restrict__ dv,
                    int64_t s_len, int64_t t_len, int64_t hq, int64_t hd,
                    int causal, int64_t window, float scale) {
  using L = F32KvLayout<HD_PAD>;
  constexpr int kR = L::kR;
  constexpr int kNS = kR / 2;                // score registers a thread
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t bar_full = base + L::kOffBar;             // [stage]
  float* xchg = reinterpret_cast<float*>(smem_raw + (base + L::kOffX - raw));

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // grid (Kh, B, key blocks): the first key blocks, whose causal bands are
  // the longest, are all launched first
  const int64_t k0 = (int64_t)blockIdx.z * kF32Block;
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int group = (int)(hq / gridDim.x);
  const int64_t n_qt = (s_len + kTile - 1) / kTile;
  const int64_t s_pad = n_qt * kTile;
  const int64_t k_last = (k0 + kF32Block < t_len ? k0 + kF32Block : t_len) - 1;

  if (tid == 0) {
    for (int s = 0; s < kF32Stages; ++s) mbar_init(bar_full + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // thread 0 issues every copy: the (Q, dO, rows) of the it-th unit into
  // stage it % 2, once every thread has passed the split of unit it - 1
  const auto load_stage = [&](int it, int g, int64_t q0) {
    const int s = it % kF32Stages;
    const uint32_t full = bar_full + 8 * s;
    const uint32_t st = base + s * L::kStage;
    const int h = kvh * group + g;
    mbar_expect_tx(full, L::kTx);
#pragma unroll
    for (int c = 0; c < L::kChunks; ++c) {
      tma_load_4d(st + c * L::kTChunk, &q_map, full, kF32Cols * c, (int)q0,
                  h, b);
      tma_load_4d(st + 2 * L::kTBytes + c * L::kTChunk, &do_map, full,
                  kF32Cols * c, (int)q0, h, b);
    }
    bulk_load(st + L::kOffRows,
              rows + (((int64_t)b * hq + h) * s_pad + q0) * 2, kR * 8, full);
  };
  UnitWalk<kR> walk{{bounds, n_qt, k0, k_last, t_len, window, group, causal,
                     0, -32, 0u}, 0, kTile / kR - 1, 0};
  UnitWalk<kR> ahead = walk;          // the producer's, one unit on
  if (warp == 0) {
    int g;
    int64_t qt, q0;
    if (ahead.next(g, qt, q0) && lane == 0) load_stage(0, g, q0);
    __syncwarp();
  }

  const int wg = __shfl_sync(0xffffffffu, warp >> 2, 0);
  const int wt = tid & (kWgThreads - 1);
  const int quad = lane & 3;
  const int m0 = 16 * (warp & 3) + (lane >> 2);   // accumulator rows m0, +8
  const int64_t key_a = k0 + m0;
  const int64_t kwarp = k0 + 16 * (warp & 3);     // this warp's 16 keys
  const float sl2 = scale * kLog2e;
  // the A operand of the scores, as loaded: K (warpgroup 0) or V (1)
  float araw[HD_PAD / 2];
  load_frags<HD_PAD>(araw, wg ? v : k, wg ? vs : ks, b, key_a, t_len, kvh,
                     hd, quad);
  // B of this warpgroup's product: P^T (0) or dS^T (1), hi then lo
  const uint32_t pb = base + L::kOffP + wg * 2 * L::kPBytes;

  float acc[HD_PAD / 2], sc[kNS], t[32];
#pragma unroll
  for (int i = 0; i < HD_PAD / 2; ++i) acc[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < kNS; ++i) sc[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < 32; ++i) t[i] = 0.0f;

  for (int it = 0;; ++it) {
    int g;
    int64_t qt, q0;
    if (!walk.next(g, qt, q0)) break;
    const int s = it % kF32Stages;
    const uint32_t st = base + s * L::kStage;
    mbar_wait(bar_full + 8 * s, (uint32_t)((it / kF32Stages) & 1));

    // split Q and dO, shared by both warpgroups: hi in place, lo kTBytes on
#pragma unroll
    for (int i = tid; i < L::kTBytes / 16; i += kF32Threads) {
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const uint32_t a = st + x * 2 * L::kTBytes + 16 * i;
        const float4 y = lds_f32x4(a);
        const float4 y_hi = tf32_hi4(y);
        sts_f32x4(a, y_hi);
        sts_f32x4(a + L::kTBytes, sub4(y, y_hi));
      }
    }
    fence_proxy_async();
    __syncthreads();
    if (warp == 0) {
      int g2;
      int64_t qt2, q2;
      if (ahead.next(g2, qt2, q2) && lane == 0) load_stage(it + 1, g2, q2);
      __syncwarp();
    }

    // S^T = K Q^T (warpgroup 0), dP^T = V dO^T (1): sc[i] is key key_a
    // (i & 2 == 0) or key_a + 8, query row q0 + c, c = 8 (i / 4) + 2 quad +
    // (i & 1)
    split_scores<kR, HD_PAD, L::kGroup>(sc, araw, st + wg * 2 * L::kTBytes,
                                        L::kTBytes, L::kTChunk);
    // rows_s holds rows c, c + 1 of column pair i / 4 as one float4 (L log2
    // e, D, L log2 e, D)
    const float4* rw =
        reinterpret_cast<const float4*>(smem_raw + (st + L::kOffRows - raw));
    if (wg == 0) {
#pragma unroll
      for (int j = 0; j < kR / 8; ++j) {
        const float4 x = rw[4 * j + quad];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e;
          sc[i] = exp2f(fmaf(sc[i], sl2, (e & 1) ? -x.z : -x.x));
        }
      }
      // Where a key of this warp lies past the tile's band edge, mask by
      // selects (a masked p may be inf: it is replaced, not multiplied).
      // Rows past S have P = 0 already; keys past T are never stored.
      const int32_t pmin = bounds[2 * qt], pmax = bounds[2 * qt + 1];
      const bool open = (!causal || kwarp + 15 <= pmin) &&
                        (window <= 0 || kwarp > pmax - window);
      if (!open) {                                     // warp-uniform
#pragma unroll
        for (int i = 0; i < kNS; ++i) {
          const int64_t row = q0 + 8 * (i >> 2) + 2 * quad + (i & 1);
          const int64_t pos = row < s_len ? q_pos[row] : 0;
          const int64_t key = key_a + ((i & 2) ? 8 : 0);
          const bool ok = (!causal || key <= pos) &&
                          (window <= 0 || key > pos - window);
          sc[i] = ok ? sc[i] : 0.0f;
        }
      }
#pragma unroll
      for (int i = 0; i < kNS; ++i) xchg[i * kWgThreads + wt] = sc[i];
      bar_arrive<1, kF32Threads>();                      // P is there
    } else {
      bar_sync<1, kF32Threads>();
#pragma unroll
      for (int j = 0; j < kR / 8; ++j) {
        const float4 x = rw[4 * j + quad];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e;
          sc[i] = xchg[i * kWgThreads + wt] *
                  (sc[i] - ((e & 1) ? x.w : x.y));
        }
      }
    }
    // this warpgroup's P^T or dS^T, split, as a B operand: rows of 64
    // keys, 32 query rows (128 bytes) a chunk
#pragma unroll
    for (int j = 0; j < kR / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        const int i = 4 * j + e;
        const int c = 8 * j + 2 * quad;
        const uint32_t a = pb + (c / kF32Cols) * L::kPChunk +
                           swz_f32(m0 + 4 * e, c % kF32Cols);
        const float h0 = tf32_hi(sc[i]), h1 = tf32_hi(sc[i + 1]);
        sts_f32x2(a, h0, h1);
        sts_f32x2(a + L::kPBytes, sc[i] - h0, sc[i + 1] - h1);
      }
    fence_proxy_async();
    if (wg == 0) {                         // this warpgroup's writes done
      bar_sync<2, kWgThreads>();
    } else {
      bar_sync<3, kWgThreads>();
    }

    // dV^T += dO^T P (warpgroup 0), dK^T += Q^T dS (1): 64 head-dim rows
    // a block, K the tile's rows; A gathered from the other operand's hi
    // and lo, each block and tile into a fresh accumulator, added in f32
    const uint32_t as = st + (1 - wg) * 2 * L::kTBytes;
#pragma unroll
    for (int mb = 0; mb < HD_PAD / 64; ++mb) {
      uint32_t ahi[kR / 8][4], alo[kR / 8][4];
#pragma unroll
      for (int kk = 0; kk < kR / 8; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int d = 64 * mb + m0 + 8 * (e & 1);
          const int r = 8 * kk + quad + 4 * (e >> 1);
          const uint32_t a = as + (d / kF32Cols) * L::kTChunk +
                             swz_f32(r, d % kF32Cols);
          ahi[kk][e] = __float_as_uint(lds_f32(a));
          alo[kk][e] = __float_as_uint(lds_f32(a + L::kTBytes));
        }
      fence_regs(t);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kR / 8; ++kk) {
        const uint32_t bh = pb + (kk / 4) * L::kPChunk + (kk % 4) * 32;
        wgmma_tf32<64>(t, ahi[kk], desc128(bh, 16, 1024), kk > 0);
        wgmma_tf32<64>(t, ahi[kk], desc128(bh + L::kPBytes, 16, 1024), 1);
        wgmma_tf32<64>(t, alo[kk], desc128(bh, 16, 1024), 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(t);
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[32 * mb + i] += t[i];
    }
  }

  // acc[32 mb + i]: head dim 64 mb + m0 (i & 2 == 0) or + 8, key k0 + 8 (i
  // / 4) + 2 quad + (i & 1); dK times the scale
  float* out = wg ? dk : dv;
  const float mul = wg ? scale : 1.0f;
  const int64_t kh = gridDim.x;
#pragma unroll
  for (int mb = 0; mb < HD_PAD / 64; ++mb)
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int64_t d = 64 * mb + m0 + ((i & 2) ? 8 : 0);
      const int64_t key = k0 + 8 * (i >> 2) + 2 * quad + (i & 1);
      if (d < hd && key < t_len) {
        out[((b * t_len + key) * kh + kvh) * hd + d] = acc[32 * mb + i] * mul;
      }
    }
}

// pass 3: dQ of 64 query rows of one head.  Warpgroup 0 computes S = Q K^T
// and P, warpgroup 1 dP = dO V^T and dS = P (dP - D); each then takes half
// the head dim of dQ += dS K.
template <int HD_PAD>
__global__ void __launch_bounds__(kF32Threads, 1)
bwd_dq_f32_kernel(const __grid_constant__ CUtensorMap k_map,
                  const __grid_constant__ CUtensorMap v_map,
                  const float* __restrict__ q, const float* __restrict__ dout,
                  Strides qs, Strides ds, const float* __restrict__ rows,
                  const int32_t* __restrict__ q_pos,
                  const int32_t* __restrict__ bounds,
                  float* __restrict__ dq, int64_t s_len, int64_t t_len,
                  int64_t group, int64_t hd, int causal, int64_t window,
                  float scale) {
  using L = F32QLayout<HD_PAD>;
  constexpr int kNS = kF32Keys / 2;          // score registers a thread
  constexpr int kNH = HD_PAD / 2;            // dQ columns a warpgroup
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t bar_full = base + L::kOffBar;             // [stage]
  float* xchg = reinterpret_cast<float*>(smem_raw + (base + L::kOffX - raw));

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int64_t n_qt = (s_len + kTile - 1) / kTile;
  const int64_t s_pad = n_qt * kTile;
  // grid (Hq, B, query tiles): the last query tiles, whose causal bands
  // are the longest, are all launched first
  const int64_t qt = n_qt - 1 - (int64_t)blockIdx.z;
  const int64_t q0 = qt * kTile;
  const int h = blockIdx.x, b = blockIdx.y;
  const int kvh = h / (int)group;
  const int64_t hq = gridDim.x;

  if (tid == 0) {
    for (int s = 0; s < kF32Stages; ++s) mbar_init(bar_full + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  int64_t lo, hi;
  key_band(bounds[2 * qt], bounds[2 * qt + 1], t_len, causal, window, lo,
           hi);
  const int kt0 = __shfl_sync(
      0xffffffffu, (int)(lo <= hi ? lo / kF32Keys * kF32Keys : 0), 0);
  const int n_tiles = __shfl_sync(
      0xffffffffu, (int)(lo <= hi ? (hi - kt0) / kF32Keys + 1 : 0), 0);

  // thread 0 issues every copy: the K and V of key tile it into stage it %
  // 2, once every thread has passed the split of tile it - 1
  const auto load_kv = [&](int it) {
    const int s = it % kF32Stages;
    const uint32_t full = bar_full + 8 * s;
    const uint32_t st = base + s * L::kStage;
    const int kt = kt0 + it * kF32Keys;
    mbar_expect_tx(full, L::kTx);
#pragma unroll
    for (int c = 0; c < L::kChunks; ++c) {
      tma_load_4d(st + c * L::kTChunk, &k_map, full, kF32Cols * c, kt, kvh,
                  b);
      tma_load_4d(st + L::kOffV + c * L::kTChunk, &v_map, full, kF32Cols * c,
                  kt, kvh, b);
    }
  };
  if (tid == 0 && n_tiles > 0) load_kv(0);

  const int wg = __shfl_sync(0xffffffffu, warp >> 2, 0);
  const int wt = tid & (kWgThreads - 1);
  const int quad = lane & 3;
  const int m0 = 16 * (warp & 3) + (lane >> 2);   // rows q0 + m0, + 8
  const int64_t row_a = q0 + m0, row_b = row_a + 8;
  const int64_t pos_a = row_a < s_len ? q_pos[row_a] : 0;
  const int64_t pos_b = row_b < s_len ? q_pos[row_b] : 0;
  // (L log2 e, D) of the two rows; rows past S read (+inf, 0): P = 0
  const float2* rb =
      reinterpret_cast<const float2*>(rows) + ((int64_t)b * hq + h) * s_pad;
  const float2 ra = rb[row_a], rr = rb[row_b];
  const float sl2 = scale * kLog2e;
  // the A operand of the scores, as loaded: Q (warpgroup 0) or dO (1)
  float araw[HD_PAD / 2];
  load_frags<HD_PAD>(araw, wg ? dout : q, wg ? ds : qs, b, row_a, s_len, h,
                     hd, quad);

  float acc[kNH / 2], t[kNH / 2], sc[kNS];
#pragma unroll
  for (int i = 0; i < kNH / 2; ++i) acc[i] = t[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < kNS; ++i) sc[i] = 0.0f;

  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % kF32Stages;
    const uint32_t st = base + s * L::kStage;
    mbar_wait(bar_full + 8 * s, (uint32_t)((it / kF32Stages) & 1));

    // Split the tile, shared by both warpgroups: K and V hi in place, lo
    // kTBytes on; K^T hi and lo (HD_PAD rows of 32 keys, the order 0 2 4 6
    // 1 3 5 7 within each 8 of the A fragments of dS).  16-byte unit u of
    // row d of K^T holds keys 8 (u / 2) + (u & 1) + 2 w, w = 0..3, read at
    // one d and rounded in place by the thread that transposes them, so
    // no element is read after another thread rounded it.
#pragma unroll
    for (int m = 0; m < HD_PAD * 8 / kF32Threads; ++m) {
      const int i = tid + m * kF32Threads;
      const int d = i % HD_PAD, u = i / HD_PAD;
      const int key0 = 8 * (u >> 1) + (u & 1);
      const uint32_t src = st + (d / kF32Cols) * L::kTChunk;
      float x[4], x_hi[4];
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const uint32_t a = src + swz_f32(key0 + 2 * w, d % kF32Cols);
        x[w] = lds_f32(a);
        x_hi[w] = tf32_hi(x[w]);
        sts_f32(a, x_hi[w]);
        sts_f32(a + L::kTBytes, x[w] - x_hi[w]);
      }
      const uint32_t dst = st + L::kOffKt + swz_f32(d, 4 * u);
      sts_f32x4(dst, make_float4(x_hi[0], x_hi[1], x_hi[2], x_hi[3]));
      sts_f32x4(dst + L::kTBytes,
                make_float4(x[0] - x_hi[0], x[1] - x_hi[1], x[2] - x_hi[2],
                            x[3] - x_hi[3]));
    }
#pragma unroll
    for (int i = tid; i < L::kTBytes / 16; i += kF32Threads) {
      const uint32_t a = st + L::kOffV + 16 * i;
      const float4 y = lds_f32x4(a);
      const float4 y_hi = tf32_hi4(y);
      sts_f32x4(a, y_hi);
      sts_f32x4(a + L::kTBytes, sub4(y, y_hi));
    }
    fence_proxy_async();
    __syncthreads();
    if (tid == 0 && it + 1 < n_tiles) load_kv(it + 1);

    // S = Q K^T (warpgroup 0), dP = dO V^T (1): sc[i] is row row_a (i & 2
    // == 0) or row_b, key kt + 8 (i / 4) + 2 quad + (i & 1)
    split_scores<kF32Keys, HD_PAD, L::kGroup>(sc, araw, st + wg * L::kOffV,
                                              L::kTBytes, L::kTChunk);
    if (wg == 0) {
      const int64_t kt = kt0 + (int64_t)it * kF32Keys;
#pragma unroll
      for (int i = 0; i < kNS; ++i) {
        sc[i] = exp2f(fmaf(sc[i], sl2, (i & 2) ? -rr.x : -ra.x));
      }
      // where any lane of the warp meets a masked key, mask by selects
      const bool open =
          tile_open<kF32Keys>(kt, pos_a, t_len, causal, window) &&
          tile_open<kF32Keys>(kt, pos_b, t_len, causal, window);
      if (__any_sync(0xffffffffu, !open)) {
        const int64_t k0 = kt + 2 * quad;          // the key of sc[0]
        const int t_rel = clamp_rel(t_len - k0);
        const int far = 1 << 30;
        const int hi_a = causal ? clamp_rel(pos_a - k0) : far;
        const int hi_b = causal ? clamp_rel(pos_b - k0) : far;
        const int lo_a = window > 0 ? clamp_rel(pos_a - window + 1 - k0) : -far;
        const int lo_b = window > 0 ? clamp_rel(pos_b - window + 1 - k0) : -far;
#pragma unroll
        for (int i = 0; i < kNS; ++i) {
          const int c = 8 * (i >> 2) + (i & 1);
          const int hi_r = (i & 2) ? hi_b : hi_a, lo_r = (i & 2) ? lo_b : lo_a;
          const bool ok = c <= hi_r && c >= lo_r && c < t_rel;
          sc[i] = ok ? sc[i] : 0.0f;
        }
      }
#pragma unroll
      for (int i = 0; i < kNS; ++i) xchg[i * kWgThreads + wt] = sc[i];
      bar_arrive<1, kF32Threads>();                      // P is there
      bar_sync<2, kF32Threads>();                        // dS is there
#pragma unroll
      for (int i = 0; i < kNS; ++i) sc[i] = xchg[i * kWgThreads + wt];
    } else {
      bar_sync<1, kF32Threads>();
#pragma unroll
      for (int i = 0; i < kNS; ++i) {
        sc[i] = xchg[i * kWgThreads + wt] *
                (sc[i] - ((i & 2) ? rr.y : ra.y));
        xchg[i * kWgThreads + wt] = sc[i];
      }
      bar_arrive<2, kF32Threads>();
    }

    // dQ += dS K over this warpgroup's half of the head dim: A = dS split
    // in registers (column c of a k8 step is key 2c, c < 4, or 2 (c - 4) +
    // 1: the order of K^T's keys), B = K^T's rows, into a fresh
    // accumulator added in f32
    uint32_t shi[4][4], slo[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = sc[4 * j + ((e & 1) << 1) + (e >> 1)];
        const float x_hi = tf32_hi(x);
        shi[j][e] = __float_as_uint(x_hi);
        slo[j][e] = __float_as_uint(x - x_hi);
      }
    const uint32_t kth = st + L::kOffKt + wg * kNH * kSwizzleRow;
    fence_regs(t);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kF32Keys / 8; ++j) {
      wgmma_tf32<kNH>(t, shi[j], desc128(kth + 32 * j, 16, 1024), j > 0);
      wgmma_tf32<kNH>(t, shi[j], desc128(kth + L::kTBytes + 32 * j, 16, 1024),
                      1);
      wgmma_tf32<kNH>(t, slo[j], desc128(kth + 32 * j, 16, 1024), 1);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(t);
#pragma unroll
    for (int i = 0; i < kNH / 2; ++i) acc[i] += t[i];
  }

  // acc[i]: row row_a (i & 2 == 0) or row_b, head dim wg kNH + 8 (i / 4) +
  // 2 quad + (i & 1); times the scale
#pragma unroll
  for (int i = 0; i < kNH / 2; ++i) {
    const int64_t row = (i & 2) ? row_b : row_a;
    const int64_t d = wg * kNH + 8 * (i >> 2) + 2 * quad + (i & 1);
    if (row < s_len && d < hd) {
      dq[((b * s_len + row) * hq + h) * hd + d] = acc[i] * scale;
    }
  }
}

// ------------------------------------------- f32 route, 128 < hd <= 256 --
//
// The same three kernels and split-TF32 arithmetic at hd padded to 256
// (pass 1 is `bwd_rows_kernel<float>` itself).  At this width a 64-key
// block's dK and dV are 128 registers a thread over 256 threads, and the
// A operand of its scores (K or V as loaded, hd / 2 a thread) would be
// another 128: the narrow kernels' layouts do not fit.  So the operand a
// block holds for its whole walk (K and V in pass 2, Q and dO in pass 3)
// stays in shared memory as loaded (64 rows x 256 f32, 64 KB each), and
// each warpgroup reads its A fragments from there 4 k8 steps at a time and
// splits them in registers (the next 4 while the tensor core takes these:
// two sets of 32 registers); the streamed operand comes in tiles
// of 16 rows (pass 2: query rows of Q and dO; pass 3: keys of K and V),
// split in place (its lo in the chunk's rows 0..15, its hi, where TMA put
// it, in rows 16..31), one tile in flight.  Per tile a warpgroup runs
//   the scores (S^T = K Q^T or dP^T = V dO^T in pass 2, S = Q K^T or dP =
//   dO V^T in pass 3): per k8 step an n32 product A_hi [B_lo | B_hi]^T
//   (its columns 0..15 A_hi B_lo^T, 16..31 A_hi B_hi^T) and an n16
//   product A_lo B_hi^T into the former; the two halves meet in one f32
//   add (the narrow route's short sums: 32 k8 steps an accumulator);
// then, as the narrow kernels, warpgroup 0 makes P, warpgroup 1 dS from
// it, and the outputs' products follow:
//   pass 2: dV^T += dO^T P (warpgroup 0), dK^T += Q^T dS (1): M = hd in
//   blocks of 64, N = the 64 keys, K = the tile's 16 rows; A gathered from
//   the split tile, B = P^T or dS^T split into one 128-byte row a key (hi
//   in bytes 0..63, lo in 64..127); each warpgroup owns all 256 rows of
//   its output, 128 registers a thread;
//   pass 3: dQ^T += K^T dS^T, each warpgroup 128 rows of hd (M), N = the
//   block's 64 query rows, K = the tile's 16 keys: A gathered from the
//   split K tile, B = dS split as above (a row a query row), so no
//   transposed copy of K is made.
// Products: pass 2 4 and pass 3 3 of the five (S and dP twice, as the
// narrow route), each as three TF32 products; none is computed twice more
// for the width.  Each tile's output product goes into a fresh
// accumulator added in f32.  Shared memory: pass 2 K and V 128 KB, the Q
// and dO tile split 64 KB, P^T and dS^T 16 KB, the P hand-over 4 KB: 213
// KB; pass 3 Q and dO 128 KB, the K and V tile split 64 KB, dS 8 KB, the
// hand-over 4 KB: 205 KB.  So the streamed tiles are 16 wide, and the
// scores' products are n32 and n16: the tensor core takes them at a
// fraction of its n64 rate (on the H100 the scores are a third of pass
// 2's time and two fifths of pass 3's, `scripts/
// torch_flash_wide_ablate.py`), which is most of what holds these kernels
// above their bound.  Pass 2 runs one block a query head, not a KV head
// (grid (Hq, B, key blocks)): with G > 1 each block writes its head's
// share of dK and dV to a (2, B, T, Hq, hd) scratch, and
// `bwd_group_sum_kernel` adds the G shares in head order (one writer an
// element: still bitwise repeatable).  A block by KV head would walk
// every query row of its group: at the federated LM's layer (G = 2) the
// first key blocks' walk, the pass's longest, is halved so, and the grid
// doubled to 256 blocks.  What bounds the backward: operations (3 x 10 hd
// flops a pair, 0.260 ms at that layer).
constexpr int kWideUnit = 16;           // rows (pass 2) or keys (pass 3)
constexpr int kWideHd = 256;
constexpr int kWideChunks = kWideHd / kF32Cols;          // 8
constexpr int kWideRaw = kF32Block * kSwizzleRow;        // 8 KB a chunk
constexpr int kWideSplit = 2 * kWideUnit * kSwizzleRow;  // 4 KB a chunk
constexpr int kWideHi = kWideUnit * kSwizzleRow;         // 2 KB: hi rows
constexpr int kWideGroup = 4;           // k8 steps a group of the scores

// D (64 x 16, f32) += A (64 x 8, tf32 in registers) * B (16 x 8, tf32,
// K-major in shared memory); D is d[0..7], the columns 0..15 of an n32
// accumulator; scale_d = 0 ignores D
__device__ __forceinline__ void wgmma_tf32_rs_n16(float (&d)[16], uint32_t a0,
                                                  uint32_t a1, uint32_t a2,
                                                  uint32_t a3, uint64_t db,
                                                  int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1;"
      "\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(scale_d));
}

// The scores of a 64-row operand A (as loaded in shared memory at `a_raw`:
// 8 KB chunks of 32 columns; this thread's rows m0, m0 + 8) against a
// split 16-row tile B (4 KB chunks at `b_split`) over hd 256: sc[i] for i
// < 8 is the score of row m0 (i & 2 == 0) or m0 + 8 and the tile's row 8 (i
// / 4) + 2 quad + (i & 1).  Each k8 step: A_hi [B_lo | B_hi]^T (n32),
// A_lo B_hi^T (n16) into the first half; one accumulator over the 32
// steps, whose halves meet in an f32 add.  A's fragments are read and split
// kG k8 steps at a time into one of two register sets, the next group's
// while the tensor core takes this one (at most one group left pending).
template <int kG>
__device__ __forceinline__ void wide_scores(float (&sc)[16], uint32_t a_raw,
                                            uint32_t b_split, int m0,
                                            int quad) {
  constexpr int kGroups = kWideHd / 8 / kG;
  opaque(a_raw);
  opaque(b_split);
  uint32_t fh[2][kG][4], fl[2][kG][4];
  const auto prep = [&](int set, int g0) {
#pragma unroll
    for (int j = 0; j < kG; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * (g0 + j) + quad + 4 * (e >> 1);
        const float x = lds_f32(a_raw + (col / kF32Cols) * kWideRaw +
                                swz_f32(m0 + 8 * (e & 1), col % kF32Cols));
        const float x_hi = tf32_hi(x);
        fh[set][j][e] = __float_as_uint(x_hi);
        fl[set][j][e] = __float_as_uint(x - x_hi);
      }
  };
  const auto issue = [&](int set, int g0) {
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kG; ++j) {
      const int ks = g0 + j;
      const uint32_t bc = b_split + (ks / 4) * kWideSplit + (ks % 4) * 32;
      wgmma_tf32_rs_n32x(sc, fh[set][j][0], fh[set][j][1], fh[set][j][2],
                         fh[set][j][3], desc128(bc, 16, 1024), ks > 0);
      wgmma_tf32_rs_n16(sc, fl[set][j][0], fl[set][j][1], fl[set][j][2],
                        fl[set][j][3], desc128(bc + kWideHi, 16, 1024), 1);
    }
    wgmma_commit();
  };
  // a set's registers stay live (not reused) until its products are done
  const auto hold = [&](int set) {
#pragma unroll
    for (int j = 0; j < kG; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        asm volatile("" : "+r"(fh[set][j][e]), "+r"(fl[set][j][e]));
      }
  };
  fence_regs(sc);
  prep(0, 0);
  issue(0, 0);
#pragma unroll
  for (int g = 1; g < kGroups; ++g) {
    prep(g & 1, kG * g);
    issue(g & 1, kG * g);
    wgmma_wait<1>();                               // group g - 1 is done
    hold((g - 1) & 1);
  }
  wgmma_wait<0>();
  hold((kGroups - 1) & 1);
  fence_regs(sc);
#pragma unroll
  for (int i = 0; i < 8; ++i) sc[i] += sc[i + 8];
}

// Split a 16-row tile in place, both warpgroups: of each of the two
// tensors' 8 chunks (the second `stride` bytes on), the hi rows 16..31 (as
// TMA put them) rounded to TF32 and their lo written to rows 0..15 (the
// same swizzle: 2 KB on)
__device__ __forceinline__ void wide_split(uint32_t t0, int stride, int tid) {
#pragma unroll
  for (int u = tid; u < 2 * kWideChunks * (kWideHi / 16); u += kF32Threads) {
    const int x = u / (kWideChunks * (kWideHi / 16));
    const int r = u % (kWideChunks * (kWideHi / 16));
    const uint32_t a = t0 + x * stride + (r / (kWideHi / 16)) * kWideSplit +
                       kWideHi + 16 * (r % (kWideHi / 16));
    const float4 y = lds_f32x4(a);
    const float4 y_hi = tf32_hi4(y);
    sts_f32x4(a, y_hi);
    sts_f32x4(a - kWideHi, sub4(y, y_hi));
  }
}

// One 64-row block of an output's transposed product, X^T Y over a
// 16-row tile: A = X^T's fragments (M = head-dim rows d0 + m0, + 8; K =
// the tile's rows) gathered from the split tile at `x_split`, B = Y split
// in one 128-byte row an N row (hi bytes 0..63, lo 64..127) at `y_rows`;
// three TF32 products a step into a fresh accumulator, added to acc[a0
// ..].
template <int N>
__device__ __forceinline__ void wide_out_block(float (&acc)[N], int a0,
                                               uint32_t x_split,
                                               uint32_t y_rows, int d0,
                                               int m0, int quad) {
  opaque(x_split);
  opaque(y_rows);
  uint32_t ahi[2][4], alo[2][4];
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = d0 + m0 + 8 * (e & 1);
      const int r = 8 * kk + quad + 4 * (e >> 1);
      const uint32_t a = x_split + (d / kF32Cols) * kWideSplit +
                         swz_f32(r, d % kF32Cols);
      alo[kk][e] = __float_as_uint(lds_f32(a));
      ahi[kk][e] = __float_as_uint(lds_f32(a + kWideHi));
    }
  float t[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) t[i] = 0.0f;
  fence_regs(t);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    wgmma_tf32<64>(t, ahi[kk], desc128(y_rows + 32 * kk, 16, 1024), kk > 0);
    wgmma_tf32<64>(t, ahi[kk], desc128(y_rows + 64 + 32 * kk, 16, 1024), 1);
    wgmma_tf32<64>(t, alo[kk], desc128(y_rows + 32 * kk, 16, 1024), 1);
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(t);
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[a0 + i] += t[i];
}

// Write an (N row, 16) operand from score registers sc[0..7] (N row m0 (i
// & 2 == 0) or m0 + 8, column 8 (i / 4) + 2 quad + (i & 1)) split into its
// 128-byte rows at `rows` (hi at columns 0..15, lo at 16..31)
__device__ __forceinline__ void wide_put_rows(uint32_t rows,
                                              const float (&sc)[16], int m0,
                                              int quad) {
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; e += 2) {
      const int i = 4 * j + e, c = 8 * j + 2 * quad, r = m0 + 4 * e;
      const float h0 = tf32_hi(sc[i]), h1 = tf32_hi(sc[i + 1]);
      sts_f32x2(rows + swz_f32(r, c), h0, h1);
      sts_f32x2(rows + swz_f32(r, 16 + c), sc[i] - h0, sc[i + 1] - h1);
    }
}

struct F32WideKvLayout {
  static constexpr int kOffV = kWideChunks * kWideRaw;       // 64 KB
  static constexpr int kOffQ = 2 * kOffV;                    // the tile
  static constexpr int kOffDo = kOffQ + kWideChunks * kWideSplit;
  static constexpr int kOffRows = kOffDo + kWideChunks * kWideSplit;
  static constexpr int kOffP = kOffRows + 1024;             // P^T, dS^T
  static constexpr int kOffDs = kOffP + kF32Block * kSwizzleRow;
  static constexpr int kOffX = kOffDs + kF32Block * kSwizzleRow;
  static constexpr int kOffBar = kOffX + kWgThreads * (kWideUnit / 2) * 4;
  static constexpr uint32_t kKvTx = 2 * kWideChunks * kWideRaw;
  static constexpr uint32_t kTx = 2 * kWideChunks * kWideHi + kWideUnit * 8;
  static constexpr size_t kBytes = kOffBar + 16 + 1024;
};

// pass 2 at hd 256: one query head's share of dK and dV of 64 keys of its
// KV head, into (B, T, Hq, hd) (dK and dV themselves when G = 1; else
// `bwd_group_sum_kernel` sums the G heads' shares in order).  Warpgroup 0
// computes S^T = K Q^T, P^T and dV^T += dO^T P; warpgroup 1 dP^T = V
// dO^T, dS^T = P^T (dP^T - D) and dK^T += Q^T dS.
__global__ void __launch_bounds__(kF32Threads, 1)
bwd_dkdv_f32_wide_kernel(const __grid_constant__ CUtensorMap q_map,
                         const __grid_constant__ CUtensorMap do_map,
                         const __grid_constant__ CUtensorMap k_map,
                         const __grid_constant__ CUtensorMap v_map,
                         const float* __restrict__ rows,
                         const int32_t* __restrict__ q_pos,
                         const int32_t* __restrict__ bounds,
                         float* __restrict__ dk, float* __restrict__ dv,
                         int64_t s_len, int64_t t_len, int64_t group,
                         int64_t hd, int causal, int64_t window,
                         float scale) {
  using L = F32WideKvLayout;
  constexpr int kNS = kWideUnit / 2;         // score registers a thread
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t bar_kv = base + L::kOffBar, bar_full = bar_kv + 8;
  float* xchg = reinterpret_cast<float*>(smem_raw + (base + L::kOffX - raw));

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // grid (Hq, B, key blocks): the first key blocks, whose causal bands are
  // the longest, are all launched first
  const int64_t k0 = (int64_t)blockIdx.z * kF32Block;
  const int h = blockIdx.x, b = blockIdx.y;
  const int kvh = h / (int)group;
  const int64_t hq = gridDim.x;
  const int64_t n_qt = (s_len + kTile - 1) / kTile;
  const int64_t s_pad = n_qt * kTile;
  const int64_t k_last = (k0 + kF32Block < t_len ? k0 + kF32Block : t_len) - 1;

  if (tid == 0) {
    mbar_init(bar_kv, 1);
    mbar_init(bar_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // thread 0 issues every copy: K and V once, then the (Q, dO, rows) of
  // the it-th unit once every thread is done with unit it - 1
  const auto load_unit = [&](int64_t q0) {
    mbar_expect_tx(bar_full, L::kTx);
#pragma unroll
    for (int c = 0; c < kWideChunks; ++c) {
      tma_load_4d(base + L::kOffQ + c * kWideSplit + kWideHi, &q_map,
                  bar_full, kF32Cols * c, (int)q0, h, b);
      tma_load_4d(base + L::kOffDo + c * kWideSplit + kWideHi, &do_map,
                  bar_full, kF32Cols * c, (int)q0, h, b);
    }
    bulk_load(base + L::kOffRows,
              rows + (((int64_t)b * hq + h) * s_pad + q0) * 2,
              kWideUnit * 8, bar_full);
  };
  // one walk, stepped by every thread: with one unit in flight, the next
  // unit to load is the next to compute
  UnitWalk<kWideUnit> walk{{bounds, n_qt, k0, k_last, t_len, window, 1,
                            causal, 0, -32, 0u}, 0, kTile / kWideUnit - 1, 0};
  int g;
  int64_t qt, q0;
  bool more = walk.next(g, qt, q0);
  if (tid == 0) {
    mbar_expect_tx(bar_kv, L::kKvTx);
#pragma unroll
    for (int c = 0; c < kWideChunks; ++c) {
      tma_load_4d(base + c * kWideRaw, &k_map, bar_kv, kF32Cols * c,
                  (int)k0, kvh, b);
      tma_load_4d(base + L::kOffV + c * kWideRaw, &v_map, bar_kv,
                  kF32Cols * c, (int)k0, kvh, b);
    }
  }
  if (tid == 0 && more) load_unit(q0);

  const int wg = __shfl_sync(0xffffffffu, warp >> 2, 0);
  const int wt = tid & (kWgThreads - 1);
  const int quad = lane & 3;
  const int m0 = 16 * (warp & 3) + (lane >> 2);   // keys k0 + m0, + 8
  const int64_t key_a = k0 + m0;
  const int64_t kwarp = k0 + 16 * (warp & 3);     // this warp's 16 keys
  const float sl2 = scale * kLog2e;
  // A of the scores (K or V as loaded), B (Q or dO split), this
  // warpgroup's output's A (dO or Q split) and B (P^T or dS^T)
  const uint32_t a_raw = base + (wg ? L::kOffV : 0);
  const uint32_t b_split = base + (wg ? L::kOffDo : L::kOffQ);
  const uint32_t x_split = base + (wg ? L::kOffQ : L::kOffDo);
  const uint32_t y_rows = base + (wg ? L::kOffDs : L::kOffP);

  float acc[kWideHd / 2], sc[16];
#pragma unroll
  for (int i = 0; i < kWideHd / 2; ++i) acc[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < 16; ++i) sc[i] = 0.0f;

  mbar_wait(bar_kv, 0);
  for (int it = 0; more; ++it) {
    mbar_wait(bar_full, (uint32_t)(it & 1));
    wide_split(base + L::kOffQ, L::kOffDo - L::kOffQ, tid);
    fence_proxy_async();
    __syncthreads();

    // S^T (warpgroup 0), dP^T (1): sc[i] is key key_a (i & 2 == 0) or
    // key_a + 8, query row q0 + c, c = 8 (i / 4) + 2 quad + (i & 1)
    wide_scores<kWideGroup>(sc, a_raw, b_split, m0, quad);
    // the rows' (L log2 e, D): rows c, c + 1 of column pair i / 4
    const float4* rw = reinterpret_cast<const float4*>(
        smem_raw + (base + L::kOffRows - raw));
    if (wg == 0) {
#pragma unroll
      for (int j = 0; j < kNS / 4; ++j) {
        const float4 x = rw[4 * j + quad];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e;
          sc[i] = exp2f(fmaf(sc[i], sl2, (e & 1) ? -x.z : -x.x));
        }
      }
      const int32_t pmin = bounds[2 * qt], pmax = bounds[2 * qt + 1];
      const bool open = (!causal || kwarp + 15 <= pmin) &&
                        (window <= 0 || kwarp > pmax - window);
      if (!open) {                                     // warp-uniform
#pragma unroll
        for (int i = 0; i < kNS; ++i) {
          const int64_t row = q0 + 8 * (i >> 2) + 2 * quad + (i & 1);
          const int64_t pos = row < s_len ? q_pos[row] : 0;
          const int64_t key = key_a + ((i & 2) ? 8 : 0);
          const bool ok = (!causal || key <= pos) &&
                          (window <= 0 || key > pos - window);
          sc[i] = ok ? sc[i] : 0.0f;
        }
      }
#pragma unroll
      for (int i = 0; i < kNS; ++i) xchg[i * kWgThreads + wt] = sc[i];
      bar_arrive<1, kF32Threads>();                      // P is there
    } else {
      bar_sync<1, kF32Threads>();
#pragma unroll
      for (int j = 0; j < kNS / 4; ++j) {
        const float4 x = rw[4 * j + quad];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e;
          sc[i] = xchg[i * kWgThreads + wt] *
                  (sc[i] - ((e & 1) ? x.w : x.y));
        }
      }
    }
    wide_put_rows(y_rows, sc, m0, quad);
    fence_proxy_async();
    if (wg == 0) {
      bar_sync<2, kWgThreads>();
    } else {
      bar_sync<3, kWgThreads>();
    }

    // dV^T += dO^T P (warpgroup 0), dK^T += Q^T dS (1), 64 rows of hd at
    // a time
#pragma unroll
    for (int mb = 0; mb < kWideHd / 64; ++mb) {
      wide_out_block(acc, 32 * mb, x_split, y_rows, 64 * mb, m0, quad);
    }
    __syncthreads();                  // the tile and P^T / dS^T are free
    more = walk.next(g, qt, q0);
    if (tid == 0 && more) load_unit(q0);
  }

  // acc[32 mb + i]: head dim 64 mb + m0 (i & 2 == 0) or + 8, key k0 + 8 (i
  // / 4) + 2 quad + (i & 1); dK times the scale
  float* out = wg ? dk : dv;
  const float mul = wg ? scale : 1.0f;
#pragma unroll
  for (int mb = 0; mb < kWideHd / 64; ++mb)
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int64_t d = 64 * mb + m0 + ((i & 2) ? 8 : 0);
      const int64_t key = k0 + 8 * (i >> 2) + 2 * quad + (i & 1);
      if (d < hd && key < t_len) {
        out[((b * t_len + key) * hq + h) * hd + d] = acc[32 * mb + i] * mul;
      }
    }
}

__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// dK and dV of each KV head: the sum of its G query heads' f32 shares (B,
// T, Hq, hd), head 0 first, rounded once to T; one writer an element
template <typename T>
__global__ void __launch_bounds__(kThreads)
bwd_group_sum_kernel(const float* __restrict__ part_k,
                     const float* __restrict__ part_v, T* __restrict__ dk,
                     T* __restrict__ dv, int64_t n, int64_t group,
                     int64_t hd) {
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * kThreads) {
    const int64_t d = i % hd, row = i / hd;           // row: (b, t, kvh)
    const int64_t src = row * group * hd + d;
    float sk = part_k[src], sv = part_v[src];
    for (int64_t g = 1; g < group; ++g) {
      sk += part_k[src + g * hd];
      sv += part_v[src + g * hd];
    }
    put(dk + i, sk);
    put(dv + i, sv);
  }
}

struct F32WideQLayout {
  static constexpr int kOffDo = kWideChunks * kWideRaw;      // 64 KB
  static constexpr int kOffK = 2 * kOffDo;                   // the tile
  static constexpr int kOffV = kOffK + kWideChunks * kWideSplit;
  static constexpr int kOffDs = kOffV + kWideChunks * kWideSplit;
  static constexpr int kOffX = kOffDs + kF32Block * kSwizzleRow;
  static constexpr int kOffBar = kOffX + kWgThreads * (kWideUnit / 2) * 4;
  static constexpr uint32_t kQTx = 2 * kWideChunks * kWideRaw;
  static constexpr uint32_t kTx = 2 * kWideChunks * kWideHi;
  static constexpr size_t kBytes = kOffBar + 16 + 1024;
};

// pass 3 at hd 256: dQ of 64 query rows of one head.  Warpgroup 0 computes
// S = Q K^T and P, warpgroup 1 dP = dO V^T and dS = P (dP - D); each then
// takes 128 rows of hd of dQ^T += K^T dS^T.
__global__ void __launch_bounds__(kF32Threads, 1)
bwd_dq_f32_wide_kernel(const __grid_constant__ CUtensorMap q_map,
                       const __grid_constant__ CUtensorMap do_map,
                       const __grid_constant__ CUtensorMap k_map,
                       const __grid_constant__ CUtensorMap v_map,
                       const float* __restrict__ rows,
                       const int32_t* __restrict__ q_pos,
                       const int32_t* __restrict__ bounds,
                       float* __restrict__ dq, int64_t s_len, int64_t t_len,
                       int64_t group, int64_t hd, int causal, int64_t window,
                       float scale) {
  using L = F32WideQLayout;
  constexpr int kNS = kWideUnit / 2;         // score registers a thread
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t bar_q = base + L::kOffBar, bar_full = bar_q + 8;
  float* xchg = reinterpret_cast<float*>(smem_raw + (base + L::kOffX - raw));

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int64_t n_qt = (s_len + kTile - 1) / kTile;
  const int64_t s_pad = n_qt * kTile;
  const int64_t qt = n_qt - 1 - (int64_t)blockIdx.z;
  const int64_t q0 = qt * kTile;
  const int h = blockIdx.x, b = blockIdx.y;
  const int kvh = h / (int)group;
  const int64_t hq = gridDim.x;

  if (tid == 0) {
    mbar_init(bar_q, 1);
    mbar_init(bar_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  int64_t lo, hi;
  key_band(bounds[2 * qt], bounds[2 * qt + 1], t_len, causal, window, lo,
           hi);
  const int kt0 = __shfl_sync(
      0xffffffffu, (int)(lo <= hi ? lo / kWideUnit * kWideUnit : 0), 0);
  const int n_tiles = __shfl_sync(
      0xffffffffu, (int)(lo <= hi ? (hi - kt0) / kWideUnit + 1 : 0), 0);

  // thread 0 issues every copy: Q and dO once, then the K and V of key
  // tile it once every thread is done with tile it - 1
  const auto load_kv = [&](int it) {
    const int kt = kt0 + it * kWideUnit;
    mbar_expect_tx(bar_full, L::kTx);
#pragma unroll
    for (int c = 0; c < kWideChunks; ++c) {
      tma_load_4d(base + L::kOffK + c * kWideSplit + kWideHi, &k_map,
                  bar_full, kF32Cols * c, kt, kvh, b);
      tma_load_4d(base + L::kOffV + c * kWideSplit + kWideHi, &v_map,
                  bar_full, kF32Cols * c, kt, kvh, b);
    }
  };
  if (tid == 0) {
    mbar_expect_tx(bar_q, L::kQTx);
#pragma unroll
    for (int c = 0; c < kWideChunks; ++c) {
      tma_load_4d(base + c * kWideRaw, &q_map, bar_q, kF32Cols * c, (int)q0,
                  h, b);
      tma_load_4d(base + L::kOffDo + c * kWideRaw, &do_map, bar_q,
                  kF32Cols * c, (int)q0, h, b);
    }
    if (n_tiles > 0) load_kv(0);
  }

  const int wg = __shfl_sync(0xffffffffu, warp >> 2, 0);
  const int wt = tid & (kWgThreads - 1);
  const int quad = lane & 3;
  const int m0 = 16 * (warp & 3) + (lane >> 2);   // rows q0 + m0, + 8
  const int64_t row_a = q0 + m0, row_b = row_a + 8;
  const int64_t pos_a = row_a < s_len ? q_pos[row_a] : 0;
  const int64_t pos_b = row_b < s_len ? q_pos[row_b] : 0;
  // (L log2 e, D) of the two rows; rows past S read (+inf, 0): P = 0
  const float2* rb =
      reinterpret_cast<const float2*>(rows) + ((int64_t)b * hq + h) * s_pad;
  const float2 ra = rb[row_a], rr = rb[row_b];
  const float sl2 = scale * kLog2e;
  const uint32_t a_raw = base + (wg ? L::kOffDo : 0);
  const uint32_t b_split = base + (wg ? L::kOffV : L::kOffK);
  const uint32_t ds_rows = base + L::kOffDs;

  float acc[kWideHd / 4], sc[16];
#pragma unroll
  for (int i = 0; i < kWideHd / 4; ++i) acc[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < 16; ++i) sc[i] = 0.0f;

  mbar_wait(bar_q, 0);
  for (int it = 0; it < n_tiles; ++it) {
    mbar_wait(bar_full, (uint32_t)(it & 1));
    wide_split(base + L::kOffK, L::kOffV - L::kOffK, tid);
    fence_proxy_async();
    __syncthreads();

    // S = Q K^T (warpgroup 0), dP = dO V^T (1): sc[i] is row row_a (i & 2
    // == 0) or row_b, key kt + 8 (i / 4) + 2 quad + (i & 1)
    wide_scores<kWideGroup>(sc, a_raw, b_split, m0, quad);
    if (wg == 0) {
      const int64_t kt = kt0 + (int64_t)it * kWideUnit;
#pragma unroll
      for (int i = 0; i < kNS; ++i) {
        sc[i] = exp2f(fmaf(sc[i], sl2, (i & 2) ? -rr.x : -ra.x));
      }
      const bool open =
          tile_open<kWideUnit>(kt, pos_a, t_len, causal, window) &&
          tile_open<kWideUnit>(kt, pos_b, t_len, causal, window);
      if (__any_sync(0xffffffffu, !open)) {
        const int64_t k0 = kt + 2 * quad;          // the key of sc[0]
        const int t_rel = clamp_rel(t_len - k0);
        const int far = 1 << 30;
        const int hi_a = causal ? clamp_rel(pos_a - k0) : far;
        const int hi_b = causal ? clamp_rel(pos_b - k0) : far;
        const int lo_a = window > 0 ? clamp_rel(pos_a - window + 1 - k0) : -far;
        const int lo_b = window > 0 ? clamp_rel(pos_b - window + 1 - k0) : -far;
#pragma unroll
        for (int i = 0; i < kNS; ++i) {
          const int c = 8 * (i >> 2) + (i & 1);
          const int hi_r = (i & 2) ? hi_b : hi_a, lo_r = (i & 2) ? lo_b : lo_a;
          const bool ok = c <= hi_r && c >= lo_r && c < t_rel;
          sc[i] = ok ? sc[i] : 0.0f;
        }
      }
#pragma unroll
      for (int i = 0; i < kNS; ++i) xchg[i * kWgThreads + wt] = sc[i];
      bar_arrive<1, kF32Threads>();                      // P is there
    } else {
      bar_sync<1, kF32Threads>();
#pragma unroll
      for (int i = 0; i < kNS; ++i) {
        sc[i] = xchg[i * kWgThreads + wt] *
                (sc[i] - ((i & 2) ? rr.y : ra.y));
      }
      wide_put_rows(ds_rows, sc, m0, quad);
      fence_proxy_async();
    }
    bar_sync<2, kF32Threads>();                          // dS is there

    // dQ^T += K^T dS^T over this warpgroup's 128 rows of hd
#pragma unroll
    for (int mb = 0; mb < 2; ++mb) {
      wide_out_block(acc, 32 * mb, base + L::kOffK, ds_rows,
                     kWideHd / 2 * wg + 64 * mb, m0, quad);
    }
    __syncthreads();                  // the tile and dS are free
    if (tid == 0 && it + 1 < n_tiles) load_kv(it + 1);
  }

  // acc[32 mb + i]: head dim 128 wg + 64 mb + m0 (i & 2 == 0) or + 8, row
  // q0 + 8 (i / 4) + 2 quad + (i & 1); times the scale
#pragma unroll
  for (int mb = 0; mb < 2; ++mb)
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int64_t d = kWideHd / 2 * wg + 64 * mb + m0 + ((i & 2) ? 8 : 0);
      const int64_t row = q0 + 8 * (i >> 2) + 2 * quad + (i & 1);
      if (row < s_len && d < hd) {
        dq[((b * s_len + row) * hq + h) * hd + d] = acc[32 * mb + i] * scale;
      }
    }
}

// ------------------------------------------ bf16 route, 128 < hd <= 256 --
//
// The bf16 route's arithmetic (`bwd_dkdv_tc_kernel`, `bwd_dq_tc_kernel`:
// P and dS rounded to bf16 before the three products that read them, dS
// from the unrounded P, S, dP, L, D and the sums in f32, each output
// rounded once to bf16; `ref.py::attention_bwd_bf16_ref`) at hd padded to
// 256 (pass 1 is `bwd_rows_kernel<__nv_bfloat16>` itself).  At this width
// a warpgroup that held both dK and dV of its keys, as the narrow pass 2
// does, would need 256 accumulator registers a thread.  So, as the f32
// routes, the two warpgroups of a block split the products between them
// and each holds one output (128 registers a thread):
//   pass 2 (`bwd_dkdv_bf16_wide_kernel`): a block owns 64 keys, K and V
//   loaded once by TMA (32 KB each), and streams the (Q, dO) tiles of 64
//   rows with their (L log2 e, D) pairs through a ring of 2 stages (64 KB
//   each).  Warpgroup 0: S^T = K Q^T (wgmma m64n64k16, both from shared
//   memory, K-major), P^T = exp2(S^T scale log2 e - L log2 e), masked,
//   handed over in f32 through shared memory (16 KB: dS needs the
//   unrounded P), then dV += P^T dO (m64n256k16, P^T rounded to bf16 from
//   registers, dO read MN-major).  Warpgroup 1: dP^T = V dO^T, then dS^T =
//   P^T (dP^T - D) and dK += dS^T Q the same way.
//   pass 3 (`bwd_dq_bf16_wide_kernel`): a block owns 64 query rows of one
//   head, Q and dO loaded once (32 KB each), and streams 64-key (K, V)
//   tiles through the same ring.  Warpgroup 0: S = Q K^T and P, handed over
//   in f32; warpgroup 1: dP = dO V^T and dS = P (dP - D), written as bf16
//   into a 128-byte-swizzled tile (8 KB: 64 rows of 64 keys, the K-major A
//   operand); then each warpgroup takes 128 columns of dQ += dS K
//   (m64n128k16, A and B from shared memory, K read MN-major; 64 registers
//   a thread).
// Thread 0 issues every copy: tile it + 1 once both warpgroups have
// released tile it - 1 (the stage's "empty" mbarrier, 8 warps).  In pass 2
// that wait is made by all of warpgroup 0 before it writes P, since
// warpgroup 1 reads the previous P before it releases its stage; in pass 3
// the two warpgroups meet at a named barrier every tile (dS is there).
// Pass 2 runs one block a query head, as the f32 wide route (grid (Hq, B,
// key blocks), the first key blocks, the longest walks under causal
// masking, launched first): with G > 1 each block writes its head's f32
// share of dK and dV to a (2, B, T, Hq, hd) scratch and
// `bwd_group_sum_kernel<__nv_bfloat16>` adds the G shares in head order
// and rounds once (one writer an element: bitwise repeatable).  Shared
// memory: the resident operand 64 KB, two stages 128 KB (and their 1 KB
// of row pairs), the dS tile 8 KB, the P hand-over 16 KB: 217 KB, one
// block an SM.  What bounds it: operations, 10 hd flops a pair; at the
// federated LM's layer 4.29e10 flops, 0.0434 ms at 989 TFLOP/s.
struct Bf16WideBwdLayout {
  static constexpr int kStages = 2;
  static constexpr int kChunk = kTile * kSwizzleRow;    // 64 rows x 64 columns
  static constexpr int kOperand = 4 * kChunk;           // 64 rows of hd 256
  // pass 2: K, then V; pass 3: Q, then dO
  static constexpr int kOffB = kOperand;
  // a stage: Q then dO (pass 2), K then V (pass 3)
  static constexpr int kOffStage = 2 * kOperand;
  static constexpr int kStage = 2 * kOperand;
  static constexpr int kOffRows = kOffStage + kStages * kStage;  // pass 2
  static constexpr int kOffDs = kOffRows + kStages * kRowBytes;  // pass 3
  static constexpr int kOffX = kOffDs + kChunk;                  // P
  static constexpr int kOffBar = kOffX + kTcThreads / 2 * 32 * 4;
  static constexpr size_t kBytes = kOffBar + 8 * (1 + 2 * kStages) + 1024;
};

__device__ __forceinline__ void sts_b32(uint32_t a, uint32_t x) {
  asm volatile("st.shared.b32 [%0], %1;\n" :: "r"(a), "r"(x) : "memory");
}

// pass 2 at hd 256: one query head's share of dK and dV of 64 keys of its
// KV head: dK and dV themselves (bf16) when G = 1, else the f32 shares
// `part_k`, `part_v` ((B, T, Hq, hd)), summed by `bwd_group_sum_kernel`
__global__ void __launch_bounds__(kTcThreads, 1)
bwd_dkdv_bf16_wide_kernel(const __grid_constant__ CUtensorMap q_map,
                          const __grid_constant__ CUtensorMap do_map,
                          const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map,
                          const float* __restrict__ rows,
                          const int32_t* __restrict__ q_pos,
                          const int32_t* __restrict__ bounds,
                          __nv_bfloat16* __restrict__ dk,
                          __nv_bfloat16* __restrict__ dv,
                          float* __restrict__ part_k,
                          float* __restrict__ part_v, int64_t s_len,
                          int64_t t_len, int64_t group, int64_t hd,
                          int causal, int64_t window, float scale) {
  using L = Bf16WideBwdLayout;
  constexpr int kS = L::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t k_base = base, v_base = base + L::kOffB;
  const uint32_t stage0 = base + L::kOffStage;
  const uint32_t rows0 = base + L::kOffRows;
  const uint32_t bar_kv = base + L::kOffBar;                // K, V arrived
  const uint32_t bar_full = bar_kv + 8;                     // [stage]
  const uint32_t bar_empty = bar_full + 8 * kS;             // [stage]
  const float4* rows_s =
      reinterpret_cast<const float4*>(smem_raw + (rows0 - raw));
  float* xchg = reinterpret_cast<float*>(smem_raw + (base + L::kOffX - raw));

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // grid (Hq, B, key blocks): the first key blocks, whose causal bands are
  // the longest, are all launched first
  const int64_t k0 = (int64_t)blockIdx.z * kTile;
  const int h = blockIdx.x, b = blockIdx.y;
  const int kvh = h / (int)group;
  const int64_t hq = gridDim.x;
  const int64_t n_qt = (s_len + kTile - 1) / kTile;
  const int64_t s_pad = n_qt * kTile;
  const int64_t k_last = (k0 + kTile < t_len ? k0 + kTile : t_len) - 1;

  if (tid == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < kS; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, kTcWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // thread 0 issues every copy: K and V now, and the (Q, dO, rows) of the
  // it-th visited query tile into stage it % stages
  const auto load_stage = [&](int it, int64_t qt) {
    const int s = it % kS;
    const uint32_t full = bar_full + 8 * s;
    const uint32_t st = stage0 + s * L::kStage;
    const int q0 = (int)(qt * kTile);
    mbar_expect_tx(full, 2 * L::kOperand + kRowBytes);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      tma_load_4d(st + c * L::kChunk, &q_map, full, 64 * c, q0, h, b);
      tma_load_4d(st + L::kOperand + c * L::kChunk, &do_map, full, 64 * c,
                  q0, h, b);
    }
    bulk_load(rows0 + s * kRowBytes,
              rows + (((int64_t)b * hq + h) * s_pad + qt * kTile) * 2,
              kRowBytes, full);
  };
  // the query tiles of this head whose band meets the block's keys; warp
  // 0 steps `ahead` a tile ahead of the others to load it
  TileWalk walk{bounds, n_qt, k0, k_last, t_len, window, 1, causal, 0, -32,
                0u};
  TileWalk ahead = walk;
  if (warp == 0) {
    if (lane == 0) {
      mbar_expect_tx(bar_kv, 2 * L::kOperand);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        tma_load_4d(k_base + c * L::kChunk, &k_map, bar_kv, 64 * c, (int)k0,
                    kvh, b);
        tma_load_4d(v_base + c * L::kChunk, &v_map, bar_kv, 64 * c, (int)k0,
                    kvh, b);
      }
    }
    for (int i = 0; i < kS; ++i) {
      int g;
      int64_t qt;
      if (!ahead.next(g, qt)) break;
      if (lane == 0) load_stage(i, qt);
    }
    __syncwarp();
  }

  // ---- both warpgroups own keys k0 .. k0 + 63: warpgroup 0 makes P and
  // dV, warpgroup 1 dS and dK ----
  const int wg = __shfl_sync(0xffffffffu, warp >> 2, 0);
  const int wt = tid & 127;
  const int quad = lane & 3;
  const int64_t kwarp = k0 + 16 * (warp & 3);      // this warp's 16 keys
  const int64_t key_a = kwarp + (lane >> 2);       // and key_a + 8
  const float sl2 = scale * kLog2e;
  const uint32_t a_s = wg ? v_base : k_base;       // the scores' A

  float acc[128], sc[32];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < 32; ++i) sc[i] = 0.0f;

  mbar_wait(bar_kv, 0);
  for (int it = 0;; ++it) {
    int g;
    int64_t qt;
    if (!walk.next(g, qt)) break;
    const int s = it % kS;
    mbar_wait(bar_full + 8 * s, (uint32_t)((it / kS) & 1));
    const uint32_t st = stage0 + s * L::kStage;

    // S^T = K Q^T (warpgroup 0), dP^T = V dO^T (1): 16 columns of hd a
    // step, 32 bytes into a 128-byte row
    const uint32_t b_s = st + (wg ? L::kOperand : 0);
    fence_regs(sc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 16; ++ks) {
      const uint32_t col = (ks % 4) * 32;
      wgmma_ss_n64(sc, desc128(a_s + (ks / 4) * L::kChunk + col, 16, 1024),
                   desc128(b_s + (ks / 4) * L::kChunk + col, 16, 1024),
                   ks > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    // sc[i]: key key_a (i & 2 == 0) or key_a + 8, query row q0 + c, c = 8
    // (i / 4) + 2 quad + (i & 1); rows_s holds rows c, c + 1 of column
    // pair i / 4 as one float4 (L log2 e, D, L log2 e, D)
    const float4* rw = rows_s + s * (kRowBytes / 16);
    if (wg == 0) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 x = rw[4 * j + quad];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e;
          sc[i] = exp2f(fmaf(sc[i], sl2, (e & 1) ? -x.z : -x.x));
        }
      }
      // where a key of this warp lies past the tile's band edge, mask by
      // selects (a masked p may be inf: it is replaced, not multiplied);
      // rows past S have P = 0 already, keys past T are never stored
      const int32_t pmin = bounds[2 * qt], pmax = bounds[2 * qt + 1];
      const bool open = (!causal || kwarp + 15 <= pmin) &&
                        (window <= 0 || kwarp > pmax - window);
      if (!open) {                                     // warp-uniform
        const int64_t q0 = qt * kTile;
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int64_t row = q0 + 8 * (i >> 2) + 2 * quad + (i & 1);
          const int64_t pos = row < s_len ? q_pos[row] : 0;
          const int64_t key = key_a + ((i & 2) ? 8 : 0);
          const bool ok = (!causal || key <= pos) &&
                          (window <= 0 || key > pos - window);
          sc[i] = ok ? sc[i] : 0.0f;
        }
      }
      // warpgroup 1 read the previous tile's P before it released that
      // tile's stage; then tile it + 1 goes into that stage
      if (it >= 1) {
        mbar_wait(bar_empty + 8 * ((it - 1) % kS),
                  (uint32_t)(((it - 1) / kS) & 1));
        if (warp == 0) {
          int g2;
          int64_t qt2;
          if (ahead.next(g2, qt2) && lane == 0) load_stage(it + 1, qt2);
          __syncwarp();
        }
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) xchg[i * 128 + wt] = sc[i];
      bar_arrive<1, kTcThreads>();                       // P is there
    } else {
      bar_sync<1, kTcThreads>();
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 x = rw[4 * j + quad];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e;
          sc[i] = xchg[i * 128 + wt] * (sc[i] - ((e & 1) ? x.w : x.y));
        }
      }
    }

    // dV += P^T dO (warpgroup 0), dK += dS^T Q (1), P and dS rounded to
    // bf16: 16 query rows (2 KB of 128-byte rows) a step, B read MN-major
    uint32_t fa[4][4];
    pack_a(fa, sc);
    const uint32_t x_s = st + (wg ? 0 : L::kOperand);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_rs_n256(acc, fa[kk],
                    desc128(x_s + kk * 16 * kSwizzleRow, L::kChunk, 1024), 1);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty + 8 * s);   // this warp is done
  }

  // acc[4 j + 2 half + e]: key key_a + 8 half, head dim 8 j + 2 quad + e;
  // dK times the scale
  const float mul = wg ? scale : 1.0f;
  if (group == 1) {
    store_rows<256>(wg ? dk : dv, acc, mul, b, key_a, t_len, h, hq, hd,
                    quad);
    return;
  }
  float* out = wg ? part_k : part_v;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const int64_t d = 8 * j + 2 * quad;
    if (d >= hd) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int64_t key = key_a + 8 * half;
      if (key >= t_len) continue;
      float* p = out + ((b * t_len + key) * hq + h) * hd + d;
      p[0] = acc[4 * j + 2 * half] * mul;
      if (d + 1 < hd) p[1] = acc[4 * j + 2 * half + 1] * mul;
    }
  }
}

// pass 3 at hd 256: dQ of 64 query rows of one head.  Warpgroup 0 computes
// S = Q K^T and P, warpgroup 1 dP = dO V^T and dS = P (dP - D); each then
// takes 128 columns of dQ += dS K.
__global__ void __launch_bounds__(kTcThreads, 1)
bwd_dq_bf16_wide_kernel(const __grid_constant__ CUtensorMap q_map,
                        const __grid_constant__ CUtensorMap do_map,
                        const __grid_constant__ CUtensorMap k_map,
                        const __grid_constant__ CUtensorMap v_map,
                        const float* __restrict__ rows,
                        const int32_t* __restrict__ q_pos,
                        const int32_t* __restrict__ bounds,
                        __nv_bfloat16* __restrict__ dq, int64_t s_len,
                        int64_t t_len, int64_t group, int64_t hd, int causal,
                        int64_t window, float scale) {
  using L = Bf16WideBwdLayout;
  constexpr int kS = L::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t q_base = base, do_base = base + L::kOffB;
  const uint32_t stage0 = base + L::kOffStage;
  const uint32_t ds_tile = base + L::kOffDs;
  const uint32_t bar_q = base + L::kOffBar;                 // Q, dO arrived
  const uint32_t bar_full = bar_q + 8;                      // [stage]
  const uint32_t bar_empty = bar_full + 8 * kS;             // [stage]
  float* xchg = reinterpret_cast<float*>(smem_raw + (base + L::kOffX - raw));

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int64_t n_qt = (s_len + kTile - 1) / kTile;
  const int64_t s_pad = n_qt * kTile;
  // grid (Hq, B, query tiles): the last query tiles, whose causal bands
  // are the longest, are all launched first
  const int64_t qt = n_qt - 1 - (int64_t)blockIdx.z;
  const int64_t q0 = qt * kTile;
  const int h = blockIdx.x, b = blockIdx.y;
  const int kvh = h / (int)group;
  const int64_t hq = gridDim.x;

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kS; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, kTcWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  int64_t lo, hi;
  key_band(bounds[2 * qt], bounds[2 * qt + 1], t_len, causal, window, lo,
           hi);
  const int kt0 = __shfl_sync(
      0xffffffffu, (int)(lo <= hi ? lo / kTile * kTile : 0), 0);
  const int n_tiles = __shfl_sync(
      0xffffffffu, (int)(lo <= hi ? (hi - kt0) / kTile + 1 : 0), 0);

  // thread 0 issues every copy: Q and dO once, the K and V of key tile it
  // into stage it % stages
  const auto load_kv = [&](int it) {
    const int s = it % kS;
    const uint32_t full = bar_full + 8 * s;
    const uint32_t st = stage0 + s * L::kStage;
    const int kt = kt0 + it * kTile;
    mbar_expect_tx(full, 2 * L::kOperand);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      tma_load_4d(st + c * L::kChunk, &k_map, full, 64 * c, kt, kvh, b);
      tma_load_4d(st + L::kOperand + c * L::kChunk, &v_map, full, 64 * c, kt,
                  kvh, b);
    }
  };
  if (tid == 0) {
    mbar_expect_tx(bar_q, 2 * L::kOperand);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      tma_load_4d(q_base + c * L::kChunk, &q_map, bar_q, 64 * c, (int)q0, h,
                  b);
      tma_load_4d(do_base + c * L::kChunk, &do_map, bar_q, 64 * c, (int)q0,
                  h, b);
    }
    for (int i = 0; i < kS && i < n_tiles; ++i) load_kv(i);
  }
  __syncwarp();

  const int wg = __shfl_sync(0xffffffffu, warp >> 2, 0);
  const int wt = tid & 127;
  const int quad = lane & 3;
  const int m0 = 16 * (warp & 3) + (lane >> 2);   // rows q0 + m0, + 8
  const int64_t row_a = q0 + m0, row_b = row_a + 8;
  const int64_t pos_a = row_a < s_len ? q_pos[row_a] : 0;
  const int64_t pos_b = row_b < s_len ? q_pos[row_b] : 0;
  // (L log2 e, D) of the two rows; rows past S read (+inf, 0): P = 0
  const float2* rb =
      reinterpret_cast<const float2*>(rows) + ((int64_t)b * hq + h) * s_pad;
  const float2 ra = rb[row_a], rr = rb[row_b];
  const float sl2 = scale * kLog2e;
  const uint32_t a_s = wg ? do_base : q_base;      // the scores' A

  float acc[64], sc[32];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < 32; ++i) sc[i] = 0.0f;

  mbar_wait(bar_q, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % kS;
    if (tid == 0 && it >= 1 && it + 1 < n_tiles) {
      // tile it + 1 into the stage tile it - 1 has released
      mbar_wait(bar_empty + 8 * ((it - 1) % kS),
                (uint32_t)(((it - 1) / kS) & 1));
      load_kv(it + 1);
    }
    __syncwarp();
    mbar_wait(bar_full + 8 * s, (uint32_t)((it / kS) & 1));
    const int64_t kt = kt0 + (int64_t)it * kTile;
    const uint32_t k_s = stage0 + s * L::kStage;

    // S = Q K^T (warpgroup 0), dP = dO V^T (1)
    const uint32_t b_s = k_s + (wg ? L::kOperand : 0);
    fence_regs(sc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 16; ++ks) {
      const uint32_t col = (ks % 4) * 32;
      wgmma_ss_n64(sc, desc128(a_s + (ks / 4) * L::kChunk + col, 16, 1024),
                   desc128(b_s + (ks / 4) * L::kChunk + col, 16, 1024),
                   ks > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    // sc[i]: row row_a (i & 2 == 0) or row_b, key kt + 8 (i / 4) + 2 quad
    // + (i & 1)
    if (wg == 0) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        sc[i] = exp2f(fmaf(sc[i], sl2, (i & 2) ? -rr.x : -ra.x));
      }
      // where any lane of the warp meets a masked key, mask by selects
      const bool open = tile_open<kTile>(kt, pos_a, t_len, causal, window) &&
                        tile_open<kTile>(kt, pos_b, t_len, causal, window);
      if (__any_sync(0xffffffffu, !open)) {
        const int64_t kq = kt + 2 * quad;          // the key of sc[0]
        const int t_rel = clamp_rel(t_len - kq);
        const int far = 1 << 30;
        const int hi_a = causal ? clamp_rel(pos_a - kq) : far;
        const int hi_b = causal ? clamp_rel(pos_b - kq) : far;
        const int lo_a = window > 0 ? clamp_rel(pos_a - window + 1 - kq) : -far;
        const int lo_b = window > 0 ? clamp_rel(pos_b - window + 1 - kq) : -far;
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int c = 8 * (i >> 2) + (i & 1);
          const int hi_r = (i & 2) ? hi_b : hi_a, lo_r = (i & 2) ? lo_b : lo_a;
          const bool ok = c <= hi_r && c >= lo_r && c < t_rel;
          sc[i] = ok ? sc[i] : 0.0f;
        }
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) xchg[i * 128 + wt] = sc[i];
      bar_arrive<1, kTcThreads>();                       // P is there
    } else {
      bar_sync<1, kTcThreads>();
      // dS in f32, rounded to bf16 into the tile: row r, keys 8 j + 2 quad
      // and + 1 as one word of 16-byte unit j (swizzled by r mod 8)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
          const int i = 4 * j + e;
          const float2 r = e ? rr : ra;
          const float d0 = xchg[i * 128 + wt] * (sc[i] - r.y);
          const float d1 = xchg[(i + 1) * 128 + wt] * (sc[i + 1] - r.y);
          const int row = m0 + 4 * e;
          sts_b32(ds_tile + row * kSwizzleRow + (((j ^ row) & 7) << 4) +
                      4 * quad,
                  pack_bf16(d0, d1));
        }
      fence_proxy_async();
    }
    bar_sync<2, kTcThreads>();                           // dS is there

    // dQ += dS K over this warpgroup's 128 columns of hd: 16 keys a step,
    // dS (K-major) and K (read MN-major) from shared memory
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_ss_n128_tb(
          acc, desc128(ds_tile + kk * 32, 16, 1024),
          desc128(k_s + 2 * wg * L::kChunk + kk * 16 * kSwizzleRow,
                  L::kChunk, 1024),
          1);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty + 8 * s);   // this warp is done
  }

  // acc[4 j + 2 half + e]: row row_a + 8 half, head dim 128 wg + 8 j + 2
  // quad + e; times the scale, as bf16
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int64_t d = 128 * wg + 8 * j + 2 * quad;
    if (d >= hd) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int64_t row = row_a + 8 * half;
      if (row >= s_len) continue;
      const float x0 = acc[4 * j + 2 * half] * scale;
      const float x1 = acc[4 * j + 2 * half + 1] * scale;
      __nv_bfloat16* p = dq + ((b * s_len + row) * hq + h) * hd + d;
      if ((hd & 1) == 0) {
        *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x0, x1);
      } else {
        p[0] = __float2bfloat16_rn(x0);
        if (d + 1 < hd) p[1] = __float2bfloat16_rn(x1);
      }
    }
  }
}

// pass 1 of both routes, `bwd_rows_kernel`, which reads o (and dO) by
// 16-byte words, as TMA reads the others
template <typename T>
int launch_rows(cudaStream_t stream, const void* o, const void* dout,
                const void* lse, const void* q_pos, void* rows, void* bounds,
                int64_t b, int64_t s_len, int64_t hq, int64_t hd, Strides os,
                Strides ds) {
  const int64_t o_size[3] = {b, s_len, hq}, o_step[3] = {os.b, os.s, os.h};
  for (int i = 0; i < 3; ++i) {
    if (o_size[i] > 1 && (o_step[i] * (int64_t)sizeof(T)) % 16) {
      return (int)cudaErrorMisalignedAddress;
    }
  }
  if ((uintptr_t)o & 15) return (int)cudaErrorMisalignedAddress;
  const unsigned n_qt = (unsigned)((s_len + kTile - 1) / kTile);
  bwd_rows_kernel<T><<<dim3(n_qt, (unsigned)hq, (unsigned)b), kThreads, 0,
                       stream>>>(
      (const T*)o, (const T*)dout, (const float*)lse, (const int32_t*)q_pos,
      (float*)rows, (int32_t*)bounds, s_len, hd, os, ds);
  return (int)cudaGetLastError();
}

template <int HD_PAD>
int launch_tc_bwd(cudaStream_t stream, const void* q, const void* k,
                  const void* v, const void* o, const void* dout,
                  const void* lse, const void* q_pos, void* dq, void* dk,
                  void* dv, void* rows, void* bounds, int64_t b,
                  int64_t s_len, int64_t t_len, int64_t hq, int64_t kh,
                  int64_t hd, Strides qs, Strides ks, Strides vs,
                  Strides os, Strides ds, int causal, int64_t window,
                  float scale) {
  // pass 2 streams Q and dO by 64 rows and holds K and V by 128; pass 3
  // the other way round
  CUtensorMap q64, do64, k128, v128, q128, do128, k64, v64;
  int rc = make_map(&q64, q, kBf16, 2, hd, s_len, hq, b, qs, kTile);
  if (rc == 0) rc = make_map(&do64, dout, kBf16, 2, hd, s_len, hq, b, ds,
                             kTile);
  if (rc == 0) rc = make_map(&k128, k, kBf16, 2, hd, t_len, kh, b, ks,
                             kTcBlock);
  if (rc == 0) rc = make_map(&v128, v, kBf16, 2, hd, t_len, kh, b, vs,
                             kTcBlock);
  if (rc == 0) rc = make_map(&q128, q, kBf16, 2, hd, s_len, hq, b, qs,
                             kTcBlock);
  if (rc == 0) rc = make_map(&do128, dout, kBf16, 2, hd, s_len, hq, b, ds,
                             kTcBlock);
  if (rc == 0) rc = make_map(&k64, k, kBf16, 2, hd, t_len, kh, b, ks, kTile);
  if (rc == 0) rc = make_map(&v64, v, kBf16, 2, hd, t_len, kh, b, vs, kTile);
  if (rc != 0) return rc;
  rc = launch_rows<__nv_bfloat16>(stream, o, dout, lse, q_pos, rows, bounds,
                                  b, s_len, hq, hd, os, ds);
  if (rc != 0) return rc;
  const size_t kv_bytes = KvLayout<HD_PAD>::kBytes;
  const size_t q_bytes = QLayout<HD_PAD>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(bwd_dkdv_tc_kernel<HD_PAD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kv_bytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(bwd_dq_tc_kernel<HD_PAD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)q_bytes);
  if (err != cudaSuccess) return (int)err;
  bwd_dkdv_tc_kernel<HD_PAD>
      <<<dim3((unsigned)kh, (unsigned)b,
              (unsigned)((t_len + kTcBlock - 1) / kTcBlock)),
         kTcThreads, kv_bytes, stream>>>(
          q64, do64, k128, v128, (const float*)rows, (const int32_t*)q_pos,
          (const int32_t*)bounds, (__nv_bfloat16*)dk, (__nv_bfloat16*)dv,
          s_len, t_len, hq, hd, causal, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bwd_dq_tc_kernel<HD_PAD>
      <<<dim3((unsigned)hq, (unsigned)b,
              (unsigned)((s_len + kTcBlock - 1) / kTcBlock)),
         kTcThreads, q_bytes, stream>>>(
          q128, do128, k64, v64, (const float*)rows, (const int32_t*)q_pos,
          (const int32_t*)bounds, (__nv_bfloat16*)dq, s_len, t_len, hq / kh,
          hd, causal, window, scale);
  return (int)cudaGetLastError();
}

template <int HD_PAD>
int launch_f32_bwd(cudaStream_t stream, const void* q, const void* k,
                   const void* v, const void* o, const void* dout,
                   const void* lse, const void* q_pos, void* dq, void* dk,
                   void* dv, void* rows, void* bounds, int64_t b,
                   int64_t s_len, int64_t t_len, int64_t hq, int64_t kh,
                   int64_t hd, Strides qs, Strides ks, Strides vs,
                   Strides os, Strides ds, int causal, int64_t window,
                   float scale) {
  // pass 2 streams Q and dO by R rows and reads K and V through their
  // strides; pass 3 streams K and V by 32 keys and reads Q and dO
  constexpr int kR = F32KvLayout<HD_PAD>::kR;
  CUtensorMap q_map, do_map, k_map, v_map;
  int rc = make_map(&q_map, q, kF32, 4, hd, s_len, hq, b, qs, kR);
  if (rc == 0) rc = make_map(&do_map, dout, kF32, 4, hd, s_len, hq, b, ds,
                             kR);
  if (rc == 0) rc = make_map(&k_map, k, kF32, 4, hd, t_len, kh, b, ks,
                             kF32Keys);
  if (rc == 0) rc = make_map(&v_map, v, kF32, 4, hd, t_len, kh, b, vs,
                             kF32Keys);
  if (rc == 0) rc = launch_rows<float>(stream, o, dout, lse, q_pos, rows,
                                       bounds, b, s_len, hq, hd, os, ds);
  if (rc != 0) return rc;
  const size_t kv_bytes = F32KvLayout<HD_PAD>::kBytes;
  const size_t q_bytes = F32QLayout<HD_PAD>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      bwd_dkdv_f32_kernel<HD_PAD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kv_bytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(bwd_dq_f32_kernel<HD_PAD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)q_bytes);
  if (err != cudaSuccess) return (int)err;
  bwd_dkdv_f32_kernel<HD_PAD>
      <<<dim3((unsigned)kh, (unsigned)b,
              (unsigned)((t_len + kF32Block - 1) / kF32Block)),
         kF32Threads, kv_bytes, stream>>>(
          q_map, do_map, (const float*)k, (const float*)v, ks, vs,
          (const float*)rows, (const int32_t*)q_pos, (const int32_t*)bounds,
          (float*)dk, (float*)dv, s_len, t_len, hq, hd, causal, window,
          scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bwd_dq_f32_kernel<HD_PAD>
      <<<dim3((unsigned)hq, (unsigned)b,
              (unsigned)((s_len + kF32Block - 1) / kF32Block)),
         kF32Threads, q_bytes, stream>>>(
          k_map, v_map, (const float*)q, (const float*)dout, qs, ds,
          (const float*)rows, (const int32_t*)q_pos, (const int32_t*)bounds,
          (float*)dq, s_len, t_len, hq / kh, hd, causal, window, scale);
  return (int)cudaGetLastError();
}

int launch_f32_bwd_wide(cudaStream_t stream, const void* q, const void* k,
                        const void* v, const void* o, const void* dout,
                        const void* lse, const void* q_pos, void* dq,
                        void* dk, void* dv, void* rows, void* bounds,
                        void* part,
                        int64_t b, int64_t s_len, int64_t t_len, int64_t hq,
                        int64_t kh, int64_t hd, Strides qs, Strides ks,
                        Strides vs, Strides os, Strides ds, int causal,
                        int64_t window, float scale) {
  // pass 2 streams Q and dO by 16 rows and holds K and V by 64; pass 3
  // the other way round
  CUtensorMap q16, do16, k64, v64, q64, do64, k16, v16;
  int rc = make_map(&q16, q, kF32, 4, hd, s_len, hq, b, qs, kWideUnit);
  if (rc == 0) rc = make_map(&do16, dout, kF32, 4, hd, s_len, hq, b, ds,
                             kWideUnit);
  if (rc == 0) rc = make_map(&k64, k, kF32, 4, hd, t_len, kh, b, ks,
                             kF32Block);
  if (rc == 0) rc = make_map(&v64, v, kF32, 4, hd, t_len, kh, b, vs,
                             kF32Block);
  if (rc == 0) rc = make_map(&q64, q, kF32, 4, hd, s_len, hq, b, qs,
                             kF32Block);
  if (rc == 0) rc = make_map(&do64, dout, kF32, 4, hd, s_len, hq, b, ds,
                             kF32Block);
  if (rc == 0) rc = make_map(&k16, k, kF32, 4, hd, t_len, kh, b, ks,
                             kWideUnit);
  if (rc == 0) rc = make_map(&v16, v, kF32, 4, hd, t_len, kh, b, vs,
                             kWideUnit);
  if (rc == 0) rc = launch_rows<float>(stream, o, dout, lse, q_pos, rows,
                                       bounds, b, s_len, hq, hd, os, ds);
  if (rc != 0) return rc;
  const size_t kv_bytes = F32WideKvLayout::kBytes;
  const size_t q_bytes = F32WideQLayout::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      bwd_dkdv_f32_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kv_bytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(bwd_dq_f32_wide_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)q_bytes);
  if (err != cudaSuccess) return (int)err;
  // one block a query head: its share goes to dK and dV when G = 1, else
  // to `part` ((B, T, Hq, hd) for dK, then for dV), summed by head after
  const int64_t group = hq / kh;
  if (group > 1 && part == nullptr) return (int)cudaErrorInvalidValue;
  float* share_k = group > 1 ? (float*)part : (float*)dk;
  float* share_v = group > 1 ? (float*)part + b * t_len * hq * hd
                             : (float*)dv;
  bwd_dkdv_f32_wide_kernel
      <<<dim3((unsigned)hq, (unsigned)b,
              (unsigned)((t_len + kF32Block - 1) / kF32Block)),
         kF32Threads, kv_bytes, stream>>>(
          q16, do16, k64, v64, (const float*)rows, (const int32_t*)q_pos,
          (const int32_t*)bounds, share_k, share_v, s_len, t_len, group, hd,
          causal, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (group > 1) {
    const int64_t n = b * t_len * kh * hd;
    const int64_t blocks = (n + kThreads - 1) / kThreads;
    bwd_group_sum_kernel<float>
        <<<(unsigned)(blocks < 4096 ? blocks : 4096), kThreads, 0, stream>>>(
        share_k, share_v, (float*)dk, (float*)dv, n, group, hd);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  bwd_dq_f32_wide_kernel
      <<<dim3((unsigned)hq, (unsigned)b,
              (unsigned)((s_len + kF32Block - 1) / kF32Block)),
         kF32Threads, q_bytes, stream>>>(
          q64, do64, k16, v16, (const float*)rows, (const int32_t*)q_pos,
          (const int32_t*)bounds, (float*)dq, s_len, t_len, hq / kh, hd,
          causal, window, scale);
  return (int)cudaGetLastError();
}

int launch_bf16_bwd_wide(cudaStream_t stream, const void* q, const void* k,
                         const void* v, const void* o, const void* dout,
                         const void* lse, const void* q_pos, void* dq,
                         void* dk, void* dv, void* rows, void* bounds,
                         void* part, int64_t b, int64_t s_len, int64_t t_len,
                         int64_t hq, int64_t kh, int64_t hd, Strides qs,
                         Strides ks, Strides vs, Strides os, Strides ds,
                         int causal, int64_t window, float scale) {
  // both passes read every operand in boxes of 64 rows
  CUtensorMap q64, do64, k64, v64;
  int rc = make_map(&q64, q, kBf16, 2, hd, s_len, hq, b, qs, kTile);
  if (rc == 0) rc = make_map(&do64, dout, kBf16, 2, hd, s_len, hq, b, ds,
                             kTile);
  if (rc == 0) rc = make_map(&k64, k, kBf16, 2, hd, t_len, kh, b, ks, kTile);
  if (rc == 0) rc = make_map(&v64, v, kBf16, 2, hd, t_len, kh, b, vs, kTile);
  if (rc == 0) rc = launch_rows<__nv_bfloat16>(stream, o, dout, lse, q_pos,
                                               rows, bounds, b, s_len, hq, hd,
                                               os, ds);
  if (rc != 0) return rc;
  const size_t bytes = Bf16WideBwdLayout::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      bwd_dkdv_bf16_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(bwd_dq_bf16_wide_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err != cudaSuccess) return (int)err;
  // one block a query head: its share goes to dK and dV when G = 1, else
  // to `part` ((B, T, Hq, hd) f32 for dK, then for dV), summed by head
  // and rounded to bf16 after
  const int64_t group = hq / kh;
  if (group > 1 && part == nullptr) return (int)cudaErrorInvalidValue;
  float* part_k = group > 1 ? (float*)part : nullptr;
  float* part_v = group > 1 ? (float*)part + b * t_len * hq * hd : nullptr;
  bwd_dkdv_bf16_wide_kernel
      <<<dim3((unsigned)hq, (unsigned)b,
              (unsigned)((t_len + kTile - 1) / kTile)),
         kTcThreads, bytes, stream>>>(
          q64, do64, k64, v64, (const float*)rows, (const int32_t*)q_pos,
          (const int32_t*)bounds, (__nv_bfloat16*)dk, (__nv_bfloat16*)dv,
          part_k, part_v, s_len, t_len, group, hd, causal, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (group > 1) {
    const int64_t n = b * t_len * kh * hd;
    const int64_t blocks = (n + kThreads - 1) / kThreads;
    bwd_group_sum_kernel<__nv_bfloat16>
        <<<(unsigned)(blocks < 4096 ? blocks : 4096), kThreads, 0, stream>>>(
            part_k, part_v, (__nv_bfloat16*)dk, (__nv_bfloat16*)dv, n, group,
            hd);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  bwd_dq_bf16_wide_kernel
      <<<dim3((unsigned)hq, (unsigned)b,
              (unsigned)((s_len + kTile - 1) / kTile)),
         kTcThreads, bytes, stream>>>(
          q64, do64, k64, v64, (const float*)rows, (const int32_t*)q_pos,
          (const int32_t*)bounds, (__nv_bfloat16*)dq, s_len, t_len, group,
          hd, causal, window, scale);
  return (int)cudaGetLastError();
}

int check_shape(int64_t b, int64_t s_len, int64_t t_len, int64_t hq,
                int64_t kh, int64_t hd, int64_t block, int64_t max_hd) {
  if (b < 1 || s_len < 1 || t_len < 1 || kh < 1 || hq < kh || hq % kh ||
      hd < 1 || hd > max_hd || hq > 65535 || b > 65535 ||
      (s_len + block - 1) / block > 65535 ||
      (t_len + block - 1) / block > 65535) {
    return (int)cudaErrorInvalidConfiguration;
  }
  return 0;
}

}  // namespace

// q, o, dO (B, S, Hq, hd) and k, v (B, T, Kh, hd), bf16 or f32 by the
// entry, read through their (batch, seq, head) strides with the head dim
// contiguous, 16-byte aligned bases and strides (TMA reads q and dO or k
// and v, pass 1 o and dO by 16-byte words); dq, dk, dv contiguous; lse (B,
// Hq, S) f32; rows a (B, Hq, S padded to 64, 2) f32 scratch; q_pos (S,)
// int32; bounds a (2 * ceil(S / 64),) int32 scratch; part a (2, B, T, Hq,
// hd) f32 scratch for 128 < hd <= 256 with G > 1, else null.  Three kernels on `stream` (four for that case: the G heads'
// shares of dK and dV summed last); returns cudaGetLastError() after them,
// or the error of a check.
extern "C" int flash_attention_bwd_f32(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, const void* q_pos, void* dq, void* dk,
    void* dv, void* rows, void* bounds, void* part, int64_t b, int64_t s_len,
    int64_t t_len, int64_t hq, int64_t kh, int64_t hd, int64_t q_sb,
    int64_t q_ss, int64_t q_sh, int64_t k_sb, int64_t k_st, int64_t k_sh,
    int64_t v_sb, int64_t v_st, int64_t v_sh, int64_t o_sb, int64_t o_ss,
    int64_t o_sh, int64_t d_sb, int64_t d_ss, int64_t d_sh, int64_t causal,
    int64_t window, float scale, int64_t device, void* stream) {
  cudaError_t err = cudaSetDevice((int)device);
  if (err != cudaSuccess) return (int)err;
  const int bad = check_shape(b, s_len, t_len, hq, kh, hd, kF32Block, 256);
  if (bad) return bad;
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_st, k_sh},
      vs{v_sb, v_st, v_sh}, os{o_sb, o_ss, o_sh}, ds{d_sb, d_ss, d_sh};
  const int c = causal ? 1 : 0;
  if (hd > 128) {
    return launch_f32_bwd_wide((cudaStream_t)stream, q, k, v, o, dout, lse,
                               q_pos, dq, dk, dv, rows, bounds, part, b, s_len,
                               t_len, hq, kh, hd, qs, ks, vs, os, ds, c,
                               window, scale);
  }
  if (hd <= 64) {
    return launch_f32_bwd<64>((cudaStream_t)stream, q, k, v, o, dout, lse,
                              q_pos, dq, dk, dv, rows, bounds, b, s_len,
                              t_len, hq, kh, hd, qs, ks, vs, os, ds, c,
                              window, scale);
  }
  return launch_f32_bwd<128>((cudaStream_t)stream, q, k, v, o, dout, lse,
                             q_pos, dq, dk, dv, rows, bounds, b, s_len,
                             t_len, hq, kh, hd, qs, ks, vs, os, ds, c,
                             window, scale);
}

extern "C" int flash_attention_bwd_bf16(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, const void* q_pos, void* dq, void* dk,
    void* dv, void* rows, void* bounds, void* part, int64_t b, int64_t s_len,
    int64_t t_len, int64_t hq, int64_t kh, int64_t hd, int64_t q_sb,
    int64_t q_ss, int64_t q_sh, int64_t k_sb, int64_t k_st, int64_t k_sh,
    int64_t v_sb, int64_t v_st, int64_t v_sh, int64_t o_sb, int64_t o_ss,
    int64_t o_sh, int64_t d_sb, int64_t d_ss, int64_t d_sh, int64_t causal,
    int64_t window, float scale, int64_t device, void* stream) {
  cudaError_t err = cudaSetDevice((int)device);
  if (err != cudaSuccess) return (int)err;
  const int bad = check_shape(b, s_len, t_len, hq, kh, hd,
                              hd > 128 ? kTile : kTcBlock, 256);
  if (bad) return bad;
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_st, k_sh},
      vs{v_sb, v_st, v_sh}, os{o_sb, o_ss, o_sh}, ds{d_sb, d_ss, d_sh};
  const int c = causal ? 1 : 0;
  if (hd > 128) {
    return launch_bf16_bwd_wide((cudaStream_t)stream, q, k, v, o, dout, lse,
                                q_pos, dq, dk, dv, rows, bounds, part, b,
                                s_len, t_len, hq, kh, hd, qs, ks, vs, os, ds,
                                c, window, scale);
  }
  if (hd <= 64) {
    return launch_tc_bwd<64>((cudaStream_t)stream, q, k, v, o, dout, lse,
                             q_pos, dq, dk, dv, rows, bounds, b, s_len, t_len,
                             hq, kh, hd, qs, ks, vs, os, ds, c, window, scale);
  }
  return launch_tc_bwd<128>((cudaStream_t)stream, q, k, v, o, dout, lse,
                            q_pos, dq, dk, dv, rows, bounds, b, s_len, t_len,
                            hq, kh, hd, qs, ks, vs, os, ds, c, window, scale);
}
