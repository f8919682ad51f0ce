// Causal flash attention with an optional sliding window and GQA,
// hand-written for Hopper.
//
// Replaces: the Pallas TPU kernel `flash_attention_kernel` (body
// `_flash_kernel`) in src/repro/kernels/flash_attention/kernel.py, and on
// the LM's prefill path the pure-JAX online-softmax scan `flash_attention`
// in src/repro/models/lm/attention.py.
//
// With a non-null `lse` both routes also write each row's log-sum-exp of
// the scaled scores, (B, Hq, S) f32, which the backward pass
// (flash_attention_bwd.cu) reads; the output is the same bit for bit
// with or without it.
//
// Computes, for every batch b, query head h and query row i:
//   s_j = (q_i . k_j) * scale                      (float32; scale = hd^-0.5)
//   s_j = NEG_INF (the finite -1e30) where key j is masked:
//         causal: j <= pos_i;  window > 0: j > pos_i - window
//   o_i = sum_j softmax(s)_j v_j                   (in q's dtype)
// by the online softmax over key tiles (32 keys on the f32 route, 128 on
// the bf16 route), with (m, l, acc) in float32 and o = acc / max(l, 1e-30),
// as the TPU kernel does.  Key positions are 0 .. T-1; query positions come
// from `q_pos` (0 .. S-1 on prefill).  Query head h reads KV head h / G
// (G = Hq / Kh), the grouping of the reference's reshape (B, S, Kh, G, hd):
// KV is never repeated in memory.  q, k, v and o are read and written
// through their (batch, seq, head) strides, so the model's (B, S, H, hd)
// tensors need no transpose.
//
// Tile skipping: a group of 64 query rows visits only the key tiles that
// meet the band [min pos - window + 1, max pos] of its rows, so the window
// path costs O(S * W), not O(S^2).  Under the finite sentinel this gives
// the same result as visiting every tile: a row whose first visited tile is
// fully masked accumulates junk (p = exp(0) = 1), and its first valid tile
// wipes it (corr = exp(-1e30 - m) = 0).  Rows with no valid key at all (only
// possible when pos_i >= T + window - 1 or pos_i < 0) come out 0 when their
// group visits no tile; the LM never makes such rows.
//
// What bounds it on the H100: operations.  At the H2O-Danube-3-4B prefill
// (B = 4, Hq = 32, Kh = 8, S = T = 8192, hd = 120, window 4096, bf16) a
// layer has 3.22e9 unmasked (query, key) pairs, 480 flops each over the two
// products: 1.55 TFLOP, 1.57 ms at the 989 TFLOP/s bf16 tensor-core peak,
// against 0.63 GB of q/k/v/o traffic, 0.19 ms at 3.35 TB/s.
//
// Two routes, by the inputs' type, each at hd padded to 64 or 128 as
// below and, for 128 < hd <= 256, in a wide form at hd padded to 256 (the
// sections "f32 route, 128 < hd <= 256" and "bf16 route, 128 < hd <=
// 256" at their kernels):
//
// bf16 (the serving path): both products on the tensor cores.  A block of
// 288 threads owns 128 query rows of one (batch, head): two consumer
// warpgroups of 64 rows each and one producer warp.  The producer's lane 0
// loads the Q tile once and then the K/V tiles of the block's band into a
// ring of 2 stages by TMA, each stage tracked by a "full" mbarrier (the
// copy's bytes) and an "empty" one (the 8 consumer warps' releases), so
// tile j+1 arrives while tile j is computed.  Tiles are 128 keys by hd
// padded to 64 or 128 columns; every tile is stored as 128-byte rows under
// the 128-byte swizzle, in 64-column chunks, the layout `wgmma` reads.  The
// tensor maps keep head_dim as a dimension of its own, of size hd, so the
// pad columns of Q, K and V are out of bounds and arrive as zeros; rows
// past S or T arrive as zeros too.  Per tile a consumer warpgroup runs
//   S = Q K^T       wgmma m64n128k16, Q and K from shared memory (K-major),
//   p = exp2(S * scale * log2 e - m)   in f32 registers, masked as above,
//   O += P V        wgmma m64n{64,128}k16, P from registers, V from shared
//                   memory (MN-major, transposed by the instruction),
// with P rounded to bf16 for the second product: this departs from the
// reference, which multiplies f32 P by V (the TPU kernel's `pv` and the
// LM's `attention`).  The row sum l is taken over the unrounded f32 p, as
// the reference does; the rescale, (m, l) and o = acc / max(l, 1e-30) stay
// in f32, and o is stored as bf16.  The exponent base-2 form folds the
// scale into one multiply per score; the sentinel becomes -1e30 * log2 e,
// which keeps the skipping argument above.  Masks are applied by selects,
// only in warps that meet a masked key, and the loop bounds are made
// warp-uniform, so ptxas sees no divergent path around the asynchronous
// products (a branch per lane there ran markedly slower).  The two
// warpgroups overlap each other's softmax and products; a warpgroup does
// not yet overlap its own (that needs more than the 168 registers a thread
// has at 288 threads, and it serialised the products when tried).  Shared
// memory: Q 32 KB plus 64 KB a stage at hd 128, 160 KB in all; one block
// per SM.
//
// f32: split-TF32 products on the tensor cores.  The same 128-row blocks
// of two warpgroups, TMA ring of 2 stages, masking and band skipping as
// the bf16 route, and the reference's f32 P (never rounded to bf16), but
// no producer warp: thread 0 issues the copies (see Registers below).
// What bounds it: operations.  Each f32 product a.b is taken as
// a_hi b_hi + a_hi b_lo + a_lo b_hi, where a_hi is a rounded to TF32
// (cvt.rna, 10 mantissa bits) and a_lo = a - a_hi exactly in f32; the
// tensor core reads the top 19 bits of each operand, so it reads a_hi
// exactly and a_lo truncated, and
// the dropped a_lo b_lo leaves ~2^-22 of each product.  This departs from
// f32 FMA, but holds the route's 2e-5 against the f32 plain version
// (`ref.py::attention_split_tf32` emulates the operands' split on the CPU,
// where the tests hold it to the reference; it does not emulate the
// tensor core's own sums, below).  At the Danube layer above in f32 that is
// 3 x 1.55 TFLOP of TF32 products, 9.37 ms at the 495 TFLOP/s TF32 peak,
// against 1.26 GB of q/k/v/o traffic, 0.38 ms; 1.55 TFLOP of f32 FMA on the
// CUDA cores (67 TFLOP/s) would take 23.08 ms.  No setting of
// torch.backends.cuda.matmul.allow_tf32 reaches it: the split is the
// kernel's own.
//
// Operand layouts.  wgmma takes .tf32 operands from shared memory only
// K-major (no transpose bit, unlike bf16).  Per 32-key tile a consumer
// warpgroup runs
//   Q_hi K_lo^T | Q_hi K_hi^T         m64n64k8: Q_hi and K's 64 rows (the
//                                     32 keys' lo, then their hi) from
//                                     shared memory, both as loaded
//                                     (hd contiguous: K-major);
//   Q_lo K_hi^T                       m64n32k8, Q_lo from registers, into
//                                     the Q_hi K_lo^T registers;
//   p = exp2(S * scale * log2 e - m)  f32, masked as the bf16 route;
//   T = P_hi V_hi + P_hi V_lo + P_lo V_hi   m64n64k8 per 64 columns of the
//                                     head, P split in registers (the A
//                                     operand), V^T from shared memory;
//   O = O * corr + T                  f32 FMA in registers.
// The tensor core truncates the sums it accumulates.  Left to accumulate
// O over a row's 128 tiles (and the small terms of S together with the
// large one), that cost 1.5e-5 at the Danube layer, 11 times the error of
// f32 FMA on the CUDA cores; so each sum the tensor core takes is short
// (32 keys, or hd) and the parts meet in f32 adds, as the split-TF32
// GEMMs of Ootomo and Yokota (2022) do: 2.6e-6 at the same layer.
// V's tile as loaded is MN-major for O += P V, so the consumers write it
// transposed (V^T: hd rows of the tile's 32 keys, one 128-byte swizzled
// row each) together with its split.  The other way out, O^T = V^T P^T
// with V^T split in registers, would have each warpgroup split V again
// and its accumulator indexed by query columns, which makes the rescale
// a shared-memory exchange.  The accumulator layout of S holds keys 2
// quad, 2 quad + 1 of each 8-key step where the TF32 A layout wants
// columns quad, quad + 4, so V^T's keys are stored in the order 0 2 4 6
// 1 3 5 7 within each 8 and the registers go over as they are.  Q is split
// once per block: each thread rounds its own A-fragment elements in
// place and keeps their lo.  Each tile is split once for both
// warpgroups: all 256 threads round K in place and write its lo and
// V^T's hi and lo, then meet at a block barrier (after fence.proxy.async:
// wgmma reads shared memory through the async proxy), after which thread 0
// loads tile j + 1 into the stage tile j - 1 has released.
//
// Shared memory at hd padded to 128: Q 64 KB (128 rows, hi in place);
// a stage 80 KB (K 16 KB + its lo 16 KB, V 16 KB as loaded, V^T hi and
// lo 16 KB each); two stages; 224 KB in all of the 227 KB, one block per
// SM.  32-key tiles are what fits two stages: at 64 keys one stage is
// 160 KB.  Keeping Q_lo in shared memory too (another 64 KB) would leave
// room for one stage, so it stays in registers.  Registers per thread:
// O 64, Q_lo 64, the scores 32 (S's two parts, then P_hi and P_lo), the
// tile's T 32: 192 before addresses and temporaries; ptxas takes 254 at
// hd 128 (185 at 64) and spills none.  An SM's registers sit in four
// partitions, one per warp scheduler: with a producer warp (9 warps, 3 on
// one partition) ptxas gave each thread 168 and spilled 572 bytes,
// serialising the products; at 8 warps a thread may hold 255.  Splitting
// tile j + 1 while tile j's P V runs was tried and dropped: it spilled 28
// bytes and ran no faster.
#include <cuda.h>
#include <limits.h>
#include <math_constants.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1e30f;

// ----------------------------------------------------------- bf16 route --

constexpr int kTcRows = 128;            // query rows per block
constexpr int kTcKeys = 128;            // keys per tile
constexpr int kTcStages = 2;            // K/V tiles in flight
constexpr int kTcConsumerWarps = 8;     // two warpgroups of 64 rows
constexpr int kTcThreads = 32 * (kTcConsumerWarps + 1);   // + the producer

template <int HD_PAD>
struct TcLayout {
  static constexpr int kChunks = HD_PAD / 64;         // 64-column chunks
  static constexpr int kQChunk = kTcRows * kSwizzleRow;
  static constexpr int kKVChunk = kTcKeys * kSwizzleRow;
  static constexpr int kQBytes = kChunks * kQChunk;
  static constexpr int kKVBytes = kChunks * kKVChunk;  // one K or V tile
  static constexpr int kOffK = kQBytes;
  static constexpr int kOffV = kOffK + kTcStages * kKVBytes;
  static constexpr int kOffBar = kOffV + kTcStages * kKVBytes;
  // Q, the K and V rings, 1 + 2 * stages mbarriers, slack to align to 1 KB
  static constexpr size_t kBytes = kOffBar + 8 * (1 + 2 * kTcStages) + 1024;
};

// The forward's optional second output, the per-row log-sum-exp of the
// scaled scores in natural units, L = m ln 2 + log(max(l, 1e-30)) (m is
// the row max in base-2 units), for the backward pass.  lse is (B, Hq, S)
// f32; a quad's lane 0 writes its rows `row` and `row` + 8.  It reads what
// the output already computed and changes nothing of it.
__device__ __forceinline__ void store_lse(float* lse, int b, int h,
                                          int64_t s_len, int64_t row,
                                          int quad, float m_a, float m_b,
                                          float den_a, float den_b) {
  constexpr float kLn2 = 0.6931471805599453f;
  if (quad != 0) return;
  float* lb = lse + ((int64_t)b * gridDim.y + h) * s_len;
  if (row < s_len) lb[row] = fmaf(m_a, kLn2, logf(den_a));
  if (row + 8 < s_len) lb[row + 8] = fmaf(m_b, kLn2, logf(den_b));
}

template <int HD_PAD>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_tc_kernel(const __grid_constant__ CUtensorMap q_map,
                const __grid_constant__ CUtensorMap k_map,
                const __grid_constant__ CUtensorMap v_map,
                __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                const int32_t* __restrict__ q_pos, int64_t s_len,
                int64_t t_len, int64_t group, int64_t hd, Strides os,
                int causal, int64_t window, float scale) {
  using L = TcLayout<HD_PAD>;
  constexpr int kChunks = L::kChunks;
  constexpr int kNS = kTcKeys / 2;          // score registers per thread
  extern __shared__ uint8_t smem_raw[];
  __shared__ int32_t pos_s[kTcRows];
  __shared__ int32_t pmin_s[kTcRows / 32], pmax_s[kTcRows / 32];

  // 128-byte swizzled tiles need 1 KB alignment
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t q_base = base;
  const uint32_t k_base = base + L::kOffK;
  const uint32_t v_base = base + L::kOffV;
  const uint32_t bar_q = base + L::kOffBar;                 // Q arrived
  const uint32_t bar_full = bar_q + 8;                      // [stage]
  const uint32_t bar_empty = bar_full + 8 * kTcStages;      // [stage]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int64_t n_qt = (s_len + kTcRows - 1) / kTcRows;
  // the last query tiles have the longest bands: launch them first
  const int64_t q0 = (n_qt - 1 - (int64_t)blockIdx.x) * kTcRows;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (int)group;     // 32-bit: no division call

  if (tid < kTcRows) {
    const bool valid = q0 + tid < s_len;
    const int32_t p = valid ? q_pos[q0 + tid] : 0;
    pos_s[tid] = p;
    int32_t mn = valid ? p : INT_MAX, mx = valid ? p : INT_MIN;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      mn = min(mn, __shfl_xor_sync(0xffffffffu, mn, off));
      mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    }
    if (lane == 0) {
      pmin_s[warp] = mn;
      pmax_s[warp] = mx;
    }
  }
  if (tid == kTcConsumerWarps * 32) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kTcStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, kTcConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // each warpgroup's band, and the block's: the union of the two
  int64_t lo[2], hi[2];
#pragma unroll
  for (int w = 0; w < 2; ++w) {
    key_band(min(pmin_s[2 * w], pmin_s[2 * w + 1]),
             max(pmax_s[2 * w], pmax_s[2 * w + 1]), t_len, causal, window,
             lo[w], hi[w]);
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
      0xffffffffu, (int)(b_hi >= 0 ? b_lo / kTcKeys * kTcKeys : 0), 0);
  const int n_tiles = __shfl_sync(
      0xffffffffu, (int)(b_hi >= 0 ? (b_hi - kt0) / kTcKeys + 1 : 0), 0);

  if (warp == kTcConsumerWarps) {
    // ---- producer: lane 0 issues every copy ----
    if (lane == 0) {
      mbar_expect_tx(bar_q, L::kQBytes);
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        tma_load_4d(q_base + c * L::kQChunk, &q_map, bar_q, 64 * c, (int)q0,
                    h, b);
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kTcStages;
        if (it >= kTcStages) {
          mbar_wait(bar_empty + 8 * s, (uint32_t)((it / kTcStages - 1) & 1));
        }
        const uint32_t full = bar_full + 8 * s;
        mbar_expect_tx(full, 2 * L::kKVBytes);
        const int kt = kt0 + it * kTcKeys;
#pragma unroll
        for (int c = 0; c < kChunks; ++c) {
          tma_load_4d(k_base + s * L::kKVBytes + c * L::kKVChunk, &k_map,
                      full, 64 * c, kt, kvh, b);
          tma_load_4d(v_base + s * L::kKVBytes + c * L::kKVChunk, &v_map,
                      full, 64 * c, kt, kvh, b);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 ----
  const int wg = __shfl_sync(0xffffffffu, warp >> 2, 0);
  const int r_a = 64 * wg + 16 * (warp & 3) + (lane >> 2);  // and r_a + 8
  const int quad = lane & 3;
  const int64_t pos_a = pos_s[r_a], pos_b = pos_s[r_a + 8];
  const float sl2 = scale * kLog2e;
  const float sentinel = kNegInf * kLog2e;
  const uint32_t q_wg = q_base + wg * 64 * kSwizzleRow;

  // the tiles this warpgroup visits, it_first .. it_last, are a run of
  // the block's; it still waits for and releases the others
  const int64_t w_lo = wg ? lo[1] : lo[0], w_hi = wg ? hi[1] : hi[0];
  int it_first = n_tiles, it_last = -1;
  if (w_lo <= w_hi && n_tiles > 0) {
    it_first = (int)((w_lo - kt0) / kTcKeys);
    it_last = (int)((w_hi - kt0) / kTcKeys);
    if (it_last > n_tiles - 1) it_last = n_tiles - 1;
  }
  it_first = __shfl_sync(0xffffffffu, it_first, 0);
  it_last = __shfl_sync(0xffffffffu, it_last, 0);

  float m_a = sentinel, m_b = sentinel, l_a = 0.0f, l_b = 0.0f;
  float acc[HD_PAD / 2], sc[kNS];
#pragma unroll
  for (int i = 0; i < HD_PAD / 2; ++i) acc[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < kNS; ++i) sc[i] = 0.0f;

  mbar_wait(bar_q, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % kTcStages;
    mbar_wait(bar_full + 8 * s, (uint32_t)((it / kTcStages) & 1));
    if (it >= it_first && it <= it_last) {
      const int64_t kt = kt0 + it * kTcKeys;
      const uint32_t k_s = k_base + s * L::kKVBytes;
      const uint32_t v_s = v_base + s * L::kKVBytes;

      // S = Q K^T: 16 columns of hd per step, 32 bytes into a 128-byte row
      fence_regs(sc);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < HD_PAD / 16; ++ks) {
        const uint32_t col = (ks % 4) * 32;
        wgmma_ss_n128(sc,
                      desc128(q_wg + (ks / 4) * L::kQChunk + col, 16, 1024),
                      desc128(k_s + (ks / 4) * L::kKVChunk + col, 16, 1024),
                      ks > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);

      // scale to log2 units; sc[i] is row r_a (i & 2 == 0) or r_a + 8,
      // key kt + 2 quad + 8 (i / 4) + (i & 1).  Where any lane of the warp
      // meets a masked key, mask by selects, with no branch per lane.
#pragma unroll
      for (int i = 0; i < kNS; ++i) sc[i] *= sl2;
      const bool open =
          tile_open<kTcKeys>(kt, pos_a, t_len, causal, window) &&
          tile_open<kTcKeys>(kt, pos_b, t_len, causal, window);
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
          const float x = (c <= hi_r && c >= lo_r) ? sc[i] : sentinel;
          sc[i] = c < t_rel ? x : -CUDART_INF_F;   // past T: not a key
        }
      }

      // online softmax; l sums this thread's share of the unrounded p
      float mx_a = -CUDART_INF_F, mx_b = -CUDART_INF_F;
#pragma unroll
      for (int i = 0; i < kNS; ++i) {
        if (i & 2) {
          mx_b = fmaxf(mx_b, sc[i]);
        } else {
          mx_a = fmaxf(mx_a, sc[i]);
        }
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
      }
      const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
      const float corr_a = exp2f(m_a - mn_a), corr_b = exp2f(m_b - mn_b);
      m_a = mn_a;
      m_b = mn_b;
      float sum_a = 0.0f, sum_b = 0.0f;
#pragma unroll
      for (int i = 0; i < kNS; ++i) {
        if (i & 2) {
          sc[i] = exp2f(sc[i] - mn_b);
          sum_b += sc[i];
        } else {
          sc[i] = exp2f(sc[i] - mn_a);
          sum_a += sc[i];
        }
      }
      l_a = l_a * corr_a + sum_a;
      l_b = l_b * corr_b + sum_b;
#pragma unroll
      for (int i = 0; i < HD_PAD / 2; ++i) acc[i] *= (i & 2) ? corr_b : corr_a;

      // P rounded to bf16 as A fragments: the accumulator layout of keys
      // 16 kk .. 16 kk + 15 is the A-operand layout of a k16 step
      uint32_t pa[kTcKeys / 16][4];
#pragma unroll
      for (int kk = 0; kk < kTcKeys / 16; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          pa[kk][j] = pack_bf16(sc[8 * kk + 2 * j], sc[8 * kk + 2 * j + 1]);

      // O += P V: 16 keys (2 KB of 128-byte rows) per step
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kTcKeys / 16; ++kk) {
        wgmma_pv<HD_PAD>(acc, pa[kk],
                         desc128(v_s + kk * 16 * kSwizzleRow, L::kKVChunk,
                                 1024));
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty + 8 * s);   // this warp is done
  }

  // o = acc / max(l, 1e-30) by the fast division (the result is rounded
  // to bf16), stored as bf16; rows past S and columns past hd are not
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  const float den_a = fmaxf(l_a, 1e-30f), den_b = fmaxf(l_b, 1e-30f);
  if (lse != nullptr) store_lse(lse, b, h, s_len, q0 + r_a, quad, m_a, m_b,
                                den_a, den_b);
  const bool pairs = ((hd | os.s | os.h | os.b) & 1) == 0;
  __nv_bfloat16* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int j = 0; j < HD_PAD / 8; ++j) {
    const int64_t d = 8 * j + 2 * quad;
    if (d >= hd) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int64_t row = q0 + r_a + 8 * half;
      if (row >= s_len) continue;
      const float den = half ? den_b : den_a;
      const float x0 = __fdividef(acc[4 * j + 2 * half], den);
      const float x1 = __fdividef(acc[4 * j + 2 * half + 1], den);
      __nv_bfloat16* dst = ob + row * os.s + d;
      if (pairs && d + 1 < hd) {
        *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(x0, x1);
      } else {
        dst[0] = __float2bfloat16_rn(x0);
        if (d + 1 < hd) dst[1] = __float2bfloat16_rn(x1);
      }
    }
  }
}

// ------------------------------------------------------------ f32 route --

constexpr int kF32Rows = 128;           // query rows per block, 64 a warpgroup
constexpr int kF32Keys = 32;            // keys a tile: a 128-byte row of V^T
constexpr int kF32Stages = 2;           // K/V tiles in flight
constexpr int kF32Threads = 256;        // two warpgroups, no producer warp
constexpr int kF32Cols = kSwizzleRow / 4;   // f32 columns in a 128-byte row

template <int HD_PAD>
struct F32Layout {
  static constexpr int kChunks = HD_PAD / kF32Cols;   // 32-column chunks
  static constexpr int kQChunk = kF32Rows * kSwizzleRow;         // 16 KB
  // K: rows 0..31 the tile's lo, rows 32..63 the tile (rounded to TF32 in
  // place)
  static constexpr int kKChunk = 2 * kF32Keys * kSwizzleRow;     // 8 KB
  static constexpr int kKHi = kF32Keys * kSwizzleRow;   // 4 KB: the hi rows
  static constexpr int kVChunk = kF32Keys * kSwizzleRow;         // 4 KB
  static constexpr int kQBytes = kChunks * kQChunk;
  static constexpr int kKBytes = kChunks * kKChunk;
  static constexpr int kVBytes = kChunks * kVChunk;
  static constexpr int kVtBytes = HD_PAD * kSwizzleRow;  // V^T hi, or lo
  static constexpr int kStage = kKBytes + kVBytes + 2 * kVtBytes;
  static constexpr int kOffStage = kQBytes;
  static constexpr int kOffBar = kOffStage + kF32Stages * kStage;
  // TMA bytes of one tile: K and V as loaded
  static constexpr uint32_t kTx = 2 * kChunks * kF32Keys * kSwizzleRow;
  // Q, the stages, 1 + stages mbarriers, slack to align to 1 KB
  static constexpr size_t kBytes = kOffBar + 8 * (1 + kF32Stages) + 1024;
};

// D (64 x 64, f32) += A (64 x 8, tf32, K-major) * B (64 x 8, tf32, K-major),
// both from shared memory through their descriptors; scale_d = 0 ignores D
__device__ __forceinline__ void wgmma_tf32_ss_n64(float (&d)[32], uint64_t da,
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 32, f32) += A (64 x 8, tf32 in registers) * B (32 x 8, tf32,
// K-major in shared memory through its descriptor); D is d[0..15], the
// columns 0..31 of an n64 accumulator (ptxas serialises the products when
// it is the upper half); scale_d = 0 ignores D
__device__ __forceinline__ void wgmma_tf32_rs_n32(float (&d)[32], uint32_t a0,
                                                uint32_t a1, uint32_t a2,
                                                uint32_t a3, uint64_t db,
                                                int scale_d) {
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

// T (64 x 64) (+)= P (64 x 8) V (8 x 64) for 8 keys of the tile from the
// score registers p[i0 + 4 j .. i0 + 4 j + 3] (rows r, r, r + 8, r + 8;
// keys 2 quad, 2 quad + 1 of the step): the TF32 A layout holds columns
// quad and quad + 4, so column c of the step is key 2c (c < 4) or
// 2(c - 4) + 1, the order V^T's keys are stored in
__device__ __forceinline__ void wgmma_tf32_pv_step(float (&t)[32],
                                                   const float (&p)[32],
                                                   int i0, int j, uint64_t db,
                                                   int scale_d) {
  const int i = i0 + 4 * j;
  wgmma_tf32_rs_n64(t, __float_as_uint(p[i]), __float_as_uint(p[i + 2]),
                    __float_as_uint(p[i + 1]), __float_as_uint(p[i + 3]), db,
                    scale_d);
}

template <int HD_PAD>
__global__ void __launch_bounds__(kF32Threads, 1)
flash_f32_tc_kernel(const __grid_constant__ CUtensorMap q_map,
                    const __grid_constant__ CUtensorMap k_map,
                    const __grid_constant__ CUtensorMap v_map,
                    float* __restrict__ o, float* __restrict__ lse,
                    const int32_t* __restrict__ q_pos, int64_t s_len,
                    int64_t t_len, int64_t group, int64_t hd, Strides os,
                    int causal, int64_t window, float scale) {
  using L = F32Layout<HD_PAD>;
  constexpr int kChunks = L::kChunks;
  constexpr int kKS = HD_PAD / 8;            // k8 steps of Q K^T
  constexpr int kNS = kF32Keys / 2;          // score registers per thread
  extern __shared__ uint8_t smem_raw[];
  __shared__ int32_t pos_s[kF32Rows];
  __shared__ int32_t pmin_s[kF32Rows / 32], pmax_s[kF32Rows / 32];

  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t q_base = base;
  const uint32_t stage0 = base + L::kOffStage;
  const uint32_t bar_q = base + L::kOffBar;
  const uint32_t bar_full = bar_q + 8;                      // [stage]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int64_t n_qt = (s_len + kF32Rows - 1) / kF32Rows;
  // the last query tiles have the longest bands: launch them first
  const int64_t q0 = (n_qt - 1 - (int64_t)blockIdx.x) * kF32Rows;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (int)group;

  if (tid < kF32Rows) {
    const bool valid = q0 + tid < s_len;
    const int32_t p = valid ? q_pos[q0 + tid] : 0;
    pos_s[tid] = p;
    int32_t mn = valid ? p : INT_MAX, mx = valid ? p : INT_MIN;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      mn = min(mn, __shfl_xor_sync(0xffffffffu, mn, off));
      mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    }
    if (lane == 0) {
      pmin_s[warp] = mn;
      pmax_s[warp] = mx;
    }
  }
  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kF32Stages; ++s) mbar_init(bar_full + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  int64_t lo[2], hi[2];
#pragma unroll
  for (int w = 0; w < 2; ++w) {
    key_band(min(pmin_s[2 * w], pmin_s[2 * w + 1]),
             max(pmax_s[2 * w], pmax_s[2 * w + 1]), t_len, causal, window,
             lo[w], hi[w]);
  }
  int64_t b_lo = INT64_MAX, b_hi = -1;
#pragma unroll
  for (int w = 0; w < 2; ++w) {
    if (lo[w] <= hi[w]) {
      b_lo = lo[w] < b_lo ? lo[w] : b_lo;
      b_hi = hi[w] > b_hi ? hi[w] : b_hi;
    }
  }
  const int kt0 = __shfl_sync(
      0xffffffffu, (int)(b_hi >= 0 ? b_lo / kF32Keys * kF32Keys : 0), 0);
  const int n_tiles = __shfl_sync(
      0xffffffffu, (int)(b_hi >= 0 ? (b_hi - kt0) / kF32Keys + 1 : 0), 0);

  // Thread 0 issues every copy: Q and the first tile now, tile it + 1
  // once every thread has passed tile it's split (below), when the stage
  // it takes has been read for the last time (by tile it - 1's products).
  const auto load_tile = [&](int it) {
    const int s = it % kF32Stages;
    const uint32_t full = bar_full + 8 * s;
    const uint32_t k_s = stage0 + s * L::kStage;
    const uint32_t v_s = k_s + L::kKBytes;
    const int kt = kt0 + it * kF32Keys;
    mbar_expect_tx(full, L::kTx);
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      tma_load_4d(k_s + c * L::kKChunk + L::kKHi, &k_map, full, kF32Cols * c,
                  kt, kvh, b);
      tma_load_4d(v_s + c * L::kVChunk, &v_map, full, kF32Cols * c, kt, kvh,
                  b);
    }
  };
  if (tid == 0) {
    mbar_expect_tx(bar_q, L::kQBytes);
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      tma_load_4d(q_base + c * L::kQChunk, &q_map, bar_q, kF32Cols * c,
                  (int)q0, h, b);
    }
    if (n_tiles > 0) load_tile(0);
  }

  // ---- warpgroup wg owns rows 64 wg .. 64 wg + 63 ----
  const int wg = __shfl_sync(0xffffffffu, warp >> 2, 0);
  const int r_a = 64 * wg + 16 * (warp & 3) + (lane >> 2);  // and r_a + 8
  const int quad = lane & 3;
  const int64_t pos_a = pos_s[r_a], pos_b = pos_s[r_a + 8];
  const float sl2 = scale * kLog2e;
  const float sentinel = kNegInf * kLog2e;
  const uint32_t q_wg = q_base + wg * 64 * kSwizzleRow;

  const int64_t w_lo = wg ? lo[1] : lo[0], w_hi = wg ? hi[1] : hi[0];
  int it_first = n_tiles, it_last = -1;
  if (w_lo <= w_hi && n_tiles > 0) {
    it_first = (int)((w_lo - kt0) / kF32Keys);
    it_last = (int)((w_hi - kt0) / kF32Keys);
    if (it_last > n_tiles - 1) it_last = n_tiles - 1;
  }
  it_first = __shfl_sync(0xffffffffu, it_first, 0);
  it_last = __shfl_sync(0xffffffffu, it_last, 0);

  // Split Q once: each thread rounds the elements of its own A fragments
  // (rows r_a, r_a + 8; columns 8 ks + quad, + 4) to TF32 in place and
  // keeps their lo in registers, the A operand of Q_lo K_hi^T.  The
  // fragments of a warpgroup cover its 64 rows exactly; the first tile's
  // barrier below orders these writes before any product reads them.
  mbar_wait(bar_q, 0);
  float qlo[HD_PAD / 2];
#pragma unroll
  for (int ks = 0; ks < kKS; ++ks) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r_a + 8 * (e & 1);
      const int col = 8 * ks + quad + 4 * (e >> 1);
      const uint32_t a = q_base + (col / kF32Cols) * L::kQChunk +
                         swz_f32(row, col % kF32Cols);
      const float x = lds_f32(a);
      const float x_hi = tf32_hi(x);
      sts_f32(a, x_hi);
      qlo[4 * ks + e] = x - x_hi;
    }
  }

  float m_a = sentinel, m_b = sentinel, l_a = 0.0f, l_b = 0.0f;
  // sp[0..15]: Q_hi K_lo^T + Q_lo K_hi^T, then P_hi; sp[16..31]: Q_hi
  // K_hi^T, then P_lo; t: one tile's P V over 64 columns of the head
  float acc[HD_PAD / 2], sp[2 * kNS], t[32];
#pragma unroll
  for (int i = 0; i < HD_PAD / 2; ++i) acc[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < 2 * kNS; ++i) sp[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < 32; ++i) t[i] = 0.0f;

  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % kF32Stages;
    const uint32_t k_s = stage0 + s * L::kStage;
    const uint32_t v_s = k_s + L::kKBytes;
    const uint32_t vt_hi = v_s + L::kVBytes;
    const uint32_t vt_lo = vt_hi + L::kVtBytes;
    mbar_wait(bar_full + 8 * s, (uint32_t)((it / kF32Stages) & 1));

    // Split the tile, shared by both warpgroups.  K (32 keys x 128-byte
    // rows a chunk): hi in place, lo 32 rows above, the same swizzle.
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const uint32_t a = k_s + c * L::kKChunk + L::kKHi + 16 * tid;
      const float4 x = lds_f32x4(a);
      const float4 x_hi = tf32_hi4(x);
      sts_f32x4(a, x_hi);
      sts_f32x4(a - L::kKHi, sub4(x, x_hi));
    }
    // V (keys x hd) to V^T (hd rows of 32 keys, K-major for wgmma's B):
    // 16-byte unit u of row d holds keys 8 (u / 2) + (u & 1) + 2 w, w =
    // 0..3, the order of the A fragments (wgmma_tf32_pv_step).  A warp
    // takes 32 consecutive d at one u: its reads cover one 128-byte row of
    // V, its 16-byte writes 8 rows of distinct swizzle, no bank conflict.
#pragma unroll
    for (int m = 0; m < HD_PAD * 8 / kF32Threads; ++m) {
      const int i = tid + m * kF32Threads;
      const int d = i % HD_PAD, u = i / HD_PAD;
      const int key0 = 8 * (u >> 1) + (u & 1);
      const uint32_t src = v_s + (d / kF32Cols) * L::kVChunk;
      float4 x;
      x.x = lds_f32(src + swz_f32(key0, d % kF32Cols));
      x.y = lds_f32(src + swz_f32(key0 + 2, d % kF32Cols));
      x.z = lds_f32(src + swz_f32(key0 + 4, d % kF32Cols));
      x.w = lds_f32(src + swz_f32(key0 + 6, d % kF32Cols));
      const float4 x_hi = tf32_hi4(x);
      const uint32_t dst = swz_f32(d, 4 * u);
      sts_f32x4(vt_hi + dst, x_hi);
      sts_f32x4(vt_lo + dst, sub4(x, x_hi));
    }
    fence_proxy_async();
    __syncthreads();
    if (tid == 0 && it + 1 < n_tiles) load_tile(it + 1);

    if (it >= it_first && it <= it_last) {
      const int64_t kt = kt0 + it * kF32Keys;

      // S = Q_hi K_hi^T + (Q_hi K_lo^T + Q_lo K_hi^T).  One n64 product
      // against K's 64 rows (lo, hi) gives Q_hi K_lo^T in sp[0..15] and
      // Q_hi K_hi^T in sp[16..31]; Q_lo from registers adds its term to
      // the former.  The tensor core truncates its sums, so the small terms
      // accumulate apart from the large one and meet it in one f32 add.
      fence_regs(sp);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kKS; ++ks) {
        const uint32_t col = (ks % 4) * 32;
        wgmma_tf32_ss_n64(
            sp, desc128(q_wg + (ks / 4) * L::kQChunk + col, 16, 1024),
            desc128(k_s + (ks / 4) * L::kKChunk + col, 16, 1024), ks > 0);
      }
#pragma unroll
      for (int ks = 0; ks < kKS; ++ks) {
        const uint32_t col = (ks % 4) * 32;
        wgmma_tf32_rs_n32(sp, __float_as_uint(qlo[4 * ks]),
                          __float_as_uint(qlo[4 * ks + 1]),
                          __float_as_uint(qlo[4 * ks + 2]),
                          __float_as_uint(qlo[4 * ks + 3]),
                          desc128(k_s + (ks / 4) * L::kKChunk + L::kKHi + col,
                                  16, 1024), 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sp);

      // scores in log2 units; sp[i] is row r_a (i & 2 == 0) or r_a + 8,
      // key kt + 2 quad + 8 (i / 4) + (i & 1); masked as the bf16 route
#pragma unroll
      for (int i = 0; i < kNS; ++i) sp[i] = (sp[i] + sp[i + kNS]) * sl2;
      const bool open =
          tile_open<kF32Keys>(kt, pos_a, t_len, causal, window) &&
          tile_open<kF32Keys>(kt, pos_b, t_len, causal, window);
      if (__any_sync(0xffffffffu, !open)) {
        const int64_t k0 = kt + 2 * quad;
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
          const float x = (c <= hi_r && c >= lo_r) ? sp[i] : sentinel;
          sp[i] = c < t_rel ? x : -CUDART_INF_F;
        }
      }

      // online softmax over f32 p; l sums the unsplit p
      float mx_a = -CUDART_INF_F, mx_b = -CUDART_INF_F;
#pragma unroll
      for (int i = 0; i < kNS; ++i) {
        if (i & 2) {
          mx_b = fmaxf(mx_b, sp[i]);
        } else {
          mx_a = fmaxf(mx_a, sp[i]);
        }
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
      }
      const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
      const float corr_a = exp2f(m_a - mn_a), corr_b = exp2f(m_b - mn_b);
      m_a = mn_a;
      m_b = mn_b;
      float sum_a = 0.0f, sum_b = 0.0f;
#pragma unroll
      for (int i = 0; i < kNS; ++i) {
        const float p = exp2f(sp[i] - ((i & 2) ? mn_b : mn_a));
        if (i & 2) {
          sum_b += p;
        } else {
          sum_a += p;
        }
        const float p_hi = tf32_hi(p);    // P split like any operand
        sp[i] = p_hi;
        sp[i + kNS] = p - p_hi;
      }
      l_a = l_a * corr_a + sum_a;
      l_b = l_b * corr_b + sum_b;

      // T = P_hi V_hi + P_hi V_lo + P_lo V_hi over this tile's 32 keys (8
      // keys, 32 bytes of each V^T row, a step), 64 columns of the head at
      // a time, taken into a fresh accumulator: summed across the row's
      // tiles inside the tensor core, its truncation would grow with the
      // row (1.5e-5 at the Danube layer).  O = O * corr + T in f32.
#pragma unroll
      for (int half = 0; half < HD_PAD / 64; ++half) {
        const uint32_t vh = vt_hi + half * 64 * kSwizzleRow;
        const uint32_t vl = vt_lo + half * 64 * kSwizzleRow;
        fence_regs(t);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < kF32Keys / 8; ++j) {
          wgmma_tf32_pv_step(t, sp, 0, j, desc128(vh + 32 * j, 16, 1024),
                             j > 0);
        }
#pragma unroll
        for (int j = 0; j < kF32Keys / 8; ++j) {
          wgmma_tf32_pv_step(t, sp, 0, j, desc128(vl + 32 * j, 16, 1024), 1);
        }
#pragma unroll
        for (int j = 0; j < kF32Keys / 8; ++j) {
          wgmma_tf32_pv_step(t, sp, kNS, j, desc128(vh + 32 * j, 16, 1024),
                             1);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(t);
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          float& o_i = acc[32 * half + i];
          o_i = fmaf(o_i, (i & 2) ? corr_b : corr_a, t[i]);
        }
      }
    }
  }

  // o = acc / max(l, 1e-30) by IEEE division, stored as f32; rows past S
  // and columns past hd are not
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  const float den_a = fmaxf(l_a, 1e-30f), den_b = fmaxf(l_b, 1e-30f);
  if (lse != nullptr) store_lse(lse, b, h, s_len, q0 + r_a, quad, m_a, m_b,
                                den_a, den_b);
  const bool pairs = ((os.s | os.h | os.b) & 1) == 0;
  float* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int j = 0; j < HD_PAD / 8; ++j) {
    const int64_t d = 8 * j + 2 * quad;
    if (d >= hd) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int64_t row = q0 + r_a + 8 * half;
      if (row >= s_len) continue;
      const float den = half ? den_b : den_a;
      const float x0 = acc[4 * j + 2 * half] / den;
      const float x1 = acc[4 * j + 2 * half + 1] / den;
      float* dst = ob + row * os.s + d;
      if (pairs && d + 1 < hd) {
        *reinterpret_cast<float2*>(dst) = make_float2(x0, x1);
      } else {
        dst[0] = x0;
        if (d + 1 < hd) dst[1] = x1;
      }
    }
  }
}

// ------------------------------------------- f32 route, 128 < hd <= 256 --
//
// The same split-TF32 arithmetic as flash_f32_tc_kernel (three TF32
// products a product, f32 P, the finite sentinel, o = acc / max(l, 1e-30),
// lse in natural units), at hd padded to 256, where that kernel's tiles
// and registers do not fit: Q alone would be 128 KB for its 128 rows, and
// a warpgroup's O (64 x 256 f32) plus Q_lo would take 256 registers a
// thread.  So a block owns 64 query rows, and its two warpgroups split the
// head dim: warpgroup w holds columns 128 w .. 128 w + 127 of Q (as
// loaded, in registers, split a group of k8 steps at a time) and of O.
// Per 32-key tile each warpgroup takes its half of the scores' sum
//   S_w = Q_hi K_lo^T + Q_lo K_hi^T + Q_hi K_hi^T   over its 128 columns,
// the two halves meet through shared memory (S = S_0 + S_1, in that order
// in both), both run the same online softmax on the whole S, and each
// takes P V into its own 128 columns of O (fresh accumulators of 64
// columns, O = O * corr + T, as the narrow route).  The score sums are the
// narrow route's at hd 128 (16 k8 steps an accumulator), met by one f32
// add.  Q's fragments are split 2 k8 steps at a time, the next 2 while the
// tensor core takes these (two sets of 16 registers), by a volatile
// conversion: a pure one is hoisted out of the tile loop, and the 128
// registers of all of Q's splits spill (296 bytes; 0.61 ms against 0.48
// on the H100 at the federated LM's layer, `scripts/
// torch_flash_wide_ablate.py`).  Registers a thread: O 64, Q
// 64, the scores 32, the split fragments 32 or the tile's T 32: the
// narrow route's 192.  Every hd in 129..256 is padded to 256 (pad columns
// arrive as zeros): hd 160 does 1.6 times the products it needs; no
// config has it.  What bounds it: operations, as the narrow route; at the
// federated LM's layer (B 2, S = T = 2048, 4 / 2 heads of 256, causal)
// 3 x 1.72e10 TF32 flops, 0.104 ms at 495 TFLOP/s.
// Shared memory: a landing zone for the next tile's K and V as TMA brings
// them (32 + 32 KB), the current tile's K split (64 KB, lo rows then hi
// rows a chunk) and V^T hi and lo (32 + 32 KB), and the exchange of the
// scores' halves (16 KB): 208 KB, one block an SM.  Tile it + 1 lands
// while tile it is computed; all 256 threads split it once both
// warpgroups are done with tile it.
constexpr int kWideRows = 64;           // query rows a block

struct F32WideLayout {
  static constexpr int kHdPad = 256;
  static constexpr int kChunks = kHdPad / kF32Cols;      // 8
  static constexpr int kLandChunk = kF32Keys * kSwizzleRow;   // 4 KB
  static constexpr int kLandBytes = kChunks * kLandChunk;     // K or V
  static constexpr int kKChunk = 2 * kLandChunk;         // lo rows, hi rows
  static constexpr int kKHi = kLandChunk;
  static constexpr int kVtBytes = kHdPad * kSwizzleRow;  // V^T hi, or lo
  static constexpr int kOffLandV = kLandBytes;
  static constexpr int kOffK = 2 * kLandBytes;
  static constexpr int kOffVtHi = kOffK + kChunks * kKChunk;
  static constexpr int kOffVtLo = kOffVtHi + kVtBytes;
  static constexpr int kOffX = kOffVtLo + kVtBytes;
  static constexpr int kXBytes = kF32Threads * (kF32Keys / 2) * 4;
  static constexpr int kOffBar = kOffX + kXBytes;
  static constexpr uint32_t kTx = 2 * kLandBytes;
  static constexpr size_t kBytes = kOffBar + 8 + 1024;
};

__global__ void __launch_bounds__(kF32Threads, 1)
flash_f32_wide_kernel(const __grid_constant__ CUtensorMap k_map,
                      const __grid_constant__ CUtensorMap v_map,
                      const float* __restrict__ q, Strides qs,
                      float* __restrict__ o, float* __restrict__ lse,
                      const int32_t* __restrict__ q_pos, int64_t s_len,
                      int64_t t_len, int64_t group, int64_t hd, Strides os,
                      int causal, int64_t window, float scale) {
  using L = F32WideLayout;
  constexpr int kHalf = L::kHdPad / 2;       // columns a warpgroup
  constexpr int kKS = kHalf / 8;             // its k8 steps of Q K^T
  constexpr int kGroup = 2;                  // k8 steps a group of S
  constexpr int kNS = kF32Keys / 2;          // score registers per thread
  extern __shared__ uint8_t smem_raw[];
  __shared__ int32_t pos_s[kWideRows];
  __shared__ int32_t pmin_s[kWideRows / 32], pmax_s[kWideRows / 32];

  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t land_k = base, land_v = base + L::kOffLandV;
  const uint32_t k_s = base + L::kOffK;
  const uint32_t vt_hi = base + L::kOffVtHi, vt_lo = base + L::kOffVtLo;
  const uint32_t bar_full = base + L::kOffBar;
  float* xchg = reinterpret_cast<float*>(smem_raw + (base + L::kOffX - raw));

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int64_t n_qt = (s_len + kWideRows - 1) / kWideRows;
  // the last query tiles have the longest bands: launch them first
  const int64_t q0 = (n_qt - 1 - (int64_t)blockIdx.x) * kWideRows;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (int)group;

  if (tid < kWideRows) {
    const bool valid = q0 + tid < s_len;
    const int32_t p = valid ? q_pos[q0 + tid] : 0;
    pos_s[tid] = p;
    int32_t mn = valid ? p : INT_MAX, mx = valid ? p : INT_MIN;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      mn = min(mn, __shfl_xor_sync(0xffffffffu, mn, off));
      mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    }
    if (lane == 0) {
      pmin_s[warp] = mn;
      pmax_s[warp] = mx;
    }
  }
  if (tid == 0) {
    mbar_init(bar_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  int64_t lo, hi;
  key_band(min(pmin_s[0], pmin_s[1]), max(pmax_s[0], pmax_s[1]), t_len,
           causal, window, lo, hi);
  const int kt0 = __shfl_sync(
      0xffffffffu, (int)(lo <= hi ? lo / kF32Keys * kF32Keys : 0), 0);
  const int n_tiles = __shfl_sync(
      0xffffffffu, (int)(lo <= hi ? (hi - kt0) / kF32Keys + 1 : 0), 0);

  // thread 0 brings tile it's K and V into the landing zone, which the
  // split of tile it - 1 has read for the last time
  const auto load_tile = [&](int it) {
    const int kt = kt0 + it * kF32Keys;
    mbar_expect_tx(bar_full, L::kTx);
#pragma unroll
    for (int c = 0; c < L::kChunks; ++c) {
      tma_load_4d(land_k + c * L::kLandChunk, &k_map, bar_full, kF32Cols * c,
                  kt, kvh, b);
      tma_load_4d(land_v + c * L::kLandChunk, &v_map, bar_full, kF32Cols * c,
                  kt, kvh, b);
    }
  };
  if (tid == 0 && n_tiles > 0) load_tile(0);

  // ---- warpgroup wg owns head-dim columns 128 wg .. 128 wg + 127 ----
  const int wg = __shfl_sync(0xffffffffu, warp >> 2, 0);
  const int wt = tid & 127;
  const int r_a = 16 * (warp & 3) + (lane >> 2);          // and r_a + 8
  const int quad = lane & 3;
  const int64_t pos_a = pos_s[r_a], pos_b = pos_s[r_a + 8];
  const float sl2 = scale * kLog2e;
  const float sentinel = kNegInf * kLog2e;

  // Q's A fragments of this warpgroup's columns, as loaded (rows r_a, r_a
  // + 8; columns 128 wg + 8 ks + quad, + 4), zeros past S and hd
  float qraw[kHalf / 2];
#pragma unroll
  for (int ks = 0; ks < kKS; ++ks)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int64_t row = q0 + r_a + 8 * (e & 1);
      const int64_t d = kHalf * wg + 8 * ks + quad + 4 * (e >> 1);
      qraw[4 * ks + e] = row < s_len && d < hd
          ? __ldg(q + b * qs.b + row * qs.s + h * qs.h + d) : 0.0f;
    }

  float m_a = sentinel, m_b = sentinel, l_a = 0.0f, l_b = 0.0f;
  // sp[0..15]: Q_hi K_lo^T + Q_lo K_hi^T, then P_hi; sp[16..31]: Q_hi
  // K_hi^T, then P_lo
  float acc[kHalf / 2], sp[2 * kNS];
#pragma unroll
  for (int i = 0; i < kHalf / 2; ++i) acc[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < 2 * kNS; ++i) sp[i] = 0.0f;

  for (int it = 0; it < n_tiles; ++it) {
    mbar_wait(bar_full, (uint32_t)(it & 1));
    __syncthreads();                  // tile it - 1's products are done
    // K: hi in the chunk's rows 32..63, lo in its rows 0..31, under the
    // same swizzle as landed (both 1 KB aligned, rows a multiple of 8 on)
#pragma unroll
    for (int m = 0; m < L::kLandBytes / 16 / kF32Threads; ++m) {
      const int u = tid + m * kF32Threads;
      const int c = u / (L::kLandChunk / 16);
      const int off = 16 * (u % (L::kLandChunk / 16));
      const float4 x = lds_f32x4(land_k + c * L::kLandChunk + off);
      const float4 x_hi = tf32_hi4(x);
      sts_f32x4(k_s + c * L::kKChunk + L::kKHi + off, x_hi);
      sts_f32x4(k_s + c * L::kKChunk + off, sub4(x, x_hi));
    }
    // V to V^T hi and lo, as flash_f32_tc_kernel: 16-byte unit u of row d
    // holds keys 8 (u / 2) + (u & 1) + 2 w, w = 0..3
#pragma unroll
    for (int m = 0; m < L::kHdPad * 8 / kF32Threads; ++m) {
      const int i = tid + m * kF32Threads;
      const int d = i % L::kHdPad, u = i / L::kHdPad;
      const int key0 = 8 * (u >> 1) + (u & 1);
      const uint32_t src = land_v + (d / kF32Cols) * L::kLandChunk;
      float4 x;
      x.x = lds_f32(src + swz_f32(key0, d % kF32Cols));
      x.y = lds_f32(src + swz_f32(key0 + 2, d % kF32Cols));
      x.z = lds_f32(src + swz_f32(key0 + 4, d % kF32Cols));
      x.w = lds_f32(src + swz_f32(key0 + 6, d % kF32Cols));
      const float4 x_hi = tf32_hi4(x);
      const uint32_t dst = swz_f32(d, 4 * u);
      sts_f32x4(vt_hi + dst, x_hi);
      sts_f32x4(vt_lo + dst, sub4(x, x_hi));
    }
    fence_proxy_async();
    __syncthreads();
    if (tid == 0 && it + 1 < n_tiles) load_tile(it + 1);
    const int64_t kt = kt0 + (int64_t)it * kF32Keys;

    // this warpgroup's half of S: one n64 product against the chunk's 64
    // rows (lo, hi) gives Q_hi K_lo^T in sp[0..15] and Q_hi K_hi^T in
    // sp[16..31]; Q_lo K_hi^T adds to the former
    uint32_t k_t = k_s, vh_t = vt_hi, vl_t = vt_lo;
    opaque(k_t);
    opaque(vh_t);
    opaque(vl_t);
    // Q's fragments are split two k8 steps at a time into one of two
    // register sets, the next pair's while the tensor core takes this pair
    uint32_t fh[2][kGroup][4], fl[2][kGroup][4];
    const auto prep = [&](int set, int g0) {
#pragma unroll
      for (int j = 0; j < kGroup; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = qraw[4 * (g0 + j) + e];
          const float x_hi = tf32_hi_here(x);
          fh[set][j][e] = __float_as_uint(x_hi);
          fl[set][j][e] = __float_as_uint(x - x_hi);
        }
    };
    const auto issue = [&](int set, int g0) {
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        const int ks = g0 + j;
        const uint32_t kc = k_t + (4 * wg + ks / 4) * L::kKChunk +
                            (ks % 4) * 32;
        wgmma_tf32_rs_n64(sp, fh[set][j][0], fh[set][j][1], fh[set][j][2],
                          fh[set][j][3], desc128(kc, 16, 1024), ks > 0);
        wgmma_tf32_rs_n32(sp, fl[set][j][0], fl[set][j][1], fl[set][j][2],
                          fl[set][j][3], desc128(kc + L::kKHi, 16, 1024), 1);
      }
      wgmma_commit();
    };
    // a set's registers stay live (not reused) until its products are done
    const auto hold = [&](int set) {
#pragma unroll
      for (int j = 0; j < kGroup; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          asm volatile("" : "+r"(fh[set][j][e]), "+r"(fl[set][j][e]));
        }
    };
    fence_regs(sp);
    prep(0, 0);
    issue(0, 0);
#pragma unroll
    for (int g = 1; g < kKS / kGroup; ++g) {
      prep(g & 1, kGroup * g);
      issue(g & 1, kGroup * g);
      wgmma_wait<1>();                             // group g - 1 is done
      hold((g - 1) & 1);
    }
    wgmma_wait<0>();
    hold((kKS / kGroup - 1) & 1);
    fence_regs(sp);

    // the halves meet: S = S_0 + S_1 in both warpgroups, in log2 units;
    // sp[i] is row r_a (i & 2 == 0) or r_a + 8, key kt + 2 quad + 8 (i /
    // 4) + (i & 1)
#pragma unroll
    for (int i = 0; i < kNS; ++i) {
      sp[i] += sp[i + kNS];
      xchg[(wg * kNS + i) * 128 + wt] = sp[i];
    }
    bar_sync<1, kF32Threads>();
#pragma unroll
    for (int i = 0; i < kNS; ++i) {
      const float other = xchg[((1 - wg) * kNS + i) * 128 + wt];
      sp[i] = (wg ? other + sp[i] : sp[i] + other) * sl2;
    }
    const bool open =
        tile_open<kF32Keys>(kt, pos_a, t_len, causal, window) &&
        tile_open<kF32Keys>(kt, pos_b, t_len, causal, window);
    if (__any_sync(0xffffffffu, !open)) {
      const int64_t k0 = kt + 2 * quad;
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
        const float x = (c <= hi_r && c >= lo_r) ? sp[i] : sentinel;
        sp[i] = c < t_rel ? x : -CUDART_INF_F;
      }
    }

    // online softmax over f32 p, the same in both warpgroups
    float mx_a = -CUDART_INF_F, mx_b = -CUDART_INF_F;
#pragma unroll
    for (int i = 0; i < kNS; ++i) {
      if (i & 2) {
        mx_b = fmaxf(mx_b, sp[i]);
      } else {
        mx_a = fmaxf(mx_a, sp[i]);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
    }
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    const float corr_a = exp2f(m_a - mn_a), corr_b = exp2f(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
    float sum_a = 0.0f, sum_b = 0.0f;
#pragma unroll
    for (int i = 0; i < kNS; ++i) {
      const float p = exp2f(sp[i] - ((i & 2) ? mn_b : mn_a));
      if (i & 2) {
        sum_b += p;
      } else {
        sum_a += p;
      }
      const float p_hi = tf32_hi(p);
      sp[i] = p_hi;
      sp[i + kNS] = p - p_hi;
    }
    l_a = l_a * corr_a + sum_a;
    l_b = l_b * corr_b + sum_b;

    // T = P_hi V_hi + P_hi V_lo + P_lo V_hi into this warpgroup's columns,
    // 64 at a time, a fresh accumulator each; O = O * corr + T in f32
#pragma unroll
    for (int half = 0; half < kHalf / 64; ++half) {
      const uint32_t row0 = (kHalf * wg + 64 * half) * kSwizzleRow;
      const uint32_t vh = vh_t + row0, vl = vl_t + row0;
      float t[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) t[i] = 0.0f;
      fence_regs(t);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < kF32Keys / 8; ++j) {
        wgmma_tf32_pv_step(t, sp, 0, j, desc128(vh + 32 * j, 16, 1024),
                           j > 0);
      }
#pragma unroll
      for (int j = 0; j < kF32Keys / 8; ++j) {
        wgmma_tf32_pv_step(t, sp, 0, j, desc128(vl + 32 * j, 16, 1024), 1);
      }
#pragma unroll
      for (int j = 0; j < kF32Keys / 8; ++j) {
        wgmma_tf32_pv_step(t, sp, kNS, j, desc128(vh + 32 * j, 16, 1024), 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(t);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        float& o_i = acc[32 * half + i];
        o_i = fmaf(o_i, (i & 2) ? corr_b : corr_a, t[i]);
      }
    }
  }

  // o = acc / max(l, 1e-30) by IEEE division; warpgroup 0 writes the lse
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  const float den_a = fmaxf(l_a, 1e-30f), den_b = fmaxf(l_b, 1e-30f);
  if (lse != nullptr && wg == 0) {
    store_lse(lse, b, h, s_len, q0 + r_a, quad, m_a, m_b, den_a, den_b);
  }
  const bool pairs = ((os.s | os.h | os.b) & 1) == 0;
  float* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int j = 0; j < kHalf / 8; ++j) {
    const int64_t d = kHalf * wg + 8 * j + 2 * quad;
    if (d >= hd) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int64_t row = q0 + r_a + 8 * half;
      if (row >= s_len) continue;
      const float den = half ? den_b : den_a;
      const float x0 = acc[4 * j + 2 * half] / den;
      const float x1 = acc[4 * j + 2 * half + 1] / den;
      float* dst = ob + row * os.s + d;
      if (pairs && d + 1 < hd) {
        *reinterpret_cast<float2*>(dst) = make_float2(x0, x1);
      } else {
        dst[0] = x0;
        if (d + 1 < hd) dst[1] = x1;
      }
    }
  }
}

// ------------------------------------------ bf16 route, 128 < hd <= 256 --
//
// The bf16 route's arithmetic (flash_tc_kernel: S and the softmax in f32,
// P rounded to bf16 before P V, l over the unrounded p, o = acc / max(l,
// 1e-30) rounded once to bf16, the finite sentinel, lse in natural units)
// at hd padded to 256, where that kernel's layout does not fit: its
// 128-key tiles at hd 256 need Q 64 KB plus 128 KB a stage, and its
// producer warp holds a thread to 168 registers while a warpgroup's O (64
// x 256 f32) alone is 128.  So the tiles are 64 keys and there is no
// producer warp: thread 0 issues every copy, as in the f32 routes, and a
// thread may hold 255 registers (O 128, S 32, P's bf16 fragments 16).  A
// block of 256 threads owns 128 query rows of one (batch, head), 64 a
// warpgroup.  Per tile a warpgroup runs
//   S = Q K^T       wgmma m64n64k16 over 16 k16 steps, Q and K from shared
//                   memory (K-major, as loaded);
//   p = exp2(S * scale * log2 e - m), masked by selects as flash_tc_kernel;
//   O += P V        wgmma m64n256k16 over the tile's 4 k16 steps, P from
//                   registers, V read MN-major from shared memory.
// Thread 0 loads Q once and the K/V tiles of the block's band into a ring
// of 2 stages ("full" mbarriers count the copies' bytes, "empty" ones the
// 8 warps' releases): tile it + 1 is asked for at the start of tile it,
// once both warpgroups have released tile it - 1, so one tile's products
// cover the next tile's copy, and the two warpgroups stay within a tile
// of each other (one's softmax runs beside the other's products).
// Shared memory: Q 64 KB and two stages of K and V (32 + 32 KB), 192 KB,
// in 128-byte-swizzled 64-column chunks; one block an SM.  Every hd in
// 129..256 is padded to 256 (the pad columns arrive as zeros).  What
// bounds it: operations, 4 x 256 flops a (query, key) pair; at the
// federated LM's layer (B 2, S = T = 2048, 4 / 2 heads of 256, causal)
// 1.72e10 flops, 0.0174 ms at 989 TFLOP/s.  The grid there is 16 x 4 x 2
// = 128 blocks, the last row blocks (all 32 tiles under causal masking)
// launched first.
struct Bf16WideLayout {
  static constexpr int kKeys = 64;                       // keys a tile
  static constexpr int kHdPad = 256;
  static constexpr int kChunks = kHdPad / 64;            // 64-column chunks
  static constexpr int kQChunk = kTcRows * kSwizzleRow;  // 16 KB
  static constexpr int kKVChunk = kKeys * kSwizzleRow;   // 8 KB
  static constexpr int kQBytes = kChunks * kQChunk;      // 64 KB
  static constexpr int kKVBytes = kChunks * kKVChunk;    // 32 KB: K or V
  static constexpr int kOffK = kQBytes;
  static constexpr int kOffV = kOffK + kTcStages * kKVBytes;
  static constexpr int kOffBar = kOffV + kTcStages * kKVBytes;
  // Q, the K and V rings, 1 + 2 * stages mbarriers, slack to align to 1 KB
  static constexpr size_t kBytes = kOffBar + 8 * (1 + 2 * kTcStages) + 1024;
};
constexpr int kBf16WideThreads = 256;   // two warpgroups, no producer warp

__global__ void __launch_bounds__(kBf16WideThreads, 1)
flash_bf16_wide_kernel(const __grid_constant__ CUtensorMap q_map,
                       const __grid_constant__ CUtensorMap k_map,
                       const __grid_constant__ CUtensorMap v_map,
                       __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                       const int32_t* __restrict__ q_pos, int64_t s_len,
                       int64_t t_len, int64_t group, int64_t hd, Strides os,
                       int causal, int64_t window, float scale) {
  using L = Bf16WideLayout;
  constexpr int kKeys = L::kKeys;
  constexpr int kNS = kKeys / 2;            // score registers per thread
  constexpr int kWarps = kBf16WideThreads / 32;
  extern __shared__ uint8_t smem_raw[];
  __shared__ int32_t pos_s[kTcRows];
  __shared__ int32_t pmin_s[kTcRows / 32], pmax_s[kTcRows / 32];

  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t q_base = base;
  const uint32_t k_base = base + L::kOffK;
  const uint32_t v_base = base + L::kOffV;
  const uint32_t bar_q = base + L::kOffBar;                 // Q arrived
  const uint32_t bar_full = bar_q + 8;                      // [stage]
  const uint32_t bar_empty = bar_full + 8 * kTcStages;      // [stage]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int64_t n_qt = (s_len + kTcRows - 1) / kTcRows;
  // the last query tiles have the longest bands: launch them first
  const int64_t q0 = (n_qt - 1 - (int64_t)blockIdx.x) * kTcRows;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (int)group;

  if (tid < kTcRows) {
    const bool valid = q0 + tid < s_len;
    const int32_t p = valid ? q_pos[q0 + tid] : 0;
    pos_s[tid] = p;
    int32_t mn = valid ? p : INT_MAX, mx = valid ? p : INT_MIN;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      mn = min(mn, __shfl_xor_sync(0xffffffffu, mn, off));
      mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    }
    if (lane == 0) {
      pmin_s[warp] = mn;
      pmax_s[warp] = mx;
    }
  }
  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kTcStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // each warpgroup's band, and the block's: the union of the two
  int64_t lo[2], hi[2];
#pragma unroll
  for (int w = 0; w < 2; ++w) {
    key_band(min(pmin_s[2 * w], pmin_s[2 * w + 1]),
             max(pmax_s[2 * w], pmax_s[2 * w + 1]), t_len, causal, window,
             lo[w], hi[w]);
  }
  int64_t b_lo = INT64_MAX, b_hi = -1;
#pragma unroll
  for (int w = 0; w < 2; ++w) {
    if (lo[w] <= hi[w]) {
      b_lo = lo[w] < b_lo ? lo[w] : b_lo;
      b_hi = hi[w] > b_hi ? hi[w] : b_hi;
    }
  }
  const int kt0 = __shfl_sync(
      0xffffffffu, (int)(b_hi >= 0 ? b_lo / kKeys * kKeys : 0), 0);
  const int n_tiles = __shfl_sync(
      0xffffffffu, (int)(b_hi >= 0 ? (b_hi - kt0) / kKeys + 1 : 0), 0);

  // thread 0 issues every copy: Q and the first two tiles now, tile it + 1
  // at the start of tile it (below)
  const auto load_tile = [&](int it) {
    const int s = it % kTcStages;
    const uint32_t full = bar_full + 8 * s;
    const int kt = kt0 + it * kKeys;
    mbar_expect_tx(full, 2 * L::kKVBytes);
#pragma unroll
    for (int c = 0; c < L::kChunks; ++c) {
      tma_load_4d(k_base + s * L::kKVBytes + c * L::kKVChunk, &k_map, full,
                  64 * c, kt, kvh, b);
      tma_load_4d(v_base + s * L::kKVBytes + c * L::kKVChunk, &v_map, full,
                  64 * c, kt, kvh, b);
    }
  };
  if (tid == 0) {
    mbar_expect_tx(bar_q, L::kQBytes);
#pragma unroll
    for (int c = 0; c < L::kChunks; ++c) {
      tma_load_4d(q_base + c * L::kQChunk, &q_map, bar_q, 64 * c, (int)q0, h,
                  b);
    }
    for (int i = 0; i < kTcStages && i < n_tiles; ++i) load_tile(i);
  }
  __syncwarp();

  // ---- warpgroup wg owns rows 64 wg .. 64 wg + 63 ----
  const int wg = __shfl_sync(0xffffffffu, warp >> 2, 0);
  const int r_a = 64 * wg + 16 * (warp & 3) + (lane >> 2);  // and r_a + 8
  const int quad = lane & 3;
  const int64_t pos_a = pos_s[r_a], pos_b = pos_s[r_a + 8];
  const float sl2 = scale * kLog2e;
  const float sentinel = kNegInf * kLog2e;
  const uint32_t q_wg = q_base + wg * 64 * kSwizzleRow;

  // the tiles this warpgroup visits, it_first .. it_last, are a run of
  // the block's; it still waits for and releases the others
  const int64_t w_lo = wg ? lo[1] : lo[0], w_hi = wg ? hi[1] : hi[0];
  int it_first = n_tiles, it_last = -1;
  if (w_lo <= w_hi && n_tiles > 0) {
    it_first = (int)((w_lo - kt0) / kKeys);
    it_last = (int)((w_hi - kt0) / kKeys);
    if (it_last > n_tiles - 1) it_last = n_tiles - 1;
  }
  it_first = __shfl_sync(0xffffffffu, it_first, 0);
  it_last = __shfl_sync(0xffffffffu, it_last, 0);

  float m_a = sentinel, m_b = sentinel, l_a = 0.0f, l_b = 0.0f;
  float acc[L::kHdPad / 2], sc[kNS];
#pragma unroll
  for (int i = 0; i < L::kHdPad / 2; ++i) acc[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < kNS; ++i) sc[i] = 0.0f;

  mbar_wait(bar_q, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % kTcStages;
    if (tid == 0 && it >= 1 && it + 1 < n_tiles) {
      // tile it + 1 into the stage tile it - 1 has released
      mbar_wait(bar_empty + 8 * ((it - 1) % kTcStages),
                (uint32_t)(((it - 1) / kTcStages) & 1));
      load_tile(it + 1);
    }
    __syncwarp();
    mbar_wait(bar_full + 8 * s, (uint32_t)((it / kTcStages) & 1));
    if (it >= it_first && it <= it_last) {
      const int64_t kt = kt0 + (int64_t)it * kKeys;
      const uint32_t k_s = k_base + s * L::kKVBytes;
      const uint32_t v_s = v_base + s * L::kKVBytes;

      // S = Q K^T: 16 columns of hd per step, 32 bytes into a 128-byte row
      fence_regs(sc);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < L::kHdPad / 16; ++ks) {
        const uint32_t col = (ks % 4) * 32;
        wgmma_ss_n64(sc,
                     desc128(q_wg + (ks / 4) * L::kQChunk + col, 16, 1024),
                     desc128(k_s + (ks / 4) * L::kKVChunk + col, 16, 1024),
                     ks > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);

      // scale to log2 units; sc[i] is row r_a (i & 2 == 0) or r_a + 8,
      // key kt + 2 quad + 8 (i / 4) + (i & 1); masked as flash_tc_kernel
#pragma unroll
      for (int i = 0; i < kNS; ++i) sc[i] *= sl2;
      const bool open =
          tile_open<kKeys>(kt, pos_a, t_len, causal, window) &&
          tile_open<kKeys>(kt, pos_b, t_len, causal, window);
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
          const float x = (c <= hi_r && c >= lo_r) ? sc[i] : sentinel;
          sc[i] = c < t_rel ? x : -CUDART_INF_F;   // past T: not a key
        }
      }

      // online softmax; l sums this thread's share of the unrounded p
      float mx_a = -CUDART_INF_F, mx_b = -CUDART_INF_F;
#pragma unroll
      for (int i = 0; i < kNS; ++i) {
        if (i & 2) {
          mx_b = fmaxf(mx_b, sc[i]);
        } else {
          mx_a = fmaxf(mx_a, sc[i]);
        }
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
      }
      const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
      const float corr_a = exp2f(m_a - mn_a), corr_b = exp2f(m_b - mn_b);
      m_a = mn_a;
      m_b = mn_b;
      float sum_a = 0.0f, sum_b = 0.0f;
#pragma unroll
      for (int i = 0; i < kNS; ++i) {
        if (i & 2) {
          sc[i] = exp2f(sc[i] - mn_b);
          sum_b += sc[i];
        } else {
          sc[i] = exp2f(sc[i] - mn_a);
          sum_a += sc[i];
        }
      }
      l_a = l_a * corr_a + sum_a;
      l_b = l_b * corr_b + sum_b;
#pragma unroll
      for (int i = 0; i < L::kHdPad / 2; ++i) {
        acc[i] *= (i & 2) ? corr_b : corr_a;
      }

      // P rounded to bf16 as A fragments (the accumulator layout of keys
      // 16 kk .. 16 kk + 15 is the A layout of a k16 step), then O += P V
      // over the whole head dim, 16 keys (2 KB of 128-byte rows) a step
      uint32_t pa[kKeys / 16][4];
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          pa[kk][j] = pack_bf16(sc[8 * kk + 2 * j], sc[8 * kk + 2 * j + 1]);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk) {
        wgmma_rs_n256(acc, pa[kk],
                      desc128(v_s + kk * 16 * kSwizzleRow, L::kKVChunk, 1024),
                      1);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty + 8 * s);   // this warp is done
  }

  // o = acc / max(l, 1e-30) by the fast division (the result is rounded
  // to bf16), stored as bf16; rows past S and columns past hd are not
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  const float den_a = fmaxf(l_a, 1e-30f), den_b = fmaxf(l_b, 1e-30f);
  if (lse != nullptr) store_lse(lse, b, h, s_len, q0 + r_a, quad, m_a, m_b,
                                den_a, den_b);
  const bool pairs = ((hd | os.s | os.h | os.b) & 1) == 0;
  __nv_bfloat16* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int j = 0; j < L::kHdPad / 8; ++j) {
    const int64_t d = 8 * j + 2 * quad;
    if (d >= hd) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int64_t row = q0 + r_a + 8 * half;
      if (row >= s_len) continue;
      const float den = half ? den_b : den_a;
      const float x0 = __fdividef(acc[4 * j + 2 * half], den);
      const float x1 = __fdividef(acc[4 * j + 2 * half + 1], den);
      __nv_bfloat16* dst = ob + row * os.s + d;
      if (pairs && d + 1 < hd) {
        *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(x0, x1);
      } else {
        dst[0] = __float2bfloat16_rn(x0);
        if (d + 1 < hd) dst[1] = __float2bfloat16_rn(x1);
      }
    }
  }
}

int launch_bf16_wide(cudaStream_t stream, const void* q, const void* k,
                     const void* v, void* o, void* lse, const void* q_pos,
                     int64_t b, int64_t s_len, int64_t t_len, int64_t hq,
                     int64_t kh, int64_t hd, Strides qs, Strides ks,
                     Strides vs, Strides os, int causal, int64_t window,
                     float scale) {
  CUtensorMap q_map, k_map, v_map;
  int rc = make_map(&q_map, q, kBf16, 2, hd, s_len, hq, b, qs, kTcRows);
  if (rc == 0) rc = make_map(&k_map, k, kBf16, 2, hd, t_len, kh, b, ks,
                             Bf16WideLayout::kKeys);
  if (rc == 0) rc = make_map(&v_map, v, kBf16, 2, hd, t_len, kh, b, vs,
                             Bf16WideLayout::kKeys);
  if (rc != 0) return rc;
  const size_t bytes = Bf16WideLayout::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bf16_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((s_len + kTcRows - 1) / kTcRows), (unsigned)hq,
                  (unsigned)b);
  flash_bf16_wide_kernel<<<grid, kBf16WideThreads, bytes, stream>>>(
      q_map, k_map, v_map, (__nv_bfloat16*)o, (float*)lse,
      (const int32_t*)q_pos, s_len, t_len, hq / kh, hd, os, causal, window,
      scale);
  return (int)cudaGetLastError();
}

int launch_f32_wide(cudaStream_t stream, const void* q, const void* k,
                    const void* v, void* o, void* lse, const void* q_pos,
                    int64_t b, int64_t s_len, int64_t t_len, int64_t hq,
                    int64_t kh, int64_t hd, Strides qs, Strides ks,
                    Strides vs, Strides os, int causal, int64_t window,
                    float scale) {
  CUtensorMap k_map, v_map;
  int rc = make_map(&k_map, k, kF32, 4, hd, t_len, kh, b, ks, kF32Keys);
  if (rc == 0) rc = make_map(&v_map, v, kF32, 4, hd, t_len, kh, b, vs,
                             kF32Keys);
  if (rc != 0) return rc;
  const size_t bytes = F32WideLayout::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_f32_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((s_len + kWideRows - 1) / kWideRows),
                  (unsigned)hq, (unsigned)b);
  flash_f32_wide_kernel<<<grid, kF32Threads, bytes, stream>>>(
      k_map, v_map, (const float*)q, qs, (float*)o, (float*)lse,
      (const int32_t*)q_pos, s_len, t_len, hq / kh, hd, os, causal, window,
      scale);
  return (int)cudaGetLastError();
}

template <int HD_PAD>
int launch_tc_hd(cudaStream_t stream, const void* q, const void* k,
                 const void* v, void* o, void* lse, const void* q_pos,
                 int64_t b, int64_t s_len, int64_t t_len, int64_t hq,
                 int64_t kh, int64_t hd, Strides qs, Strides ks, Strides vs,
                 Strides os, int causal, int64_t window, float scale) {
  CUtensorMap q_map, k_map, v_map;
  int rc = make_map(&q_map, q, kBf16, 2, hd, s_len, hq, b, qs,
                    kTcRows);
  if (rc == 0) rc = make_map(&k_map, k, kBf16, 2, hd, t_len, kh, b, ks,
                               kTcKeys);
  if (rc == 0) rc = make_map(&v_map, v, kBf16, 2, hd, t_len, kh, b, vs,
                               kTcKeys);
  if (rc != 0) return rc;
  const size_t bytes = TcLayout<HD_PAD>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_tc_kernel<HD_PAD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((s_len + kTcRows - 1) / kTcRows), (unsigned)hq,
                  (unsigned)b);
  flash_tc_kernel<HD_PAD><<<grid, kTcThreads, bytes, stream>>>(
      q_map, k_map, v_map, (__nv_bfloat16*)o, (float*)lse,
      (const int32_t*)q_pos, s_len, t_len, hq / kh, hd, os, causal, window,
      scale);
  return (int)cudaGetLastError();
}

template <int HD_PAD>
int launch_f32_hd(cudaStream_t stream, const void* q, const void* k,
                  const void* v, void* o, void* lse, const void* q_pos,
                  int64_t b, int64_t s_len, int64_t t_len, int64_t hq,
                  int64_t kh, int64_t hd, Strides qs, Strides ks, Strides vs,
                  Strides os, int causal, int64_t window, float scale) {
  CUtensorMap q_map, k_map, v_map;
  int rc = make_map(&q_map, q, kF32, 4, hd, s_len, hq, b, qs, kF32Rows);
  if (rc == 0) rc = make_map(&k_map, k, kF32, 4, hd, t_len, kh, b, ks,
                             kF32Keys);
  if (rc == 0) rc = make_map(&v_map, v, kF32, 4, hd, t_len, kh, b, vs,
                             kF32Keys);
  if (rc != 0) return rc;
  const size_t bytes = F32Layout<HD_PAD>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_f32_tc_kernel<HD_PAD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((s_len + kF32Rows - 1) / kF32Rows), (unsigned)hq,
                  (unsigned)b);
  flash_f32_tc_kernel<HD_PAD><<<grid, kF32Threads, bytes, stream>>>(
      q_map, k_map, v_map, (float*)o, (float*)lse, (const int32_t*)q_pos,
      s_len, t_len, hq / kh, hd, os, causal, window, scale);
  return (int)cudaGetLastError();
}

int check_shape(int64_t b, int64_t s_len, int64_t t_len, int64_t hq,
                int64_t kh, int64_t hd, int64_t max_hd) {
  if (b < 1 || s_len < 1 || t_len < 1 || kh < 1 || hq < kh || hq % kh ||
      hd < 1 || hd > max_hd || (s_len + 63) / 64 > 2147483647 || hq > 65535 ||
      b > 65535 || t_len > 2147483647) {
    return (int)cudaErrorInvalidConfiguration;
  }
  return 0;
}

}  // namespace

extern "C" int flash_attention_f32(
    const void* q, const void* k, const void* v, void* o, void* lse,
    const void* q_pos, int64_t b, int64_t s_len, int64_t t_len, int64_t hq,
    int64_t kh, int64_t hd, int64_t q_sb, int64_t q_ss, int64_t q_sh,
    int64_t k_sb, int64_t k_st, int64_t k_sh, int64_t v_sb, int64_t v_st,
    int64_t v_sh, int64_t o_sb, int64_t o_ss, int64_t o_sh, int64_t causal,
    int64_t window, float scale, int64_t device, void* stream) {
  cudaError_t err = cudaSetDevice((int)device);
  if (err != cudaSuccess) return (int)err;
  const int bad = check_shape(b, s_len, t_len, hq, kh, hd, 256);
  if (bad) return bad;
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_st, k_sh},
      vs{v_sb, v_st, v_sh}, os{o_sb, o_ss, o_sh};
  const int c = causal ? 1 : 0;
  if (hd > 128) {
    return launch_f32_wide((cudaStream_t)stream, q, k, v, o, lse, q_pos, b,
                           s_len, t_len, hq, kh, hd, qs, ks, vs, os, c,
                           window, scale);
  }
  if (hd <= 64) {
    return launch_f32_hd<64>((cudaStream_t)stream, q, k, v, o, lse, q_pos, b,
                             s_len, t_len, hq, kh, hd, qs, ks, vs, os, c,
                             window, scale);
  }
  return launch_f32_hd<128>((cudaStream_t)stream, q, k, v, o, lse, q_pos, b,
                            s_len, t_len, hq, kh, hd, qs, ks, vs, os, c,
                            window, scale);
}

extern "C" int flash_attention_bf16(
    const void* q, const void* k, const void* v, void* o, void* lse,
    const void* q_pos, int64_t b, int64_t s_len, int64_t t_len, int64_t hq,
    int64_t kh, int64_t hd, int64_t q_sb, int64_t q_ss, int64_t q_sh,
    int64_t k_sb, int64_t k_st, int64_t k_sh, int64_t v_sb, int64_t v_st,
    int64_t v_sh, int64_t o_sb, int64_t o_ss, int64_t o_sh, int64_t causal,
    int64_t window, float scale, int64_t device, void* stream) {
  cudaError_t err = cudaSetDevice((int)device);
  if (err != cudaSuccess) return (int)err;
  const int bad = check_shape(b, s_len, t_len, hq, kh, hd, 256);
  if (bad) return bad;
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_st, k_sh},
      vs{v_sb, v_st, v_sh}, os{o_sb, o_ss, o_sh};
  const int c = causal ? 1 : 0;
  if (hd > 128) {
    return launch_bf16_wide((cudaStream_t)stream, q, k, v, o, lse, q_pos, b,
                            s_len, t_len, hq, kh, hd, qs, ks, vs, os, c,
                            window, scale);
  }
  if (hd <= 64) {
    return launch_tc_hd<64>((cudaStream_t)stream, q, k, v, o, lse, q_pos, b,
                            s_len, t_len, hq, kh, hd, qs, ks, vs, os, c,
                            window, scale);
  }
  return launch_tc_hd<128>((cudaStream_t)stream, q, k, v, o, lse, q_pos, b,
                           s_len, t_len, hq, kh, hd, qs, ks, vs, os, c,
                           window, scale);
}
