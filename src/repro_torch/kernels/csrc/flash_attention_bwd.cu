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
// Determinism: no atomics.  Pass 2 runs one block per (key tile, KV head,
// batch row), which visits the G heads and then the query tiles in a fixed
// order with its dK and dV tiles in registers; pass 3 one block per (query
// tile, query head, batch row).  Two launches on the same inputs are
// bitwise equal.  Each of passes 2 and 3 recomputes S and dP for its
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
// GB of traffic, 0.05 ms at 3.35 TB/s.  Two routes, by the inputs' type:
//
// bf16 (the training path): every product on the tensor cores, in the
// shape of the forward's bf16 route (flash_attention.cu, flash_tc_kernel),
// with the Hopper helpers of hopper.cuh.  Tiles are stored as 128-byte
// rows under the 128-byte swizzle, in 64-column chunks of hd padded to 64
// or 128 (the tensor maps' head_dim is a dimension of size hd, so pad
// columns and rows past S or T arrive as zeros).  Pass 1 writes, for each
// query row, the pair (L log2 e, D) into a (B, Hq, S padded to 64, 2)
// scratch, rows past S as (+inf, 0), so that their P is exp2(-inf) = 0.
// Pass 2 (`bwd_dkdv_tc_kernel`): a block of 256 threads owns 128 keys of
// one KV head, 64 for each of two warpgroups.  Thread 0 loads K and V once
// by TMA, then streams the (Q, dO) tiles of 64 rows of the visited (head,
// query tile) pairs, each with its 64 (L log2 e, D) pairs (a 1-D bulk
// copy), through a ring of 3 stages with "full" mbarriers (the copies'
// bytes) and "empty" ones (the 8 warps' releases).  A warpgroup computes
// the transposed scores, so that P and dS come out in the layout of a
// register A operand:
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
// stored as bf16.  The ring's producer is thread 0 and not a warp of its
// own: with a ninth warp a thread may hold 168 registers (an SM's four
// register partitions, three warps on one), and pass 2 needs ~230 at hd
// 128; at 8 warps it may hold 255.
//
// Arithmetic of the bf16 route: P and dS are rounded to bf16 before the
// three products that read them (P dO, dS Q, dS K), as the forward rounds
// P before P V; the reference and today's f32 route keep them in f32.  S,
// dP, the sums, L, D and the rescales stay f32; each output is rounded to
// bf16 once.  `ref.py::attention_bwd_bf16_ref` is this arithmetic on the
// CPU.
//
// f32: every product and sum is an f32 FMA on the CUDA cores.  Tiles are
// 64 query rows by 64 keys by hd padded to 64 or 128, f32 in shared memory
// with each row padded by one word, so that both the row walks and the
// column walks below are free of bank conflicts.  256 threads as 16 x 16:
// thread (ty, tx) holds S and dP at rows ty + 16 r and keys tx + 16 c (r, c
// < 4), and each accumulator at rows ty + 16 r and columns tx + 16 c (c <
// HD_PAD / 16).  Rows past S, keys past T and columns past hd load as
// zeros and are masked or not stored.  Shared memory at HD_PAD 128: pass 2
// holds K, V, Q, dO (33 KB each) and P, dS (16.6 KB each), 165 KB, one
// block per SM; pass 3 holds Q, dO, K, V and dS, 149 KB.  At HD_PAD 64
// they take 100 and 83 KB, two blocks.  Its redesign (split-TF32 products
// on the tensor cores, as the forward's f32 route) is later work.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math_constants.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kTile = 64;          // query rows, and keys, a tile
constexpr int kThreads = 256;      // 16 x 16
constexpr int kPLd = kTile + 1;    // padded row of a P or dS tile

struct Shape {
  int64_t b, s, t, hq, kh, hd;
};

template <int HD_PAD>
struct BwdLayout {
  static constexpr int kLd = HD_PAD + 1;         // padded row, in floats
  static constexpr int kTileF = kTile * kLd;     // a (64, HD_PAD) tile
  static constexpr int kPTileF = kTile * kPLd;   // a (64, 64) tile
  static constexpr size_t kBytesKV = (4 * kTileF + 2 * kPTileF) * 4;
  static constexpr size_t kBytesQ = (4 * kTileF + kPTileF) * 4;
};

// Rows r0 .. r0 + 63 of head h of batch row b of a contiguous
// (B, len, heads, hd) tensor, as a (64, HD_PAD) f32 tile with padded rows;
// zeros past len and past hd.
template <int HD_PAD>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int64_t b, int64_t r0, int64_t len,
                                          int64_t h, int64_t heads,
                                          int64_t hd) {
  constexpr int kLd = HD_PAD + 1;
  for (int e = threadIdx.x; e < kTile * HD_PAD; e += kThreads) {
    const int r = e / HD_PAD, c = e % HD_PAD;
    const int64_t row = r0 + r;
    float x = 0.0f;
    if (row < len && c < hd) {
      x = src[((b * len + row) * heads + h) * hd + c];
    }
    dst[r * kLd + c] = x;
  }
}

// the forward's mask: true when the row at `pos` attends to `key`
__device__ __forceinline__ bool attends(int64_t pos, int64_t key,
                                        int64_t t_len, int causal,
                                        int64_t window) {
  return key < t_len && (!causal || key <= pos) &&
         (window <= 0 || key > pos - window);
}

// S = Q K^T and dP = dO V^T over the padded head dim for this thread's
// 4 x 4 rows and keys (unscaled, f32 FMA in the order d = 0 .. HD_PAD - 1)
template <int HD_PAD>
__device__ __forceinline__ void scores(const float* q_s, const float* do_s,
                                       const float* k_s, const float* v_s,
                                       int ty, int tx, float (&sc)[4][4],
                                       float (&dp)[4][4]) {
  constexpr int kLd = HD_PAD + 1;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) sc[r][c] = dp[r][c] = 0.0f;
#pragma unroll 4
  for (int d = 0; d < HD_PAD; ++d) {
    float qa[4], da[4], kb[4], vb[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      qa[r] = q_s[(ty + 16 * r) * kLd + d];
      da[r] = do_s[(ty + 16 * r) * kLd + d];
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      kb[c] = k_s[(tx + 16 * c) * kLd + d];
      vb[c] = v_s[(tx + 16 * c) * kLd + d];
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        sc[r][c] = fmaf(qa[r], kb[c], sc[r][c]);
        dp[r][c] = fmaf(da[r], vb[c], dp[r][c]);
      }
  }
}

// the rows' positions, L and D of query tile q0 of head h into shared
// memory (rows past S get zeros and are masked by their index)
__device__ __forceinline__ void load_rows(int32_t* pos_s, float* lse_s,
                                          float* dl_s, const int32_t* q_pos,
                                          const float* lse,
                                          const float* delta, int64_t b,
                                          int64_t h, int64_t q0,
                                          const Shape& sh) {
  const int i = threadIdx.x;
  if (i < kTile) {
    const int64_t row = q0 + i;
    const bool ok = row < sh.s;
    const int64_t at = (b * sh.hq + h) * sh.s + row;
    pos_s[i] = ok ? q_pos[row] : 0;
    lse_s[i] = ok ? lse[at] : 0.0f;
    dl_s[i] = ok ? delta[at] : 0.0f;
  }
}

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

// pass 1: D = rowsum(dO o) for 64 rows of one (batch row, head), and the
// rows' least and greatest positions (written by the (0, 0) blocks)
__global__ void __launch_bounds__(kThreads)
bwd_delta_kernel(const float* __restrict__ o, const float* __restrict__ dout,
                 const int32_t* __restrict__ q_pos, float* __restrict__ delta,
                 int32_t* __restrict__ bounds, Shape sh) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  for (int r = warp; r < kTile; r += kThreads / 32) {
    const int64_t row = qt * kTile + r;
    if (row >= sh.s) break;
    const int64_t off = ((b * sh.s + row) * sh.hq + h) * sh.hd;
    float acc = 0.0f;
    for (int64_t c = lane; c < sh.hd; c += 32) {
      acc = fmaf(dout[off + c], o[off + c], acc);
    }
#pragma unroll
    for (int x = 16; x > 0; x >>= 1) {
      acc += __shfl_xor_sync(0xffffffffu, acc, x);
    }
    if (lane == 0) delta[(b * sh.hq + h) * sh.s + row] = acc;
  }
  if (h == 0 && b == 0 && warp == 0) tile_bounds(q_pos, sh.s, qt, bounds);
}

// pass 2: dK and dV of one 64-key tile of one KV head
template <int HD_PAD>
__global__ void __launch_bounds__(kThreads)
bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta,
                const int32_t* __restrict__ q_pos,
                const int32_t* __restrict__ bounds, float* __restrict__ dk,
                float* __restrict__ dv, Shape sh, int causal, int64_t window,
                float scale) {
  using L = BwdLayout<HD_PAD>;
  constexpr int kLd = L::kLd;
  constexpr int kC = HD_PAD / 16;
  extern __shared__ float smem[];
  float* k_s = smem;
  float* v_s = k_s + L::kTileF;
  float* q_s = v_s + L::kTileF;
  float* do_s = q_s + L::kTileF;
  float* p_s = do_s + L::kTileF;
  float* ds_s = p_s + L::kPTileF;
  __shared__ float lse_s[kTile], dl_s[kTile];
  __shared__ int32_t pos_s[kTile];

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int64_t k0 = (int64_t)blockIdx.x * kTile;
  const int64_t kvh = blockIdx.y, b = blockIdx.z;
  const int64_t group = sh.hq / sh.kh;
  const int64_t n_qt = (sh.s + kTile - 1) / kTile;
  const int64_t k_last = (k0 + kTile < sh.t ? k0 + kTile : sh.t) - 1;

  load_tile<HD_PAD>(k_s, k, b, k0, sh.t, kvh, sh.kh, sh.hd);
  load_tile<HD_PAD>(v_s, v, b, k0, sh.t, kvh, sh.kh, sh.hd);

  float adk[4][kC], adv[4][kC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < kC; ++c) adk[r][c] = adv[r][c] = 0.0f;

  for (int64_t g = 0; g < group; ++g) {
    const int64_t h = kvh * group + g;
    for (int64_t qt = 0; qt < n_qt; ++qt) {
      int64_t lo, hi;
      key_band(bounds[2 * qt], bounds[2 * qt + 1], sh.t, causal, window, lo,
               hi);
      if (lo > hi || hi < k0 || lo > k_last) continue;   // block-uniform
      const int64_t q0 = qt * kTile;
      __syncthreads();          // the last tile's reads of q_s .. ds_s
      load_tile<HD_PAD>(q_s, q, b, q0, sh.s, h, sh.hq, sh.hd);
      load_tile<HD_PAD>(do_s, dout, b, q0, sh.s, h, sh.hq, sh.hd);
      load_rows(pos_s, lse_s, dl_s, q_pos, lse, delta, b, h, q0, sh);
      __syncthreads();

      float sc[4][4], dp[4][4];
      scores<HD_PAD>(q_s, do_s, k_s, v_s, ty, tx, sc, dp);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = ty + 16 * r;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = tx + 16 * c;
          const bool ok = q0 + i < sh.s &&
                          attends(pos_s[i], k0 + j, sh.t, causal, window);
          const float p = ok ? expf(fmaf(sc[r][c], scale, -lse_s[i])) : 0.0f;
          p_s[i * kPLd + j] = p;
          ds_s[i * kPLd + j] = ok ? p * (dp[r][c] - dl_s[i]) : 0.0f;
        }
      }
      __syncthreads();

      // dV += P^T dO, dK += dS^T Q over the tile's 64 rows
#pragma unroll 4
      for (int i = 0; i < kTile; ++i) {
        float pa[4], sa[4], db[kC], qb[kC];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          pa[r] = p_s[i * kPLd + ty + 16 * r];
          sa[r] = ds_s[i * kPLd + ty + 16 * r];
        }
#pragma unroll
        for (int c = 0; c < kC; ++c) {
          db[c] = do_s[i * kLd + tx + 16 * c];
          qb[c] = q_s[i * kLd + tx + 16 * c];
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < kC; ++c) {
            adv[r][c] = fmaf(pa[r], db[c], adv[r][c]);
            adk[r][c] = fmaf(sa[r], qb[c], adk[r][c]);
          }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int64_t key = k0 + ty + 16 * r;
    if (key >= sh.t) continue;
    const int64_t base = ((b * sh.t + key) * sh.kh + kvh) * sh.hd;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const int64_t d = tx + 16 * c;
      if (d >= sh.hd) continue;
      dk[base + d] = adk[r][c] * scale;
      dv[base + d] = adv[r][c];
    }
  }
}

// pass 3: dQ of one 64-row query tile of one query head
template <int HD_PAD>
__global__ void __launch_bounds__(kThreads)
bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              const int32_t* __restrict__ q_pos,
              const int32_t* __restrict__ bounds, float* __restrict__ dq,
              Shape sh, int causal, int64_t window, float scale) {
  using L = BwdLayout<HD_PAD>;
  constexpr int kLd = L::kLd;
  constexpr int kC = HD_PAD / 16;
  extern __shared__ float smem[];
  float* q_s = smem;
  float* do_s = q_s + L::kTileF;
  float* k_s = do_s + L::kTileF;
  float* v_s = k_s + L::kTileF;
  float* ds_s = v_s + L::kTileF;
  __shared__ float lse_s[kTile], dl_s[kTile];
  __shared__ int32_t pos_s[kTile];

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int64_t n_qt = (sh.s + kTile - 1) / kTile;
  // the last query tiles have the longest causal bands: launch them first
  const int64_t qt = n_qt - 1 - (int64_t)blockIdx.x;
  const int64_t q0 = qt * kTile;
  const int64_t h = blockIdx.y, b = blockIdx.z;
  const int64_t kvh = h / (sh.hq / sh.kh);

  load_tile<HD_PAD>(q_s, q, b, q0, sh.s, h, sh.hq, sh.hd);
  load_tile<HD_PAD>(do_s, dout, b, q0, sh.s, h, sh.hq, sh.hd);
  load_rows(pos_s, lse_s, dl_s, q_pos, lse, delta, b, h, q0, sh);
  int64_t lo, hi;
  key_band(bounds[2 * qt], bounds[2 * qt + 1], sh.t, causal, window, lo, hi);

  float adq[4][kC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < kC; ++c) adq[r][c] = 0.0f;

  for (int64_t k0 = lo <= hi ? lo / kTile * kTile : hi + 1; k0 <= hi;
       k0 += kTile) {
    __syncthreads();            // Q / rows loaded; the last tile's reads
    load_tile<HD_PAD>(k_s, k, b, k0, sh.t, kvh, sh.kh, sh.hd);
    load_tile<HD_PAD>(v_s, v, b, k0, sh.t, kvh, sh.kh, sh.hd);
    __syncthreads();

    float sc[4][4], dp[4][4];
    scores<HD_PAD>(q_s, do_s, k_s, v_s, ty, tx, sc, dp);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = ty + 16 * r;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = tx + 16 * c;
        const bool ok = q0 + i < sh.s &&
                        attends(pos_s[i], k0 + j, sh.t, causal, window);
        const float p = ok ? expf(fmaf(sc[r][c], scale, -lse_s[i])) : 0.0f;
        ds_s[i * kPLd + j] = ok ? p * (dp[r][c] - dl_s[i]) : 0.0f;
      }
    }
    __syncthreads();

    // dQ += dS K over the tile's 64 keys
#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {
      float sa[4], kb[kC];
#pragma unroll
      for (int r = 0; r < 4; ++r) sa[r] = ds_s[(ty + 16 * r) * kPLd + j];
#pragma unroll
      for (int c = 0; c < kC; ++c) kb[c] = k_s[j * kLd + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < kC; ++c) adq[r][c] = fmaf(sa[r], kb[c], adq[r][c]);
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int64_t row = q0 + ty + 16 * r;
    if (row >= sh.s) continue;
    const int64_t base = ((b * sh.s + row) * sh.hq + h) * sh.hd;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const int64_t d = tx + 16 * c;
      if (d < sh.hd) dq[base + d] = adq[r][c] * scale;
    }
  }
}

template <int HD_PAD>
int launch_bwd(cudaStream_t stream, const void* q, const void* k,
               const void* v, const void* o, const void* dout,
               const void* lse, const void* q_pos, void* dq, void* dk,
               void* dv, void* delta, void* bounds, const Shape& sh,
               int causal, int64_t window, float scale) {
  using L = BwdLayout<HD_PAD>;
  const unsigned n_qt = (unsigned)((sh.s + kTile - 1) / kTile);
  const unsigned n_kt = (unsigned)((sh.t + kTile - 1) / kTile);
  bwd_delta_kernel<<<dim3(n_qt, (unsigned)sh.hq, (unsigned)sh.b), kThreads,
                     0, stream>>>(
      (const float*)o, (const float*)dout, (const int32_t*)q_pos,
      (float*)delta, (int32_t*)bounds, sh);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(bwd_dkdv_kernel<HD_PAD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)L::kBytesKV);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(bwd_dq_kernel<HD_PAD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)L::kBytesQ);
  if (err != cudaSuccess) return (int)err;
  bwd_dkdv_kernel<HD_PAD><<<dim3(n_kt, (unsigned)sh.kh, (unsigned)sh.b),
                            kThreads, L::kBytesKV, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout,
      (const float*)lse, (const float*)delta, (const int32_t*)q_pos,
      (const int32_t*)bounds, (float*)dk, (float*)dv, sh, causal, window,
      scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bwd_dq_kernel<HD_PAD><<<dim3(n_qt, (unsigned)sh.hq, (unsigned)sh.b),
                          kThreads, L::kBytesQ, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout,
      (const float*)lse, (const float*)delta, (const int32_t*)q_pos,
      (const int32_t*)bounds, (float*)dq, sh, causal, window, scale);
  return (int)cudaGetLastError();
}

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

// pass 1 of the bf16 route: for 64 rows of one (batch row, head), the
// pairs (L log2 e, D = rowsum(dO o)) into `rows`, (B, Hq, S padded to 64,
// 2) f32, rows past S as (+inf, 0).  o and dO are read through their
// strides (16-byte aligned, as TMA wants them), 8 lanes a row, 16 bytes a
// lane.  The (0, 0) blocks write the tile's least and greatest positions.
__global__ void __launch_bounds__(kThreads)
bwd_rows_kernel(const __nv_bfloat16* __restrict__ o,
                const __nv_bfloat16* __restrict__ dout,
                const float* __restrict__ lse,
                const int32_t* __restrict__ q_pos, float* __restrict__ rows,
                int32_t* __restrict__ bounds, int64_t s_len, int64_t hd,
                Strides os, Strides ds) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int64_t hq = gridDim.y, s_pad = (int64_t)gridDim.x * kTile;
  float* out = rows + ((b * hq + h) * s_pad + qt * kTile) * 2;
  using W = Word<__nv_bfloat16>;
  for (int r = 4 * warp + (lane >> 3); r < kTile; r += kThreads / 8) {
    const int64_t row = qt * kTile + r;
    float acc = 0.0f;
    if (row < s_len) {
      const __nv_bfloat16* op = o + b * os.b + row * os.s + h * os.h;
      const __nv_bfloat16* dp = dout + b * ds.b + row * ds.s + h * ds.h;
      for (int64_t c = W::kN * (lane & 7); c < hd; c += 8 * W::kN) {
        float x[W::kN], y[W::kN];
        if (c + W::kN <= hd) {
          W::unpack(*reinterpret_cast<const uint4*>(op + c), x);
          W::unpack(*reinterpret_cast<const uint4*>(dp + c), y);
        } else {
#pragma unroll
          for (int e = 0; e < W::kN; ++e) {
            x[e] = c + e < hd ? __bfloat162float(op[c + e]) : 0.0f;
            y[e] = c + e < hd ? __bfloat162float(dp[c + e]) : 0.0f;
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
  // pass 1 reads o by 16-byte words, as TMA reads the others
  const int64_t o_size[3] = {b, s_len, hq}, o_step[3] = {os.b, os.s, os.h};
  for (int i = 0; i < 3; ++i) {
    if (o_size[i] > 1 && (o_step[i] * 2) % 16) {
      return (int)cudaErrorMisalignedAddress;
    }
  }
  if ((uintptr_t)o & 15) return (int)cudaErrorMisalignedAddress;
  const unsigned n_qt = (unsigned)((s_len + kTile - 1) / kTile);
  bwd_rows_kernel<<<dim3(n_qt, (unsigned)hq, (unsigned)b), kThreads, 0,
                    stream>>>(
      (const __nv_bfloat16*)o, (const __nv_bfloat16*)dout,
      (const float*)lse, (const int32_t*)q_pos, (float*)rows,
      (int32_t*)bounds, s_len, hd, os, ds);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t kv_bytes = KvLayout<HD_PAD>::kBytes;
  const size_t q_bytes = QLayout<HD_PAD>::kBytes;
  err = cudaFuncSetAttribute(bwd_dkdv_tc_kernel<HD_PAD>,
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

int check_shape(int64_t b, int64_t s_len, int64_t t_len, int64_t hq,
                int64_t kh, int64_t hd) {
  if (b < 1 || s_len < 1 || t_len < 1 || kh < 1 || hq < kh || hq % kh ||
      hd < 1 || hd > 128 || hq > 65535 || b > 65535 ||
      (s_len + kTcBlock - 1) / kTcBlock > 65535 ||
      (t_len + kTcBlock - 1) / kTcBlock > 65535) {
    return (int)cudaErrorInvalidConfiguration;
  }
  return 0;
}

}  // namespace

// f32: q, o, dO, dq (B, S, Hq, hd) and k, v, dk, dv (B, T, Kh, hd)
// contiguous; lse and delta (B, Hq, S) f32 (delta is written); q_pos (S,)
// int32; bounds a (2 * ceil(S / 64),) int32 scratch.  Three kernels on
// `stream`; returns cudaGetLastError() after them, or the error of a check.
extern "C" int flash_attention_bwd_f32(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, const void* q_pos, void* dq, void* dk,
    void* dv, void* delta, void* bounds, int64_t b, int64_t s_len,
    int64_t t_len, int64_t hq, int64_t kh, int64_t hd, int64_t causal,
    int64_t window, float scale, int64_t device, void* stream) {
  cudaError_t err = cudaSetDevice((int)device);
  if (err != cudaSuccess) return (int)err;
  if (b < 1 || s_len < 1 || t_len < 1 || kh < 1 || hq < kh || hq % kh ||
      hd < 1 || hd > 128 || hq > 65535 || kh > 65535 || b > 65535 ||
      (s_len + kTile - 1) / kTile > 2147483647 ||
      (t_len + kTile - 1) / kTile > 2147483647) {
    return (int)cudaErrorInvalidConfiguration;
  }
  const Shape sh{b, s_len, t_len, hq, kh, hd};
  const int c = causal ? 1 : 0;
  if (hd <= 64) {
    return launch_bwd<64>((cudaStream_t)stream, q, k, v, o, dout, lse, q_pos,
                          dq, dk, dv, delta, bounds, sh, c, window, scale);
  }
  return launch_bwd<128>((cudaStream_t)stream, q, k, v, o, dout, lse, q_pos,
                         dq, dk, dv, delta, bounds, sh, c, window, scale);
}

// q, o, dO (B, S, Hq, hd) and k, v (B, T, Kh, hd) bf16, read through
// their (batch, seq, head) strides with the head dim contiguous, 16-byte
// aligned bases and strides (TMA reads q, k, v and dO, pass 1 o and dO by
// 16-byte words); dq, dk, dv contiguous; lse (B, Hq, S) f32; rows a (B, Hq, S padded to 64, 2) f32
// scratch; q_pos (S,) int32; bounds a (2 * ceil(S / 64),) int32 scratch.
// Three kernels on `stream`; returns cudaGetLastError() after them, or the
// error of a check.
extern "C" int flash_attention_bwd_bf16(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, const void* q_pos, void* dq, void* dk,
    void* dv, void* rows, void* bounds, int64_t b, int64_t s_len,
    int64_t t_len, int64_t hq, int64_t kh, int64_t hd, int64_t q_sb,
    int64_t q_ss, int64_t q_sh, int64_t k_sb, int64_t k_st, int64_t k_sh,
    int64_t v_sb, int64_t v_st, int64_t v_sh, int64_t o_sb, int64_t o_ss,
    int64_t o_sh, int64_t d_sb, int64_t d_ss, int64_t d_sh, int64_t causal,
    int64_t window, float scale, int64_t device, void* stream) {
  cudaError_t err = cudaSetDevice((int)device);
  if (err != cudaSuccess) return (int)err;
  const int bad = check_shape(b, s_len, t_len, hq, kh, hd);
  if (bad) return bad;
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_st, k_sh},
      vs{v_sb, v_st, v_sh}, os{o_sb, o_ss, o_sh}, ds{d_sb, d_ss, d_sh};
  const int c = causal ? 1 : 0;
  if (hd <= 64) {
    return launch_tc_bwd<64>((cudaStream_t)stream, q, k, v, o, dout, lse,
                             q_pos, dq, dk, dv, rows, bounds, b, s_len, t_len,
                             hq, kh, hd, qs, ks, vs, os, ds, c, window, scale);
  }
  return launch_tc_bwd<128>((cudaStream_t)stream, q, k, v, o, dout, lse,
                            q_pos, dq, dk, dv, rows, bounds, b, s_len, t_len,
                            hq, kh, hd, qs, ks, vs, os, ds, c, window, scale);
}
