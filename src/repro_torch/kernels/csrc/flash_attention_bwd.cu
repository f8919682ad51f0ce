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
//
// Arithmetic: every product and sum is an f32 FMA on the CUDA cores.  bf16
// inputs widen exactly as a tile is loaded, and the outputs round to the
// input dtype once, at the store.  Tiles are 64 query rows by 64 keys by
// hd padded to 64 or 128, f32 in shared memory with each row padded by one
// word, so that both the row walks and the column walks below are free of
// bank conflicts.  256 threads as 16 x 16: thread (ty, tx) holds S and dP
// at rows ty + 16 r and keys tx + 16 c (r, c < 4), and each accumulator at
// rows ty + 16 r and columns tx + 16 c (c < HD_PAD / 16).  Band skipping:
// pass 1 also writes each 64-row query tile's least and greatest position,
// and passes 2 and 3 visit only the (query tile, key tile) pairs whose
// band [pmin - window + 1, pmax] meets.  Rows past S, keys past T and
// columns past hd load as zeros and are masked or not stored.
//
// Shared memory at HD_PAD 128: pass 2 holds K, V, Q, dO (33 KB each) and
// P, dS (16.6 KB each), 165 KB, one block per SM; pass 3 holds Q, dO, K,
// V and dS, 149 KB.  At HD_PAD 64 they take 100 and 83 KB, two blocks.
// This is the simple, right version; a wgmma / TMA design is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "common.cuh"

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
template <typename T, int HD_PAD>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          int64_t b, int64_t r0, int64_t len,
                                          int64_t h, int64_t heads,
                                          int64_t hd) {
  constexpr int kLd = HD_PAD + 1;
  for (int e = threadIdx.x; e < kTile * HD_PAD; e += kThreads) {
    const int r = e / HD_PAD, c = e % HD_PAD;
    const int64_t row = r0 + r;
    float x = 0.0f;
    if (row < len && c < hd) {
      x = Elem<T>::load(src[((b * len + row) * heads + h) * hd + c]);
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

// pass 1: D = rowsum(dO o) for 64 rows of one (batch row, head), and the
// rows' least and greatest positions (written by the (0, 0) blocks)
template <typename T>
__global__ void __launch_bounds__(kThreads)
bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
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
      acc = fmaf(Elem<T>::load(dout[off + c]), Elem<T>::load(o[off + c]),
                 acc);
    }
#pragma unroll
    for (int x = 16; x > 0; x >>= 1) {
      acc += __shfl_xor_sync(0xffffffffu, acc, x);
    }
    if (lane == 0) delta[(b * sh.hq + h) * sh.s + row] = acc;
  }
  if (h == 0 && b == 0 && warp == 0) {
    int32_t mn = INT_MAX, mx = INT_MIN;
    for (int r = lane; r < kTile; r += 32) {
      const int64_t row = qt * kTile + r;
      if (row < sh.s) {
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
}

// pass 2: dK and dV of one 64-key tile of one KV head
template <typename T, int HD_PAD>
__global__ void __launch_bounds__(kThreads)
bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta,
                const int32_t* __restrict__ q_pos,
                const int32_t* __restrict__ bounds, T* __restrict__ dk,
                T* __restrict__ dv, Shape sh, int causal, int64_t window,
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

  load_tile<T, HD_PAD>(k_s, k, b, k0, sh.t, kvh, sh.kh, sh.hd);
  load_tile<T, HD_PAD>(v_s, v, b, k0, sh.t, kvh, sh.kh, sh.hd);

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
      load_tile<T, HD_PAD>(q_s, q, b, q0, sh.s, h, sh.hq, sh.hd);
      load_tile<T, HD_PAD>(do_s, dout, b, q0, sh.s, h, sh.hq, sh.hd);
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
      dk[base + d] = Elem<T>::store(adk[r][c] * scale);
      dv[base + d] = Elem<T>::store(adv[r][c]);
    }
  }
}

// pass 3: dQ of one 64-row query tile of one query head
template <typename T, int HD_PAD>
__global__ void __launch_bounds__(kThreads)
bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              const int32_t* __restrict__ q_pos,
              const int32_t* __restrict__ bounds, T* __restrict__ dq,
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

  load_tile<T, HD_PAD>(q_s, q, b, q0, sh.s, h, sh.hq, sh.hd);
  load_tile<T, HD_PAD>(do_s, dout, b, q0, sh.s, h, sh.hq, sh.hd);
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
    load_tile<T, HD_PAD>(k_s, k, b, k0, sh.t, kvh, sh.kh, sh.hd);
    load_tile<T, HD_PAD>(v_s, v, b, k0, sh.t, kvh, sh.kh, sh.hd);
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
      if (d < sh.hd) dq[base + d] = Elem<T>::store(adq[r][c] * scale);
    }
  }
}

template <typename T, int HD_PAD>
int launch_bwd(cudaStream_t stream, const void* q, const void* k,
               const void* v, const void* o, const void* dout,
               const void* lse, const void* q_pos, void* dq, void* dk,
               void* dv, void* delta, void* bounds, const Shape& sh,
               int causal, int64_t window, float scale) {
  using L = BwdLayout<HD_PAD>;
  const unsigned n_qt = (unsigned)((sh.s + kTile - 1) / kTile);
  const unsigned n_kt = (unsigned)((sh.t + kTile - 1) / kTile);
  bwd_delta_kernel<T><<<dim3(n_qt, (unsigned)sh.hq, (unsigned)sh.b),
                        kThreads, 0, stream>>>(
      (const T*)o, (const T*)dout, (const int32_t*)q_pos, (float*)delta,
      (int32_t*)bounds, sh);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(bwd_dkdv_kernel<T, HD_PAD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)L::kBytesKV);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(bwd_dq_kernel<T, HD_PAD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)L::kBytesQ);
  if (err != cudaSuccess) return (int)err;
  bwd_dkdv_kernel<T, HD_PAD><<<dim3(n_kt, (unsigned)sh.kh, (unsigned)sh.b),
                               kThreads, L::kBytesKV, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
      (const float*)lse, (const float*)delta, (const int32_t*)q_pos,
      (const int32_t*)bounds, (T*)dk, (T*)dv, sh, causal, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bwd_dq_kernel<T, HD_PAD><<<dim3(n_qt, (unsigned)sh.hq, (unsigned)sh.b),
                             kThreads, L::kBytesQ, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
      (const float*)lse, (const float*)delta, (const int32_t*)q_pos,
      (const int32_t*)bounds, (T*)dq, sh, causal, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int bwd_entry(const void* q, const void* k, const void* v, const void* o,
              const void* dout, const void* lse, const void* q_pos, void* dq,
              void* dk, void* dv, void* delta, void* bounds, int64_t b,
              int64_t s_len, int64_t t_len, int64_t hq, int64_t kh,
              int64_t hd, int64_t causal, int64_t window, float scale,
              int64_t device, void* stream) {
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
    return launch_bwd<T, 64>((cudaStream_t)stream, q, k, v, o, dout, lse,
                             q_pos, dq, dk, dv, delta, bounds, sh, c, window,
                             scale);
  }
  return launch_bwd<T, 128>((cudaStream_t)stream, q, k, v, o, dout, lse,
                            q_pos, dq, dk, dv, delta, bounds, sh, c, window,
                            scale);
}

}  // namespace

// q, o, dO, dq (B, S, Hq, hd) and k, v, dk, dv (B, T, Kh, hd) contiguous
// in one dtype; lse and delta (B, Hq, S) f32 (delta is written); q_pos (S,)
// int32; bounds a (2 * ceil(S / 64),) int32 scratch.  Three kernels on
// `stream`; returns cudaGetLastError() after them, or the error of a check.
extern "C" int flash_attention_bwd_f32(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, const void* q_pos, void* dq, void* dk,
    void* dv, void* delta, void* bounds, int64_t b, int64_t s_len,
    int64_t t_len, int64_t hq, int64_t kh, int64_t hd, int64_t causal,
    int64_t window, float scale, int64_t device, void* stream) {
  return bwd_entry<float>(q, k, v, o, dout, lse, q_pos, dq, dk, dv, delta,
                          bounds, b, s_len, t_len, hq, kh, hd, causal,
                          window, scale, device, stream);
}

extern "C" int flash_attention_bwd_bf16(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, const void* q_pos, void* dq, void* dk,
    void* dv, void* delta, void* bounds, int64_t b, int64_t s_len,
    int64_t t_len, int64_t hq, int64_t kh, int64_t hd, int64_t causal,
    int64_t window, float scale, int64_t device, void* stream) {
  return bwd_entry<__nv_bfloat16>(q, k, v, o, dout, lse, q_pos, dq, dk, dv,
                                  delta, bounds, b, s_len, t_len, hq, kh, hd,
                                  causal, window, scale, device, stream);
}
