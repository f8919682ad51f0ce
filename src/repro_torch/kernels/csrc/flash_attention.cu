// Causal flash attention with an optional sliding window and GQA,
// hand-written for Hopper.
//
// Replaces: the Pallas TPU kernel `flash_attention_kernel` (body
// `_flash_kernel`) in src/repro/kernels/flash_attention/kernel.py, and on
// the LM's prefill path the pure-JAX online-softmax scan `flash_attention`
// in src/repro/models/lm/attention.py.
//
// Computes, for every batch b, query head h and query row i:
//   s_j = (q_i . k_j) * scale                      (float32; scale = hd^-0.5)
//   s_j = NEG_INF (the finite -1e30) where key j is masked:
//         causal: j <= pos_i;  window > 0: j > pos_i - window
//   o_i = sum_j softmax(s)_j v_j                   (in q's dtype)
// by the online softmax over 64-key tiles, with (m, l, acc) in float32 and
// o = acc / max(l, 1e-30), as the TPU kernel does.  bf16 inputs are widened
// to float32 when a tile is staged, before both products.  Key positions
// are 0 .. T-1; query positions come from `q_pos` (0 .. S-1 on prefill).
// Query head h reads KV head h / G (G = Hq / Kh), the grouping of the
// reference's reshape (B, S, Kh, G, hd): KV is never repeated in memory.
// q, k, v and o are read and written through their (batch, seq, head)
// strides, so the model's (B, S, H, hd) tensors need no transpose.
//
// Tile skipping: a block visits only the key tiles that meet the band
// [min pos - window + 1, max pos] of its 64 rows, so the window path costs
// O(S * W), not O(S^2).  Under the finite sentinel this gives the same
// result as visiting every tile: a row whose first visited tile is fully
// masked accumulates junk (p = exp(0) = 1), and its first valid tile wipes
// it (corr = exp(-1e30 - m) = 0).  Rows with no valid key at all (only
// possible when pos_i >= T + window - 1 or pos_i < 0) come out 0, where
// the dense version averages every v; the LM never makes such rows.
//
// What bounds it on the H100: operations.  At the H2O-Danube-3-4B prefill
// (B = 4, Hq = 32, Kh = 8, S = T = 8192, hd = 120, window 4096, bf16) a
// layer has 3.22e9 unmasked (query, key) pairs, 480 flops each over the two
// products: 1.55 TFLOP, 1.57 ms at the 989 TFLOP/s bf16 tensor-core peak,
// against 0.63 GB of q/k/v/o traffic, 0.19 ms at 3.35 TB/s.
//
// What this simple design does about it: it runs both products in float32
// FMA on the CUDA cores (67 TFLOP/s peak), so it cannot reach that bound;
// it keeps the arithmetic the reference's (f32 products, exact division)
// and gets the memory side right.  One block of 256 threads per (64-row
// query tile, head, batch); Q and each K/V tile are staged in shared
// memory as float32 rows padded to 4 floats past 64 or 128 columns (head
// dims up to 128, the pad zeroed, so hd = 120 needs no special case);
// each thread owns 4 rows x 4 keys of a score tile and 4 rows x hd/16
// columns of the accumulator, with 16-byte shared-memory reads that are
// free of bank conflicts.  Per-row (m, l) live in registers, reduced over
// the 16 threads of a row by warp shuffles.  Ragged S and T are masked:
// keys past T are -inf (they do not exist), rows past S are not stored.
// Tensor cores (wgmma on bf16 tiles), TMA and a pipeline of tiles are a
// later PR's work.
#include <math_constants.h>

#include "common.cuh"

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;

template <int HD_PAD>
struct Layout {
  static constexpr int kRow = HD_PAD + 4;      // q/k/v row stride, floats
  static constexpr int kPRow = kBlockK + 4;    // score row stride, floats
  static constexpr int kCols = HD_PAD / 16;    // acc columns per thread
  static constexpr size_t kBytes =
      sizeof(float) * (3 * kBlockQ * kRow + kBlockQ * kPRow);
};

struct Strides {
  int64_t b, s, h;
};

// Stage rows [row0, row0 + n) of one head as float32, zero past n and hd.
template <typename T, int HD_PAD>
__device__ __forceinline__ void stage(float* dst, const T* src, Strides st,
                                      int64_t row0, int64_t n, int64_t hd) {
  constexpr int kRow = Layout<HD_PAD>::kRow;
  for (int i = threadIdx.x; i < kBlockQ * HD_PAD; i += kThreads) {
    const int r = i / HD_PAD, d = i % HD_PAD;
    float x = 0.0f;
    if (r < n && d < hd) x = Elem<T>::load(src[(row0 + r) * st.s + d]);
    dst[r * kRow + d] = x;
  }
}

template <typename T, int HD_PAD>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o,
             const int32_t* __restrict__ q_pos, int64_t s_len, int64_t t_len,
             int64_t group, int64_t hd, Strides qs, Strides ks, Strides vs,
             Strides os, int causal, int64_t window, float scale) {
  using L = Layout<HD_PAD>;
  constexpr int kRow = L::kRow, kPRow = L::kPRow, kCols = L::kCols;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);   // [kBlockQ][kRow]
  float* k_s = q_s + kBlockQ * kRow;              // [kBlockK][kRow]
  float* v_s = k_s + kBlockK * kRow;              // [kBlockK][kRow]
  float* p_s = v_s + kBlockK * kRow;              // [kBlockQ][kPRow]
  __shared__ int32_t pos_s[kBlockQ];

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;   // rows ty*4.., keys tx + 16j
  const int64_t q0 = (int64_t)blockIdx.x * kBlockQ;
  const int64_t h = blockIdx.y, b = blockIdx.z, kvh = h / group;
  const int64_t nq = (s_len - q0) < kBlockQ ? (s_len - q0) : kBlockQ;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + kvh * ks.h;
  const T* vb = v + b * vs.b + kvh * vs.h;
  T* ob = o + b * os.b + h * os.h;

  stage<T, HD_PAD>(q_s, qb, qs, q0, nq, hd);
  // rows past S take row 0's position, which leaves the band unchanged
  if (tid < kBlockQ) pos_s[tid] = q_pos[q0 + (tid < nq ? tid : 0)];
  __syncthreads();

  int64_t pos[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) pos[i] = pos_s[ty * 4 + i];
  int64_t qmin = pos_s[0], qmax = pos_s[0];
  for (int r = 1; r < kBlockQ; ++r) {
    qmin = pos_s[r] < qmin ? pos_s[r] : qmin;
    qmax = pos_s[r] > qmax ? pos_s[r] : qmax;
  }
  int64_t k_lo = 0, k_hi = t_len - 1;
  if (causal && qmax < k_hi) k_hi = qmax;
  if (window > 0 && qmin - window + 1 > k_lo) k_lo = qmin - window + 1;

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.0f;
  }
  const int hd4 = (int)((hd + 3) & ~int64_t(3));

  for (int64_t kt = k_lo / kBlockK * kBlockK; k_lo <= k_hi && kt <= k_hi;
       kt += kBlockK) {
    const int64_t nk = (t_len - kt) < kBlockK ? (t_len - kt) : kBlockK;
    __syncthreads();                 // the last tile's readers are done
    stage<T, HD_PAD>(k_s, kb, ks, kt, nk, hd);
    stage<T, HD_PAD>(v_s, vb, vs, kt, nk, hd);
    __syncthreads();

    // scores: rows ty*4 + i, keys tx + 16 j
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.0f;
    for (int d = 0; d < hd4; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(&q_s[(ty * 4 + i) * kRow + d]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(&k_s[(tx + 16 * j) * kRow + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float a = sc[i][j];
          a = fmaf(qv[i].x, kv[j].x, a);
          a = fmaf(qv[i].y, kv[j].y, a);
          a = fmaf(qv[i].z, kv[j].z, a);
          a = fmaf(qv[i].w, kv[j].w, a);
          sc[i][j] = a;
        }
    }

    // mask, online softmax, probabilities to shared memory
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float rmax = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const int64_t kp = kt + c;
        float s;
        if (c >= nk) {
          s = -CUDART_INF_F;             // past T: not a key
        } else if ((causal && kp > pos[i]) ||
                   (window > 0 && kp <= pos[i] - window)) {
          s = kNegInf;
        } else {
          s = sc[i][j] * scale;
        }
        sc[i][j] = s;
        rmax = fmaxf(rmax, s);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off, 16));
      const float m_new = fmaxf(m[i], rmax);
      float rsum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(sc[i][j] - m_new);
        p_s[(ty * 4 + i) * kPRow + tx + 16 * j] = p;
        rsum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rsum += __shfl_xor_sync(0xffffffffu, rsum, off, 16);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + rsum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

    // acc += P V: rows ty*4 + i, columns 64 u + 4 tx + e
    for (int c = 0; c < kBlockK; c += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(&p_s[(ty * 4 + i) * kPRow + c]);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
#pragma unroll
        for (int u = 0; u < kCols / 4; ++u) {
          const float4 vv = *reinterpret_cast<const float4*>(
              &v_s[(c + cc) * kRow + 64 * u + 4 * tx]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = cc == 0 ? pv[i].x : cc == 1 ? pv[i].y
                          : cc == 2 ? pv[i].z : pv[i].w;
            acc[i][4 * u + 0] = fmaf(p, vv.x, acc[i][4 * u + 0]);
            acc[i][4 * u + 1] = fmaf(p, vv.y, acc[i][4 * u + 1]);
            acc[i][4 * u + 2] = fmaf(p, vv.z, acc[i][4 * u + 2]);
            acc[i][4 * u + 3] = fmaf(p, vv.w, acc[i][4 * u + 3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (r >= nq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int64_t d = 64 * (c / 4) + 4 * tx + (c % 4);
      if (d < hd) ob[(q0 + r) * os.s + d] = Elem<T>::store(acc[i][c] / denom);
    }
  }
}

template <typename T, int HD_PAD>
int launch_hd(dim3 grid, cudaStream_t stream, const void* q, const void* k,
              const void* v, void* o, const void* q_pos, int64_t s_len,
              int64_t t_len, int64_t group, int64_t hd, Strides qs,
              Strides ks, Strides vs, Strides os, int causal, int64_t window,
              float scale) {
  const size_t bytes = Layout<HD_PAD>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, HD_PAD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  flash_kernel<T, HD_PAD><<<grid, kThreads, bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, (const int32_t*)q_pos,
      s_len, t_len, group, hd, qs, ks, vs, os, causal, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o,
           const void* q_pos, int64_t b, int64_t s_len, int64_t t_len,
           int64_t hq, int64_t kh, int64_t hd, int64_t q_sb, int64_t q_ss,
           int64_t q_sh, int64_t k_sb, int64_t k_st, int64_t k_sh,
           int64_t v_sb, int64_t v_st, int64_t v_sh, int64_t o_sb,
           int64_t o_ss, int64_t o_sh, int64_t causal, int64_t window,
           float scale, int64_t device, void* stream) {
  cudaError_t err = cudaSetDevice((int)device);
  if (err != cudaSuccess) return (int)err;
  const int64_t n_qt = (s_len + kBlockQ - 1) / kBlockQ;
  if (b < 1 || s_len < 1 || t_len < 1 || kh < 1 || hq < kh || hq % kh ||
      hd < 1 || hd > 128 || n_qt > 2147483647 || hq > 65535 || b > 65535) {
    return (int)cudaErrorInvalidConfiguration;
  }
  const dim3 grid((unsigned)n_qt, (unsigned)hq, (unsigned)b);
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_st, k_sh},
      vs{v_sb, v_st, v_sh}, os{o_sb, o_ss, o_sh};
  const int c = causal ? 1 : 0;
  if (hd <= 64) {
    return launch_hd<T, 64>(grid, (cudaStream_t)stream, q, k, v, o, q_pos,
                            s_len, t_len, hq / kh, hd, qs, ks, vs, os, c,
                            window, scale);
  }
  return launch_hd<T, 128>(grid, (cudaStream_t)stream, q, k, v, o, q_pos,
                           s_len, t_len, hq / kh, hd, qs, ks, vs, os, c,
                           window, scale);
}

}  // namespace

#define FLASH_ENTRY(NAME, T)                                                 \
  extern "C" int NAME(const void* q, const void* k, const void* v, void* o,  \
                      const void* q_pos, int64_t b, int64_t s_len,           \
                      int64_t t_len, int64_t hq, int64_t kh, int64_t hd,     \
                      int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb, \
                      int64_t k_st, int64_t k_sh, int64_t v_sb, int64_t v_st, \
                      int64_t v_sh, int64_t o_sb, int64_t o_ss, int64_t o_sh, \
                      int64_t causal, int64_t window, float scale,           \
                      int64_t device, void* stream) {                        \
    return launch<T>(q, k, v, o, q_pos, b, s_len, t_len, hq, kh, hd, q_sb,   \
                     q_ss, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, o_sb,   \
                     o_ss, o_sh, causal, window, scale, device, stream);     \
  }

FLASH_ENTRY(flash_attention_f32, float)
FLASH_ENTRY(flash_attention_bf16, __nv_bfloat16)
