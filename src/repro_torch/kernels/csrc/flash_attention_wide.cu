// Flash attention, forward and backward, for head dims above 128: the wide
// route, hand-written for Hopper on the CUDA cores.
//
// Replaces: the Pallas TPU kernel `flash_attention_kernel` (body
// `_flash_kernel`) in src/repro/kernels/flash_attention/kernel.py, which
// takes any head dim, where the tensor-core routes of flash_attention.cu
// and flash_attention_bwd.cu stop at 256 in both dtypes (their tiles and
// registers are sized for it, hd padded to 256).  The wrapper sends head
// dims above 256 here, on a CUDA tensor (`flash_attention/kernel.py::
// route`); no config has them: the LM's published configs have 64..128,
// the federated LM example at d_model 1024 has 4 heads of 256 (the
// tensor-core kernels, both dtypes).
//
// The same function as the tensor-core routes, in float32 throughout
// (bf16 inputs widened on load, P never rounded; o, dq, dk, dv rounded
// once to the inputs' dtype):
//   s_ij = (q_i . k_j) * scale, key j visible to row i when j < T,
//          causal: j <= pos_i, window > 0: j > pos_i - window;
//   o_i  = sum_j softmax(s_i)_j v_j   over the visible keys,
//   lse_i = m_i + log(max(l_i, 1e-30)) (natural units), o = acc / max(l, 1e-30);
//   backward from lse:  P = exp(s - lse),  D_i = dO_i . o_i,
//   dS = P (dO V^T - D),  dQ = scale dS K,  dK = scale dS^T Q,  dV = P^T dO,
//   dK and dV summed over the G query heads of each KV head (h / G).
//
// The head dim is walked in chunks of 128.  A block owns 8 rows (8 warps,
// a row a warp) and one 128-wide chunk of its outputs (grid z = batch x
// output chunks): the scores' dot products run over every chunk of the
// head dim, staged through shared memory one chunk at a time, and only
// the block's own chunk of O (of dQ, of dK and dV) is accumulated, four
// columns a lane.  So registers and shared memory do not grow with hd
// (any hd works), and the scores are computed once per output chunk: the
// route is simple and correct, not fast.  A tile is 32 keys (forward,
// dQ; a key a lane) or 32 query rows (dK / dV; a row a lane); the dot
// products read their lane's shared-memory row padded to 129 words, so
// the 32 lanes hit 32 banks.  A block visits only the tiles that meet the
// band of its rows (forward, dQ) or of its keys (dK / dV), and skips the
// rest; masked pairs contribute exactly 0.  No atomics: every output
// element has one writer, so two launches are bitwise equal.
//
// Three kernels for the backward: wide_rows_kernel (D a row), then
// wide_dq_kernel and wide_dkdv_kernel, which read D and lse.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRows = 8;                // rows a block: a warp each
constexpr int kThreads = kRows * 32;
constexpr int kTile = 32;               // keys (or query rows) a tile
constexpr int kChunk = 128;             // head-dim columns a chunk
constexpr int kPad = kChunk + 1;        // conflict-free row reads
constexpr int kCols = kChunk / 32;      // output columns a lane
constexpr unsigned kFull = 0xffffffffu;

struct Strides {
  int64_t b, s, h;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}
__device__ __forceinline__ int64_t warp_min64(int64_t x) {
  for (int o = 16; o > 0; o >>= 1) {
    const int64_t y = __shfl_xor_sync(kFull, x, o);
    x = y < x ? y : x;
  }
  return x;
}
__device__ __forceinline__ int64_t warp_max64(int64_t x) {
  for (int o = 16; o > 0; o >>= 1) {
    const int64_t y = __shfl_xor_sync(kFull, x, o);
    x = y > x ? y : x;
  }
  return x;
}

// The visible keys [lo, hi] of a row at position `pos` (empty: lo > hi).
__device__ __forceinline__ void band(int64_t pos, int64_t t_len, int causal,
                                     int64_t window, int64_t* lo,
                                     int64_t* hi) {
  *hi = causal ? (pos < t_len - 1 ? pos : t_len - 1) : t_len - 1;
  *lo = window > 0 ? (pos - window + 1 > 0 ? pos - window + 1 : 0) : 0;
}

// rows x kChunk elements of a (B, L, H, hd) tensor, rows r0.., columns
// c0.., zero outside [0, n) x [0, hd), into a row-major shared array of
// row stride `ld` (every thread of the block takes part).
template <typename T>
__device__ __forceinline__ void stage(float* dst, int ld, int rows,
                                      const T* src, Strides st, int64_t b,
                                      int64_t h, int64_t r0, int64_t n,
                                      int64_t c0, int64_t hd) {
  for (int idx = threadIdx.x; idx < rows * kChunk; idx += kThreads) {
    const int r = idx / kChunk, d = idx % kChunk;
    const int64_t row = r0 + r, col = c0 + d;
    dst[r * ld + d] = (row < n && col < hd)
                          ? to_f(src[b * st.b + row * st.s + h * st.h + col])
                          : 0.f;
  }
}

// The union [lo, hi] of the bands of the block's 8 query rows; every
// thread gets the same pair.
__device__ void block_band(const int32_t* q_pos, int64_t row0, int64_t s_len,
                           int64_t t_len, int causal, int64_t window,
                           int64_t* lo, int64_t* hi) {
  __shared__ int64_t lo_s[kRows], hi_s[kRows];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t row = row0 + warp;
  int64_t l = t_len, h = -1;
  if (row < s_len) band(q_pos[row], t_len, causal, window, &l, &h);
  if (lane == 0) {
    lo_s[warp] = l;
    hi_s[warp] = h;
  }
  __syncthreads();
  *lo = t_len;
  *hi = -1;
  for (int w = 0; w < kRows; ++w) {
    *lo = lo_s[w] < *lo ? lo_s[w] : *lo;
    *hi = hi_s[w] > *hi ? hi_s[w] : *hi;
  }
}

// ------------------------------------------------------------ forward ----
template <typename T>
__global__ void __launch_bounds__(kThreads)
    wide_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, T* __restrict__ o,
                    float* __restrict__ lse, const int32_t* __restrict__ q_pos,
                    int64_t s_len, int64_t t_len, int64_t hq, int64_t hd,
                    int64_t group, int64_t n_chunks, Strides qs, Strides ks,
                    Strides vs, Strides os, int causal, int64_t window,
                    float scale) {
  __shared__ float k_s[kTile * kPad];
  __shared__ float q_s[kRows * kChunk];
  __shared__ float v_s[kTile * kChunk];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t h = blockIdx.y, kvh = h / group;
  const int64_t b = blockIdx.z / n_chunks, c_out = blockIdx.z % n_chunks;
  const int64_t row0 = (int64_t)blockIdx.x * kRows, row = row0 + warp;
  const bool live = row < s_len;
  int64_t lo = t_len, hi = -1;
  if (live) band(q_pos[row], t_len, causal, window, &lo, &hi);
  int64_t blo, bhi;
  block_band(q_pos, row0, s_len, t_len, causal, window, &blo, &bhi);

  float m = -INFINITY, l = 0.f, acc[kCols];
#pragma unroll
  for (int i = 0; i < kCols; ++i) acc[i] = 0.f;
  for (int64_t t0 = blo / kTile * kTile; t0 <= bhi; t0 += kTile) {
    float s = 0.f;
    for (int64_t c0 = 0; c0 < hd; c0 += kChunk) {
      __syncthreads();
      stage(k_s, kPad, kTile, k, ks, b, kvh, t0, t_len, c0, hd);
      stage(q_s, kChunk, kRows, q, qs, b, h, row0, s_len, c0, hd);
      __syncthreads();
#pragma unroll 16
      for (int d = 0; d < kChunk; ++d)
        s = fmaf(q_s[warp * kChunk + d], k_s[lane * kPad + d], s);
    }
    s *= scale;
    const int64_t t = t0 + lane;
    const bool ok = live && t >= lo && t <= hi;
    const float m_new = fmaxf(m, warp_max(ok ? s : -INFINITY));
    const float p = (ok && m_new != -INFINITY) ? expf(s - m_new) : 0.f;
    __syncthreads();
    stage(v_s, kChunk, kTile, v, vs, b, kvh, t0, t_len, c_out * kChunk, hd);
    __syncthreads();
    if (m_new != -INFINITY) {        // warp-uniform: the row has a key
      const float corr = expf(m - m_new);
      l = l * corr + warp_sum(p);
#pragma unroll
      for (int i = 0; i < kCols; ++i) acc[i] *= corr;
      for (int j = 0; j < kTile; ++j) {
        const float pj = __shfl_sync(kFull, p, j);
#pragma unroll
        for (int i = 0; i < kCols; ++i)
          acc[i] = fmaf(pj, v_s[j * kChunk + lane + 32 * i], acc[i]);
      }
      m = m_new;
    }
  }
  if (!live) return;
  const float den = fmaxf(l, 1e-30f);
#pragma unroll
  for (int i = 0; i < kCols; ++i) {
    const int64_t d = c_out * kChunk + lane + 32 * i;
    if (d < hd) o[b * os.b + row * os.s + h * os.h + d] = from_f<T>(acc[i] / den);
  }
  if (lse != nullptr && c_out == 0 && lane == 0)
    lse[(b * hq + h) * s_len + row] = m + logf(den);
}

// ----------------------------------------------------------- backward ----
// D = rowsum(dO o), (B, Hq, S) f32: a warp a row.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    wide_rows_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                     float* __restrict__ rows, int64_t s_len, int64_t hq,
                     int64_t hd, Strides os, Strides ds) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t h = blockIdx.y, b = blockIdx.z;
  const int64_t row = (int64_t)blockIdx.x * kRows + warp;
  if (row >= s_len) return;
  float acc = 0.f;
  for (int64_t d = lane; d < hd; d += 32)
    acc = fmaf(to_f(dout[b * ds.b + row * ds.s + h * ds.h + d]),
               to_f(o[b * os.b + row * os.s + h * os.h + d]), acc);
  acc = warp_sum(acc);
  if (lane == 0) rows[(b * hq + h) * s_len + row] = acc;
}

// dQ: a block of 8 query rows and one output chunk; 32-key tiles.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    wide_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ rows,
                   const int32_t* __restrict__ q_pos, T* __restrict__ dq,
                   int64_t s_len, int64_t t_len, int64_t hq, int64_t hd,
                   int64_t group, int64_t n_chunks, Strides qs, Strides ks,
                   Strides vs, Strides ds, int causal, int64_t window,
                   float scale) {
  __shared__ float k_s[kTile * kPad];
  __shared__ float v_s[kTile * kPad];
  __shared__ float q_s[kRows * kChunk];
  __shared__ float d_s[kRows * kChunk];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t h = blockIdx.y, kvh = h / group;
  const int64_t b = blockIdx.z / n_chunks, c_out = blockIdx.z % n_chunks;
  const int64_t row0 = (int64_t)blockIdx.x * kRows, row = row0 + warp;
  const bool live = row < s_len;
  int64_t lo = t_len, hi = -1;
  float row_lse = 0.f, row_d = 0.f;
  if (live) {
    band(q_pos[row], t_len, causal, window, &lo, &hi);
    row_lse = lse[(b * hq + h) * s_len + row];
    row_d = rows[(b * hq + h) * s_len + row];
  }
  int64_t blo, bhi;
  block_band(q_pos, row0, s_len, t_len, causal, window, &blo, &bhi);

  float acc[kCols];
#pragma unroll
  for (int i = 0; i < kCols; ++i) acc[i] = 0.f;
  for (int64_t t0 = blo / kTile * kTile; t0 <= bhi; t0 += kTile) {
    float s = 0.f, dp = 0.f;
    for (int64_t c0 = 0; c0 < hd; c0 += kChunk) {
      __syncthreads();
      stage(k_s, kPad, kTile, k, ks, b, kvh, t0, t_len, c0, hd);
      stage(v_s, kPad, kTile, v, vs, b, kvh, t0, t_len, c0, hd);
      stage(q_s, kChunk, kRows, q, qs, b, h, row0, s_len, c0, hd);
      stage(d_s, kChunk, kRows, dout, ds, b, h, row0, s_len, c0, hd);
      __syncthreads();
#pragma unroll 16
      for (int d = 0; d < kChunk; ++d) {
        s = fmaf(q_s[warp * kChunk + d], k_s[lane * kPad + d], s);
        dp = fmaf(d_s[warp * kChunk + d], v_s[lane * kPad + d], dp);
      }
    }
    const int64_t t = t0 + lane;
    const bool ok = live && t >= lo && t <= hi;
    const float p = ok ? expf(s * scale - row_lse) : 0.f;
    const float dsc = p * (dp - row_d);
    __syncthreads();
    stage(k_s, kPad, kTile, k, ks, b, kvh, t0, t_len, c_out * kChunk, hd);
    __syncthreads();
    for (int j = 0; j < kTile; ++j) {
      const float dj = __shfl_sync(kFull, dsc, j);
#pragma unroll
      for (int i = 0; i < kCols; ++i)
        acc[i] = fmaf(dj, k_s[j * kPad + lane + 32 * i], acc[i]);
    }
  }
  if (!live) return;
#pragma unroll
  for (int i = 0; i < kCols; ++i) {
    const int64_t d = c_out * kChunk + lane + 32 * i;
    if (d < hd) dq[((b * s_len + row) * hq + h) * hd + d] = from_f<T>(acc[i] * scale);
  }
}

// dK / dV: a block of 8 keys of one KV head and one output chunk; over the
// G query heads of the group and the 32-row query tiles that meet the
// keys.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    wide_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ rows,
                     const int32_t* __restrict__ q_pos, T* __restrict__ dk,
                     T* __restrict__ dv, int64_t s_len, int64_t t_len,
                     int64_t hq, int64_t kh, int64_t hd, int64_t group,
                     int64_t n_chunks, Strides qs, Strides ks, Strides vs,
                     Strides ds, int causal, int64_t window, float scale) {
  __shared__ float q_s[kTile * kPad];
  __shared__ float d_s[kTile * kPad];
  __shared__ float k_s[kRows * kChunk];
  __shared__ float v_s[kRows * kChunk];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t kvh = blockIdx.y;
  const int64_t b = blockIdx.z / n_chunks, c_out = blockIdx.z % n_chunks;
  const int64_t key0 = (int64_t)blockIdx.x * kRows, key = key0 + warp;
  const int64_t key_hi = key0 + kRows - 1;

  float acc_k[kCols], acc_v[kCols];
#pragma unroll
  for (int i = 0; i < kCols; ++i) acc_k[i] = acc_v[i] = 0.f;
  for (int64_t g = 0; g < group; ++g) {
    const int64_t h = kvh * group + g;
    for (int64_t i0 = 0; i0 < s_len; i0 += kTile) {
      const int64_t row = i0 + lane;
      int64_t lo = t_len, hi = -1;
      if (row < s_len) band(q_pos[row], t_len, causal, window, &lo, &hi);
      // every warp reads the same 32 rows: a block-uniform skip
      if (warp_max64(hi) < key0 || warp_min64(lo) > key_hi) continue;
      float s = 0.f, dp = 0.f;
      for (int64_t c0 = 0; c0 < hd; c0 += kChunk) {
        __syncthreads();
        stage(q_s, kPad, kTile, q, qs, b, h, i0, s_len, c0, hd);
        stage(d_s, kPad, kTile, dout, ds, b, h, i0, s_len, c0, hd);
        stage(k_s, kChunk, kRows, k, ks, b, kvh, key0, t_len, c0, hd);
        stage(v_s, kChunk, kRows, v, vs, b, kvh, key0, t_len, c0, hd);
        __syncthreads();
#pragma unroll 16
        for (int d = 0; d < kChunk; ++d) {
          s = fmaf(q_s[lane * kPad + d], k_s[warp * kChunk + d], s);
          dp = fmaf(d_s[lane * kPad + d], v_s[warp * kChunk + d], dp);
        }
      }
      const bool ok = row < s_len && key < t_len && key >= lo && key <= hi;
      float p = 0.f, dsc = 0.f;
      if (ok) {
        p = expf(s * scale - lse[(b * hq + h) * s_len + row]);
        dsc = p * (dp - rows[(b * hq + h) * s_len + row]);
      }
      __syncthreads();
      stage(q_s, kPad, kTile, q, qs, b, h, i0, s_len, c_out * kChunk, hd);
      stage(d_s, kPad, kTile, dout, ds, b, h, i0, s_len, c_out * kChunk, hd);
      __syncthreads();
      for (int r = 0; r < kTile; ++r) {
        const float pr = __shfl_sync(kFull, p, r);
        const float sr = __shfl_sync(kFull, dsc, r);
#pragma unroll
        for (int i = 0; i < kCols; ++i) {
          acc_v[i] = fmaf(pr, d_s[r * kPad + lane + 32 * i], acc_v[i]);
          acc_k[i] = fmaf(sr, q_s[r * kPad + lane + 32 * i], acc_k[i]);
        }
      }
    }
  }
  if (key >= t_len) return;
#pragma unroll
  for (int i = 0; i < kCols; ++i) {
    const int64_t d = c_out * kChunk + lane + 32 * i;
    if (d < hd) {
      const int64_t at = ((b * t_len + key) * kh + kvh) * hd + d;
      dk[at] = from_f<T>(acc_k[i] * scale);
      dv[at] = from_f<T>(acc_v[i]);
    }
  }
}

int check_shape(int64_t b, int64_t s_len, int64_t t_len, int64_t hq,
                int64_t kh, int64_t hd) {
  const int64_t n_chunks = (hd + kChunk - 1) / kChunk;
  if (b < 1 || s_len < 1 || t_len < 1 || kh < 1 || hq < kh || hq % kh ||
      hd < 1 || hq > 65535 || kh > 65535 || b * n_chunks > 65535 ||
      (s_len + kRows - 1) / kRows > 2147483647 ||
      (t_len + kRows - 1) / kRows > 2147483647) {
    return (int)cudaErrorInvalidConfiguration;
  }
  return 0;
}

template <typename T>
int launch_fwd(cudaStream_t stream, const void* q, const void* k,
               const void* v, void* o, void* lse, const void* q_pos,
               int64_t b, int64_t s_len, int64_t t_len, int64_t hq,
               int64_t kh, int64_t hd, Strides qs, Strides ks, Strides vs,
               Strides os, int causal, int64_t window, float scale) {
  const int64_t n_chunks = (hd + kChunk - 1) / kChunk;
  const dim3 grid((unsigned)((s_len + kRows - 1) / kRows), (unsigned)hq,
                  (unsigned)(b * n_chunks));
  wide_fwd_kernel<T><<<grid, kThreads, 0, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, (float*)lse,
      (const int32_t*)q_pos, s_len, t_len, hq, hd, hq / kh, n_chunks, qs, ks,
      vs, os, causal, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(cudaStream_t stream, const void* q, const void* k,
               const void* v, const void* o, const void* dout,
               const void* lse, const void* q_pos, void* dq, void* dk,
               void* dv, void* rows, int64_t b, int64_t s_len, int64_t t_len,
               int64_t hq, int64_t kh, int64_t hd, Strides qs, Strides ks,
               Strides vs, Strides os, Strides ds, int causal, int64_t window,
               float scale) {
  const int64_t n_chunks = (hd + kChunk - 1) / kChunk;
  const unsigned q_blocks = (unsigned)((s_len + kRows - 1) / kRows);
  wide_rows_kernel<T><<<dim3(q_blocks, (unsigned)hq, (unsigned)b), kThreads,
                        0, stream>>>((const T*)o, (const T*)dout,
                                     (float*)rows, s_len, hq, hd, os, ds);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  wide_dq_kernel<T><<<dim3(q_blocks, (unsigned)hq, (unsigned)(b * n_chunks)),
                      kThreads, 0, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
      (const float*)lse, (const float*)rows, (const int32_t*)q_pos, (T*)dq,
      s_len, t_len, hq, hd, hq / kh, n_chunks, qs, ks, vs, ds, causal, window,
      scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  wide_dkdv_kernel<T><<<dim3((unsigned)((t_len + kRows - 1) / kRows),
                             (unsigned)kh, (unsigned)(b * n_chunks)),
                        kThreads, 0, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
      (const float*)lse, (const float*)rows, (const int32_t*)q_pos, (T*)dk,
      (T*)dv, s_len, t_len, hq, kh, hd, hq / kh, n_chunks, qs, ks, vs, ds,
      causal, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// (q, k, v, o, lse or null, q_pos, B, S, T, Hq, Kh, hd, the (b, s, h)
// strides of q, k, v and o, causal, window, scale, device, stream): the
// tensor-core forward entries' arguments.
#define WIDE_FWD_ENTRY(NAME, T)                                               \
  extern "C" int NAME(                                                        \
      const void* q, const void* k, const void* v, void* o, void* lse,        \
      const void* q_pos, int64_t b, int64_t s_len, int64_t t_len, int64_t hq, \
      int64_t kh, int64_t hd, int64_t q_sb, int64_t q_ss, int64_t q_sh,       \
      int64_t k_sb, int64_t k_st, int64_t k_sh, int64_t v_sb, int64_t v_st,   \
      int64_t v_sh, int64_t o_sb, int64_t o_ss, int64_t o_sh, int64_t causal, \
      int64_t window, float scale, int64_t device, void* stream) {            \
    cudaError_t err = cudaSetDevice((int)device);                             \
    if (err != cudaSuccess) return (int)err;                                  \
    const int bad = check_shape(b, s_len, t_len, hq, kh, hd);                 \
    if (bad) return bad;                                                      \
    return launch_fwd<T>((cudaStream_t)stream, q, k, v, o, lse, q_pos, b,     \
                         s_len, t_len, hq, kh, hd,                            \
                         Strides{q_sb, q_ss, q_sh}, Strides{k_sb, k_st, k_sh}, \
                         Strides{v_sb, v_st, v_sh}, Strides{o_sb, o_ss, o_sh}, \
                         causal ? 1 : 0, window, scale);                      \
  }

WIDE_FWD_ENTRY(flash_attention_wide_f32, float)
WIDE_FWD_ENTRY(flash_attention_wide_bf16, __nv_bfloat16)

// (q, k, v, o, dO, lse, q_pos, dq, dk, dv, rows: the (B, Hq, S) f32 D
// scratch, B, S, T, Hq, Kh, hd, the (b, s, h) strides of q, k, v, o and
// dO, causal, window, scale, device, stream); dq, dk and dv contiguous.
#define WIDE_BWD_ENTRY(NAME, T)                                               \
  extern "C" int NAME(                                                        \
      const void* q, const void* k, const void* v, const void* o,             \
      const void* dout, const void* lse, const void* q_pos, void* dq,         \
      void* dk, void* dv, void* rows, int64_t b, int64_t s_len,               \
      int64_t t_len, int64_t hq, int64_t kh, int64_t hd, int64_t q_sb,        \
      int64_t q_ss, int64_t q_sh, int64_t k_sb, int64_t k_st, int64_t k_sh,   \
      int64_t v_sb, int64_t v_st, int64_t v_sh, int64_t o_sb, int64_t o_ss,   \
      int64_t o_sh, int64_t d_sb, int64_t d_ss, int64_t d_sh, int64_t causal, \
      int64_t window, float scale, int64_t device, void* stream) {            \
    cudaError_t err = cudaSetDevice((int)device);                             \
    if (err != cudaSuccess) return (int)err;                                  \
    const int bad = check_shape(b, s_len, t_len, hq, kh, hd);                 \
    if (bad) return bad;                                                      \
    return launch_bwd<T>(                                                     \
        (cudaStream_t)stream, q, k, v, o, dout, lse, q_pos, dq, dk, dv, rows, \
        b, s_len, t_len, hq, kh, hd, Strides{q_sb, q_ss, q_sh},               \
        Strides{k_sb, k_st, k_sh}, Strides{v_sb, v_st, v_sh},                 \
        Strides{o_sb, o_ss, o_sh}, Strides{d_sb, d_ss, d_sh},                 \
        causal ? 1 : 0, window, scale);                                       \
  }

WIDE_BWD_ENTRY(flash_attention_wide_bwd_f32, float)
WIDE_BWD_ENTRY(flash_attention_wide_bwd_bf16, __nv_bfloat16)
