// Per-row softmax cross-entropy (the GTG-Shapley utility), hand-written for
// Hopper.
//
// Replaces: the Pallas TPU kernel `ce_loss_kernel` (body `_ce_kernel`) in
// src/repro/kernels/ce_loss/kernel.py.
//
// Computes loss[row] = logsumexp(logits[row, :]) - logits[row, label], with
// label = labels[row % n_labels] (so a batch of B models scored on the same
// L validation rows passes its L labels once), in float32, for float32 and
// bfloat16 logits.
//
// What bounds it on the H100: bytes read, rows*V*itemsize, at one expf per
// element; the loss is one float per row.
//
// What the design does about it: the rows are contiguous, so every variant
// reads the logits as 16-byte words (scalar code only for the ragged head
// before the first 16-byte boundary and the tail after the last), and the
// grid is persistent: a few 256-thread blocks per SM stride over the work
// instead of one block per row.  The wrapper (`ce_loss/kernel.py::
// launch_plan`) picks one of three variants by V:
//
//   V <= 32      whole rows per thread.  A block owns a chunk of 256 rows,
//                rows*V*itemsize contiguous bytes, and copies it into
//                shared memory with coalesced 16-byte loads; then each
//                thread reduces one row from shared memory (max, then the
//                sum of exp), and the 256 losses are stored coalesced.  At
//                the MNIST head (V = 10, f32) a row is 10 words: read as
//                float pairs, the 16 rows of a half-warp fall on distinct
//                banks, so the row stride needs no padding (padding would
//                turn the copy's 16-byte stores into scattered ones).
//   V <= 4096    one warp per row: each lane keeps a running (max, sum) over
//                its 16-byte words, merged by shuffles; no __syncthreads.
//   V > 4096     one block per row (the vocabulary of an LM head): the same
//                per-thread pass, merged by shuffles and then across warps
//                through shared memory.
//
// The first threshold keeps the chunk (256 rows of at most 32 f32 logits,
// 32 KB) small enough for several blocks per SM; the second is where a
// warp's 32 lanes would each loop over more than 128 logits.
#include <math.h>

#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;          // every variant; rows per chunk too

__device__ __forceinline__ float rescale(float s, float m, float mx) {
  return m == mx ? s : s * expf(m - mx);
}

// merge the partial (m2, s2) into (m, s); an empty partial has m = -inf
__device__ __forceinline__ void merge(float& m, float& s, float m2,
                                      float s2) {
  const float mx = fmaxf(m, m2);
  if (mx == -INFINITY) return;
  s = rescale(s, m, mx) + rescale(s2, m2, mx);
  m = mx;
}

__device__ __forceinline__ void warp_merge(float& m, float& s) {
  for (int off = 16; off > 0; off >>= 1) {
    const float m2 = __shfl_xor_sync(kFull, m, off);
    const float s2 = __shfl_xor_sync(kFull, s, off);
    merge(m, s, m2, s2);
  }
}

// elements of x before its first 16-byte boundary (at most v)
template <typename T>
__device__ __forceinline__ int64_t head_elems(const T* x, int64_t v) {
  const int64_t h = (int64_t)((16 - ((uintptr_t)x & 15)) & 15) / sizeof(T);
  return h < v ? h : v;
}

// This thread's running (max, sum of exp) over its share of the row x[0, v)
// when `n` threads (index `idx`) split it: scalar head and tail, 16-byte
// words in between, four words in flight per thread.
template <typename T>
__device__ __forceinline__ void row_partial(const T* __restrict__ x,
                                            int64_t v, int idx, int n,
                                            float& m, float& s) {
  constexpr int kN = Word<T>::kN;
  const int64_t head = head_elems(x, v);
  const int64_t n_words = (v - head) / kN;
  const int64_t tail = head + n_words * kN;
  for (int64_t c = idx; c < head; c += n) {
    merge(m, s, Elem<T>::load(x[c]), 1.0f);
  }
  for (int64_t c = tail + idx; c < v; c += n) {
    merge(m, s, Elem<T>::load(x[c]), 1.0f);
  }
  const uint4* w = reinterpret_cast<const uint4*>(x + head);
#pragma unroll 4
  for (int64_t i = idx; i < n_words; i += n) {
    float e[kN];
    Word<T>::unpack(__ldg(w + i), e);
    float cm = e[0];
#pragma unroll
    for (int j = 1; j < kN; ++j) cm = fmaxf(cm, e[j]);
    if (cm == -INFINITY) continue;
    if (cm > m) {
      s = rescale(s, m, cm);
      m = cm;
    }
#pragma unroll
    for (int j = 0; j < kN; ++j) s += expf(e[j] - m);
  }
}

__device__ __forceinline__ float finish(float m, float s, float gold) {
  return (m + logf(s)) - gold;
}

// ---- V <= 32: whole rows per thread, the chunk staged in shared memory --
template <typename T>
__global__ void __launch_bounds__(kThreads)
ce_rows_kernel(const T* __restrict__ logits,
               const int64_t* __restrict__ labels, float* __restrict__ out,
               int64_t rows, int64_t v, int64_t n_labels) {
  extern __shared__ uint4 chunk_s[];
  const int64_t n_chunks = (rows + kThreads - 1) / kThreads;
  const int tid = threadIdx.x;
  for (int64_t chunk = blockIdx.x; chunk < n_chunks; chunk += gridDim.x) {
    const int64_t row0 = chunk * kThreads;
    const int64_t n_rows = rows - row0 < kThreads ? rows - row0 : kThreads;
    const T* src = logits + row0 * v;
    const int64_t n = n_rows * v;
    // src's offset into its 16-byte word; the chunk lands at that offset
    // in shared memory, so global and shared words line up
    const int shift = (int)(((uintptr_t)src & 15) / sizeof(T));
    T* dst = reinterpret_cast<T*>(chunk_s) + shift;
    const int64_t head = head_elems(src, n);
    const int64_t n_words = (n - head) / Word<T>::kN;
    const int64_t tail = head + n_words * Word<T>::kN;
    if (tid < head) dst[tid] = src[tid];
    if (tail + tid < n) dst[tail + tid] = src[tail + tid];
    const uint4* sw = reinterpret_cast<const uint4*>(src + head);
    uint4* dw = reinterpret_cast<uint4*>(dst + head);
    for (int64_t i = tid; i < n_words; i += kThreads) dw[i] = __ldg(sw + i);
    __syncthreads();

    if (tid < n_rows) {
      const T* x = dst + (int64_t)tid * v;
      float m = -INFINITY, s = 0.0f;
      if (sizeof(T) == 4 && (v & 1) == 0 && (shift & 1) == 0) {
        const float2* x2 = reinterpret_cast<const float2*>(x);
        for (int64_t c = 0; c < v / 2; ++c) {
          const float2 p = x2[c];
          m = fmaxf(m, fmaxf(p.x, p.y));
        }
        if (m != -INFINITY) {
          for (int64_t c = 0; c < v / 2; ++c) {
            const float2 p = x2[c];
            s += expf(p.x - m) + expf(p.y - m);
          }
        }
      } else {
        for (int64_t c = 0; c < v; ++c) m = fmaxf(m, Elem<T>::load(x[c]));
        if (m != -INFINITY) {
          for (int64_t c = 0; c < v; ++c) s += expf(Elem<T>::load(x[c]) - m);
        }
      }
      const int64_t row = row0 + tid;
      out[row] = finish(m, s, Elem<T>::load(x[labels[row % n_labels]]));
    }
    __syncthreads();  // the next chunk reuses chunk_s
  }
}

// ---- V <= 4096: one warp per row ----------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads)
ce_warp_kernel(const T* __restrict__ logits,
               const int64_t* __restrict__ labels, float* __restrict__ out,
               int64_t rows, int64_t v, int64_t n_labels) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = (int64_t)gridDim.x * (kThreads / 32);
  for (int64_t row = (int64_t)blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
       row < rows; row += warps) {
    const T* x = logits + row * v;
    float m = -INFINITY, s = 0.0f;
    row_partial(x, v, lane, 32, m, s);
    warp_merge(m, s);
    if (lane == 0) {
      out[row] = finish(m, s, Elem<T>::load(x[labels[row % n_labels]]));
    }
  }
}

// ---- V > 4096: one block per row -----------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads)
ce_block_kernel(const T* __restrict__ logits,
                const int64_t* __restrict__ labels, float* __restrict__ out,
                int64_t rows, int64_t v, int64_t n_labels) {
  __shared__ float sh_m[kThreads / 32], sh_s[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int64_t row = blockIdx.x; row < rows; row += gridDim.x) {
    const T* x = logits + row * v;
    float m = -INFINITY, s = 0.0f;
    row_partial(x, v, threadIdx.x, kThreads, m, s);
    warp_merge(m, s);
    if (lane == 0) {
      sh_m[warp] = m;
      sh_s[warp] = s;
    }
    __syncthreads();
    if (warp == 0) {
      m = lane < kThreads / 32 ? sh_m[lane] : -INFINITY;
      s = lane < kThreads / 32 ? sh_s[lane] : 0.0f;
      warp_merge(m, s);
      if (lane == 0) {
        out[row] = finish(m, s, Elem<T>::load(x[labels[row % n_labels]]));
      }
    }
    __syncthreads();  // sh_m / sh_s are reused by the next row
  }
}

enum Variant { kRows = 0, kWarp = 1, kBlock = 2 };

template <typename T>
int launch(const void* logits, const void* labels, void* out, int64_t rows,
           int64_t v, int64_t n_labels, int64_t variant, int64_t blocks,
           int64_t device, void* stream) {
  cudaError_t err = cudaSetDevice((int)device);
  if (err != cudaSuccess) return (int)err;
  if (blocks < 1 || blocks > 2147483647 || v < 1 || rows < 1 ||
      n_labels < 1) {
    return (int)cudaErrorInvalidConfiguration;
  }
  const dim3 grid((unsigned)blocks);
  const cudaStream_t st = (cudaStream_t)stream;
  const T* x = (const T*)logits;
  const int64_t* y = (const int64_t*)labels;
  float* o = (float*)out;
  switch (variant) {
    case kRows: {
      if (v > 32) return (int)cudaErrorInvalidConfiguration;
      // the chunk plus up to one word of lead-in
      const size_t bytes = kThreads * v * sizeof(T) + 16;
      ce_rows_kernel<T><<<grid, kThreads, bytes, st>>>(x, y, o, rows, v,
                                                       n_labels);
      break;
    }
    case kWarp:
      ce_warp_kernel<T><<<grid, kThreads, 0, st>>>(x, y, o, rows, v,
                                                   n_labels);
      break;
    case kBlock:
      ce_block_kernel<T><<<grid, kThreads, 0, st>>>(x, y, o, rows, v,
                                                    n_labels);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// variant: 0 rows per thread, 1 a warp per row, 2 a block per row; blocks:
// the persistent grid (both from ce_loss/kernel.py::launch_plan)
extern "C" int ce_loss_f32(const void* logits, const void* labels, void* out,
                           int64_t rows, int64_t v, int64_t n_labels,
                           int64_t variant, int64_t blocks, int64_t device,
                           void* stream) {
  return launch<float>(logits, labels, out, rows, v, n_labels, variant,
                       blocks, device, stream);
}

extern "C" int ce_loss_bf16(const void* logits, const void* labels, void* out,
                            int64_t rows, int64_t v, int64_t n_labels,
                            int64_t variant, int64_t blocks, int64_t device,
                            void* stream) {
  return launch<__nv_bfloat16>(logits, labels, out, rows, v, n_labels,
                               variant, blocks, device, stream);
}
