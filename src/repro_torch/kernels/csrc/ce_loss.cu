// Per-row softmax cross-entropy (the GTG-Shapley utility), hand-written for
// Hopper.
//
// Replaces: the Pallas TPU kernel `ce_loss_kernel` (body `_ce_kernel`) in
// src/repro/kernels/ce_loss/kernel.py.
//
// Computes loss[row] = logsumexp(logits[row, :]) - logits[row, label], with
// label = labels[row % n_labels] (so a batch of B models scored on the same
// L validation rows passes its L labels once), in float32.
//
// What bounds it on the H100: bytes read, rows*V*itemsize, at one expf per
// element; the loss is one float per row.
//
// What the simple design does about it: one block per row (grid-strided
// over rows).  Threads stride over V, so each warp reads consecutive
// logits, and each keeps a running (max, sum) -- the online logsumexp the
// TPU version runs over vocab tiles.  Warps merge their pairs with
// shuffles, then warp 0 merges the warps' pairs from shared memory.  The
// gold logit is read directly at its label (the TPU version picks it by a
// masked sum in the same pass).  The block is 32..256 threads, about eight
// elements per thread, so a 10-class head does not idle 246 threads.
// Vectorised loads and several rows per block for small V are later work.
#include <math.h>

#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;

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

template <typename T>
__global__ void __launch_bounds__(256)
ce_loss_kernel(const T* __restrict__ logits, const int64_t* __restrict__ labels,
               float* __restrict__ out, int64_t rows, int64_t v,
               int64_t n_labels) {
  __shared__ float sh_m[32], sh_s[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  for (int64_t row = blockIdx.x; row < rows; row += gridDim.x) {
    const T* x = logits + row * v;
    float m = -INFINITY, s = 0.0f;
    for (int64_t c = threadIdx.x; c < v; c += blockDim.x) {
      merge(m, s, Elem<T>::load(x[c]), 1.0f);
    }
    warp_merge(m, s);
    if (lane == 0) {
      sh_m[warp] = m;
      sh_s[warp] = s;
    }
    __syncthreads();
    if (warp == 0) {
      m = lane < n_warps ? sh_m[lane] : -INFINITY;
      s = lane < n_warps ? sh_s[lane] : 0.0f;
      warp_merge(m, s);
      if (lane == 0) {
        const float gold = Elem<T>::load(x[labels[row % n_labels]]);
        out[row] = (m + logf(s)) - gold;
      }
    }
    __syncthreads();  // sh_m / sh_s are reused by the next row
  }
}

template <typename T>
int launch(const void* logits, const void* labels, void* out, int64_t rows,
           int64_t v, int64_t n_labels, int64_t threads, int64_t device,
           void* stream) {
  cudaError_t err = cudaSetDevice((int)device);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = (unsigned)(rows < 2147483647 ? rows : 2147483647);
  ce_loss_kernel<T><<<grid, (unsigned)threads, 0, (cudaStream_t)stream>>>(
      (const T*)logits, (const int64_t*)labels, (float*)out, rows, v,
      n_labels);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ce_loss_f32(const void* logits, const void* labels, void* out,
                           int64_t rows, int64_t v, int64_t n_labels,
                           int64_t threads, int64_t device, void* stream) {
  return launch<float>(logits, labels, out, rows, v, n_labels, threads,
                       device, stream);
}

extern "C" int ce_loss_bf16(const void* logits, const void* labels, void* out,
                            int64_t rows, int64_t v, int64_t n_labels,
                            int64_t threads, int64_t device, void* stream) {
  return launch<__nv_bfloat16>(logits, labels, out, rows, v, n_labels,
                               threads, device, stream);
}
