// Batched weighted model averaging (the dense GTG-Shapley oracle's
// contraction), hand-written for Hopper.
//
// Replaces: the Pallas TPU kernel `weighted_avg_kernel` (body
// `_wavg_kernel`) in src/repro/kernels/weighted_avg/kernel.py.
//
// Computes out[r, :] = sum_k weights[r, k] * stacked[k, :] for (R, M)
// weights and an (M, D) client stack, accumulating in float32 in the fixed
// order k = 0 .. M-1, whatever the input dtype.
//
// What bounds it on the H100: bytes written.  M is the cohort (5 on the
// main path), so the product has 2*M flops per output and reads M*D
// inputs against R*D outputs: at R = 1250 the writes are ~250x the reads.
//
// What the simple design does about it: grid (ceil(D/256), ceil(R/rows));
// a block stages its `rows` weight rows in shared memory, and each thread
// owns one column, reading its M stack values from L1/L2 (the whole stack
// is a few MB) and writing `rows` outputs, so every warp stores 32
// consecutive elements.  The ragged edge of D is masked and offsets are
// 64-bit.  Tensor cores, wider stores and TMA are later work.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
weighted_avg_kernel(const T* __restrict__ stacked,
                    const T* __restrict__ weights, T* __restrict__ out,
                    int64_t r, int64_t m, int64_t d, int64_t rows) {
  extern __shared__ float w_s[];  // rows * m weights of this block
  const int64_t r0 = (int64_t)blockIdx.y * rows;
  const int64_t nr = (r - r0) < rows ? (r - r0) : rows;
  for (int64_t i = threadIdx.x; i < nr * m; i += kThreads) {
    w_s[i] = Elem<T>::load(weights[r0 * m + i]);
  }
  __syncthreads();
  const int64_t col = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (col >= d) return;
  for (int64_t j = 0; j < nr; ++j) {
    float acc = 0.0f;
    for (int64_t k = 0; k < m; ++k) {
      acc = fmaf(w_s[j * m + k], Elem<T>::load(stacked[k * d + col]), acc);
    }
    out[(r0 + j) * d + col] = Elem<T>::store(acc);
  }
}

template <typename T>
int launch(const void* stacked, const void* weights, void* out, int64_t r,
           int64_t m, int64_t d, int64_t rows, int64_t device,
           void* stream) {
  cudaError_t err = cudaSetDevice((int)device);
  if (err != cudaSuccess) return (int)err;
  const int64_t blocks_y = (r + rows - 1) / rows;
  if (rows < 1 || blocks_y > 65535 || rows * m * 4 > 48 * 1024) {
    return (int)cudaErrorInvalidConfiguration;
  }
  const dim3 grid((unsigned)((d + kThreads - 1) / kThreads),
                  (unsigned)blocks_y);
  weighted_avg_kernel<T><<<grid, kThreads, rows * m * sizeof(float),
                           (cudaStream_t)stream>>>(
      (const T*)stacked, (const T*)weights, (T*)out, r, m, d, rows);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int weighted_avg_f32(const void* stacked, const void* weights,
                                void* out, int64_t r, int64_t m, int64_t d,
                                int64_t rows, int64_t device, void* stream) {
  return launch<float>(stacked, weights, out, r, m, d, rows, device, stream);
}

extern "C" int weighted_avg_bf16(const void* stacked, const void* weights,
                                 void* out, int64_t r, int64_t m, int64_t d,
                                 int64_t rows, int64_t device, void* stream) {
  return launch<__nv_bfloat16>(stacked, weights, out, r, m, d, rows, device,
                               stream);
}
