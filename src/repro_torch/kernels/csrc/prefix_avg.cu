// Streaming prefix-subset averaging for GTG-Shapley, hand-written for Hopper.
//
// Replaces: the Pallas TPU kernel `prefix_avg_kernel` (body `_prefix_kernel`)
// in src/repro/kernels/prefix_avg/kernel.py.
//
// Computes, for each permutation walk r and position j,
//     S_j = S_{j-1} + n_{pi(j)} * W[pi(j)],   out[r*M + j] = S_j / N_j,
// with float32 accumulation strictly left to right along the walk.
//
// What bounds it on the H100: bytes written.  It reads the (M, D) client
// stack once (later walks hit L2) and writes R*M*D outputs: at the main
// path (M=5, R=250, D=156,800 and 20,000) that is ~3.5 MB read against
// ~884 MB written, with three flops per output element.
//
// What the simple design does about it: one thread per column, grid
// (ceil(D/256), walks), so every warp writes 32 consecutive floats and
// stores coalesce; the accumulator lives in a register across the walk
// (the TPU version keeps it in VMEM), and each block loads its own walk's
// perms/scale/ncum from global memory (the TPU's scalar prefetch).  The
// ragged edge of D is masked, not padded, and output offsets are 64-bit.
// The products, sums and quotients use __fmul_rn/__fadd_rn/__fdiv_rn so
// nvcc cannot contract `acc + s*row` into an FMA: the kernel then equals
// the plain torch walk in ref.py bit for bit.  Wider stores, TMA and
// clusters are later work.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
prefix_avg_kernel(const T* __restrict__ stacked,
                  const int64_t* __restrict__ perms,
                  const float* __restrict__ scale,
                  const float* __restrict__ ncum, T* __restrict__ out,
                  int64_t r, int64_t m, int64_t d) {
  const int64_t col = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (col >= d) return;
  for (int64_t w = blockIdx.y; w < r; w += gridDim.y) {
    float acc = 0.0f;
    for (int64_t j = 0; j < m; ++j) {
      const int64_t p = w * m + j;
      const float g = Elem<T>::load(stacked[perms[p] * d + col]);
      acc = __fadd_rn(acc, __fmul_rn(scale[p], g));
      out[p * d + col] = Elem<T>::store(__fdiv_rn(acc, ncum[p]));
    }
  }
}

template <typename T>
int launch(const void* stacked, const void* perms, const void* scale,
           const void* ncum, void* out, int64_t r, int64_t m, int64_t d,
           int64_t device, void* stream) {
  cudaError_t err = cudaSetDevice((int)device);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((d + kThreads - 1) / kThreads),
                  (unsigned)(r < 65535 ? r : 65535));
  prefix_avg_kernel<T><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)stacked, (const int64_t*)perms, (const float*)scale,
      (const float*)ncum, (T*)out, r, m, d);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int prefix_avg_f32(const void* stacked, const void* perms,
                              const void* scale, const void* ncum, void* out,
                              int64_t r, int64_t m, int64_t d, int64_t device,
                              void* stream) {
  return launch<float>(stacked, perms, scale, ncum, out, r, m, d, device,
                       stream);
}

extern "C" int prefix_avg_bf16(const void* stacked, const void* perms,
                               const void* scale, const void* ncum, void* out,
                               int64_t r, int64_t m, int64_t d, int64_t device,
                               void* stream) {
  return launch<__nv_bfloat16>(stacked, perms, scale, ncum, out, r, m, d,
                               device, stream);
}
