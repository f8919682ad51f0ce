// Batched weighted model averaging (the dense GTG-Shapley oracle's
// contraction), hand-written for Hopper.
//
// Replaces: the Pallas TPU kernel `weighted_avg_kernel` (body
// `_wavg_kernel`) in src/repro/kernels/weighted_avg/kernel.py.
//
// Computes, for every leaf of a parameter tree, out[r, :] = sum_k
// weights[r, k] * stacked[k, :] for (R, M) weights and the leaf's (M, D)
// client stack, accumulating in float32 in the fixed order k = 0 .. M-1
// (one fmaf chain from 0), whatever the input dtype.
//
// What bounds it on the H100: bytes written.  M is the cohort (5 on the
// main path), so the product has 2*M flops per output and reads M*D
// inputs against R*D outputs: at R = 1250 the writes are ~250x the reads,
// 890 MB of f32 for the MLP's six leaves, far more than the 50 MB L2.
//
// What the design does about it:
// - One launch for the whole tree.  The wrapper passes a table of leaves
//   (stack, output, D, first column block, vector width) by value in the
//   kernel's parameters; grid.x runs over the column blocks of all leaves
//   one after the other, grid.y over groups of `rows` weight rows, so a
//   10-wide leaf shares the grid of the 156,800-wide one.
// - Each thread owns the consecutive columns of one 16-byte word (4 f32
//   or 8 bf16), loads their M stack values into registers once (kChunk at a
//   time), then walks its block's rows: per row it reads the weights from
//   shared memory (a broadcast) and writes one 16-byte word with an
//   evict-first store, since the output does not fit in L2.  For M above
//   kChunk the stack values are reloaded per row, chunk by chunk, in the
//   same k order.
// - A leaf whose D is not a multiple of a word's elements, or whose stack
//   or output is not 16-byte aligned, takes the same loop with one column
//   per thread and scalar stores, inside the same launch.  Offsets are
//   64-bit.
#include "common.cuh"

namespace {

constexpr int kThreads = kWordThreads;
constexpr int kChunk = 8;        // stack values per column held at a time

// Rows r0 .. r0+nr-1 of one leaf at this thread's columns of `tile`.
template <typename T, bool kWide>
__device__ __forceinline__ void average_tile(const WordLeaf& leaf,
                                             int64_t tile, const float* w_s,
                                             int64_t r0, int64_t nr,
                                             int64_t m) {
  constexpr int V = Cols<T, kWide>::kN;
  const int64_t d = leaf.d;
  const int64_t col = (tile * kThreads + threadIdx.x) * V;
  if (col >= d) return;
  const T* src = static_cast<const T*>(leaf.src) + col;
  T* out = static_cast<T*>(leaf.out) + col;
  float x[kChunk][V];
  for (int64_t j = 0; j < nr; ++j) {
    float acc[V];
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = 0.0f;
    for (int64_t k0 = 0; k0 < m; k0 += kChunk) {
      if (j == 0 || m > kChunk) {
#pragma unroll
        for (int kk = 0; kk < kChunk; ++kk) {
          if (k0 + kk < m) Cols<T, kWide>::load(src + (k0 + kk) * d, x[kk]);
        }
      }
      const float* w = w_s + j * m + k0;
#pragma unroll
      for (int kk = 0; kk < kChunk; ++kk) {
        if (k0 + kk < m) {
          const float wk = w[kk];
#pragma unroll
          for (int v = 0; v < V; ++v) acc[v] = fmaf(wk, x[kk][v], acc[v]);
        }
      }
    }
    Cols<T, kWide>::store(out + (r0 + j) * d, acc);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
weighted_avg_kernel(const __grid_constant__ WordTable t,
                    const T* __restrict__ weights, int64_t r, int64_t m,
                    int64_t rows) {
  extern __shared__ float w_s[];  // rows * m weights of this block
  const int64_t r0 = (int64_t)blockIdx.y * rows;
  const int64_t nr = (r - r0) < rows ? (r - r0) : rows;
  for (int64_t i = threadIdx.x; i < nr * m; i += kThreads) {
    w_s[i] = Elem<T>::load(weights[r0 * m + i]);
  }
  __syncthreads();
  const WordLeaf& leaf = word_leaf(t, blockIdx.x);
  const int64_t tile = (int64_t)blockIdx.x - leaf.blk0;
  if (leaf.vec == 1) {
    average_tile<T, false>(leaf, tile, w_s, r0, nr, m);
  } else {
    average_tile<T, true>(leaf, tile, w_s, r0, nr, m);
  }
}

template <typename T>
int launch(const int64_t* leaves, int64_t n, const void* weights, int64_t r,
           int64_t m, int64_t rows, int64_t blocks_x, int64_t device,
           void* stream) {
  cudaError_t err = cudaSetDevice((int)device);
  if (err != cudaSuccess) return (int)err;
  const int64_t blocks_y = rows < 1 ? 0 : (r + rows - 1) / rows;
  if (rows < 1 || blocks_y < 1 || blocks_y > 65535 ||
      rows * m * 4 > 48 * 1024) {
    return (int)cudaErrorInvalidConfiguration;
  }
  WordTable t;
  err = fill_word_table<T>(leaves, n, blocks_x, &t);
  if (err != cudaSuccess) return (int)err;
  weighted_avg_kernel<T><<<dim3((unsigned)blocks_x, (unsigned)blocks_y),
                           kThreads, rows * m * sizeof(float),
                           (cudaStream_t)stream>>>(t, (const T*)weights, r,
                                                   m, rows);
  return (int)cudaGetLastError();
}

}  // namespace

// leaves: n rows of kWordLeafFields int64 in host memory (src, out, d,
// blk0, vec), in increasing blk0; the kernel takes them by value.
extern "C" int weighted_avg_f32(const int64_t* leaves, int64_t n,
                                const void* weights, int64_t r, int64_t m,
                                int64_t rows, int64_t blocks_x,
                                int64_t device, void* stream) {
  return launch<float>(leaves, n, weights, r, m, rows, blocks_x, device,
                       stream);
}

extern "C" int weighted_avg_bf16(const int64_t* leaves, int64_t n,
                                 const void* weights, int64_t r, int64_t m,
                                 int64_t rows, int64_t blocks_x,
                                 int64_t device, void* stream) {
  return launch<__nv_bfloat16>(leaves, n, weights, r, m, rows, blocks_x,
                               device, stream);
}
