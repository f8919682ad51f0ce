// Streaming prefix-subset averaging for GTG-Shapley, hand-written for Hopper.
//
// Replaces: the Pallas TPU kernel `prefix_avg_kernel` (body `_prefix_kernel`)
// in src/repro/kernels/prefix_avg/kernel.py.
//
// Computes, for every leaf of a parameter tree, each permutation walk r and
// position j,
//     S_j = S_{j-1} + n_{pi(j)} * W[pi(j)],   out[r*M + j] = S_j / N_j,
// with N_j = n_{pi(0)} + ... + n_{pi(j)}, both sums in float32 strictly left
// to right along the walk.
//
// What bounds it on the H100: bytes written.  Each output costs one
// product, one sum and one quotient, and the outputs are R*M times the
// (M, D) stack's rows: a main-path round (the MLP's six leaves, D = 178,110
// in all, M = 5, R = 250 walks) writes 890.55 MB and reads 3.56 MB, 0.2669
// ms at 3.35 TB/s, and the output is 18x the 50 MB L2.
//
// What the design does about it:
// - One launch for the whole tree.  The wrapper passes a table of leaves
//   (stack, output, D, first column block, vector width; common.cuh) by
//   value in the kernel's parameters; grid.x runs over the column blocks of
//   all leaves one after the other, grid.y over groups of `walks` walks:
//   about 8 prefix models a block, one walk at M = 5.  At 56 registers a
//   thread four blocks fit on an SM, and short blocks keep the last of the
//   grid's waves short (12 walks a block make 7.08 waves: 9 % slower on an
//   H100, chip_smoke.py's `c_entry_ms_by_walks`).
// - The walk tables are staged once per block.  A block reads the perms of
//   its walks and n_k, and forms in shared memory each position's client,
//   weight n_k[perm] and running size N_j, summed left to right with
//   __fadd_rn, one 16-byte step a position (read back as one broadcast).
// - Each thread owns the consecutive columns of one 16-byte word (4 f32 or
//   8 bf16).  For M <= kRegRows it loads the M stack words once into
//   registers and picks a position's row with an unrolled compare-select
//   (a dynamic index would send the array to local memory); above that it
//   reloads the row's word per position (L1/L2 hits).  It then walks every
//   walk of its block and writes each prefix model's word with one
//   evict-first 16-byte store, since the output does not fit in L2.
// - A leaf whose D is not a multiple of a word's elements, or whose stack
//   or output is not 16-byte aligned, takes the same loop with one column
//   per thread and scalar stores, inside the same launch.  Offsets are
//   64-bit.
// - The products, sums and quotients use __fmul_rn/__fadd_rn/__fdiv_rn, so
//   nvcc cannot contract `acc + s*row` into an FMA: the kernel equals the
//   plain walk in ref.py bit for bit.  The IEEE quotient is about ten
//   instructions an output; at M = 5 a word's gather, product, sum and
//   quotients issue ~70 instructions against 16 bytes stored, below what the
//   store rate allows.
#include "common.cuh"

namespace {

constexpr int kThreads = kWordThreads;
constexpr int kRegRows = 8;   // clients whose stack words stay in registers
constexpr int kMaxSmem = 48 * 1024;

// The walks of a launch: (r, m) perms and (m,) n_k on the card, `walks`
// of them a block.
struct Walks {
  const int64_t* perms;
  const float* n_k;
  int64_t r, m, walks;
};

// One walk position, staged in shared memory by the block (16 bytes).
struct __align__(16) Step {
  int perm;      // the client at this position
  float scale;   // n_k[perm]
  float ncum;    // running size N_j along the walk
};

// Row p of the kM rows in x (p < kM: the wrapper checks the perms), by
// selects only, so that x stays in registers.
template <int kM, int V>
__device__ __forceinline__ void pick(const float (&x)[kM][V], int p,
                                     float* g) {
#pragma unroll
  for (int v = 0; v < V; ++v) g[v] = x[0][v];
#pragma unroll
  for (int k = 1; k < kM; ++k) {
    const bool hit = p == k;
#pragma unroll
    for (int v = 0; v < V; ++v) g[v] = hit ? x[k][v] : g[v];
  }
}

// Walks w0 .. w0+nw-1 of one leaf at this thread's columns of `tile`;
// kM = M held in registers, or 0 to reload each position's row.
template <typename T, bool kWide, int kM>
__device__ __forceinline__ void walk_tile(const WordLeaf& leaf, int64_t tile,
                                          const Step* steps, int64_t w0,
                                          int64_t nw, int64_t m) {
  constexpr int V = Cols<T, kWide>::kN;
  const int64_t d = leaf.d;
  const int64_t col = (tile * kThreads + threadIdx.x) * V;
  if (col >= d) return;
  const T* src = static_cast<const T*>(leaf.src) + col;
  T* out = static_cast<T*>(leaf.out) + w0 * m * d + col;
  float x[kM > 0 ? kM : 1][V];
  if constexpr (kM > 0) {
#pragma unroll
    for (int k = 0; k < kM; ++k) Cols<T, kWide>::load(src + k * d, x[k]);
  }
  for (int64_t w = 0; w < nw; ++w) {
    float acc[V];
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = 0.0f;
#pragma unroll
    for (int64_t j = 0; j < (kM > 0 ? kM : m); ++j) {
      const Step s = steps[w * m + j];
      float g[V];
      if constexpr (kM > 0) {
        pick<kM, V>(x, s.perm, g);
      } else {
        Cols<T, kWide>::load(src + (int64_t)s.perm * d, g);
      }
      float y[V];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        acc[v] = __fadd_rn(acc[v], __fmul_rn(s.scale, g[v]));
        y[v] = __fdiv_rn(acc[v], s.ncum);
      }
      Cols<T, kWide>::store(out + (w * m + j) * d, y);
    }
  }
}

template <typename T, int kM>
__global__ void __launch_bounds__(kThreads)
prefix_avg_kernel(const __grid_constant__ WordTable t, const Walks wk) {
  extern __shared__ Step steps[];   // wk.walks * m positions of this block
  const int64_t m = wk.m;
  const int64_t w0 = (int64_t)blockIdx.y * wk.walks;
  const int64_t nw = (wk.r - w0) < wk.walks ? (wk.r - w0) : wk.walks;
  for (int64_t i = threadIdx.x; i < nw * m; i += kThreads) {
    const int64_t p = wk.perms[w0 * m + i];
    steps[i].perm = (int)p;
    steps[i].scale = wk.n_k[p];
  }
  __syncthreads();
  for (int64_t w = threadIdx.x; w < nw; w += kThreads) {
    float n = steps[w * m].scale;
    steps[w * m].ncum = n;
    for (int64_t j = 1; j < m; ++j) {
      n = __fadd_rn(n, steps[w * m + j].scale);
      steps[w * m + j].ncum = n;
    }
  }
  __syncthreads();
  const WordLeaf& leaf = word_leaf(t, blockIdx.x);
  const int64_t tile = (int64_t)blockIdx.x - leaf.blk0;
  if (leaf.vec == 1) {
    walk_tile<T, false, kM>(leaf, tile, steps, w0, nw, m);
  } else {
    walk_tile<T, true, kM>(leaf, tile, steps, w0, nw, m);
  }
}

template <typename T, int kM>
cudaError_t launch_m(const WordTable& t, const Walks& wk, dim3 grid,
                     size_t smem, cudaStream_t stream) {
  prefix_avg_kernel<T, kM><<<grid, kThreads, smem, stream>>>(t, wk);
  return cudaGetLastError();
}

template <typename T>
int launch(const int64_t* leaves, int64_t n, const void* perms,
           const void* n_k, int64_t r, int64_t m, int64_t walks,
           int64_t blocks_x, int64_t device, void* stream) {
  cudaError_t err = cudaSetDevice((int)device);
  if (err != cudaSuccess) return (int)err;
  const int64_t blocks_y = walks < 1 ? 0 : (r + walks - 1) / walks;
  if (m < 1 || walks < 1 || blocks_y < 1 || blocks_y > 65535 ||
      walks * m * (int64_t)sizeof(Step) > kMaxSmem) {
    return (int)cudaErrorInvalidConfiguration;
  }
  WordTable t;
  err = fill_word_table<T>(leaves, n, blocks_x, &t);
  if (err != cudaSuccess) return (int)err;
  const Walks wk{(const int64_t*)perms, (const float*)n_k, r, m, walks};
  const dim3 grid((unsigned)blocks_x, (unsigned)blocks_y);
  const size_t smem = walks * m * sizeof(Step);
  const cudaStream_t s = (cudaStream_t)stream;
  switch (m) {   // M up to kRegRows held in registers, larger M reloaded
    case 1: return (int)launch_m<T, 1>(t, wk, grid, smem, s);
    case 2: return (int)launch_m<T, 2>(t, wk, grid, smem, s);
    case 3: return (int)launch_m<T, 3>(t, wk, grid, smem, s);
    case 4: return (int)launch_m<T, 4>(t, wk, grid, smem, s);
    case 5: return (int)launch_m<T, 5>(t, wk, grid, smem, s);
    case 6: return (int)launch_m<T, 6>(t, wk, grid, smem, s);
    case 7: return (int)launch_m<T, 7>(t, wk, grid, smem, s);
    case kRegRows: return (int)launch_m<T, kRegRows>(t, wk, grid, smem, s);
    default: return (int)launch_m<T, 0>(t, wk, grid, smem, s);
  }
}

}  // namespace

// leaves: n rows of kWordLeafFields int64 in host memory (src, out, d,
// blk0, vec), in increasing blk0; the kernel takes them by value.  perms:
// (r, m) int64 on the card, each in [0, m) (the wrapper checks); n_k: (m,)
// float32 on the card; walks: walks a block, grid.y = ceil(r / walks).
extern "C" int prefix_avg_f32(const int64_t* leaves, int64_t n,
                              const void* perms, const void* n_k, int64_t r,
                              int64_t m, int64_t walks, int64_t blocks_x,
                              int64_t device, void* stream) {
  return launch<float>(leaves, n, perms, n_k, r, m, walks, blocks_x, device,
                       stream);
}

extern "C" int prefix_avg_bf16(const int64_t* leaves, int64_t n,
                               const void* perms, const void* n_k, int64_t r,
                               int64_t m, int64_t walks, int64_t blocks_x,
                               int64_t device, void* stream) {
  return launch<__nv_bfloat16>(leaves, n, perms, n_k, r, m, walks, blocks_x,
                               device, stream);
}
