// Cohort row gather, hand-written for Hopper.
//
// Replaces: the Pallas TPU kernel `cohort_gather_kernel` (body
// `_gather_kernel`) in src/repro/kernels/cohort_gather/kernel.py.
//
// Computes out[i] = table[ids[i]] for a (N, row_bytes) table of any dtype
// and (M,) int64 ids.  The copy moves raw words, never float values, so
// every bit survives, -0.0 and NaN payloads included (the engines rely on
// the gather being bitwise the dense take).
//
// What bounds it on the H100: bytes, M rows read and M rows written; no
// arithmetic.
//
// What the simple design does about it: grid (row chunks, M); block y
// reads its own id (the TPU's scalar prefetch) and copies its chunk of
// that row with 16-byte vectors when the row and both base pointers are
// 16-byte aligned, else 4-byte words, else bytes, so a warp moves 512
// consecutive bytes per instruction on the aligned path.  An id outside
// [0, N) is not read: the block raises a flag in device memory, which the
// wrapper reads and turns into an error.  TMA bulk copies are later work.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr unsigned kMaxChunks = 1024;

template <typename U>
__global__ void __launch_bounds__(kThreads)
cohort_gather_kernel(const U* __restrict__ table,
                     const int64_t* __restrict__ ids, U* __restrict__ out,
                     int* __restrict__ bad, int64_t n, int64_t units) {
  const int64_t id = ids[blockIdx.y];
  if (id < 0 || id >= n) {
    if (threadIdx.x == 0) atomicOr(bad, 1);
    return;
  }
  const U* src = table + id * units;
  U* dst = out + (int64_t)blockIdx.y * units;
  for (int64_t u = (int64_t)blockIdx.x * kThreads + threadIdx.x; u < units;
       u += (int64_t)gridDim.x * kThreads) {
    dst[u] = src[u];
  }
}

template <typename U>
int launch(const void* table, const void* ids, void* out, void* bad,
           int64_t n, int64_t m, int64_t row_bytes, cudaStream_t stream) {
  const int64_t units = row_bytes / (int64_t)sizeof(U);
  int64_t chunks = (units + kThreads - 1) / kThreads;
  if (chunks > kMaxChunks) chunks = kMaxChunks;
  if (chunks < 1) chunks = 1;
  const dim3 grid((unsigned)chunks, (unsigned)m);
  cohort_gather_kernel<U><<<grid, kThreads, 0, stream>>>(
      (const U*)table, (const int64_t*)ids, (U*)out, (int*)bad, n, units);
  return (int)cudaGetLastError();
}

bool aligned(const void* p, int64_t a) { return (uintptr_t)p % a == 0; }

}  // namespace

extern "C" int cohort_gather(const void* table, const void* ids, void* out,
                             void* bad, int64_t n, int64_t m,
                             int64_t row_bytes, int64_t device,
                             void* stream) {
  cudaError_t err = cudaSetDevice((int)device);
  if (err != cudaSuccess) return (int)err;
  if (m > 65535) return (int)cudaErrorInvalidConfiguration;
  const cudaStream_t s = (cudaStream_t)stream;
  if (row_bytes % 16 == 0 && aligned(table, 16) && aligned(out, 16)) {
    return launch<uint4>(table, ids, out, bad, n, m, row_bytes, s);
  }
  if (row_bytes % 4 == 0 && aligned(table, 4) && aligned(out, 4)) {
    return launch<uint32_t>(table, ids, out, bad, n, m, row_bytes, s);
  }
  return launch<uint8_t>(table, ids, out, bad, n, m, row_bytes, s);
}
