// Cohort row gather, hand-written for Hopper.
//
// Replaces: the Pallas TPU kernel `cohort_gather_kernel` (body
// `_gather_kernel`) in src/repro/kernels/cohort_gather/kernel.py.
//
// Computes, for every leaf of a tree of (N, row_bytes) client stacks of any
// dtype, out[i] = table[ids[i]] for the M cohort ids.  The copy moves raw
// words, never float values, so every bit survives, -0.0 and NaN payloads
// included (the engines rely on the gather being bitwise the dense take).
//
// What bounds it on the H100: bytes, M rows read and M rows written per
// leaf, no arithmetic; at the main path's 5 MB a round that is ~1.5 us, so
// in practice the host's cost per call and the launch bound it.
//
// What the design does about it: one launch for the whole tree, with no
// device-side flag and no sync.  The wrapper checks the ids on the host
// (where the engine already holds them) and passes them, with a table of
// leaves (source, destination, row bytes, rows, first block, word bytes),
// by value in the kernel's parameters: the counterpart of the TPU kernel's
// scalar prefetch.  grid.x runs over the row chunks of all leaves one after
// the other, grid.y over the cohort slots.  Each leaf moves 16-byte words
// when its rows and both base pointers are 16-byte aligned, else 4-byte
// words, else bytes; a thread keeps kUnroll words in flight, so a block
// moves 16 KB of a 16-byte-aligned row.  The C entry checks every id
// against every leaf's rows again before it launches, so the kernel never
// reads outside a table.
//
// A second entry, cohort_gather_ids, takes the ids as a device pointer, for
// a round captured in a CUDA graph, whose cohort is chosen on the card and
// whose by-value parameters would be frozen at capture.  Each block reads
// its slot's id from global memory and checks it against its leaf's rows;
// an id outside [0, rows) is written into a device error word (the first
// one to arrive wins, by compare-and-swap on zero) and its row is not
// copied.  The host reads the word once, after the run, and raises
// IndexError as index_select does.  No row is ever clamped.
//
// A third entry, cohort_gather_shard, is the client-sharded gather (the
// reference's `_cross_shard_take`, src/repro/kernels/cohort_gather/ops.py,
// a clamped take, a mask and one psum a leaf; not a Pallas kernel there).
// Each rank holds one block of n_local clients, global rows [lo, lo +
// n_local), of every per-client table, and every rank knows the M cohort
// ids.  The kernel writes the M rows of every leaf into ONE packed output,
// the leaves one after the other, each segment padded with zeros to 16
// bytes: a row's bytes where lo <= id < lo + n_local, zeros elsewhere.  An
// id outside [0, N) (the global N, not the block) goes into the error word,
// as in the device-id entry, and its row is zeros.  The wrapper then sums
// the packed output over the client group as int32 words with one
// all_reduce and views the leaves back out.  That sum is exact for every
// dtype (-0.0, NaN payloads, bool, 16-bit leaves of odd width): every id
// lies in exactly one block, so every byte of the output has at most one
// rank that may write a nonzero value into it, and all others write 0.
// Adding integers whose nonzero bytes never share a position makes no
// carry, so the sum of each word is the OR of the ranks' words, which is
// the one writer's bytes.  No overflow either: at most one addend of a word
// has its top bit set.  (Gloo refuses int16 and NCCL has no bitwise-OR
// reduction, so the reference's per-leaf psum of a same-width uint does not
// carry over.)  Like the device-id entry it reads nothing back, so a
// captured round holds it.  Bounded by bytes: the block's hits read, M
// rows written a leaf.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr int kMaxLeaves = 16;
constexpr int kMaxIds = 256;
constexpr int kLeafFields = 6;  // src, dst, row bytes, rows, blk0, unit

struct Leaf {
  const char* src;   // (n, row_bytes) table
  char* dst;         // (m, row_bytes) output
  int64_t row_bytes;
  int64_t blk0;      // first row chunk of the leaf in grid.x
  int64_t unit;      // bytes per word: 16, 4 or 1
  int64_t rows;      // n, the table's rows
};

struct Table {
  Leaf leaf[kMaxLeaves];
  int32_t ids[kMaxIds];
  int64_t n;
};

// The device-id entry's parameters: no ids by value.
struct DeviceTable {
  Leaf leaf[kMaxLeaves];
  int64_t n;
  const int64_t* ids;               // (m,) cohort ids in device memory
  unsigned long long* error;        // the first id out of range, or 0
};

// The sharded entry's parameters: the block's first row and the global N.
struct ShardTable {
  Leaf leaf[kMaxLeaves];
  int64_t n;
  const int64_t* ids;               // (m,) global cohort ids, device memory
  unsigned long long* error;        // the first id outside [0, n_total)
  int64_t lo;                       // global row of the block's first row
  int64_t n_total;                  // N
};

template <typename U>
__device__ __forceinline__ void zero_chunk(const Leaf& leaf, int64_t slot,
                                           int64_t chunk) {
  const int64_t units = leaf.row_bytes / (int64_t)sizeof(U);
  U* dst = reinterpret_cast<U*>(leaf.dst + slot * leaf.row_bytes);
  const int64_t u0 = chunk * (kThreads * kUnroll) + threadIdx.x;
  const U z{};
#pragma unroll
  for (int i = 0; i < kUnroll; ++i) {
    const int64_t u = u0 + i * kThreads;
    if (u < units) dst[u] = z;
  }
}

__device__ __forceinline__ void zero_row_chunk(const Leaf& leaf, int64_t slot,
                                               int64_t chunk) {
  if (leaf.unit == 16) {
    zero_chunk<uint4>(leaf, slot, chunk);
  } else if (leaf.unit == 4) {
    zero_chunk<uint32_t>(leaf, slot, chunk);
  } else {
    zero_chunk<uint8_t>(leaf, slot, chunk);
  }
}

template <typename U>
__device__ __forceinline__ void copy_chunk(const Leaf& leaf, int64_t id,
                                           int64_t slot, int64_t chunk) {
  const int64_t units = leaf.row_bytes / (int64_t)sizeof(U);
  const U* src = reinterpret_cast<const U*>(leaf.src + id * leaf.row_bytes);
  U* dst = reinterpret_cast<U*>(leaf.dst + slot * leaf.row_bytes);
  const int64_t u0 = chunk * (kThreads * kUnroll) + threadIdx.x;
  U v[kUnroll];
#pragma unroll
  for (int i = 0; i < kUnroll; ++i) {
    const int64_t u = u0 + i * kThreads;
    if (u < units) v[i] = src[u];
  }
#pragma unroll
  for (int i = 0; i < kUnroll; ++i) {
    const int64_t u = u0 + i * kThreads;
    if (u < units) dst[u] = v[i];
  }
}

__device__ __forceinline__ void copy_row_chunk(const Leaf& leaf, int64_t id,
                                               int64_t slot, int64_t chunk) {
  if (leaf.unit == 16) {
    copy_chunk<uint4>(leaf, id, slot, chunk);
  } else if (leaf.unit == 4) {
    copy_chunk<uint32_t>(leaf, id, slot, chunk);
  } else {
    copy_chunk<uint8_t>(leaf, id, slot, chunk);
  }
}

template <typename T>
__device__ __forceinline__ int leaf_of(const T& t) {
  int i = 0;
  while (i + 1 < t.n && (int64_t)blockIdx.x >= t.leaf[i + 1].blk0) ++i;
  return i;
}

__global__ void __launch_bounds__(kThreads)
cohort_gather_kernel(const __grid_constant__ Table t) {
  const Leaf& leaf = t.leaf[leaf_of(t)];
  const int64_t slot = blockIdx.y;
  copy_row_chunk(leaf, t.ids[slot], slot, (int64_t)blockIdx.x - leaf.blk0);
}

__global__ void __launch_bounds__(kThreads)
cohort_gather_ids_kernel(const __grid_constant__ DeviceTable t) {
  const Leaf& leaf = t.leaf[leaf_of(t)];
  const int64_t slot = blockIdx.y;
  const int64_t id = t.ids[slot];
  if (id < 0 || id >= leaf.rows) {
    if (threadIdx.x == 0) {
      atomicCAS(t.error, 0ull, (unsigned long long)id);
    }
    return;
  }
  copy_row_chunk(leaf, id, slot, (int64_t)blockIdx.x - leaf.blk0);
}

__global__ void __launch_bounds__(kThreads)
cohort_gather_shard_kernel(const __grid_constant__ ShardTable t) {
  const Leaf& leaf = t.leaf[leaf_of(t)];
  const int64_t slot = blockIdx.y;
  const int64_t chunk = (int64_t)blockIdx.x - leaf.blk0;
  const int64_t id = t.ids[slot];
  const bool valid = id >= 0 && id < t.n_total;
  if (!valid && threadIdx.x == 0) {
    atomicCAS(t.error, 0ull, (unsigned long long)id);
  }
  const int64_t local = id - t.lo;
  if (valid && local >= 0 && local < leaf.rows) {
    copy_row_chunk(leaf, local, slot, chunk);
  } else {
    zero_row_chunk(leaf, slot, chunk);
  }
  // the segment's pad after the last row, up to 16 bytes: zeros, written by
  // the leaf's first block
  if (slot == 0 && chunk == 0) {
    const int64_t used = (int64_t)gridDim.y * leaf.row_bytes;
    const int64_t pad = (16 - used % 16) % 16;
    if (threadIdx.x < pad) leaf.dst[used + threadIdx.x] = 0;
  }
}

bool aligned(const void* p, int64_t a) { return (uintptr_t)p % a == 0; }

// Fills `leaf` from n_leaves rows of kLeafFields int64 (src, dst, row
// bytes, rows, blk0, unit), in increasing blk0; false if a row is not a
// valid launch.
bool parse_leaves(const int64_t* leaves, int64_t n_leaves, int64_t blocks_x,
                  Leaf* leaf) {
  for (int64_t i = 0; i < n_leaves; ++i) {
    const int64_t* f = leaves + i * kLeafFields;
    const int64_t end = i + 1 < n_leaves ? leaves[(i + 1) * kLeafFields + 4]
                                         : blocks_x;
    Leaf& l = leaf[i];
    l = {(const char*)f[0], (char*)f[1], f[2], f[4], f[5], f[3]};
    const int64_t chunk_bytes = (int64_t)kThreads * kUnroll * l.unit;
    if ((l.unit != 16 && l.unit != 4 && l.unit != 1) || l.row_bytes < 1 ||
        l.row_bytes % l.unit != 0 || l.rows < 1 || !aligned(l.src, l.unit) ||
        !aligned(l.dst, l.unit) || (i == 0 && l.blk0 != 0) ||
        end <= l.blk0 || (end - l.blk0) * chunk_bytes < l.row_bytes) {
      return false;
    }
  }
  return true;
}

bool bad_shape(int64_t n_leaves, int64_t m, int64_t max_m, int64_t blocks_x) {
  return n_leaves < 1 || n_leaves > kMaxLeaves || m < 1 || m > max_m ||
         blocks_x < 1 || blocks_x > 0x7fffffff;
}

}  // namespace

// leaves: n_leaves rows of kLeafFields int64 in host memory (src, dst, row
// bytes, rows, blk0, unit), in increasing blk0; ids: m int64 in host
// memory.  Both go to the kernel by value.
extern "C" int cohort_gather(const int64_t* leaves, int64_t n_leaves,
                             const int64_t* ids, int64_t m, int64_t blocks_x,
                             int64_t device, void* stream) {
  cudaError_t err = cudaSetDevice((int)device);
  if (err != cudaSuccess) return (int)err;
  if (bad_shape(n_leaves, m, kMaxIds, blocks_x)) {
    return (int)cudaErrorInvalidConfiguration;
  }
  Table t{};
  t.n = n_leaves;
  if (!parse_leaves(leaves, n_leaves, blocks_x, t.leaf)) {
    return (int)cudaErrorInvalidValue;
  }
  for (int64_t i = 0; i < n_leaves; ++i) {
    for (int64_t s = 0; s < m; ++s) {
      if (ids[s] < 0 || ids[s] >= t.leaf[i].rows || ids[s] > 0x7fffffff) {
        return (int)cudaErrorInvalidValue;
      }
    }
  }
  for (int64_t s = 0; s < m; ++s) t.ids[s] = (int32_t)ids[s];
  cohort_gather_kernel<<<dim3((unsigned)blocks_x, (unsigned)m), kThreads, 0,
                         (cudaStream_t)stream>>>(t);
  return (int)cudaGetLastError();
}

// leaves as above, in host memory (by value); ids: m int64 in device
// memory; error: one int64 in device memory that the kernel sets to the
// first id it finds outside a leaf's rows (the caller zeroes it first and
// reads it after its run).
extern "C" int cohort_gather_ids(const int64_t* leaves, int64_t n_leaves,
                                 const int64_t* ids, int64_t m,
                                 int64_t blocks_x, int64_t* error,
                                 int64_t device, void* stream) {
  cudaError_t err = cudaSetDevice((int)device);
  if (err != cudaSuccess) return (int)err;
  if (bad_shape(n_leaves, m, 65535, blocks_x) || ids == nullptr ||
      error == nullptr || !aligned(ids, 8) || !aligned(error, 8)) {
    return (int)cudaErrorInvalidConfiguration;
  }
  DeviceTable t{};
  t.n = n_leaves;
  t.ids = ids;
  t.error = reinterpret_cast<unsigned long long*>(error);
  if (!parse_leaves(leaves, n_leaves, blocks_x, t.leaf)) {
    return (int)cudaErrorInvalidValue;
  }
  cohort_gather_ids_kernel<<<dim3((unsigned)blocks_x, (unsigned)m), kThreads,
                             0, (cudaStream_t)stream>>>(t);
  return (int)cudaGetLastError();
}

// leaves as above, each dst the leaf's segment of the packed output (16-byte
// aligned, its m rows and then zeros up to 16 bytes) and rows the block's
// n_local; ids: m int64 global ids in device memory; lo: the block's first
// global row; n_total: N; error as in cohort_gather_ids.
extern "C" int cohort_gather_shard(const int64_t* leaves, int64_t n_leaves,
                                   const int64_t* ids, int64_t m,
                                   int64_t blocks_x, int64_t lo,
                                   int64_t n_total, int64_t* error,
                                   int64_t device, void* stream) {
  cudaError_t err = cudaSetDevice((int)device);
  if (err != cudaSuccess) return (int)err;
  if (bad_shape(n_leaves, m, 65535, blocks_x) || ids == nullptr ||
      error == nullptr || !aligned(ids, 8) || !aligned(error, 8) || lo < 0 ||
      n_total < 1) {
    return (int)cudaErrorInvalidConfiguration;
  }
  ShardTable t{};
  t.n = n_leaves;
  t.ids = ids;
  t.error = reinterpret_cast<unsigned long long*>(error);
  t.lo = lo;
  t.n_total = n_total;
  if (!parse_leaves(leaves, n_leaves, blocks_x, t.leaf)) {
    return (int)cudaErrorInvalidValue;
  }
  for (int64_t i = 0; i < n_leaves; ++i) {
    if (!aligned(t.leaf[i].dst, 16)) return (int)cudaErrorInvalidValue;
  }
  cohort_gather_shard_kernel<<<dim3((unsigned)blocks_x, (unsigned)m),
                               kThreads, 0, (cudaStream_t)stream>>>(t);
  return (int)cudaGetLastError();
}
