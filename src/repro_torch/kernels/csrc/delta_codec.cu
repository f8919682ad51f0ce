// Upload-delta codec roundtrip (encode -> decode) of a stacked tree,
// hand-written for Hopper.
//
// Replaces: the Pallas TPU kernel `delta_codec_kernel` (body `_codec_kernel`,
// helper `_kth_largest`) in src/repro/kernels/delta_codec/kernel.py, and the
// two elementwise passes its tree wrapper ran around it.
//
// Computes, for each leaf of a tree (an (M, d) stack of client weights and
// the (d,) server weights `ref`) and each row w of the stack:
//   x = w - ref                       (IEEE subtraction, __fsub_rn)
//   quant8       scale = max(max|x|, 1e-12) / 127,
//                q = clip(rint(x / scale), -127, 127) * scale;
//   topk         q = x on exactly the k largest |x| (ties lowest column
//                first, the lax.top_k contract), +0.0 elsewhere;
//   quant8_topk  the quant8 value on the top-k set, +0.0 elsewhere;
//   out = ref + q                     (IEEE addition, __fadd_rn).
// These are the operations, in the same order, of the plain version
// (`ref + delta_codec_ref(w - ref)`) and of the loop engine's per-client
// codec, so the result equals both bit for bit on finite rows.  A leaf
// without `ref` (the single-matrix launcher) skips the subtraction and the
// addition: adding a zero row would turn a -0.0 into +0.0.  Division and
// product are IEEE (__fdiv_rn / __fmul_rn, so nvcc cannot swap in a
// reciprocal), rintf rounds half to even like jnp.round, and a dropped
// entry is +0.0, never x * 0.  Non-finite values pass through as in the
// plain version and the reference (jnp.max and jnp.clip propagate NaN): the
// abs-max is an integer max of the |x| bit patterns, so one NaN makes the
// scale NaN, the max with 1e-12 and the clip are compares that keep a NaN,
// and an inf abs-max gives an inf scale and NaN outputs.  In the keep set
// every NaN counts as one key above inf, so NaNs are the largest entries
// and tie in column order, as in a stable sort.
//
// What bounds it on the H100: bytes, one read of the stack and of `ref`
// and one write of the result; the keep-set search is integer compares.
// The TPU kernel keeps a whole row in VMEM for ~50 passes; a 156,800-float
// row is 627 KB, more than the 227 KB of shared memory a block may have.
//
// What the design does about it:
// - One launch for up to 32 leaves.  The wrapper passes a table of leaves
//   by value (`__grid_constant__`); each (leaf, row) pair is one thread-
//   block cluster of kCluster blocks, so the main path's 6 leaves x 5 rows
//   are 30 clusters, 240 blocks on 132 SMs, not 5 blocks.
// - Each block of a cluster owns a contiguous slice of the row (a multiple
//   of 4 columns, in rank order, so block order is column order).  It reads
//   its slice once, forms the delta and keeps it in dynamic shared memory
//   (78.4 KB at d = 156,800); every later pass reads shared memory.  The
//   shared memory is sized for the table's widest slice; a leaf whose slice
//   is wider than that (above kMaxStageBytes) re-reads its slice from
//   global memory in each pass instead, inside the same launch.
// - The k-th largest key (31 bits, monotone in |x|) is found by radix
//   select over digits of 7/8/8/8 bits (256 bins).  The first digit's
//   histogram and the abs-max are taken while the slice is staged.  Each
//   block counts its slice; after a cluster barrier every block sums the
//   cluster's histograms through distributed shared memory and finds the
//   same bin (warp 0 reads 8 bins a lane from each block).  Two histogram
//   buffers take turns, so one cluster barrier a pass suffices.  The search
//   stops early once every key on the prefix found so far is kept.  Each
//   count is one shared atomic, whose result no thread waits for; the
//   first digit of a row of deltas is nearly the same everywhere, and
//   per-warp aggregation of it (__match_any_sync) measured slower, since it
//   puts a warp-wide exchange in every entry's path.  A warp with no key on
//   the prefix skips the later digits' counts.
// - Ties at the threshold, when not all of them are kept, are ranked in
//   column order across the cluster: a block's offset is the ties of the
//   lower ranks (read from their last histograms), then a block-wide scan
//   in column order (warp shuffles, then the warps' counts).
// - 16-byte loads and evict-first stores where a leaf's d and pointers
//   allow, else 4-byte words, chosen per leaf inside the same launch; a
//   thread issues the global loads of kUnroll words before it uses them.
// - No block exits while another may read its shared memory: each block
//   arrives at a last cluster barrier after its last remote read and waits
//   on it after its write pass.
#include <cooperative_groups.h>

#include <atomic>
#include <climits>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kCluster = 8;      // blocks per row: the portable cluster size
constexpr int kBins = 256;
constexpr int kUnroll = 4;       // words a thread loads before it uses them
constexpr int kMaxLeaves = 32;
constexpr int kLeafFields = 7;   // the wrapper's table: src, ref, out, d, k,
                                 // slice, vec
constexpr int64_t kMaxStageBytes = 220 * 1024;  // + Shared <= 227 KB
constexpr unsigned kFull = 0xffffffffu;
enum Codec : int64_t { kQuant8 = 0, kTopk = 1, kQuant8Topk = 2 };

constexpr uint32_t kInfBits = 0x7f800000u;

static_assert(kThreads >= 2 * kBins,
              "after a pass, the threads from kBins on clear the other "
              "buffer, a bin each, beside warp 0's search");
static_assert(kBins == 32 * 8, "warp 0 searches the bins, 8 a lane");
static_assert(kBins % 32 == 0 && kCluster <= 32,
              "the abs-max of the cluster is read by the first lanes of a "
              "warp");

struct Leaf {
  const float* src;   // (rows, d) stack
  const float* ref;   // (d,) reference row, or null
  float* out;         // (rows, d) result
  int64_t d;
  int64_t k;          // keep count of the sparse codecs
  int64_t slice;      // columns per block of a cluster, a multiple of 4
  int64_t vec;        // 4: 16-byte words, 1: 4-byte words
};

struct Table {
  Leaf leaf[kMaxLeaves];
};

struct alignas(16) Shared {
  unsigned hist[2][kBins];  // this block's counts; the two take turns
  uint32_t amax;            // this block's abs-max bits
  int warp_ties[kWarps];
  uint32_t prefix;
  int want, ties, before;
  float scale;
};

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

__device__ __forceinline__ uint32_t abs_bits(float x) {
  return __float_as_uint(x) & 0x7fffffffu;  // bits of |x|
}

// the keep-set key: |x| bits, every NaN folded onto one key above inf
__device__ __forceinline__ uint32_t key_of(float x) {
  const uint32_t a = abs_bits(x);
  return a > kInfBits ? kInfBits + 1u : a;
}

// clip(rint(x / scale), -127, 127) * scale; the clip is two compares, which
// keep a NaN (fminf / fmaxf would drop it)
__device__ __forceinline__ float quantize(float x, float scale) {
  const float r = rintf(__fdiv_rn(x, scale));
  const float q = r < -127.0f ? -127.0f : (r > 127.0f ? 127.0f : r);
  return __fmul_rn(q, scale);
}

__device__ __forceinline__ float delta_at(const float* src, const float* ref,
                                          int64_t i) {
  return ref ? __fsub_rn(src[i], ref[i]) : src[i];
}

// V columns from i (i < n; a 16-byte word when V == 4) of w - ref; zeros
// past the slice
template <int V>
__device__ __forceinline__ void load_delta(const float* src, const float* ref,
                                           int64_t i, int64_t n, float* x) {
  if constexpr (V == 4) {
    if (i < n) {
      const float4 w = __ldg(reinterpret_cast<const float4*>(src + i));
      x[0] = w.x; x[1] = w.y; x[2] = w.z; x[3] = w.w;
      if (ref) {
        const float4 r = __ldg(reinterpret_cast<const float4*>(ref + i));
        x[0] = __fsub_rn(x[0], r.x);
        x[1] = __fsub_rn(x[1], r.y);
        x[2] = __fsub_rn(x[2], r.z);
        x[3] = __fsub_rn(x[3], r.w);
      }
    } else {
      x[0] = x[1] = x[2] = x[3] = 0.0f;
    }
  } else {
    x[0] = i < n ? delta_at(src, ref, i) : 0.0f;
  }
}

// V columns, stored evict-first
template <int V>
__device__ __forceinline__ void store_out(float* out, const float* q) {
  if constexpr (V == 4) {
    __stcs(reinterpret_cast<float4*>(out), make_float4(q[0], q[1], q[2], q[3]));
  } else {
    __stcs(out, q[0]);
  }
}

// The 4 columns from i (a multiple of 4) of the slice, zeros past n: one
// 16-byte word of shared memory (the stage holds whole words), or w - ref
// from global memory.
template <bool kStaged>
__device__ __forceinline__ void slice_word(const float* stage,
                                           const float* src, const float* ref,
                                           int64_t i, int64_t n, float* x) {
  if constexpr (kStaged) {
    const float4 w = i < n ? *reinterpret_cast<const float4*>(stage + i)
                           : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    x[0] = w.x; x[1] = w.y; x[2] = w.z; x[3] = w.w;
  } else {
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      x[v] = i + v < n ? delta_at(src, ref, i + v) : 0.0f;
    }
  }
}

// The digit at `shift` of the keys of x (the 4 columns from i) that lie on
// the prefix `thr` under `mask`, an atomic each; a warp with none skips.
// Every lane of the warp calls it.
__device__ __forceinline__ void count_digits(unsigned* hist, const float* x,
                                             int64_t i, int64_t n,
                                             uint32_t mask, uint32_t thr,
                                             int shift) {
  uint32_t key[4];
  bool on[4], any = false;
#pragma unroll
  for (int v = 0; v < 4; ++v) {
    key[v] = key_of(x[v]);
    on[v] = i + v < n && (key[v] & mask) == thr;
    any = any || on[v];
  }
  if (__ballot_sync(kFull, any) == 0u) return;
#pragma unroll
  for (int v = 0; v < 4; ++v) {
    if (on[v]) atomicAdd(&hist[(key[v] >> shift) & 0xffu], 1u);
  }
}

// Warp 0, after a cluster barrier: the cluster's counts of this pass (the
// sum of every block's buffer `buf`, read through distributed shared
// memory, 8 bins a lane); the bin that holds the want-th largest key, the
// keys left to take in it, its count, and the ties of the lower ranks in
// it.
__device__ __forceinline__ void select_digit(Shared& sh,
                                             cg::cluster_group& cluster,
                                             int buf, int shift, uint32_t thr,
                                             int want, int rank, int lane) {
  unsigned c[8] = {0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
#pragma unroll
  for (int r = 0; r < kCluster; ++r) {
    const uint4* h = reinterpret_cast<const uint4*>(
        cluster.map_shared_rank(&sh.hist[buf][8 * lane], r));
    const uint4 lo = h[0], hi = h[1];
    c[0] += lo.x; c[1] += lo.y; c[2] += lo.z; c[3] += lo.w;
    c[4] += hi.x; c[5] += hi.y; c[6] += hi.z; c[7] += hi.w;
  }
  int sum = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) sum += (int)c[j];
  int suf = sum;   // keys in this lane's bins and all higher ones
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_down_sync(kFull, suf, o);
    if (lane + o < 32) suf += v;
  }
  const bool here = suf - sum < want && want <= suf;
  int b = 0, above = suf - sum, count = 0;
  if (here) {
#pragma unroll
    for (int j = 7; j >= 0; --j) {
      if (above + (int)c[j] >= want) {
        b = 8 * lane + j;
        count = (int)c[j];
        break;
      }
      above += (int)c[j];
    }
  }
  const int from = __ffs(__ballot_sync(kFull, here)) - 1;
  b = __shfl_sync(kFull, b, from);
  above = __shfl_sync(kFull, above, from);
  count = __shfl_sync(kFull, count, from);
  const unsigned lower =
      lane < rank ? cluster.map_shared_rank(&sh.hist[buf][0], lane)[b] : 0u;
  const unsigned before = __reduce_add_sync(kFull, lower);
  if (lane == 0) {
    sh.prefix = thr | ((uint32_t)b << shift);
    sh.want = want - above;
    sh.ties = count;
    sh.before = (int)before;
  }
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// One row of one leaf; this block's slice.  kStaged: the slice is kept in
// `stage` (shared memory); else every pass reads it from global memory.
// The loops over the slice step kUnroll words a thread at a time and issue
// their global loads first, so that a thread has several in flight.
template <bool kStaged, int V>
__device__ __forceinline__ void codec_row(const Leaf& leaf, int64_t row,
                                          int64_t codec, float* stage,
                                          Shared& sh,
                                          cg::cluster_group& cluster) {
  constexpr int64_t kStep = (int64_t)kThreads * V * kUnroll;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rank = (int)cluster.block_rank();
  const int64_t d = leaf.d;
  const int64_t lo = min64((int64_t)rank * leaf.slice, d);
  const int64_t n = min64(lo + leaf.slice, d) - lo;
  const float* src = leaf.src + row * d + lo;
  const float* ref = leaf.ref ? leaf.ref + lo : nullptr;
  float* out = leaf.out + row * d + lo;
  const bool sparse = codec != kQuant8;

  if (tid < kBins) sh.hist[0][tid] = 0u;
  if (tid == 0) sh.amax = 0u;
  __syncthreads();

  // ---- stage: the delta into shared memory, its abs-max, and the first
  // digit's histogram ----------------------------------------------------
  uint32_t amax = 0u;
  for (int64_t i0 = 0; i0 < n; i0 += kStep) {
    float x[kUnroll][V];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      load_delta<V>(src, ref, i0 + ((int64_t)u * kThreads + tid) * V, n,
                    x[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = i0 + ((int64_t)u * kThreads + tid) * V;
      if (kStaged && i < n) {
        if constexpr (V == 4) {
          *reinterpret_cast<float4*>(stage + i) =
              make_float4(x[u][0], x[u][1], x[u][2], x[u][3]);
        } else {
          stage[i] = x[u][0];
        }
      }
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const bool in = i + v < n;
        if (in) amax = max(amax, abs_bits(x[u][v]));
        if (sparse) {
          if (in) atomicAdd(&sh.hist[0][key_of(x[u][v]) >> 24], 1u);
        }
      }
    }
  }
  amax = __reduce_max_sync(kFull, amax);
  if (lane == 0) atomicMax(&sh.amax, amax);

  // ---- scale, and radix select of the k-th largest key ------------------
  uint32_t thr = 0u, mask = 0u;
  int want = (int)leaf.k, ties = 0, before = 0;
  float scale = 0.0f;
  for (int p = 0;; ++p) {
    const int shift = 24 - 8 * p, buf = p & 1;
    if (p > 0) {    // the next digit of the keys on the prefix found so far
      for (int64_t i0 = 0; i0 < n; i0 += 4 * kThreads) {
        const int64_t i = i0 + 4 * tid;
        float x[4];
        slice_word<kStaged>(stage, src, ref, i, n, x);
        count_digits(sh.hist[buf], x, i, n, mask, thr, shift);
      }
    }
    cluster.sync();   // every block's counts (and abs-max) are in
    if (warp == 0) {
      if (sparse) {
        select_digit(sh, cluster, buf, shift, thr, want, rank, lane);
      }
    } else if (tid >= kBins) {
      // no block reads the other buffer any more: clear it for the next pass
      if (sparse) sh.hist[buf ^ 1][tid - kBins] = 0u;
      if (p == 0 && codec != kTopk && tid < kBins + kCluster) {
        const uint32_t a = __reduce_max_sync(
            (1u << kCluster) - 1u,
            *cluster.map_shared_rank(&sh.amax, tid - kBins));
        if (tid == kBins) {
          const float am = __uint_as_float(a);
          sh.scale = __fdiv_rn(am < 1e-12f ? 1e-12f : am, 127.0f);
        }
      }
    }
    __syncthreads();
    if (p == 0 && codec != kTopk) scale = sh.scale;
    if (!sparse) break;
    thr = sh.prefix;
    want = sh.want;
    ties = sh.ties;
    before = sh.before;
    mask |= 0xffu << shift;
    if (want == ties || shift == 0) break;   // uniform across the cluster
  }
  cluster_arrive();   // this block reads no other block's memory from here

  // keys on the prefix above thr are kept; of the `ties` keys on thr, all
  // of them, or the first `want` in column order across the cluster
  const bool rank_ties = sparse && want < ties;
  int seen = before;  // ties in lower ranks and in earlier chunks
  for (int64_t i0 = 0; i0 < n; i0 += kStep) {
    float r[kUnroll][V];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (ref) {
        load_delta<V>(ref, nullptr, i0 + ((int64_t)u * kThreads + tid) * V,
                      n, r[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = i0 + ((int64_t)u * kThreads + tid) * V;
      float x[V];
      if constexpr (!kStaged) {
        load_delta<V>(src, ref, i, n, x);
      } else if constexpr (V == 4) {
        const float4 w = i < n ? *reinterpret_cast<const float4*>(stage + i)
                               : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        x[0] = w.x; x[1] = w.y; x[2] = w.z; x[3] = w.w;
      } else {
        x[0] = i < n ? stage[i] : 0.0f;
      }
      bool tie[V], keep[V];
      int mine = 0;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const uint32_t key = key_of(x[v]) & mask;
        tie[v] = sparse && i + v < n && key == thr;
        keep[v] = !sparse || key > thr || (tie[v] && !rank_ties);
        mine += tie[v];
      }
      if (rank_ties) {    // uniform; ranks this chunk's ties in column order
        int incl = mine;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int t = __shfl_up_sync(kFull, incl, o);
          if (lane >= o) incl += t;
        }
        if (lane == 31) sh.warp_ties[warp] = incl;
        __syncthreads();
        int rk = seen + incl - mine, total = 0;
        for (int w = 0; w < kWarps; ++w) {
          const int cw = sh.warp_ties[w];
          if (w < warp) rk += cw;
          total += cw;
        }
#pragma unroll
        for (int v = 0; v < V; ++v) {
          if (tie[v]) keep[v] = rk++ < want;
        }
        seen += total;
        __syncthreads();
      }
      if (i < n) {
        float q[V];
#pragma unroll
        for (int v = 0; v < V; ++v) {
          q[v] = keep[v] ? (codec == kTopk ? x[v]
                                           : quantize(x[v], scale))
                         : 0.0f;
          if (ref) q[v] = __fadd_rn(r[u][v], q[v]);
        }
        store_out<V>(out + i, q);
      }
    }
  }
  cluster_wait();
}

__global__ void __launch_bounds__(kThreads, 2)
delta_codec_kernel(const __grid_constant__ Table t, int64_t rows,
                   int64_t codec, int64_t stage_floats) {
  extern __shared__ float4 stage4[];
  __shared__ Shared sh;
  cg::cluster_group cluster = cg::this_cluster();
  const int64_t cid = (int64_t)blockIdx.x / kCluster;
  const Leaf& leaf = t.leaf[cid / rows];
  const int64_t row = cid % rows;
  float* stage = reinterpret_cast<float*>(stage4);
  if (leaf.slice <= stage_floats) {
    if (leaf.vec == 4) {
      codec_row<true, 4>(leaf, row, codec, stage, sh, cluster);
    } else {
      codec_row<true, 1>(leaf, row, codec, stage, sh, cluster);
    }
  } else if (leaf.vec == 4) {
    codec_row<false, 4>(leaf, row, codec, stage, sh, cluster);
  } else {
    codec_row<false, 1>(leaf, row, codec, stage, sh, cluster);
  }
}

bool aligned(const void* p) { return (uintptr_t)p % 16 == 0; }

int64_t slice_of(int64_t d) {
  const int64_t per = (d + kCluster - 1) / kCluster;
  return (per + 3) / 4 * 4;
}

// cudaFuncAttributeMaxDynamicSharedMemorySize, set once per device
cudaError_t allow_stage(int64_t device) {
  static std::atomic<unsigned long long> done{0ull};
  const unsigned long long bit = 1ull << device;
  if (done.load() & bit) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      delta_codec_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kMaxStageBytes);
  if (err == cudaSuccess) done.fetch_or(bit);
  return err;
}

cudaLaunchConfig_t config(int64_t clusters, int64_t smem_bytes, void* stream,
                          cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(clusters * kCluster));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = (size_t)smem_bytes;
  cfg.stream = (cudaStream_t)stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kCluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

bool valid_stage(int64_t smem_bytes) {
  return smem_bytes >= 0 && smem_bytes % 16 == 0 &&
         smem_bytes <= kMaxStageBytes;
}

}  // namespace

// leaves: n rows of kLeafFields int64 in host memory (src, ref or 0, out,
// d, k, slice, vec); each leaf's stack has `rows` rows.  smem_bytes: the
// dynamic shared memory of each block; a leaf whose slice fits in it is
// staged there.  The kernel takes the table by value.
extern "C" int delta_codec_f32(const int64_t* leaves, int64_t n, int64_t rows,
                               int64_t codec, int64_t smem_bytes,
                               int64_t device, void* stream) {
  cudaError_t err = cudaSetDevice((int)device);
  if (err != cudaSuccess) return (int)err;
  if (n < 1 || n > kMaxLeaves || rows < 1 || codec < kQuant8 ||
      codec > kQuant8Topk || !valid_stage(smem_bytes) || device < 0 ||
      device > 63 || rows > INT_MAX || n * rows * kCluster > INT_MAX) {
    return (int)cudaErrorInvalidValue;
  }
  Table t{};
  for (int64_t i = 0; i < n; ++i) {
    const int64_t* f = leaves + i * kLeafFields;
    Leaf& leaf = t.leaf[i];
    leaf = {(const float*)f[0], (const float*)f[1], (float*)f[2], f[3], f[4],
            f[5], f[6]};
    const bool wide = leaf.vec == 4 && leaf.d % 4 == 0 &&
                      aligned(leaf.src) && aligned(leaf.out) &&
                      (leaf.ref == nullptr || aligned(leaf.ref));
    if (!leaf.src || !leaf.out || leaf.d < 1 || leaf.d > INT_MAX ||
        (codec != kQuant8 && (leaf.k < 1 || leaf.k > leaf.d)) ||
        leaf.slice != slice_of(leaf.d) || (leaf.vec != 1 && !wide)) {
      return (int)cudaErrorInvalidValue;
    }
  }
  if (smem_bytes > 48 * 1024) {
    err = allow_stage(device);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config(n * rows, smem_bytes, stream, &attr);
  const int64_t stage_floats = smem_bytes / 4;
  err = cudaLaunchKernelEx(&cfg, delta_codec_kernel, t, rows, codec,
                           stage_floats);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// How many clusters of the kernel the card holds at once with smem_bytes
// of dynamic shared memory a block (cudaOccupancyMaxActiveClusters).
extern "C" int delta_codec_occupancy(int64_t smem_bytes, int64_t device,
                                     int64_t* clusters) {
  cudaError_t err = cudaSetDevice((int)device);
  if (err != cudaSuccess) return (int)err;
  if (!valid_stage(smem_bytes) || device < 0 || device > 63) {
    return (int)cudaErrorInvalidValue;
  }
  err = allow_stage(device);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config(1, smem_bytes, nullptr, &attr);
  int active = 0;
  err = cudaOccupancyMaxActiveClusters(&active, delta_codec_kernel, &cfg);
  *clusters = active;
  return (int)err;
}
