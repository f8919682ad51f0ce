// Causal flash attention with an optional sliding window and GQA,
// hand-written for Hopper.
//
// Replaces: the Pallas TPU kernel `flash_attention_kernel` (body
// `_flash_kernel`) in src/repro/kernels/flash_attention/kernel.py, and on
// the LM's prefill path the pure-JAX online-softmax scan `flash_attention`
// in src/repro/models/lm/attention.py.
//
// Computes, for every batch b, query head h and query row i:
//   s_j = (q_i . k_j) * scale                      (float32; scale = hd^-0.5)
//   s_j = NEG_INF (the finite -1e30) where key j is masked:
//         causal: j <= pos_i;  window > 0: j > pos_i - window
//   o_i = sum_j softmax(s)_j v_j                   (in q's dtype)
// by the online softmax over key tiles (64 keys on the f32 route, 128 on
// the bf16 route), with (m, l, acc) in float32 and o = acc / max(l, 1e-30),
// as the TPU kernel does.  Key positions are 0 .. T-1; query positions come
// from `q_pos` (0 .. S-1 on prefill).  Query head h reads KV head h / G
// (G = Hq / Kh), the grouping of the reference's reshape (B, S, Kh, G, hd):
// KV is never repeated in memory.  q, k, v and o are read and written
// through their (batch, seq, head) strides, so the model's (B, S, H, hd)
// tensors need no transpose.
//
// Tile skipping: a 64-row group of queries visits only the key tiles that
// meet the band [min pos - window + 1, max pos] of its rows, so the window
// path costs O(S * W), not O(S^2).  Under the finite sentinel this gives
// the same result as visiting every tile: a row whose first visited tile is
// fully masked accumulates junk (p = exp(0) = 1), and its first valid tile
// wipes it (corr = exp(-1e30 - m) = 0).  Rows with no valid key at all (only
// possible when pos_i >= T + window - 1 or pos_i < 0) come out 0 when their
// group visits no tile; the LM never makes such rows.
//
// What bounds it on the H100: operations.  At the H2O-Danube-3-4B prefill
// (B = 4, Hq = 32, Kh = 8, S = T = 8192, hd = 120, window 4096, bf16) a
// layer has 3.22e9 unmasked (query, key) pairs, 480 flops each over the two
// products: 1.55 TFLOP, 1.57 ms at the 989 TFLOP/s bf16 tensor-core peak,
// against 0.63 GB of q/k/v/o traffic, 0.19 ms at 3.35 TB/s.
//
// Two routes, by the inputs' type:
//
// bf16 (the serving path): both products on the tensor cores.  A block of
// 288 threads owns 128 query rows of one (batch, head): two consumer
// warpgroups of 64 rows each and one producer warp.  The producer's lane 0
// loads the Q tile once and then the K/V tiles of the block's band into a
// ring of 2 stages by TMA, each stage tracked by a "full" mbarrier (the
// copy's bytes) and an "empty" one (the 8 consumer warps' releases), so
// tile j+1 arrives while tile j is computed.  Tiles are 128 keys by hd
// padded to 64 or 128 columns; every tile is stored as 128-byte rows under
// the 128-byte swizzle, in 64-column chunks, the layout `wgmma` reads.  The
// tensor maps keep head_dim as a dimension of its own, of size hd, so the
// pad columns of Q, K and V are out of bounds and arrive as zeros; rows
// past S or T arrive as zeros too.  Per tile a consumer warpgroup runs
//   S = Q K^T       wgmma m64n128k16, Q and K from shared memory (K-major),
//   p = exp2(S * scale * log2 e - m)   in f32 registers, masked as above,
//   O += P V        wgmma m64n{64,128}k16, P from registers, V from shared
//                   memory (MN-major, transposed by the instruction),
// with P rounded to bf16 for the second product: this departs from the
// reference, which multiplies f32 P by V (the TPU kernel's `pv` and the
// LM's `attention`).  The row sum l is taken over the unrounded f32 p, as
// the reference does; the rescale, (m, l) and o = acc / max(l, 1e-30) stay
// in f32, and o is stored as bf16.  The exponent base-2 form folds the
// scale into one multiply per score; the sentinel becomes -1e30 * log2 e,
// which keeps the skipping argument above.  Masks are applied by selects,
// only in warps that meet a masked key, and the loop bounds are made
// warp-uniform, so ptxas sees no divergent path around the asynchronous
// products (a branch per lane there ran markedly slower).  The two
// warpgroups overlap each other's softmax and products; a warpgroup does
// not yet overlap its own (that needs more than the 168 registers a thread
// has at 288 threads, and it serialised the products when tried).  Shared
// memory: Q 32 KB plus 64 KB a stage at hd 128, 160 KB in all; one block
// per SM.
//
// f32: the CUDA-core kernel of the first port, kept for float32 inputs (the
// serving-parity checks run in f32 at 2e-5): one block of 256 threads per
// (64-row query tile, head, batch); Q and each K/V tile staged in shared
// memory as float32 rows padded to 4 floats past 64 or 128 columns (the
// pad zeroed, so hd = 120 needs no special case); each thread owns 4 rows
// x 4 keys of a score tile and 4 rows x hd/16 columns of the accumulator,
// both products in f32 FMA (67 TFLOP/s peak).
#include <cuda.h>
#include <limits.h>
#include <math_constants.h>

#include "common.cuh"

namespace {

constexpr float kNegInf = -1e30f;

struct Strides {
  int64_t b, s, h;
};

// ------------------------------------------------------------ f32 route --

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;

template <int HD_PAD>
struct Layout {
  static constexpr int kRow = HD_PAD + 4;      // q/k/v row stride, floats
  static constexpr int kPRow = kBlockK + 4;    // score row stride, floats
  static constexpr int kCols = HD_PAD / 16;    // acc columns per thread
  static constexpr size_t kBytes =
      sizeof(float) * (3 * kBlockQ * kRow + kBlockQ * kPRow);
};

// Stage rows [row0, row0 + n) of one head, zero past n and hd.
template <int HD_PAD>
__device__ __forceinline__ void stage(float* dst, const float* src,
                                      Strides st, int64_t row0, int64_t n,
                                      int64_t hd) {
  constexpr int kRow = Layout<HD_PAD>::kRow;
  for (int i = threadIdx.x; i < kBlockQ * HD_PAD; i += kThreads) {
    const int r = i / HD_PAD, d = i % HD_PAD;
    float x = 0.0f;
    if (r < n && d < hd) x = src[(row0 + r) * st.s + d];
    dst[r * kRow + d] = x;
  }
}

template <int HD_PAD>
__global__ void __launch_bounds__(kThreads)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 const int32_t* __restrict__ q_pos, int64_t s_len,
                 int64_t t_len, int64_t group, int64_t hd, Strides qs,
                 Strides ks, Strides vs, Strides os, int causal,
                 int64_t window, float scale) {
  using L = Layout<HD_PAD>;
  constexpr int kRow = L::kRow, kPRow = L::kPRow, kCols = L::kCols;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);   // [kBlockQ][kRow]
  float* k_s = q_s + kBlockQ * kRow;              // [kBlockK][kRow]
  float* v_s = k_s + kBlockK * kRow;              // [kBlockK][kRow]
  float* p_s = v_s + kBlockK * kRow;              // [kBlockQ][kPRow]
  __shared__ int32_t pos_s[kBlockQ];

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;   // rows ty*4.., keys tx + 16j
  const int64_t q0 = (int64_t)blockIdx.x * kBlockQ;
  const int64_t h = blockIdx.y, b = blockIdx.z, kvh = h / group;
  const int64_t nq = (s_len - q0) < kBlockQ ? (s_len - q0) : kBlockQ;
  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + kvh * ks.h;
  const float* vb = v + b * vs.b + kvh * vs.h;
  float* ob = o + b * os.b + h * os.h;

  stage<HD_PAD>(q_s, qb, qs, q0, nq, hd);
  // rows past S take row 0's position, which leaves the band unchanged
  if (tid < kBlockQ) pos_s[tid] = q_pos[q0 + (tid < nq ? tid : 0)];
  __syncthreads();

  int64_t pos[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) pos[i] = pos_s[ty * 4 + i];
  int64_t qmin = pos_s[0], qmax = pos_s[0];
  for (int r = 1; r < kBlockQ; ++r) {
    qmin = pos_s[r] < qmin ? pos_s[r] : qmin;
    qmax = pos_s[r] > qmax ? pos_s[r] : qmax;
  }
  int64_t k_lo = 0, k_hi = t_len - 1;
  if (causal && qmax < k_hi) k_hi = qmax;
  if (window > 0 && qmin - window + 1 > k_lo) k_lo = qmin - window + 1;

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.0f;
  }
  const int hd4 = (int)((hd + 3) & ~int64_t(3));

  for (int64_t kt = k_lo / kBlockK * kBlockK; k_lo <= k_hi && kt <= k_hi;
       kt += kBlockK) {
    const int64_t nk = (t_len - kt) < kBlockK ? (t_len - kt) : kBlockK;
    __syncthreads();                 // the last tile's readers are done
    stage<HD_PAD>(k_s, kb, ks, kt, nk, hd);
    stage<HD_PAD>(v_s, vb, vs, kt, nk, hd);
    __syncthreads();

    // scores: rows ty*4 + i, keys tx + 16 j
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.0f;
    for (int d = 0; d < hd4; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(&q_s[(ty * 4 + i) * kRow + d]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(&k_s[(tx + 16 * j) * kRow + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float a = sc[i][j];
          a = fmaf(qv[i].x, kv[j].x, a);
          a = fmaf(qv[i].y, kv[j].y, a);
          a = fmaf(qv[i].z, kv[j].z, a);
          a = fmaf(qv[i].w, kv[j].w, a);
          sc[i][j] = a;
        }
    }

    // mask, online softmax, probabilities to shared memory
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float rmax = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const int64_t kp = kt + c;
        float s;
        if (c >= nk) {
          s = -CUDART_INF_F;             // past T: not a key
        } else if ((causal && kp > pos[i]) ||
                   (window > 0 && kp <= pos[i] - window)) {
          s = kNegInf;
        } else {
          s = sc[i][j] * scale;
        }
        sc[i][j] = s;
        rmax = fmaxf(rmax, s);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off, 16));
      const float m_new = fmaxf(m[i], rmax);
      float rsum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(sc[i][j] - m_new);
        p_s[(ty * 4 + i) * kPRow + tx + 16 * j] = p;
        rsum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rsum += __shfl_xor_sync(0xffffffffu, rsum, off, 16);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + rsum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

    // acc += P V: rows ty*4 + i, columns 64 u + 4 tx + e
    for (int c = 0; c < kBlockK; c += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(&p_s[(ty * 4 + i) * kPRow + c]);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
#pragma unroll
        for (int u = 0; u < kCols / 4; ++u) {
          const float4 vv = *reinterpret_cast<const float4*>(
              &v_s[(c + cc) * kRow + 64 * u + 4 * tx]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = cc == 0 ? pv[i].x : cc == 1 ? pv[i].y
                          : cc == 2 ? pv[i].z : pv[i].w;
            acc[i][4 * u + 0] = fmaf(p, vv.x, acc[i][4 * u + 0]);
            acc[i][4 * u + 1] = fmaf(p, vv.y, acc[i][4 * u + 1]);
            acc[i][4 * u + 2] = fmaf(p, vv.z, acc[i][4 * u + 2]);
            acc[i][4 * u + 3] = fmaf(p, vv.w, acc[i][4 * u + 3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (r >= nq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int64_t d = 64 * (c / 4) + 4 * tx + (c % 4);
      if (d < hd) ob[(q0 + r) * os.s + d] = acc[i][c] / denom;
    }
  }
}

template <int HD_PAD>
int launch_f32_hd(dim3 grid, cudaStream_t stream, const void* q,
                  const void* k, const void* v, void* o, const void* q_pos,
                  int64_t s_len, int64_t t_len, int64_t group, int64_t hd,
                  Strides qs, Strides ks, Strides vs, Strides os, int causal,
                  int64_t window, float scale) {
  const size_t bytes = Layout<HD_PAD>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_f32_kernel<HD_PAD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  flash_f32_kernel<HD_PAD><<<grid, kThreads, bytes, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o,
      (const int32_t*)q_pos, s_len, t_len, group, hd, qs, ks, vs, os, causal,
      window, scale);
  return (int)cudaGetLastError();
}

// ----------------------------------------------------------- bf16 route --

constexpr int kTcRows = 128;            // query rows per block
constexpr int kTcKeys = 128;            // keys per tile
constexpr int kTcStages = 2;            // K/V tiles in flight
constexpr int kTcConsumerWarps = 8;     // two warpgroups of 64 rows
constexpr int kTcThreads = 32 * (kTcConsumerWarps + 1);   // + the producer
constexpr int kSwizzleRow = 128;        // bytes: 64 bf16 columns, one chunk
constexpr float kLog2e = 1.4426950408889634f;

template <int HD_PAD>
struct TcLayout {
  static constexpr int kChunks = HD_PAD / 64;         // 64-column chunks
  static constexpr int kQChunk = kTcRows * kSwizzleRow;
  static constexpr int kKVChunk = kTcKeys * kSwizzleRow;
  static constexpr int kQBytes = kChunks * kQChunk;
  static constexpr int kKVBytes = kChunks * kKVChunk;  // one K or V tile
  static constexpr int kOffK = kQBytes;
  static constexpr int kOffV = kOffK + kTcStages * kKVBytes;
  static constexpr int kOffBar = kOffV + kTcStages * kKVBytes;
  // Q, the K and V rings, 1 + 2 * stages mbarriers, slack to align to 1 KB
  static constexpr size_t kBytes = kOffBar + 8 * (1 + 2 * kTcStages) + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("{\n.reg .b64 state;\n"
               "mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n"
               :: "r"(bar) : "memory");
}

// Wait for the completion of the barrier's phase of this parity.  A wait
// lasts microseconds; one that outlasts 2^25 tries is a fault of the
// pipeline, and it traps (the launch fails) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  for (uint32_t tries = 0;; ++tries) {
    asm volatile("{\n.reg .pred p;\n"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 "selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (tries == (1u << 25)) __trap();
  }
}

// TMA: the box at (c0, c1, c2, c3) of a 4-D tensor map into shared memory,
// its bytes counted on `bar`
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout 128B
__device__ __forceinline__ uint64_t desc128(uint32_t addr, uint32_t lbo,
                                            uint32_t sbo) {
  return (uint64_t)((addr & 0x3ffff) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3fff) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3fff) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keep the compiler from moving register reads or writes across the
// asynchronous wgmma that owns these registers
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// D (64 x 128, f32) += A (64 x 16, K-major) * B (128 x 16, K-major), both
// from shared memory through their descriptors; scale_d = 0 ignores D's
// input
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 64, f32) += A (64 x 16, bf16 in registers) * B (16 x 64, MN-major
// in shared memory through its descriptor)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

// D (64 x 128, f32) += A (64 x 16, bf16 in registers) * B (16 x 128, MN-major
// in shared memory through its descriptor)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

// O (64 x HD_PAD) += P (64 x 16) V (16 x HD_PAD) for one 16-key step
template <int HD_PAD>
__device__ __forceinline__ void wgmma_pv(float (&acc)[HD_PAD / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (HD_PAD == 128) {
    wgmma_rs_n128(acc, a, db, 1);
  } else {
    wgmma_rs_n64(acc, a, db, 1);
  }
}

// The band of keys [lo, hi] that query positions [pmin, pmax] may see;
// lo > hi when there is none (also when the rows hold no query).
__device__ __forceinline__ void key_band(int64_t pmin, int64_t pmax,
                                         int64_t t_len, int causal,
                                         int64_t window, int64_t& lo,
                                         int64_t& hi) {
  lo = 0;
  hi = t_len - 1;
  if (pmin > pmax) {
    lo = 1;
    hi = 0;
    return;
  }
  if (causal && pmax < hi) hi = pmax;
  if (window > 0 && pmin - window + 1 > lo) lo = pmin - window + 1;
}

// true when no key of tile [kt, kt + kTcKeys) is masked for a row at `pos`
__device__ __forceinline__ bool tile_open(int64_t kt, int64_t pos,
                                          int64_t t_len, int causal,
                                          int64_t window) {
  return kt + kTcKeys <= t_len && (!causal || kt + kTcKeys - 1 <= pos) &&
         (window <= 0 || kt > pos - window);
}

__device__ __forceinline__ int clamp_rel(int64_t x) {
  constexpr int64_t kFar = int64_t(1) << 30;
  return (int)(x < -kFar ? -kFar : x > kFar ? kFar : x);
}

template <int HD_PAD>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_tc_kernel(const __grid_constant__ CUtensorMap q_map,
                const __grid_constant__ CUtensorMap k_map,
                const __grid_constant__ CUtensorMap v_map,
                __nv_bfloat16* __restrict__ o,
                const int32_t* __restrict__ q_pos, int64_t s_len,
                int64_t t_len, int64_t group, int64_t hd, Strides os,
                int causal, int64_t window, float scale) {
  using L = TcLayout<HD_PAD>;
  constexpr int kChunks = L::kChunks;
  constexpr int kNS = kTcKeys / 2;          // score registers per thread
  extern __shared__ uint8_t smem_raw[];
  __shared__ int32_t pos_s[kTcRows];
  __shared__ int32_t pmin_s[kTcRows / 32], pmax_s[kTcRows / 32];

  // 128-byte swizzled tiles need 1 KB alignment
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t q_base = base;
  const uint32_t k_base = base + L::kOffK;
  const uint32_t v_base = base + L::kOffV;
  const uint32_t bar_q = base + L::kOffBar;                 // Q arrived
  const uint32_t bar_full = bar_q + 8;                      // [stage]
  const uint32_t bar_empty = bar_full + 8 * kTcStages;      // [stage]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int64_t n_qt = (s_len + kTcRows - 1) / kTcRows;
  // the last query tiles have the longest bands: launch them first
  const int64_t q0 = (n_qt - 1 - (int64_t)blockIdx.x) * kTcRows;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (int)group;     // 32-bit: no division call

  if (tid < kTcRows) {
    const bool valid = q0 + tid < s_len;
    const int32_t p = valid ? q_pos[q0 + tid] : 0;
    pos_s[tid] = p;
    int32_t mn = valid ? p : INT_MAX, mx = valid ? p : INT_MIN;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      mn = min(mn, __shfl_xor_sync(0xffffffffu, mn, off));
      mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    }
    if (lane == 0) {
      pmin_s[warp] = mn;
      pmax_s[warp] = mx;
    }
  }
  if (tid == kTcConsumerWarps * 32) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kTcStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, kTcConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // each warpgroup's band, and the block's: the union of the two
  int64_t lo[2], hi[2];
#pragma unroll
  for (int w = 0; w < 2; ++w) {
    key_band(min(pmin_s[2 * w], pmin_s[2 * w + 1]),
             max(pmax_s[2 * w], pmax_s[2 * w + 1]), t_len, causal, window,
             lo[w], hi[w]);
  }
  int64_t b_lo = INT64_MAX, b_hi = -1;
#pragma unroll
  for (int w = 0; w < 2; ++w) {
    if (lo[w] <= hi[w]) {
      b_lo = lo[w] < b_lo ? lo[w] : b_lo;
      b_hi = hi[w] > b_hi ? hi[w] : b_hi;
    }
  }
  // tile counts as warp-uniform values (a shuffle from lane 0), so that
  // the compiler sees no divergent path around the wgmma instructions
  const int kt0 = __shfl_sync(
      0xffffffffu, (int)(b_hi >= 0 ? b_lo / kTcKeys * kTcKeys : 0), 0);
  const int n_tiles = __shfl_sync(
      0xffffffffu, (int)(b_hi >= 0 ? (b_hi - kt0) / kTcKeys + 1 : 0), 0);

  if (warp == kTcConsumerWarps) {
    // ---- producer: lane 0 issues every copy ----
    if (lane == 0) {
      mbar_expect_tx(bar_q, L::kQBytes);
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        tma_load_4d(q_base + c * L::kQChunk, &q_map, bar_q, 64 * c, (int)q0,
                    h, b);
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kTcStages;
        if (it >= kTcStages) {
          mbar_wait(bar_empty + 8 * s, (uint32_t)((it / kTcStages - 1) & 1));
        }
        const uint32_t full = bar_full + 8 * s;
        mbar_expect_tx(full, 2 * L::kKVBytes);
        const int kt = kt0 + it * kTcKeys;
#pragma unroll
        for (int c = 0; c < kChunks; ++c) {
          tma_load_4d(k_base + s * L::kKVBytes + c * L::kKVChunk, &k_map,
                      full, 64 * c, kt, kvh, b);
          tma_load_4d(v_base + s * L::kKVBytes + c * L::kKVChunk, &v_map,
                      full, 64 * c, kt, kvh, b);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 ----
  const int wg = __shfl_sync(0xffffffffu, warp >> 2, 0);
  const int r_a = 64 * wg + 16 * (warp & 3) + (lane >> 2);  // and r_a + 8
  const int quad = lane & 3;
  const int64_t pos_a = pos_s[r_a], pos_b = pos_s[r_a + 8];
  const float sl2 = scale * kLog2e;
  const float sentinel = kNegInf * kLog2e;
  const uint32_t q_wg = q_base + wg * 64 * kSwizzleRow;

  // the tiles this warpgroup visits, it_first .. it_last, are a run of
  // the block's; it still waits for and releases the others
  const int64_t w_lo = wg ? lo[1] : lo[0], w_hi = wg ? hi[1] : hi[0];
  int it_first = n_tiles, it_last = -1;
  if (w_lo <= w_hi && n_tiles > 0) {
    it_first = (int)((w_lo - kt0) / kTcKeys);
    it_last = (int)((w_hi - kt0) / kTcKeys);
    if (it_last > n_tiles - 1) it_last = n_tiles - 1;
  }
  it_first = __shfl_sync(0xffffffffu, it_first, 0);
  it_last = __shfl_sync(0xffffffffu, it_last, 0);

  float m_a = sentinel, m_b = sentinel, l_a = 0.0f, l_b = 0.0f;
  float acc[HD_PAD / 2], sc[kNS];
#pragma unroll
  for (int i = 0; i < HD_PAD / 2; ++i) acc[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < kNS; ++i) sc[i] = 0.0f;

  mbar_wait(bar_q, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % kTcStages;
    mbar_wait(bar_full + 8 * s, (uint32_t)((it / kTcStages) & 1));
    if (it >= it_first && it <= it_last) {
      const int64_t kt = kt0 + it * kTcKeys;
      const uint32_t k_s = k_base + s * L::kKVBytes;
      const uint32_t v_s = v_base + s * L::kKVBytes;

      // S = Q K^T: 16 columns of hd per step, 32 bytes into a 128-byte row
      fence_regs(sc);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < HD_PAD / 16; ++ks) {
        const uint32_t col = (ks % 4) * 32;
        wgmma_ss_n128(sc,
                      desc128(q_wg + (ks / 4) * L::kQChunk + col, 16, 1024),
                      desc128(k_s + (ks / 4) * L::kKVChunk + col, 16, 1024),
                      ks > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);

      // scale to log2 units; sc[i] is row r_a (i & 2 == 0) or r_a + 8,
      // key kt + 2 quad + 8 (i / 4) + (i & 1).  Where any lane of the warp
      // meets a masked key, mask by selects, with no branch per lane.
#pragma unroll
      for (int i = 0; i < kNS; ++i) sc[i] *= sl2;
      const bool open = tile_open(kt, pos_a, t_len, causal, window) &&
                        tile_open(kt, pos_b, t_len, causal, window);
      if (__any_sync(0xffffffffu, !open)) {
        const int64_t k0 = kt + 2 * quad;          // the key of sc[0]
        const int t_rel = clamp_rel(t_len - k0);
        const int far = 1 << 30;
        const int hi_a = causal ? clamp_rel(pos_a - k0) : far;
        const int hi_b = causal ? clamp_rel(pos_b - k0) : far;
        const int lo_a = window > 0 ? clamp_rel(pos_a - window + 1 - k0) : -far;
        const int lo_b = window > 0 ? clamp_rel(pos_b - window + 1 - k0) : -far;
#pragma unroll
        for (int i = 0; i < kNS; ++i) {
          const int c = 8 * (i >> 2) + (i & 1);
          const int hi_r = (i & 2) ? hi_b : hi_a, lo_r = (i & 2) ? lo_b : lo_a;
          const float x = (c <= hi_r && c >= lo_r) ? sc[i] : sentinel;
          sc[i] = c < t_rel ? x : -CUDART_INF_F;   // past T: not a key
        }
      }

      // online softmax; l sums this thread's share of the unrounded p
      float mx_a = -CUDART_INF_F, mx_b = -CUDART_INF_F;
#pragma unroll
      for (int i = 0; i < kNS; ++i) {
        if (i & 2) {
          mx_b = fmaxf(mx_b, sc[i]);
        } else {
          mx_a = fmaxf(mx_a, sc[i]);
        }
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
      }
      const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
      const float corr_a = exp2f(m_a - mn_a), corr_b = exp2f(m_b - mn_b);
      m_a = mn_a;
      m_b = mn_b;
      float sum_a = 0.0f, sum_b = 0.0f;
#pragma unroll
      for (int i = 0; i < kNS; ++i) {
        if (i & 2) {
          sc[i] = exp2f(sc[i] - mn_b);
          sum_b += sc[i];
        } else {
          sc[i] = exp2f(sc[i] - mn_a);
          sum_a += sc[i];
        }
      }
      l_a = l_a * corr_a + sum_a;
      l_b = l_b * corr_b + sum_b;
#pragma unroll
      for (int i = 0; i < HD_PAD / 2; ++i) acc[i] *= (i & 2) ? corr_b : corr_a;

      // P rounded to bf16 as A fragments: the accumulator layout of keys
      // 16 kk .. 16 kk + 15 is the A-operand layout of a k16 step
      uint32_t pa[kTcKeys / 16][4];
#pragma unroll
      for (int kk = 0; kk < kTcKeys / 16; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          pa[kk][j] = pack_bf16(sc[8 * kk + 2 * j], sc[8 * kk + 2 * j + 1]);

      // O += P V: 16 keys (2 KB of 128-byte rows) per step
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kTcKeys / 16; ++kk) {
        wgmma_pv<HD_PAD>(acc, pa[kk],
                         desc128(v_s + kk * 16 * kSwizzleRow, L::kKVChunk,
                                 1024));
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty + 8 * s);   // this warp is done
  }

  // o = acc / max(l, 1e-30) by the fast division (the result is rounded
  // to bf16), stored as bf16; rows past S and columns past hd are not
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  const float den_a = fmaxf(l_a, 1e-30f), den_b = fmaxf(l_b, 1e-30f);
  const bool pairs = ((hd | os.s | os.h | os.b) & 1) == 0;
  __nv_bfloat16* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int j = 0; j < HD_PAD / 8; ++j) {
    const int64_t d = 8 * j + 2 * quad;
    if (d >= hd) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int64_t row = q0 + r_a + 8 * half;
      if (row >= s_len) continue;
      const float den = half ? den_b : den_a;
      const float x0 = __fdividef(acc[4 * j + 2 * half], den);
      const float x1 = __fdividef(acc[4 * j + 2 * half + 1], den);
      __nv_bfloat16* dst = ob + row * os.s + d;
      if (pairs && d + 1 < hd) {
        *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(x0, x1);
      } else {
        dst[0] = __float2bfloat16_rn(x0);
        if (d + 1 < hd) dst[1] = __float2bfloat16_rn(x1);
      }
    }
  }
}

// cuTensorMapEncodeTiled from libcuda, looked up through the CUDA runtime
// (the library links only the runtime)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// A 4-D map (hd, seq, heads, batch) of a bf16 tensor read through its
// strides, boxes of 64 columns x `rows` rows of one head, 128-byte swizzle.
// head_dim is a dimension of its own, of size hd, so the columns of a box
// past hd are out of bounds and arrive as zeros.  TMA needs a 16-byte
// aligned base and strides that are multiples of 16 bytes; the wrapper
// copies a tensor that does not qualify.  A dimension of size 1 is never
// stepped, so its stride is replaced by a valid one.
int make_map(CUtensorMap* map, const void* base, int64_t hd, int64_t seq,
             int64_t heads, int64_t batch, Strides st, uint32_t rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  if ((uintptr_t)base & 15) return (int)cudaErrorMisalignedAddress;
  const int64_t size[3] = {seq, heads, batch};
  const int64_t stride[3] = {st.s, st.h, st.b};
  const int64_t spare = ((hd * 2 + 15) / 16) * 16 * seq * heads;
  cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)seq, (cuuint64_t)heads,
                        (cuuint64_t)batch};
  cuuint64_t strides[3];
  for (int i = 0; i < 3; ++i) {
    const int64_t bytes = size[i] == 1 ? spare : stride[i] * 2;
    if (bytes <= 0 || bytes % 16) return (int)cudaErrorInvalidValue;
    strides[i] = (cuuint64_t)bytes;
  }
  const cuuint32_t box[4] = {64, rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int HD_PAD>
int launch_tc_hd(cudaStream_t stream, const void* q, const void* k,
                 const void* v, void* o, const void* q_pos, int64_t b,
                 int64_t s_len, int64_t t_len, int64_t hq, int64_t kh,
                 int64_t hd, Strides qs, Strides ks, Strides vs, Strides os,
                 int causal, int64_t window, float scale) {
  CUtensorMap q_map, k_map, v_map;
  int rc = make_map(&q_map, q, hd, s_len, hq, b, qs, kTcRows);
  if (rc == 0) rc = make_map(&k_map, k, hd, t_len, kh, b, ks, kTcKeys);
  if (rc == 0) rc = make_map(&v_map, v, hd, t_len, kh, b, vs, kTcKeys);
  if (rc != 0) return rc;
  const size_t bytes = TcLayout<HD_PAD>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_tc_kernel<HD_PAD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((s_len + kTcRows - 1) / kTcRows), (unsigned)hq,
                  (unsigned)b);
  flash_tc_kernel<HD_PAD><<<grid, kTcThreads, bytes, stream>>>(
      q_map, k_map, v_map, (__nv_bfloat16*)o, (const int32_t*)q_pos, s_len,
      t_len, hq / kh, hd, os, causal, window, scale);
  return (int)cudaGetLastError();
}

int check_shape(int64_t b, int64_t s_len, int64_t t_len, int64_t hq,
                int64_t kh, int64_t hd) {
  if (b < 1 || s_len < 1 || t_len < 1 || kh < 1 || hq < kh || hq % kh ||
      hd < 1 || hd > 128 || (s_len + 63) / 64 > 2147483647 || hq > 65535 ||
      b > 65535 || t_len > 2147483647) {
    return (int)cudaErrorInvalidConfiguration;
  }
  return 0;
}

}  // namespace

extern "C" int flash_attention_f32(
    const void* q, const void* k, const void* v, void* o, const void* q_pos,
    int64_t b, int64_t s_len, int64_t t_len, int64_t hq, int64_t kh,
    int64_t hd, int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb,
    int64_t k_st, int64_t k_sh, int64_t v_sb, int64_t v_st, int64_t v_sh,
    int64_t o_sb, int64_t o_ss, int64_t o_sh, int64_t causal, int64_t window,
    float scale, int64_t device, void* stream) {
  cudaError_t err = cudaSetDevice((int)device);
  if (err != cudaSuccess) return (int)err;
  const int bad = check_shape(b, s_len, t_len, hq, kh, hd);
  if (bad) return bad;
  const dim3 grid((unsigned)((s_len + kBlockQ - 1) / kBlockQ), (unsigned)hq,
                  (unsigned)b);
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_st, k_sh},
      vs{v_sb, v_st, v_sh}, os{o_sb, o_ss, o_sh};
  const int c = causal ? 1 : 0;
  if (hd <= 64) {
    return launch_f32_hd<64>(grid, (cudaStream_t)stream, q, k, v, o, q_pos,
                             s_len, t_len, hq / kh, hd, qs, ks, vs, os, c,
                             window, scale);
  }
  return launch_f32_hd<128>(grid, (cudaStream_t)stream, q, k, v, o, q_pos,
                            s_len, t_len, hq / kh, hd, qs, ks, vs, os, c,
                            window, scale);
}

extern "C" int flash_attention_bf16(
    const void* q, const void* k, const void* v, void* o, const void* q_pos,
    int64_t b, int64_t s_len, int64_t t_len, int64_t hq, int64_t kh,
    int64_t hd, int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb,
    int64_t k_st, int64_t k_sh, int64_t v_sb, int64_t v_st, int64_t v_sh,
    int64_t o_sb, int64_t o_ss, int64_t o_sh, int64_t causal, int64_t window,
    float scale, int64_t device, void* stream) {
  cudaError_t err = cudaSetDevice((int)device);
  if (err != cudaSuccess) return (int)err;
  const int bad = check_shape(b, s_len, t_len, hq, kh, hd);
  if (bad) return bad;
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_st, k_sh},
      vs{v_sb, v_st, v_sh}, os{o_sb, o_ss, o_sh};
  const int c = causal ? 1 : 0;
  if (hd <= 64) {
    return launch_tc_hd<64>((cudaStream_t)stream, q, k, v, o, q_pos, b, s_len,
                            t_len, hq, kh, hd, qs, ks, vs, os, c, window,
                            scale);
  }
  return launch_tc_hd<128>((cudaStream_t)stream, q, k, v, o, q_pos, b, s_len,
                           t_len, hq, kh, hd, qs, ks, vs, os, c, window,
                           scale);
}
