// Rowwise upload-delta codec roundtrip (encode -> decode), hand-written for
// Hopper.
//
// Replaces: the Pallas TPU kernel `delta_codec_kernel` (body `_codec_kernel`,
// helper `_kth_largest`) in src/repro/kernels/delta_codec/kernel.py.
//
// Computes, for each row x of a (rows, D) float32 delta matrix:
//   quant8       scale = max(max|x|, 1e-12) / 127,
//                out = clip(rint(x / scale), -127, 127) * scale;
//   topk         out = x on exactly the k largest |x| (ties lowest column
//                first, the lax.top_k contract), +0.0 elsewhere;
//   quant8_topk  the quant8 value on the top-k set, +0.0 elsewhere.
// Division and product are IEEE (__fdiv_rn / __fmul_rn, so nvcc cannot
// swap in a reciprocal), rintf rounds half to even like jnp.round, and a
// dropped entry is written as +0.0, never x * 0: the kernel equals the
// plain version bit for bit on finite rows.  Non-finite values pass through
// as in the plain version and the reference (jnp.max and jnp.clip propagate
// NaN): the abs-max is an integer max of the |x| bit patterns, so one NaN
// makes the scale NaN, the max with 1e-12 and the clip are compares that
// keep a NaN, and an inf abs-max gives an inf scale and NaN outputs.  In
// the keep set every NaN counts as one key above inf, so NaNs are the
// largest entries and tie in column order, as in a stable sort.
//
// What bounds it on the H100: bytes, one read and one write of the row;
// the keep-set search is integer compares.  The TPU design keeps the whole
// row in VMEM for ~50 passes; a 156,800-float row is 627 KB, more than the
// 227 KB of shared memory a block may have, so that does not carry over.
//
// What the simple design does about it: one block of 1024 threads per row;
// the row stays in global memory, where the re-reads hit L2 (the whole
// main-path cohort is 3.6 MB).  The k-th largest |x| bit pattern (31 bits,
// monotone in |x|) is found by radix select: four histogram passes over
// digits of 7/8/8/8 bits with 256 bins in shared memory, each pass keeping
// only entries whose higher digits match the prefix found so far.  The last
// histogram also counts the ties at the threshold; when not all of them are
// kept, one block-wide prefix scan in column order ranks them (warp ballots,
// then the warps' counts).  A few rows leave most SMs idle; several blocks
// per row and warp-aggregated histogram updates are later work.
#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
enum Codec : int64_t { kQuant8 = 0, kTopk = 1, kQuant8Topk = 2 };

constexpr uint32_t kInfBits = 0x7f800000u;

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

__global__ void __launch_bounds__(kThreads)
delta_codec_kernel(const float* __restrict__ x, float* __restrict__ out,
                   int64_t d, int64_t codec, int64_t k) {
  __shared__ unsigned hist[256];
  __shared__ uint32_t red[kWarps];
  __shared__ int warp_cnt[kWarps];
  __shared__ uint32_t s_prefix;
  __shared__ int s_want, s_ties;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* row = x + (int64_t)blockIdx.x * d;
  float* dst = out + (int64_t)blockIdx.x * d;

  // ---- scale from the row's abs-max (an integer max of the |x| bits:
  // order-free, so exact, and a NaN in the row makes it NaN) -------------
  float scale = 0.0f;
  if (codec != kTopk) {
    uint32_t v = 0u;
    for (int64_t c = tid; c < d; c += kThreads) v = max(v, abs_bits(row[c]));
    v = __reduce_max_sync(kFull, v);
    if (lane == 0) red[warp] = v;
    __syncthreads();
    uint32_t top = red[0];
    for (int w = 1; w < kWarps; ++w) top = max(top, red[w]);
    const float amax = __uint_as_float(top);
    scale = __fdiv_rn(amax < 1e-12f ? 1e-12f : amax, 127.0f);
  }

  // ---- radix select of the k-th largest key -----------------------------
  uint32_t thr = 0, mask = 0;
  int want = (int)k, ties = 0;
  if (codec != kQuant8) {
    for (int shift = 24; shift >= 0; shift -= 8) {
      for (int b = tid; b < 256; b += kThreads) hist[b] = 0u;
      __syncthreads();
      for (int64_t c = tid; c < d; c += kThreads) {
        const uint32_t key = key_of(row[c]);
        if ((key & mask) == thr) atomicAdd(&hist[(key >> shift) & 0xffu], 1u);
      }
      __syncthreads();
      if (tid == 0) {
        int above = 0, b = 255;
        for (; b > 0; --b) {
          if (above + (int)hist[b] >= want) break;
          above += (int)hist[b];
        }
        s_prefix = thr | ((uint32_t)b << shift);
        s_want = want - above;
        s_ties = (int)hist[b];
      }
      __syncthreads();
      thr = s_prefix;
      want = s_want;
      ties = s_ties;
      mask |= 0xffu << shift;
    }
  }
  // keys > thr are kept; of the `ties` keys == thr, the first `want` columns
  const bool rank_ties = codec != kQuant8 && want < ties;

  // ---- write: one chunk of kThreads columns at a time, in column order --
  int seen = 0;  // ties in earlier chunks
  for (int64_t c0 = 0; c0 < d; c0 += kThreads) {
    const int64_t c = c0 + tid;
    const bool in = c < d;
    const float v = in ? row[c] : 0.0f;
    const uint32_t key = key_of(v);
    const bool tie = in && codec != kQuant8 && key == thr;
    bool keep = codec == kQuant8 || key > thr || (tie && !rank_ties);
    if (rank_ties) {
      const unsigned bal = __ballot_sync(kFull, tie);
      if (lane == 0) warp_cnt[warp] = __popc(bal);
      __syncthreads();
      int before = seen + __popc(bal & ((1u << lane) - 1u)), total = 0;
      for (int w = 0; w < kWarps; ++w) {
        if (w < warp) before += warp_cnt[w];
        total += warp_cnt[w];
      }
      keep = keep || (tie && before < want);
      seen += total;
      __syncthreads();
    }
    if (in) dst[c] = keep ? (codec == kTopk ? v : quantize(v, scale)) : 0.0f;
  }
}

}  // namespace

extern "C" int delta_codec_f32(const void* x, void* out, int64_t rows,
                               int64_t d, int64_t codec, int64_t k,
                               int64_t device, void* stream) {
  cudaError_t err = cudaSetDevice((int)device);
  if (err != cudaSuccess) return (int)err;
  if (rows > 2147483647LL || codec < kQuant8 || codec > kQuant8Topk ||
      (codec != kQuant8 && (k < 1 || k > d))) {
    return (int)cudaErrorInvalidValue;
  }
  delta_codec_kernel<<<(unsigned)rows, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (float*)out, d, codec, k);
  return (int)cudaGetLastError();
}
