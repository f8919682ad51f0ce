// Shared helpers of the port's CUDA kernels: element loads and stores in
// the input dtype with float32 arithmetic, and 16-byte words of elements.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

template <typename T> struct Elem;

template <> struct Elem<float> {
  static __device__ __forceinline__ float load(float x) { return x; }
  static __device__ __forceinline__ float store(float x) { return x; }
};

template <> struct Elem<__nv_bfloat16> {
  static __device__ __forceinline__ float load(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  static __device__ __forceinline__ __nv_bfloat16 store(float x) {
    return __float2bfloat16_rn(x);  // round to nearest even, as torch's .to()
  }
};

// The 16 / sizeof(T) elements of one 16-byte word, as floats and back
// (bf16 widens exactly and narrows by Elem's rounding).
template <typename T> struct Word;

template <> struct Word<float> {
  static constexpr int kN = 4;
  static __device__ __forceinline__ void unpack(uint4 w, float* x) {
    x[0] = __uint_as_float(w.x);
    x[1] = __uint_as_float(w.y);
    x[2] = __uint_as_float(w.z);
    x[3] = __uint_as_float(w.w);
  }
  static __device__ __forceinline__ uint4 pack(const float* x) {
    return make_uint4(__float_as_uint(x[0]), __float_as_uint(x[1]),
                      __float_as_uint(x[2]), __float_as_uint(x[3]));
  }
};

template <> struct Word<__nv_bfloat16> {
  static constexpr int kN = 8;
  static __device__ __forceinline__ void unpack(uint4 w, float* x) {
    const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[2 * i] = __uint_as_float(u[i] << 16);            // exact widening
      x[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ uint4 pack(const float* x) {
    uint32_t u[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      u[i] = (uint32_t)__bfloat16_as_ushort(
                 Elem<__nv_bfloat16>::store(x[2 * i])) |
             ((uint32_t)__bfloat16_as_ushort(
                  Elem<__nv_bfloat16>::store(x[2 * i + 1])) << 16);
    }
    return make_uint4(u[0], u[1], u[2], u[3]);
  }
};

// A thread's columns of one row: one 16-byte word (kN of them, loaded and
// stored whole, the store evict-first) or one element (plain accesses).
template <typename T, bool kWide> struct Cols;

template <typename T> struct Cols<T, false> {
  static constexpr int kN = 1;
  static __device__ __forceinline__ void load(const T* p, float* x) {
    x[0] = Elem<T>::load(*p);
  }
  static __device__ __forceinline__ void store(T* p, const float* x) {
    *p = Elem<T>::store(x[0]);
  }
};

template <typename T> struct Cols<T, true> {
  static constexpr int kN = Word<T>::kN;
  static __device__ __forceinline__ void load(const T* p, float* x) {
    Word<T>::unpack(*reinterpret_cast<const uint4*>(p), x);
  }
  static __device__ __forceinline__ void store(T* p, const float* x) {
    __stcs(reinterpret_cast<uint4*>(p), Word<T>::pack(x));
  }
};

// The leaf table of the kernels whose threads each own the columns of one
// 16-byte word (weighted_avg, prefix_avg).  One launch covers up to
// kMaxWordLeaves leaves of a tree; grid.x runs over all their column blocks
// one after the other, as the wrappers' `launch_plan` lays them out
// (weighted_avg/kernel.py), and the kernel takes the table by value.
constexpr int kWordThreads = 256;    // threads a block: THREADS in the plan
constexpr int kMaxWordLeaves = 32;
constexpr int kWordLeafFields = 5;   // the wrapper's table: src, out, d,
                                     // blk0, vec

struct WordLeaf {
  const void* src;   // (M, d) stack
  void* out;         // (rows, d) output
  int64_t d;
  int64_t blk0;      // first column block of the leaf in grid.x
  int64_t vec;       // columns per thread: Word<T>::kN, or 1
};

struct WordTable {
  WordLeaf leaf[kMaxWordLeaves];
  int64_t n;
};

// Fill `t` from the wrapper's n rows of kWordLeafFields int64 in host
// memory, in increasing blk0.  Refuses (cudaErrorInvalidConfiguration) a
// table size or grid.x the launch cannot take, and (cudaErrorInvalidValue)
// a leaf whose column blocks do not cover its D from where the previous
// leaf's end, or whose 16-byte path lacks whole, aligned words in every row
// of its stack and output.
template <typename T>
inline cudaError_t fill_word_table(const int64_t* leaves, int64_t n,
                                   int64_t blocks_x, WordTable* t) {
  if (n < 1 || n > kMaxWordLeaves || blocks_x < 1 || blocks_x > 0x7fffffff) {
    return cudaErrorInvalidConfiguration;
  }
  *t = WordTable{};
  t->n = n;
  for (int64_t i = 0; i < n; ++i) {
    const int64_t* f = leaves + i * kWordLeafFields;
    t->leaf[i] = {(const void*)f[0], (void*)f[1], f[2], f[3], f[4]};
  }
  for (int64_t i = 0; i < n; ++i) {
    const WordLeaf& leaf = t->leaf[i];
    const int64_t end = i + 1 < n ? t->leaf[i + 1].blk0 : blocks_x;
    const bool wide = leaf.vec == Word<T>::kN && leaf.d % leaf.vec == 0 &&
                      (uintptr_t)leaf.src % 16 == 0 &&
                      (uintptr_t)leaf.out % 16 == 0;
    if ((leaf.vec != 1 && !wide) || leaf.d < 1 ||
        (i == 0 && leaf.blk0 != 0) || end <= leaf.blk0 ||
        (end - leaf.blk0) * kWordThreads * leaf.vec < leaf.d) {
      return cudaErrorInvalidValue;
    }
  }
  return cudaSuccess;
}

// The leaf that owns column block b of grid.x.
__device__ __forceinline__ const WordLeaf& word_leaf(const WordTable& t,
                                                     int64_t b) {
  int i = 0;
  while (i + 1 < t.n && b >= t.leaf[i + 1].blk0) ++i;
  return t.leaf[i];
}

// Attention's key band (flash_attention.cu and its backward): the keys
// [lo, hi] that query positions [pmin, pmax] may see under the causal mask
// and a window; lo > hi when there is none (also when the rows hold no
// query).
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
