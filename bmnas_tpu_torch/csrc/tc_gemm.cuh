// Tensor-core building blocks for the cell kernels (node_mixed.cu) and the
// attention kernel (attention.cu), through the WMMA C++ API (nvcuda::wmma),
// so that no fragment layout is assumed.
//
//   * TcStep<T>: one MMA step of depth kK on 16x16 tiles, the A operand
//     row-major in shared memory, fp32 accumulation. An A operand is loaded
//     once (load_a) and multiplied into N output tiles at once (mma), each
//     with its own B operand (load_b): a row-major B (TcStep<T>::B) or the
//     transpose of a row-major matrix read in place (TcStep<T>::BT, WMMA's
//     col_major: S = Q K^T with K as it is stored).
//       fp32 storage: 3xTF32, m16n16k8. Each operand v is split into
//         hi = tf32(v) and lo = tf32(v - hi); the product is lo*hi + hi*lo
//         + hi*hi (the small terms first), which keeps about fp32 accuracy
//         (the lo*lo term, below 2^-22 of the product, is dropped);
//         mma_terms keeps the three terms in three accumulators. A B
//         operand that is exact in TF32 (bf16 values widened to fp32) is
//         loaded unsplit (load_b_exact) and takes two products
//         (mma_exact_b): lo*hi + hi*hi.
//       bf16 storage: one bf16 MMA, m16n16k16; bf16 operands are exact.
//   * cp_async_wait<N>() / cp_async_wait_n(n): wait until at most N (n)
//     committed cp.async groups of this thread are still in flight
//     (cell_common.cuh has the copy and the commit);
//   * group_sync(id, n) / group_arrive(id, n): a named barrier of n
//     threads, for warp groups that work apart within a block.
//
// Pointers handed to load_a / load_b must be 32-byte aligned and the
// leading dimensions multiples of 16 bytes (WMMA's rules).
#pragma once

#include <cuda_bf16.h>
#include <mma.h>

namespace {

namespace wmma = nvcuda::wmma;

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Barrier of the n threads (a multiple of 32) that use barrier id (1..15):
// one warp group meets without the rest of the block.
__device__ __forceinline__ void group_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// Arrive at barrier id for n threads without waiting: the threads that
// wait there go on once all n have come (a producer's handover).
__device__ __forceinline__ void group_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// cp_async_wait<n> for a count known only at run time, 0 <= n <= 8.
__device__ __forceinline__ void cp_async_wait_n(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    case 7: cp_async_wait<7>(); break;
    default: cp_async_wait<8>(); break;
  }
}

// hi = tf32(hi), lo = tf32(v - hi) elementwise, v the loaded fragment.
template <typename Frag>
__device__ __forceinline__ void split_tf32(Frag& hi, Frag& lo) {
#pragma unroll
  for (int i = 0; i < hi.num_elements; ++i) {
    const float v = hi.x[i];
    hi.x[i] = wmma::__float_to_tf32(v);
    lo.x[i] = wmma::__float_to_tf32(v - hi.x[i]);
  }
}

template <typename T>
struct TcStep;

template <>
struct TcStep<float> {
  static constexpr int kK = 8;  // depth of one MMA step
  using Acc = wmma::fragment<wmma::accumulator, 16, 16, 8, float>;
  struct A {
    wmma::fragment<wmma::matrix_a, 16, 16, 8, wmma::precision::tf32,
                   wmma::row_major>
        hi, lo;
  };
  template <typename Layout>
  struct BOf {
    wmma::fragment<wmma::matrix_b, 16, 16, 8, wmma::precision::tf32, Layout>
        hi, lo;
  };
  using B = BOf<wmma::row_major>;
  using BT = BOf<wmma::col_major>;

  __device__ __forceinline__ static void load_a(A& a, const float* p,
                                                int ld) {
    wmma::load_matrix_sync(a.hi, p, ld);
    split_tf32(a.hi, a.lo);
  }
  template <typename Frag>
  __device__ __forceinline__ static void load_b(Frag& b, const float* p,
                                                int ld) {
    wmma::load_matrix_sync(b.hi, p, ld);
    split_tf32(b.hi, b.lo);
  }
  // A row-major B operand whose values are exact in TF32: b.lo stays unset
  // and mma_exact_b does not read it.
  __device__ __forceinline__ static void load_b_exact(B& b, const float* p,
                                                      int ld) {
    wmma::load_matrix_sync(b.hi, p, ld);
  }
  // acc[c] += a b[c] for N tiles (acc: the first N of an array), the small
  // terms first; one term of every tile before the next term of any, so
  // that consecutive MMAs never wait on each other (a warp issues in
  // order).
  template <int N, typename Frag>
  __device__ __forceinline__ static void mma(Acc* acc, const A& a,
                                             const Frag (&b)[N]) {
#pragma unroll
    for (int c = 0; c < N; ++c) wmma::mma_sync(acc[c], a.lo, b[c].hi, acc[c]);
#pragma unroll
    for (int c = 0; c < N; ++c) wmma::mma_sync(acc[c], a.hi, b[c].lo, acc[c]);
#pragma unroll
    for (int c = 0; c < N; ++c) wmma::mma_sync(acc[c], a.hi, b[c].hi, acc[c]);
  }
  // acc[i] += term i of a b for one tile: lo*hi, hi*lo and hi*hi each in
  // an accumulator of its own, so that the three MMAs of a step do not
  // wait on each other; sum_terms adds them, the small terms first.
  static constexpr int kTerms = 3;
  template <typename Frag>
  __device__ __forceinline__ static void mma_terms(Acc (&acc)[kTerms],
                                                   const A& a,
                                                   const Frag& b) {
    wmma::mma_sync(acc[0], a.lo, b.hi, acc[0]);
    wmma::mma_sync(acc[1], a.hi, b.lo, acc[1]);
    wmma::mma_sync(acc[2], a.hi, b.hi, acc[2]);
  }
  __device__ __forceinline__ static void sum_terms(Acc (&acc)[kTerms]) {
#pragma unroll
    for (int i = 0; i < acc[0].num_elements; ++i)
      acc[0].x[i] = (acc[0].x[i] + acc[1].x[i]) + acc[2].x[i];
  }
  // acc[c] += a b[c] for N tiles whose B operands came from load_b_exact,
  // interleaved as in mma.
  template <int N>
  __device__ __forceinline__ static void mma_exact_b(Acc* acc, const A& a,
                                                     const B (&b)[N]) {
#pragma unroll
    for (int c = 0; c < N; ++c) wmma::mma_sync(acc[c], a.lo, b[c].hi, acc[c]);
#pragma unroll
    for (int c = 0; c < N; ++c) wmma::mma_sync(acc[c], a.hi, b[c].hi, acc[c]);
  }
};

template <>
struct TcStep<__nv_bfloat16> {
  static constexpr int kK = 16;
  using Acc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
  struct A {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                   wmma::row_major>
        v;
  };
  template <typename Layout>
  struct BOf {
    wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, Layout> v;
  };
  using B = BOf<wmma::row_major>;
  using BT = BOf<wmma::col_major>;

  __device__ __forceinline__ static void load_a(A& a,
                                                const __nv_bfloat16* p,
                                                int ld) {
    wmma::load_matrix_sync(a.v, p, ld);
  }
  template <typename Frag>
  __device__ __forceinline__ static void load_b(Frag& b,
                                                const __nv_bfloat16* p,
                                                int ld) {
    wmma::load_matrix_sync(b.v, p, ld);
  }
  template <int N, typename Frag>
  __device__ __forceinline__ static void mma(Acc* acc, const A& a,
                                             const Frag (&b)[N]) {
#pragma unroll
    for (int c = 0; c < N; ++c) wmma::mma_sync(acc[c], a.v, b[c].v, acc[c]);
  }
  static constexpr int kTerms = 1;  // one product: mma_terms is mma
  template <typename Frag>
  __device__ __forceinline__ static void mma_terms(Acc (&acc)[kTerms],
                                                   const A& a,
                                                   const Frag& b) {
    wmma::mma_sync(acc[0], a.v, b.v, acc[0]);
  }
  __device__ __forceinline__ static void sum_terms(Acc (&)[kTerms]) {}
};

}  // namespace
