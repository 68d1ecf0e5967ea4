// softmax(x y^T / sqrt(C)) y, keys equal to values, as one CUDA kernel for
// Hopper.
//
// Replaces bmnas_tpu/ops/kernels/attention.py::blockwise_scaled_dot_attention
// (the Pallas TPU kernel). Queries x (B, Lq, C) and keys = values y
// (B, Lk, C) in fp32 or bf16, read in their own type and accumulated in
// fp32; the output is fp32 (B, Lq, C). The key axis is consumed tile by tile
// with an online softmax (running max m, running denominator l, an fp32
// accumulator rescaled by exp(m_old - m_new)), so the (Lq, Lk) score matrix
// is never written to device memory: only x, y and the output are.
//
// What bounds it on an H100: the call does 4 B Lq Lk C FLOP (two products)
// and must move 4 (2 B Lq C + B Lk C) bytes in fp32. At B = 8, C = 192,
// L = 16 that is 1.6 MFLOP against 295 KB: bound by bytes, 0.09 us at
// 3.35 TB/s, where launch latency is all that shows. From L of a few
// hundred on it is bound by operations: 24 us at L = 512 and 1.5 ms at
// L = 4096 at the 67 TFLOP/s fp32 rate.
//
// What the design does about it:
//   * one block of 256 threads per (sample, 64-query tile). The grid is
//     exactly B * ceil(Lq / 64) blocks, so a ragged Lq needs no pad copy:
//     query rows past Lq are staged as zeros and never stored.
//   * the query tile sits in shared memory in fp32, converted once. Key
//     tiles of 64 rows stream through a double buffer in shared memory by
//     cp.async in their storage type, the next tile in flight while the
//     current one is used. Rows past Lk are never loaded and their scores
//     are masked: p = 0 explicitly, m starting at -1e30 as in the TPU
//     kernel, so the first tile's correction exp(-1e30 - m) is 0, never NaN.
//   * one tile's 64 x 64 scores live in shared memory; each thread computes
//     a 4 x 4 block of them in registers from float4 reads. Rows are padded
//     by 16 bytes, so the rows of a float4 read fall on distinct banks.
//   * the softmax update takes one warp per 8 query rows, max and sum by
//     shuffles. The accumulator lives in registers: thread (ty, tx) owns
//     rows ty + 16 i and channel quads tx + 16 k, up to C = 256. C need not
//     be a power of two: at C = 192 (48 quads) the threads past C idle in
//     the P K product.
//   * block_q / block_k of the TPU kernel sized VMEM tiles of a sequential
//     grid; a Hopper block picks its own (64 x 64) and the wrapper keeps the
//     two arguments for the signature only.
//   * plain fp32 FMA on the CUDA cores, one block per SM (166 KB of shared
//     memory at C = 192 in fp32): far from the 67 TFLOP/s bound at long L.
//     mma.sync / wgmma in TF32 or bf16 (FlashAttention-2/3) is later work.
//
// Requirements: C % 8 == 0, 8 <= C <= 256, B, Lq, Lk >= 1, checked here;
// 16-byte aligned x, y and out, checked by the wrapper.
#include "cell_common.cuh"

namespace {

constexpr int kBQ = 64;        // query rows of one block
constexpr int kBK = 64;        // key rows of one tile
constexpr int kThreads = 256;  // 16 x 16: (ty, tx)
constexpr float kNegInf = -1e30f;

// Bytes of dynamic shared memory: the fp32 query tile, the scores, m, l and
// the corrections, then two key tiles in the storage type. Rows carry 16
// bytes of padding.
size_t attention_smem(int C, int itemsize) {
  return static_cast<size_t>(kBQ) * (C + 4) * sizeof(float) +
         static_cast<size_t>(kBQ) * kBK * sizeof(float) +
         static_cast<size_t>(3) * kBQ * sizeof(float) +
         static_cast<size_t>(2) * kBK * (C + 16 / itemsize) * itemsize;
}

// Rows [k0, k0 + kn) of one sample's y into dst (row stride ks elements)
// with cp.async, 16 bytes a copy; a row is whole 16-byte chunks.
template <typename T>
__device__ void load_k_tile(T* dst, const T* yb, int k0, int kn, int C,
                            int ks) {
  constexpr int kVec = 16 / sizeof(T);
  const int chunks = C / kVec;
  for (int i = threadIdx.x; i < kn * chunks; i += blockDim.x) {
    const int r = i / chunks, c = (i - r * chunks) * kVec;
    cp_async16(dst + r * ks + c, yb + static_cast<size_t>(k0 + r) * C + c);
  }
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float s) {
  return fmaf(a.x, b.x, fmaf(a.y, b.y, fmaf(a.z, b.z, fmaf(a.w, b.w, s))));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    attention_kernel(const T* __restrict__ x, const T* __restrict__ y,
                     float* __restrict__ out, int Lq, int Lk, int C, int nq,
                     float scale) {
  extern __shared__ __align__(16) float smem[];
  const int qs = C + 4;                                   // floats a row
  const int ks = C + 16 / static_cast<int>(sizeof(T));    // elements a row
  float* Qs = smem;
  float* S = Qs + kBQ * qs;
  float* m_s = S + kBQ * kBK;
  float* l_s = m_s + kBQ;
  float* c_s = l_s + kBQ;
  T* kbuf = reinterpret_cast<T*>(c_s + kBQ);

  const int b = blockIdx.x / nq;
  const int q0 = (blockIdx.x - b * nq) * kBQ;
  const int rows = min(kBQ, Lq - q0);
  const T* xb = x + (static_cast<size_t>(b) * Lq + q0) * C;
  const T* yb = y + static_cast<size_t>(b) * Lk * C;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int lane = tid & 31, warp = tid >> 5;
  const int ntiles = (Lk + kBK - 1) / kBK;

  // key tile 0 in flight while the query tile is staged
  load_k_tile(kbuf, yb, 0, min(kBK, Lk), C, ks);
  cp_async_commit();
  const int c4 = C / 4;
  for (int i = tid; i < kBQ * c4; i += kThreads) {
    const int r = i / c4, c = 4 * (i - r * c4);
    store4(Qs + r * qs + c,
           r < rows ? load4(xb + static_cast<size_t>(r) * C + c)
                    : make_float4(0.f, 0.f, 0.f, 0.f));
  }
  if (tid < kBQ) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }

  float4 acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[i][k] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * kBK, kn = min(kBK, Lk - k0);
    if (t + 1 < ntiles)
      load_k_tile(kbuf + ((t + 1) & 1) * kBK * ks, yb, k0 + kBK,
                  min(kBK, Lk - k0 - kBK), C, ks);
    cp_async_commit();    // possibly empty: keeps one group per tile
    cp_async_wait_one();  // tile t has landed (this thread's copies)
    __syncthreads();      // ... and every other thread's; Q, m, l are set
    const T* K = kbuf + (t & 1) * kBK * ks;

    // scores: thread (ty, tx) takes query rows ty + 16 i, keys tx + 16 j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int c = 0; c < C; c += 4) {
      float4 q[4], k[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) q[i] = load4(Qs + (ty + 16 * i) * qs + c);
#pragma unroll
      for (int j = 0; j < 4; ++j) k[j] = load4(K + (tx + 16 * j) * ks + c);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dot4(q[i], k[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = tx + 16 * j;  // keys past Lk read stale rows
        S[(ty + 16 * i) * kBK + key] = key < kn ? s[i][j] * scale : kNegInf;
      }
    __syncthreads();

    // online softmax: warp w updates query rows 8 w .. 8 w + 7
    for (int r = warp * 8; r < warp * 8 + 8; ++r) {
      float* row = S + r * kBK;
      const float a = row[lane], bb = row[lane + 32];
      float mx = fmaxf(a, bb);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      const float pa = lane < kn ? expf(a - m_new) : 0.f;
      const float pb = lane + 32 < kn ? expf(bb - m_new) : 0.f;
      row[lane] = pa;
      row[lane + 32] = pb;
      float sum = pa + pb;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {  // every lane has read m_old: the shuffles wait
        const float corr = expf(m_old - m_new);
        c_s[r] = corr;
        l_s[r] = fmaf(l_s[r], corr, sum);
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * corr + P K over the tile's valid keys
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float corr = c_s[ty + 16 * i];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        acc[i][k].x *= corr;
        acc[i][k].y *= corr;
        acc[i][k].z *= corr;
        acc[i][k].w *= corr;
      }
    }
    for (int j = 0; j < kn; ++j) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = S[(ty + 16 * i) * kBK + j];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int c = 4 * (tx + 16 * k);
        if (c < C) {
          const float4 v = load4(K + j * ks + c);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[i][k].x = fmaf(p[i], v.x, acc[i][k].x);
            acc[i][k].y = fmaf(p[i], v.y, acc[i][k].y);
            acc[i][k].z = fmaf(p[i], v.z, acc[i][k].z);
            acc[i][k].w = fmaf(p[i], v.w, acc[i][k].w);
          }
        }
      }
    }
    __syncthreads();  // tile t's buffer is refilled at t + 2; S rewritten
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r < rows) {
      const float inv = 1.f / l_s[r];
      float* o = out + (static_cast<size_t>(b) * Lq + q0 + r) * C;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int c = 4 * (tx + 16 * k);
        if (c < C)
          store4(o + c, make_float4(acc[i][k].x * inv, acc[i][k].y * inv,
                                    acc[i][k].z * inv, acc[i][k].w * inv));
      }
    }
  }
}

template <typename T>
int launch(const void* x, const void* y, float* out, int B, int Lq, int Lk,
           int C, cudaStream_t stream) {
  const size_t smem = attention_smem(C, sizeof(T));
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  const int nq = (Lq + kBQ - 1) / kBQ;
  if (static_cast<long long>(B) * nq > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(
      attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = B * nq;
  const float scale = 1.f / sqrtf(static_cast<float>(C));
  const T* xt = static_cast<const T*>(x);
  const T* yt = static_cast<const T*>(y);
  attention_kernel<T><<<blocks, kThreads, smem, stream>>>(
      xt, yt, out, Lq, Lk, C, nq, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block needs.
size_t attention_smem_bytes(int C, int itemsize) {
  return attention_smem(C, itemsize);
}

const char* attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// dtype: 0 = fp32, 1 = bf16 (x and y); out is fp32 (B, Lq, C). Returns the
// CUDA error code of the launch (0 on success).
int attention_forward(int dtype, const void* x, const void* y, void* out,
                      int B, int Lq, int Lk, int C, void* stream) {
  if (B < 1 || Lq < 1 || Lk < 1 || C % 8 != 0 || C < 8 || C > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, y, o, B, Lq, Lk, C, st);
  if (dtype == 1) return launch<__nv_bfloat16>(x, y, o, B, Lq, Lk, C, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
