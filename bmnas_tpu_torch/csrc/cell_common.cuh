// Device functions shared by the fusion-cell kernels: found_cell.cu (one
// block per sample, every intermediate state in shared memory in fp32)
// uses all of them; node_mixed.cu and attention.cu the loads and stores
// and the cp.async copies.
//
//   * four-element loads and stores of fp32 or bf16 storage;
//   * cp.async copies (weights stream through shared memory in K-tiles);
//   * block reductions and the per-sample LayerNorm over (L, C) with a
//     per-position affine, variance taken as E[(x - mean)^2];
//   * softmax(X Y^T / sqrt(C)) Y for one sample, one warp per score;
//   * the streamed GEMM h = [A_0 | A_1 | ...] W + b over all row tiles,
//     with a GLU or ReLU epilogue that writes its result or adds a scaled
//     copy of it to the destination.
//
// blockDim.x = 2 * round32(C): thread (h, n) owns output column n (and the
// gate column n + C) for row half h of a GEMM row tile.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kRowTile = 16;  // rows of one GEMM tile (L = 16 in one tile)
constexpr int kHalfRows = kRowTile / 2;
constexpr int kSmemLimit = 232448;  // bytes of shared memory a block may use

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Four consecutive elements (16-byte aligned for fp32, 8 for bf16).
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<unsigned*>(&lo);
  u.y = *reinterpret_cast<unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// Wait until at most one committed group is still in flight.
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__host__ __device__ __forceinline__ int round4(int n) { return (n + 3) & ~3; }

// Sum of v over the block, returned to every thread. blockDim.x is a
// multiple of 32; every thread of the block must call it.
__device__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();  // the previous call's readers are done with red
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = 0.f;
  for (int w = 0; w < nwarps; ++w) t += red[w];
  return t;
}

// Per-sample LayerNorm of v (n values, n % 4 == 0) with a per-position
// affine, written to dst (which may be v itself, or the output in device
// memory).
template <typename P, typename D>
__device__ void layer_norm(const float* v, int n, const P* scale,
                           const P* bias, float eps, float* red, D* dst) {
  float s = 0.f;
  for (int i = 4 * threadIdx.x; i < n; i += 4 * blockDim.x) {
    const float4 a = load4(v + i);
    s += (a.x + a.y) + (a.z + a.w);
  }
  const float mean = block_sum(s, red) / n;
  float q = 0.f;
  for (int i = 4 * threadIdx.x; i < n; i += 4 * blockDim.x) {
    const float4 a = load4(v + i);
    const float dx = a.x - mean, dy = a.y - mean, dz = a.z - mean,
                dw = a.w - mean;
    q += (dx * dx + dy * dy) + (dz * dz + dw * dw);
  }
  const float rstd = rsqrtf(block_sum(q, red) / n + eps);
  for (int i = 4 * threadIdx.x; i < n; i += 4 * blockDim.x) {
    const float4 a = load4(v + i), g = load4(scale + i), b = load4(bias + i);
    store4(dst + i, make_float4((a.x - mean) * rstd * g.x + b.x,
                                (a.y - mean) * rstd * g.y + b.y,
                                (a.z - mean) * rstd * g.z + b.z,
                                (a.w - mean) * rstd * g.w + b.w));
  }
}

// softmax(X Y^T / sqrt(C)) Y for one sample into dst (L x C).
__device__ void attention(const float* X, const float* Y, float* dst,
                          float* scores, int L, int C) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const float inv_sqrt_c = 1.f / sqrtf(static_cast<float>(C));
  for (int p = warp; p < L * L; p += nwarps) {
    const int i = p / L, j = p - i * L;
    float s = 0.f;
    for (int c = lane; c < C; c += 32) s = fmaf(X[i * C + c], Y[j * C + c], s);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) scores[p] = s * inv_sqrt_c;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < L; i += blockDim.x) {
    float* row = scores + i * L;
    float mx = row[0];
    for (int j = 1; j < L; ++j) mx = fmaxf(mx, row[j]);
    float sum = 0.f;
    for (int j = 0; j < L; ++j) {
      row[j] = expf(row[j] - mx);
      sum += row[j];
    }
    const float inv = 1.f / sum;
    for (int j = 0; j < L; ++j) row[j] *= inv;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < L * C; idx += blockDim.x) {
    const int i = idx / C, c = idx - i * C;
    float a = 0.f;
    for (int j = 0; j < L; ++j) a = fmaf(scores[i * L + j], Y[j * C + c], a);
    dst[idx] = a;
  }
  __syncthreads();
}

// stage[k * kRowTile + r] = concat(srcs)[r0 + r][k], zero past the last row.
__device__ void stage_rows(float* stage, const float* const* srcs, int nsrc,
                           int C, int r0, int rows) {
  const int K = nsrc * C;
  for (int idx = threadIdx.x; idx < K * kRowTile; idx += blockDim.x) {
    const int r = idx / K, k = idx - r * K;
    const int s = k / C, c = k - s * C;
    stage[k * kRowTile + r] = r < rows ? srcs[s][(r0 + r) * C + c] : 0.f;
  }
}

// Rows [k0, k0 + kn) of W (ldw elements a row, contiguous) into wtile with
// cp.async, 16 bytes a copy; kn * ldw is a multiple of 16 bytes.
template <typename T>
__device__ void load_w_tile(T* wtile, const T* W, int k0, int kn, int ldw) {
  constexpr int kVec = 16 / sizeof(T);
  const T* src = W + static_cast<size_t>(k0) * ldw;
  const int chunks = kn * ldw / kVec;
  for (int i = threadIdx.x; i < chunks; i += blockDim.x)
    cp_async16(wtile + i * kVec, src + static_cast<size_t>(i) * kVec);
}

// One row tile of h = A W + b, A staged transposed (K x kRowTile), W
// streamed through wbuf (two K-tiles of kt rows).
//   GLU: W is (K, 2C); v[r][n] = h[r][n] * sigmoid(h[r][n + C]).
//   FC:  W is (K, C);  v[r][n] = relu(h[r][n]).
// kAcc: dst[r][n] += gamma * v[r][n]; otherwise dst[r][n] = v[r][n].
// Thread (h, n), h = threadIdx.x / (blockDim.x / 2), owns column n for
// rows [h * kHalfRows, (h + 1) * kHalfRows) of the tile.
template <typename T, bool kGlu, bool kAcc = false>
__device__ void gemm_rows(const float* stage, int K, const T* __restrict__ W,
                          const T* __restrict__ bias, int C, float* dst,
                          int r0, int rows, T* wbuf, int kt,
                          float gamma = 1.f) {
  const int ldw = kGlu ? 2 * C : C;
  const int half = blockDim.x >> 1;
  const int h = threadIdx.x >= half ? 1 : 0;
  const int n = threadIdx.x - h * half;
  const int ntiles = (K + kt - 1) / kt;
  float acc[kHalfRows], gate[kHalfRows];
#pragma unroll
  for (int r = 0; r < kHalfRows; ++r) acc[r] = gate[r] = 0.f;

  load_w_tile(wbuf, W, 0, min(kt, K), ldw);
  cp_async_commit();
  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * kt, kn = min(kt, K - k0);
    if (t + 1 < ntiles)
      load_w_tile(wbuf + ((t + 1) & 1) * kt * ldw, W, k0 + kt,
                  min(kt, K - k0 - kt), ldw);
    cp_async_commit();  // possibly empty: keeps one group per tile
    cp_async_wait_one();  // tile t has landed (this thread's copies)
    __syncthreads();      // ... and every other thread's
    if (n < C) {
      const T* w = wbuf + (t & 1) * kt * ldw + n;
      const float* a = stage + k0 * kRowTile + h * kHalfRows;
#pragma unroll 4
      for (int k = 0; k < kn; ++k) {
        const float wa = to_f(w[k * ldw]);
        const float wg = kGlu ? to_f(w[k * ldw + C]) : 0.f;
        const float4* a4 = reinterpret_cast<const float4*>(a + k * kRowTile);
#pragma unroll
        for (int q = 0; q < kHalfRows / 4; ++q) {
          const float4 v = a4[q];
          acc[4 * q + 0] = fmaf(v.x, wa, acc[4 * q + 0]);
          acc[4 * q + 1] = fmaf(v.y, wa, acc[4 * q + 1]);
          acc[4 * q + 2] = fmaf(v.z, wa, acc[4 * q + 2]);
          acc[4 * q + 3] = fmaf(v.w, wa, acc[4 * q + 3]);
          if (kGlu) {
            gate[4 * q + 0] = fmaf(v.x, wg, gate[4 * q + 0]);
            gate[4 * q + 1] = fmaf(v.y, wg, gate[4 * q + 1]);
            gate[4 * q + 2] = fmaf(v.z, wg, gate[4 * q + 2]);
            gate[4 * q + 3] = fmaf(v.w, wg, gate[4 * q + 3]);
          }
        }
      }
    }
    __syncthreads();  // tile t's buffer is refilled at t + 2
  }
  if (n < C) {
    const float ba = to_f(bias[n]);
    const float bg = kGlu ? to_f(bias[n + C]) : 0.f;
#pragma unroll
    for (int r = 0; r < kHalfRows; ++r) {
      const int row = h * kHalfRows + r;
      if (row < rows) {
        const float v = acc[r] + ba;
        const float o = kGlu ? v / (1.f + expf(-(gate[r] + bg)))
                             : fmaxf(v, 0.f);
        float& d = dst[(r0 + row) * C + n];
        d = kAcc ? fmaf(gamma, o, d) : o;
      }
    }
  }
}

// dst = GEMM over the concatenated sources, all row tiles (kAcc: dst +=
// gamma * GEMM).
template <typename T, bool kGlu, bool kAcc = false>
__device__ void dense_step(float* stage, const float* const* srcs, int nsrc,
                           const T* W, const T* bias, int L, int C,
                           float* dst, T* wbuf, int kt, float gamma = 1.f) {
  for (int r0 = 0; r0 < L; r0 += kRowTile) {
    const int rows = min(kRowTile, L - r0);
    stage_rows(stage, srcs, nsrc, C, r0, rows);
    __syncthreads();
    gemm_rows<T, kGlu, kAcc>(stage, nsrc * C, W, bias, C, dst, r0, rows,
                             wbuf, kt, gamma);
    __syncthreads();
  }
}

}  // namespace
