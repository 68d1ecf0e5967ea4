// Device code of the found cell's one-block-a-sample design (found_cell.cu's
// kWhole phase, the design of the port's first found-cell kernel): a block
// of blockDim.x = 2 * round32(C) threads holds one sample's whole cell in
// shared memory in fp32.
//
//   * block reductions and the per-sample LayerNorm over (L, C) with a
//     per-position affine, variance taken as E[(x - mean)^2];
//   * softmax(X Y^T / sqrt(C)) Y for one sample, a thread a score;
//   * the streamed GEMM h = [A_0 | A_1 | ...] W + b over all row tiles in
//     fp32 FMA, the weights through a double buffer of K-tiles by
//     cp.async, with a GLU or ReLU epilogue. Thread (h, n) owns output
//     column n (and the gate column n + C) for row half h of a row tile.
#pragma once

#include "cell_gemm.cuh"

namespace {

constexpr int kRowTile = 16;  // rows of one GEMM tile (L = 16 in one tile)
constexpr int kHalfRows = kRowTile / 2;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__host__ __device__ __forceinline__ int round4(int n) { return (n + 3) & ~3; }

// Sum of v over the block, returned to every thread. blockDim.x is a
// multiple of 32; every thread of the block must call it.
__device__ float block_sum(float v, float* red) {
  const int nwarps = blockDim.x >> 5;
  v = warp_sum(v);
  __syncthreads();  // the previous call's readers are done with red
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
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

// softmax(X Y^T / sqrt(C)) Y for one sample into dst (L x C; rows of C
// floats, C % 4 == 0). A thread a score: four partial sums, float4 reads,
// score (i, j) walking the columns from column 4j on, so that the threads
// of a warp, on rows C floats apart, read different banks. A warp a row of
// the softmax; a thread four output columns.
__device__ void attention(const float* X, const float* Y, float* dst,
                          float* scores, int L, int C) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5, cq = C / 4;
  const float inv_sqrt_c = 1.f / sqrtf(static_cast<float>(C));
  for (int p = threadIdx.x; p < L * L; p += blockDim.x) {
    const int i = p / L, j = p - i * L;
    const float* xi = X + i * C;
    const float* yj = Y + j * C;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);  // four partial sums
    int c = 4 * (j % cq);
#pragma unroll 4
    for (int q = 0; q < cq; ++q) {
      const float4 a = load4(xi + c), b = load4(yj + c);
      acc.x = fmaf(a.x, b.x, acc.x);
      acc.y = fmaf(a.y, b.y, acc.y);
      acc.z = fmaf(a.z, b.z, acc.z);
      acc.w = fmaf(a.w, b.w, acc.w);
      c = c + 4 == C ? 0 : c + 4;
    }
    scores[p] = ((acc.x + acc.y) + (acc.z + acc.w)) * inv_sqrt_c;
  }
  __syncthreads();
  for (int i = warp; i < L; i += nwarps) {
    float* row = scores + i * L;
    float mx = -3.402823466e38f;
    for (int j = lane; j < L; j += 32) mx = fmaxf(mx, row[j]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < L; j += 32) {
      const float e = expf(row[j] - mx);
      row[j] = e;
      sum += e;
    }
    const float inv = 1.f / warp_sum(sum);
    for (int j = lane; j < L; j += 32) row[j] *= inv;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < L * cq; idx += blockDim.x) {
    const int i = idx / cq, c = 4 * (idx - i * cq);
    const float* pr = scores + i * L;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int j = 0; j < L; ++j) {
      const float w = pr[j];
      const float4 v = load4(Y + j * C + c);
      a.x = fmaf(w, v.x, a.x);
      a.y = fmaf(w, v.y, a.y);
      a.z = fmaf(w, v.z, a.z);
      a.w = fmaf(w, v.w, a.w);
    }
    store4(dst + i * C + c, a);
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
//   GLU: W is (K, 2C); dst[r][n] = h[r][n] * sigmoid(h[r][n + C]).
//   FC:  W is (K, C);  dst[r][n] = relu(h[r][n]).
// Thread (h, n), h = threadIdx.x / (blockDim.x / 2), owns column n for
// rows [h * kHalfRows, (h + 1) * kHalfRows) of the tile.
template <typename T, bool kGlu>
__device__ void gemm_rows(const float* stage, int K, const T* __restrict__ W,
                          const T* __restrict__ bias, int C, float* dst,
                          int r0, int rows, T* wbuf, int kt) {
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
    cp_async_commit();     // possibly empty: keeps one group per tile
    cp_async_wait<1>();    // tile t has landed (this thread's copies)
    __syncthreads();       // ... and every other thread's
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
        dst[(r0 + row) * C + n] =
            kGlu ? v / (1.f + expf(-(gate[r] + bg))) : fmaxf(v, 0.f);
      }
    }
  }
}

// dst = the GEMM over the concatenated sources, all row tiles.
template <typename T, bool kGlu>
__device__ void dense_step(float* stage, const float* const* srcs, int nsrc,
                           const T* W, const T* bias, int L, int C,
                           float* dst, T* wbuf, int kt) {
  for (int r0 = 0; r0 < L; r0 += kRowTile) {
    const int rows = min(kRowTile, L - r0);
    stage_rows(stage, srcs, nsrc, C, r0, rows);
    __syncthreads();
    gemm_rows<T, kGlu>(stage, nsrc * C, W, bias, C, dst, r0, rows, wbuf, kt);
    __syncthreads();
  }
}

// Floats of the fp32 part of a block's shared memory.
__host__ __device__ inline size_t whole_smem_floats(int L, int C, int S,
                                                    int m) {
  const int lc = round4(L * C);
  const int kmax = (m > 2 ? m : 2) * C;
  // zeros + (2 + S) states + output buffer + staging + scores + reduction
  return static_cast<size_t>(lc) * (S + 4) +
         static_cast<size_t>(kmax) * kRowTile + round4(L * L) + 32;
}

// Bytes of a block's shared memory with weight K-tiles of kt rows: the
// weight double buffer (widest row: 2C with a GLU step, else C) after the
// fp32 part.
inline size_t whole_smem_bytes(int L, int C, int S, int m, bool glu,
                               int itemsize, int kt) {
  const size_t ldw = glu ? 2 * C : C;
  return whole_smem_floats(L, C, S, m) * sizeof(float) +
         2 * kt * ldw * itemsize;
}

}  // namespace
