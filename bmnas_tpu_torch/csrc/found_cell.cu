// Eval-mode found fusion cell (FoundNodeCell) as one CUDA kernel for Hopper.
//
// Replaces bmnas_tpu/ops/kernels/node_mixed.py::found_node_cell_multi_fused
// (the Pallas TPU kernel). Per sample it computes:
//   (a) S chained inner steps. Step s reads two states picked by static
//       skip/none edges (a 'none' edge reads zeros) and runs one branch:
//         0 Sum        x + y
//         1 Attention  softmax(x y^T / sqrt(C)) y, then per-sample LayerNorm
//                      over (L, C) with a per-position affine
//         2 GLU        [x|y] W + b (BN folded), a * sigmoid(g)
//         3 ConcatFC   relu([x|y] W + b) (BN folded)
//   (b) m != 1: relu(concat(last m states) W_oc + b_oc) (BN folded);
//   (c) + x (the cell's first input), then per-sample LayerNorm.
//
// What bounds it on an H100: at the serving batch (B = 8, L = 16, C = 192)
// it moves about 0.3 MB of activations (x, y, out) and, per GLU step,
// 0.6 MB of fp32 weights: about 0.3 us at 3.35 TB/s. Its 38 MFLOP per GLU
// step take 0.6 us at the fp32 rate. Both are far below one launch, so the
// time is memory latency and launch overhead, not bandwidth or arithmetic.
//
// What the design does about it:
//   * one block per sample: every intermediate state stays in shared memory
//     in fp32, and nothing but x, y, the weights and the output touch device
//     memory. The grid is exactly B blocks, so a ragged batch needs no pad
//     copy and no mask.
//   * latency, not bandwidth, is the cost, so no thread waits on one load
//     at a time: activations and LayerNorm affines move four elements a
//     load, and the weights, which do not fit in shared memory (the GLU
//     weight is 576 KiB in fp32 at C = 192), stream through it in K-tiles
//     that the whole block copies with cp.async, the next tile in flight
//     while the current one is used. Every block reads the same weights,
//     so after the first block they come from L2.
//   * GEMM: thread (h, n) owns output column n (and the gate column n + C)
//     for row half h, so 2 C threads share one sample; the activation tile
//     is staged transposed in shared memory and read as float4 broadcasts.
//     Plain fp32 FMA; wgmma/TMA are later work. One sample's GEMMs on one
//     SM put a floor of about 10 us under a GLU step at C = 192.
//   * the TPU kernel's block-diagonal (R x R) score matrix and its
//     block-averaging LayerNorm matmul were matrix-unit workarounds; here
//     each sample's L x L scores are computed directly (one warp per score),
//     the softmax is a per-row loop, and LayerNorm statistics are block
//     reductions with the variance taken as E[(x - mean)^2].
//   * storage is fp32 or bf16 (template), accumulation always fp32.
//
// Requirements: C % 8 == 0 and C <= 256 (blockDim.x = 2 * round32(C) <=
// 512), checked here; 16-byte aligned tensors, checked by the wrapper.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kMaxSteps = 4;
constexpr int kMaxSources = kMaxSteps + 2;
constexpr int kRowTile = 16;  // rows of one GEMM tile (L = 16 in one tile)
constexpr int kHalfRows = kRowTile / 2;
constexpr int kSmemLimit = 232448;  // bytes of shared memory a block may use

struct CellCfg {
  int S, m, kt;  // kt: rows of one weight K-tile
  int branch[kMaxSteps];
  int src_x[kMaxSteps];  // state index, -1 for a 'none' edge
  int src_y[kMaxSteps];
};

template <typename T>
struct CellParams {
  const T *ln1_s, *ln1_b;  // (S, L, C)
  const T *glu_w, *glu_b;  // (S, 2C, 2C), (S, 2C)
  const T *cfc_w, *cfc_b;  // (S, 2C, C), (S, C)
  const T *oc_w, *oc_b;    // (m C, C), (C); unused when m == 1
  const T *ln2_s, *ln2_b;  // (L, C)
};

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
        dst[(r0 + row) * C + n] =
            kGlu ? v / (1.f + expf(-(gate[r] + bg))) : fmaxf(v, 0.f);
      }
    }
  }
}

// dst = GEMM over the concatenated sources, all row tiles.
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

// Floats of the fp32 part of shared memory.
__host__ __device__ size_t smem_floats(int L, int C, int S, int m) {
  const int lc = round4(L * C);
  const int kmax = (m > 2 ? m : 2) * C;
  // zeros + (2 + S) states + output buffer + staging + scores + reduction
  return static_cast<size_t>(lc) * (S + 4) +
         static_cast<size_t>(kmax) * kRowTile + round4(L * L) + 32;
}

// Bytes of shared memory with weight K-tiles of kt rows: the weight double
// buffer (widest row: 2C with a GLU step, else C) after the fp32 part.
size_t smem_bytes(int L, int C, int S, int m, bool glu, int itemsize,
                  int kt) {
  const size_t ldw = glu ? 2 * C : C;
  return smem_floats(L, C, S, m) * sizeof(float) + 2 * kt * ldw * itemsize;
}

// One block per sample. A serving batch is less than one wave (B <= 132
// SMs), so a block may take an SM's registers (128 a thread at 512
// threads) rather than spill to fit two blocks.
template <typename T>
__global__ void __launch_bounds__(512, 1)
    found_cell_kernel(const T* __restrict__ x, const T* __restrict__ y,
                      T* __restrict__ out, CellParams<T> p, CellCfg cfg, int L,
                      int C, float eps) {
  extern __shared__ __align__(16) float smem[];
  const int LC = L * C, lc = round4(LC), S = cfg.S;
  float* zero = smem;
  float* states = zero + lc;  // state k at states + k * lc
  float* obuf = states + (2 + S) * lc;
  float* stage = obuf + lc;
  float* scores = stage + (cfg.m > 2 ? cfg.m : 2) * C * kRowTile;
  float* red = scores + round4(L * L);
  T* wbuf = reinterpret_cast<T*>(red + 32);

  const size_t base = static_cast<size_t>(blockIdx.x) * LC;
  for (int i = 4 * threadIdx.x; i < LC; i += 4 * blockDim.x) {
    store4(zero + i, make_float4(0.f, 0.f, 0.f, 0.f));
    store4(states + i, load4(x + base + i));
    store4(states + lc + i, load4(y + base + i));
  }
  __syncthreads();

  const float* srcs[kMaxSources];
  for (int s = 0; s < S; ++s) {
    srcs[0] = cfg.src_x[s] < 0 ? zero : states + cfg.src_x[s] * lc;
    srcs[1] = cfg.src_y[s] < 0 ? zero : states + cfg.src_y[s] * lc;
    float* dst = states + (2 + s) * lc;
    switch (cfg.branch[s]) {
      case 0:
        for (int i = 4 * threadIdx.x; i < LC; i += 4 * blockDim.x) {
          const float4 a = load4(srcs[0] + i), b = load4(srcs[1] + i);
          store4(dst + i, make_float4(a.x + b.x, a.y + b.y, a.z + b.z,
                                      a.w + b.w));
        }
        break;
      case 1:
        attention(srcs[0], srcs[1], dst, scores, L, C);
        layer_norm(dst, LC, p.ln1_s + s * LC, p.ln1_b + s * LC, eps, red, dst);
        break;
      case 2:
        dense_step<T, true>(stage, srcs, 2,
                            p.glu_w + static_cast<size_t>(s) * 4 * C * C,
                            p.glu_b + s * 2 * C, L, C, dst, wbuf, cfg.kt);
        break;
      default:
        dense_step<T, false>(stage, srcs, 2,
                             p.cfc_w + static_cast<size_t>(s) * 2 * C * C,
                             p.cfc_b + s * C, L, C, dst, wbuf, cfg.kt);
        break;
    }
    __syncthreads();
  }

  const float* o = states + (1 + S) * lc;
  if (cfg.m != 1) {
    for (int k = 0; k < cfg.m; ++k) srcs[k] = states + (2 + S - cfg.m + k) * lc;
    dense_step<T, false>(stage, srcs, cfg.m, p.oc_w, p.oc_b, L, C, obuf, wbuf,
                         cfg.kt);
    o = obuf;
  }
  for (int i = 4 * threadIdx.x; i < LC; i += 4 * blockDim.x) {
    const float4 a = load4(o + i), b = load4(states + i);
    store4(obuf + i, make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w));
  }
  __syncthreads();
  layer_norm(obuf, LC, p.ln2_s, p.ln2_b, eps, red, out + base);
}

template <typename T>
int launch(const void* x, const void* y, void* out, int B, int L, int C,
           CellCfg cfg, bool glu, const void* const* params, float eps,
           cudaStream_t stream) {
  CellParams<T> p;
  const T* const* t = reinterpret_cast<const T* const*>(params);
  p.ln1_s = t[0];
  p.ln1_b = t[1];
  p.glu_w = t[2];
  p.glu_b = t[3];
  p.cfc_w = t[4];
  p.cfc_b = t[5];
  p.oc_w = t[6];
  p.oc_b = t[7];
  p.ln2_s = t[8];
  p.ln2_b = t[9];
  // the deepest weight K-tile that fits
  cfg.kt = 32;
  while (cfg.kt > 8 &&
         smem_bytes(L, C, cfg.S, cfg.m, glu, sizeof(T), cfg.kt) > kSmemLimit)
    cfg.kt >>= 1;
  const size_t smem = smem_bytes(L, C, cfg.S, cfg.m, glu, sizeof(T), cfg.kt);
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(
      found_cell_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = 2 * ((C + 31) / 32 * 32);  // two row halves a column
  found_cell_kernel<T><<<B, threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(y), static_cast<T*>(out),
      p, cfg, L, C, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block needs at the shallowest weight
// K-tile (8 rows); a launch takes the deepest tile that fits.
size_t found_cell_smem_bytes(int L, int C, int S, int m, int glu,
                             int itemsize) {
  return smem_bytes(L, C, S, m, glu != 0, itemsize, 8);
}

const char* found_cell_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// dtype: 0 = fp32, 1 = bf16 (x, y, out and every parameter). params holds
// ten device pointers in CellParams order (oc_w, oc_b may be null when
// m == 1). branch/src_x/src_y are host arrays of S entries. Returns the
// CUDA error code of the launch (0 on success).
int found_cell_forward(int dtype, const void* x, const void* y, void* out,
                       int B, int L, int C, int S, int m, const int* branch,
                       const int* src_x, const int* src_y,
                       const void* const* params, float eps, void* stream) {
  if (S < 1 || S > kMaxSteps || m < 1 || m > S + 2 || C % 8 != 0 ||
      C > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  CellCfg cfg;
  cfg.S = S;
  cfg.m = m;
  cfg.kt = 0;
  bool glu = false;
  for (int s = 0; s < kMaxSteps; ++s) {
    cfg.branch[s] = s < S ? branch[s] : 0;
    cfg.src_x[s] = s < S ? src_x[s] : -1;
    cfg.src_y[s] = s < S ? src_y[s] : -1;
    glu = glu || (s < S && branch[s] == 2);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, y, out, B, L, C, cfg, glu, params, eps, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, y, out, B, L, C, cfg, glu, params, eps,
                                 st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
