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
// The device functions (loads, cp.async, LayerNorm, attention, the streamed
// GEMM) live in cell_common.cuh, shared with node_mixed.cu.
//
// Requirements: C % 8 == 0 and C <= 256 (blockDim.x = 2 * round32(C) <=
// 512), checked here; 16-byte aligned tensors, checked by the wrapper.
#include "cell_common.cuh"

namespace {

constexpr int kMaxSteps = 4;
constexpr int kMaxSources = kMaxSteps + 2;

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
