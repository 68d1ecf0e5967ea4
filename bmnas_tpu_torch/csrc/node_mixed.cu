// Eval-mode supernet mixed op (NodeMixedOp) as one CUDA kernel for Hopper.
//
// Replaces bmnas_tpu/ops/kernels/node_mixed.py::node_mixed_op_fused (the
// Pallas TPU kernel). Per sample it computes the gamma-weighted sum of all
// four inner fusion ops, with BatchNorm folded into the dense weights:
//   out = g0 (x + y)
//       + g1 LN(softmax(x y^T / sqrt(C)) y)        per-sample LayerNorm over
//                                                  (L, C), per-position affine
//       + g2 GLU([x|y] Wg + bg)                    a * sigmoid(g)
//       + g3 relu([x|y] Wc + bc)
// The four weights g are read from device memory (a softmaxed row of the
// supernet's gammas), once per block: no host sync.
//
// What bounds it on an H100: at the search batch (B = 8, L = 16, C = 192,
// fp32) the call does about 58 MFLOP (the GLU and ConcatFC GEMMs are 96% of
// it), 0.87 us at the 67 TFLOP/s fp32 rate, and moves about 1.2 MB (x, y,
// out and 864 KiB of weights), 0.36 us at 3.35 TB/s: bound by operations.
// At B = 96 the operations take about 10.4 us.
//
// What the design does about it:
//   * one block per sample, as found_cell.cu: x, y, the attention branch and
//     the running sum stay in shared memory in fp32, and only x, y, the
//     weights and the output touch device memory. The grid is exactly B
//     blocks, so a ragged batch needs no pad copy and no mask.
//   * the four branches add into one fp32 accumulator in shared memory: the
//     sum branch initialises it, attention adds its LayerNorm'd output, and
//     the GLU and ConcatFC GEMM epilogues add gamma * value in place.
//   * the GLU and ConcatFC weights (864 KiB in fp32 at C = 192) do not fit
//     in shared memory: they stream through it in cp.async K-tiles, the next
//     tile in flight while the current one is used (cell_common.cuh). Every
//     block reads the same weights, so after the first block they come
//     from L2.
//   * x and y may be the same tensor (the supernet passes one tensor as
//     both inputs): both are read, neither is written, and the output never
//     aliases them.
//   * the TPU kernel's block-diagonal score matrix and averaging-matmul
//     LayerNorm were matrix-unit workarounds; here scores are per sample,
//     one warp per score, and LayerNorm statistics are block reductions.
//   * storage is fp32 or bf16 (template), accumulation always fp32. Plain
//     fp32 FMA: one sample's GEMMs (7.1 MFLOP at L = 16, C = 192) on one
//     SM (a 132nd of 67 TFLOP/s) take at least 14 us, far above the bound.
//     wgmma and a cluster per sample are later work.
//
// Requirements: C % 8 == 0 and C <= 256 (blockDim.x = 2 * round32(C) <=
// 512), checked here; 16-byte aligned x, y, out and weights, checked by
// the wrapper.
#include "cell_common.cuh"

namespace {

template <typename T>
struct MixedParams {
  const T *ln_s, *ln_b;    // (L, C)
  const T *glu_w, *glu_b;  // (2C, 2C), (2C)
  const T *cfc_w, *cfc_b;  // (2C, C), (C)
};

// Floats of the fp32 part of shared memory: x, y, the attention branch and
// the accumulator, then staging, scores and the reduction slots.
__host__ __device__ size_t mixed_smem_floats(int L, int C) {
  const int lc = round4(L * C);
  return static_cast<size_t>(lc) * 4 +
         static_cast<size_t>(2 * C) * kRowTile + round4(L * L) + 32;
}

// Bytes of shared memory with weight K-tiles of kt rows (the double buffer
// holds GLU rows of 2C elements).
size_t mixed_smem_bytes(int L, int C, int itemsize, int kt) {
  return mixed_smem_floats(L, C) * sizeof(float) +
         static_cast<size_t>(2) * kt * 2 * C * itemsize;
}

template <typename T>
__global__ void __launch_bounds__(512, 1)
    node_mixed_kernel(const T* x, const T* y,
                      const float* __restrict__ gammas, T* __restrict__ out,
                      MixedParams<T> p, int L, int C, int kt, float eps) {
  extern __shared__ __align__(16) float smem[];
  const int LC = L * C, lc = round4(LC);
  float* xs = smem;
  float* ys = xs + lc;
  float* abuf = ys + lc;  // the attention branch
  float* acc = abuf + lc;  // the weighted sum of the four branches
  float* stage = acc + lc;
  float* scores = stage + 2 * C * kRowTile;
  float* red = scores + round4(L * L);
  T* wbuf = reinterpret_cast<T*>(red + 32);

  const float g0 = gammas[0], g1 = gammas[1], g2 = gammas[2], g3 = gammas[3];
  const size_t base = static_cast<size_t>(blockIdx.x) * LC;
  for (int i = 4 * threadIdx.x; i < LC; i += 4 * blockDim.x) {
    const float4 a = load4(x + base + i), b = load4(y + base + i);
    store4(xs + i, a);
    store4(ys + i, b);
    store4(acc + i, make_float4(g0 * (a.x + b.x), g0 * (a.y + b.y),
                                g0 * (a.z + b.z), g0 * (a.w + b.w)));
  }
  __syncthreads();

  attention(xs, ys, abuf, scores, L, C);
  layer_norm(abuf, LC, p.ln_s, p.ln_b, eps, red, abuf);
  __syncthreads();
  for (int i = 4 * threadIdx.x; i < LC; i += 4 * blockDim.x) {
    const float4 a = load4(abuf + i), s = load4(acc + i);
    store4(acc + i, make_float4(fmaf(g1, a.x, s.x), fmaf(g1, a.y, s.y),
                                fmaf(g1, a.z, s.z), fmaf(g1, a.w, s.w)));
  }
  __syncthreads();

  const float* srcs[2] = {xs, ys};
  dense_step<T, true, true>(stage, srcs, 2, p.glu_w, p.glu_b, L, C, acc, wbuf,
                            kt, g2);
  dense_step<T, false, true>(stage, srcs, 2, p.cfc_w, p.cfc_b, L, C, acc,
                             wbuf, kt, g3);

  for (int i = 4 * threadIdx.x; i < LC; i += 4 * blockDim.x)
    store4(out + base + i, load4(acc + i));
}

template <typename T>
int launch(const void* x, const void* y, const float* gammas, void* out,
           int B, int L, int C, const void* const* params, float eps,
           cudaStream_t stream) {
  MixedParams<T> p;
  const T* const* t = reinterpret_cast<const T* const*>(params);
  p.ln_s = t[0];
  p.ln_b = t[1];
  p.glu_w = t[2];
  p.glu_b = t[3];
  p.cfc_w = t[4];
  p.cfc_b = t[5];
  // the deepest weight K-tile that fits
  int kt = 32;
  while (kt > 8 && mixed_smem_bytes(L, C, sizeof(T), kt) > kSmemLimit)
    kt >>= 1;
  const size_t smem = mixed_smem_bytes(L, C, sizeof(T), kt);
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(
      node_mixed_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = 2 * ((C + 31) / 32 * 32);  // two row halves a column
  node_mixed_kernel<T><<<B, threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(y), gammas,
      static_cast<T*>(out), p, L, C, kt, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block needs at the shallowest weight
// K-tile (8 rows); a launch takes the deepest tile that fits.
size_t node_mixed_smem_bytes(int L, int C, int itemsize) {
  return mixed_smem_bytes(L, C, itemsize, 8);
}

const char* node_mixed_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// dtype: 0 = fp32, 1 = bf16 (x, y, out and every parameter); gammas is a
// device pointer to four fp32 weights. params holds six device pointers in
// MixedParams order. x and y may be equal. Returns the CUDA error code of
// the launch (0 on success).
int node_mixed_forward(int dtype, const void* x, const void* y,
                       const void* gammas, void* out, int B, int L, int C,
                       const void* const* params, float eps, void* stream) {
  if (B < 1 || L < 1 || C % 8 != 0 || C < 8 || C > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* g = static_cast<const float*>(gammas);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, y, g, out, B, L, C, params, eps, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, y, g, out, B, L, C, params, eps, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
