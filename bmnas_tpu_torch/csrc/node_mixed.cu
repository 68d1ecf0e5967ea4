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
// it) and moves about 1.2 MB (x, y, out and 864 KiB of weights). At that
// size what costs is latency: how many SMs share the work, how soon the
// weights arrive, and how long one block's chain of dependent steps is.
//
// The design:
//   * a block owns a group of S whole samples and one tile of nt output
//     columns [n0, n0 + nt). For that tile it needs three sets of weight
//     columns over K = 2C: the GLU values Wg[:, n0:], the GLU gates
//     Wg[:, C + n0:] and ConcatFC Wc[:, n0:], 3 nt columns in all. Whole
//     samples per block keep the attention and the LayerNorm statistics
//     inside the block: no atomics, no second pass, every output element
//     written once. The grid is 1-D: blockIdx.x = group * tiles + tile.
//     A ragged last group is masked, never padded in device memory.
//   * the launcher picks (S, nt) from B: the fewest waves of blocks over
//     the card (blocks per SM from the occupancy calculator) times the work
//     of one block. For each (S, nt) the weight columns either sit whole in
//     shared memory (every K-tile in flight from the start) or stream
//     through a ring of four K-tiles, whichever takes fewer waves (the
//     whole slab on a tie).
//   * 512 threads in two warp groups that run at the same time, each
//     meeting at its own named barrier, and the whole block only before
//     the epilogue. Every block is latency-bound at these sizes, so the
//     attention hides behind the weight stream and the GEMMs.
//   * the attention group stages A = [x | y] of the block's samples (S L
//     rows, zero rows up to a multiple of 16) and the epilogue's
//     LayerNorm affine and biases for the block's columns by cp.async,
//     and hands A over at a barrier the GEMM group waits at; meanwhile the
//     GEMM group issues the weight K-tiles, one cp.async group each. One
//     group barrier a K-tile.
//   * the GEMM group runs both GEMMs on the tensor cores through WMMA
//     (tc_gemm.cuh): fp32 storage as 3xTF32 (fp32 accuracy), bf16 storage
//     as bf16 MMA, fp32 accumulation. A warp's unit of work is two 16-row
//     tiles times three 16-column tiles: it loads (and for 3xTF32 splits)
//     each B fragment once for two row tiles and each A fragment once for
//     three column tiles, six independent accumulators. When the block
//     has fewer units than GEMM warps, the warps split the units' MMA
//     steps and the epilogue adds the partial sums.
//   * the attention group computes each sample's attention whole in every
//     column tile (at C = 192 about 0.1 MFLOP a sample, small beside the
//     GEMM): the scores one thread each with four partial sums, the
//     softmax one warp a row, P V four columns a thread, then the
//     LayerNorm mean and variance (E[(v - mean)^2]) of every sample in two
//     group reductions.
//   * the epilogue (all threads) adds g0 (x + y), g1 LN(attn),
//     g2 a sigmoid(g) and g3 relu(c), with the biases, four columns a
//     thread, and stores the result once in the storage type.
//   * x and y may be the same tensor (the supernet passes one tensor as
//     both inputs): both are read, neither is written, and the output never
//     aliases them.
//
// The geometry and its pick, the weight copier, the GEMM group and the
// attention are in cell_gemm.cuh, shared with found_cell.cu.
//
// Requirements: C % 8 == 0 and C <= 256, at most 256 rows a block (L <=
// 256) and a geometry whose shared memory fits, checked here; 16-byte
// aligned x, y, out and weights, checked by the wrapper.
#include "cell_gemm.cuh"

namespace {

template <typename T>
struct MixedParams {
  const T *ln_s, *ln_b;    // (L, C)
  const T *glu_w, *glu_b;  // (2C, 2C), (2C)
  const T *cfc_w, *cfc_b;  // (2C, C), (C)
};

// Byte offsets of the shared-memory regions; each starts 32-byte aligned
// (WMMA's rule). The weight tiles and, after the GEMM, its results share
// one region.
struct MixedSmem {
  size_t a, prm, attn, scores, stats, ring, total;
};

__host__ __device__ inline MixedSmem mixed_smem(const GemmGeom& g, int L,
                                                int C, int itemsize) {
  MixedSmem m;
  size_t off = 0;
  m.a = off;
  off += align32(static_cast<size_t>(g.rows) * g.lda * itemsize);
  m.prm = off;  // LN scale and bias (L, nt), then the three biases (nt)
  off += align32(static_cast<size_t>(2 * L + 3) * g.nt * itemsize);
  m.attn = off;
  off += align32(static_cast<size_t>(g.S) * L * C * sizeof(float));
  m.scores = off;
  off += align32(static_cast<size_t>(g.S) * L * L * sizeof(float));
  m.stats = off;  // mean and rstd per sample, then the reduction slots
  off += align32((2 + kAttnWarps) * kMaxSamples * sizeof(float));
  m.ring = off;
  off += ring_bytes(g, itemsize);
  m.total = off;
  return m;
}

// The GEMM thread's copier of the block's three weight column sets
// [GLU values | GLU gates | ConcatFC] (cell_gemm.cuh).
template <typename T>
__device__ TileCopier<T> tile_copier(const MixedParams<T>& p,
                                     const GemmGeom& g, int C, int n0) {
  const T* const srcs[kMaxSets] = {p.glu_w, p.glu_w + C, p.cfc_w};
  const int strides[kMaxSets] = {2 * C, 2 * C, C};
  return tile_copier(srcs, strides, 3, g.nt, C, n0, 2 * C);
}

// The epilogue's parameters for the block's columns, by cp.async from the
// attention group (tid its thread's index in it): LN scale
// and bias rows (L, nt), then the GLU value, GLU gate and ConcatFC biases.
template <typename T>
__device__ void load_epilogue_params(T* dst, const MixedParams<T>& p,
                                     int L, int C, int nt, int n0, int tid) {
  constexpr int kVec = 16 / sizeof(T);
  const int seg = nt / kVec;
  for (int idx = tid; idx < (2 * L + 3) * seg; idx += kAttnThreads) {
    const int r = idx / seg, c = (idx - r * seg) * kVec, n = n0 + c;
    T* d = dst + r * nt + c;
    if (n >= C) {
      *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
      continue;
    }
    const T* src = r < L           ? p.ln_s + r * C + n
                   : r < 2 * L     ? p.ln_b + (r - L) * C + n
                   : r == 2 * L    ? p.glu_b + n
                   : r == 2 * L + 1 ? p.glu_b + C + n
                                    : p.cfc_b + n;
    cp_async16(d, src);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    node_mixed_kernel(const T* x, const T* y,
                      const float* __restrict__ gammas, T* __restrict__ out,
                      MixedParams<T> p, GemmGeom g, int B, int L, int C,
                      float eps) {
  extern __shared__ __align__(128) float smem[];
  constexpr int kVec = 16 / sizeof(T);
  const MixedSmem m = mixed_smem(g, L, C, sizeof(T));
  char* base = reinterpret_cast<char*>(smem);
  T* A = reinterpret_cast<T*>(base + m.a);
  T* prm = reinterpret_cast<T*>(base + m.prm);
  float* attn = reinterpret_cast<float*>(base + m.attn);
  float* scores = reinterpret_cast<float*>(base + m.scores);
  float* stats = reinterpret_cast<float*>(base + m.stats);
  float* red = stats + 2 * kMaxSamples;
  T* ring = reinterpret_cast<T*>(base + m.ring);
  float* res = reinterpret_cast<float*>(base + m.ring);  // after the GEMM

  const int bid = blockIdx.x;
  const int group = bid / g.tiles, tile = bid - group * g.tiles;
  const int b0 = group * g.S, ns = min(g.S, B - b0), nrows = ns * L;
  const int n0 = tile * g.nt, K = 2 * C;
  const size_t gbase = static_cast<size_t>(b0) * L * C;
  const bool gemm = threadIdx.x < kGemmThreads;

  const float g0 = gammas[0], g1 = gammas[1], g2 = gammas[2], g3 = gammas[3];
  if (gemm) {
    // the GEMM group's first weight K-tiles, one cp.async group each: all
    // of them when the whole slab fits, else all but one slot of the ring
    const TileCopier<T> wcopy = tile_copier(p, g, C, n0);
    const int first = g.slots >= g.nk ? g.nk : g.slots - 1;
    for (int t = 0; t < first; ++t) {
      load_weight_tile(ring + t * g.kt * g.ldb, wcopy, g.ldb, t * g.kt,
                       min(g.kt, K - t * g.kt));
      cp_async_commit();
    }
    group_sync(kBarA, kThreads);  // A is in (the attention group's arrival)
    gemm_group<T, 3>(A, ring, res, g, wcopy, first, K);
  } else {
    // the attention group stages A = [x | y] of the block's samples (rows
    // past the last one are zeros) and the epilogue's parameters
    const int tid = threadIdx.x - kGemmThreads;
    const int hc = C / kVec;  // 16-byte chunks in half a row
    const int warp = tid >> 5, lane = tid & 31;
    for (int r = warp; r < g.rows; r += kAttnWarps) {  // a warp a row
      for (int q = lane; q < 2 * hc; q += 32) {
        const int h = q >= hc ? 1 : 0, c = (q - h * hc) * kVec;
        T* d = A + r * g.lda + h * C + c;
        if (r < nrows)
          cp_async16(d, (h ? y : x) + gbase + static_cast<size_t>(r) * C + c);
        else
          *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
    load_epilogue_params(prm, p, L, C, g.nt, n0, tid);
    cp_async_commit();
    cp_async_wait<0>();                  // this thread's copies have landed
    group_sync(kBarAttn, kAttnThreads);  // ... and the group's
    group_arrive(kBarA, kThreads);       // the GEMM group may read A
    sample_attention(A, A + C, g.lda, L, C, ns, tid, attn, scores, stats,
                     red, eps);
  }
  __syncthreads();  // the GEMM results and the attention are in

  // out = g0 (x + y) + g1 LN(attn) + g2 GLU + g3 relu(FC), four columns a
  // thread, the block's columns only
  const int nq = g.nt / 4, ldr = 3 * g.nt, LC = L * C;
  const T* ln_s = prm;
  const T* ln_b = prm + L * g.nt;
  const T* bias = prm + 2 * L * g.nt;
  for (int idx = threadIdx.x; idx < nrows * nq; idx += kThreads) {
    const int r = idx / nq, c = 4 * (idx - r * nq), n = n0 + c;
    if (n >= C) continue;
    const int s = r / L, i = r - s * L;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f), gt = v, fc = v;
    for (int sp = 0; sp < g.splits; ++sp) {
      const float* rr = res + (sp * g.rows + r) * ldr + c;
      const float4 a = load4(rr), b = load4(rr + g.nt);
      const float4 d = load4(rr + 2 * g.nt);
      v = make_float4(v.x + a.x, v.y + a.y, v.z + a.z, v.w + a.w);
      gt = make_float4(gt.x + b.x, gt.y + b.y, gt.z + b.z, gt.w + b.w);
      fc = make_float4(fc.x + d.x, fc.y + d.y, fc.z + d.z, fc.w + d.w);
    }
    const float4 xv = load4(A + r * g.lda + n);
    const float4 yv = load4(A + r * g.lda + C + n);
    const float4 av = load4(attn + s * LC + i * C + n);
    const float4 ls = load4(ln_s + i * g.nt + c), lb = load4(ln_b + i * g.nt + c);
    const float4 bv = load4(bias + c), bg = load4(bias + g.nt + c);
    const float4 bc = load4(bias + 2 * g.nt + c);
    const float mean = stats[s], rstd = stats[kMaxSamples + s];
    float o[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float ln = (comp(av, e) - mean) * rstd * comp(ls, e) + comp(lb, e);
      const float glu = (comp(v, e) + comp(bv, e)) /
                        (1.f + expf(-(comp(gt, e) + comp(bg, e))));
      const float relu = fmaxf(comp(fc, e) + comp(bc, e), 0.f);
      o[e] = g0 * (comp(xv, e) + comp(yv, e)) + g1 * ln + g2 * glu +
             g3 * relu;
    }
    store4(out + gbase + static_cast<size_t>(r) * C + n,
           make_float4(o[0], o[1], o[2], o[3]));
  }
}

// The kernel may take every byte of shared memory a block can have; the
// occupancy calculator then sees each geometry's real share.
template <typename T>
cudaError_t allow_smem() {
  return cudaFuncSetAttribute(node_mixed_kernel<T>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              kSmemLimit);
}

// The geometry of a call: the mixed op's GEMM is 2C deep over three
// weight column sets (cell_gemm.cuh's pick_geom).
template <typename T>
bool pick_mixed_geom(int B, int L, int C, int S_req, int nt_req,
                     GemmGeom* out, int* occ_out) {
  const int sz = sizeof(T);
  return pick_geom(
      B, L, C, 2 * C, sz, 3, S_req, nt_req,
      [&](const GemmGeom& g) { return mixed_smem(g, L, C, sz).total; },
      [](size_t bytes) {
        return blocks_per_sm(node_mixed_kernel<T>, kThreads, bytes);
      },
      out, occ_out);
}

template <typename T>
int launch(const void* x, const void* y, const float* gammas, void* out,
           int B, int L, int C, const void* const* params, float eps,
           int samples_per_block, int cols_per_block, cudaStream_t stream) {
  MixedParams<T> p;
  const T* const* t = reinterpret_cast<const T* const*>(params);
  p.ln_s = t[0];
  p.ln_b = t[1];
  p.glu_w = t[2];
  p.glu_b = t[3];
  p.cfc_w = t[4];
  p.cfc_b = t[5];
  cudaError_t err = allow_smem<T>();
  if (err != cudaSuccess) return static_cast<int>(err);
  GemmGeom g;
  int occ = 1;
  if (!pick_mixed_geom<T>(B, L, C, samples_per_block, cols_per_block, &g,
                          &occ))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = mixed_smem(g, L, C, sizeof(T)).total;
  const int blocks = g.groups * g.tiles;
  node_mixed_kernel<T><<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(y), gammas,
      static_cast<T*>(out), p, g, B, L, C, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int geometry(int B, int L, int C, int samples_per_block, int cols_per_block,
             int* geom) {
  cudaError_t err = allow_smem<T>();
  if (err != cudaSuccess) return static_cast<int>(err);
  GemmGeom g;
  int occ = 1;
  if (!pick_mixed_geom<T>(B, L, C, samples_per_block, cols_per_block, &g,
                          &occ))
    return static_cast<int>(cudaErrorInvalidValue);
  geom[0] = g.S;
  geom[1] = g.nt;
  geom[2] = g.kt;
  geom[3] = g.slots;
  geom[4] = g.groups * g.tiles;
  geom[5] = occ;
  geom[6] = static_cast<int>(mixed_smem(g, L, C, sizeof(T)).total);
  return 0;
}

bool valid_call(int B, int L, int C, int samples_per_block,
                int cols_per_block) {
  return B >= 1 && L >= 1 && C % 8 == 0 && C >= 8 && C <= 256 &&
         samples_per_block >= 0 && samples_per_block <= kMaxSamples &&
         (samples_per_block & (samples_per_block - 1)) == 0 &&
         (cols_per_block == 0 || cols_per_block == 16 ||
          cols_per_block == 32);
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory of the smallest geometry (one sample a
// block, 16 columns, a ring of 16-row K-tiles): the call fits if this does.
size_t node_mixed_smem_bytes(int L, int C, int itemsize) {
  return mixed_smem(gemm_geom(1, L, C, 2 * C, itemsize, 3, 1, 16, 16, false),
                    L, C, itemsize)
      .total;
}

// The geometry a call would take: geom = {S, nt, kt, K-tiles in shared
// memory, blocks, blocks an SM, smem bytes}. Returns 0, or
// cudaErrorInvalidValue if no geometry fits.
int node_mixed_geometry(int B, int L, int C, int itemsize,
                        int samples_per_block, int cols_per_block,
                        int* geom) {
  if (!valid_call(B, L, C, samples_per_block, cols_per_block))
    return static_cast<int>(cudaErrorInvalidValue);
  if (itemsize == 4)
    return geometry<float>(B, L, C, samples_per_block, cols_per_block, geom);
  if (itemsize == 2)
    return geometry<__nv_bfloat16>(B, L, C, samples_per_block,
                                   cols_per_block, geom);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* node_mixed_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// dtype: 0 = fp32, 1 = bf16 (x, y, out and every parameter); gammas is a
// device pointer to four fp32 weights. params holds six device pointers in
// MixedParams order. x and y may be equal. samples_per_block (1, 2 or 4)
// and cols_per_block (16 or 32) fix the geometry; 0 lets the launcher
// pick. Returns the CUDA error code of the launch (0 on success).
int node_mixed_forward(int dtype, const void* x, const void* y,
                       const void* gammas, void* out, int B, int L, int C,
                       const void* const* params, float eps,
                       int samples_per_block, int cols_per_block,
                       void* stream) {
  if (!valid_call(B, L, C, samples_per_block, cols_per_block))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* g = static_cast<const float*>(gammas);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, y, g, out, B, L, C, params, eps,
                         samples_per_block, cols_per_block, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, y, g, out, B, L, C, params, eps,
                                 samples_per_block, cols_per_block, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
