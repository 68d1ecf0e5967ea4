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
// Requirements: C % 8 == 0 and C <= 256, at most 256 rows a block (L <=
// 256) and a geometry whose shared memory fits, checked here; 16-byte
// aligned x, y, out and weights, checked by the wrapper.
#include "cell_common.cuh"
#include "tc_gemm.cuh"

namespace {

// Two warp groups: warps [0, kGemmWarps) issue the weight copies and run
// the GEMMs while the others stage A and run the attention, each group
// meeting at its own named barrier; the block meets before the epilogue.
constexpr int kGemmWarps = 8;
constexpr int kAttnWarps = 8;
constexpr int kGemmThreads = 32 * kGemmWarps;
constexpr int kAttnThreads = 32 * kAttnWarps;
constexpr int kThreads = kGemmThreads + kAttnThreads;
// the groups' barrier ids, and the one at which the attention group
// hands A over to the GEMM group
constexpr int kBarGemm = 1, kBarAttn = 2, kBarA = 3;
constexpr int kTilesPerUnit = 3;     // 16-column accumulator tiles a unit
constexpr int kRowTilesPerUnit = 2;  // 16-row accumulator tiles a unit
constexpr int kMaxStages = 8;        // K-tiles in shared memory at most
constexpr int kRingStages = 4;       // K-tiles of a ring
constexpr int kMaxSamples = 4;       // samples a block
constexpr int kMaxGroupRows = 64;    // rows of a block of several samples
constexpr int kDefaultSms = 132;     // H100 SXM, if the device cannot say
// the launcher's cost of one block: its GEMM rows x columns, plus this
// much for what every block pays whatever its size (the copies' issue,
// the attention, the barriers); on the H100 it makes B = 96 take two
// samples and 32 columns a block, which measured fastest there
constexpr long kBlockFixed = 512;

template <typename T>
struct MixedParams {
  const T *ln_s, *ln_b;    // (L, C)
  const T *glu_w, *glu_b;  // (2C, 2C), (2C)
  const T *cfc_w, *cfc_b;  // (2C, C), (C)
};

// The launch geometry of one call.
struct MixedGeom {
  int S;       // samples a block
  int nt;      // output columns a block (16 or 32)
  int kt;      // weight rows a K-tile (a multiple of 16)
  int nk;      // K-tiles: ceil(2C / kt)
  int slots;   // K-tiles shared memory holds: nk (the whole slab) or a ring
  int rows;    // GEMM rows: S L rounded up to 16
  int lda;     // elements of an A row: 2C + 16 bytes of pad
  int ldb;     // elements of a weight-tile row: 3 nt + 16 bytes of pad
  int units;   // (two 16-row tiles, three 16-column tiles) pairs
  int splits;  // warps that share one unit's MMA steps
  int groups;  // sample groups: ceil(B / S)
  int tiles;   // column tiles: ceil(C / nt)
};

__host__ __device__ inline MixedGeom mixed_geom(int B, int L, int C,
                                                int itemsize, int S, int nt,
                                                int kt, bool slab) {
  MixedGeom g;
  g.S = S;
  g.nt = nt;
  g.kt = kt < 2 * C ? kt : 2 * C;
  g.nk = (2 * C + g.kt - 1) / g.kt;
  g.slots = slab || g.nk <= kRingStages ? g.nk : kRingStages;
  g.rows = (S * L + 15) / 16 * 16;
  g.lda = 2 * C + 16 / itemsize;
  g.ldb = 3 * nt + 16 / itemsize;
  g.units = (g.rows / 16 + kRowTilesPerUnit - 1) / kRowTilesPerUnit *
            (nt / 16);
  g.splits = g.units >= kGemmWarps ? 1 : kGemmWarps / g.units;
  g.groups = (B + S - 1) / S;
  g.tiles = (C + nt - 1) / nt;
  return g;
}

__host__ __device__ inline size_t align32(size_t n) {
  return (n + 31) & ~static_cast<size_t>(31);
}

// Byte offsets of the shared-memory regions; each starts 32-byte aligned
// (WMMA's rule). The weight tiles and, after the GEMM, its results share
// one region.
struct MixedSmem {
  size_t a, prm, attn, scores, stats, ring, total;
};

__host__ __device__ inline MixedSmem mixed_smem(const MixedGeom& g, int L,
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
  const size_t ring = static_cast<size_t>(g.slots) * g.kt * g.ldb * itemsize;
  const size_t res =
      static_cast<size_t>(g.splits) * g.rows * 3 * g.nt * sizeof(float);
  off += align32(ring > res ? ring : res);
  m.total = off;
  return m;
}

bool mixed_fits(const MixedGeom& g, int L, int C, int itemsize) {
  return g.units <= kGemmWarps && g.slots <= kMaxStages &&
         mixed_smem(g, L, C, itemsize).total <= kSmemLimit;
}

// A GEMM thread's share of the block's weight K-tiles, fixed for the whole
// call so that the copy loop does no index arithmetic: the lanes of a warp
// split one row's 3 nt columns [GLU values | GLU gates | ConcatFC] into
// 16-byte chunks (at most 24), a warp copies rpp rows at a time. Chunks at
// or past C (a ragged last column tile) are zeros.
template <typename T>
struct TileCopier {
  const T* src;  // the chunk's column in weight row 0
  int dst;       // the chunk's element offset in a slot row
  int stride;    // elements from one weight row to the next
  int row0;      // the thread's first row of a tile
  int rstep;     // rows from one of the thread's rows to its next
  bool active;   // the lane has a chunk
  bool zero;     // the chunk lies past C
};

template <typename T>
__device__ TileCopier<T> tile_copier(const MixedParams<T>& p,
                                     const MixedGeom& g, int C, int n0) {
  constexpr int kVec = 16 / sizeof(T);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int seg = g.nt / kVec, per_row = 3 * seg, rpp = 32 / per_row;
  const int sub = lane / per_row, q = lane - sub * per_row;
  const int s = q / seg, col = (q - s * seg) * kVec, n = n0 + col;
  TileCopier<T> c;
  c.active = sub < rpp;
  c.zero = n >= C;
  c.dst = s * g.nt + col;
  c.src = s == 2 ? p.cfc_w + n : p.glu_w + (s ? C : 0) + n;
  c.stride = s == 2 ? C : 2 * C;
  c.row0 = warp * rpp + sub;
  c.rstep = kGemmWarps * rpp;
  return c;
}

// Weight rows [k0, k0 + kn) of the block's 3 nt columns into one slot.
template <typename T>
__device__ void load_weight_tile(T* dst, const TileCopier<T>& c, int ldb,
                                 int k0, int kn) {
  if (!c.active) return;
  for (int r = c.row0; r < kn; r += c.rstep) {
    T* d = dst + r * ldb + c.dst;
    if (c.zero)
      *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
    else
      cp_async16(d, c.src + static_cast<size_t>(k0 + r) * c.stride);
  }
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

// Component e (a constant after unrolling) of a float4.
__device__ __forceinline__ float comp(const float4& a, int e) {
  return e == 0 ? a.x : e == 1 ? a.y : e == 2 ? a.z : a.w;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// v[s] summed over the attention group for s < ns, returned to each of its
// threads (tid its index in the group); two barriers of the group.
__device__ void group_sums(float (&v)[kMaxSamples], int ns, int tid,
                           float* red) {
  const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int s = 0; s < kMaxSamples; ++s)
    if (s < ns) v[s] = warp_sum(v[s]);
  if (lane == 0) {
#pragma unroll
    for (int s = 0; s < kMaxSamples; ++s) red[warp * kMaxSamples + s] = v[s];
  }
  group_sync(kBarAttn, kAttnThreads);
#pragma unroll
  for (int s = 0; s < kMaxSamples; ++s) {
    float t = 0.f;
    for (int w = 0; w < kAttnWarps; ++w) t += red[w * kMaxSamples + s];
    v[s] = t;
  }
  group_sync(kBarAttn, kAttnThreads);  // red is free again
}

// The attention group (tid its thread's index in it): for each of the
// block's ns samples, attn = softmax(x y^T / sqrt(C)) y over the whole
// (L, C), x and y read from A, in fp32; then its LayerNorm mean and rstd
// into stats[s], stats[kMaxSamples + s].
template <typename T>
__device__ void sample_attention(const T* A, int lda, int L, int C, int ns,
                                 int tid, float* attn, float* scores,
                                 float* stats, float* red, float eps) {
  const int LL = L * L, LC = L * C;
  const float inv_sqrt_c = 1.f / sqrtf(static_cast<float>(C));
  for (int p = tid; p < ns * LL; p += kAttnThreads) {
    const int s = p / LL, ij = p - s * LL, i = ij / L, j = ij - i * L;
    const T* xi = A + (s * L + i) * lda;
    const T* yj = A + (s * L + j) * lda + C;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);  // four partial sums
#pragma unroll 4
    for (int c = 0; c < C; c += 4) {
      const float4 a = load4(xi + c), b = load4(yj + c);
      acc.x = fmaf(a.x, b.x, acc.x);
      acc.y = fmaf(a.y, b.y, acc.y);
      acc.z = fmaf(a.z, b.z, acc.z);
      acc.w = fmaf(a.w, b.w, acc.w);
    }
    scores[p] = ((acc.x + acc.y) + (acc.z + acc.w)) * inv_sqrt_c;
  }
  group_sync(kBarAttn, kAttnThreads);
  const int lane = tid & 31, warp = tid >> 5;
  for (int row = warp; row < ns * L; row += kAttnWarps) {  // a warp a row
    float* sr = scores + row * L;
    float mx = -3.402823466e38f;
    for (int j = lane; j < L; j += 32) mx = fmaxf(mx, sr[j]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < L; j += 32) {
      const float e = expf(sr[j] - mx);
      sr[j] = e;
      sum += e;
    }
    const float inv = 1.f / warp_sum(sum);
    for (int j = lane; j < L; j += 32) sr[j] *= inv;
  }
  group_sync(kBarAttn, kAttnThreads);
  const int cq = C / 4;
  for (int idx = tid; idx < ns * L * cq; idx += kAttnThreads) {
    const int row = idx / cq, c = 4 * (idx - row * cq);
    const int s = row / L;
    const float* pr = scores + row * L;
    const T* yc = A + s * L * lda + C + c;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int j = 0; j < L; ++j) {
      const float w = pr[j];
      const float4 v = load4(yc + j * lda);
      a.x = fmaf(w, v.x, a.x);
      a.y = fmaf(w, v.y, a.y);
      a.z = fmaf(w, v.z, a.z);
      a.w = fmaf(w, v.w, a.w);
    }
    store4(attn + row * C + c, a);
  }
  group_sync(kBarAttn, kAttnThreads);
  // LayerNorm statistics of every sample at once: mean, then E[(v-mean)^2]
  float sum[kMaxSamples];
#pragma unroll
  for (int s = 0; s < kMaxSamples; ++s) {
    sum[s] = 0.f;
    if (s < ns) {
      for (int i = 4 * tid; i < LC; i += 4 * kAttnThreads) {
        const float4 a = load4(attn + s * LC + i);
        sum[s] += (a.x + a.y) + (a.z + a.w);
      }
    }
  }
  group_sums(sum, ns, tid, red);
  float mean[kMaxSamples], q[kMaxSamples];
#pragma unroll
  for (int s = 0; s < kMaxSamples; ++s) {
    mean[s] = sum[s] / LC;
    q[s] = 0.f;
    if (s < ns) {
      for (int i = 4 * tid; i < LC; i += 4 * kAttnThreads) {
        const float4 a = load4(attn + s * LC + i);
        const float dx = a.x - mean[s], dy = a.y - mean[s],
                    dz = a.z - mean[s], dw = a.w - mean[s];
        q[s] += (dx * dx + dy * dy) + (dz * dz + dw * dw);
      }
    }
  }
  group_sums(q, ns, tid, red);
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kMaxSamples; ++s) {
      stats[s] = mean[s];
      stats[kMaxSamples + s] = rsqrtf(q[s] / LC + eps);
    }
  }
}

// The GEMM group: [x|y] [Wg_values | Wg_gates | Wc] for the block's
// columns on the tensor cores, weight K-tile t landing in slot t % slots.
// Warp w < units x splits takes unit w % units (two 16-row tiles, the
// second absent past the last row, and three 16-column tiles: each B
// fragment serves both row tiles, each A fragment three column tiles) and
// the MMA steps k with k % splits == w / units. Leaves its 16x16 tiles in
// res[split] (rows x 3 nt, fp32), which overlays the ring.
template <typename T>
__device__ void gemm_group(const T* A, T* ring, float* res,
                           const MixedGeom& g, const TileCopier<T>& wcopy,
                           int first, int K) {
  using Step = TcStep<T>;
  constexpr int kK = Step::kK;
  const int warp = threadIdx.x >> 5, cg_count = g.nt / 16;
  const bool active = warp < g.units * g.splits;
  const int unit = warp % g.units, split = warp / g.units;
  const int rt = unit / cg_count * kRowTilesPerUnit;
  const int cg = unit - unit / cg_count * cg_count;
  const bool two = rt + 1 < g.rows / 16;  // the unit's second row tile
  typename Step::Acc acc[kRowTilesPerUnit][kTilesPerUnit];
#pragma unroll
  for (int r = 0; r < kRowTilesPerUnit; ++r)
#pragma unroll
    for (int c = 0; c < kTilesPerUnit; ++c) wmma::fill_fragment(acc[r][c], 0.f);
  for (int t = 0; t < g.nk; ++t) {
    cp_async_wait_n(first - 1);  // tile t has landed (this thread's)
    group_sync(kBarGemm, kGemmThreads);  // ... the group's; t - 1's slot free
    if (t + first < g.nk) {
      const int tn = t + first;
      load_weight_tile(ring + (tn % g.slots) * g.kt * g.ldb, wcopy, g.ldb,
                       tn * g.kt, min(g.kt, K - tn * g.kt));
    }
    cp_async_commit();  // possibly empty: one group a tile
    if (!active) continue;
    const T* wt = ring + (t % g.slots) * g.kt * g.ldb;
    const int k0 = t * g.kt, steps = min(g.kt, K - k0) / kK;
    const int kbase = k0 / kK;  // MMA steps before this tile
    const T* a0 = A + rt * 16 * g.lda + k0;
    const T* b0 = wt + cg * kTilesPerUnit * 16;
    // splits = kGemmWarps / units is a power of two
    for (int ks = (split - kbase) & (g.splits - 1); ks < steps;
         ks += g.splits) {
      typename Step::B b[kTilesPerUnit];
#pragma unroll
      for (int c = 0; c < kTilesPerUnit; ++c)
        Step::load_b(b[c], b0 + ks * kK * g.ldb + c * 16, g.ldb);
      typename Step::A a;
      Step::load_a(a, a0 + ks * kK, g.lda);
      Step::mma(acc[0], a, b);
      if (two) {
        Step::load_a(a, a0 + 16 * g.lda + ks * kK, g.lda);
        Step::mma(acc[1], a, b);
      }
    }
  }
  group_sync(kBarGemm, kGemmThreads);  // the ring takes the results
  if (!active) return;
  const int ldr = 3 * g.nt;
#pragma unroll
  for (int r = 0; r < kRowTilesPerUnit; ++r) {
    if (r == 1 && !two) break;
#pragma unroll
    for (int c = 0; c < kTilesPerUnit; ++c)
      wmma::store_matrix_sync(
          res + (split * g.rows + (rt + r) * 16) * ldr +
              (cg * kTilesPerUnit + c) * 16,
          acc[r][c], ldr, wmma::mem_row_major);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    node_mixed_kernel(const T* x, const T* y,
                      const float* __restrict__ gammas, T* __restrict__ out,
                      MixedParams<T> p, MixedGeom g, int B, int L, int C,
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
    gemm_group(A, ring, res, g, wcopy, first, K);
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
    sample_attention(A, g.lda, L, C, ns, tid, attn, scores, stats, red,
                     eps);
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

template <typename T>
int blocks_per_sm(size_t smem) {
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, node_mixed_kernel<T>, kThreads, smem) != cudaSuccess ||
      n < 1)
    n = 1;
  return n;
}

int sm_count() {
  int dev = 0, nsm = kDefaultSms;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    nsm = kDefaultSms;
  return nsm;
}

// Waves of blocks a grid of `blocks` takes on nsm SMs, occ blocks an SM.
long waves(long blocks, int nsm, int occ) {
  const long per_wave = static_cast<long>(nsm) * occ;
  return (blocks + per_wave - 1) / per_wave;
}

// For (S, nt): the whole weight slab in 64-row K-tiles, or a ring of 64-,
// 32- or 16-row K-tiles, whichever fits in the fewest waves (the first of
// them on a tie). False if none fits.
template <typename T>
bool best_layout(int B, int L, int C, int S, int nt, int nsm,
                 MixedGeom* out, int* occ) {
  const int sz = sizeof(T);
  const MixedGeom cand[] = {mixed_geom(B, L, C, sz, S, nt, 64, true),
                            mixed_geom(B, L, C, sz, S, nt, 64, false),
                            mixed_geom(B, L, C, sz, S, nt, 32, false),
                            mixed_geom(B, L, C, sz, S, nt, 16, false)};
  bool found = false;
  long best = 0;
  for (const MixedGeom& g : cand) {
    if (!mixed_fits(g, L, C, sz)) continue;
    const int o = blocks_per_sm<T>(mixed_smem(g, L, C, sz).total);
    const long w = waves(static_cast<long>(g.groups) * g.tiles, nsm, o);
    if (!found || w < best) {
      *out = g;
      *occ = o;
      best = w;
      found = true;
    }
  }
  return found;
}

// The geometry of a call: S and nt as asked (0: the launcher picks the
// one with the least waves x (block rows x nt + kBlockFixed), the first of
// S = 1, 2, 4 and nt = 16, 32 on a tie). False if none fits.
template <typename T>
bool pick_geom(int B, int L, int C, int S_req, int nt_req, MixedGeom* out,
               int* occ_out) {
  const int nsm = sm_count();
  bool found = false;
  long best = 0;
  for (int S = 1; S <= kMaxSamples; S <<= 1) {
    if (S_req ? S != S_req : S > 1 && (S * L > kMaxGroupRows || S > B))
      continue;
    for (int nt = 16; nt <= 32; nt <<= 1) {
      if (nt_req ? nt != nt_req : nt == 32 && C <= 16) continue;
      MixedGeom g;
      int occ = 1;
      if (!best_layout<T>(B, L, C, S, nt, nsm, &g, &occ)) continue;
      const long cost =
          waves(static_cast<long>(g.groups) * g.tiles, nsm, occ) *
          (static_cast<long>(g.rows) * g.nt + kBlockFixed);
      if (!found || cost < best) {
        *out = g;
        *occ_out = occ;
        best = cost;
        found = true;
      }
    }
  }
  return found;
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
  MixedGeom g;
  int occ = 1;
  if (!pick_geom<T>(B, L, C, samples_per_block, cols_per_block, &g, &occ))
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
  MixedGeom g;
  int occ = 1;
  if (!pick_geom<T>(B, L, C, samples_per_block, cols_per_block, &g, &occ))
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
  return mixed_smem(mixed_geom(1, L, C, itemsize, 1, 16, 16, false), L, C,
                    itemsize)
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
