// Device code shared by the two fusion-cell kernels that run their GEMMs on
// the tensor cores, node_mixed.cu and found_cell.cu.
//
// A block of kThreads = 512 threads in two warp groups that work apart,
// each meeting at its own named barrier: the GEMM group (warps 0-7) streams
// the block's weight columns through shared memory by cp.async and runs the
// product on the tensor cores (tc_gemm.cuh), while the other group stages
// the operand A and computes per-sample attention and LayerNorm statistics.
//
//   * GemmGeom / gemm_geom: the geometry of a call. A block owns S whole
//     samples (S L rows, rounded up to 16) and nt output columns of each of
//     `sets` weight column sets: [GLU values | GLU gates | ConcatFC] for the
//     mixed op; the values and gates of a GLU step, or the one set of a
//     ConcatFC step or of the out-conv, for the found cell. The weight
//     columns sit whole in shared memory or stream through a ring of
//     K-tiles. blockIdx.x = group * tiles + tile.
//   * TileCopier / load_weight_tile: a GEMM thread's share of a weight K-tile
//     by cp.async; columns past C and rows past the weight's depth are
//     zeros.
//   * gemm_group: the GEMM group's product; a warp's unit of work is two
//     16-row tiles times `sets` 16-column tiles, and when the block has
//     fewer units than warps, the warps split the units' MMA steps and the
//     epilogue adds the partial sums in a fixed order.
//   * attention_rows / sample_attention / group_sums: the other group's
//     per-sample attention, then (sample_attention) its LayerNorm
//     statistics.
//   * pick_geom: the launcher's choice of (S, nt) and weight layout, the
//     fewest waves of blocks over the card (occupancy calculator) times the
//     work of one block.
#pragma once

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
// the groups' barrier ids, and the one at which the staging group hands A
// over to the GEMM group
constexpr int kBarGemm = 1, kBarAttn = 2, kBarA = 3;
constexpr int kRowTilesPerUnit = 2;  // 16-row accumulator tiles a unit
constexpr int kMaxSets = 3;          // weight column sets (16-col tiles a unit)
constexpr int kMaxStages = 8;        // K-tiles in shared memory at most
constexpr int kRingStages = 4;       // K-tiles of a ring
constexpr int kMaxSamples = 4;       // samples a block
constexpr int kMaxGroupRows = 64;    // rows of a block of several samples
constexpr int kDefaultSms = 132;     // H100 SXM, if the device cannot say
// the launcher's cost of one block: its GEMM rows x columns, plus this
// much for what every block pays whatever its size (the copies' issue,
// the attention, the barriers); on the H100 it makes the mixed op's B = 96
// take two samples and 32 columns a block, which measured fastest there
constexpr long kBlockFixed = 512;

// The launch geometry of one call (or of one found-cell phase).
struct GemmGeom {
  int S;       // samples a block
  int nt;      // output columns a block of each weight column set (16, 32)
  int sets;    // weight column sets: 16-column tiles of a warp's unit
  int kt;      // weight rows a K-tile (a multiple of 16, or all of K)
  int nk;      // K-tiles: ceil(K / kt)
  int slots;   // K-tiles shared memory holds: nk (the whole slab) or a ring
  int rows;    // GEMM rows: S L rounded up to 16
  int lda;     // elements of an A row: K + 16 bytes of pad
  int ldb;     // elements of a weight-tile row: sets nt + 16 bytes of pad
  int units;   // (two 16-row tiles, sets 16-column tiles) pairs
  int splits;  // warps that share one unit's MMA steps
  int groups;  // sample groups: ceil(B / S)
  int tiles;   // column tiles: ceil(C / nt)
};

// K: the GEMM's depth, a multiple of the MMA step (8 fp32, 16 bf16).
__host__ __device__ inline GemmGeom gemm_geom(int B, int L, int C, int K,
                                              int itemsize, int sets, int S,
                                              int nt, int kt, bool slab) {
  GemmGeom g;
  g.S = S;
  g.nt = nt;
  g.sets = sets;
  g.kt = kt < K ? kt : K;
  g.nk = (K + g.kt - 1) / g.kt;
  g.slots = slab || g.nk <= kRingStages ? g.nk : kRingStages;
  g.rows = (S * L + 15) / 16 * 16;
  g.lda = K + 16 / itemsize;
  g.ldb = sets * nt + 16 / itemsize;
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

// Bytes of the region that holds the weight K-tiles and, after the GEMM,
// its fp32 results (one copy a split).
__host__ __device__ inline size_t ring_bytes(const GemmGeom& g,
                                             int itemsize) {
  const size_t ring = static_cast<size_t>(g.slots) * g.kt * g.ldb * itemsize;
  const size_t res = static_cast<size_t>(g.splits) * g.rows * g.sets *
                     g.nt * sizeof(float);
  return align32(ring > res ? ring : res);
}

// A GEMM thread's share of the block's weight K-tiles, fixed for the whole
// call so that the copy loop does no index arithmetic: the lanes of a warp
// split one row's sets x nt columns into 16-byte chunks (at most 24), a
// warp copies rpp rows at a time. Chunks at or past C (a ragged last column
// tile), and rows at or past krows, are zeros.
template <typename T>
struct TileCopier {
  const T* src;  // the chunk's column in weight row 0
  int dst;       // the chunk's element offset in a slot row
  int stride;    // elements from one weight row to the next
  int row0;      // the thread's first row of a tile
  int rstep;     // rows from one of the thread's rows to its next
  int krows;     // the weight's rows
  bool active;   // the lane has a chunk
  bool zero;     // the chunk lies past C
};

// srcs[s]: column 0 of weight column set s in weight row 0; strides[s]:
// elements from one of its rows to the next; n0: the block's first column.
template <typename T>
__device__ TileCopier<T> tile_copier(const T* const (&srcs)[kMaxSets],
                                     const int (&strides)[kMaxSets],
                                     int sets, int nt, int C, int n0,
                                     int krows) {
  constexpr int kVec = 16 / sizeof(T);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int seg = nt / kVec, per_row = sets * seg, rpp = 32 / per_row;
  const int sub = lane / per_row, q = lane - sub * per_row;
  const int s = q / seg < sets ? q / seg : 0;
  const int col = (q - s * seg) * kVec, n = n0 + col;
  TileCopier<T> c;
  c.active = sub < rpp;
  c.zero = n >= C;
  c.dst = s * nt + col;
  c.src = srcs[s] + n;
  c.stride = strides[s];
  c.row0 = warp * rpp + sub;
  c.rstep = kGemmWarps * rpp;
  c.krows = krows;
  return c;
}

// Weight rows [k0, k0 + kn) of the block's columns into one slot.
template <typename T>
__device__ void load_weight_tile(T* dst, const TileCopier<T>& c, int ldb,
                                 int k0, int kn) {
  if (!c.active) return;
  for (int r = c.row0; r < kn; r += c.rstep) {
    T* d = dst + r * ldb + c.dst;
    if (c.zero || k0 + r >= c.krows)
      *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
    else
      cp_async16(d, c.src + static_cast<size_t>(k0 + r) * c.stride);
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

// v[s] summed over the staging group for s < ns, returned to each of its
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

// The staging group (tid its thread's index in it): for each of the
// block's ns samples, attn = softmax(x y^T / sqrt(C)) y over the whole
// (L, C) in fp32, x and y read from X and Y (ld elements a row), attn
// written with C a row; the group meets after it.
template <typename T>
__device__ void attention_rows(const T* X, const T* Y, int ld, int L, int C,
                               int ns, int tid, float* attn, float* scores) {
  const int LL = L * L;
  const float inv_sqrt_c = 1.f / sqrtf(static_cast<float>(C));
  for (int p = tid; p < ns * LL; p += kAttnThreads) {
    const int s = p / LL, ij = p - s * LL, i = ij / L, j = ij - i * L;
    const T* xi = X + (s * L + i) * ld;
    const T* yj = Y + (s * L + j) * ld;
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
    const T* yc = Y + s * L * ld + c;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int j = 0; j < L; ++j) {
      const float w = pr[j];
      const float4 v = load4(yc + j * ld);
      a.x = fmaf(w, v.x, a.x);
      a.y = fmaf(w, v.y, a.y);
      a.z = fmaf(w, v.z, a.z);
      a.w = fmaf(w, v.w, a.w);
    }
    store4(attn + row * C + c, a);
  }
  group_sync(kBarAttn, kAttnThreads);
}

// attention_rows, then each sample's LayerNorm mean and rstd into
// stats[s], stats[kMaxSamples + s] (by thread 0: the caller meets before
// reading), every sample at once: mean, then E[(v - mean)^2].
template <typename T>
__device__ void sample_attention(const T* X, const T* Y, int ld, int L,
                                 int C, int ns, int tid, float* attn,
                                 float* scores, float* stats, float* red,
                                 float eps) {
  const int LC = L * C;
  attention_rows(X, Y, ld, L, C, ns, tid, attn, scores);
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

// The GEMM group: A [the block's weight columns] on the tensor cores, K
// deep, weight K-tile t landing in slot t % slots (the first `first` of them
// issued before the call). Warp w < units x splits takes unit w % units
// (two 16-row tiles, the second absent past the last row, and kSets 16-column
// tiles: each B fragment serves both row tiles, each A fragment kSets column
// tiles) and the MMA steps k with k % splits == w / units. Leaves its 16x16
// tiles in res[split] (rows x kSets nt, fp32), which overlays the ring.
template <typename T, int kSets>
__device__ void gemm_group(const T* A, T* ring, float* res,
                           const GemmGeom& g, const TileCopier<T>& wcopy,
                           int first, int K) {
  using Step = TcStep<T>;
  constexpr int kK = Step::kK;
  const int warp = threadIdx.x >> 5, cg_count = g.nt / 16;
  const bool active = warp < g.units * g.splits;
  const int unit = warp % g.units, split = warp / g.units;
  const int rt = unit / cg_count * kRowTilesPerUnit;
  const int cg = unit - unit / cg_count * cg_count;
  const bool two = rt + 1 < g.rows / 16;  // the unit's second row tile
  typename Step::Acc acc[kRowTilesPerUnit][kSets];
#pragma unroll
  for (int r = 0; r < kRowTilesPerUnit; ++r)
#pragma unroll
    for (int c = 0; c < kSets; ++c) wmma::fill_fragment(acc[r][c], 0.f);
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
    const T* b0 = wt + cg * kSets * 16;
    // splits = kGemmWarps / units is a power of two
    for (int ks = (split - kbase) & (g.splits - 1); ks < steps;
         ks += g.splits) {
      typename Step::B b[kSets];
#pragma unroll
      for (int c = 0; c < kSets; ++c)
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
  const int ldr = kSets * g.nt;
#pragma unroll
  for (int r = 0; r < kRowTilesPerUnit; ++r) {
    if (r == 1 && !two) break;
#pragma unroll
    for (int c = 0; c < kSets; ++c)
      wmma::store_matrix_sync(
          res + (split * g.rows + (rt + r) * 16) * ldr + (cg * kSets + c) * 16,
          acc[r][c], ldr, wmma::mem_row_major);
  }
}

// Blocks of `threads` threads and `smem` bytes an SM holds; at least 1.
template <typename Kernel>
int blocks_per_sm(Kernel kernel, int threads, size_t smem) {
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads,
                                                    smem) != cudaSuccess ||
      n < 1)
    n = 1;
  return n;
}

inline int sm_count() {
  int dev = 0, nsm = kDefaultSms;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    nsm = kDefaultSms;
  return nsm;
}

// Waves of blocks a grid of `blocks` takes on nsm SMs, occ blocks an SM.
inline long waves(long blocks, int nsm, int occ) {
  const long per_wave = static_cast<long>(nsm) * occ;
  return (blocks + per_wave - 1) / per_wave;
}

// The geometry of a GEMM K deep with `sets` column sets: S and nt as asked
// (0: the launcher picks the one with the least waves x (block rows x nt +
// kBlockFixed), the first of S = 1, 2, 4 and nt = 16, 32 on a tie). For
// each (S, nt) the whole weight slab in 64-row K-tiles, or a ring of 64-,
// 32- or 16-row K-tiles, whichever fits in the fewest waves (the first of
// them on a tie). smem(g): a block's bytes of shared memory; occ(bytes): the
// blocks an SM holds. False if none fits.
template <typename Smem, typename Occ>
bool pick_geom(int B, int L, int C, int K, int itemsize, int sets, int S_req,
               int nt_req, Smem smem, Occ occ, GemmGeom* out,
               int* occ_out) {
  const int nsm = sm_count();
  bool found = false;
  long best = 0;
  for (int S = 1; S <= kMaxSamples; S <<= 1) {
    if (S_req ? S != S_req : S > 1 && (S * L > kMaxGroupRows || S > B))
      continue;
    for (int nt = 16; nt <= 32; nt <<= 1) {
      if (nt_req ? nt != nt_req : nt == 32 && C <= 16) continue;
      const GemmGeom cand[] = {
          gemm_geom(B, L, C, K, itemsize, sets, S, nt, 64, true),
          gemm_geom(B, L, C, K, itemsize, sets, S, nt, 64, false),
          gemm_geom(B, L, C, K, itemsize, sets, S, nt, 32, false),
          gemm_geom(B, L, C, K, itemsize, sets, S, nt, 16, false)};
      bool any = false;
      long best_w = 0;
      GemmGeom g{};
      int o = 1;
      for (const GemmGeom& c : cand) {
        if (c.units > kGemmWarps || c.slots > kMaxStages) continue;
        const size_t bytes = smem(c);
        if (bytes > static_cast<size_t>(kSmemLimit)) continue;
        const int oc = occ(bytes);
        const long w = waves(static_cast<long>(c.groups) * c.tiles, nsm, oc);
        if (!any || w < best_w) {
          g = c;
          o = oc;
          best_w = w;
          any = true;
        }
      }
      if (!any) continue;
      const long cost = best_w * (static_cast<long>(g.rows) * g.nt +
                                  kBlockFixed);
      if (!found || cost < best) {
        *out = g;
        *occ_out = o;
        best = cost;
        found = true;
      }
    }
  }
  return found;
}

}  // namespace
