// softmax(x y^T / sqrt(C)) y, keys equal to values, as one CUDA kernel for
// Hopper's tensor cores.
//
// Replaces bmnas_tpu/ops/kernels/attention.py::blockwise_scaled_dot_attention
// (the Pallas TPU kernel). Queries x (B, Lq, C) and keys = values y
// (B, Lk, C) in fp32 or bf16, read in their own type and accumulated in
// fp32; the output is fp32 (B, Lq, C). The key axis is consumed tile by tile
// with an online softmax (running max m, running denominator l, an fp32
// accumulator rescaled by 2^(m_old - m_new)), so the (Lq, Lk) score matrix
// is never written to device memory: only x, y and the output are.
//
// What bounds it on an H100: the call does 4 B Lq Lk C FLOP (two products)
// and must move 4 (2 B Lq C + B Lk C) bytes in fp32. At B = 8, C = 192,
// L = 16 that is 1.6 MFLOP against 295 KB: bound by bytes, 0.09 us at
// 3.35 TB/s, where launch latency is all that shows. From L of a few
// hundred on it is bound by operations: at L = 4096, 1.5 ms at the 67
// TFLOP/s of fp32 FMA and 0.21 ms at the tensor cores' 495 TFLOP/s of TF32
// (3xTF32 runs three TF32 products for each fp32 one).
//
// What the design does about it:
//   * both products run on the tensor cores through WMMA (tc_gemm.cuh):
//       fp32 inputs: S = Q K^T and O = P V in 3xTF32 (fp32 accuracy), S's
//         three terms in three accumulators, so its MMAs do not wait on
//         each other (a warp is bound by latency, not by the MMA rate);
//       bf16 inputs: S in one bf16 MMA (exact products, fp32 sums); P stays
//         fp32, split into TF32 hi and lo, and V (bf16, exact in TF32) is
//         widened once a tile into an fp32 copy: two TF32 products. P is
//         never rounded to bf16, so bf16 inputs keep fp32 tolerances.
//     K^T is K read in place as WMMA's col_major B operand: no transpose.
//   * a warp owns 16 query rows and a share of the key and channel tiles.
//     A block is wq query groups of 16 rows times wc warps a group (at most
//     8 warps); a group's wc warps split S's 16-key tiles, the softmax's
//     rows and P V's 16-channel tiles among them. A warp's tile counts are
//     template arguments (score_tiles, value_tiles), so the product loops
//     hold no branch and a step's B operands all load before its MMAs.
//     The launcher picks (wq, wc, bk) for the call so that the grid covers
//     the card (the occupancy calculator says how many blocks an SM
//     holds); attention_geometry() says what it picked.
//   * key tiles of bk (32 or 64) rows stream through a double buffer in
//     shared memory by cp.async in their storage type, the next tile in
//     flight while the current one is used; the query tile is staged once.
//     C is padded to cp, a multiple of 16, with zero columns in shared
//     memory; rows past Lq and Lk are zero and never stored; masked scores
//     are -1e30 and their p is 0, so the first correction is 0, never NaN.
//   * the online softmax with an opaque accumulator layout: O stays in
//     WMMA fragments across the whole key loop. The running max moves only
//     when a row's tile max exceeds it by more than kRescaleSlack (2^8 in
//     p), so p <= 256 and fp32 keeps every sum; when it moves, the warp
//     stores each O fragment to a 16x16 staging tile of its own, scales the
//     rows there and loads it back (correct for any fragment layout). Inputs
//     of ordinary scale move the max in the first tile only.
//   * three barriers a tile: the block when a tile has landed and when the
//     scores are in shared memory (bf16: and V's fp32 copy), the group when
//     P is. The softmax takes 2 wc lanes a row, max and sum by shuffles.
//   * block_q / block_k of the TPU kernel sized VMEM tiles of a sequential
//     grid; the wrapper keeps them for the signature only.
//
// Measured on an H100 (chip_smoke.py phase 9's sweep and ablation): the
// two products take about 80% of the time at L = 4096, well below the
// tensor cores' rate; each warp is bound by latency (time falls about in
// proportion to warps an SM), and registers and shared memory hold an SM
// to 8 warps.
//
// Shared memory (bytes, fp32 / bf16 inputs): Q 16 wq (cp + pad) s, two key
// tiles 2 bk (cp + pad) s (pad: 16 bytes a row, s the storage size), bf16
// only an fp32 copy of V bk (cp + 4) 4, the scores / P 16 wq (bk + 4) 4,
// one 16x20 fp32 staging tile a warp and m, l and the corrections. The
// largest geometry at C = 192 (wq = 4, wc = 2, bk = 64) takes 178,944 /
// 155,392; at C = 256 (wq = 2, wc = 4, bk = 64) 185,728 / 170,368; a block
// may take 232,448.
//
// Requirements: C % 8 == 0, 8 <= C <= 256, B, Lq, Lk >= 1, checked here;
// 16-byte aligned x, y and out, checked by the wrapper.
#include "cell_common.cuh"
#include "tc_gemm.cuh"

namespace {

constexpr int kMaxWarps = 8;      // warps a block
constexpr int kMaxGroups = 4;     // query groups of 16 rows a block (wq)
constexpr int kMaxKeyTiles = 2;   // 16-key score tiles a warp: bk / 16 / wc
// Per-thread arrays sized for the geometries the launcher allows, so that
// no register spills: at most 6 output tiles a warp (C = 256 takes four
// warps a group) and bk / 2 wc <= 16 scores a lane in the softmax.
constexpr int kMaxColTiles = 6;   // 16-channel output tiles a warp
constexpr int kMaxLaneKeys = 16;  // scores a lane holds in the softmax
constexpr int kStageLd = 20;      // floats a row of a warp's staging tile
constexpr int kDefaultSms = 132;  // H100 SXM, if the device cannot say
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
// log2 units by which a row's tile max may exceed its running max before
// the accumulator is rescaled
constexpr float kRescaleSlack = 8.f;
// the launcher's cost of one 16-key step of the softmax and the barriers,
// in the channel units of its products (2 cp a key)
constexpr long kKeyFixed = 64;

// The launch geometry of one call.
struct AttnGeom {
  int wq;      // query groups of 16 rows a block
  int wc;      // warps a group
  int bk;      // keys a tile: 32 or 64
  int cp;      // C rounded up to 16
  int qs, ks;  // elements a row of Q and of a key tile (storage type)
  int vs, ps;  // floats a row of V's fp32 copy and of the scores / P
  int nq;      // query blocks a sample: ceil(Lq / 16 wq)
  int blocks;  // B nq
};

// Byte offsets of the regions of dynamic shared memory, 128-aligned.
struct AttnSmem {
  size_t q, k, v, p, stage, stats, total;
};

size_t align128(size_t n) { return (n + 127) / 128 * 128; }

AttnGeom attn_geom(int B, int Lq, int C, int itemsize, int wq, int wc,
                   int bk) {
  AttnGeom g;
  g.wq = wq;
  g.wc = wc;
  g.bk = bk;
  g.cp = (C + 15) / 16 * 16;
  g.qs = g.cp + 16 / itemsize;
  g.ks = g.qs;
  g.vs = g.cp + 4;
  g.ps = bk + 4;
  g.nq = (Lq + 16 * wq - 1) / (16 * wq);
  const long blocks = static_cast<long>(B) * g.nq;
  g.blocks = blocks > 2147483647L ? -1 : static_cast<int>(blocks);
  return g;
}

AttnSmem attn_smem(const AttnGeom& g, int itemsize) {
  AttnSmem s;
  s.q = 0;
  s.k = s.q + align128(static_cast<size_t>(16) * g.wq * g.qs * itemsize);
  s.v = s.k + align128(static_cast<size_t>(2) * g.bk * g.ks * itemsize);
  s.p = s.v + (itemsize == 4 ? 0
                             : align128(static_cast<size_t>(g.bk) * g.vs * 4));
  s.stage = s.p + align128(static_cast<size_t>(16) * g.wq * g.ps * 4);
  s.stats = s.stage + align128(static_cast<size_t>(g.wq) * g.wc * 16 *
                               kStageLd * 4);
  s.total = s.stats + static_cast<size_t>(3) * 16 * g.wq * 4;
  return s;
}

__device__ __forceinline__ void zero16(void* p) {
  *reinterpret_cast<float4*>(p) = make_float4(0.f, 0.f, 0.f, 0.f);
}

// rows [0, n) of src (row stride C) into dst (row stride ld) by cp.async,
// 16 bytes a copy; the pad columns [C, cp) and the rows [n, rows) are
// zeroed by plain stores (never a cp.async target, so no race).
template <typename T>
__device__ void stage_rows(T* dst, const T* src, int n, int rows, int C,
                           int cp, int ld) {
  constexpr int kVec = 16 / sizeof(T);
  const int row_chunks = cp / kVec;
  for (int i = threadIdx.x; i < rows * row_chunks; i += blockDim.x) {
    const int r = i / row_chunks, c = (i - r * row_chunks) * kVec;
    if (r < n && c < C)
      cp_async16(dst + r * ld + c, src + static_cast<size_t>(r) * C + c);
    else
      zero16(dst + r * ld + c);
  }
}

// S = Q K^T for this warp's N key tiles j = wi + wc u (u < N), each
// 3xTF32 term in an accumulator of its own, stored to the group's scores.
// N is a template argument, so the loop holds no branch and every B
// operand of a step is loaded before its MMAs. Tiles past the tile's last
// key read zero rows; the softmax masks their scores.
template <typename T, int N>
__device__ __forceinline__ void score_tiles(const T* Qg, const T* K,
                                            float* Pg, const AttnGeom& g,
                                            int wi) {
  using Step = TcStep<T>;
  typename Step::Acc s[N][Step::kTerms];
#pragma unroll
  for (int u = 0; u < N; ++u)
#pragma unroll
    for (int e = 0; e < Step::kTerms; ++e) wmma::fill_fragment(s[u][e], 0.f);
#pragma unroll 2
  for (int c = 0; c < g.cp; c += Step::kK) {
    typename Step::A a;
    typename Step::BT bt[N];
    Step::load_a(a, Qg + c, g.qs);
#pragma unroll
    for (int u = 0; u < N; ++u)
      Step::load_b(bt[u], K + 16 * (wi + g.wc * u) * g.ks + c, g.ks);
#pragma unroll
    for (int u = 0; u < N; ++u) Step::mma_terms(s[u], a, bt[u]);
  }
#pragma unroll
  for (int u = 0; u < N; ++u) {
    Step::sum_terms(s[u]);
    wmma::store_matrix_sync(Pg + 16 * (wi + g.wc * u), s[u][0], g.ps,
                            wmma::mem_row_major);
  }
}

// o[u] += P V over the tile's first kn keys for this warp's N output tiles
// n = wi + wc u: 3xTF32 with V the fp32 key tile, or two TF32 products
// with V's fp32 copy of bf16 keys (exact in TF32).
template <typename T, int N>
__device__ __forceinline__ void value_tiles(TcStep<float>::Acc* o,
                                            const float* Pg, const float* V,
                                            int ldv, int kn,
                                            const AttnGeom& g, int wi) {
  using F32 = TcStep<float>;
#pragma unroll 2
  for (int kk = 0; kk < kn; kk += F32::kK) {
    typename F32::A pa;
    typename F32::B bv[N];
    F32::load_a(pa, Pg + kk, g.ps);
#pragma unroll
    for (int u = 0; u < N; ++u) {
      const float* p = V + kk * ldv + 16 * (wi + g.wc * u);
      if (sizeof(T) == 4)
        F32::load_b(bv[u], p, ldv);
      else
        F32::load_b_exact(bv[u], p, ldv);
    }
    if (sizeof(T) == 4)
      F32::mma(o, pa, bv);
    else
      F32::mma_exact_b(o, pa, bv);
  }
}

template <typename T>
__global__ void __launch_bounds__(32 * kMaxWarps)
    attention_kernel(const T* __restrict__ x, const T* __restrict__ y,
                     float* __restrict__ out, int Lq, int Lk, int C,
                     AttnGeom g, AttnSmem lay, float scale_log2) {
  extern __shared__ __align__(128) float smem[];
  using F32 = TcStep<float>;
  char* base = reinterpret_cast<char*>(smem);
  T* Qs = reinterpret_cast<T*>(base + lay.q);
  T* Kbuf = reinterpret_cast<T*>(base + lay.k);
  float* V32 = reinterpret_cast<float*>(base + lay.v);
  float* Ps = reinterpret_cast<float*>(base + lay.p);
  float* m_s = reinterpret_cast<float*>(base + lay.stats);
  float* l_s = m_s + 16 * g.wq;
  float* c_s = l_s + 16 * g.wq;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = warp / g.wc, wi = warp - grp * g.wc;
  const int b = blockIdx.x / g.nq;
  const int q0 = (blockIdx.x - b * g.nq) * 16 * g.wq;
  const int rows = min(16 * g.wq, Lq - q0);
  const T* yb = y + static_cast<size_t>(b) * Lk * C;
  const int ntiles = (Lk + g.bk - 1) / g.bk;
  const T* Qg = Qs + grp * 16 * g.qs;      // this warp's query rows
  float* Pg = Ps + grp * 16 * g.ps;        // ... their scores, then P
  float* stage = reinterpret_cast<float*>(base + lay.stage) +
                 warp * 16 * kStageLd;     // this warp's staging tile
  const int row0 = grp * 16;               // first of its rows in m, l, c

  // the query tile and key tile 0 in one cp.async group
  stage_rows(Qs, x + (static_cast<size_t>(b) * Lq + q0) * C, rows,
             16 * g.wq, C, g.cp, g.qs);
  stage_rows(Kbuf, yb, min(g.bk, Lk), g.bk, C, g.cp, g.ks);
  cp_async_commit();
  if (threadIdx.x < 16 * g.wq) {
    m_s[threadIdx.x] = kNegInf;
    l_s[threadIdx.x] = 0.f;
  }

  // O: output tiles n = wi + wc u of the group's 16 rows, ncols of them
  const int ncol = g.cp / 16, nkey = g.bk / 16;
  const int ncols = wi < ncol ? (ncol - wi + g.wc - 1) / g.wc : 0;
  typename F32::Acc o[kMaxColTiles];
#pragma unroll
  for (int u = 0; u < kMaxColTiles; ++u) wmma::fill_fragment(o[u], 0.f);

  // softmax: the warp's rows [r0, r0 + 16 / wc), lpr lanes a row
  const int lpr = 2 * g.wc, npl = g.bk / lpr;
  const int srow = wi * (16 / g.wc) + lane / lpr, sub = lane % lpr;

  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * g.bk, kn = min(g.bk, Lk - k0);
    cp_async_wait<0>();  // tile t has landed (this thread's copies)
    __syncthreads();     // ... and everyone's; tile t - 1 is consumed
    if (t + 1 < ntiles)
      stage_rows(Kbuf + ((t + 1) & 1) * g.bk * g.ks,
                 yb + static_cast<size_t>(k0 + g.bk) * C,
                 min(g.bk, Lk - k0 - g.bk), g.bk, C, g.cp, g.ks);
    cp_async_commit();
    const T* K = Kbuf + (t & 1) * g.bk * g.ks;

    if (sizeof(T) != 4) {  // V widened to fp32, exact in TF32
      const int c4 = g.cp / 4;
      for (int i = threadIdx.x; i < g.bk * c4; i += blockDim.x) {
        const int r = i / c4, c = 4 * (i - r * c4);
        store4(V32 + r * g.vs + c, load4(K + r * g.ks + c));
      }
    }

    // S = Q K^T for this warp's key tiles (nkey / wc of them)
    if (nkey == g.wc)
      score_tiles<T, 1>(Qg, K, Pg, g, wi);
    else
      score_tiles<T, 2>(Qg, K, Pg, g, wi);
    __syncthreads();  // the group's scores (and V's fp32 copy) are set

    // online softmax of row srow over the tile's keys sub + lpr e
    {
      float sv[kMaxLaneKeys];
      float* prow = Pg + srow * g.ps;
      float mx = kNegInf;
#pragma unroll
      for (int e = 0; e < kMaxLaneKeys; ++e) {
        if (e < npl) {
          const int key = sub + lpr * e;
          sv[e] = key < kn ? prow[key] * scale_log2 : kNegInf;
          mx = fmaxf(mx, sv[e]);
        }
      }
      for (int o2 = 1; o2 < lpr; o2 <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o2));
      const float m_old = m_s[row0 + srow];
      const float m_new = mx > m_old + kRescaleSlack ? mx : m_old;
      float sum = 0.f;
#pragma unroll
      for (int e = 0; e < kMaxLaneKeys; ++e) {
        if (e < npl) {
          const int key = sub + lpr * e;
          const float p = key < kn ? exp2f(sv[e] - m_new) : 0.f;
          prow[key] = p;
          sum += p;
        }
      }
      for (int o2 = 1; o2 < lpr; o2 <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o2);
      if (sub == 0) {  // every lane of the row has read m_old
        const float corr = exp2f(m_old - m_new);
        c_s[row0 + srow] = corr;
        l_s[row0 + srow] = fmaf(l_s[row0 + srow], corr, sum);
        m_s[row0 + srow] = m_new;
      }
    }
    group_sync(1 + grp, 32 * g.wc);  // the group's P and corrections

    // O = O corr + P V. A moved max rescales O through the staging tile.
    float moved = c_s[row0 + (lane & 15)] != 1.f ? 1.f : 0.f;
#pragma unroll
    for (int o2 = 1; o2 < 16; o2 <<= 1)
      moved = fmaxf(moved, __shfl_xor_sync(0xffffffffu, moved, o2));
    if (t > 0 && moved > 0.f) {  // at t = 0, O is zero
      const int r = lane >> 1, c = 8 * (lane & 1);
      const float corr = c_s[row0 + r];
#pragma unroll
      for (int u = 0; u < kMaxColTiles; ++u) {
        if (wi + g.wc * u < ncol) {
          wmma::store_matrix_sync(stage, o[u], kStageLd,
                                  wmma::mem_row_major);
          __syncwarp();
#pragma unroll
          for (int i = 0; i < 8; ++i) stage[r * kStageLd + c + i] *= corr;
          __syncwarp();
          wmma::load_matrix_sync(o[u], stage, kStageLd, wmma::mem_row_major);
          __syncwarp();
        }
      }
    }
    const float* V = sizeof(T) == 4 ? reinterpret_cast<const float*>(K)
                                    : V32;
    const int ldv = sizeof(T) == 4 ? g.ks : g.vs;
    switch (ncols) {
      case 1: value_tiles<T, 1>(o, Pg, V, ldv, kn, g, wi); break;
      case 2: value_tiles<T, 2>(o, Pg, V, ldv, kn, g, wi); break;
      case 3: value_tiles<T, 3>(o, Pg, V, ldv, kn, g, wi); break;
      case 4: value_tiles<T, 4>(o, Pg, V, ldv, kn, g, wi); break;
      case 5: value_tiles<T, 5>(o, Pg, V, ldv, kn, g, wi); break;
      case 6: value_tiles<T, 6>(o, Pg, V, ldv, kn, g, wi); break;
      default: break;  // a warp with no output tile (C < 16 wc)
    }
  }

  // out = O / l for the rows below Lq and the channels below C
  const int r = lane >> 1, c = 8 * (lane & 1);
  const int q = grp * 16 + r;
  const float inv = q < rows ? 1.f / l_s[row0 + r] : 0.f;
  float* orow = out + (static_cast<size_t>(b) * Lq + q0 + q) * C;
#pragma unroll
  for (int u = 0; u < kMaxColTiles; ++u) {
    const int n = wi + g.wc * u;
    if (n < ncol) {
      wmma::store_matrix_sync(stage, o[u], kStageLd, wmma::mem_row_major);
      __syncwarp();
      if (q < rows) {
#pragma unroll
        for (int i = 0; i < 8; i += 4) {
          const int col = 16 * n + c + i;
          if (col < C) {
            const float* v = stage + r * kStageLd + c + i;
            store4(orow + col,
                   make_float4(v[0] * inv, v[1] * inv, v[2] * inv,
                               v[3] * inv));
          }
        }
      }
      __syncwarp();
    }
  }
}

// The kernel may take every byte of shared memory a block can have; the
// occupancy calculator then sees each geometry's real share.
template <typename T>
cudaError_t allow_smem() {
  return cudaFuncSetAttribute(attention_kernel<T>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              kSmemLimit);
}

template <typename T>
int blocks_per_sm(int threads, size_t smem) {
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, attention_kernel<T>, threads, smem) != cudaSuccess)
    n = 0;
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

// The geometry of a call: wq, wc and bk as asked (0: the launcher picks).
// The launcher's cost of a geometry: the busiest SM runs ceil(blocks /
// SMs) blocks, k at a time (k from the occupancy calculator), each of
// whose warps does 1 / wc of its group's work; an SM runs 8 warps' worth
// at once. So cost = rounds x keys x (2 cp + kKeyFixed) x max(8, k wq wc)
// / wc. The first of wq = 4, 2, 1, wc = 1, 2, 4, bk = 64, 32 wins a tie.
// False if none fits.
template <typename T>
bool pick_geom(int B, int Lq, int Lk, int C, int wq_req, int wc_req,
               int bk_req, AttnGeom* out, int* occ_out) {
  const int nsm = sm_count();
  const int qgroups = (Lq + 15) / 16;
  bool found = false;
  long best = 0;
  for (int wq = kMaxGroups; wq >= 1; wq >>= 1) {
    if (wq_req ? wq != wq_req : wq > 1 && wq > qgroups) continue;
    for (int wc = 1; wc <= 4; wc <<= 1) {
      if (wc_req && wc != wc_req) continue;
      for (int bk = 64; bk >= 32; bk >>= 1) {
        if (bk_req && bk != bk_req) continue;
        const AttnGeom g = attn_geom(B, Lq, C, sizeof(T), wq, wc, bk);
        const int warps = wq * wc;
        if (warps > kMaxWarps || bk / 16 < wc ||
            bk / 16 > kMaxKeyTiles * wc ||
            (g.cp / 16 + wc - 1) / wc > kMaxColTiles || g.blocks < 1)
          continue;
        const size_t smem = attn_smem(g, sizeof(T)).total;
        if (smem > static_cast<size_t>(kSmemLimit)) continue;
        const int occ = blocks_per_sm<T>(32 * warps, smem);
        if (occ < 1) continue;
        const long per_sm = (g.blocks + nsm - 1) / nsm;
        const long k = per_sm < occ ? per_sm : occ;
        const long rounds = (per_sm + k - 1) / k;
        const int ntiles = (Lk + bk - 1) / bk;
        const int last = Lk - (ntiles - 1) * bk;
        const long keys = static_cast<long>(ntiles - 1) * bk +
                          (last + 15) / 16 * 16;
        const long par = k * warps > 8 ? k * warps : 8;
        const long cost =
            rounds * keys * (2L * g.cp + kKeyFixed) * par / wc;
        if (!found || cost < best) {
          *out = g;
          *occ_out = occ;
          best = cost;
          found = true;
        }
      }
    }
  }
  return found;
}

template <typename T>
int launch(const void* x, const void* y, float* out, int B, int Lq, int Lk,
           int C, int wq, int wc, int bk, cudaStream_t stream) {
  cudaError_t err = allow_smem<T>();
  if (err != cudaSuccess) return static_cast<int>(err);
  AttnGeom g;
  int occ = 0;
  if (!pick_geom<T>(B, Lq, Lk, C, wq, wc, bk, &g, &occ))
    return static_cast<int>(cudaErrorInvalidValue);
  const AttnSmem lay = attn_smem(g, sizeof(T));
  const size_t smem = lay.total;
  const int threads = 32 * g.wq * g.wc;
  const float scale_log2 = kLog2e / sqrtf(static_cast<float>(C));
  attention_kernel<T><<<g.blocks, threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(y), out, Lq, Lk, C, g,
      lay, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int geometry(int B, int Lq, int Lk, int C, int wq, int wc, int bk,
             int* geom) {
  cudaError_t err = allow_smem<T>();
  if (err != cudaSuccess) return static_cast<int>(err);
  AttnGeom g;
  int occ = 0;
  if (!pick_geom<T>(B, Lq, Lk, C, wq, wc, bk, &g, &occ))
    return static_cast<int>(cudaErrorInvalidValue);
  geom[0] = g.wq;
  geom[1] = g.wc;
  geom[2] = g.bk;
  geom[3] = 32 * g.wq * g.wc;
  geom[4] = g.blocks;
  geom[5] = occ;
  geom[6] = static_cast<int>(attn_smem(g, sizeof(T)).total);
  return 0;
}

bool pow2_upto(int v, int hi) { return v >= 0 && v <= hi && !(v & (v - 1)); }

bool valid_call(int B, int Lq, int Lk, int C, int wq, int wc, int bk) {
  return B >= 1 && Lq >= 1 && Lk >= 1 && C % 8 == 0 && C >= 8 && C <= 256 &&
         pow2_upto(wq, kMaxGroups) && pow2_upto(wc, 4) &&
         (bk == 0 || bk == 32 || bk == 64);
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory of four query groups of two warps and
// 64-key tiles at this C: no geometry the launcher allows takes more.
size_t attention_smem_bytes(int C, int itemsize) {
  return attn_smem(attn_geom(1, 1, C, itemsize, kMaxGroups, 2, 64), itemsize)
      .total;
}

const char* attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The geometry a call would take: geom = {wq, wc, bk, threads, blocks,
// blocks an SM, smem bytes}. wq (1, 2, 4), wc (1, 2, 4) and bk (32, 64)
// fix it; 0 lets the launcher pick. Returns 0, or cudaErrorInvalidValue if
// no geometry fits.
int attention_geometry(int B, int Lq, int Lk, int C, int itemsize, int wq,
                       int wc, int bk, int* geom) {
  if (!valid_call(B, Lq, Lk, C, wq, wc, bk))
    return static_cast<int>(cudaErrorInvalidValue);
  if (itemsize == 4) return geometry<float>(B, Lq, Lk, C, wq, wc, bk, geom);
  if (itemsize == 2)
    return geometry<__nv_bfloat16>(B, Lq, Lk, C, wq, wc, bk, geom);
  return static_cast<int>(cudaErrorInvalidValue);
}

// attention_forward with the geometry fixed: wq, wc and bk as for
// attention_geometry, 0 letting the launcher pick.
int attention_forward_geometry(int dtype, const void* x, const void* y,
                               void* out, int B, int Lq, int Lk, int C,
                               int wq, int wc, int bk, void* stream) {
  if (!valid_call(B, Lq, Lk, C, wq, wc, bk))
    return static_cast<int>(cudaErrorInvalidValue);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, y, o, B, Lq, Lk, C, wq, wc, bk, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, y, o, B, Lq, Lk, C, wq, wc, bk, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// dtype: 0 = fp32, 1 = bf16 (x and y); out is fp32 (B, Lq, C). The launcher
// picks the geometry. Returns the CUDA error code of the launch (0 on
// success).
int attention_forward(int dtype, const void* x, const void* y, void* out,
                      int B, int Lq, int Lk, int C, void* stream) {
  return attention_forward_geometry(dtype, x, y, out, B, Lq, Lk, C, 0, 0, 0,
                                    stream);
}

}  // extern "C"
