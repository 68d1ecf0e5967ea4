// Eval-mode found fusion cell (FoundNodeCell) as CUDA kernels for Hopper.
//
// Replaces bmnas_tpu/ops/kernels/node_mixed.py::found_node_cell_multi_fused
// (the Pallas TPU kernel). Per sample it computes:
//   (a) S <= 4 chained inner steps. Step s reads two states picked by static
//       skip/none edges (a 'none' edge reads zeros) and runs one branch:
//         0 Sum        x + y
//         1 Attention  softmax(x y^T / sqrt(C)) y, then per-sample LayerNorm
//                      over (L, C) with a per-position affine
//         2 GLU        [x|y] W + b (BN folded), a * sigmoid(g)
//         3 ConcatFC   relu([x|y] W + b) (BN folded)
//   (b) m != 1: relu(concat(last m states) W_oc + b_oc) (BN folded);
//   (c) + x (the cell's first input), then per-sample LayerNorm.
// States are numbered x = 0, y = 1, step s's output s + 2, the out-conv's
// output S + 2.
//
// What bounds it on an H100: at the serving batches (B = 8, L = 16, C = 192
// and B = 96, L = 8, C = 128) a GLU step is 38-101 MFLOP on 0.26-0.59 MB of
// fp32 weights, and a whole cell moves a few MB at most: 0.1-4 us at the
// card's rates (0.4-0.6 us on the tensor cores), less than one launch. So the
// time is latency: how many SMs share each product, how soon the weights
// arrive, and how long each block's chain of dependent steps is.
//
// Two designs, a kernel each:
//   * the whole cell in one block a sample (kWhole, cell_whole.cuh): every
//     state in shared memory, the GEMMs in fp32 FMA with the weights
//     streamed in K-tiles, one launch. A GLU step at C = 192 takes ~38 us
//     whatever B, since one SM runs a sample's chain.
//   * the phases, below: each GEMM spread over the card, a launch a phase.
//   The launcher takes the phases where they gain: for a cell with a GEMM
//   step or an out-conv while B leaves more than half of the card's SMs
//   idle (2 B < SMs). Where B blocks already fill the card, or the cell
//   has no GEMM to spread, it takes one block a sample. On the H100
//   (NVIDIA H100 80GB HBM3, 700.00 W, chip_smoke.py phase 3) the phases
//   took a GLU cell at B = 8 from 38.2 to 19.0 us, but at B = 96, where
//   one block a sample fills 96 SMs, they were slower in every cell with a
//   GEMM (LinearGLU 60.8 against 39.3 us), and a cell without one ran 3-15%
//   faster in one block a sample at every B.
//
// The phases:
//   * A later step, the out-conv and the final LayerNorm each need
//     every column of a GEMM's output, so the host cuts the cell's static
//     plan into phases at its GEMM outputs, one launch each: a phase a GLU
//     or ConcatFC step and one for the out-conv. The last GEMM phase ends the
//     cell: each of its blocks writes its columns, takes a ticket for its
//     sample group, and the group's last block adds x and runs the
//     per-sample LayerNorm over the group's whole rows (variance E[(v -
//     mean)^2], in a fixed order whichever block is last). A step after the
//     last GEMM keeps a last phase of its own (a block of 256 threads a
//     sample); a cell with no GEMM and m = 1 (Sum, ScaleDotAttn) is that one
//     phase. One kernel runs every phase: a host loop launches it once a
//     phase on the caller's stream, with that phase's plan as an argument;
//     kernel boundaries order the phases.
//   * the non-GEMM steps (Sum; attention + LayerNorm) run in the blocks of
//     the phase that reads them, whole, for those blocks' own samples, as
//     the mixed op computes its attention in every column tile. A state that
//     a later phase reads again is written to device memory by the blocks of
//     column tile 0 only.
//   * a GEMM phase has the mixed op's geometry (cell_gemm.cuh): a block owns
//     S whole samples (1, 2 or 4) and a tile of nt output columns (16 or 32;
//     for GLU the value columns and their gate columns), blockIdx.x = group
//     * tiles + tile, the launcher picking (S, nt) and the weight layout from
//     B, L and C by waves (occupancy calculator) times block work. 512
//     threads: 8 warps stream the block's weight columns by cp.async (whole
//     in shared memory, or a ring of K-tiles; every K-tile in flight from
//     the start when the slab fits) and run the product on the tensor cores
//     through WMMA: 3xTF32 for fp32 storage (about fp32 accuracy), bf16 MMA
//     with fp32 accumulation for bf16. The other 8 warps meanwhile stage the
//     block's states, run its non-GEMM steps and build the operand A =
//     [sources] (S L rows), which they hand over at a named barrier. The
//     epilogue adds the bias, takes a * sigmoid(g) or the ReLU, and writes
//     the block's columns once.
//   * intermediate states live in a scratch buffer that the wrapper
//     allocates: (S + 1) x B x L x C in fp32 whatever the storage type
//     (states 2 .. S + 2), at most 2.4 MB at B = 96, so a state stays in L2
//     from one phase to the next. The tickets (B ints a stream) are 0 before
//     and after a call. No atomics on sums: every element is written once,
//     so the cell is deterministic bit for bit.
//   * in a block, the states it reads or computes sit in shared memory in
//     fp32, each row padded by kPad floats so that the attention's reads of
//     neighbouring rows fall in different banks; bf16 storage rounds a state
//     to bf16 only where it is an MMA operand.
//   * what the design does about latency: every load of a block is issued
//     before it waits (cp.async; bf16 x and y land as they are and are
//     widened in shared memory), the biases and the LayerNorm's affine
//     among them; the weights are in flight while the staging warps work;
//     the work of a phase is spread over the card. On the H100 (NVIDIA H100
//     80GB HBM3, 700.00 W) a phase still costs about 6-8 us whatever its
//     work, and the code a phase runs counts: rolling the loops of the last
//     phase took the ScaleDotAttn cell from 24.4 to 17.3 us, so the paths
//     keep their loops over states and samples rolled. Where B alone fills
//     the card (B = 96) a phase's product takes up to 3 waves of blocks;
//     blocks of whole rows, the whole cell in one launch, were slower still
//     (LinearGLU at B = 96: 99 us), with the 3xTF32 WMMA loop at about a
//     tenth of the TF32 rate. There the launcher takes one block a sample.
//
// Requirements: C % 8 == 0, 8 <= C <= 256, and a geometry whose shared
// memory fits (in a GEMM phase at most 256 rows a block, so L <= 256; the
// launcher takes one block a sample only where it fits), checked here;
// 16-byte aligned tensors, a scratch of (S + 1) B L C floats and B zeroed
// int tickets, checked by the wrapper.
#include <cstring>
#include <mutex>
#include <type_traits>

#include "cell_whole.cuh"

namespace {

constexpr int kMaxSteps = 4;
// states: x, y, one a step and the out-conv's output
constexpr int kMaxStates = kMaxSteps + 3;
// phases: one a GEMM step, the out-conv's and the last one
constexpr int kMaxPhases = kMaxSteps + 2;
constexpr int kPad = 4;  // floats after each row of a state in shared memory
enum PhaseKind { kFinal = 0, kGlu = 1, kFc = 2, kOutConv = 3, kWhole = 4 };
// a call's design: the launcher's pick, the phases, or the whole cell in one
// block a sample
enum Design { kDesignAuto = 0, kDesignPhases = 1, kDesignWhole = 2 };

template <typename T>
struct CellParams {
  const T *ln1_s, *ln1_b;  // (S, L, C)
  const T *glu_w, *glu_b;  // (S, 2C, 2C), (S, 2C)
  const T *cfc_w, *cfc_b;  // (S, 2C, C), (S, C)
  const T *oc_w, *oc_b;    // (m C, C), (C); unused when m == 1
  const T *ln2_s, *ln2_b;  // (L, C)
};

struct CellSteps {
  int S, m;
  int branch[kMaxSteps];
  int src_x[kMaxSteps];  // state index, -1 for a 'none' edge
  int src_y[kMaxSteps];
};

// One phase of the plan, with its launch geometry and shared-memory layout.
struct FoundPhase {
  int kind;              // PhaseKind
  int step;              // kGlu, kFc: the GEMM's step
  int first, last;       // the non-GEMM steps [first, last) a block runs
  int nsrc;              // the GEMM's sources (2, or m for the out-conv)
  int src[kMaxStates];   // their states (-1: zeros)
  int K, Kp;             // the GEMM's depth nsrc C, and rounded up to an MMA step
  int dst;               // the state the GEMM writes; kFinal: o, read with x
  int slot[kMaxStates + 1];  // shared-memory slot of state k at k + 1 (of
                             // the zeros at 0); -1: none
  int nslots;
  int nraw;              // x and y among the states read into slots
  bool attn;             // a non-GEMM step is an attention
  bool fused;            // a GEMM phase that ends the cell: the residual and
                         // the LayerNorm of its group's rows by the group's
                         // last block
  unsigned load;         // bit k: state k is read into its slot
  unsigned store;        // bit k: state k, made here, is written (tile 0)
  GemmGeom g;            // kFinal: S = 1, one tile, B groups
  int blocks, threads, occ;
  // byte offsets of the shared-memory regions, and the bytes
  size_t local, raw, att, scores, stats, prm, xs, ln, a, ring, smem;
};

// floats of the statistics region: mean and rstd a sample, then a slot a
// warp and sample for the reductions
constexpr int kStatFloats = (2 + kThreads / 32) * kMaxSamples;


// The block's rows of state k in device memory (k >= 2: in the scratch).
template <typename T>
__device__ __forceinline__ const T* input_rows(const T* x, const T* y,
                                               int k, size_t gbase) {
  return (k ? y : x) + gbase;
}
__device__ __forceinline__ float* scratch_rows(float* scratch, int k,
                                               size_t BLC, size_t gbase) {
  return scratch + (k - 2) * BLC + gbase;
}

// Rows [0, rows) of a state (C elements a row, contiguous) into dst (ldd
// elements a row), by the staging group (tid its thread's index in it): by
// cp.async where the types match, else by loads that a thread issues four at
// a time before it converts and stores them.
template <typename D, typename Src>
__device__ void copy_rows(D* dst, int ldd, const Src* src, int rows, int C,
                          int tid) {
  if constexpr (std::is_same<D, Src>::value) {
    constexpr int kVec = 16 / sizeof(D);
    const int per = C / kVec;
    for (int q = tid; q < rows * per; q += kAttnThreads) {
      const int r = q / per, c = (q - r * per) * kVec;
      cp_async16(dst + r * ldd + c, src + static_cast<size_t>(r) * C + c);
    }
  } else {
    constexpr int kU = 4;
    const int per = C / 4, n = rows * per;
    for (int q0 = tid; q0 < n; q0 += kU * kAttnThreads) {
      float4 v[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int q = q0 + u * kAttnThreads, r = q / per;
        if (q < n) v[u] = load4(src + static_cast<size_t>(r) * C + (q - r * per) * 4);
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int q = q0 + u * kAttnThreads, r = q / per;
        if (q < n) store4(dst + r * ldd + (q - r * per) * 4, v[u]);
      }
    }
  }
}

// Columns [c0, c1) of rows [r0, r1) of dst (ldd elements a row) set to 0;
// c0, c1 multiples of 4.
template <typename D>
__device__ void zero_cols(D* dst, int ldd, int r0, int r1, int c0, int c1,
                          int tid) {
  const int per = (c1 - c0) / 4, n = (r1 - r0) * per;
  for (int q = tid; q < n; q += kAttnThreads) {
    const int r = q / per;
    store4(dst + (r0 + r) * ldd + c0 + (q - r * per) * 4,
           make_float4(0.f, 0.f, 0.f, 0.f));
  }
}

// dst = (v - mean) rstd scale + bias for the rows of ns samples of L rows:
// v with ldv elements a row, dst with ldd, scale and bias (L, C) a
// position, mean and rstd of sample s at stats[s], stats[kMaxSamples + s].
// A thread issues its scale and bias loads four positions at a time.
template <typename P, typename D>
__device__ void ln_rows(const float* v, int ldv, int ns, int L, int C,
                        const P* scale, const P* bias, const float* stats,
                        D* dst, int ldd, int tid) {
  constexpr int kU = 4;
  const int per = C / 4, n = ns * L * per;
  for (int q0 = tid; q0 < n; q0 += kU * kAttnThreads) {
    float4 gs[kU], bs[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int q = q0 + u * kAttnThreads, r = q / per;
      if (q < n) {
        const int pos = (r % L) * C + (q - r * per) * 4;
        gs[u] = load4(scale + pos);
        bs[u] = load4(bias + pos);
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int q = q0 + u * kAttnThreads, r = q / per;
      if (q >= n) continue;
      const int c = (q - r * per) * 4, s = r / L;
      const float mean = stats[s], rstd = stats[kMaxSamples + s];
      const float4 a = load4(v + r * ldv + c);
      store4(dst + r * ldd + c,
             make_float4((a.x - mean) * rstd * gs[u].x + bs[u].x,
                         (a.y - mean) * rstd * gs[u].y + bs[u].y,
                         (a.z - mean) * rstd * gs[u].z + bs[u].z,
                         (a.w - mean) * rstd * gs[u].w + bs[u].w));
    }
  }
}

// The GEMM thread's copier of the phase's weight columns: the values and
// the gates of a GLU step, or the one set of a ConcatFC step or the
// out-conv; rows past K are zeros.
template <typename T>
__device__ TileCopier<T> phase_copier(const CellParams<T>& p,
                                      const FoundPhase& P, int C, int n0) {
  const T* srcs[kMaxSets] = {p.oc_w, p.oc_w, p.oc_w};
  int strides[kMaxSets] = {C, C, C};
  int sets = 1;
  if (P.kind == kGlu) {
    const T* w = p.glu_w + static_cast<size_t>(P.step) * 4 * C * C;
    srcs[0] = w;
    srcs[1] = w + C;
    strides[0] = strides[1] = 2 * C;
    sets = 2;
  } else if (P.kind == kFc) {
    srcs[0] = p.cfc_w + static_cast<size_t>(P.step) * 2 * C * C;
  }
  return tile_copier(srcs, strides, sets, P.g.nt, C, n0, P.K);
}

// v summed over the staging group, returned to each of its threads (tid
// its index in the group); two barriers of the group.
__device__ float group_sum(float v, int tid, float* red) {
  v = warp_sum(v);
  if ((tid & 31) == 0) red[tid >> 5] = v;
  group_sync(kBarAttn, kAttnThreads);
  float t = 0.f;
  for (int w = 0; w < kAttnWarps; ++w) t += red[w];
  group_sync(kBarAttn, kAttnThreads);  // red is free again
  return t;
}

// The LayerNorm mean and rstd of each of ns samples of LC values (v, one
// sample after the other) into stats[s], stats[kMaxSamples + s], a sample
// at a time (a short loop, not one unrolled for the most samples a block);
// every thread of the staging group leaves with them in place.
__device__ void sample_stats(const float* v, int ns, int LC, float eps,
                             int tid, float* stats) {
  float* red = stats + 2 * kMaxSamples;
#pragma unroll 1
  for (int s = 0; s < ns; ++s) {
    const float* w = v + s * LC;
    float sum = 0.f;
    for (int i = 4 * tid; i < LC; i += 4 * kAttnThreads) {
      const float4 a = load4(w + i);
      sum += (a.x + a.y) + (a.z + a.w);
    }
    const float mean = group_sum(sum, tid, red) / LC;
    float sq = 0.f;
    for (int i = 4 * tid; i < LC; i += 4 * kAttnThreads) {
      const float4 a = load4(w + i);
      const float dx = a.x - mean, dy = a.y - mean, dz = a.z - mean,
                  dw = a.w - mean;
      sq += (dx * dx + dy * dy) + (dz * dz + dw * dw);
    }
    const float rstd = rsqrtf(group_sum(sq, tid, red) / LC + eps);
    if (tid == 0) {
      stats[s] = mean;
      stats[kMaxSamples + s] = rstd;
    }
  }
  group_sync(kBarAttn, kAttnThreads);  // the statistics are in
}

// The staging group (tid its thread's index in it; all of a last-phase
// block): the block's states into shared memory, its non-GEMM steps, then in
// a GEMM phase the states later phases read (tile 0) and the operand A.
template <typename T>
__device__ void stage_phase(const T* x, const T* y, float* scratch,
                            const CellParams<T>& p, const CellSteps& cs,
                            const FoundPhase& P, char* base, int tile, int ns,
                            size_t gbase, size_t BLC, int L, int C, float eps,
                            int tid) {
  const GemmGeom& g = P.g;
  const bool gemm = P.kind != kFinal;
  const int nrows = ns * L, ldl = C + kPad, LC = L * C, per = C / 4;
  float* local = reinterpret_cast<float*>(base + P.local);
  float* stats = reinterpret_cast<float*>(base + P.stats);
  T* A = reinterpret_cast<T*>(base + P.a);
  const int cap = g.S * L * ldl;  // floats of a slot
  auto slot = [&](int k) { return local + P.slot[k + 1] * cap; };

  // 1. the zeros, the states read here, the parts of A that come from
  // device memory and the epilogue's parameters, every copy issued before
  // any wait
  if (P.slot[0] >= 0) zero_cols(slot(-1), ldl, 0, nrows, 0, C, tid);
  if (!gemm || P.fused) {  // the LayerNorm's affine
    T* ln = reinterpret_cast<T*>(base + P.ln);
    copy_rows(ln, C, p.ln2_s, L, C, tid);
    copy_rows(ln + LC, C, p.ln2_b, L, C, tid);
  }
  if (P.fused)  // the residual's rows
    copy_rows(reinterpret_cast<T*>(base + P.xs), C, x + gbase, nrows, C, tid);
  if (gemm) load_bias(p, P, reinterpret_cast<T*>(base + P.prm), C, tile, tid);
  // x and y in bf16 land as they are, to be widened after the wait
  T* raw = reinterpret_cast<T*>(base + P.raw);
  const bool widen = sizeof(T) != sizeof(float);
#pragma unroll 1
  for (int k = 0, j = 0; k < kMaxStates; ++k) {
    if (!(P.load >> k & 1)) continue;
    if (k < 2 && widen)
      copy_rows(raw + (j++) * g.S * L * C, C, input_rows(x, y, k, gbase),
                nrows, C, tid);
    else if (k < 2)
      copy_rows(slot(k), ldl, input_rows(x, y, k, gbase), nrows, C, tid);
    else
      copy_rows(slot(k), ldl, scratch_rows(scratch, k, BLC, gbase), nrows,
                C, tid);
  }
  if (gemm) {
#pragma unroll 1
    for (int j = 0; j < P.nsrc; ++j) {
      const int k = P.src[j];
      if (k < 0)
        zero_cols(A, g.lda, 0, nrows, j * C, (j + 1) * C, tid);
      else if (P.slot[k + 1] < 0 && k < 2)
        copy_rows(A + j * C, g.lda, input_rows(x, y, k, gbase), nrows, C,
                  tid);
      else if (P.slot[k + 1] < 0)
        copy_rows(A + j * C, g.lda, scratch_rows(scratch, k, BLC, gbase),
                  nrows, C, tid);
    }
    zero_cols(A, g.lda, 0, nrows, P.K, P.Kp, tid);  // pad to an MMA step
    zero_cols(A, g.lda, nrows, g.rows, 0, P.Kp, tid);  // rows past the last
  }
  cp_async_commit();
  cp_async_wait<0>();                  // this thread's copies have landed
  group_sync(kBarAttn, kAttnThreads);  // ... and the group's
  if (widen && P.nraw > 0) {
#pragma unroll 1
    for (int k = 0, j = 0; k < 2; ++k) {
      if (!(P.load >> k & 1)) continue;
      const T* s = raw + (j++) * g.S * L * C;
      float* d = slot(k);
      for (int q = tid; q < nrows * per; q += kAttnThreads) {
        const int r = q / per, c = (q - r * per) * 4;
        store4(d + r * ldl + c, load4(s + r * C + c));
      }
    }
    group_sync(kBarAttn, kAttnThreads);
  }

  // 2. the non-GEMM steps, in order
#pragma unroll 1
  for (int s = P.first; s < P.last; ++s) {
    const float* a = slot(cs.src_x[s]);
    const float* b = slot(cs.src_y[s]);
    float* d = slot(s + 2);
    if (cs.branch[s] == 0) {
      for (int q = tid; q < nrows * per; q += kAttnThreads) {
        const int r = q / per, o = r * ldl + (q - r * per) * 4;
        const float4 u = load4(a + o), v = load4(b + o);
        store4(d + o, make_float4(u.x + v.x, u.y + v.y, u.z + v.z, u.w + v.w));
      }
    } else {
      float* att = reinterpret_cast<float*>(base + P.att);
      attention_rows(a, b, ldl, L, C, ns, tid, att,
                     reinterpret_cast<float*>(base + P.scores));
      sample_stats(att, ns, LC, eps, tid, stats);
      ln_rows(att, C, ns, L, C, p.ln1_s + s * LC, p.ln1_b + s * LC, stats,
              d, ldl, tid);
    }
    group_sync(kBarAttn, kAttnThreads);
  }
  if (!gemm) return;

  // 3. the states a later phase reads, once (column tile 0), and A's
  // sources that are in shared memory
  if (tile == 0) {
#pragma unroll 1
    for (int k = 2; k < kMaxStates; ++k) {
      if (!(P.store >> k & 1)) continue;
      const float* v = slot(k);
      float* d = scratch_rows(scratch, k, BLC, gbase);
      for (int q = tid; q < nrows * per; q += kAttnThreads) {
        const int r = q / per, c = (q - r * per) * 4;
        store4(d + r * C + c, load4(v + r * ldl + c));
      }
    }
  }
#pragma unroll 1
  for (int j = 0; j < P.nsrc; ++j) {
    const int k = P.src[j];
    if (k < 0 || P.slot[k + 1] < 0) continue;
    const float* v = slot(k);
    for (int q = tid; q < nrows * per; q += kAttnThreads) {
      const int r = q / per, c = (q - r * per) * 4;
      store4(A + r * g.lda + j * C + c, load4(v + r * ldl + c));
    }
  }
}

// The last phase, a sample a block (tid: the thread's index): v = o + x in
// o's slot, its LayerNorm statistics, then the output rows with the affine
// staged in shared memory.
template <typename T>
__device__ void final_norm(const FoundPhase& P, char* base, T* out, int L,
                           int C, float eps, int tid) {
  const int ldl = C + kPad, LC = L * C, per = C / 4;
  float* local = reinterpret_cast<float*>(base + P.local);
  float* red = reinterpret_cast<float*>(base + P.stats) + 2 * kMaxSamples;
  float* v = local + P.slot[P.dst + 1] * L * ldl;
  const float* xs = local + P.slot[1] * L * ldl;
  float sum = 0.f;
  for (int q = tid; q < L * per; q += kAttnThreads) {
    const int r = q / per, o = r * ldl + (q - r * per) * 4;
    const float4 a = load4(v + o), b = load4(xs + o);
    const float4 w = make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
    store4(v + o, w);
    sum += (w.x + w.y) + (w.z + w.w);
  }
  const float mean = group_sum(sum, tid, red) / LC;
  float sq = 0.f;
  for (int q = tid; q < L * per; q += kAttnThreads) {
    const int r = q / per;
    const float4 a = load4(v + r * ldl + (q - r * per) * 4);
    const float dx = a.x - mean, dy = a.y - mean, dz = a.z - mean,
                dw = a.w - mean;
    sq += (dx * dx + dy * dy) + (dz * dz + dw * dw);
  }
  const float rstd = rsqrtf(group_sum(sq, tid, red) / LC + eps);
  const T* ln = reinterpret_cast<const T*>(base + P.ln);
  for (int q = tid; q < L * per; q += kAttnThreads) {
    const int r = q / per, c = (q - r * per) * 4;
    const float4 a = load4(v + r * ldl + c), g = load4(ln + r * C + c);
    const float4 b = load4(ln + LC + r * C + c);
    store4(out + r * C + c, make_float4((a.x - mean) * rstd * g.x + b.x,
                                        (a.y - mean) * rstd * g.y + b.y,
                                        (a.z - mean) * rstd * g.z + b.z,
                                        (a.w - mean) * rstd * g.w + b.w));
  }
}

// The GEMM epilogue's biases for the block's columns into prm by cp.async
// (zeros past C): the values' (and a GLU's gates' after them), nt each.
template <typename T>
__device__ void load_bias(const CellParams<T>& p, const FoundPhase& P,
                          T* prm, int C, int tile, int tid) {
  constexpr int kVec = 16 / sizeof(T);
  const int nt = P.g.nt, n0 = tile * nt, seg = nt / kVec;
  const T* bias = P.kind == kGlu  ? p.glu_b + P.step * 2 * C
                  : P.kind == kFc ? p.cfc_b + P.step * C
                                  : p.oc_b;
  for (int q = tid; q < P.g.sets * seg; q += kAttnThreads) {
    const int s = q / seg, c = (q - s * seg) * kVec, n = n0 + c;
    T* d = prm + s * nt + c;
    if (n < C)
      cp_async16(d, bias + s * C + n);
    else
      *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// The fused phase's end, in the group's last block (all kThreads threads),
// a sample at a time: v = o + x over the sample's whole rows (o from the
// scratch, where every block of the group wrote its columns), its
// LayerNorm, the output rows. Sums run in a fixed order, whichever block
// is last.
template <typename T>
__device__ void fused_norm(const float* o, const FoundPhase& P, char* base,
                           T* out, int ns, int L, int C, float eps) {
  const int LC = L * C;
  float* v = reinterpret_cast<float*>(base + P.ring);  // the GEMM is done
  const T* xs = reinterpret_cast<const T*>(base + P.xs);
  const T* ln = reinterpret_cast<const T*>(base + P.ln);
  float* red = reinterpret_cast<float*>(base + P.stats) + 2 * kMaxSamples;
#pragma unroll 1
  for (int s = 0; s < ns; ++s) {
    const int s0 = s * LC;
    float sum = 0.f;
    for (int i = 4 * threadIdx.x; i < LC; i += 4 * kThreads) {
      const float4 a = __ldcg(reinterpret_cast<const float4*>(o + s0 + i));
      const float4 b = load4(xs + s0 + i);
      const float4 w = make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
      store4(v + s0 + i, w);
      sum += (w.x + w.y) + (w.z + w.w);
    }
    const float mean = block_sum(sum, red) / LC;
    float sq = 0.f;
    for (int i = 4 * threadIdx.x; i < LC; i += 4 * kThreads) {
      const float4 a = load4(v + s0 + i);
      const float dx = a.x - mean, dy = a.y - mean, dz = a.z - mean,
                  dw = a.w - mean;
      sq += (dx * dx + dy * dy) + (dz * dz + dw * dw);
    }
    const float rstd = rsqrtf(block_sum(sq, red) / LC + eps);
    for (int i = 4 * threadIdx.x; i < LC; i += 4 * kThreads) {
      const float4 a = load4(v + s0 + i), g = load4(ln + i);
      const float4 b = load4(ln + LC + i);
      store4(out + s0 + i, make_float4((a.x - mean) * rstd * g.x + b.x,
                                       (a.y - mean) * rstd * g.y + b.y,
                                       (a.z - mean) * rstd * g.z + b.z,
                                       (a.w - mean) * rstd * g.w + b.w));
    }
  }
}

// The whole cell of sample blockIdx.x in one block (the kWhole phase;
// blockDim.x = 2 round32(C)): every state in shared memory in fp32, the
// weights streamed in K-tiles of kt rows (cell_whole.cuh). A kernel of its
// own, so that its registers and code are its own: as a path of
// found_cell_kernel it ran 3-13% slower in bf16 on the H100. A block may
// take an SM's registers (128 a thread at 512 threads).
template <typename T>
__global__ void __launch_bounds__(512, 1)
    whole_cell_kernel(const T* __restrict__ x, const T* __restrict__ y,
                      T* __restrict__ out, CellParams<T> p, CellSteps cs,
                      int kt, int L, int C, float eps) {
  extern __shared__ __align__(128) float smem[];
  const int LC = L * C, lc = round4(LC), S = cs.S;
  float* zero = smem;
  float* states = zero + lc;  // state k at states + k * lc
  float* obuf = states + (2 + S) * lc;
  float* stage = obuf + lc;
  float* scores = stage + (cs.m > 2 ? cs.m : 2) * C * kRowTile;
  float* red = scores + round4(L * L);
  T* wbuf = reinterpret_cast<T*>(red + 32);

  const size_t base = static_cast<size_t>(blockIdx.x) * LC;
  for (int i = 4 * threadIdx.x; i < LC; i += 4 * blockDim.x) {
    store4(zero + i, make_float4(0.f, 0.f, 0.f, 0.f));
    store4(states + i, load4(x + base + i));
    store4(states + lc + i, load4(y + base + i));
  }
  __syncthreads();

  const float* srcs[kMaxStates];
  for (int s = 0; s < S; ++s) {
    srcs[0] = cs.src_x[s] < 0 ? zero : states + cs.src_x[s] * lc;
    srcs[1] = cs.src_y[s] < 0 ? zero : states + cs.src_y[s] * lc;
    float* dst = states + (2 + s) * lc;
    switch (cs.branch[s]) {
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
                            p.glu_b + s * 2 * C, L, C, dst, wbuf, kt);
        break;
      default:
        dense_step<T, false>(stage, srcs, 2,
                             p.cfc_w + static_cast<size_t>(s) * 2 * C * C,
                             p.cfc_b + s * C, L, C, dst, wbuf, kt);
        break;
    }
    __syncthreads();
  }

  const float* o = states + (1 + S) * lc;
  if (cs.m != 1) {
    for (int k = 0; k < cs.m; ++k) srcs[k] = states + (2 + S - cs.m + k) * lc;
    dense_step<T, false>(stage, srcs, cs.m, p.oc_w, p.oc_b, L, C, obuf, wbuf,
                         kt);
    o = obuf;
  }
  for (int i = 4 * threadIdx.x; i < LC; i += 4 * blockDim.x) {
    const float4 a = load4(o + i), b = load4(states + i);
    store4(obuf + i, make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w));
  }
  __syncthreads();
  layer_norm(obuf, LC, p.ln2_s, p.ln2_b, eps, red, out + base);
}

// One phase of the cell (P); blockIdx.x = group * tiles + tile.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    found_cell_kernel(const T* x, const T* y, T* __restrict__ out,
                      float* scratch, int* tickets, CellParams<T> p,
                      CellSteps cs, FoundPhase P, int B, int L, int C,
                      float eps) {
  extern __shared__ __align__(128) float smem[];
  char* base = reinterpret_cast<char*>(smem);
  const GemmGeom& g = P.g;
  const bool gemm = P.kind != kFinal;
  const int bid = blockIdx.x;
  const int group = bid / g.tiles, tile = bid - group * g.tiles;
  const int b0 = group * g.S, ns = min(g.S, B - b0), nrows = ns * L;
  const int n0 = tile * g.nt;
  const size_t gbase = static_cast<size_t>(b0) * L * C;
  const size_t BLC = static_cast<size_t>(B) * L * C;
  T* ring = reinterpret_cast<T*>(base + P.ring);
  float* res = reinterpret_cast<float*>(base + P.ring);  // after the GEMM

  if (gemm && threadIdx.x < kGemmThreads) {
    // the first weight K-tiles, one cp.async group each: all of them when
    // the whole slab fits, else all but one slot of the ring
    const TileCopier<T> wcopy = phase_copier(p, P, C, n0);
    const int first = g.slots >= g.nk ? g.nk : g.slots - 1;
    for (int t = 0; t < first; ++t) {
      load_weight_tile(ring + t * g.kt * g.ldb, wcopy, g.ldb, t * g.kt,
                       min(g.kt, P.Kp - t * g.kt));
      cp_async_commit();
    }
    group_sync(kBarA, kThreads);  // A is in (the staging group's arrival)
    const T* A = reinterpret_cast<const T*>(base + P.a);
    if (P.kind == kGlu)
      gemm_group<T, 2>(A, ring, res, g, wcopy, first, P.Kp);
    else
      gemm_group<T, 1>(A, ring, res, g, wcopy, first, P.Kp);
  } else {
    const int tid = gemm ? threadIdx.x - kGemmThreads : threadIdx.x;
    stage_phase(x, y, scratch, p, cs, P, base, tile, ns, gbase, BLC, L, C,
                eps, tid);
    if (!gemm) {
      final_norm(P, base, out + gbase, L, C, eps, tid);
      return;
    }
    group_arrive(kBarA, kThreads);  // the GEMM group may read A
  }
  __syncthreads();  // the GEMM's results are in

  // the epilogue: bias and a * sigmoid(g) or ReLU, four columns a thread,
  // the block's columns only, into the scratch
  const bool glu = P.kind == kGlu;
  const int nq = g.nt / 4, ldr = g.sets * g.nt;
  const T* bias = reinterpret_cast<const T*>(base + P.prm);
  float* dst = scratch_rows(scratch, P.dst, BLC, gbase);
  for (int idx = threadIdx.x; idx < nrows * nq; idx += kThreads) {
    const int r = idx / nq, c = 4 * (idx - r * nq), n = n0 + c;
    if (n >= C) continue;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f), gt = v;
    for (int sp = 0; sp < g.splits; ++sp) {
      const float* rr = res + (sp * g.rows + r) * ldr + c;
      const float4 a = load4(rr);
      v = make_float4(v.x + a.x, v.y + a.y, v.z + a.z, v.w + a.w);
      if (glu) {
        const float4 b = load4(rr + g.nt);
        gt = make_float4(gt.x + b.x, gt.y + b.y, gt.z + b.z, gt.w + b.w);
      }
    }
    const float4 bv = load4(bias + c);
    const float4 bg = glu ? load4(bias + g.nt + c) : gt;
    float o[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float h = comp(v, e) + comp(bv, e);
      o[e] = glu ? h / (1.f + expf(-(comp(gt, e) + comp(bg, e))))
                 : fmaxf(h, 0.f);
    }
    store4(dst + static_cast<size_t>(r) * C + n,
           make_float4(o[0], o[1], o[2], o[3]));
  }
  if (!P.fused) return;

  // the group's last block to get here (its ticket) ends the cell
  int* last = reinterpret_cast<int*>(base + P.stats);
  __threadfence();  // this block's columns, before its ticket
  __syncthreads();
  if (threadIdx.x == 0)
    *last = atomicAdd(tickets + group, 1) == g.tiles - 1;
  __syncthreads();
  if (!*last) return;
  __threadfence();  // the other blocks' columns, after the tickets
  fused_norm(scratch_rows(scratch, P.dst, BLC, gbase), P, base, out + gbase,
             ns, L, C, eps);
  if (threadIdx.x == 0) tickets[group] = 0;  // ready for the next call
}

// ---------------------------------------------------------------------------
// The host side: the plan, each phase's geometry, the launches
// ---------------------------------------------------------------------------

// The cell's phases from its steps: what each reads, computes and keeps in
// shared memory, and which states it writes for later phases. Returns the
// number of phases.
int plan_phases(const CellSteps& cs, FoundPhase* ph) {
  int n = 0, first = 0;
  for (int s = 0; s < cs.S; ++s) {
    if (cs.branch[s] < 2) continue;
    FoundPhase& P = ph[n++] = FoundPhase{};
    P.kind = cs.branch[s] == 2 ? kGlu : kFc;
    P.step = s;
    P.first = first;
    P.last = s;
    P.nsrc = 2;
    P.src[0] = cs.src_x[s];
    P.src[1] = cs.src_y[s];
    P.dst = s + 2;
    first = s + 1;
  }
  if (cs.m != 1) {
    FoundPhase& P = ph[n++] = FoundPhase{};
    P.kind = kOutConv;
    P.first = first;
    P.last = cs.S;
    P.nsrc = cs.m;
    for (int j = 0; j < cs.m; ++j) P.src[j] = cs.S + 2 - cs.m + j;
    P.dst = cs.S + 2;
    first = cs.S;
  }
  FoundPhase& F = ph[n++] = FoundPhase{};
  F.kind = kFinal;
  F.first = first;
  F.last = cs.S;
  F.dst = cs.m != 1 ? cs.S + 2 : cs.S + 1;

  unsigned reads[kMaxPhases], made[kMaxPhases];
  for (int i = 0; i < n; ++i) {
    FoundPhase& P = ph[i];
    unsigned pend = 0, mk = 0, gsrc = 0;
    bool zero = false;
    for (int s = P.first; s < P.last; ++s) {
      const int srcs[2] = {cs.src_x[s], cs.src_y[s]};
      for (int k : srcs) {
        if (k < 0)
          zero = true;
        else
          pend |= 1u << k;
      }
      mk |= 1u << (s + 2);
      P.attn = P.attn || cs.branch[s] == 1;
    }
    for (int j = 0; j < P.nsrc; ++j)
      if (P.src[j] >= 0) gsrc |= 1u << P.src[j];
    const unsigned fin = P.kind == kFinal ? (1u << P.dst) | 1u : 0u;
    const unsigned local = pend | mk | fin;
    P.load = local & ~mk;
    reads[i] = pend | gsrc | fin;
    made[i] = mk;
    P.nraw = (P.load & 1u) + (P.load >> 1 & 1u);
    P.nslots = 0;
    P.slot[0] = zero ? P.nslots++ : -1;
    for (int k = 0; k < kMaxStates; ++k)
      P.slot[k + 1] = local >> k & 1 ? P.nslots++ : -1;
  }
  for (int i = 0; i < n; ++i) {
    unsigned later = 0;
    for (int j = i + 1; j < n; ++j) later |= reads[j];
    ph[i].store = made[i] & later;
  }
  // a last phase with no step of its own reads only the last GEMM's output
  // (and x): that GEMM's phase ends the cell instead
  if (n >= 2 && ph[n - 1].first == ph[n - 1].last) {
    ph[n - 2].fused = true;
    --n;
  }
  return n;
}

// A phase's shared-memory layout for geometry g (each region 32-byte
// aligned, WMMA's rule); returns the bytes.
size_t phase_smem(FoundPhase& P, const GemmGeom& g, int L, int C,
                  int itemsize) {
  size_t off = 0;
  P.local = off;
  off += align32(static_cast<size_t>(P.nslots) * g.S * L * (C + kPad) *
                 sizeof(float));
  P.raw = off;  // bf16 x and y as they came, before they are widened
  if (itemsize != sizeof(float))
    off += align32(static_cast<size_t>(P.nraw) * g.S * L * C * itemsize);
  P.att = P.scores = off;
  if (P.attn) {
    off += align32(static_cast<size_t>(g.S) * L * C * sizeof(float));
    P.scores = off;
    off += align32(static_cast<size_t>(g.S) * L * L * sizeof(float));
  }
  P.stats = off;  // mean and rstd per sample, then the reduction slots
  off += align32(kStatFloats * sizeof(float));
  const size_t rows = static_cast<size_t>(g.S) * L * C;
  P.ln = P.xs = P.prm = off;
  if (P.kind == kFinal || P.fused) {  // the LayerNorm's affine
    off += align32(2 * static_cast<size_t>(L) * C * itemsize);
    P.xs = off;
  }
  if (P.fused) {  // the residual's rows
    off += align32(rows * itemsize);
    P.prm = off;
  }
  P.a = P.ring = off;
  if (P.kind != kFinal) {
    off += align32(static_cast<size_t>(g.sets) * g.nt * itemsize);  // biases
    P.a = off;
    off += align32(static_cast<size_t>(g.rows) * g.lda * itemsize);
    P.ring = off;
    // the ring, then the GEMM's results, then a fused phase's v rows
    const size_t ring = ring_bytes(g, itemsize);
    const size_t v = P.fused ? align32(rows * sizeof(float)) : 0;
    off += ring > v ? ring : v;
  }
  return off;
}

// The GEMM's depth and its column sets.
void gemm_shape(FoundPhase& P, int C, int itemsize) {
  const int kk = itemsize == 4 ? 8 : 16;  // TcStep<T>::kK
  P.K = P.nsrc * C;
  P.Kp = (P.K + kk - 1) / kk * kk;
}

// The geometry of the last phase: a sample a block, 256 threads.
GemmGeom final_geom(int B) {
  GemmGeom g{};
  g.S = 1;
  g.nt = 16;
  g.groups = B;
  g.tiles = 1;
  return g;
}

// The kernels may take every byte of shared memory a block can have; the
// occupancy calculator then sees each geometry's real share.
template <typename T>
cudaError_t allow_smem() {
  const cudaError_t err = cudaFuncSetAttribute(
      found_cell_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemLimit);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(whole_cell_kernel<T>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              kSmemLimit);
}

// The launcher's design for a cell of B samples (the note at the top): true
// for the whole cell in one block a sample, false for the phases.
bool whole_first(const CellSteps& cs, int B) {
  bool gemm = cs.m != 1;
  for (int s = 0; s < cs.S; ++s) gemm = gemm || cs.branch[s] >= 2;
  return !gemm || 2 * B >= sm_count();
}

// The one phase of the whole cell in one block a sample: 2 round32(C)
// threads, the deepest weight K-tile of 32, 16 or 8 rows that fits. False
// if none does.
template <typename T>
bool whole_phase(const CellSteps& cs, int B, int L, int C, FoundPhase* P) {
  bool glu = false;
  for (int s = 0; s < cs.S; ++s) glu = glu || cs.branch[s] == 2;
  *P = FoundPhase{};
  P->kind = kWhole;
  P->g = final_geom(B);
  P->g.kt = 32;
  while (P->g.kt > 8 && whole_smem_bytes(L, C, cs.S, cs.m, glu, sizeof(T),
                                         P->g.kt) > kSmemLimit)
    P->g.kt >>= 1;
  P->smem = whole_smem_bytes(L, C, cs.S, cs.m, glu, sizeof(T), P->g.kt);
  if (P->smem > static_cast<size_t>(kSmemLimit)) return false;
  P->threads = 2 * ((C + 31) / 32 * 32);  // two row halves a column
  P->blocks = B;
  P->occ = blocks_per_sm(whole_cell_kernel<T>, P->threads, P->smem);
  return true;
}

// The whole plan with every phase's geometry. design: kDesignAuto lets the
// launcher pick (whole_first) unless S_req or nt_req fix the GEMM phases'
// samples and columns a block (0: the launcher picks them); then, as with
// kDesignPhases, the cell runs as phases. Returns the number of phases, or
// 0 if a phase fits no geometry.
template <typename T>
int plan(const CellSteps& cs, int B, int L, int C, int S_req, int nt_req,
         int design, FoundPhase* ph) {
  if (design == kDesignWhole ||
      (design == kDesignAuto && S_req == 0 && nt_req == 0 &&
       whole_first(cs, B))) {
    if (whole_phase<T>(cs, B, L, C, ph)) return 1;
    if (design == kDesignWhole) return 0;
  }
  const int n = plan_phases(cs, ph), sz = sizeof(T);
  for (int i = 0; i < n; ++i) {
    FoundPhase& P = ph[i];
    if (P.kind == kFinal) {
      P.g = final_geom(B);
      P.threads = kAttnThreads;
      P.smem = phase_smem(P, P.g, L, C, sz);
      if (P.smem > static_cast<size_t>(kSmemLimit)) return 0;
      P.occ = blocks_per_sm(found_cell_kernel<T>, P.threads, P.smem);
    } else {
      gemm_shape(P, C, sz);
      if (!pick_geom(
              B, L, C, P.Kp, sz, P.kind == kGlu ? 2 : 1, S_req, nt_req,
              [&](const GemmGeom& g) { return phase_smem(P, g, L, C, sz); },
              [](size_t bytes) {
                return blocks_per_sm(found_cell_kernel<T>, kThreads, bytes);
              },
              &P.g, &P.occ))
        return 0;
      P.threads = kThreads;
      P.smem = phase_smem(P, P.g, L, C, sz);
    }
    P.blocks = P.g.groups * P.g.tiles;
  }
  return n;
}

// The plans of recent calls. Picking a GEMM phase's geometry asks the
// occupancy calculator once a candidate, up to 24 times a phase: on an
// H100 80GB HBM3 at 700 W a phased plan made anew took 9.1-50.2 us of host
// time against calls of about 0.1 ms (chip_smoke.py phase 3, plan_us; the
// run is PERF.md section 6's), so a call that repeats
// one of these reuses its plan, and the kernels' shared-memory limit set
// when it was made. The key holds ints only (no padding), compared as
// bytes. Returns the number of phases, 0 if a phase fits no geometry, or
// minus the CUDA error of setting the limit.
struct PlanKey {
  int device, B, L, C, S_req, nt_req, design;
  CellSteps cs;
};
constexpr int kPlanCache = 16;

template <typename T>
int cached_plan(const CellSteps& cs, int B, int L, int C, int S_req,
                int nt_req, int design, FoundPhase* ph) {
  struct Entry {
    PlanKey key;
    int n;
    FoundPhase ph[kMaxPhases];
  };
  static std::mutex mu;
  static Entry cache[kPlanCache];
  static int next = 0;
  PlanKey key;
  std::memset(&key, 0, sizeof key);
  if (cudaGetDevice(&key.device) != cudaSuccess) key.device = -1;
  key.B = B;
  key.L = L;
  key.C = C;
  key.S_req = S_req;
  key.nt_req = nt_req;
  key.design = design;
  key.cs = cs;
  std::lock_guard<std::mutex> lock(mu);
  for (const Entry& e : cache) {
    if (e.n > 0 && std::memcmp(&e.key, &key, sizeof key) == 0) {
      for (int i = 0; i < e.n; ++i) ph[i] = e.ph[i];
      return e.n;
    }
  }
  const cudaError_t attr = allow_smem<T>();
  if (attr != cudaSuccess) return -static_cast<int>(attr);
  const int n = plan<T>(cs, B, L, C, S_req, nt_req, design, ph);
  if (n > 0) {
    Entry& e = cache[next];
    next = (next + 1) % kPlanCache;
    e.key = key;
    e.n = n;
    for (int i = 0; i < n; ++i) e.ph[i] = ph[i];
  }
  return n;
}

template <typename T>
int launch(const void* x, const void* y, void* out, float* scratch,
           int* tickets, int B, int L, int C, const CellSteps& cs,
           const void* const* params, float eps, int S_req, int nt_req,
           int design, cudaStream_t stream) {
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
  FoundPhase ph[kMaxPhases];
  const int n = cached_plan<T>(cs, B, L, C, S_req, nt_req, design, ph);
  if (n < 0) return -n;
  if (n == 0) return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < n; ++i) {
    const FoundPhase& P = ph[i];
    if (P.kind == kWhole)
      whole_cell_kernel<T><<<P.blocks, P.threads, P.smem, stream>>>(
          static_cast<const T*>(x), static_cast<const T*>(y),
          static_cast<T*>(out), p, cs, P.g.kt, L, C, eps);
    else
      found_cell_kernel<T><<<P.blocks, P.threads, P.smem, stream>>>(
          static_cast<const T*>(x), static_cast<const T*>(y),
          static_cast<T*>(out), scratch, tickets, p, cs, P, B, L, C, eps);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// The steps of a call from the C interface's arrays; false if they are not
// a cell the kernel hosts.
bool read_steps(int S, int m, const int* branch, const int* src_x,
                const int* src_y, CellSteps* cs) {
  if (S < 1 || S > kMaxSteps || m < 1 || m > S + 2) return false;
  cs->S = S;
  cs->m = m;
  for (int s = 0; s < kMaxSteps; ++s) {
    cs->branch[s] = s < S ? branch[s] : 0;
    cs->src_x[s] = s < S ? src_x[s] : -1;
    cs->src_y[s] = s < S ? src_y[s] : -1;
    if (s < S && (branch[s] < 0 || branch[s] > 3 || src_x[s] < -1 ||
                  src_x[s] >= s + 2 || src_y[s] < -1 || src_y[s] >= s + 2))
      return false;
  }
  return true;
}

bool valid_call(int B, int L, int C, int S_req, int nt_req, int design) {
  return B >= 1 && L >= 1 && C % 8 == 0 && C >= 8 && C <= 256 &&
         S_req >= 0 && S_req <= kMaxSamples && (S_req & (S_req - 1)) == 0 &&
         (nt_req == 0 || nt_req == 16 || nt_req == 32) &&
         design >= kDesignAuto && design <= kDesignWhole;
}

constexpr int kGeomFields = 11;

}  // namespace

extern "C" {

// Bytes of dynamic shared memory of the call's largest phase at its
// smallest geometry (one sample a block, 16 columns, a ring of 16-row
// K-tiles): the call fits if this does. 0 for steps the kernel cannot host.
size_t found_cell_smem_bytes(int L, int C, int S, int m, const int* branch,
                             const int* src_x, const int* src_y,
                             int itemsize) {
  CellSteps cs;
  if (!read_steps(S, m, branch, src_x, src_y, &cs) || L < 1 || C % 8 != 0 ||
      (itemsize != 4 && itemsize != 2))
    return 0;
  FoundPhase ph[kMaxPhases];
  const int n = plan_phases(cs, ph);
  size_t worst = 0;
  for (int i = 0; i < n; ++i) {
    FoundPhase& P = ph[i];
    GemmGeom g = final_geom(1);
    if (P.kind != kFinal) {
      gemm_shape(P, C, itemsize);
      g = gemm_geom(1, L, C, P.Kp, itemsize, P.kind == kGlu ? 2 : 1, 1, 16,
                    16, false);
    }
    const size_t bytes = phase_smem(P, g, L, C, itemsize);
    worst = bytes > worst ? bytes : worst;
  }
  return worst;
}

// The geometry a call would take, kGeomFields ints a phase in geom: kind
// (0 the last phase, 1 GLU, 2 ConcatFC, 3 out-conv, 4 the whole cell in one
// block a sample), step, samples a block, columns a block, weight rows a
// K-tile, K-tiles in shared memory at once, blocks, threads, blocks an SM,
// bytes of shared memory, 1 if the phase ends the cell (its group's last
// block adds x and normalizes); the number of phases in *nphases. Returns
// 0, or cudaErrorInvalidValue if the call is not one the kernel hosts.
int found_cell_geometry(int B, int L, int C, int S, int m, const int* branch,
                        const int* src_x, const int* src_y, int itemsize,
                        int samples_per_block, int cols_per_block,
                        int design, int* geom, int* nphases) {
  CellSteps cs;
  if (!valid_call(B, L, C, samples_per_block, cols_per_block, design) ||
      !read_steps(S, m, branch, src_x, src_y, &cs))
    return static_cast<int>(cudaErrorInvalidValue);
  FoundPhase ph[kMaxPhases];
  int n = 0;
  if (itemsize == 4) {
    const cudaError_t err = allow_smem<float>();
    if (err != cudaSuccess) return static_cast<int>(err);
    n = plan<float>(cs, B, L, C, samples_per_block, cols_per_block, design,
                    ph);
  } else if (itemsize == 2) {
    const cudaError_t err = allow_smem<__nv_bfloat16>();
    if (err != cudaSuccess) return static_cast<int>(err);
    n = plan<__nv_bfloat16>(cs, B, L, C, samples_per_block, cols_per_block,
                            design, ph);
  }
  if (n == 0) return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < n; ++i) {
    const FoundPhase& P = ph[i];
    const bool gemm = P.kind != kFinal && P.kind != kWhole;
    int* o = geom + i * kGeomFields;
    o[0] = P.kind;
    o[1] = P.kind == kGlu || P.kind == kFc ? P.step : -1;
    o[2] = P.g.S;
    o[3] = gemm ? P.g.nt : C;
    o[4] = gemm || P.kind == kWhole ? P.g.kt : 0;
    o[5] = gemm ? P.g.slots : P.kind == kWhole ? 2 : 0;
    o[6] = P.blocks;
    o[7] = P.threads;
    o[8] = P.occ;
    o[9] = static_cast<int>(P.smem);
    o[10] = P.fused;
  }
  *nphases = n;
  return 0;
}

const char* found_cell_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// dtype: 0 = fp32, 1 = bf16 (x, y, out and every parameter). scratch: (S +
// 1) B L C floats of device memory the call may overwrite; tickets: B ints
// of device memory that are 0 before the call and after it (one buffer a
// stream: the calls on it take turns). params holds ten
// device pointers in CellParams order (oc_w, oc_b may be null when m == 1).
// branch/src_x/src_y are host arrays of S entries (a source -1 for a 'none'
// edge). samples_per_block (1, 2 or 4) and cols_per_block (16 or 32) fix
// the GEMM phases' geometry; 0 lets the launcher pick. design: 0 the
// launcher's pick, 1 the phases, 2 the whole cell in one block a sample
// (which takes neither scratch nor tickets). Launches one kernel a phase on
// `stream`; returns the CUDA error code of the launches (0 on success).
int found_cell_forward(int dtype, const void* x, const void* y, void* out,
                       void* scratch, void* tickets, int B, int L, int C,
                       int S, int m,
                       const int* branch, const int* src_x, const int* src_y,
                       const void* const* params, float eps,
                       int samples_per_block, int cols_per_block, int design,
                       void* stream) {
  CellSteps cs;
  if (!valid_call(B, L, C, samples_per_block, cols_per_block, design) ||
      !read_steps(S, m, branch, src_x, src_y, &cs))
    return static_cast<int>(cudaErrorInvalidValue);
  float* sc = static_cast<float*>(scratch);
  int* tk = static_cast<int*>(tickets);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, y, out, sc, tk, B, L, C, cs, params, eps,
                         samples_per_block, cols_per_block, design, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, y, out, sc, tk, B, L, C, cs, params, eps,
                                 samples_per_block, cols_per_block, design,
                                 st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
