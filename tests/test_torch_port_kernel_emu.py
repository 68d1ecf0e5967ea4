"""The port's CUDA kernels' own code, run on the CPU by emulation.

There is no CUDA compiler or card on the test host, so
``bmnas_tpu_torch/csrc/found_cell.cu``, ``node_mixed.cu`` and
``attention.cu``, with their headers ``cell_common.cuh`` and
``tc_gemm.cuh``, are compiled as C++ against stand-in CUDA
headers: one ``std::thread`` per CUDA thread, a ``std::barrier`` for
``__syncthreads``, per-warp barriers for the shuffles and for a
warp-collective WMMA (each lane holds a slice of every fragment; a TF32
operand's low 13 bits are cut, as the tensor cores read it, and
``__float_to_tf32`` rounds to 10 mantissa bits, so the low half of 3xTF32
counts; a misaligned WMMA pointer fails the launch), ``cp.async`` as a
16-byte copy that lands only when a ``wait_group`` retires its group,
blocks one after another, shared memory allocated at exactly the launch's
size and filled with NaNs. What it checks is the
kernels' indexing, tiling, staging and synchronisation order, through the
port's own ctypes bindings (``node_mixed.bind`` / ``launch``,
``bind_mixed`` / ``launch_mixed`` and ``attention.bind`` / ``launch``),
against ``found_node_cell_reference``, ``node_mixed_op_reference`` and
``reference_attention``. It cannot check timing, memory ordering
on the card or the compiler's output; ``chip_smoke.py`` does that. Skips
where there is no ``g++``.
"""
import ctypes
import math
import os
import re
import shutil
import subprocess

import pytest
import torch

from bmnas_tpu_torch.ops.kernels import _build
from bmnas_tpu_torch.ops.kernels import attention as tat
from bmnas_tpu_torch.ops.kernels import node_mixed as tnm

CUDA_RUNTIME_H = r"""
#pragma once
#include <atomic>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <functional>
#include <math.h>
#include <memory>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __align__(x)
#define __shared__
#define __restrict__
struct uint3_ { unsigned x, y, z; };
extern thread_local uint3_ threadIdx, blockIdx;
extern uint3_ blockDim;
extern std::barrier<>* g_block_barrier;
extern std::vector<std::unique_ptr<std::barrier<>>> g_warp_barriers;
extern float g_shfl[1024];
extern float* g_smem;
// set by a stand-in that sees a misuse (a misaligned WMMA pointer); the next
// cudaGetLastError reports it
extern std::atomic<bool> g_emu_fault;
// cp.async: a copy lands only when a wait_group retires its group
struct EmuCopy { void* dst; const void* src; };
extern thread_local std::vector<EmuCopy> g_cp_open;
extern thread_local std::vector<std::vector<EmuCopy>> g_cp_groups;
inline void emu_cp_async(void* s, const void* g) { g_cp_open.push_back({s, g}); }
inline void emu_cp_commit() {
  g_cp_groups.push_back(g_cp_open);
  g_cp_open.clear();
}
inline void emu_cp_wait(int n) {  // all but the newest n groups land
  while (static_cast<int>(g_cp_groups.size()) > n) {
    for (const EmuCopy& c : g_cp_groups.front()) std::memcpy(c.dst, c.src, 16);
    g_cp_groups.erase(g_cp_groups.begin());
  }
}
inline void __syncthreads() { g_block_barrier->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) {
  g_warp_barriers[threadIdx.x >> 5]->arrive_and_wait();
}
// a named barrier: made for its thread count at its first use in a block;
// an arrival that does not wait counts toward it as well
void emu_group_sync(int id, int n);
void emu_group_arrive(int id, int n);
inline float __shfl_xor_sync(unsigned, float v, int o) {
  const int t = threadIdx.x, w = t >> 5;
  g_shfl[t] = v;
  g_warp_barriers[w]->arrive_and_wait();
  const float r = g_shfl[(w << 5) | ((t & 31) ^ o)];
  g_warp_barriers[w]->arrive_and_wait();
  return r;
}
inline float rsqrtf(float x) { return 1.f / std::sqrt(x); }
// a block's ticket: blocks run one after another, so the fences have
// nothing to order and the last block of a group is the last in index order
inline int atomicAdd(int* p, int v) {
  return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST);
}
inline void __threadfence() { std::atomic_thread_fence(std::memory_order_seq_cst); }
struct float4 { float x, y, z, w; };
inline float4 __ldcg(const float4* p) { return *p; }
struct float2 { float x, y; };
struct uint2 { unsigned x, y; };
inline float4 make_float4(float a, float b, float c, float d) {
  return {a, b, c, d};
}
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount };
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return cudaSuccess; }
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) {
  *v = 132;  // an H100 SXM's SMs
  return cudaSuccess;
}
typedef struct CUstream_st* cudaStream_t;
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
template <class T>
cudaError_t cudaFuncSetAttribute(T, cudaFuncAttribute, int) {
  return cudaSuccess;
}
// an H100's limits: 228 KiB of shared memory an SM, 1 KiB of it reserved
// for each block, 64 Ki registers, taken as 128 a thread
template <class T>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, T, int threads,
                                                          size_t smem) {
  *n = std::min<int>(65536 / (128 * threads), 233472 / (smem + 1024));
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() {
  return g_emu_fault.exchange(false) ? cudaErrorInvalidValue : cudaSuccess;
}
inline const char* cudaGetErrorString(cudaError_t e) {
  return e == cudaSuccess ? "no error" : "invalid argument";
}
using std::max;
using std::min;
void emu_launch(int blocks, int threads, size_t bytes,
                std::function<void()> body);
"""

CUDA_BF16_H = r"""
#pragma once
#include <cstdint>
#include <cstring>
struct __nv_bfloat16 { unsigned short v; };
struct __nv_bfloat162 { __nv_bfloat16 x, y; };
inline float __bfloat162float(__nv_bfloat16 b) {
  uint32_t u = uint32_t(b.v) << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline __nv_bfloat16 __float2bfloat16(float f) {  // round to nearest even
  uint32_t u;
  std::memcpy(&u, &f, 4);
  u += 0x7fff + ((u >> 16) & 1);
  return {static_cast<unsigned short>(u >> 16)};
}
inline float2 __bfloat1622float2(__nv_bfloat162 h) {
  return {__bfloat162float(h.x), __bfloat162float(h.y)};
}
inline __nv_bfloat162 __floats2bfloat162_rn(float a, float b) {
  return {__float2bfloat16(a), __float2bfloat16(b)};
}
"""

MMA_H = r"""
#pragma once
#include <cstdint>
#include <cstring>
#include <type_traits>
#include "cuda_runtime.h"
#include "cuda_bf16.h"
namespace nvcuda {
namespace wmma {
struct matrix_a {};
struct matrix_b {};
struct accumulator {};
struct row_major {};
struct col_major {};
namespace precision { struct tf32 {}; }
enum layout_t { mem_row_major, mem_col_major };

template <class Use, int M, int N, int K> struct dims;
template <int M, int N, int K> struct dims<matrix_a, M, N, K> {
  static constexpr int rows = M, cols = K;
};
template <int M, int N, int K> struct dims<matrix_b, M, N, K> {
  static constexpr int rows = K, cols = N;
};
template <int M, int N, int K> struct dims<accumulator, M, N, K> {
  static constexpr int rows = M, cols = N;
};
template <class T> struct storage { using type = T; };
template <> struct storage<precision::tf32> { using type = float; };

// Lane l holds elements [l * num_elements, (l + 1) * num_elements) of the
// tile in row-major order: a layout of the stand-in's own, which code that
// is right for every layout does not notice.
template <class Use, int M, int N, int K, class T, class Layout = void>
struct fragment {
  static constexpr int rows = dims<Use, M, N, K>::rows;
  static constexpr int cols = dims<Use, M, N, K>::cols;
  static constexpr int num_elements = rows * cols / 32;
  using element_type = typename storage<T>::type;
  element_type x[num_elements];
};

inline float emu_bits(float v, uint32_t mask) {
  uint32_t u;
  std::memcpy(&u, &v, 4);
  u &= mask;
  std::memcpy(&v, &u, 4);
  return v;
}
// cvt.rna.tf32.f32: round to 10 mantissa bits, ties away from zero
inline float __float_to_tf32(float v) {
  uint32_t u;
  std::memcpy(&u, &v, 4);
  if ((u & 0x7f800000u) != 0x7f800000u) u += 0x1000u;
  std::memcpy(&v, &u, 4);
  return emu_bits(v, 0xffffe000u);
}
// what the tensor cores read of an operand: a tf32 one's low 13 bits are
// ignored, so an operand not rounded by __float_to_tf32 is cut
template <class T> float operand(typename storage<T>::type v);
template <> inline float operand<precision::tf32>(float v) {
  return emu_bits(v, 0xffffe000u);
}
template <> inline float operand<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

inline void emu_check(const void* p, unsigned ldm, size_t elem) {
  if (reinterpret_cast<uintptr_t>(p) % 32 || ldm * elem % 16)
    g_emu_fault = true;  // WMMA's alignment rules
}

// A col_major operand's element (row, col) is p[col * ldm + row]: the
// fragment holds the same tile as a row_major load of its transpose would.
template <class Use, int M, int N, int K, class T, class Lay, class E>
void load_matrix_sync(fragment<Use, M, N, K, T, Lay>& f, const E* p,
                      unsigned ldm) {
  using F = fragment<Use, M, N, K, T, Lay>;
  emu_check(p, ldm, sizeof(E));
  const int lane = threadIdx.x & 31;
  for (int i = 0; i < F::num_elements; ++i) {
    const int e = lane * F::num_elements + i, r = e / F::cols,
              c = e % F::cols;
    f.x[i] = std::is_same_v<Lay, col_major> ? p[c * ldm + r]
                                            : p[r * ldm + c];
  }
}

// an accumulator from memory, row-major only (as store_matrix_sync)
template <int M, int N, int K>
void load_matrix_sync(fragment<accumulator, M, N, K, float>& f,
                      const float* p, unsigned ldm, layout_t layout) {
  using F = fragment<accumulator, M, N, K, float>;
  emu_check(p, ldm, sizeof(float));
  if (layout != mem_row_major) g_emu_fault = true;
  const int lane = threadIdx.x & 31;
  for (int i = 0; i < F::num_elements; ++i) {
    const int e = lane * F::num_elements + i;
    f.x[i] = p[(e / N) * ldm + e % N];
  }
}

template <int M, int N, int K>
void store_matrix_sync(float* p, const fragment<accumulator, M, N, K, float>& f,
                       unsigned ldm, layout_t layout) {
  using F = fragment<accumulator, M, N, K, float>;
  emu_check(p, ldm, sizeof(float));
  if (layout != mem_row_major) g_emu_fault = true;
  const int lane = threadIdx.x & 31;
  for (int i = 0; i < F::num_elements; ++i) {
    const int e = lane * F::num_elements + i;
    p[(e / N) * ldm + e % N] = f.x[i];
  }
}

template <class Use, int M, int N, int K, class T, class Lay>
void fill_fragment(fragment<Use, M, N, K, T, Lay>& f, float v) {
  for (auto& e : f.x) e = v;
}

inline float g_mma[32][3 * 256];  // a warp's operands, gathered
// d = a b + c, warp-collective: every lane publishes its elements, the warp
// meets at its barrier, each lane computes its own elements of d.
template <int M, int N, int K, class Ta, class La, class Tb, class Lb>
void mma_sync(fragment<accumulator, M, N, K, float>& d,
              const fragment<matrix_a, M, N, K, Ta, La>& a,
              const fragment<matrix_b, M, N, K, Tb, Lb>& b,
              const fragment<accumulator, M, N, K, float>& c) {
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float *sa = g_mma[w], *sb = sa + 256, *sc = sb + 256;
  constexpr int na = M * K / 32, nb = K * N / 32, nc = M * N / 32;
  for (int i = 0; i < na; ++i) sa[lane * na + i] = operand<Ta>(a.x[i]);
  for (int i = 0; i < nb; ++i) sb[lane * nb + i] = operand<Tb>(b.x[i]);
  for (int i = 0; i < nc; ++i) sc[lane * nc + i] = c.x[i];
  g_warp_barriers[w]->arrive_and_wait();
  float r[nc];
  for (int i = 0; i < nc; ++i) {
    const int e = lane * nc + i, row = e / N, col = e % N;
    float s = sc[e];
    for (int k = 0; k < K; ++k) s = fmaf(sa[row * K + k], sb[k * N + col], s);
    r[i] = s;
  }
  g_warp_barriers[w]->arrive_and_wait();
  for (int i = 0; i < nc; ++i) d.x[i] = r[i];
}
}  // namespace wmma
}  // namespace nvcuda
"""

EMU_RUNTIME_CPP = r"""
#include "cuda_runtime.h"
#include <cstdlib>
#include <mutex>
thread_local uint3_ threadIdx, blockIdx;
uint3_ blockDim;
std::barrier<>* g_block_barrier;
std::vector<std::unique_ptr<std::barrier<>>> g_warp_barriers;
float g_shfl[1024];
float* g_smem;
std::atomic<bool> g_emu_fault{false};
static std::mutex g_group_mutex;
static std::unique_ptr<std::barrier<>> g_group_barriers[16];
static std::barrier<>* emu_group_barrier(int id, int n) {
  std::lock_guard<std::mutex> lock(g_group_mutex);
  if (!g_group_barriers[id]) g_group_barriers[id].reset(new std::barrier<>(n));
  return g_group_barriers[id].get();
}
void emu_group_sync(int id, int n) { emu_group_barrier(id, n)->arrive_and_wait(); }
void emu_group_arrive(int id, int n) { (void)emu_group_barrier(id, n)->arrive(); }
thread_local std::vector<EmuCopy> g_cp_open;
thread_local std::vector<std::vector<EmuCopy>> g_cp_groups;
void emu_launch(int blocks, int threads, size_t bytes,
                std::function<void()> body) {
  blockDim = {unsigned(threads), 1, 1};
  for (int b = 0; b < blocks; ++b) {
    g_smem = static_cast<float*>(
        std::aligned_alloc(128, (bytes + 127) / 128 * 128));
    std::memset(g_smem, 0xff, bytes);  // NaNs: unset reads show
    std::barrier<> bar(threads);
    g_block_barrier = &bar;
    g_warp_barriers.clear();
    for (auto& gb : g_group_barriers) gb.reset();
    for (int w = 0; w < threads / 32; ++w)
      g_warp_barriers.emplace_back(new std::barrier<>(32));
    std::vector<std::thread> ts;
    for (int t = 0; t < threads; ++t)
      ts.emplace_back([=] {
        threadIdx = {unsigned(t), 0, 0};
        blockIdx = {unsigned(b), 0, 0};
        body();
      });
    for (auto& t : ts) t.join();
    std::free(g_smem);
  }
}
"""


# the inline PTX of each header, by function name, and its stand-in
HEADER_STAND_INS = {
    "cell_common.cuh": {
        "cp_async16": "inline void cp_async16(void* s, const void* g) "
                      "{ emu_cp_async(s, g); }",
        "cp_async_commit": "inline void cp_async_commit() "
                           "{ emu_cp_commit(); }",
    },
    # template <int N> stays in front of the stand-in
    "tc_gemm.cuh": {
        "cp_async_wait": "inline void cp_async_wait() { emu_cp_wait(N); }",
        "group_sync": "inline void group_sync(int id, int n) "
                      "{ emu_group_sync(id, n); }",
        "group_arrive": "inline void group_arrive(int id, int n) "
                        "{ emu_group_arrive(id, n); }",
    },
    # no inline PTX: written beside the others as they are
    "cell_gemm.cuh": {},
    "cell_whole.cuh": {},
}


def _emulated_header(src: str, stand_ins: dict) -> str:
    """A header with its inline PTX replaced."""
    for name, body in stand_ins.items():
        src, n = re.subn(r"__device__ __forceinline__ void " + name
                         + r"\(.*?\n\}", body, src, flags=re.S)
        assert n == 1, name
    assert "asm" not in src
    return '#include "cuda_runtime.h"\n' + src


def _emulated_source(src: str) -> str:
    """A kernel source with its launch syntax replaced: each kernel's
    shared memory and its one launch site."""
    kernels = src.count("__global__")
    src, n = re.subn(r"extern __shared__ __align__\(\d+\) float smem\[\];",
                     "float* smem = g_smem;", src)
    assert n == kernels
    # kernel<T><<<grid, block, smem, stream>>>(args): the stream is dropped
    src, n = re.subn(r"(\w+_kernel<T>)<<<([^,]+,[^,]+,[^,]+),[^>]*>>>"
                     r"\((.*?)\);",
                     r"emu_launch(\2, [=]() { \1(\3); });", src,
                     flags=re.S)
    assert n == kernels
    assert "asm" not in src
    return '#include "cuda_runtime.h"\n' + src


# The stand-in WMMA checked by itself: d = a k^T with k read in place as a
# col_major B operand (k row-major, 16 rows of kK), as attention.cu reads
# its keys.
EMU_SELFTEST_CPP = r"""
#include <mma.h>
namespace wmma = nvcuda::wmma;
template <class T, int kK>
static int col_major_product(const T* a, const T* k, float* d) {
  using Prec = std::conditional_t<kK == 8, wmma::precision::tf32, T>;
  emu_launch(1, 32, 0, [=]() {
    wmma::fragment<wmma::matrix_a, 16, 16, kK, Prec, wmma::row_major> fa;
    wmma::fragment<wmma::matrix_b, 16, 16, kK, Prec, wmma::col_major> fb;
    wmma::fragment<wmma::accumulator, 16, 16, kK, float> acc;
    wmma::load_matrix_sync(fa, a, kK);
    wmma::load_matrix_sync(fb, k, kK);
    wmma::fill_fragment(acc, 0.f);
    wmma::mma_sync(acc, fa, fb, acc);
    wmma::store_matrix_sync(d, acc, 16, wmma::mem_row_major);
  });
  return cudaGetLastError();
}
extern "C" int emu_col_major_product(int bf16, const void* a, const void* k,
                                     float* d) {
  if (bf16)
    return col_major_product<__nv_bfloat16, 16>(
        static_cast<const __nv_bfloat16*>(a),
        static_cast<const __nv_bfloat16*>(k), d);
  return col_major_product<float, 8>(static_cast<const float*>(a),
                                     static_cast<const float*>(k), d);
}
"""

KERNELS = ("found_cell", "node_mixed", "attention")


@pytest.fixture(scope="module")
def emu_libs(tmp_path_factory):
    """{'found_cell': lib, 'node_mixed': lib, 'attention': lib}: the three
    kernels and the emulated runtime in one library, bound with the port's
    bindings."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no g++ to compile the kernels' CPU emulation")
    d = tmp_path_factory.mktemp("cell_kernels_emu")
    files = {"cuda_runtime.h": CUDA_RUNTIME_H, "cuda_bf16.h": CUDA_BF16_H,
             "emu_runtime.cpp": EMU_RUNTIME_CPP}
    files["mma.h"] = MMA_H
    files["emu_selftest.cpp"] = EMU_SELFTEST_CPP
    for name, stand_ins in HEADER_STAND_INS.items():
        with open(os.path.join(_build.CSRC, name)) as f:
            files[name] = _emulated_header(f.read(), stand_ins)
    for name in KERNELS:
        with open(os.path.join(_build.CSRC, f"{name}.cu")) as f:
            files[f"{name}_emu.cpp"] = _emulated_source(f.read())
    for name, text in files.items():
        (d / name).write_text(text)
    so = d / "libcell_kernels_emu.so"
    subprocess.run([cxx, "-std=c++20", "-O1", "-shared", "-fPIC",
                    f"-I{d}", "-o", str(so),
                    *[str(d / f"{name}_emu.cpp") for name in KERNELS],
                    str(d / "emu_selftest.cpp"), str(d / "emu_runtime.cpp"),
                    "-lpthread"],
                   check=True, capture_output=True, timeout=300)
    return {"found_cell": tnm.bind(ctypes.CDLL(str(so))),
            "node_mixed": tnm.bind_mixed(ctypes.CDLL(str(so))),
            "attention": tat.bind(ctypes.CDLL(str(so))),
            "selftest": ctypes.CDLL(str(so))}


@pytest.fixture(scope="module")
def emu_lib(emu_libs):
    return emu_libs["found_cell"]


CONFIGS = [
    (1, 1, ("Sum",)),
    (1, 1, ("ScaleDotAttn",)),
    (1, 1, ("LinearGLU",)),
    (1, 1, ("ConcatFC",)),
    (2, 2, ("ConcatFC", "ScaleDotAttn")),
    (2, 2, ("LinearGLU", "LinearGLU")),
    (3, 1, ("ScaleDotAttn", "Sum", "ConcatFC")),
    (4, 6, ("LinearGLU", "Sum", "ConcatFC", "ScaleDotAttn")),
]
IDS = ["-".join(ops) + f"-m{m}" for _, m, ops in CONFIGS]
TOLS = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _params(gen, S, m, L, C, dtype):
    def r(*shape, k=1.0):
        return (torch.randn(*shape, generator=gen) * k).to(dtype)
    w = 1.0 / math.sqrt(2 * C)
    return tnm.FoundCellParams(
        ln1_scale=r(S, L, C), ln1_bias=r(S, L, C),
        glu_kernel=r(S, 2 * C, 2 * C, k=w), glu_bias=r(S, 2 * C, k=0.1),
        cfc_kernel=r(S, 2 * C, C, k=w), cfc_bias=r(S, C, k=0.1),
        oc_kernel=r(m * C, C, k=1 / math.sqrt(m * C)) if m != 1 else None,
        oc_bias=r(C, k=0.1) if m != 1 else None,
        ln2_scale=r(L, C), ln2_bias=r(L, C))


def _nan_scratch(x, cfg):
    """The kernel's scratch filled with NaNs: a state read before it is
    written shows in the output."""
    B, L, C = x.shape
    return torch.full((tnm.found_cell_scratch_numel(B, L, C, len(cfg)),),
                      float("nan"))


def _compare(lib, x, y, p, cfg, m, **geom):
    scratch = _nan_scratch(x, cfg)
    tnm._check(x, y, p, cfg, m, scratch)
    got = tnm.launch(lib, x, y, p, cfg, m, 1e-5, None, scratch,
                     **geom).float()
    want = tnm.found_node_cell_reference(x, y, p, cfg, m).float()
    tol = TOLS[x.dtype]
    assert torch.isfinite(got).all()
    assert ((got - want).abs() <= tol + tol * want.abs()).all(), float(
        (got - want).abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("node_steps,m,ops", CONFIGS, ids=IDS)
def test_kernel_matches_reference(emu_lib, node_steps, m, ops, dtype):
    """B=3, L=8, C=16: one row tile, half of it past the last row."""
    B, L, C = 3, 8, 16
    gen = torch.Generator().manual_seed(node_steps * 10 + m)
    cfg = tnm.found_cell_steps_cfg(
        tuple(e for i in range(node_steps)
              for e in (("skip", i), ("skip", i + 1))), ops)
    p = _params(gen, node_steps, m, L, C, dtype)
    x = torch.randn(B, L, C, generator=gen).to(dtype)
    y = torch.randn(B, L, C, generator=gen).to(dtype)
    _compare(emu_lib, x, y, p, cfg, m)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("ops", [("LinearGLU", "LinearGLU"),
                                 ("ScaleDotAttn", "ConcatFC"),
                                 ("ConcatFC", "Sum"),
                                 ("Sum", "ScaleDotAttn")],
                         ids=lambda ops: "-".join(ops))
def test_kernel_ntu_width(emu_lib, ops, dtype):
    """The NTU serving width, L=8, C=128 (256 threads a block, the 256
    rows of a GLU weight in K-tiles of 32), with the four cells the NTU
    serve smoke test
    serves: two chained steps (the second reads the first's output) and
    multiplier 2, so the out-conv runs."""
    B, L, C = 2, 8, 128
    gen = torch.Generator().manual_seed(12)
    cfg = tnm.found_cell_steps_cfg(
        (("skip", 0), ("skip", 1), ("skip", 1), ("skip", 2)), ops)
    p = _params(gen, 2, 2, L, C, dtype)
    x = torch.randn(B, L, C, generator=gen).to(dtype)
    y = torch.randn(B, L, C, generator=gen).to(dtype)
    _compare(emu_lib, x, y, p, cfg, 2)


def test_kernel_two_row_tiles_and_none_edges(emu_lib):
    """L=20 (a full row tile, then a ragged one), C=32 (several K-tiles),
    and 'none' inner edges, which read zeros."""
    B, L, C = 2, 20, 32
    gen = torch.Generator().manual_seed(11)
    cfg = tnm.found_cell_steps_cfg(
        (("none", 0), ("skip", 1), ("skip", 2), ("none", 0),
         ("skip", 3), ("skip", 0)), ("ScaleDotAttn", "LinearGLU", "ConcatFC"))
    p = _params(gen, 3, 3, L, C, torch.float32)
    x, y = (torch.randn(B, L, C, generator=gen) for _ in range(2))
    _compare(emu_lib, x, y, p, cfg, 3)


def test_kernel_refuses_width(emu_lib):
    """The C function itself refuses a width it cannot host, and the
    binding turns its error code into an exception."""
    B, L, C = 2, 8, 12
    gen = torch.Generator().manual_seed(3)
    p = _params(gen, 1, 1, L, C, torch.float32)
    x = torch.randn(B, L, C, generator=gen)
    with pytest.raises(RuntimeError, match="launch failed"):
        tnm.launch(emu_lib, x, x, p, ((0, (True, 0), (True, 1)),), 1, 1e-5,
                   None)


def _cell_inputs(gen, B, L, C, S, m, dtype):
    p = _params(gen, S, m, L, C, dtype)
    x = torch.randn(B, L, C, generator=gen).to(dtype)
    y = torch.randn(B, L, C, generator=gen).to(dtype)
    return p, x, y


def _chain(ops):
    return tnm.found_cell_steps_cfg(
        tuple(e for i in range(len(ops)) for e in (("skip", i),
                                                   ("skip", i + 1))), ops)


# (inner ops, multiplier, the phases: one launch each; '*' marks the GEMM
# phase that ends the cell with the residual and the LayerNorm)
PHASE_PLANS = [
    (("Sum",), 1, ("final",)),
    (("ScaleDotAttn",), 1, ("final",)),
    (("LinearGLU",), 1, ("glu*",)),
    (("LinearGLU", "Sum"), 1, ("glu", "final")),
    (("LinearGLU", "LinearGLU"), 2, ("glu", "glu", "out_conv*")),
    (("ScaleDotAttn", "ConcatFC"), 2, ("fc", "out_conv*")),
    (("ConcatFC", "Sum"), 2, ("fc", "out_conv*")),
    (("Sum", "ScaleDotAttn"), 2, ("out_conv*",)),
    (("ScaleDotAttn", "Sum", "ConcatFC"), 1, ("fc*",)),
    (("LinearGLU", "ConcatFC", "LinearGLU"), 2,
     ("glu", "fc", "glu", "out_conv*")),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("ops,m,kinds", PHASE_PLANS,
                         ids=["-".join(o) + f"-m{m}"
                              for o, m, _ in PHASE_PLANS])
def test_kernel_phase_plans(emu_lib, ops, m, kinds, dtype):
    """Every phase plan: one launch (no GEMM and m = 1, or a last GEMM that
    ends the cell), two, three and four (the NTU serving cells' op pairs,
    chained, m = 2; the 3-step ScaleDotAttn+Sum+ConcatFC; a step after the
    last GEMM, which keeps a last phase of its own), the plan the C
    function reports equal to ``found_cell_phases``, against
    ``found_node_cell_reference`` on a NaN scratch. B=3 (the last GEMM
    group ragged at two samples a block), L=8, C=16; the phased design
    asked for (the launcher runs a cell without a GEMM in one block a
    sample)."""
    B, L, C = 3, 8, 16
    cfg = _chain(ops)
    itemsize = 4 if dtype == torch.float32 else 2
    geom = tnm.found_cell_geometry(emu_lib, B, L, C, cfg, m, itemsize,
                                   design="phases")
    mark = lambda ph: ph["kind"] + "*" * ph["fused"]  # noqa: E731
    assert tuple(mark(g) for g in geom) == kinds
    assert tuple(mark(p) for p in tnm.found_cell_phases(cfg, m)) == kinds
    assert [g["threads"] for g in geom] == [
        256 if k == "final" else 512 for k in kinds]
    gen = torch.Generator().manual_seed(len(ops) * 10 + m)
    p, x, y = _cell_inputs(gen, B, L, C, len(ops), m, dtype)
    _compare(emu_lib, x, y, p, cfg, m, design="phases")


# inner edges with 'none' (zeros) in an attention and in a GEMM, read in
# the phase that computes them, in a later GEMM phase and in the last phase
NONE_EDGE_CELLS = {
    "attn-glu-fc-m3": (
        (("none", 0), ("skip", 1), ("skip", 2), ("none", 0),
         ("skip", 3), ("skip", 0)),
        ("ScaleDotAttn", "LinearGLU", "ConcatFC"), 3),
    "glu-attn-sum-m1": (
        (("skip", 0), ("none", 1), ("skip", 2), ("none", 0),
         ("none", 1), ("skip", 3)),
        ("LinearGLU", "ScaleDotAttn", "Sum"), 1),
}


@pytest.mark.parametrize("B", [1, 2, 37])
@pytest.mark.parametrize("cell", list(NONE_EDGE_CELLS))
def test_kernel_batches_and_none_edges(emu_lib, cell, B):
    """B of one sample, two, and 37 (ten groups of four samples the last of
    one, at L=8), with 'none' edges: an attention over zero queries inside
    a GEMM phase, a GEMM half of zeros, and an attention over zero values
    and a Sum in the last phase; on a NaN scratch, in fp32, and in bf16 at
    B=1 and 2."""
    L, C = 8, 16
    edges, ops, m = NONE_EDGE_CELLS[cell]
    cfg = tnm.found_cell_steps_cfg(edges, ops)
    for dtype in (torch.float32, torch.bfloat16)[:2 if B <= 2 else 1]:
        gen = torch.Generator().manual_seed(B)
        p, x, y = _cell_inputs(gen, B, L, C, len(ops), m, dtype)
        _compare(emu_lib, x, y, p, cfg, m)


# (inner ops, multiplier, C): a GLU and a ConcatFC phase and a 3-way
# out-conv whose depth (3 x 40) is not a multiple of bf16's MMA step, and a
# cell of every step kind with a 6-way out-conv 528 rows deep at C=88, more
# K-tiles than shared memory holds, so its weights take the ring
GEOMETRY_CELLS = {
    "odd-depth": (("LinearGLU", "ConcatFC"), 3, 40),
    "four-phases-ring": (("LinearGLU", "Sum", "ConcatFC", "ScaleDotAttn"),
                         6, 88),
}


def _geometry_case(emu_lib, cell, S, nt, dtype):
    B, L = 5, 8
    ops, m, C = GEOMETRY_CELLS[cell]
    cfg = _chain(ops)
    itemsize = 4 if dtype == torch.float32 else 2
    kk = 8 if itemsize == 4 else 16  # the MMA step
    geom = tnm.found_cell_geometry(emu_lib, B, L, C, cfg, m, itemsize, S, nt)
    for g in geom:
        if g["kind"] == "final":
            assert (g["samples_per_block"], g["blocks"]) == (1, B)
            continue
        assert (g["samples_per_block"], g["cols_per_block"]) == (S, nt)
        assert g["blocks"] == -(-B // S) * -(-C // nt)
        assert g["smem_bytes"] <= tnm.SMEM_LIMIT
        nsrc = m if g["kind"] == "out_conv" else 2
        depth = -(-nsrc * C // kk) * kk
        resident = g["k_tiles_resident"] * g["k_tile"]
        if cell == "four-phases-ring" and g["kind"] == "out_conv":
            assert resident < depth  # a ring: more than 8 K-tiles
        else:
            assert resident >= depth  # the whole slab
    gen = torch.Generator().manual_seed(S * 100 + nt)
    p, x, y = _cell_inputs(gen, B, L, C, len(ops), m, dtype)
    _compare(emu_lib, x, y, p, cfg, m, samples_per_block=S,
             cols_per_block=nt)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("S,nt", [(1, 16), (1, 32), (2, 16), (2, 32),
                                  (4, 16), (4, 32)])
def test_kernel_geometries(emu_lib, S, nt, dtype):
    """Each geometry the launcher can pick for the GEMM phases (one, two or
    four samples a block; 16 or 32 columns, ragged at C=40) at B=5 (a
    ragged last group), L=8, for a GLU, a ConcatFC and an out-conv phase
    whose bf16 depth pads to the MMA step, against the plain version on a
    NaN scratch, the weights whole in shared memory."""
    _geometry_case(emu_lib, "odd-depth", S, nt, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_kernel_weight_ring(emu_lib, dtype):
    """A cell of every step kind whose 6-way out-conv (528 rows deep at
    C=88) takes the weights through a ring of K-tiles, one sample and 16
    columns a block."""
    _geometry_case(emu_lib, "four-phases-ring", 1, 16, dtype)


@pytest.mark.parametrize("L,C,B,ops,m,picks", [
    (16, 192, 8, ("LinearGLU",), 1, [("glu", 1, 16, 96)]),
    (16, 192, 37, ("LinearGLU",), 1, [("glu", 2, 32, 114)]),
    (16, 192, 96, ("LinearGLU",), 1, [("whole", 1, 192, 96)]),
    (16, 192, 96, ("ConcatFC",), 1, [("whole", 1, 192, 96)]),
    (16, 192, 8, ("LinearGLU", "Sum"), 1, [("glu", 1, 16, 96),
                                           ("final", 1, 192, 8)]),
    (8, 128, 8, ("LinearGLU", "LinearGLU"), 2,
     [("glu", 1, 16, 64)] * 2 + [("out_conv", 1, 16, 64)]),
    (8, 128, 96, ("LinearGLU", "LinearGLU"), 2, [("whole", 1, 128, 96)]),
    (8, 128, 96, ("Sum", "ScaleDotAttn"), 2, [("whole", 1, 128, 96)]),
], ids=["mmimdb-glu-B8", "mmimdb-glu-B37", "mmimdb-glu-B96",
        "mmimdb-fc-B96", "mmimdb-glu-sum-B8", "ntu-glu-B8", "ntu-glu-B96",
        "ntu-sum-attn-B96"])
def test_found_launcher_fills_the_card(emu_lib, L, C, B, ops, m, picks):
    """At the MM-IMDB (L=16, C=192) and NTU (L=8, C=128) widths the
    launcher fills the card's 132 SMs: at B=8 and 37 it spreads each GEMM
    phase over them (one 512-thread block an SM; one sample and 16 columns
    a block at B=8, 96 and 64 blocks; two samples and 32 columns at B=37),
    a last phase of its own (a step after the last GEMM) a sample a block;
    at B=96, where B blocks fill more than half of them, it runs the whole
    cell in one block a sample. In fp32 and bf16, within the shared memory
    a block may take."""
    cfg = _chain(ops)
    for itemsize in (4, 2):
        geom = tnm.found_cell_geometry(emu_lib, B, L, C, cfg, m, itemsize)
        assert [(g["kind"], g["samples_per_block"], g["cols_per_block"],
                 g["blocks"]) for g in geom] == picks
        assert all(g["smem_bytes"] <= tnm.SMEM_LIMIT for g in geom)


# (inner ops, multiplier, B, design asked for, the design the call takes)
DESIGN_PICKS = [
    (("LinearGLU",), 1, 65, "auto", "phases"),
    (("LinearGLU",), 1, 66, "auto", "whole"),
    (("Sum", "ScaleDotAttn"), 2, 65, "auto", "phases"),
    (("Sum", "ScaleDotAttn"), 2, 66, "auto", "whole"),
    (("Sum",), 1, 1, "auto", "whole"),
    (("Sum", "Sum"), 1, 8, "auto", "whole"),
    (("ScaleDotAttn",), 1, 1, "auto", "whole"),
    (("Sum", "ScaleDotAttn"), 1, 96, "auto", "whole"),
    (("LinearGLU",), 1, 8, "whole", "whole"),
    (("LinearGLU",), 1, 96, "phases", "phases"),
]


@pytest.mark.parametrize("ops,m,B,design,want", DESIGN_PICKS,
                         ids=[f"{'-'.join(o)}-m{m}-B{B}-{d}"
                              for o, m, B, d, _ in DESIGN_PICKS])
def test_found_launcher_picks_the_design(emu_lib, ops, m, B, design, want):
    """On 132 SMs at L=8, C=128 the launcher runs a cell with a GEMM step
    or an out-conv as phases up to B=65 and in one block a sample from
    B=66 (half the SMs), a cell without a GEMM (Sums, attentions) in one
    block a sample at any B; a design asked for is the one taken, and a
    fixed GEMM geometry asks for the phases."""
    cfg = _chain(ops)
    geom = tnm.found_cell_geometry(emu_lib, B, 8, 128, cfg, m, 4,
                                   design=design)
    got = "whole" if [g["kind"] for g in geom] == ["whole"] else "phases"
    assert got == want
    if want == "whole":
        (g,) = geom
        assert (g["samples_per_block"], g["blocks"], g["threads"]) == (
            1, B, 256)
    if want == "whole" and design == "auto":
        fixed = tnm.found_cell_geometry(emu_lib, B, 8, 128, cfg, m, 4,
                                        samples_per_block=2)
        assert all(g["kind"] != "whole" for g in fixed)


# (inner ops, multiplier, B, L, C): the whole cell in one block a sample,
# asked for: every phase-plan cell at B=3 (a block of 64 threads), a ring
# of K-tiles deeper than the double buffer (C=88: 2C = 176 rows of 32), and
# two row tiles, the second ragged (L=20)
WHOLE_CELLS = [(o, m, 3, 8, 16) for o, m, _ in PHASE_PLANS] + [
    (("LinearGLU", "Sum", "ConcatFC", "ScaleDotAttn"), 6, 2, 8, 88),
    (("ConcatFC", "ScaleDotAttn"), 2, 2, 20, 32),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("ops,m,B,L,C", WHOLE_CELLS,
                         ids=[f"{'-'.join(o)}-m{m}-L{L}-C{C}"
                              for o, m, _, L, C in WHOLE_CELLS])
def test_kernel_whole_design(emu_lib, ops, m, B, L, C, dtype):
    """The whole cell in one block a sample against
    ``found_node_cell_reference`` on a NaN scratch, which it never
    reads."""
    cfg = _chain(ops)
    itemsize = 4 if dtype == torch.float32 else 2
    (g,) = tnm.found_cell_geometry(emu_lib, B, L, C, cfg, m, itemsize,
                                   design="whole")
    assert (g["kind"], g["blocks"], g["threads"]) == (
        "whole", B, 2 * -(-C // 32) * 32)
    gen = torch.Generator().manual_seed(len(ops) * 10 + m + L)
    p, x, y = _cell_inputs(gen, B, L, C, len(ops), m, dtype)
    _compare(emu_lib, x, y, p, cfg, m, design="whole")


def test_kernel_whole_design_none_edges(emu_lib):
    """The whole cell in one block a sample with 'none' inner edges in an
    attention, a GEMM and a Sum, at B=37."""
    L, C = 8, 16
    for edges, ops, m in NONE_EDGE_CELLS.values():
        cfg = tnm.found_cell_steps_cfg(edges, ops)
        gen = torch.Generator().manual_seed(37)
        p, x, y = _cell_inputs(gen, 37, L, C, len(ops), m, torch.float32)
        _compare(emu_lib, x, y, p, cfg, m, design="whole")


def test_kernel_tickets_return_to_zero(emu_lib):
    """A phase that ends the cell takes a ticket a sample group; the last
    block of each group leaves it at 0, so one buffer serves call after
    call, and the same input gives the same output bit for bit."""
    B, L, C = 3, 8, 24
    cfg = _chain(("ConcatFC", "LinearGLU"))
    gen = torch.Generator().manual_seed(21)
    p, x, y = _cell_inputs(gen, B, L, C, 2, 2, torch.float32)
    tickets = torch.zeros(B, dtype=torch.int32)
    outs = []
    for S, nt in [(2, 16), (1, 16), (2, 16)]:
        outs.append(tnm.launch(emu_lib, x, y, p, cfg, 2, 1e-5, None,
                               _nan_scratch(x, cfg), S, nt, tickets))
        assert not tickets.any()
    assert torch.equal(outs[0], outs[2])
    want = tnm.found_node_cell_reference(x, y, p, cfg, 2)
    for got in outs:
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_smem_bytes_match_the_kernel(emu_lib):
    """``found_cell_smem_bytes`` in Python (what the blocker reads) equals
    the C function for every cell of these tests, both storage types and
    several widths and lengths."""
    cells = [(_chain(o), m) for _, m, o in CONFIGS]
    cells += [(_chain(o), m) for o, m, _ in PHASE_PLANS]
    cells += [(_chain(o), m) for o, m, _ in GEOMETRY_CELLS.values()]
    cells += [(tnm.found_cell_steps_cfg(e, o), m)
              for e, o, m in NONE_EDGE_CELLS.values()]
    for cfg, m in cells:
        for L, C in [(8, 16), (16, 192), (8, 128), (20, 88), (64, 256)]:
            for itemsize in (4, 2):
                want = emu_lib.found_cell_smem_bytes(
                    L, C, len(cfg), m, *tnm._steps_arrays(cfg), itemsize)
                assert tnm.found_cell_smem_bytes(
                    L, C, cfg, m, itemsize) == want, (cfg, m, L, C)


def test_kernel_refuses_geometry(emu_lib):
    """Three samples a block is refused by the C function; a cell longer
    than a GEMM block's rows is refused by the binding."""
    gen = torch.Generator().manual_seed(9)
    cfg = _chain(("LinearGLU",))
    p, x, y = _cell_inputs(gen, 4, 8, 16, 1, 1, torch.float32)
    with pytest.raises(RuntimeError, match="launch failed"):
        tnm.launch(emu_lib, x, y, p, cfg, 1, 1e-5, None,
                   samples_per_block=3)
    L = tnm.FOUND_MAX_L + 1
    p, x, y = _cell_inputs(gen, 1, L, 8, 1, 1, torch.float32)
    with pytest.raises(ValueError, match="cannot host"):
        tnm.launch(emu_lib, x, y, p, cfg, 1, 1e-5, None)


# ---------------------------------------------------------------------------
# node_mixed.cu
# ---------------------------------------------------------------------------

def _mixed_params(gen, L, C, dtype):
    def r(*shape, k=1.0):
        return (torch.randn(*shape, generator=gen) * k).to(dtype)
    w = 1.0 / math.sqrt(2 * C)
    return tnm.NodeMixedParams(
        ln_scale=r(L, C), ln_bias=r(L, C),
        glu_kernel=r(2 * C, 2 * C, k=w), glu_bias=r(2 * C, k=0.1),
        cfc_kernel=r(2 * C, C, k=w), cfc_bias=r(C, k=0.1))


GAMMAS = {"softmax": None, "sum": 0, "attn": 1, "glu": 2, "fc": 3}


@pytest.mark.parametrize("same", [False, True], ids=["x-y", "x-is-y"])
@pytest.mark.parametrize("gammas", list(GAMMAS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_node_mixed_matches_reference(emu_libs, dtype, gammas, same):
    """B=3, L=8, C=16 (one row tile, half of it past the last row), with
    softmaxed or one-hot branch weights, and x and y one tensor or two."""
    B, L, C = 3, 8, 16
    gen = torch.Generator().manual_seed(5)
    p = _mixed_params(gen, L, C, dtype)
    x = torch.randn(B, L, C, generator=gen).to(dtype)
    y = x if same else torch.randn(B, L, C, generator=gen).to(dtype)
    if GAMMAS[gammas] is None:
        g = torch.randn(4, generator=gen).softmax(0)
    else:
        g = torch.nn.functional.one_hot(torch.tensor(GAMMAS[gammas]),
                                        4).float()
    tnm._check_mixed(x, y, g, p)
    got = tnm.launch_mixed(emu_libs["node_mixed"], x, y, g, p, 1e-5,
                           None).float()
    want = tnm.node_mixed_op_reference(x, y, g, p).float()
    tol = TOLS[dtype]
    assert torch.isfinite(got).all()
    assert ((got - want).abs() <= tol + tol * want.abs()).all(), float(
        (got - want).abs().max())


def test_node_mixed_two_row_tiles(emu_libs):
    """L=20 (a full row tile, then a ragged one) and C=32 (several K-tiles
    for both GEMMs)."""
    B, L, C = 2, 20, 32
    gen = torch.Generator().manual_seed(6)
    p = _mixed_params(gen, L, C, torch.float32)
    x, y = (torch.randn(B, L, C, generator=gen) for _ in range(2))
    g = torch.randn(4, generator=gen).softmax(0)
    got = tnm.launch_mixed(emu_libs["node_mixed"], x, y, g, p, 1e-5, None)
    want = tnm.node_mixed_op_reference(x, y, g, p)
    assert ((got - want).abs() <= 1e-4 + 1e-4 * want.abs()).all()


def test_node_mixed_refuses_width(emu_libs):
    """The C function refuses a width it cannot host; the binding raises."""
    B, L, C = 2, 8, 12
    gen = torch.Generator().manual_seed(7)
    p = _mixed_params(gen, L, C, torch.float32)
    x = torch.randn(B, L, C, generator=gen)
    with pytest.raises(RuntimeError, match="launch failed"):
        tnm.launch_mixed(emu_libs["node_mixed"], x, x, torch.ones(4) / 4, p,
                         1e-5, None)


# (B, L, C, samples a block, columns a block, x is y); 0: the launcher picks
MIXED_GEOMETRY_CASES = {
    "ragged-group": (5, 8, 32, 2, 0, False),   # groups of 2, the last of 1
    "ntu-width": (4, 8, 128, 2, 0, False),     # two samples, one row tile
    "c256": (2, 8, 256, 0, 32, False),         # the widest C, 8 K-tiles
    "x-is-y-ragged-cols": (3, 16, 48, 2, 32, True),  # columns 48..63 empty
    "four-samples": (6, 16, 32, 4, 16, False),  # 64 rows, 2 tiles a warp
    "three-row-tiles": (3, 24, 16, 2, 0, False),  # a unit of one row tile
    "odd-length": (5, 7, 24, 0, 0, False),     # L not a multiple of 4
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", list(MIXED_GEOMETRY_CASES))
def test_node_mixed_geometries(emu_libs, case, dtype):
    """Blocks of several samples with a ragged last group, the NTU/Ego
    width, C=256, a ragged last column tile and x is y, against
    ``node_mixed_op_reference`` at the kernel tests' tolerances."""
    B, L, C, S, nt, same = MIXED_GEOMETRY_CASES[case]
    gen = torch.Generator().manual_seed(B * 1000 + C)
    p = _mixed_params(gen, L, C, dtype)
    x = torch.randn(B, L, C, generator=gen).to(dtype)
    y = x if same else torch.randn(B, L, C, generator=gen).to(dtype)
    g = torch.randn(4, generator=gen).softmax(0)
    lib = emu_libs["node_mixed"]
    geom = tnm.mixed_geometry(lib, B, L, C, x.element_size(), S, nt)
    assert (S or geom["samples_per_block"]) == geom["samples_per_block"]
    assert (nt or geom["cols_per_block"]) == geom["cols_per_block"]
    got = tnm.launch_mixed(lib, x, y, g, p, 1e-5, None, S, nt).float()
    want = tnm.node_mixed_op_reference(x, y, g, p).float()
    tol = TOLS[dtype]
    assert torch.isfinite(got).all()
    assert ((got - want).abs() <= tol + tol * want.abs()).all(), float(
        (got - want).abs().max())


@pytest.mark.parametrize("B,S,nt,blocks", [
    (8, 1, 16, 96), (37, 2, 32, 114), (96, 2, 32, 288)])
def test_node_mixed_launcher_fills_the_card(emu_libs, B, S, nt, blocks):
    """At the MM-IMDB width (L=16, C=192) the launcher takes the least
    waves over 132 SMs (one 512-thread block an SM) times each block's
    rows x columns plus its fixed cost, in fp32 and bf16: the smallest
    blocks at the search batch, two samples and 32 columns a block above
    it."""
    for itemsize in (4, 2):
        geom = tnm.mixed_geometry(emu_libs["node_mixed"], B, 16, 192,
                                  itemsize)
        assert (geom["samples_per_block"], geom["cols_per_block"],
                geom["blocks"]) == (S, nt, blocks)
        assert geom["smem_bytes"] <= tnm.SMEM_LIMIT


def test_node_mixed_refuses_geometry(emu_libs):
    """Three samples a block is refused by the C function; more rows than
    a block's accumulators hold is refused by the binding."""
    gen = torch.Generator().manual_seed(8)
    lib = emu_libs["node_mixed"]
    p = _mixed_params(gen, 8, 16, torch.float32)
    x = torch.randn(4, 8, 16, generator=gen)
    with pytest.raises(RuntimeError, match="launch failed"):
        tnm.launch_mixed(lib, x, x, torch.ones(4) / 4, p, 1e-5, None, 3, 0)
    L = tnm.MIXED_MAX_L + 1
    p = _mixed_params(gen, L, 8, torch.float32)
    x = torch.randn(1, L, 8, generator=gen)
    with pytest.raises(ValueError, match="does not fit one block"):
        tnm.launch_mixed(lib, x, x, torch.ones(4) / 4, p, 1e-5, None)


# ---------------------------------------------------------------------------
# attention.cu
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("B,Lq,Lk,scale", [
    (2, 5, 3, 1.0),      # Lk and Lq below one tile, Lq != Lk
    (1, 70, 130, 1.0),   # two query tiles, three key tiles, both ragged
    (1, 9, 67, 30.0),    # large scores across a ragged key tile
], ids=["short", "ragged-tiles", "x30"])
def test_attention_matches_reference(emu_libs, B, Lq, Lk, scale, dtype):
    """C=24 (six channel quads, not a power of two) through the port's
    binding against ``reference_attention`` on the same inputs; fp32
    output whatever the input type."""
    gen = torch.Generator().manual_seed(Lq * 1000 + Lk)
    x = (torch.randn(B, Lq, 24, generator=gen) * scale).to(dtype)
    y = (torch.randn(B, Lk, 24, generator=gen) * scale).to(dtype)
    tat._check(x, y, 128, 128)
    got = tat.launch(emu_libs["attention"], x, y, None)
    want = tat.reference_attention(x, y)
    assert got.dtype == torch.float32 and got.shape == (B, Lq, 24)
    assert torch.isfinite(got).all()
    # the JAX kernel test's tolerances: 2e-4 / 2e-5, 1e-3 for the x30 case
    rtol, atol = (2e-4, 2e-5) if scale == 1.0 else (1e-3, 1e-3)
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol)


def test_attention_refuses_width(emu_libs):
    """The C function refuses C=12; the binding raises."""
    x = torch.randn(1, 4, 12)
    with pytest.raises(RuntimeError, match="launch failed"):
        tat.launch(emu_libs["attention"], x, x, None)


def _attention_case(lib, B, Lq, Lk, C, dtype, seed, scale=1.0, **geom):
    """The kernel (the launcher's geometry, or the one ``geom`` fixes)
    against ``reference_attention`` on the same inputs, at the JAX kernel
    test's tolerances: both sides read the same bf16 values and sum in
    fp32, so bf16 is held to them too."""
    gen = torch.Generator().manual_seed(seed)
    x = (torch.randn(B, Lq, C, generator=gen) * scale).to(dtype)
    y = (torch.randn(B, Lk, C, generator=gen) * scale).to(dtype)
    tat._check(x, y, 128, 128)
    got = tat.launch(lib, x, y, None, **geom)
    want = tat.reference_attention(x, y)
    assert got.dtype == torch.float32 and got.shape == (B, Lq, C)
    assert torch.isfinite(got).all()
    rtol, atol = (2e-4, 2e-5) if scale == 1.0 else (1e-3, 1e-3)
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("C", [192, 256])
def test_attention_wide_channels(emu_libs, C, dtype):
    """The MM-IMDB width and the widest C at ragged lengths (Lq=33: three
    query groups, the last of one row; Lk=70: a full key tile and a ragged
    one); C=256 needs two warps a group for its 16 output tiles."""
    _attention_case(emu_libs["attention"], 1, 33, 70, C, dtype, seed=C)


def test_attention_bf16_ragged_key_tile(emu_libs):
    """C=24 bf16 (padded to 32 channels in shared memory) with 32-key tiles,
    the last of 13 keys: its zero rows and masked scores."""
    _attention_case(emu_libs["attention"], 2, 20, 45, 24, torch.bfloat16,
                    seed=45, bk=32)


# (wq, wc, bk): every way a block splits its work
ATTN_GEOMETRIES = [(1, 1, 32), (1, 4, 64), (2, 2, 32), (4, 2, 64)]


def _max_moves(x, y, bk, slack=8.0):
    """Whether some row's score max (log2 units) rises past the kernel's
    running max by more than its slack after the first key tile, so that
    the accumulator is rescaled."""
    s = torch.einsum("blc,bmc->blm", x.double(), y.double()) \
        / math.sqrt(x.shape[-1]) * math.log2(math.e)
    m = s[..., :bk].amax(-1)
    for k0 in range(bk, s.shape[-1], bk):
        t = s[..., k0:k0 + bk].amax(-1)
        if bool((t > m + slack).any()):
            return True
        m = torch.where(t > m + slack, t, m)
    return False


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("wq,wc,bk", ATTN_GEOMETRIES,
                         ids=[f"wq{a}-wc{b}-bk{c}" for a, b, c in
                              ATTN_GEOMETRIES])
def test_attention_geometries(emu_libs, wq, wc, bk, dtype):
    """C=40 (three output tiles, so warps own different counts of them),
    Lq=37, Lk=100 under each geometry. Key j is scaled by 1 + 0.05 j, so
    the running max moves in later key tiles and O is rescaled, while the
    softmax stays well conditioned: the fp32 reference is within the
    tolerances of a float64 one, and the kernel is held to them."""
    lib = emu_libs["attention"]
    itemsize = 4 if dtype == torch.float32 else 2
    geom = tat.geometry(lib, 2, 37, 100, 40, itemsize, wq, wc, bk)
    assert (geom["wq"], geom["wc"], geom["bk"]) == (wq, wc, bk)
    assert geom["threads"] == 32 * wq * wc
    assert geom["blocks"] == 2 * -(-37 // (16 * wq))
    gen = torch.Generator().manual_seed(wq * 100 + wc * 10 + bk)
    x = torch.randn(2, 37, 40, generator=gen).to(dtype)
    ramp = 1 + 0.05 * torch.arange(100).view(1, 100, 1)
    y = (torch.randn(2, 100, 40, generator=gen) * ramp).to(dtype)
    assert _max_moves(x, y, bk)
    got = tat.launch(lib, x, y, None, wq=wq, wc=wc, bk=bk)
    want = tat.reference_attention(x, y)
    xd, yd = x.double(), y.double()
    exact = (torch.einsum("blc,bmc->blm", xd, yd) / math.sqrt(40)).softmax(
        -1) @ yd
    torch.testing.assert_close(want.double(), exact, rtol=2e-4, atol=2e-5)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("B,L,pick", [
    (8, 512, (2, 4, 64, 128)),
    (8, 4096, (4, 2, 64, 512)),
    (1, 16, (1, 4, 64, 1)),
], ids=["B8-L512", "B8-L4096", "B1-L16"])
def test_attention_launcher_picks(emu_libs, B, L, pick):
    """At C=192 the launcher spreads the work over the card's 132 SMs: at
    L=512 two query groups of four warps a block (128 blocks, one wave), at
    L=4096 four groups of two warps (512 blocks), at B=1, L=16 one group of
    four warps; in fp32 and bf16, within the shared memory a block may
    take."""
    for itemsize in (4, 2):
        g = tat.geometry(emu_libs["attention"], B, L, L, 192, itemsize)
        assert (g["wq"], g["wc"], g["bk"], g["blocks"]) == pick, g
        assert g["blocks_per_sm"] >= 1
        assert g["smem_bytes"] <= tnm.SMEM_LIMIT
    assert emu_libs["attention"].attention_smem_bytes(256, 4) \
        <= tnm.SMEM_LIMIT


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_stand_in_col_major_load(emu_libs, dtype):
    """The stand-in's col_major B operand read from a row-major k gives
    a k^T: one warp's MMA against the transposed product, on values exact
    in TF32 and bf16."""
    kk = 8 if dtype == torch.float32 else 16
    gen = torch.Generator().manual_seed(kk)
    a = (torch.randint(-8, 9, (16, kk), generator=gen) / 4).to(dtype)
    k = (torch.randint(-8, 9, (16, kk), generator=gen) / 4).to(dtype)
    d = torch.full((16, 16), float("nan"))
    rc = emu_libs["selftest"].emu_col_major_product(
        ctypes.c_int(int(dtype == torch.bfloat16)),
        ctypes.c_void_p(a.data_ptr()), ctypes.c_void_p(k.data_ptr()),
        ctypes.c_void_p(d.data_ptr()))
    assert rc == 0
    torch.testing.assert_close(d, a.float() @ k.float().T, rtol=0, atol=0)
