"""Shared stand-ins of the kernel emulation tests
(``tests/test_torch_port_kernel_emu_{found,found_shapes,mixed,attention}.py``)
and the found cell's cases that the two found files share.

There is no CUDA compiler or card on the test host, so
``bmnas_tpu_torch/csrc/found_cell.cu``, ``node_mixed.cu`` and
``attention.cu``, with their headers ``cell_common.cuh``,
``tc_gemm.cuh``, ``cell_gemm.cuh`` and ``cell_whole.cuh``, are compiled as
C++ against stand-in CUDA
headers: one ``std::thread`` per CUDA thread, a ``std::barrier`` for
``__syncthreads``, per-warp barriers for the shuffles and for a
warp-collective WMMA (each lane holds a slice of every fragment; a TF32
operand's low 13 bits are cut, as the tensor cores read it, and
``__float_to_tf32`` rounds to 10 mantissa bits, so the low half of 3xTF32
counts; a misaligned WMMA pointer fails the launch), ``cp.async`` as a
16-byte copy that lands only when a ``wait_group`` retires its group,
blocks one after another, shared memory allocated at exactly the launch's
size and filled with NaNs. What the tests check is the
kernels' indexing, tiling, staging and synchronisation order, through the
port's own ctypes bindings (``node_mixed.bind`` / ``launch``,
``bind_mixed`` / ``launch_mixed`` and ``attention.bind`` / ``launch``),
against ``found_node_cell_reference``, ``node_mixed_op_reference`` and
``reference_attention``. They cannot check timing, memory ordering
on the card or the compiler's output; ``chip_smoke.py`` does that.

pytest does not collect this module (its name does not start with
``test_``). Each test module imports the fixtures ``emu_libs`` (the three
kernels and the emulated runtime in one library, built once a module by
``g++``; the module skips where there is no ``g++``) and ``emu_lib``.
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
# the cell kernels against their plain versions (abs + rel)
TOLS = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


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


# the found cell's cases, shared by the found files

def found_params(gen, S, m, L, C, dtype):
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


def nan_scratch(x, cfg):
    """The kernel's scratch filled with NaNs: a state read before it is
    written shows in the output."""
    B, L, C = x.shape
    return torch.full((tnm.found_cell_scratch_numel(B, L, C, len(cfg)),),
                      float("nan"))


def compare_found(lib, x, y, p, cfg, m, **geom):
    scratch = nan_scratch(x, cfg)
    tnm._check(x, y, p, cfg, m, scratch)
    got = tnm.launch(lib, x, y, p, cfg, m, 1e-5, None, scratch,
                     **geom).float()
    want = tnm.found_node_cell_reference(x, y, p, cfg, m).float()
    tol = TOLS[x.dtype]
    assert torch.isfinite(got).all()
    assert ((got - want).abs() <= tol + tol * want.abs()).all(), float(
        (got - want).abs().max())


def cell_inputs(gen, B, L, C, S, m, dtype):
    p = found_params(gen, S, m, L, C, dtype)
    x = torch.randn(B, L, C, generator=gen).to(dtype)
    y = torch.randn(B, L, C, generator=gen).to(dtype)
    return p, x, y


def chain(ops):
    return tnm.found_cell_steps_cfg(
        tuple(e for i in range(len(ops)) for e in (("skip", i),
                                                   ("skip", i + 1))), ops)


# (inner ops, multiplier, C): a GLU and a ConcatFC phase and a 3-way
# out-conv whose depth (3 x 40) is not a multiple of bf16's MMA step, and a
# cell of every step kind with a 6-way out-conv 528 rows deep at C=88, more
# K-tiles than shared memory holds, so its weights take the ring
GEOMETRY_CELLS = {
    "odd-depth": (("LinearGLU", "ConcatFC"), 3, 40),
    "four-phases-ring": (("LinearGLU", "Sum", "ConcatFC", "ScaleDotAttn"),
                         6, 88),
}


def geometry_case(emu_lib, cell, S, nt, dtype):
    B, L = 5, 8
    ops, m, C = GEOMETRY_CELLS[cell]
    cfg = chain(ops)
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
    p, x, y = cell_inputs(gen, B, L, C, len(ops), m, dtype)
    compare_found(emu_lib, x, y, p, cfg, m, samples_per_block=S,
             cols_per_block=nt)
