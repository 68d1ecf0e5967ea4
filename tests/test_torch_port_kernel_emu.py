"""The port's CUDA kernels' own code, run on the CPU by emulation.

There is no CUDA compiler or card on the test host, so
``bmnas_tpu_torch/csrc/found_cell.cu``, ``node_mixed.cu`` and
``attention.cu``, with their shared ``cell_common.cuh``, are compiled as
C++ against stand-in CUDA
headers: one ``std::thread`` per CUDA thread, a ``std::barrier`` for
``__syncthreads``, per-warp barriers for the shuffles, ``cp.async`` as a
plain 16-byte copy, blocks one after another, shared memory allocated at
exactly the launch's size and filled with NaNs. What it checks is the
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
inline void __syncthreads() { g_block_barrier->arrive_and_wait(); }
inline float __shfl_xor_sync(unsigned, float v, int o) {
  const int t = threadIdx.x, w = t >> 5;
  g_shfl[t] = v;
  g_warp_barriers[w]->arrive_and_wait();
  const float r = g_shfl[(w << 5) | ((t & 31) ^ o)];
  g_warp_barriers[w]->arrive_and_wait();
  return r;
}
inline float rsqrtf(float x) { return 1.f / std::sqrt(x); }
struct float4 { float x, y, z, w; };
struct float2 { float x, y; };
struct uint2 { unsigned x, y; };
inline float4 make_float4(float a, float b, float c, float d) {
  return {a, b, c, d};
}
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
typedef struct CUstream_st* cudaStream_t;
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
template <class T>
cudaError_t cudaFuncSetAttribute(T, cudaFuncAttribute, int) {
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
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

EMU_RUNTIME_CPP = r"""
#include "cuda_runtime.h"
#include <cstdlib>
thread_local uint3_ threadIdx, blockIdx;
uint3_ blockDim;
std::barrier<>* g_block_barrier;
std::vector<std::unique_ptr<std::barrier<>>> g_warp_barriers;
float g_shfl[1024];
float* g_smem;
void emu_launch(int blocks, int threads, size_t bytes,
                std::function<void()> body) {
  blockDim = {unsigned(threads), 1, 1};
  for (int b = 0; b < blocks; ++b) {
    g_smem = static_cast<float*>(
        std::aligned_alloc(16, (bytes + 15) / 16 * 16));
    std::memset(g_smem, 0xff, bytes);  // NaNs: unset reads show
    std::barrier<> bar(threads);
    g_block_barrier = &bar;
    g_warp_barriers.clear();
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


def _emulated_header(src: str) -> str:
    """cell_common.cuh with its inline PTX replaced."""
    stand_ins = {
        "cp_async16": "inline void cp_async16(void* s, const void* g) "
                      "{ std::memcpy(s, g, 16); }",
        "cp_async_commit": "inline void cp_async_commit() {}",
        "cp_async_wait_one": "inline void cp_async_wait_one() {}",
    }
    for name, body in stand_ins.items():
        src, n = re.subn(r"__device__ __forceinline__ void " + name
                         + r"\(.*?\n\}", body, src, flags=re.S)
        assert n == 1, name
    assert "asm" not in src
    return src


def _emulated_source(src: str) -> str:
    """A kernel source with its launch syntax replaced."""
    old = "extern __shared__ __align__(16) float smem[];"
    assert src.count(old) == 1
    src = src.replace(old, "float* smem = g_smem;")
    # kernel<T><<<grid, block, smem, stream>>>(args): the stream is dropped
    src, n = re.subn(r"(\w+_kernel<T>)<<<([^,]+,[^,]+,[^,]+),[^>]*>>>"
                     r"\((.*?)\);",
                     r"emu_launch(\2, [=]() { \1(\3); });", src,
                     flags=re.S)
    assert n == 1
    assert "asm" not in src
    return '#include "cuda_runtime.h"\n' + src


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
    with open(os.path.join(_build.CSRC, "cell_common.cuh")) as f:
        files["cell_common.cuh"] = _emulated_header(f.read())
    for name in KERNELS:
        with open(os.path.join(_build.CSRC, f"{name}.cu")) as f:
            files[f"{name}_emu.cpp"] = _emulated_source(f.read())
    for name, text in files.items():
        (d / name).write_text(text)
    so = d / "libcell_kernels_emu.so"
    subprocess.run([cxx, "-std=c++20", "-O1", "-shared", "-fPIC",
                    f"-I{d}", "-o", str(so),
                    *[str(d / f"{name}_emu.cpp") for name in KERNELS],
                    str(d / "emu_runtime.cpp"), "-lpthread"],
                   check=True, capture_output=True, timeout=300)
    return {"found_cell": tnm.bind(ctypes.CDLL(str(so))),
            "node_mixed": tnm.bind_mixed(ctypes.CDLL(str(so))),
            "attention": tat.bind(ctypes.CDLL(str(so)))}


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


def _compare(lib, x, y, p, cfg, m):
    tnm._check(x, y, p, cfg, m)
    got = tnm.launch(lib, x, y, p, cfg, m, 1e-5, None).float()
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
