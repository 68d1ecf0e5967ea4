"""The found-cell kernel run on the CPU by emulation
(``tests/_kernel_emu.py``) at the NTU and Ego serving widths, L=8, C=128,
and in each geometry the launcher can pick for the GEMM phases, against
``found_node_cell_reference``. Skips where there is no ``g++``. The other
found-cell cases are in ``tests/test_torch_port_kernel_emu_found.py``.
"""
import pytest
import torch

from _kernel_emu import (  # noqa: F401 (fixtures)
    cell_inputs,
    chain,
    compare_found,
    emu_lib,
    emu_libs,
    found_params,
    geometry_case,
)
from bmnas_tpu_torch.ops.kernels import node_mixed as tnm


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
    p = found_params(gen, 2, 2, L, C, dtype)
    x = torch.randn(B, L, C, generator=gen).to(dtype)
    y = torch.randn(B, L, C, generator=gen).to(dtype)
    compare_found(emu_lib, x, y, p, cfg, 2)


# the Ego serving width's cells (chip_smoke.py phase 12): three chained
# inner steps and multiplier 3, so the out-conv reads 3C = 384 rows; the
# two served cells hold every inner op between them, and the third puts a
# Sum and an attention after its GEMM step, in the out-conv's phase
EGO_CELLS = [("ScaleDotAttn", "LinearGLU", "ConcatFC"),
             ("Sum", "ConcatFC", "LinearGLU"),
             ("LinearGLU", "Sum", "ScaleDotAttn")]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("design", ["phases", "whole"])
@pytest.mark.parametrize("ops", EGO_CELLS, ids=lambda ops: "-".join(ops))
def test_kernel_ego_width(emu_lib, ops, design, dtype):
    """The Ego serving width, L=8, C=128, with its cells of three chained
    steps and multiplier 3, in both designs: the phases (the last an
    out-conv 384 rows deep, which ends the cell) and one block a sample.
    B=2 (the serving phase's CUDA-vs-CPU batch), on a NaN scratch."""
    B, L, C = 2, 8, 128
    cfg = chain(ops)
    itemsize = 4 if dtype == torch.float32 else 2
    geom = tnm.found_cell_geometry(emu_lib, B, L, C, cfg, 3, itemsize,
                                   design=design)
    if design == "whole":
        assert [g["kind"] for g in geom] == ["whole"]
    else:
        assert geom[-1]["kind"] == "out_conv" and geom[-1]["fused"]
        assert all(g["smem_bytes"] <= tnm.SMEM_LIMIT for g in geom)
    assert tnm.found_cell_blocker(
        tuple(e for i in range(3) for e in (("skip", i), ("skip", i + 1))),
        ops, C, L, 3) == ""
    gen = torch.Generator().manual_seed(16)
    p, x, y = cell_inputs(gen, B, L, C, 3, 3, dtype)
    compare_found(emu_lib, x, y, p, cfg, 3, design=design)


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
    geometry_case(emu_lib, "odd-depth", S, nt, dtype)
