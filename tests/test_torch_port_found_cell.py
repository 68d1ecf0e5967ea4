"""The port's found-cell plain version vs the JAX Pallas kernel and cell.

``found_node_cell_reference`` (what the CUDA kernel is held against on the
card) must compute what ``bmnas_tpu``'s ``found_node_cell_multi_fused``
computes (run here in Pallas interpret mode) and what JAX's
``FoundNodeCell`` computes in eval mode. B=3, L=8, C=16, fp32 on the CPU,
tolerance 2e-4 (the JAX package's own for this kernel).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bmnas_tpu.models.foundnet import FoundNodeCell as JFoundNodeCell
from bmnas_tpu.ops.kernels import node_mixed as jnm
from bmnas_tpu_torch.models.foundnet import FoundNodeCell
from bmnas_tpu_torch.ops.kernels import LAUNCHES, reset_launches
from bmnas_tpu_torch.ops.kernels import node_mixed as tnm
from bmnas_tpu_torch.utils.convert import state_dict_from_jax

B, L, C = 3, 8, 16
TOL = dict(rtol=2e-4, atol=2e-4)

# (node_steps, node_multiplier, inner ops): the seven kernel configurations
CONFIGS = [
    (1, 1, ("Sum",)),
    (1, 1, ("ScaleDotAttn",)),
    (1, 1, ("LinearGLU",)),
    (1, 1, ("ConcatFC",)),
    (2, 2, ("ConcatFC", "ScaleDotAttn")),
    (2, 2, ("LinearGLU", "LinearGLU")),  # repeated class: name counters
    (3, 1, ("ScaleDotAttn", "Sum", "ConcatFC")),
]
IDS = ["-".join(ops) + f"-m{m}" for _, m, ops in CONFIGS]


def _chain_edges(node_steps):
    """Step i reads states (i, i+1): exercises chaining."""
    return tuple(e for i in range(node_steps)
                 for e in (("skip", i), ("skip", i + 1)))


def _random_params(rng, S, m):
    f = lambda *s, k=1.0: rng.randn(*s).astype(np.float32) * k  # noqa: E731
    p = dict(ln1_scale=f(S, L, C), ln1_bias=f(S, L, C),
             glu_kernel=f(S, 2 * C, 2 * C, k=0.1), glu_bias=f(S, 2 * C),
             cfc_kernel=f(S, 2 * C, C, k=0.1), cfc_bias=f(S, C),
             oc_kernel=f(m * C, C, k=0.1) if m != 1 else None,
             oc_bias=f(C) if m != 1 else None,
             ln2_scale=f(L, C), ln2_bias=f(L, C))
    return p


def _jax_params(p):
    return jnm.FoundCellParams(**{k: None if v is None else jnp.asarray(v)
                                  for k, v in p.items()})


def _port_params(p):
    return tnm.FoundCellParams(**{k: None if v is None else
                                  torch.from_numpy(v) for k, v in p.items()})


@pytest.mark.parametrize("node_steps,m,ops", CONFIGS, ids=IDS)
def test_reference_matches_pallas_kernel(node_steps, m, ops):
    rng = np.random.RandomState(node_steps * 10 + m)
    x, y = (rng.randn(B, L, C).astype(np.float32) for _ in range(2))
    p = _random_params(rng, node_steps, m)
    cfg = jnm.found_cell_steps_cfg(_chain_edges(node_steps), ops)
    assert tnm.found_cell_steps_cfg(_chain_edges(node_steps), ops) == cfg
    want = jnm.found_node_cell_multi_fused(
        jnp.asarray(x), jnp.asarray(y), _jax_params(p), cfg, multiplier=m,
        interpret=True)
    got = tnm.found_node_cell_reference(
        torch.from_numpy(x), torch.from_numpy(y), _port_params(p), cfg, m)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_reference_none_edges_match_pallas_kernel():
    """A 'none' inner edge feeds zeros (attention over a zero key set, and
    a GLU reading one zero half)."""
    rng = np.random.RandomState(7)
    x, y = (rng.randn(B, L, C).astype(np.float32) for _ in range(2))
    edges = (("none", 0), ("skip", 1), ("skip", 2), ("none", 0))
    ops = ("ScaleDotAttn", "LinearGLU")
    p = _random_params(rng, 2, 1)
    cfg = jnm.found_cell_steps_cfg(edges, ops)
    want = jnm.found_node_cell_multi_fused(
        jnp.asarray(x), jnp.asarray(y), _jax_params(p), cfg, interpret=True)
    got = tnm.found_node_cell_reference(
        torch.from_numpy(x), torch.from_numpy(y), _port_params(p), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _jax_cell_and_port(node_steps, m, ops, seed=0):
    rng = np.random.RandomState(seed)
    x, y = (rng.randn(B, L, C).astype(np.float32) for _ in range(2))
    edges = _chain_edges(node_steps)
    jcell = JFoundNodeCell(inner_edges=edges, inner_steps=ops,
                           node_steps=node_steps, node_multiplier=m, C=C,
                           L=L, drpt=0.0)
    variables = jcell.init(jax.random.PRNGKey(seed), jnp.asarray(x),
                           jnp.asarray(y), True)
    variables = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.rand(*a.shape).astype(np.float32) * 0.5,
        dict(variables))
    want = np.asarray(jcell.apply(variables, jnp.asarray(x), jnp.asarray(y),
                                  False))
    tcell = FoundNodeCell(edges, ops, node_steps, m, C, L, 0.0)
    tcell.load_state_dict(state_dict_from_jax(
        variables["params"], variables.get("batch_stats", {})))
    return tcell.eval(), variables, torch.from_numpy(x), \
        torch.from_numpy(y), want


@pytest.mark.parametrize("node_steps,m,ops", CONFIGS, ids=IDS)
def test_port_cell_matches_jax_cell(node_steps, m, ops):
    """Composite eval forward, the CPU wrapper path (fused_eval) and the
    folded parameters all agree with JAX; the CPU wrapper launches
    nothing."""
    tcell, variables, x, y, want = _jax_cell_and_port(node_steps, m, ops)
    with torch.no_grad():
        np.testing.assert_allclose(tcell(x, y).numpy(), want, **TOL)
        reset_launches()
        tcell.fused_eval = True
        np.testing.assert_allclose(tcell(x, y).numpy(), want, **TOL)
    assert LAUNCHES["found_cell"] == 0

    jp = jnm.found_cell_params_from_flax(variables, ops, C, L, m)
    tp = tcell.fold()
    for name in ("ln1_scale", "ln1_bias", "glu_kernel", "glu_bias",
                 "cfc_kernel", "cfc_bias", "oc_kernel", "oc_bias",
                 "ln2_scale", "ln2_bias"):
        j, t = getattr(jp, name), getattr(tp, name)
        assert (j is None) == (t is None), name
        if j is not None:
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5,
                                       atol=1e-6, err_msg=name)


def test_folded_params_dropped_on_load_and_train():
    tcell, variables, x, y, _ = _jax_cell_and_port(1, 1, ("LinearGLU",))
    tcell.fold()
    assert tcell._folded is not None
    tcell.load_state_dict(tcell.state_dict())
    assert tcell._folded is None
    tcell.fold()
    tcell.train()
    assert tcell._folded is None
    tcell.fold()
    tcell.to(torch.float64)
    assert tcell._folded is None


def test_bf16_reference_keeps_dtype():
    rng = np.random.RandomState(3)
    p = _port_params(_random_params(rng, 1, 1)).to(dtype=torch.bfloat16)
    x = torch.from_numpy(rng.randn(B, L, C).astype(np.float32))
    cfg = tnm.found_cell_steps_cfg((("skip", 0), ("skip", 1)), ("LinearGLU",))
    reset_launches()
    out = tnm.found_node_cell_fused(x.bfloat16(), x.bfloat16(), p, cfg)
    assert out.dtype == torch.bfloat16 and out.shape == x.shape
    assert torch.isfinite(out.float()).all()
    assert LAUNCHES["found_cell"] == 0  # the CPU path is never counted


def test_unhostable_genotype_refused():
    edges = (("fc_relu", 0), ("skip", 1))
    with pytest.raises(ValueError, match="cannot host"):
        FoundNodeCell(edges, ("Sum",), 1, 1, C, L, 0.0, fused_eval=True)
    # building for CUDA refuses before any CUDA tensor is made
    with pytest.raises(ValueError, match="cannot host"):
        FoundNodeCell(edges, ("Sum",), 1, 1, C, L, 0.0, device="cuda")
    # the CPU composite path still runs it
    cell = FoundNodeCell(edges, ("Sum",), 1, 1, C, L, 0.0).eval()
    with torch.no_grad():
        assert cell(torch.zeros(B, L, C), torch.zeros(B, L, C)).shape == (
            B, L, C)
    assert "fc_relu" in tnm.found_cell_blocker(edges, ("Sum",))
    assert "> 4" in tnm.found_cell_blocker(
        _chain_edges(5), ("Sum",) * 5)


@pytest.mark.parametrize("bad,err", [
    ("dtype", TypeError), ("shape", ValueError), ("steps", ValueError),
    ("index", ValueError), ("contig", ValueError), ("mult", ValueError),
    ("scratch_dtype", TypeError), ("scratch_device", TypeError),
    ("scratch_size", ValueError), ("scratch_align", ValueError)])
def test_wrapper_checks(bad, err):
    """The checks the wrapper makes before a CUDA launch (run here on CPU
    tensors, where no launch follows), the scratch of intermediate states
    among them: fp32, on x's device, (steps + 1) x B x L x C elements,
    16-byte aligned."""
    rng = np.random.RandomState(5)
    p = _port_params(_random_params(rng, 1, 1))
    x = torch.zeros(B, L, C)
    y = torch.zeros(B, L, C)
    cfg = ((2, (True, 0), (True, 1)),)
    m = 1
    n = tnm.found_cell_scratch_numel(B, L, C, 1)
    assert n == 2 * B * L * C
    scratch = torch.empty(n)
    if bad == "scratch_dtype":
        scratch = scratch.double()
    elif bad == "scratch_device":
        scratch = torch.empty(n, device="meta")
    elif bad == "scratch_size":
        scratch = torch.empty(n - 4)
    elif bad == "scratch_align":
        scratch = torch.empty(n + 1)[1:]
    elif bad == "dtype":
        x, y = x.double(), y.double()
    elif bad == "shape":
        y = torch.zeros(B, L, C + 1)
    elif bad == "steps":
        cfg = cfg * 5
    elif bad == "index":
        cfg = ((2, (True, 0), (True, 2)),)
    elif bad == "contig":
        x = torch.zeros(B, C, L).transpose(1, 2)
    else:
        m = 4
    with pytest.raises(err):
        tnm._check(x, y, p, cfg, m, scratch)
    tnm._check(torch.zeros(B, L, C), torch.zeros(B, L, C), p,
               ((2, (True, 0), (True, 1)),), 1, torch.empty(n))


def test_blocker_limits():
    """The kernel's limits on L and shared memory reach the blocker, so a
    cell built for CUDA refuses them up front: more rows than a GEMM block
    holds, and an attention whose (L, L) scores and states overflow a
    block; a cell without GEMM is not bound by the rows."""
    glu = (("skip", 0), ("skip", 1))
    assert tnm.found_cell_blocker(glu, ("LinearGLU",), 192, 16) == ""
    assert "rows of a GEMM block" in tnm.found_cell_blocker(
        glu, ("LinearGLU",), 8, tnm.FOUND_MAX_L + 1)
    assert tnm.found_cell_blocker(glu, ("Sum",), 8, tnm.FOUND_MAX_L + 1) \
        == ""
    assert "shared memory" in tnm.found_cell_blocker(
        glu, ("ScaleDotAttn",), 192, 128)
    # the NTU serving cells at C=128, L=8, and the widest ones the tests run
    for ops in (("LinearGLU", "LinearGLU"), ("Sum", "ScaleDotAttn")):
        assert tnm.found_cell_blocker(_chain_edges(2), ops, 128, 8, 2) == ""
    assert tnm.found_cell_blocker(
        _chain_edges(4), ("LinearGLU", "Sum", "ConcatFC", "ScaleDotAttn"),
        256, 16, 6) == ""
    with pytest.raises(ValueError, match="cannot host"):
        FoundNodeCell(glu, ("ScaleDotAttn",), 1, 1, 192, 128, 0.0,
                      device="cuda")
