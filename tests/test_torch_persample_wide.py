"""The per-sample kernel's scope, the JAX kernel's: any dim, coupling
half, conditioner width and depth, and any number of coupling blocks
(vmc_pde_torch/kernels/persample.py), on the CPU. The kernel itself
runs only on the card (tests/test_torch_cuda.py::test_kernel_wide_flows).

- The gate: the port's ``supports`` equals the JAX package's on the same
  flows built in both packages, flows past dim 64, halves of 32, widths
  of 64 and four linear layers included; block mode and the cosine-bump
  latent are refused by both.
- The plan: the variable-length block plan and the repacked theta
  rebuild theta exactly, and the launch plan fits the block's shared
  memory, counted region by region, at every batch size.
- The per-sample outputs on a flow past each of those against the JAX
  kernel's body through its plain reference (tile_value_and_grads and the
  jet quad trace, which tests/test_persample.py holds the interpreted
  kernel to; the interpreter costs seconds a flow here): 1e-10 relative
  to the largest value, in f64 (tests/test_torch_persample.py says why).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models import normal, rel_err, t64
from vmc_pde_torch.config import preset
from vmc_pde_torch.kernels import persample
from vmc_pde_torch.models.flow import build_flow, perturb_theta
from vmc_pde_torch.models.sanity import SanityFlow
from vmc_pde_torch.ops.evolution import make_equation
from vmc_pde_tpu.kernels import persample as jpersample
from vmc_pde_tpu.models import coupling as jcoupling
from vmc_pde_tpu.models.flow import Flow as JFlow
from vmc_pde_tpu.models.sanity import SanityFlow as JSanityFlow

torch.set_num_threads(1)

# fokkerPlanck32 with its dim, depth and widths changed: past dim 64,
# halves of 32, widths of 64 and four linear layers, where the JAX package
# runs its kernel
FP32 = {
    "d128 depth 2 hidden 16": dict(dim=128, offset=(0.0,) * 128, depth=2,
                                   hidden=(16,)),
    "d96 depth 4 hidden 16": dict(dim=96, offset=(0.0,) * 96, depth=4,
                                  hidden=(16,)),
    "five linear layers": dict(hidden=(16, 16, 16, 16)),
    "width 96": dict(depth=2, hidden=(96,)),
    "d128 depth 4 hidden 64": dict(dim=128, offset=(0.0,) * 128, depth=4,
                                   hidden=(64,)),
}
P_OF = {"d128 depth 2 hidden 16": 25408, "d96 depth 4 hidden 16": 30352,
        "five linear layers": 22320, "width 96": 26032,
        "d128 depth 4 hidden 64": 141504}


def _jax_flow(flow):
    """The JAX package's Flow with the port flow's blocks, latent and
    offset (its parameters are not needed by the gate)."""
    return JFlow(dim=flow.dim, latent_name=flow.latent_name,
                 offset=flow.offset, blocks=tuple(
                     jcoupling.BlockSpec(
                         ind_up=s.ind_up, ind_down=s.ind_down,
                         hidden=s.hidden, variant=s.variant,
                         global_affine=s.global_affine, alpha=s.alpha)
                     for s in flow.blocks))


def _pair(label, latent_name):
    """(JAX flow, port flow, trace directions) of a table flow, built with
    the same arguments."""
    if label == "SanityFlow":
        return (JSanityFlow(4, latent_name=latent_name),
                SanityFlow(4, latent_name=latent_name), np.eye(4)[:2])
    if label == "cosine bump":
        flow = build_flow(0, 2, depth=2, hidden=(3,), variant="affine",
                          latent_name=latent_name)[0]
        return _jax_flow(flow), flow, np.eye(2)
    cfg = preset("fokkerPlanck32", **FP32[label])
    flow = build_flow(cfg.seed, cfg.dim, depth=cfg.depth,
                      hidden=cfg.hidden_resolved(), variant=cfg.variant,
                      latent_name=latent_name, offset=cfg.offset)[0]
    eq = make_equation(cfg.equation, cfg.dim, **cfg.equation_params)
    return _jax_flow(flow), flow, eq.hessian_trace_dirs(cfg.dim)


@pytest.mark.parametrize("label,latent_name", [
    *((label, lat) for label in FP32 for lat in ("Gauss", "Student_t")),
    ("SanityFlow", "Gauss"), ("SanityFlow", "Student_t"),
    ("cosine bump", "cos_dist")])
def test_gate_matches_jax(label, latent_name):
    """supports in trace mode, without a Hessian and in block mode, on
    the same flow in both packages; where it takes the flow, a plan at
    the main path's N that fits the block."""
    jflow, flow, dirs = _pair(label, latent_name)
    if label in P_OF and latent_name == "Gauss":
        assert flow.layout.size == P_OF[label]
    for args in ((dirs, None), (None, None), (dirs, (0, 1)),
                 (None, (0, 1))):
        assert (persample.supports(flow, *args)
                == jpersample.supports(jflow, *args)), args
    taken = persample.supports(flow, dirs, None)
    assert taken == (label != "cosine bump")
    if taken:
        plan = persample.tile_plan(flow, len(dirs), 16384)
        assert plan.smem <= persample.SMEM_LIMIT and plan.grid >= 1


def _flows():
    return {
        "deep": build_flow(0, 8, depth=2, hidden=(4,) * 4)[0],
        "wide": build_flow(0, 8, depth=2, hidden=(65,))[0],
        "d66": build_flow(0, 66, depth=2, hidden=(4,), variant="affine")[0],
        "Student-t, global affine": build_flow(
            0, 6, depth=3, hidden=(3, 4), variant="scale_shift",
            latent_name="Student_t", global_affine=True)[0],
        "no blocks": SanityFlow(3),
    }


def _rebuild(flow):
    """theta from the plan and the repacked theta alone: every layer's
    bias and weights, the global affines, mu, L_diag and the scale from
    their repacked offsets to their flat ones; the latent's L and
    dist_params, which the wrapper reads from theta itself, copied."""
    lay = flow.layout
    theta = torch.randn(lay.size, dtype=torch.float64,
                        generator=torch.Generator().manual_seed(1))
    meta, _ = persample.block_plan(flow, 2)
    kidx = persample.kernel_layout(flow)[0]
    tk = torch.cat([theta, theta.new_zeros(1)])[torch.as_tensor(kidx)]
    out = torch.full_like(theta, float("nan"))
    for name in ("L", "dist_params"):
        if name in lay.shapes["latent"]:
            a = lay.offset(("latent", name))
            b = a + int(np.prod(lay.shapes["latent"][name]))
            out[a:b] = theta[a:b]
    for b, spec in enumerate(flow.blocks):
        for net in spec.nets:
            for layer in range(len(spec.hidden) + 1):
                n_in, n_out, b_off, w_off, _, kb, kw, ld = (
                    int(v) for v in persample.layer_record(meta, b, net,
                                                           layer))
                out[b_off:b_off + n_out] = tk[kb:kb + n_out]
                out[w_off:w_off + n_in * n_out] = tk[kw:kw + n_in * ld].view(
                    n_in, ld)[:, :n_out].reshape(-1)
        r = persample.block_record(meta, b)
        if meta[r + 7]:
            g, g_off, kg, kg_off = (int(v) for v in meta[r + 8:r + 12])
            out[g] = tk[kg]
            out[g_off:g_off + flow.dim] = tk[kg_off:kg_off + flow.dim]
    d = flow.dim
    for flat, k in ((meta[6], meta[12]), (meta[5], meta[13])):
        out[flat:flat + d] = tk[k:k + d]
    if meta[16] >= 0:
        out[meta[16]] = tk[meta[17]]
    return theta, out


@pytest.mark.parametrize("label", list(_flows()))
def test_layout_rebuilds_theta_and_plans_fit(label):
    """The variable-length plan and the repacked theta give back theta
    bit for bit; at every batch size the plan's shared bytes and
    workspace are its regions' (region_floats, counted one by one), within
    SMEM_LIMIT, the register width only with every region shared, and a
    grid of whole tiles (fewer blocks only with a workspace)."""
    flow = _flows()[label]
    theta, rebuilt = _rebuild(flow)
    assert torch.equal(rebuilt, theta)
    meta, n_sv = persample.block_plan(flow, 2)
    for n in (1, 7, 2048, 16384, 65536):
        plan = persample.tile_plan(flow, 2, n)
        reg = persample.region_floats(
            int(meta[11]), persample._n_fconst(flow, 2), meta.size, n_sv,
            flow.dim, 2, plan.T, plan.J, int(meta[14]),
            0 if plan.MW else int(meta[15]))
        bits = {"th": persample.TH, "fc": persample.FC,
                "tile": persample.TILE, "work": persample.WORK}
        shared = reg["meta"] + reg["ps"] + sum(
            reg[k] for k, bit in bits.items() if plan.where & bit)
        ws = sum(reg[k] for k in ("tile", "work")
                 if not plan.where & bits[k])
        assert (plan.smem, plan.ws) == (4 * shared, ws)
        assert plan.smem <= persample.SMEM_LIMIT
        assert plan.MW == 0 or plan.where == persample.ALL
        tiles = -(-n // plan.T)
        assert plan.grid == tiles or (plan.ws and plan.grid < tiles)


def _jax_params(flow, theta):
    """The JAX package's parameter tree of the port's theta (the two
    packages' layouts are the same tree, models/convert.py)."""
    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, list):
            return [conv(v) for v in node]
        return jnp.asarray(node.numpy())

    return conv(flow.layout.unravel(theta))


@pytest.mark.parametrize("kw", [
    dict(dim=66, depth=1, hidden=(2,)),
    dict(dim=4, depth=2, hidden=(3, 3, 3, 3)),
    dict(dim=4, depth=2, hidden=(65,)),
], ids=["d66 halves 33", "five layers", "width 65"])
def test_per_sample_matches_pallas_past_the_old_limits(kw):
    """logp, g, the quad trace along non-axis directions and O of one tile
    of 8 on a perturbed affine flow: the port's per-sample function on the
    CPU (the plain version, which the kernel is held against on the card)
    against the JAX kernel's body (tile_value_and_grads, tile_quad with
    the jets) on the same flow and theta."""
    flow, theta = build_flow(11, variant="affine", dtype=torch.float64,
                             **kw)
    theta = perturb_theta(flow, theta, np.random.default_rng(11),
                          out_scale=0.3)
    jflow, jparams = _jax_flow(flow), _jax_params(flow, theta)
    assert persample.supports(flow, np.eye(kw["dim"]), None)
    x = normal((8, flow.dim), 12)
    dirs = normal((2, flow.dim), 13)
    lp, g, O = jax.jit(lambda p, x: jpersample.tile_value_and_grads(
        jflow, p, x))(jparams, jnp.asarray(x))
    quad = jax.jit(lambda p, x, v: jpersample.tile_quad(
        jflow, p, x, v, impl="jet"))(jparams, jnp.asarray(x),
                                     jnp.asarray(dirs))
    got = persample.per_sample(flow, theta, t64(x), t64(dirs))
    for name, g_, w_ in zip(("logp", "g", "quad", "O"), got,
                            (lp, g, quad, O)):
        assert g_.shape == tuple(w_.shape), name
        assert rel_err(g_, w_) < 1e-10, name


def test_bound_counts_five_layers_and_no_blocks():
    """kernels/bounds.py's per-sample operation count from the layer list:
    five linear layers per conditioner contribute each layer's (5 + 4 k)
    in out, and a flow without coupling blocks (SanityFlow) the latent's
    triangular products alone."""
    from vmc_pde_torch.kernels import bounds

    cfg = preset("fokkerPlanck32", **FP32["five linear layers"])
    flow = build_flow(cfg.seed, cfg.dim, depth=cfg.depth,
                      hidden=cfg.hidden_resolved(), variant=cfg.variant)[0]
    layers = bounds.flow_layers(flow)
    assert len(layers) == 4 * 4 * 5 and set(layers) == {(16, 16)}
    d, k = 32, 16
    tri = d * (d + 1)
    latent = 2 * tri + d * (d - 1) + k * (tri + 6 * d)
    assert bounds.persample_flops(layers, d, k) == (
        80 * (5 + 4 * k) * 256 + latent)
    sanity = SanityFlow(4)
    assert bounds.flow_layers(sanity) == [] and bounds.flow_ga(sanity) == 0
    assert bounds.persample_flops([], 4, 2) == 2 * 20 + 12 + 2 * (20 + 24)
    ms, by = bounds.persample([], 4, sanity.layout.size, 16384, 2)
    assert by == "bytes" and ms > 0
