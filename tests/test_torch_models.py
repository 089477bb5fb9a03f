"""The PyTorch port's flow model against the JAX package: flat-theta order,
weights carried across, log_prob / inverse / push, and the per-sample
derivatives of ops/score.py, all in f64 on shared inputs.

Tolerance: 1e-10 relative to the largest value. Both packages evaluate the
same f64 formulas; only the order of floating-point operations differs
(torch's batched matmuls and triangular solve vs XLA's), so agreement is
near machine precision times the flow's amplification -- the perturbed
flows reach values ~1e3, where a few ulp of 2e-16 stay far below 1e-10.
"""

import os
import subprocess
import sys
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from vmc_pde_torch.models.convert import from_jax
from vmc_pde_torch.models.flow import build_flow, perturb_theta
from vmc_pde_torch.models.latent import chol_factor
from vmc_pde_torch.ops import score
from vmc_pde_torch.sampling.sampler import Sampler
from vmc_pde_tpu.models.flow import build_flow as jax_build_flow
from vmc_pde_tpu.ops import score as jscore

torch.set_num_threads(1)

# -- shared set-up of the port's parity tests (the other test_torch_*
# files import these): one flow built by the JAX package, its weights
# perturbed away from the near-identity init and carried into the port
# through models/convert.from_jax, so both packages hold the same theta.


def block_tuples(jflow):
    return [(s.ind_up, s.ind_down, s.variant, s.hidden, s.alpha)
            for s in jflow.blocks]


def parity_flow(variant, dim=4, depth=2, hidden=(3,), seed=5,
                out_scale=0.3, offset=None, latent_name="Gauss",
                global_affine=False):
    """(jflow, jparams, flow, theta): the same f64 flow in both packages.
    Output-layer weights are U[-out_scale, out_scale] instead of the
    init's 1e-5, so the nonlinear parts of the flow are exercised."""
    jflow, jparams = jax_build_flow(seed, dim, depth=depth, hidden=hidden,
                                    variant=variant, offset=offset,
                                    latent_name=latent_name,
                                    global_affine=global_affine,
                                    dtype=jnp.float64)
    flow, theta = from_jax(block_tuples(jflow),
                           jax.tree.map(np.asarray, jparams), offset=offset,
                           latent_name=latent_name)
    theta = perturb_theta(flow, theta, np.random.default_rng(seed),
                          out_scale=out_scale)
    _, unravel = ravel_pytree(jparams)
    jparams = unravel(jnp.asarray(theta.numpy()))
    return jflow, jparams, flow, theta


def normal(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape)


def t64(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def rel_err(got, want):
    """max |got - want| / max(|want|, 1e-300), both as numpy f64."""
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


TOL = 1e-10
VARIANTS = ("additive", "affine", "scale", "scale_shift")


@pytest.fixture(scope="module", params=VARIANTS)
def pair(request):
    return parity_flow(request.param)


def test_flat_order_and_weights_carried_across(pair):
    """from_jax gives ravel_pytree's flat vector, and the port's unravel
    puts every JAX leaf back at its path."""
    jflow, jparams, flow, theta = pair
    flat, _ = ravel_pytree(jparams)
    _, theta2 = from_jax(block_tuples(jflow),
                         jax.tree.map(np.asarray, jparams))
    np.testing.assert_array_equal(theta2.numpy(), np.asarray(flat))
    np.testing.assert_array_equal(theta.numpy(), np.asarray(flat))
    tree = flow.layout.unravel(theta)
    for path, leaf in jax.tree_util.tree_flatten_with_path(jparams)[0]:
        node = tree
        for k in path:
            node = node[k.key if hasattr(k, "key") else k.idx]
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))


def test_log_prob_inverse_push_match_jax(pair):
    jflow, jparams, flow, theta = pair
    params = flow.layout.unravel(theta)
    x = normal((16, flow.dim), 1)
    z = normal((16, flow.dim), 2)
    lp_j = jax.jit(jax.vmap(jflow.log_prob, in_axes=(None, 0)))(jparams, x)
    assert rel_err(flow.log_prob(params, t64(x)), lp_j) < TOL
    xi_j, lj_j = jax.jit(jax.vmap(jflow.inverse, in_axes=(None, 0)))(
        jparams, z)
    xi, lj = flow.inverse(params, t64(z))
    assert rel_err(xi, xi_j) < TOL and rel_err(lj, lj_j) < TOL
    xp_j, lpp_j = jax.jit(jax.vmap(jflow.push, in_axes=(None, 0)))(
        jparams, z)
    xp, lpp = flow.push(params, t64(z))
    assert rel_err(xp, xp_j) < TOL and rel_err(lpp, lpp_j) < TOL
    # push is the exact inverse of the forward map
    assert rel_err(flow.log_prob(params, xp), lpp) < TOL


def test_score_and_quad_trace_match_jax(pair):
    """ops/score.py (torch.func) against vmc_pde_tpu/ops/score.py
    (jax.grad, jvp-of-jvp): logp, g, the O rows and the Hessian
    quadratic trace along non-axis directions."""
    jflow, jparams, flow, theta = pair
    flat, unravel = ravel_pytree(jparams)
    jf = jscore.make_flat_log_prob(jflow, unravel)
    x = normal((12, flow.dim), 3)
    dirs = normal((3, flow.dim), 4)
    want = jax.jit(jax.vmap(partial(jscore.value_score_and_param_grad, jf),
                            in_axes=(None, 0)))(flat, x)
    q_want = jax.jit(jax.vmap(
        partial(jscore.quad_trace, jf, dirs=jnp.asarray(dirs)),
        in_axes=(None, 0)))(flat, x)
    f = score.make_flat_log_prob(flow, flow.layout.unravel)
    got = score.batched_value_score_and_param_grad(f, theta, t64(x))
    q_got = score.batched_quad_trace(f, theta, t64(x), dirs)
    for g_, w_ in zip(got, want):
        assert rel_err(g_, w_) < TOL
    assert rel_err(q_got, q_want) < TOL


def test_build_flow_shapes_and_init():
    """build_flow draws partitions and the near-identity init from a
    seeded numpy generator: same P as the JAX package, valid half/half
    partitions, output layers within +-out_scale, and reproducible."""
    flow, theta = build_flow(1, 32, depth=4, hidden=(16,), variant="affine",
                             dtype=torch.float64)
    assert flow.layout.size == 9264
    jflow, jparams = jax_build_flow(1, 32, depth=4, hidden=(16,),
                                    variant="affine", dtype=jnp.float32)
    assert ravel_pytree(jparams)[0].size == 9264
    params = flow.layout.unravel(theta)
    for spec, p in zip(flow.blocks, params["blocks"]):
        assert sorted(spec.ind_up + spec.ind_down) == list(range(32))
        assert len(spec.ind_up) == 16
        for net in spec.nets:
            assert float(p[net]["w"][-1].abs().max()) <= 1e-5
            assert float(p[net]["w"][0].abs().max()) <= 1.0
    flow2, theta2 = build_flow(1, 32, depth=4, hidden=(16,),
                               variant="affine", dtype=torch.float64)
    assert flow2 == flow and torch.equal(theta, theta2)


def test_latent_sample_covariance():
    """The exact Gauss sampler's draws z = mu + U eps have mean mu and
    covariance U U^T (5 standard errors of a 40000-draw estimate)."""
    _, _, flow, theta = parity_flow("scale", seed=8, out_scale=0.3)
    params = flow.layout.unravel(theta)
    gen = torch.Generator().manual_seed(0)
    z, n = Sampler(flow.dim, dtype=torch.float64).sample(gen, flow, params,
                                                         40000)
    assert z.shape == (n, flow.dim) == (40000, flow.dim)
    U = chol_factor(params["latent"], flow.dim)
    cov = U @ U.T
    se = float(cov.diagonal().max()) * (2.0 / n) ** 0.5
    assert float((z.mean(0) - params["latent"]["mu"]).abs().max()) < 5 * se
    assert float((torch.cov(z.T) - cov).abs().max()) < 5 * se


def test_port_imports_without_jax():
    """The port imports and runs with JAX blocked, and its sources name
    no JAX module."""
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['jaxlib'] = None; sys.modules['flax'] = None\n"
            "import vmc_pde_torch.driver, vmc_pde_torch.kernels.build\n"
            "from vmc_pde_torch.models.convert import from_jax\n"
            "from vmc_pde_torch.kernels.persample import per_sample\n"
            "print('ok')")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr
    pkg = os.path.join(root, "vmc_pde_torch")
    for dirpath, _, files in os.walk(pkg):
        for name in files:
            if name.endswith(".py"):
                with open(os.path.join(dirpath, name)) as fh:
                    src = fh.read()
                for mod in ("jax", "jaxlib", "flax"):
                    assert f"import {mod}" not in src, name
                    assert f"from {mod}" not in src, name
