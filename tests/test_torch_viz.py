"""The port's plots, paper-figure helpers, SanityFlow and examples
(vmc_pde_torch/viz/, models/sanity.py, examples/) against the JAX
package's, on the CPU in f64; and the driver's repairs: the density
snapshots at plot_every, and an Equation instance as RunConfig.equation.

Tolerances:
- SanityFlow's transform and density: 1e-12 (closed forms); one TDVP
  right-hand side on shared latent draws: 1e-8, as tests/test_torch_tdvp.py
  holds the coupling flows (the solves take different LAPACK paths);
- paper.py's numbers: 1e-12; plot_data_diff's integrated |model -
  histogram| on the same theta and data: 1e-10 (only the model density
  differs, at ~1e-15);
- MovingTrap.eloc: 1e-12, the same closed form in torch.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from test_torch_models import normal, parity_flow, rel_err, t64
from test_torch_tdvp import FP, N, OBS, _compare, _jax_rhs, _port_tdvp
from vmc_pde_torch import driver
from vmc_pde_torch.config import preset
from vmc_pde_torch.kernels import persample
from vmc_pde_torch.models.convert import from_jax
from vmc_pde_torch.models.sanity import SanityFlow
from vmc_pde_torch.models.state import VarState
from vmc_pde_torch.ops.evolution import make_equation
from vmc_pde_torch.utils.dtypes import Precision
from vmc_pde_torch.utils.grid import Grid
from vmc_pde_torch.viz import paper, plots
from vmc_pde_tpu.kernels import persample as jpersample
from vmc_pde_tpu.models.sanity import SanityFlow as JSanityFlow
from vmc_pde_tpu.models.state import VarState as JVarState
from vmc_pde_tpu.ops import evolution as jevolution
from vmc_pde_tpu.parallel.mesh import ParallelCtx
from vmc_pde_tpu.sampling.sampler import Sampler as JSampler
from vmc_pde_tpu.solver.tdvp import TDVP as JTDVP
from vmc_pde_tpu.solver.tdvp import TDVPConfig as JTDVPConfig
from vmc_pde_tpu.utils.dtypes import Precision as JPrecision
from vmc_pde_tpu.viz import paper as jpaper
from vmc_pde_tpu.viz import plots as jplots

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _sanity_pair(dim, scale=2.0):
    """The JAX SanityFlow's parameters (scale and mu moved off their
    init) and the port's flow and theta carried across by from_jax."""
    jflow = JSanityFlow(dim=dim)
    jparams = jflow.init(jax.random.PRNGKey(0), dtype=jnp.float64)
    jparams["scale"] = jnp.array([scale])
    jparams["latent"]["mu"] = jnp.linspace(-0.2, 0.3, dim)
    flow, theta = from_jax([], jax.tree.map(np.asarray, jparams))
    return jflow, jparams, flow, theta


def test_sanity_flow_roundtrip_and_density():
    """tests/test_fluidpaper.py:54 on the port, batched, against the JAX
    flow: theta in ravel_pytree's order, the transform, its inverse and
    log p; the per-sample kernel takes the flow as the JAX gate does (no
    coupling blocks: the latent behind the learned scale) and plans its
    launch within the block's shared memory."""
    jflow, jparams, flow, theta = _sanity_pair(3)
    assert isinstance(flow, SanityFlow) and flow.blocks == ()
    np.testing.assert_array_equal(theta.numpy(),
                                  np.asarray(ravel_pytree(jparams)[0]))
    params = flow.layout.unravel(theta)
    x = t64(normal((16, 3), 1))
    z, lj = flow.forward(params, x)
    np.testing.assert_allclose(z.numpy(), 2.0 * x.numpy(), rtol=1e-15)
    np.testing.assert_allclose(lj.numpy(), np.full(16, 3 * np.log(2.0)),
                               rtol=1e-15)
    x2, lj_inv = flow.inverse(params, z)
    np.testing.assert_allclose(x2.numpy(), x.numpy(), atol=1e-14)
    np.testing.assert_allclose((lj + lj_inv).numpy(), 0.0, atol=1e-14)
    want = jax.jit(jax.vmap(lambda c: jflow.log_prob(jparams, c)))(
        jnp.asarray(x.numpy()))
    assert rel_err(flow.log_prob(params, x), want) < 1e-12
    assert persample.supports(flow, np.eye(3), None)
    assert jpersample.supports(jflow, np.eye(3), None)
    meta, _ = persample.block_plan(flow, 3)
    assert (meta[1], meta[16]) == (0, flow.layout.offset(("scale",)))
    plan = persample.tile_plan(flow, 3, 16384)
    assert plan.grid == 16384 // plan.T and plan.ws == 0
    assert plan.smem <= persample.SMEM_LIMIT


def test_sanity_flow_tdvp_rhs_matches_jax():
    """One RHS of the Fokker-Planck problem of tests/test_torch_tdvp.py
    with SanityFlow (P = 15) on shared draws: the torch.func pipeline
    (``auto`` keeps a P below 2048 off the kernel, as the JAX package
    does), the update and the observables."""
    dim = 4
    jflow, jparams, flow, theta = _sanity_pair(dim, scale=1.3)
    ctx = ParallelCtx.single_device()
    jprec = JPrecision.f64_everywhere()
    jstate = JVarState(jflow, jparams, ctx=ctx, precision=jprec,
                       sampler=JSampler(dim=dim, ctx=ctx, name="Gauss",
                                        dtype=jnp.float64))
    cfg = dict(svd_tol=1e-6)
    jtdvp = JTDVP(jstate, jevolution.make_equation(FP[0], dim, **FP[1]),
                  JTDVPConfig(**cfg), n_samples=N, precision=jprec)
    tdvp = _port_tdvp(flow, theta, **cfg)
    assert not tdvp.uses_kernel and tdvp.n_params == 15
    z = normal((N, dim), 51)
    jaux = _jax_rhs(jtdvp, theta, 0.2, z)
    aux = tdvp._rhs_impl(theta, 0.2, 0, t64(z))
    _compare(aux, jaux, ("update",) + OBS)
    # an exact solve at P = 15: both residuals are rounding
    assert float(aux["solver_res"]) < 1e-12 and jaux["solver_res"] < 1e-12


def test_paper_numbers_match_jax():
    t = np.linspace(0.0, 2.0, 21)
    infos = {"times": t, "entropy": 2.9 + 0.3 * t + 0.01 * np.sin(9 * t),
             "covar": normal((21, 2, 2), 3)}
    for got, want in (
            (paper.gauss_diffusion_entropy(t, 8, 0.5, 2.0),
             jpaper.gauss_diffusion_entropy(t, 8, 0.5, 2.0)),
            (plots.gauss_diffusion_entropy(t, 2),
             jplots.gauss_diffusion_entropy(t, 2)),
            (paper.steady_state_entropy(3, 10.0),
             jpaper.steady_state_entropy(3, 10.0)),
            ([paper.gauss_ball_mass(d, r) for d in (2, 6) for r in (1, .1)],
             [jpaper.gauss_ball_mass(d, r) for d in (2, 6) for r in (1, .1)])):
        assert rel_err(got, want) < 1e-12
    assert paper.entropy_error_stats(infos, 2) == \
        jpaper.entropy_error_stats(infos, 2)
    slim, jslim = paper.slim_infos(infos, 4), jpaper.slim_infos(infos, 4)
    for key in infos:
        np.testing.assert_array_equal(slim[key], jslim[key])


def test_plot_data_diff_matches_jax():
    """The model-minus-histogram surface's integrated |diff| on the same
    carried-across theta and the same data, the density evaluated on the
    state's device."""
    jflow, jparams, flow, theta = parity_flow("affine", dim=2, seed=4,
                                              out_scale=0.1)
    jstate = JVarState(jflow, jparams,
                       precision=JPrecision.f64_everywhere())
    state = VarState(flow, theta, precision=Precision.f64_everywhere())
    data = 0.8 * normal((3000, 2), 9)
    fig, got = plots.plot_data_diff(state, Grid(np.ones(2) * 3.0, 24),
                                    data)
    jfig, want = jplots.plot_data_diff(jstate, Grid(np.ones(2) * 3.0, 24),
                                       data)
    assert abs(got - want) < 1e-10 * abs(want) and got > 0.0
    plt = plots._plt()
    plt.close(fig)
    plt.close(jfig)


def test_make_final_plots_same_files_as_jax(tmp_path, monkeypatch):
    """The time-series battery on one infos record writes the JAX
    package's figures, by name (the JAX package's files are touched, not
    rendered: its names are what is compared)."""
    n, p = 6, 3
    t = np.linspace(0.0, 0.5, n)
    infos = {"times": t, "entropy": 2.8 + t,
             "covar": np.tile(np.eye(2), (n, 1, 1)),
             "solver_res": np.full(n, 1e-12),
             "ev": np.tile(np.logspace(-14, 2, p), (n, 1)),
             "x4": np.zeros((n, 2)), "integral_0.5sigma": np.full(n, 0.3)}
    os.makedirs(tmp_path / "jax")
    os.makedirs(tmp_path / "port")
    got = plots.make_final_plots(str(tmp_path / "port"), infos, dim=2)
    from matplotlib.figure import Figure

    monkeypatch.setattr(Figure, "savefig",
                        lambda fig, path, **kw: open(path, "w").close())
    want = jplots.make_final_plots(str(tmp_path / "jax"), infos, dim=2)
    assert got == want and "spectrum" in got and len(got) == 7
    assert (sorted(os.listdir(tmp_path / "port"))
            == sorted(os.listdir(tmp_path / "jax")))


def test_plots_draw(tmp_path):
    """Every other drawing function runs on the port's state, tensors and
    callables (the density on the state's device, then numpy)."""
    _, _, flow, theta = parity_flow("affine", dim=2, seed=4, out_scale=0.1)
    state = VarState(flow, theta, precision=Precision.f64_everywhere())
    grid = Grid(np.ones(2) * 3.0, 20)
    from vmc_pde_torch.ops.evolution import velocity_field_mlpaper
    from vmc_pde_torch.pretrain.train import gen_data

    _, target = gen_data((10, 2))
    data = normal((500, 2), 2)
    infos = {"times": np.linspace(0, 1, 5), "entropy": np.linspace(2, 3, 5),
             "x1": np.zeros((5, 2)), "covar": np.tile(np.eye(2), (5, 1, 1))}
    figs = [plots.plot_density(state, grid, proj=True),
            plots.plot_density(state, grid, fun=lambda c: float(c[0] ** 2)),
            plots.plot_line(state, scale=2.0, n_gridpoints=40, fit=True),
            plots.plot_diff(state, grid, target),
            plots.plot_data(data, grid),
            plots.plot_vectorfield(Grid(np.ones(2), 10, sym=False),
                                   velocity_field_mlpaper, t=0.5),
            paper.plot_entropy_comparison(
                {"a": infos}, dim=2, save=str(tmp_path / "cmp.pdf")),
            *paper.plot_vs_oracle(infos, infos, entropy_target=3.0,
                                  save_prefix=str(tmp_path / "o"))]
    assert os.path.exists(tmp_path / "cmp.pdf")
    assert os.path.exists(tmp_path / "o_covar.pdf")
    plt = plots._plt()
    for fig in figs:
        plt.close(fig)


def _jax_example(name):
    path = os.path.join(ROOT, "examples")
    sys.path.insert(0, path)
    try:
        return __import__(name)
    finally:
        sys.path.remove(path)


def test_moving_trap_eloc_matches_jax():
    from vmc_pde_torch.examples.custom_equation import make_moving_trap

    jeq = _jax_example("custom_equation").make_moving_trap(1.3, 0.4, 2.5)
    eq = make_moving_trap(1.3, 0.4, 2.5)
    x, g, lap = normal((32, 2), 1), normal((32, 2), 2), normal((32,), 3)
    np.testing.assert_array_equal(eq.hessian_trace_dirs(2),
                                  jeq.hessian_trace_dirs(2))
    want = jeq.eloc(jnp.asarray(x), jnp.asarray(g), jnp.asarray(lap), 0.37)
    assert rel_err(eq.eloc(t64(x), t64(g), t64(lap), 0.37), want) < 1e-12


def test_minimal_demo(tmp_path, capsys):
    """The demo end to end at a tiny budget on the CPU (f64), as
    tests/test_oracle_and_e2e.py:877 runs the JAX one: infos.hdf5, the
    figure battery and the driver's density snapshot."""
    from vmc_pde_torch.examples import minimal_demo

    outdir = str(tmp_path / "demo")
    infos = minimal_demo.main(["--t-end", "0.02", "--samples", "256",
                               "--outdir", outdir, "--device", "cpu"])
    assert "entropy error vs analytic" in capsys.readouterr().out
    files = set(os.listdir(outdir))
    assert {"infos.hdf5", "entropy.pdf", "covariance.pdf",
            "t_0.000.pdf"} <= files
    assert np.isfinite(infos["entropy"]).all()


def test_driver_writes_density_snapshots(tmp_path):
    """A 2-D run with a grid and a workdir saves t_{t:.3f}.pdf at each
    plot_every, one for each recorded grid integral, as the JAX driver."""
    cfg = preset("mwe", precision="f64", device="cpu", n_samples_tdvp=128,
                 n_samples_obs=128, grid_points=20, dt0=1e-3, max_step=1e-3,
                 plot_every=2e-3, t_end=3e-3, verbose=False,
                 workdir=str(tmp_path))
    _, rec = driver.run(cfg)
    times = rec.as_arrays()["grid_integral_t"]
    assert len(times) >= 2
    pdfs = {f for f in os.listdir(tmp_path) if f.endswith(".pdf")}
    assert pdfs == {f"t_{t:.3f}.pdf" for t in times}


def test_equation_instance():
    """RunConfig.equation takes an Equation instance (custom physics), and
    refuses equation_params beside one, as the JAX driver does."""
    eq = make_equation("diffusion", 2, D=0.5)
    cfg = preset("mwe", precision="f64", device="cpu", n_samples_tdvp=64,
                 n_samples_obs=64, equation=eq, verbose=False)
    _, _, _, equation, _ = driver.build_problem(cfg)
    assert equation is eq
    _, rec = driver.run(cfg, max_steps=1)
    assert np.isfinite(rec.as_arrays()["entropy"]).all()
    with pytest.raises(ValueError, match="equation_params"):
        driver.build_problem(preset("mwe", device="cpu", equation=eq,
                                    equation_params={"D": 2.0}))
