"""The port's accuracy studies (vmc_pde_torch/studies/) against the JAX
package's scripts of the same names under scripts/, on the CPU.

- check_aniso and check_fp6 read the JAX package's own runs in results/
  and print the scripts' lines: the covariance error to 1e-12 with D to
  1e-15 (the same f64 arithmetic on the same numbers); the fp6 oracle's
  cloud bit for bit (utils/threefry.py), its noise (a torch generator in
  the port, per-particle keys in JAX) within 5 Monte Carlo standard
  errors.
- northstar_l2, accuracy_d8 and evolve_d32_fp run the JAX scripts' main
  with their evolution replaced by a shared flow or a shared infos dict:
  the JSON records to 1e-12 (northstar: the same flow carried across by
  models/convert, whose densities agree to ~1e-15) or exactly.
- evolve_minsr_largep: the --quick flow's RHS on shared theta and draws
  against the JAX script's build (1e-8: the two packages' f64 statistics
  and N x N eigh solves, test_torch_solvers.py's bar); the chunked replay
  of its first steps against the direct one, and the order control.
- make_paper_figures: ness_state to 1e-12, and both figures drawn from
  the JAX package's runs in results/paper_runs (the grid oracle left
  out: compare_student_grid's test runs it).
- compare_student_grid prints the script's lag line on the port's grid.
- No study imports JAX or the JAX package; each defaults to cuda and
  raises without a card.
"""

import ast
import importlib
import importlib.util
import json
import os
import re
import shutil
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vmc_pde_torch.driver
import vmc_pde_tpu.driver
from test_torch_models import block_tuples, normal, parity_flow, rel_err, t64
from vmc_pde_torch.models.convert import from_jax
from vmc_pde_torch.models.state import VarState
from vmc_pde_torch.studies import (accuracy_d8, check_aniso, check_fp6,
                                   compare_student_grid, evolve_d32_fp,
                                   evolve_minsr_largep, make_paper_figures,
                                   northstar_l2)
from vmc_pde_torch.utils.dtypes import Precision
from vmc_pde_tpu.models.state import VarState as JVarState
from vmc_pde_tpu.ops.evolution import DiffusionAnisotropic as JAniso
from vmc_pde_tpu.parallel.mesh import ParallelCtx as JParallelCtx
from vmc_pde_tpu.utils.dtypes import Precision as JPrecision

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STUDIES = os.path.join(ROOT, "vmc_pde_torch", "studies")
NAMES = ("northstar_l2", "accuracy_d8", "check_aniso", "check_fp6",
         "evolve_minsr_largep", "evolve_d32_fp", "evolve_doublewell",
         "compare_student_grid", "make_paper_figures")


def _script(name):
    """The JAX package's scripts/<name>.py as a module."""
    spec = importlib.util.spec_from_file_location(
        f"jax_script_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Rec:
    def __init__(self, infos):
        self.infos = infos

    def as_arrays(self):
        return dict(self.infos)


def _lines(text):
    return [ln for ln in text.splitlines() if ln.strip()]


def test_studies_import_no_jax():
    """Every study module, and only those, and none imports jax, jaxlib,
    flax or the JAX package."""
    mods = sorted(f[:-3] for f in os.listdir(STUDIES)
                  if f.endswith(".py") and f != "__init__.py")
    assert mods == sorted(NAMES)
    for name in mods + ["__init__"]:
        with open(os.path.join(STUDIES, f"{name}.py")) as fh:
            tree = ast.parse(fh.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for n in names:
                assert not re.match(r"(jax|jaxlib|flax|vmc_pde_tpu)\b", n), \
                    (name, n)


def test_every_study_defaults_to_cuda():
    """Without --device each study asks for cuda, which raises here."""
    for name in NAMES:
        mod = importlib.import_module(f"vmc_pde_torch.studies.{name}")
        argv = ["run_dir"] if name in ("check_aniso", "check_fp6") else []
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mod.main(argv)


def test_check_aniso_matches_jax(tmp_path, capsys):
    """Both scripts on the JAX package's d=12 run print the same lines;
    D to 1e-15 and the worst error to 1e-12 of the JAX formula."""
    shutil.copy(os.path.join(ROOT, "results", "aniso_d12_tpu.hdf5"),
                tmp_path / "infos.hdf5")
    _script("check_aniso").main([str(tmp_path)])
    want = capsys.readouterr().out
    got = check_aniso.main([str(tmp_path), "--device", "cpu"])
    assert _lines(capsys.readouterr().out) == _lines(want)
    D_jax = np.asarray(JAniso(dim=12, seed=0).D_matrix)
    D = check_aniso.d_matrix(12, 0)
    assert np.abs(D - D_jax).max() <= 1e-15 * np.abs(D_jax).max()
    from vmc_pde_torch.utils.infos import load_infos

    infos = load_infos(str(tmp_path / "infos.hdf5"))
    worst = max(np.abs(c - (np.eye(12) + 2.0 * D_jax * t)).max()
                / np.abs(np.eye(12) + 2.0 * D_jax * t).max()
                for t, c in zip(infos["times"], infos["covar"]))
    assert abs(got["worst"] - worst) <= 1e-12 * worst


def _printed(text, label):
    line = next(ln for ln in text.splitlines() if ln.startswith(label))
    return np.array(line[len(label):].strip(" []").split(), dtype=float)


def test_check_fp6_matches_jax(tmp_path, capsys):
    """The JAX package's fp6 run against both oracles at 2000 particles:
    the same cloud bit for bit, the model's lines identical, the oracle's
    means and variances within 5 standard errors of a difference of two
    independent clouds, and so the metrics."""
    n = 2000
    want = 1.0 * np.array(check_fp6.OFFSET) + np.asarray(jax.random.normal(
        jax.random.PRNGKey(11), (n, 6), dtype=np.float64))
    np.testing.assert_array_equal(check_fp6.oracle_cloud(n).numpy(), want)

    shutil.copy(os.path.join(ROOT, "results", "fp6_tpu.hdf5"),
                tmp_path / "infos.hdf5")
    _script("check_fp6").main([str(tmp_path), "--particles", str(n)])
    jout = capsys.readouterr().out
    got = check_fp6.main([str(tmp_path), "--particles", str(n),
                          "--device", "cpu"])
    out = capsys.readouterr().out
    for label in ("model t_final", "means  (model)", "covdiag (model)"):
        assert [ln for ln in _lines(out) if ln.startswith(label)] == \
            [ln for ln in _lines(jout) if ln.startswith(label)]
    m_j, m = (_printed(s, "means  (oracle):") for s in (jout, out))
    c_j, c = (_printed(s, "covdiag (oracle):") for s in (jout, out))
    se_mean = np.sqrt(2 * c_j / n)
    assert (np.abs(m - m_j) <= 5 * se_mean + 1e-3).all(), (m, m_j)
    assert (np.abs(c / c_j - 1) <= 5 * np.sqrt(4 / n) + 1e-3).all(), (c, c_j)
    last = jout.splitlines()[-1]
    dm_j = float(re.search(r"mean diff\| ([0-9.]+)", last).group(1))
    dc_j = float(re.search(r"covdiag diff ([0-9.]+)", last).group(1))
    assert abs(got["max_mean_diff"] - dm_j) <= 5 * se_mean.max() + 1e-3
    assert abs(got["max_rel_covdiag_diff"] - dc_j) <= \
        5 * np.sqrt(4 / n) + 1e-3


def test_northstar_grid_error_matches_jax(monkeypatch, capsys):
    """The JAX script's record of a flow against the port's of the same
    flow carried across (f64, 1e-12), and the same mwe configuration."""
    jflow, jparams, flow, theta = parity_flow("scale", dim=2, seed=8,
                                              out_scale=0.05)
    jstate = JVarState(jflow, jparams, ctx=JParallelCtx.single_device(),
                       precision=JPrecision.f64_everywhere())
    seen = {}

    def fake_run(cfg):
        seen["cfg"] = cfg
        return jstate, None

    monkeypatch.setattr(vmc_pde_tpu.driver, "run", fake_run)
    flags = ["--t-end", "0.3", "--grid-n", "101", "--samples", "2000"]
    monkeypatch.setattr("sys.argv", ["northstar_l2.py"] + flags)
    _script("northstar_l2").main()
    want = json.loads(capsys.readouterr().out.splitlines()[-1])
    args = northstar_l2.parse_args(flags + ["--device", "cpu"])
    cfg = northstar_l2.make_config(args)
    for field in ("name", "dim", "t_end", "exact_t_end", "n_samples_tdvp",
                  "n_samples_obs", "precision", "seed", "dt0", "max_step",
                  "steps_per_dispatch", "increase_fac", "init_scale"):
        assert getattr(cfg, field) == getattr(seen["cfg"], field), field
    got = northstar_l2.evaluate(
        VarState(flow, theta, precision=Precision.f64_everywhere()), args)
    assert set(got) == set(want)
    for k in ("L2", "L2_rel", "Linf", "mass"):
        assert abs(got[k] - want[k]) <= 1e-12 * abs(want[k]), k
    assert got["pass"] == want["pass"]


def _d8_infos(latent):
    rng = np.random.default_rng(4)
    dt = np.minimum(1e-7 * 1.3 ** np.arange(1, 80), 1e-2)
    t = np.concatenate([[0.0], np.cumsum(dt)[:-1]])
    infos = {"times": t,
             "entropy": accuracy_d8.analytic_entropy(8, t)
             + 0.01 * rng.standard_normal(t.size),
             "solver_res": rng.uniform(1e-7, 1e-5, t.size)}
    if latent == "Student_t":
        infos["dist_params"] = rng.standard_normal((t.size, 1))
    return infos


@pytest.mark.parametrize("latent,extra", [("Gauss", ["--twice"]),
                                          ("Student_t", ["--qmc"])])
def test_accuracy_d8_record_matches_jax(latent, extra, tmp_path,
                                        monkeypatch, capsys):
    """On a shared infos dict the two scripts write the same JSON line and
    the same --dump-curve npz, from the same RunConfig."""
    infos = _d8_infos(latent)
    cfgs = {}

    def fake(package):
        def run(cfg):
            cfgs.setdefault(package, []).append(cfg)
            return None, _Rec(infos)
        return run

    monkeypatch.setattr(vmc_pde_tpu.driver, "run", fake("jax"))
    monkeypatch.setattr(vmc_pde_torch.driver, "run", fake("torch"))
    flags = ["--latent", latent, "--steps-per-dispatch", "8"] + extra
    _script("accuracy_d8").main(
        flags + ["--cpu", "--dump-curve", str(tmp_path / "j.npz")])
    want = capsys.readouterr().out.splitlines()[-1]
    accuracy_d8.main(flags + ["--device", "cpu", "--dump-curve",
                              str(tmp_path / "t.npz")])
    assert capsys.readouterr().out.splitlines()[-1] == want
    assert len(cfgs["jax"]) == len(cfgs["torch"]) == (2 if extra == [
        "--twice"] else 1)
    for jc, tc in zip(cfgs["jax"], cfgs["torch"]):
        for field in tc.__dataclass_fields__:
            if field not in ("device",):
                assert getattr(tc, field) == getattr(jc, field), field
    with np.load(tmp_path / "j.npz") as j, np.load(tmp_path / "t.npz") as t:
        assert sorted(j.files) == sorted(t.files)
        for k in j.files:
            np.testing.assert_array_equal(t[k], j[k])


def test_evolve_d32_fp_summary_matches_jax(monkeypatch, capsys):
    """The JAX script's summary of shared model and oracle records (its
    run and its oracle replaced) against the port's: the Lyapunov judge
    and the oracle comparison to 1e-12; the same RunConfig."""
    rng = np.random.default_rng(9)
    n_rec, d = 3, 32
    t = 2e-3 * np.arange(n_rec)

    def covs(scale):
        a = rng.standard_normal((n_rec, d, d)) * scale
        return np.eye(d) * (1 + t)[:, None, None] + a @ a.transpose(0, 2, 1)

    infos = {"times": t, "covar": covs(0.02),
             "solver_res": rng.uniform(1e-6, 1e-5, n_rec),
             "entropy": rng.standard_normal(n_rec)}
    oinfos = {"covar": covs(0.02)}
    seen = {}

    def fake_run(cfg, max_steps=None):
        seen["cfg"] = cfg
        return None, _Rec(infos)

    monkeypatch.setattr(vmc_pde_tpu.driver, "run", fake_run)
    monkeypatch.setattr("vmc_pde_tpu.oracle.sde.evolve",
                        lambda *a, **k: (None, oinfos))
    _script("evolve_d32_fp").main(["--quick"])
    want = json.loads(capsys.readouterr().out.splitlines()[-1])
    got = evolve_d32_fp.summarize(infos, oinfos, 10.0, 0.0)
    assert set(got) == set(want)
    for k, v in want.items():
        if k != "wall_s":
            assert abs(got[k] - v) <= 1e-12 * abs(v), k
    args = evolve_d32_fp.parse_args(["--quick", "--device", "cpu"])
    cfg = evolve_d32_fp.make_config(args)
    for field in cfg.__dataclass_fields__:
        if field not in ("device",):
            assert getattr(cfg, field) == getattr(seen["cfg"], field), field


def test_ness_state_matches_jax():
    """The heat chain's exact steady state, and an uncoupled uniform-T
    chain's, against the JAX script's function."""
    jscript = _script("make_paper_figures")
    assert jscript.HEAT_CHAIN == make_paper_figures.HEAT_CHAIN
    for params in (None, dict(T=(4.0, 4.0, 4.0), coupled=False)):
        S, ent = make_paper_figures.ness_state(params)
        S_j, ent_j = jscript.ness_state(params)
        assert rel_err(S, S_j) <= 1e-12
        assert abs(ent - ent_j) <= 1e-12 * abs(ent_j)


def test_paper_figures_from_results(tmp_path, capsys):
    """Both figures drawn on the CPU from the JAX package's runs in
    results/paper_runs, with a fresh (small) Wiener oracle and without
    the radial grid oracle (test_student_grid_report_matches_jax runs
    it); the reference's overlays are skipped."""
    p1, p2 = make_paper_figures.main([
        "--device", "cpu", "--run-dir",
        os.path.join(ROOT, "results", "paper_runs"), "--outdir",
        str(tmp_path), "--no-grid-oracle", "--oracle-particles", "200"])
    out = capsys.readouterr().out
    assert "no --reference" in out and "not found" not in out
    for p in (p1, p2, p1.replace(".pdf", ".png"), p2.replace(".pdf",
                                                             ".png")):
        assert os.path.getsize(p) > 1000, p


def test_student_grid_report_matches_jax(capsys):
    """The lag line of a curve against the port's radial grid is the JAX
    script's for the same grid."""
    grid = compare_student_grid.grid_reference(0.002, n_record=4,
                                               device="cpu")
    assert abs(grid["entropy"][0] - 14.5912) < 1e-4
    t = np.linspace(0.0, 5.0, 51)
    S = 14.6 + 0.3 * t
    got = compare_student_grid.report("curve", t, S, grid)
    out = capsys.readouterr().out
    _script("compare_student_grid")._report("curve", t, S, grid)
    assert out == capsys.readouterr().out
    assert got["max_abs_lag_after_0.5"] == pytest.approx(
        float(np.abs((S - np.interp(t, grid["times"], grid["entropy"]))
                     [t > 0.5]).max()))


def _minsr_args(**over):
    args = evolve_minsr_largep.parse_args(["--quick", "--device", "cpu"])
    args.device = torch.device("cpu")
    for k, v in over.items():
        setattr(args, k, v)
    return args


def test_minsr_quick_rhs_matches_jax(monkeypatch):
    """One RHS of the --quick problem (d=8, depth 4, hidden 16, f64; N cut
    to 128 < P so that minSR's kernel is N x N) on the JAX script's flow
    carried across, shared theta and draws: the update, the spectrum and
    the diagnostics to 1e-8."""
    jargs = SimpleNamespace(dim=8, depth=4, hidden=16, n=128, dt0=1e-6,
                            max_step=1e-2, precision="f64")
    jst, jtdvp, _ = _script("evolve_minsr_largep").build(jargs)
    flow, theta = from_jax(block_tuples(jst.flow),
                           jax.tree.map(np.asarray, jst.params))
    monkeypatch.setattr("vmc_pde_torch.models.flow.build_flow",
                        lambda *a, **k: (flow, theta))
    st, tdvp, stepper = evolve_minsr_largep.build(_minsr_args(n=128))
    assert tdvp.solver_method == jtdvp.solver_method == "minsr"
    assert tdvp.n_params == jtdvp.n_params > tdvp.n_samples == 128
    assert not tdvp.uses_kernel and stepper.pair_fn == tdvp.heun_pair
    z = normal((128, 8), 71)
    jaux = jtdvp._fused(jnp.asarray(theta.numpy()), 0.01,
                        jax.random.PRNGKey(0), jnp.asarray(z), None, None,
                        None, n=128, n_obs=128, with_obs=True)
    aux = tdvp._rhs_impl(theta, 0.01, 0, t64(z))
    for k in ("update", "ev", "tdvp_error", "entropy", "covar"):
        assert rel_err(aux[k], np.asarray(jaux[k])) < 1e-8, k
    # the kernel-space residual sits at rounding in both (P > N)
    assert float(aux["solver_res"]) < 1e-12 > float(jaux["solver_res"])


def test_minsr_evolution_and_chunked_replay():
    """The study's evolution loop on a small problem, per step and in
    batches of 4 (the same trajectory to 1e-12), and the chunked replay:
    chunks of 16 against the direct solve within the streaming test's
    bar (test_torch_solvers.py: 2e-4 of the update, here of the step's
    change of theta); the order control (the same draws in two orders)
    within f64 rounding."""
    small = dict(depth=2, hidden=4, n=64, t_end=1.5e-5)
    runs = {}
    for K in (1, 4):
        args = _minsr_args(steps_per_dispatch=K, **small)
        runs[K], n_step = evolve_minsr_largep.evolve(
            args, *evolve_minsr_largep.build(args))
        assert n_step == len(runs[K][0]) == 6
    for a, b in zip(runs[1], runs[4]):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=0)
    s = evolve_minsr_largep.summarize(_minsr_args(**small), 1, 64, n_step,
                                      *runs[1], 0.0)
    assert s["steps"] == n_step and s["entropy_err_max"] < 2.0
    assert np.isfinite([v for v in s.values() if isinstance(v, float)]).all()
    diffs, moves = evolve_minsr_largep.chunked_vs_direct(
        _minsr_args(chunk=16, chunk_steps=2, **small))
    assert len(diffs) == len(moves) == 2 and 0 < moves[0] < moves[1]
    assert all(d <= 2e-4 * m for d, m in zip(diffs, moves)), (diffs, moves)
    # the order control: the same draws in another order move theta by
    # f64 rounding only, and the first step as far as the keyed one
    diffs_c, moves_c = evolve_minsr_largep.order_control(
        _minsr_args(chunk_steps=2, **small))
    assert all(0 < d <= 1e-9 * m for d, m in zip(diffs_c, moves_c)), \
        (diffs_c, moves_c)
    assert 0.5 < moves_c[0] / moves[0] < 2
