"""The port's run state (vmc_pde_torch/utils/checkpoint.py, timings.py,
recorder.py with native/recorder.cpp, and the driver's --seed,
--init-params, --checkpoint-every, --resume, --async-recorder and
--profile-dir) against the JAX package's counterparts, on the CPU.

Tolerances:
- checkpoint files and recorder logs: equal, bit for bit, whichever
  package wrote them (the same npz keys and the same "VPDR1" records);
- resume: on mwe in f64 (depth 2, N=256) 2 steps + a resume for 2 equal 4
  uninterrupted steps bit for bit (theta, t, dt and the recorded rows: the
  same step keys, fold_in(sample_seed + 7, n_step), and the same
  operations); on 2 gloo ranks theta is bitwise equal across the ranks
  after the resumed step and within 1e-12 of one process's uninterrupted
  run (tests/test_torch_mesh.py's bar: the all-reduce sums in another
  order);
- the recorder's log against the run's InfoRecorder rows: exact (f32 and
  f64 values widen to f64 exactly).
"""

import json
import os
import shutil
import time

import numpy as np
import pytest
import torch

import torch_mesh_worker as worker
from test_torch_models import rel_err
from vmc_pde_torch import driver
from vmc_pde_torch.config import preset
from vmc_pde_torch.utils import checkpoint, recorder, timings
from vmc_pde_tpu.utils import checkpoint as jcheckpoint
from vmc_pde_tpu.utils import recorder as jrecorder
from vmc_pde_tpu.utils import timings as jtimings

torch.set_num_threads(1)


def mwe(**kw):
    """mwe in f64 at depth 2, N=256, quiet, on the CPU."""
    return preset("mwe", depth=2, precision="f64", device="cpu",
                  n_samples_tdvp=256, n_samples_obs=256, grid_points=30,
                  verbose=False, **kw)


def drive(cfg, max_steps):
    """run(cfg); returns (state, InfoRecorder arrays, theta after every
    step)."""
    thetas = []
    state, rec = driver.run(cfg, max_steps=max_steps, callbacks=[
        lambda n, t, st, info: thetas.append(st.get_parameters().clone())])
    return state, rec.as_arrays(), thetas


# -- checkpoint files --------------------------------------------------------

def test_checkpoint_files_load_in_both_packages(tmp_path):
    """The JAX package's npz checkpoint loads in the port and the port's in
    the JAX package: the same file names, keys and values."""
    theta = np.random.default_rng(0).standard_normal(37)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    jcheckpoint.save_checkpoint(jdir, 12, 0.125, theta, 3e-3)
    checkpoint.save_checkpoint(tdir, 12, 0.125, torch.as_tensor(theta),
                               3e-3)
    assert sorted(os.listdir(jdir)) == sorted(os.listdir(tdir)) == [
        "ckpt_00000012.npz", "ckpt_latest.npz"]
    for got in (checkpoint.latest_checkpoint(jdir),
                jcheckpoint.latest_checkpoint(tdir),
                checkpoint.load_checkpoint(
                    os.path.join(jdir, "ckpt_00000012.npz"))):
        assert (got["step"], got["t"], got["dt"]) == (12, 0.125, 3e-3)
        assert got["theta"].dtype == np.float64
        np.testing.assert_array_equal(got["theta"], theta)
    with np.load(os.path.join(tdir, "ckpt_latest.npz")) as z:
        assert sorted(z.files) == ["dt", "step", "t", "theta"]
    assert checkpoint.latest_checkpoint(str(tmp_path / "none")) is None


# -- resume and the initial parameters -------------------------------------

@pytest.fixture(scope="module")
def uninterrupted():
    """4 steps of mwe in f64, the reference of the resume tests."""
    state, rows, thetas = drive(mwe(), 4)
    return rows, thetas


@pytest.fixture(scope="module")
def checkpointed(tmp_path_factory):
    """2 steps with a checkpoint after each, in a workdir of their own."""
    wdir = str(tmp_path_factory.mktemp("ckpt"))
    drive(mwe(workdir=wdir, checkpoint_every=1), 2)
    return wdir


def test_checkpoint_every_writes_each_step(checkpointed, uninterrupted):
    """After step n the checkpoint holds n + 1, t + dt, theta and the
    stepper's dt: the uninterrupted run's."""
    rows, thetas = uninterrupted
    assert sorted(os.listdir(checkpointed)) == [
        "ckpt_00000001.npz", "ckpt_00000002.npz", "ckpt_latest.npz",
        "infos.hdf5"]
    for n in (1, 2):
        ck = checkpoint.load_checkpoint(
            os.path.join(checkpointed, f"ckpt_{n:08d}.npz"))
        assert ck["step"] == n
        assert ck["t"] == rows["times"][n - 1] + rows["dt"][n - 1]
        assert ck["dt"] == rows["dt"][n - 1]
        np.testing.assert_array_equal(ck["theta"], thetas[n - 1].numpy())


def test_resume_replays_the_uninterrupted_run(checkpointed, uninterrupted,
                                              tmp_path):
    """2 steps + a resume for 2 equal 4 steps bit for bit (theta after each
    step, t, dt, and every recorded row of the resumed steps)."""
    rows, thetas = uninterrupted
    wdir = str(tmp_path / "run")
    shutil.copytree(checkpointed, wdir)
    _, got_rows, got_thetas = drive(mwe(workdir=wdir, resume=True), 2)
    for a, b in zip(got_thetas, thetas[2:]):
        assert torch.equal(a, b)
    for key, v in got_rows.items():
        if key.startswith("grid_integral"):
            continue
        np.testing.assert_array_equal(v, rows[key][2:4], err_msg=key)


def test_resume_wins_over_init_params(checkpointed, uninterrupted,
                                      tmp_path):
    """With a checkpoint in the workdir, --resume starts from it and not
    from --init-params; without one, from --init-params."""
    rows, thetas = uninterrupted
    init = str(tmp_path / "init.npz")
    np.savez(init, theta=np.full(thetas[0].numel(), 1e-3))
    _, _, got = drive(mwe(workdir=checkpointed, resume=True,
                          init_params=init), 1)
    assert torch.equal(got[0], thetas[2])
    state, _, _ = drive(mwe(workdir=str(tmp_path / "empty"), resume=True,
                            init_params=init), 0)
    assert state.get_parameters().dtype == torch.float64
    assert (state.get_parameters() == 1e-3).all()


def test_load_init_params_errors(tmp_path, uninterrupted):
    state = driver.build_problem(mwe())[0]
    p = state.numParameters
    bad = str(tmp_path / "shape.npz")
    np.savez(bad, theta=np.zeros(p + 1))
    with pytest.raises(ValueError, match=r"holds \(%d,\) parameters; this "
                       r"flow has \(%d,\)" % (p + 1, p)):
        driver.load_init_params(bad, state)
    no_theta = str(tmp_path / "none.npz")
    np.savez(no_theta, params=np.zeros(p))
    with pytest.raises(ValueError, match=r"has no 'theta' array \(found "
                       r"\['params'\]\)"):
        driver.load_init_params(no_theta, state)
    orbax = tmp_path / "pretrain_ckpt"
    orbax.mkdir()
    with pytest.raises(ValueError, match="orbax pytree checkpoint"):
        driver.load_init_params(str(orbax), state)
    # an f32 npz comes back in the master dtype
    ok = str(tmp_path / "ok.npz")
    np.savez(ok, theta=np.ones(p, np.float32))
    got = driver.load_init_params(ok, state)
    assert got.dtype == torch.float64 and (got == 1).all()


# -- the CLI -----------------------------------------------------------------

def _parsed(monkeypatch, argv):
    """The RunConfig main() builds from ``argv`` (run is not called)."""
    seen = {}

    def fake_run(cfg, max_steps, callbacks):
        seen.update(cfg=cfg, max_steps=max_steps)

    monkeypatch.setattr(driver, "run", fake_run)
    driver.main(argv)
    return seen["cfg"]


def test_cli_run_state_flags(monkeypatch):
    """--seed sets both seeds (the JAX driver's rule); the other run-state
    flags reach their RunConfig fields; the defaults leave them off."""
    cfg = _parsed(monkeypatch, ["mwe", "--seed", "7", "--init-params",
                                "p.npz", "--checkpoint-every", "5",
                                "--resume", "--async-recorder",
                                "--workdir", "w", "--profile-dir", "prof"])
    assert (cfg.seed, cfg.sample_seed) == (7, 7)
    assert (cfg.init_params, cfg.checkpoint_every, cfg.resume,
            cfg.async_recorder, cfg.workdir, cfg.profile_dir,
            cfg.profile_steps) == ("p.npz", 5, True, True, "w", "prof",
                                   (5, 8))
    cfg = _parsed(monkeypatch, ["mwe"])
    assert (cfg.seed, cfg.sample_seed, cfg.device) == (1, 1, "cuda")
    assert (cfg.init_params, cfg.checkpoint_every, cfg.resume,
            cfg.async_recorder, cfg.profile_dir) == (None, 0, False, False,
                                                     None)


def test_seed_changes_the_run():
    """--seed 3 twice gives one theta; the default seed another."""
    argv = ["mwe", "--precision", "f64", "--device", "cpu", "--samples",
            "128", "--max-steps", "1", "--t-end", "1e-6"]
    a = driver.main(argv + ["--seed", "3"])[0].get_parameters()
    b = driver.main(argv + ["--seed", "3"])[0].get_parameters()
    c = driver.main(argv)[0].get_parameters()
    assert torch.equal(a, b) and not torch.equal(a, c)


@pytest.mark.parametrize("name,kernel", [("pallas", True), ("cuda", True),
                                         ("xla", False), ("torch", False)])
def test_per_sample_backend_aliases(name, kernel, monkeypatch):
    """The JAX package's pallas and xla select the kernel's wrapper and the
    torch.func pipeline, as cuda and torch do, from the CLI too."""
    cfg = _parsed(monkeypatch, ["mwe", "--per-sample-backend", name])
    assert cfg.per_sample_backend == name
    tdvp = driver.build_problem(mwe(per_sample_backend=name))[1]
    assert tdvp.uses_kernel is kernel


def test_unknown_per_sample_backend_raises():
    with pytest.raises(ValueError, match="unknown per_sample_backend"):
        driver.build_problem(mwe(per_sample_backend="triton"))


# -- timings -----------------------------------------------------------------

def test_timings_sections_match_jax(capsys):
    """The same calls on both packages' Timings: the same sections, spans
    of the slept length, the same misuse errors and report lines."""
    out = {}
    for name, mod in (("jax", jtimings), ("torch", timings)):
        tm = mod.Timings()
        with tm.section("a"):
            time.sleep(0.01)
        tm.start_timing("b")
        tm.stop_timing("b", waitFor={"x": (torch.ones(2),)}
                       if name == "torch" else None)
        with pytest.raises(RuntimeError, match="never started"):
            tm.stop_timing("c")
        tm.start_timing("d")
        with pytest.raises(RuntimeError, match="already open"):
            tm.start_timing("d")
        assert tm.last("a") >= 0.01
        tm.print_timings()
        lines = capsys.readouterr().out.splitlines()
        out[name] = (sorted(tm.timing_dict), sorted(tm.totals()),
                     [ln.split(":")[0] for ln in lines])
    assert out["jax"] == out["torch"]


def test_profiler_window_writes_trace(tmp_path):
    """profile_steps (1, 3) over 4 steps: one Chrome trace, holding the
    second and third steps' RHS (two per Heun step, each one symmetric
    eigendecomposition on mwe's eigh solve) and nothing of the others."""
    pdir = str(tmp_path / "prof")
    drive(mwe(profile_dir=pdir, profile_steps=(1, 3)), 4)
    assert os.listdir(pdir) == ["trace_rank0.json"]
    with open(os.path.join(pdir, "trace_rank0.json")) as f:
        events = json.load(f)["traceEvents"]
    eighs = [e for e in events if e.get("name") == "aten::linalg_eigh"]
    assert len(eighs) == 4


# -- the native recorder -----------------------------------------------------

def _write_log(mod, path):
    rec = mod.AsyncRecorder(path)
    for step in range(50):
        rec.record("entropy", step, 2.84 + step * 1e-3)
        rec.record("ev", step, np.linspace(0, 1, 37))
    rec.record_dict(50, {"x1": np.array([0.1, 0.2]), "_private": 1.0,
                         "empty": np.zeros(0)})
    rec.close()


def test_recorder_logs_read_alike_in_both_packages(tmp_path):
    """A log written by either package parses identically with both
    read_log functions (names, steps, wall times, values)."""
    jprobe = jrecorder.AsyncRecorder(str(tmp_path / "probe.bin"))
    assert jprobe.available  # g++ is here: the JAX recorder builds
    jprobe.close()
    for name, mod in (("torch", recorder), ("jax", jrecorder)):
        path = str(tmp_path / f"{name}.bin")
        _write_log(mod, path)
        a, b = recorder.read_log(path), jrecorder.read_log(path)
        assert len(a) == len(b) == 102
        for (na, sa, ta, da), (nb, sb, tb, db) in zip(a, b):
            assert (na, sa, ta) == (nb, sb, tb)
            np.testing.assert_array_equal(da, db)
        infos = recorder.log_to_infos(path)
        assert np.asarray(infos["ev"]).shape == (50, 37)
        assert infos["entropy"][3] == 2.84 + 3e-3
        assert "_private" not in infos and infos["empty"][0].size == 0
    # the two writers' logs differ only in their wall times
    for x, y in zip(recorder.read_log(str(tmp_path / "torch.bin")),
                    recorder.read_log(str(tmp_path / "jax.bin"))):
        assert x[:2] == y[:2]
        np.testing.assert_array_equal(x[3], y[3])


def test_recorder_corrupt_files(tmp_path):
    junk = tmp_path / "junk.bin"
    junk.write_bytes(b"not a log at all")
    with pytest.raises(ValueError, match="is not a recorder log"):
        recorder.read_log(str(junk))
    bad_kind = tmp_path / "kind.bin"
    bad_kind.write_bytes(b"VPDR1\x00\x01\x00\x07")
    with pytest.raises(ValueError, match="corrupt record kind 7"):
        recorder.read_log(str(bad_kind))


def test_recorder_build_failure_raises(tmp_path, monkeypatch):
    """A source g++ refuses raises with the compiler's output; nothing is
    published in the build directory."""
    src = tmp_path / "recorder.cpp"
    src.write_text("this is not C++\n")
    monkeypatch.setattr(recorder, "SRC", src)
    monkeypatch.setattr(recorder, "BUILD_ROOT", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed on recorder.cpp"
                       "(.|\n)*error"):
        recorder.build()
    assert not list((tmp_path / "_build").rglob("*.so"))


def test_recorder_record_dict_reads_tensors_once():
    """record_dict's tensors come to the host as one f64 buffer per device;
    numbers and arrays pass through."""
    got = recorder._to_host({"a": torch.tensor(1.5, dtype=torch.float32),
                             "b": torch.arange(3), "c": 2.0,
                             "d": torch.tensor(True)})
    assert got["c"] == 2.0
    np.testing.assert_array_equal(got["a"], [1.5])
    np.testing.assert_array_equal(got["b"], [0.0, 1.0, 2.0])
    np.testing.assert_array_equal(got["d"], [1.0])
    assert all(got[k].dtype == np.float64 for k in "abd")


def test_driver_async_recorder_round_trip(tmp_path):
    """async_recorder mirrors every step's rows into metrics.bin: for each
    key whose rows are numbers, and dist_params, log_to_infos (the port's
    and the JAX package's) equals the InfoRecorder's rows exactly; the
    skipped payloads stay out; only the coordinator writes."""
    wdir = str(tmp_path / "run")
    _, rows, _ = drive(mwe(workdir=wdir, async_recorder=True), 3)
    path = os.path.join(wdir, "metrics.bin")
    for read in (recorder.log_to_infos, jrecorder.log_to_infos):
        logged = read(path)
        keys = [k for k, v in rows.items() if v.ndim == 1
                and not k.startswith("grid_integral")]
        assert {"times", "dt", "solver_res", "entropy", "nan"} <= set(keys)
        for key in keys + ["dist_params", "covar", "x1"]:
            want = rows[key].astype(np.float64)
            got = np.asarray(logged[key], dtype=np.float64)
            np.testing.assert_array_equal(got.reshape(want.shape), want,
                                          err_msg=key)
        assert "update" not in logged and "SExp" not in logged
    with pytest.raises(ValueError, match="async_recorder needs a workdir"):
        drive(mwe(async_recorder=True), 1)


# -- two ranks ---------------------------------------------------------------

MESH_ARGV = ["mwe", "--precision", "f64", "--device", "cpu", "--samples",
             "256"]


def test_resume_on_two_ranks(tmp_path):
    """2 gloo ranks in one workdir: 2 steps with checkpoints (rank 0
    writes), then --resume for 1 (both read): the resumed step starts at
    the checkpoint on both ranks, theta is bitwise equal across them and
    within 1e-12 of one process's 3 uninterrupted steps."""
    ranks = worker.run_ranks("resume", 2, str(tmp_path), {},
                             dict(argv=json.dumps(MESH_ARGV)))
    thetas = []
    driver.main(MESH_ARGV + ["--max-steps", "3"], callbacks=[
        lambda n, t, st, info: thetas.append(
            (t, st.get_parameters().numpy().copy()))])
    for out in ranks:
        assert int(out["step"]) == 2 and bool(out["same"])
        assert float(out["t"]) == thetas[2][0]
        assert rel_err(out["theta"], thetas[2][1]) < 1e-12
    np.testing.assert_array_equal(ranks[0]["theta"], ranks[1]["theta"])
    assert sorted(os.listdir(tmp_path / "run")) == [
        "ckpt_00000001.npz", "ckpt_00000002.npz", "ckpt_latest.npz",
        "infos.hdf5"]
