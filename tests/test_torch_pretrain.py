"""The port's pre-training (vmc_pde_torch/pretrain/train.py) against the
JAX package's pretrain/train.py, on the CPU, and the handoff of its
checkpoint to the driver's --init-params.

Tolerances:
- gen_data: bit for bit (utils/threefry.py replays jax.random.normal of
  PRNGKey(key) in f64);
- train: 5 full-batch epochs (batchsize = N, so the shuffle only reorders
  the mean over the batch) of Adam in f64 from the same theta (the JAX
  flow carried across by models/convert.from_jax) on the same data: the
  losses within 1e-10 relative, theta within 1e-10 of max |theta| (most
  entries start near 0, out_scale 1e-5, so a per-entry relative bound
  would measure nothing); the two differ only in the order of f64 sums;
- the periodic grid integrals: 1e-10 relative of the JAX package's;
- a resumed pre-training: bit for bit the uninterrupted one (the shuffle
  is keyed by (key, epoch) alone).
"""

import os

import jax
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from test_torch_models import block_tuples
from vmc_pde_torch import driver
from vmc_pde_torch.config import preset
from vmc_pde_torch.models.convert import from_jax
from vmc_pde_torch.models.state import VarState, make_var_state
from vmc_pde_torch.pretrain import train as ptrain
from vmc_pde_torch.utils.dtypes import Precision
from vmc_pde_torch.utils.grid import Grid
from vmc_pde_tpu.models.state import make_var_state as jmake_var_state
from vmc_pde_tpu.pretrain import train as jtrain
from vmc_pde_tpu.utils.dtypes import Precision as JPrecision
from vmc_pde_tpu.utils.grid import Grid as JGrid

torch.set_num_threads(1)

F64 = Precision.f64_everywhere()


@pytest.mark.parametrize("mode", ["standard_normal", "normal_superpos"])
def test_gen_data_matches_jax(mode):
    """The f64 draws bit for bit, and the target densities on them."""
    want, jtarget = jtrain.gen_data((512, 4), mode=mode, key=3, std=1.5)
    got, target = ptrain.gen_data((512, 4), mode=mode, key=3, std=1.5)
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(target(got).numpy(),
                               np.asarray(jtarget(want)), rtol=1e-13)
    with pytest.raises(ValueError, match="unknown data mode"):
        ptrain.gen_data((4, 2), mode="uniform")


def _pair(ctx1, dim=2, depth=2):
    """The JAX package's f64 VarState and the port's on the same flow and
    theta."""
    jstate = jmake_var_state(1, dim, depth=depth, ctx=ctx1,
                             precision=JPrecision.f64_everywhere())
    flow, theta = from_jax(block_tuples(jstate.flow),
                           jax.tree.map(np.asarray, jstate.params))
    return jstate, VarState(flow, theta, precision=F64)


def test_train_matches_jax_full_batch(ctx1):
    """5 full-batch epochs of Adam (lr 1e-2) on normal_superpos in d=2,
    N=256, from the same theta: losses and theta (module docstring)."""
    jstate, state = _pair(ctx1)
    data, _ = jtrain.gen_data((256, 2), mode="normal_superpos", key=2)
    want = jtrain.train(jstate, data, batchsize=256, epochs=5, lr=1e-2)
    got = ptrain.train(state, ptrain.gen_data(
        (256, 2), mode="normal_superpos", key=2)[0], batchsize=256,
        epochs=5, lr=1e-2)
    assert len(got) == 5 and got[-1] < got[0]
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=0)
    jtheta = np.asarray(ravel_pytree(jstate.params)[0])
    theta = state.get_parameters().numpy()
    assert np.abs(theta - jtheta).max() <= 1e-10 * np.abs(jtheta).max()


def test_pretrain_checkpoint_and_resume(tmp_path):
    """3 epochs with a checkpoint after each, then a resume to 6, equal 6
    uninterrupted epochs bit for bit (losses and theta); the checkpoint
    holds theta, Adam's moments and step count, and the epoch."""
    data, _ = ptrain.gen_data((400, 2))

    def fresh():
        return make_var_state(1, 2, depth=2, precision=F64)

    full = fresh()
    losses_full = ptrain.train(full, data, epochs=6, batchsize=100)
    wdir = str(tmp_path)
    ptrain.train(fresh(), data, epochs=3, batchsize=100, workdir=wdir,
                 checkpoint_every=1)
    with np.load(os.path.join(wdir, "pretrain_ckpt.npz")) as z:
        assert sorted(z.files) == ["count", "epoch", "mu", "nu", "theta"]
        assert (int(z["count"]), int(z["epoch"])) == (12, 3)
    resumed = fresh()
    losses = ptrain.train(resumed, data, epochs=6, batchsize=100,
                          workdir=wdir, checkpoint_every=1, resume=True)
    assert losses == losses_full[3:]
    assert torch.equal(resumed.theta, full.theta)


def test_grid_integrals_match_jax(ctx1):
    """The periodic grid quadrature of the model density every check_every
    epochs, against the JAX package's on the same flow and data (full
    batches, as above); the density snapshots (grid with workdir) are not
    ported and raise."""
    jstate, state = _pair(ctx1)
    data, _ = jtrain.gen_data((128, 2), key=5)
    jtrain.train(jstate, data, batchsize=128, epochs=4, lr=1e-2,
                 grid=JGrid(np.ones(2) * 6.0, 40), check_every=2)
    ptrain.train(state, ptrain.gen_data((128, 2), key=5)[0], batchsize=128,
                 epochs=4, lr=1e-2, grid=Grid(np.ones(2) * 6.0, 40),
                 check_every=2)
    want = jstate.pretrain_grid_integrals
    got = state.pretrain_grid_integrals
    assert [e for e, _ in got] == [e for e, _ in want] == [2, 4]
    np.testing.assert_allclose([v for _, v in got], [v for _, v in want],
                               rtol=1e-10)
    assert all(abs(v - 1) < 0.05 for _, v in got)
    with pytest.raises(NotImplementedError, match="viz/"):
        ptrain.train(state, data, grid=Grid(np.ones(2) * 6.0, 40),
                     workdir="w")


def test_init_params_from_pretrain_checkpoint(tmp_path):
    """The pretrain CLI's checkpoint of mwe's flow (seed 1, depth 4,
    scale) starts the driver: the initial theta is the checkpoint's bit
    for bit, and the first steps run clean."""
    wdir = str(tmp_path / "pre")
    ptrain.main(["--dim", "2", "--n", "200", "--epochs", "2",
                 "--batchsize", "100", "--variant", "scale",
                 "--precision", "f64", "--workdir", wdir,
                 "--checkpoint-every", "1", "--device", "cpu"])
    ckpt = os.path.join(wdir, "pretrain_ckpt.npz")
    with np.load(ckpt) as z:
        theta = torch.as_tensor(z["theta"])
    cfg = preset("mwe", precision="f64", device="cpu", n_samples_tdvp=256,
                 n_samples_obs=256, grid_points=30, verbose=False,
                 init_params=ckpt)
    state, _ = driver.run(cfg, max_steps=0)
    assert torch.equal(state.get_parameters(), theta)
    state, rec = driver.main(["mwe", "--precision", "f64", "--device",
                              "cpu", "--samples", "256", "--max-steps", "2",
                              "--init-params", ckpt])
    rows = rec.as_arrays()
    assert not rows["nan"].any() and (rows["solver_res"] < 1e-3).all()
