"""The port's per-sample module (vmc_pde_torch/kernels/persample.py) on the
CPU: its plain version against the JAX package's Pallas kernel in
interpret mode (as tests/test_persample.py runs it), the wrapper's
dispatch, and the block plan the CUDA kernel reads. The kernel itself
runs only on the card (tests/test_torch_cuda.py).

Tolerance of the Pallas comparison: 1e-10 relative to the largest value,
in f64. The interpreted kernel computes the same mathematics as the plain
pipeline by hand-written forward, backward and second-order jets; in f64
its bf16 hi/lo selection matmuls are exact (0/1 operands, each product one
term), so the two agree to accumulated rounding.
"""

import jax
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from test_torch_models import normal, parity_flow, rel_err, t64
from vmc_pde_torch.kernels import persample
from vmc_pde_torch.models.flow import build_flow
from vmc_pde_tpu.kernels import persample as jpersample

torch.set_num_threads(1)


@pytest.mark.parametrize("variant", ["affine", "scale_shift"])
def test_plain_matches_pallas_interpret(variant):
    """logp, g, Hessian quad trace along non-axis directions, and the
    (N, P) O matrix in ravel order: the port's plain per-sample pipeline
    against make_per_sample_pallas(interpret=True), two tiles of 8."""
    jflow, jparams, flow, theta = parity_flow(variant, seed=11)
    flat, unravel = ravel_pytree(jparams)
    x = normal((16, flow.dim), 12)
    dirs = normal((3, flow.dim), 13)
    run = jpersample.make_per_sample_pallas(
        jflow, unravel, int(flat.size), dirs, tile=8, interpret=True,
        template=jparams)
    want = run(flat, jax.numpy.asarray(x))
    got = persample.per_sample_plain(flow, theta, t64(x), t64(dirs))
    for name, g_, w_ in zip(("logp", "g", "quad", "O"), got, want):
        assert g_.shape == tuple(w_.shape), name
        assert rel_err(g_, w_) < 1e-10, name


def test_wrapper_takes_plain_version_on_cpu():
    """per_sample on CPU tensors is the plain pipeline, launches nothing,
    and returns no quad without directions; per_sample_cuda refuses CPU
    tensors instead of falling back."""
    _, _, flow, theta = parity_flow("scale", seed=2)
    x = t64(normal((9, flow.dim), 3))
    dirs = t64(np.eye(flow.dim))
    before = persample.per_sample_cuda.launches
    got = persample.per_sample(flow, theta, x, dirs)
    want = persample.per_sample_plain(flow, theta, x, dirs)
    for g_, w_ in zip(got, want):
        assert torch.equal(g_, w_)
    assert persample.per_sample(flow, theta, x, None)[2] is None
    assert persample.per_sample_cuda.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        persample.per_sample_cuda(flow, theta.float(), x.float(), dirs)
    assert persample.per_sample_cuda.launches == before


def test_block_plan_matches_layout():
    """The plan the CUDA kernel reads: every layer's bias/weight offsets
    are the flat layout's, the saves tile [0, n_saves) without overlap,
    the partitions are the blocks', and every theta row is covered once
    (so every O row is written)."""
    flow, _ = build_flow(0, 6, depth=3, hidden=(3, 4), variant="affine")
    meta, n_sv = persample.block_plan(flow, n_dirs=2)
    lay = flow.layout
    assert list(meta[:8]) == [6, 3, 2, lay.size,
                              lay.offset(("latent", "L")),
                              lay.offset(("latent", "L_diag")),
                              lay.offset(("latent", "mu")), n_sv]
    rows = np.zeros(lay.size, int)
    saves = np.zeros(n_sv, int)
    for b, spec in enumerate(flow.blocks):
        r = persample.HDR + b * persample.BLOCK_REC
        n_up, n_down = len(spec.ind_up), len(spec.ind_down)
        assert list(meta[r:r + 4]) == [1, n_up, n_down, 3]
        for slot, width in ((4, n_up), (5, n_down), (6, n_up)):
            saves[meta[r + slot]:meta[r + slot] + width] += 1
        for ni, net in enumerate(persample.NETS):
            dims = [spec.net_dims(net)[0], 3, 4, spec.net_dims(net)[1]]
            for layer in range(3):
                q = r + 8 + ni * persample.NET_REC + 5 * layer
                n_in, n_out, b_off, w_off, sv = meta[q:q + 5]
                assert (n_in, n_out) == (dims[layer], dims[layer + 1])
                assert b_off == lay.offset(("blocks", b, net, "b", layer))
                assert w_off == lay.offset(("blocks", b, net, "w", layer))
                rows[b_off:b_off + n_out] += 1
                rows[w_off:w_off + n_in * n_out] += 1
                saves[sv:sv + n_out] += 1
        ind = r + 8 + 4 * persample.NET_REC
        assert tuple(meta[ind:ind + n_up]) == spec.ind_up
        assert tuple(meta[ind + persample.MAX_HALF:
                          ind + persample.MAX_HALF + n_down]) == spec.ind_down
    for name in ("L", "L_diag", "mu"):
        off = lay.offset(("latent", name))
        size = int(np.prod(lay.shapes["latent"][name]))
        rows[off:off + size] += 1
    assert (rows == 1).all() and (saves == 1).all()


def test_supports_gate():
    flow, _ = build_flow(0, 32, depth=4, hidden=(16,), variant="affine")
    dirs = np.eye(32)[1::2]
    assert persample.supports(flow, dirs, tuple(range(1, 32, 2)))
    assert persample.supports(flow, None, None)          # no Hessian needed
    assert not persample.supports(flow, None, (0, 1))    # block mode
    wide, _ = build_flow(0, 8, depth=2, hidden=(65,))
    assert not persample.supports(wide, np.eye(8), None)
    deep, _ = build_flow(0, 8, depth=2, hidden=(4,) * 4)
    assert not persample.supports(deep, np.eye(8), None)
    big, _ = build_flow(0, 66, depth=2, hidden=(4,))
    assert not persample.supports(big, np.eye(66), None)
