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


def test_split_plain_matches_pallas_emit_split():
    """The split variant's plain version against make_per_sample_pallas(
    emit_split=True, interpret=True) in f32, two tiles of 8 with a shift.
    Tolerances, relative to the largest value unless stated: logp, g and
    quad 1e-5 (both f32; the same sums in another order through a flow
    whose values reach ~1e2); hi + lo to 2^-16 of max |O - shift| (the
    split's dropped residual) plus dO, the largest difference of the two
    packages' f32 O (the interpreted plain-mode kernel's); omax to dO;
    colsum to 16 dO plus 1e-6 of its largest value (16 f32 terms)."""
    jflow, jparams, flow, theta = parity_flow("affine", seed=11)
    jparams = jax.tree.map(lambda a: a.astype(np.float32), jparams)
    flat, unravel = ravel_pytree(jparams)
    P = int(flat.size)
    x = normal((16, flow.dim), 12).astype(np.float32)
    dirs = normal((3, flow.dim), 13).astype(np.float32)
    shift = np.linspace(-0.5, 0.5, P, dtype=np.float32)
    kw = dict(tile=8, interpret=True, template=jparams)
    want = jpersample.make_per_sample_pallas(
        jflow, unravel, P, dirs, emit_split=True, **kw)(
            flat, jax.numpy.asarray(x), jax.numpy.asarray(shift))
    O_jax = np.asarray(jpersample.make_per_sample_pallas(
        jflow, unravel, P, dirs, **kw)(flat, jax.numpy.asarray(x))[3])
    tx, tdirs = torch.from_numpy(x), torch.from_numpy(dirs)
    got = persample.per_sample_split_plain(flow, theta.float(), tx, tdirs,
                                           torch.from_numpy(shift))
    O_port = persample.per_sample_plain(flow, theta.float(), tx, tdirs)[3]
    dO = float(np.abs(O_port.numpy() - O_jax).max())
    for name, g_, w_ in zip(("logp", "g", "quad"), got, want):
        assert g_.dtype == torch.float32 and g_.shape == tuple(w_.shape)
        assert rel_err(g_, w_) < 1e-5, name
    hi, lo = got[3]
    assert hi.dtype == lo.dtype == torch.bfloat16
    assert hi.shape == (16, P)
    o = hi.float().numpy() + lo.float().numpy()
    jo = (np.asarray(want[3][0], np.float32)
          + np.asarray(want[3][1], np.float32))
    assert np.abs(o - jo).max() <= 2.0**-16 * np.abs(jo).max() + dO
    assert np.abs(got[5].numpy() - np.asarray(want[5])).max() <= dO
    jsum = np.asarray(want[4])
    assert (np.abs(got[4].numpy() - jsum).max()
            <= 16 * dO + 1e-6 * np.abs(jsum).max())


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
    # the split variant dispatches the same way
    shift = torch.zeros(flow.layout.size, dtype=torch.float64)
    before = persample.per_sample_split_cuda.launches
    got = persample.per_sample_split(flow, theta, x, dirs, shift)
    want = persample.per_sample_split_plain(flow, theta, x, dirs, shift)
    for g_, w_ in zip(got[:3] + got[3] + got[4:],
                      want[:3] + want[3] + want[4:]):
        assert torch.equal(g_, w_)
    with pytest.raises(ValueError, match="CUDA"):
        persample.per_sample_split_cuda(flow, theta.float(), x.float(), dirs,
                                        shift.float())
    assert persample.per_sample_split_cuda.launches == before


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
