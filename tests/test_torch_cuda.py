"""The hand-written CUDA per-sample kernel (vmc_pde_torch/kernels/
csrc/persample.cu) against its plain torch.func version, on the card.

These tests need a CUDA device and nvcc; without one they skip. They
import nothing of JAX, so on a machine without it they run with
``python -m pytest --noconftest tests/test_torch_cuda.py``.

The reference is the plain pipeline in f64 on the same inputs, so the
difference is the kernel's own f32 rounding. Tolerances are relative to
the largest reference value: 1e-4 for logp and 2e-4 for g and O (f32
carries ~6e-8; the coupling blocks' exp/tanh amplify it, and the plain
pipeline in f32 shows up to 3e-5 on these inputs) and 1e-3 for the
Hessian quadratic trace, a second derivative summed over directions with
cancellations. Samples are standard normal for the strongly perturbed
small flows: pushed through such a flow they reach |x| ~ 1e4, where f32
itself loses several digits.
"""

import numpy as np
import pytest
import torch

from vmc_pde_torch.kernels import persample
from vmc_pde_torch.models.coupling import VARIANTS
from vmc_pde_torch.models.flow import build_flow, perturb_theta
from vmc_pde_torch.ops.evolution import make_equation

pytestmark = pytest.mark.cuda

TOL = {"logp": 1e-4, "g": 2e-4, "quad": 1e-3, "O": 2e-4}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _case(dev, variant, dim, depth, hidden, n, out_scale, push, seed=3):
    """Flow, perturbed theta and samples: latent draws pushed through the
    flow (``push``), or the draws themselves as x."""
    flow, theta = build_flow(seed, dim, depth=depth, hidden=hidden,
                             variant=variant, dtype=torch.float64,
                             device=dev)
    theta = perturb_theta(flow, theta, np.random.default_rng(seed),
                          out_scale=out_scale)
    gen = torch.Generator(device=dev).manual_seed(seed)
    z = torch.randn((n, dim), generator=gen, dtype=torch.float64,
                    device=dev)
    x = flow.push(flow.layout.unravel(theta), z)[0] if push else z
    return flow, theta, x


def _check(flow, theta, x, dirs):
    dirs64 = None if dirs is None else torch.as_tensor(
        dirs, dtype=torch.float64, device=x.device)
    ref = persample.per_sample_plain(flow, theta, x, dirs64)
    got = persample.per_sample_cuda(flow, theta.float(), x.float(), dirs)
    torch.cuda.synchronize()
    for name, a, r in zip(("logp", "g", "quad", "O"), got, ref):
        if r is None:
            assert a is None
            continue
        assert a.shape == r.shape and a.dtype == torch.float32
        err = float((a.double() - r).abs().max()
                    / r.abs().max().clamp_min(1.0))
        assert err < TOL[name], (name, err)


@pytest.mark.parametrize("variant", VARIANTS)
def test_kernel_matches_plain_small(dev, variant):
    """All four coupling variants, two hidden layers, non-axis
    directions, and a ragged batch (77 is no multiple of the block)."""
    flow, theta, x = _case(dev, variant, 6, 3, (3, 4), 77, out_scale=0.3,
                           push=False)
    dirs = np.random.default_rng(1).standard_normal((4, 6))
    _check(flow, theta, x, dirs)


def test_kernel_matches_plain_fokker_planck32(dev):
    """The fokkerPlanck32 flow (d=32, P=9264, affine) with the
    Fokker-Planck trace directions, on a ragged batch of 1000."""
    flow, theta, x = _case(dev, "affine", 32, 4, (16,), 1000,
                           out_scale=0.03, push=True)
    assert flow.layout.size == 9264
    eq = make_equation("advection_hamiltonian_wDiss", 32, T=10.0,
                       coupled=True)
    _check(flow, theta, x, eq.hessian_trace_dirs(32))


def test_launch_counter_and_no_directions(dev):
    """The counter rises by one per launch; without directions the kernel
    skips the jets and returns no quad."""
    flow, theta, x = _case(dev, "scale", 4, 2, (3,), 40, out_scale=0.3,
                           push=False)
    before = persample.per_sample_cuda.launches
    _check(flow, theta, x, None)
    assert persample.per_sample_cuda.launches == before + 1
    persample.per_sample(flow, theta.float(), x.float(), None)
    assert persample.per_sample_cuda.launches == before + 2


def test_kernel_rejects_f64(dev):
    flow, theta, x = _case(dev, "scale", 4, 2, (3,), 8, out_scale=0.3,
                           push=False)
    with pytest.raises(ValueError, match="f32"):
        persample.per_sample_cuda(flow, theta, x, None)
