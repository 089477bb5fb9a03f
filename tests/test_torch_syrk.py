"""The port's syrk Gram backend against the JAX package, on the CPU:
``syrk_plain`` (what ``syrk`` runs for CPU tensors) against the JAX
triangle kernel in interpret mode at the shapes of tests/test_kernels.py,
the direct and chunked statistics with ``gram_backend="syrk"`` against the
JAX TDVP's on the same samples, the wrapper's layout handling and the
ValueErrors.

Tolerances: 2e-5 (3e-5 weighted) of the largest entry against the exact
f64 product, the JAX tests' bars for the 3-pass bf16 split (its dropped
lo*lo term is ~2^-16 relative); 1e-4 for the statistics, as
tests/test_torch_chunked.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_chunked import _problem, _samples
from test_torch_models import rel_err
from vmc_pde_torch.kernels import persample, syrk
from vmc_pde_torch.solver.tdvp import TDVP, TDVPConfig
from vmc_pde_tpu.kernels.syrk import syrk as jsyrk

torch.set_num_threads(1)


@pytest.mark.parametrize("N,P,weighted", [
    (1024, 512, False), (512, 300, False), (100, 937, False),
    (48, 70, False), (512, 384, True)])
def test_syrk_plain_matches_jax_kernel(N, P, weighted):
    rng = np.random.default_rng(P)
    O = rng.normal(size=(N, P)).astype(np.float32)
    w = rng.normal(size=N).astype(np.float32) if weighted else None
    S = syrk.syrk(torch.from_numpy(O),
                  None if w is None else torch.from_numpy(w))
    J = np.asarray(jsyrk(jnp.asarray(O), None if w is None
                         else jnp.asarray(w), interpret=True))
    ref = O.astype(np.float64).T @ (O if w is None else O * w[:, None])
    tol = (3e-5 if weighted else 2e-5) * np.abs(ref).max()
    assert S.shape == (P, P) and S.dtype == torch.float32
    np.testing.assert_allclose(S.numpy(), ref, atol=tol)
    np.testing.assert_allclose(S.numpy(), J, atol=tol)


def test_syrk_layout_and_errors():
    """The kernel reads O feature-major: the per-sample kernel's .T view
    passes through, another layout or a ragged N becomes a zero-padded
    copy; the CUDA wrapper refuses CPU tensors."""
    X = torch.randn(70, 48)
    view, n = syrk._feature_major(X.T)
    assert n == 48 and view.data_ptr() == X.data_ptr()
    copy, n = syrk._feature_major(torch.randn(50, 70))
    assert n == 52 and copy.shape == (70, 52) and (copy[:, 50:] == 0).all()
    with pytest.raises(ValueError, match="CUDA"):
        syrk.syrk_cuda(X.T)


@pytest.mark.parametrize("chunked", [False, True])
def test_syrk_statistics_match_jax(chunked):
    """S0, F0 and A through gram_backend='syrk' on the same samples: the
    JAX TDVP runs its triangle kernel in interpret mode, the port the plain
    version through the same wrapper the card launches."""
    jtdvp, tdvp, theta, jflat = _problem(gram_backend="syrk")
    assert tdvp._use_syrk and jtdvp._use_syrk
    x = _samples(tdvp, theta, 53)
    launches = (persample.per_sample_cuda.launches, syrk.syrk_cuda.launches)
    if chunked:
        st = tdvp._chunked_stats(theta.float(), 0.25, x)
        jst = jtdvp._chunked_stats(jflat, 0.25, jnp.asarray(x.numpy()))
    else:
        st = tdvp._direct_stats(theta.float(), 0.25, x)
        jst = jtdvp._direct_stats(jflat, 0.25, jnp.asarray(x.numpy()))
    assert launches == (persample.per_sample_cuda.launches,
                        syrk.syrk_cuda.launches)
    for key in ("S0", "F0", "A"):
        assert st[key].dtype == torch.float32
        assert rel_err(st[key], jst[key]) < 1e-4, key


def test_syrk_backend_validation():
    """syrk is an f32 backend at gram_precision='high' and has no cross
    term, as in the JAX package."""
    _, tdvp, _, _ = _problem(gram_backend="syrk")
    state, eq = tdvp.state, tdvp.equation
    from vmc_pde_torch.utils.dtypes import Precision

    with pytest.raises(ValueError, match="gram_precision='high'"):
        TDVP(state, eq, TDVPConfig(gram_backend="syrk",
                                   gram_precision="highest"), n_samples=64)
    with pytest.raises(ValueError, match="gram_precision='high'"):
        TDVP(state, eq, TDVPConfig(gram_backend="syrk"), n_samples=64,
             precision=Precision.f64_everywhere())
    with pytest.raises(ValueError, match="cross term"):
        TDVP(state, eq, TDVPConfig(gram_backend="syrk", gram_cross="int8"),
             n_samples=64)
