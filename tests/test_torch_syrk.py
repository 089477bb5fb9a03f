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

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_chunked import _problem, _samples
from test_torch_models import rel_err
from vmc_pde_torch.kernels import persample, syrk
from vmc_pde_torch.solver.tdvp import TDVP, TDVPConfig
from vmc_pde_tpu.kernels.syrk import _split_bf16 as jsplit
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
    """The split pass reads O feature-major: the per-sample kernel's .T
    view passes through, with a ragged N too (the split pads it) and with
    a row stride wider than N; another layout becomes a contiguous copy;
    the CUDA wrappers refuse CPU tensors."""
    X = torch.randn(70, 48)
    view = syrk._feature_major(X.T)
    assert view.shape == (70, 48) and view.data_ptr() == X.data_ptr()
    ragged = torch.randn(70, 50)
    assert syrk._feature_major(ragged.T).data_ptr() == ragged.data_ptr()
    wide = torch.randn(70, 64)[:, 3:53]
    got = syrk._feature_major(wide.T)
    assert got.data_ptr() == wide.data_ptr() and got.stride() == (64, 1)
    O = torch.randn(50, 70)
    copy = syrk._feature_major(O)
    assert copy.shape == (70, 50) and copy.is_contiguous()
    assert torch.equal(copy, O.T)
    with pytest.raises(ValueError, match="CUDA"):
        syrk.syrk_cuda(X.T)
    with pytest.raises(ValueError, match="CUDA"):
        syrk.split_cuda(X.T)


@pytest.mark.parametrize("nb", [1, 2, 15, 16, 17, 73])
def test_tile_list_covers_the_lower_triangle_in_groups(nb):
    """Every lower tile (I >= J) once, and consecutive tiles in square
    groups: the tiles of group (a, b) are one run of the list, the groups
    row by row, each group's tiles row by row."""
    t = syrk.tile_list(nb)
    assert t.dtype == np.int32 and t.shape == (nb * (nb + 1) // 2, 2)
    assert (t[:, 0] >= t[:, 1]).all() and (t >= 0).all() and (t < nb).all()
    assert len({tuple(r) for r in t.tolist()}) == len(t)
    g = syrk.GROUP
    groups = [tuple(r) for r in (t // g).tolist()]
    runs = [k for k, _ in itertools.groupby(groups)]
    assert len(runs) == len(set(runs)) and runs == sorted(runs)
    assert [tuple(r) for r in t.tolist()] == sorted(
        map(tuple, t.tolist()), key=lambda r: (r[0] // g, r[1] // g) + r)


def _rows_read_per_wave(tiles, blocks=132):
    """Sum over the waves of ``blocks`` consecutive tiles of the operand
    rows a wave reads (each row tile once however many tiles share it)."""
    return sum(len({int(i) for t in tiles[w:w + blocks] for i in t})
               for w in range(0, len(tiles), blocks))


def test_tile_list_order_shares_rows_within_a_wave():
    """At P=9264 (73 tile rows) on 132 SMs the grouped order reads 599
    row tiles per call against 1063 row by row, 44% fewer: with 8.4 MB
    per row tile at N=16384 (bf16 hi and lo), ~5.0 GB from device memory
    against ~8.9 GB, if each wave finds only its own rows in L2."""
    nb = 73
    row_major = [(i, j) for i in range(nb) for j in range(i + 1)]
    grouped = _rows_read_per_wave(syrk.tile_list(nb).tolist())
    plain = _rows_read_per_wave(row_major)
    assert (grouped, plain) == (599, 1063)


@pytest.mark.parametrize("N,weighted", [(48, False), (50, True),
                                        (3, False), (101, True)])
def test_split_plain_matches_jax_split(N, weighted):
    """The split pass's plain version, padding included, bit for bit
    against the JAX package's _split_bf16 of the same operands (A = X w
    rounded in f32, B = X), on numpy inputs with values near bf16 ties."""
    rng = np.random.default_rng(N)
    P = 37
    X = rng.normal(size=(P, N)).astype(np.float32)
    X[0, :3] = np.float32([1 + 2.0**-8, -(1 + 3 * 2.0**-9), 2.0**-130])
    w = rng.normal(size=N).astype(np.float32) if weighted else None
    ops = syrk.split_plain(torch.from_numpy(X),
                           None if w is None else torch.from_numpy(w))
    Np = syrk.padded(N)
    assert Np % syrk.PAD == 0 and Np - syrk.PAD < N <= Np
    assert ops.dtype == torch.bfloat16
    assert ops.shape == ((4 if weighted else 2), P, Np)
    A = X if w is None else X * w[None, :]
    want = list(jsplit(jnp.asarray(A)))
    if weighted:
        want += list(jsplit(jnp.asarray(X)))
    for got, ref in zip(ops, want):
        ref = np.asarray(ref.astype(jnp.float32))
        np.testing.assert_array_equal(got[:, :N].float().numpy(), ref)
        assert (got[:, N:] == 0).all()


def kernel_constants(name):
    """The ``constexpr int NAME = <integer>;`` lines of csrc/<name>."""
    import pathlib
    import re

    src = (pathlib.Path(syrk.__file__).parent / "csrc" / name).read_text()
    return {k: int(v) for k, v in
            re.findall(r"^constexpr int (\w+) = (\d+);", src, re.M)}


def test_constants_match_the_kernel_source():
    """The wrapper's constants equal csrc/syrk.cu's (parsed from the
    source): the tile edge, the samples per stage (the TMA box's width),
    the ring depth, the stages per accumulation (512 samples) and the
    split arrays' padding."""
    k = kernel_constants("syrk.cu")
    for name in ("TILE", "KBOX", "STAGES", "FLUSH", "PAD"):
        assert k[name] == getattr(syrk, name), name
    assert syrk.KBOX * syrk.FLUSH == 512


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


def test_probe_builds_edit_the_kernel_sources():
    """tools/gram_probe.py's builds: each copy changes exactly the lines
    its edits name, once per expected occurrence, and nothing else of
    csrc/syrk.cu or csrc/quant8.cu; the load-only copy sends all three
    wgmma per 16 samples to a no-op, the no-V copy drops the V term's
    multiply-add."""
    from tools import gram_probe as probe
    from vmc_pde_torch.kernels import build

    for (name, kind), (prelude, edits) in probe.EDITS.items():
        src = (build.CSRC / f"{name}.cu").read_text().splitlines()
        var = probe.variant_source(name, kind).replace(prelude, "", 1)
        var = var.splitlines()
        assert len(var) == len(src), kind
        changed = [b for a, b in zip(src, var) if a != b]
        assert len(changed) == sum(c for _, _, c in edits), kind
    lo = probe.variant_source("syrk", "load_only")
    assert "wgmma_m64n128k16(acc, " not in lo
    assert lo.count("probe_skip(acc, ") == 3
    nv = probe.variant_source("quant8", "no_v")
    assert "fmaf(" not in nv


@pytest.mark.parametrize("name,label", [
    ("void (anonymous namespace)::split_kernel<true>(float const*)",
     "syrk kernels (split pass, product)"),
    ("(anonymous namespace)::tiles_kernel(CUtensorMap_st, int2 const*)",
     "syrk kernels (split pass, product)"),
    ("void (anonymous namespace)::persample_kernel<true, false, 16>(int)",
     "per-sample kernel, split mode"),
    ("void (anonymous namespace)::persample_kernel<false, true, 0>(int)",
     "per-sample kernel, plain mode"),
    ("void (anonymous namespace)::quant_force_kernel<1>(int)",
     "quant8 kernel")])
def test_profile_classes_name_the_kernels(name, label):
    """tools/profile_step.py files each kernel of the port under its own
    class, by the names the profiler reports for them."""
    from tools.profile_step import classify

    assert classify(name) == label
