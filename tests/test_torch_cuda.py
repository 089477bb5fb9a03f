"""The hand-written CUDA kernels (vmc_pde_torch/kernels/csrc/persample.cu
in plain and split mode, Gauss and Student-t latents, with and without the
learned global affine; csrc/quant8.cu, csrc/metropolis.cu, csrc/syrk.cu)
against their plain versions, on the card.

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

The split mode's pair hi + lo is held against the f64 O - shift to the O
tolerance plus 2^-16 of max |O - shift| (the split's dropped residual);
its column sums against the f64 sums of the pair to N 2^-16 max |o| and
its column max against the pair's to 2^-16 max |o|. quant8's q8 must be
bit-identical to the plain version's, and its f agree to 1e-5 of the
largest value (f32 sums of exact bf16 products in another order).
"""

import numpy as np
import pytest
import torch

from vmc_pde_torch.kernels import persample, quant8
from vmc_pde_torch.models.coupling import VARIANTS
from vmc_pde_torch.models.flow import build_flow, perturb_theta
from vmc_pde_torch.ops.evolution import make_equation
from vmc_pde_torch.parallel import stats

pytestmark = pytest.mark.cuda

TOL = {"logp": 1e-4, "g": 2e-4, "quad": 1e-3, "O": 2e-4}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _case(dev, variant, dim, depth, hidden, n, out_scale, push, seed=3,
          latent_name="Gauss", global_affine=False):
    """Flow, perturbed theta (a Student-t nu and the global affine's
    g_scale move off 2 and 1) and samples: standard normal draws pushed
    through the flow (``push``), or the draws themselves as x."""
    flow, theta = build_flow(seed, dim, depth=depth, hidden=hidden,
                             variant=variant, latent_name=latent_name,
                             global_affine=global_affine,
                             dtype=torch.float64, device=dev)
    theta = perturb_theta(flow, theta, np.random.default_rng(seed),
                          out_scale=out_scale)
    gen = torch.Generator(device=dev).manual_seed(seed)
    z = torch.randn((n, dim), generator=gen, dtype=torch.float64,
                    device=dev)
    x = flow.push(flow.layout.unravel(theta), z)[0] if push else z
    return flow, theta, x


def _close(name, a, r, p, tol):
    """Kernel output ``a`` against the f64 reference ``r``, relative to
    r's largest value: within ``tol``; or, given plain f32's ``p`` where
    plain f32 itself misses ``tol`` on these inputs, within plain f32's
    own error sample by sample (chip_smoke.py's phase-15 rule, _grade_ok:
    quantiles 0.5, 0.99 and 0.999 within twice plain f32's, the largest
    within ten times plain f32's largest)."""
    scale = r.abs().max().clamp_min(1.0)
    err = float((a.double() - r).abs().max() / scale)
    if err < tol:
        return
    assert p is not None, (name, err)
    assert float((p.double() - r).abs().max() / scale) >= tol, (name, err)

    def per_sample(v):
        e = (v.double() - r).abs()
        return ((e if e.ndim == 1 else e.amax(1)) / scale).cpu().numpy()

    ek, ep = per_sample(a), per_sample(p)
    qk = np.quantile(ek, (0.5, 0.99, 0.999))
    qp = np.quantile(ep, (0.5, 0.99, 0.999))
    assert (qk <= 2.0 * qp + 2.0**-24).all(), (name, err, qk, qp)
    assert ek.max() < max(tol, 10.0 * ep.max()), (name, err, ep.max())


def _check(flow, theta, x, dirs, graded=False):
    """The kernel against the plain version in f64 to TOL (``graded``:
    or to plain f32's own error, _close)."""
    dirs64 = None if dirs is None else torch.as_tensor(
        dirs, dtype=torch.float64, device=x.device)
    ref = persample.per_sample_plain(flow, theta, x, dirs64)
    got = persample.per_sample_cuda(flow, theta.float(), x.float(), dirs)
    p32 = (persample.per_sample_plain(
        flow, theta.float(), x.float(),
        None if dirs64 is None else dirs64.float()) if graded
        else (None,) * 4)
    torch.cuda.synchronize()
    for name, a, r, p in zip(("logp", "g", "quad", "O"), got, ref, p32):
        if r is None:
            assert a is None
            continue
        assert a.shape == r.shape and a.dtype == torch.float32
        _close(name, a, r, p, TOL[name])


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


def _check_split(flow, theta, x, dirs, graded=False):
    """Split mode against the plain version in f64 (``graded``: as
    _check)."""
    dirs64 = None if dirs is None else torch.as_tensor(
        dirs, dtype=torch.float64, device=x.device)
    P = flow.layout.size
    shift = torch.linspace(-0.5, 0.5, P, device=x.device)
    ref = persample.per_sample_plain(flow, theta, x, dirs64)
    got = persample.per_sample_split_cuda(flow, theta.float(), x.float(),
                                          dirs, shift)
    p32 = (persample.per_sample_split_plain(
        flow, theta.float(), x.float(),
        None if dirs64 is None else dirs64.float(), shift) if graded
        else (None,) * 4)
    torch.cuda.synchronize()
    for name, a, r, p in zip(("logp", "g", "quad"), got, ref, p32):
        if r is None:
            assert a is None
            continue
        _close(name, a, r, p, TOL[name])
    hi, lo = got[3]
    assert hi.dtype == lo.dtype == torch.bfloat16
    assert hi.shape == lo.shape == (x.shape[0], P)
    o_ref = ref[3] - shift.double()
    o = hi.double() + lo.double()
    scale = float(o_ref.abs().max())
    _close("hi+lo", o, o_ref, None if p32[3] is None
           else p32[3][0].double() + p32[3][1].double(), TOL["O"] + 2**-16)
    n = x.shape[0]
    assert float((got[4].double() - o.sum(0)).abs().max()) <= (
        n * 2**-16 * scale)
    assert float((got[5].double() - o.abs().amax(0)).abs().max()) <= (
        2**-16 * scale)


@pytest.mark.parametrize("variant", VARIANTS)
def test_split_kernel_matches_plain_small(dev, variant):
    """Split mode on all four variants with a ragged batch of 77: the tail
    threads of the last warp contribute nothing to the sums and max."""
    flow, theta, x = _case(dev, variant, 6, 3, (3, 4), 77, out_scale=0.3,
                           push=False)
    _check_split(flow, theta, x, np.random.default_rng(1).standard_normal(
        (4, 6)))


def test_split_kernel_matches_plain_fokker_planck32(dev):
    """Split mode at the fokkerPlanck32 shape, ragged 1000 samples, and a
    launch-counter check."""
    flow, theta, x = _case(dev, "affine", 32, 4, (16,), 1000,
                           out_scale=0.03, push=True)
    eq = make_equation("advection_hamiltonian_wDiss", 32, T=10.0,
                       coupled=True)
    before = persample.per_sample_split_cuda.launches
    _check_split(flow, theta, x, eq.hessian_trace_dirs(32))
    assert persample.per_sample_split_cuda.launches == before + 1


@pytest.mark.parametrize("variant,ga,lat", [
    ("scale", True, "Gauss"), ("affine", True, "Gauss"),
    ("scale", False, "Student_t"), ("affine", False, "Student_t"),
    ("affine", True, "Student_t"), ("additive", True, "Student_t"),
    ("scale_shift", True, "Student_t")])
def test_kernel_student_t_and_global_affine_small(dev, variant, ga, lat):
    """The Student-t latent (the nu row, the s-scaled latent rows and jet
    term) and the learned global affine (the g_scale and g_offset rows,
    the scaled tangents), in plain and split mode, ragged batch of 77."""
    flow, theta, x = _case(dev, variant, 6, 3, (3, 4), 77, out_scale=0.3,
                           push=False, latent_name=lat, global_affine=ga)
    assert persample.supports(flow, np.eye(6), None)
    dirs = np.random.default_rng(2).standard_normal((4, 6))
    _check(flow, theta, x, dirs)
    _check_split(flow, theta, x, dirs)


def test_kernel_student_t_global_affine_fokker_planck32(dev):
    """fokkerPlanck32's flow with the Student-t latent and the global
    affine (P=9397), ragged 1000, both modes, and one launch per call."""
    flow, theta, x = _case(dev, "affine", 32, 4, (16,), 1000,
                           out_scale=0.03, push=True, latent_name="Student_t",
                           global_affine=True)
    assert flow.layout.size == 9397
    eq = make_equation("advection_hamiltonian_wDiss", 32, T=10.0,
                       coupled=True)
    before = (persample.per_sample_cuda.launches,
              persample.per_sample_split_cuda.launches)
    _check(flow, theta, x, eq.hessian_trace_dirs(32))
    _check_split(flow, theta, x, eq.hessian_trace_dirs(32))
    assert (persample.per_sample_cuda.launches,
            persample.per_sample_split_cuda.launches) == (before[0] + 1,
                                                          before[1] + 1)


def _fp32_case(dev, n, seed=3):
    """fokkerPlanck32's flow (d=32, P=9264, the jets' register width) at a
    small perturbation, n pushed draws, and its trace directions."""
    flow, theta, x = _case(dev, "affine", 32, 4, (16,), n, out_scale=0.03,
                           push=True, seed=seed)
    eq = make_equation("advection_hamiltonian_wDiss", 32, T=10.0,
                       coupled=True)
    return flow, theta, x, eq.hessian_trace_dirs(32)


@pytest.mark.parametrize("n,tile", [(1, 8), (7, 8), (8, 8), (9, 8),
                                    (4097, 16), (4225, 32)])
def test_kernel_ragged_tiles(dev, n, tile):
    """Batches around the tile the wrapper picks (tile_plan): a single
    sample, T - 1, T and T + 1 at T = 8, and ragged last tiles at T = 16
    (4097 = 256 x 16 + 1) and T = 32 (4225 = 132 x 32 + 1), where N % 4
    and N % 8 are nonzero, so every row stores element by element; both
    modes against the plain version."""
    flow, theta, x, dirs = _fp32_case(dev, n)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    assert persample.tile_plan(flow, len(dirs), n, n_sm)[0] == tile
    _check(flow, theta, x, dirs)
    _check_split(flow, theta, x, dirs)


def _check_plan(flow, k, n, dev, plan):
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    assert persample.tile_plan(flow, k, n, n_sm)[:5] == plan


@pytest.mark.parametrize("dim,depth,hidden,variant,n,plan", [
    (32, 4, (32,), "affine", 1001, (8, 128, 128, 0, True)),
    (24, 3, (20, 20), "scale_shift", 4097, (16, 256, 192, 0, True)),
    (64, 4, (16,), "affine", 1001, (8, 128, 128, 0, True)),
    (64, 4, (32,), "affine", 16385, (8, 128, 128, 0, False))])
def test_kernel_generic_jets(dev, dim, depth, hidden, variant, n, plan):
    """Flows with a layer or a coupling half wider than the register width
    take the generic jet body (MW = 0): a hidden width of 32, two hidden
    layers of 20 (rows padded to 24) and fokkerPlanck32's flow at d=64
    with hidden 16 (halves of 32), theta in shared memory; and
    fokkerPlanck32's flow at d=64 with its hidden width d/2 = 32 (P =
    35936, the ROADMAP's d=64 cell), where theta does not fit beside a
    tile and is read from global memory. Ragged batches, both modes
    against the plain version. The draws themselves are x, as for the
    other perturbed flows here; where plain f32 misses TOL on them (the
    wide layers' sums) the kernel is held to plain f32's own error
    (_close). On the last flow plain f32 loses most digits at the worst
    sample of 16384, so its batch is the preset's size, where the graded
    rule's 0.999 quantile spans 16 samples (at 1001 it is the
    second-worst sample alone)."""
    flow, theta, x = _case(dev, variant, dim, depth, hidden, n,
                           out_scale=0.03, push=False)
    if variant == "affine":
        dirs = make_equation("advection_hamiltonian_wDiss", dim, T=10.0,
                             coupled=True).hessian_trace_dirs(dim)
    else:
        dirs = np.random.default_rng(4).standard_normal((dim // 2, dim))
    assert persample.register_width(flow) == 0
    _check_plan(flow, len(dirs), n, dev, plan)
    _check(flow, theta, x, dirs, graded=True)
    _check_split(flow, theta, x, dirs, graded=True)


def test_kernel_theta_in_global_memory_matches_resident(dev, monkeypatch):
    """The launch with theta in global memory gives the same bits as the
    launch with theta in shared memory, plain and split, on a flow that
    fits both ways (hidden 32: the generic body)."""
    flow, theta, x = _case(dev, "affine", 32, 4, (32,), 1001,
                           out_scale=0.03, push=False)
    theta, x = theta.float(), x.float()
    dirs = make_equation("advection_hamiltonian_wDiss", 32, T=10.0,
                         coupled=True).hessian_trace_dirs(32)
    shift = torch.linspace(-0.5, 0.5, flow.layout.size, device=dev)
    k = len(dirs)
    T, threads, J, MW, resident, _ = persample.tile_plan(flow, k, 1001)
    assert (MW, resident) == (0, True)
    res = (persample.per_sample_cuda(flow, theta, x, dirs),
           persample.per_sample_split_cuda(flow, theta, x, dirs, shift))
    meta, n_sv = persample.block_plan(flow, k)
    smem = 4 * persample.smem_floats(
        int(meta[11]), persample._n_fconst(flow, k), meta.size, n_sv,
        flow.dim, k, T, J, int(meta[14]), resident=False)
    monkeypatch.setattr(persample, "tile_plan", lambda *a: (
        T, threads, J, 0, False, smem))
    glob = (persample.per_sample_cuda(flow, theta, x, dirs),
            persample.per_sample_split_cuda(flow, theta, x, dirs, shift))
    for a, b in zip(res[0] + res[1][:3] + res[1][3] + res[1][4:],
                    glob[0] + glob[1][:3] + glob[1][3] + glob[1][4:]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n", [4096, 4097])
def test_kernel_launches_are_deterministic(dev, n):
    """Two launches on the same inputs give the same bits, plain and split
    (the column sums and max included): every sum runs in a fixed order."""
    flow, theta, x, dirs = _fp32_case(dev, n)
    theta, x = theta.float(), x.float()
    a = persample.per_sample_cuda(flow, theta, x, dirs)
    b = persample.per_sample_cuda(flow, theta, x, dirs)
    for u, v in zip(a, b):
        assert torch.equal(u, v)
    shift = torch.linspace(-0.5, 0.5, flow.layout.size, device=dev)
    a = persample.per_sample_split_cuda(flow, theta, x, dirs, shift)
    b = persample.per_sample_split_cuda(flow, theta, x, dirs, shift)
    for u, v in zip(a[:3] + a[3] + a[4:], b[:3] + b[3] + b[4:]):
        assert torch.equal(u, v)


def test_kernel_saves_dump_matches_forward(dev):
    """The optional saves dump (tools/persample_blocks.py reads it): every
    block's u1, u2 and v1 and its s2 net's output
    against the f64 forward through models/coupling, to the logp bar of
    each one's largest value (f32 rounding through four coupling blocks);
    the outputs of the launch are those of a launch without the dump."""
    from tools.persample_blocks import forward_values
    from vmc_pde_torch.models import mlp

    flow, theta, x, dirs = _fp32_case(dev, 1000)
    meta, n_sv = persample.block_plan(flow, len(dirs))
    saves = torch.full((n_sv, 1000), float("nan"), device=dev)
    got = persample.per_sample_cuda(flow, theta.float(), x.float(), dirs,
                                    saves=saves)
    plain = persample.per_sample_cuda(flow, theta.float(), x.float(), dirs)
    for u, v in zip(got, plain):
        assert torch.equal(u, v)
    assert torch.isfinite(saves).all()
    params = flow.layout.unravel(theta)
    for b, ((u1, u2, v1), spec) in enumerate(zip(
            forward_values(flow, params, x), flow.blocks)):
        r = persample.HDR + b * persample.BLOCK_REC
        last = r + 8 + persample.NETS.index("s2") * persample.NET_REC + 5 * (
            len(spec.hidden))
        s2 = mlp.apply(params["blocks"][b]["s2"], u2, spec.alpha)
        for slot, ref, scale in ((meta[r + 4], u1, 1.0), (meta[r + 5], u2, 1.0),
                                 (meta[r + 6], v1, 1.0),
                                 (meta[last + 4], s2, spec.alpha)):
            dump = saves[slot:slot + ref.shape[1]].T.double() * scale
            err = float((dump - ref).abs().max() / ref.abs().max())
            assert err < TOL["logp"], (b, slot, err)


@pytest.mark.parametrize("kv", [1, 2])
def test_quant8_kernel_matches_plain(dev, kv):
    """q8 bit-identical to the plain quantization, with a zero row, ties at
    half-integers and values that clip; f close to the bf16 product."""
    gen = torch.Generator(device=dev).manual_seed(kv)
    P, n = 300, 4096
    x = torch.randn((P, n), generator=gen, device=dev)
    x[7] = 0.0
    x[9, :8] = torch.tensor([0.5, 1.5, 2.5, -0.5, -1.5, 126.5, 127.6, -300.0],
                            device=dev)
    x = x.to(torch.bfloat16)
    amax = x.float().abs().amax(1)
    inv = torch.where(amax > 0, 127.0 / amax, torch.zeros_like(amax))
    inv[9] = 1.0  # row 9 quantizes its values as they are
    V = torch.randn((n, kv), generator=gen, device=dev).to(torch.bfloat16)
    before = quant8.quant_force_cuda.launches
    q8, f = quant8.quant_force(x, inv, V)
    q_ref, f_ref = quant8.quant_force_plain(x, inv, V)
    torch.cuda.synchronize()
    assert quant8.quant_force_cuda.launches == before + 1
    assert q8.dtype == torch.int8 and torch.equal(q8, q_ref)
    assert q8[9, :8].tolist() == [0, 2, 2, 0, -2, 126, 127, -127]
    assert (q8[7] == 0).all()
    assert float((f - f_ref).abs().max()) <= 1e-5 * float(f_ref.abs().max())
    with pytest.raises(ValueError, match="multiple of 8"):
        quant8.quant_force(x[:, :12], inv, V[:12])


@pytest.mark.parametrize("kv", [1, 2])
@pytest.mark.parametrize("n", [8, 4104])
@pytest.mark.parametrize("P", [1, 7, 300])
def test_quant8_kernel_ragged_rows(dev, P, n, kv):
    """Row counts around the kernel's rows per block (quant8.ROWS: one
    row, a ragged last block, many blocks), one iteration of 8 samples and
    a ragged one past the block's stride: q8 bit-identical to the plain
    version, f within 1e-5
    of the f64 product of the same bf16 values, and f bit for bit the same
    from two launches (a fixed-order reduction)."""
    gen = torch.Generator(device=dev).manual_seed(P * n + kv)
    x = torch.randn((P, n), generator=gen, device=dev).to(torch.bfloat16)
    amax = x.float().abs().amax(1)
    inv = torch.where(amax > 0, 127.0 / amax, torch.zeros_like(amax))
    V = torch.randn((n, kv), generator=gen, device=dev).to(torch.bfloat16)
    q8, f = quant8.quant_force(x, inv, V)
    q_ref, _ = quant8.quant_force_plain(x, inv, V)
    f64 = x.double() @ V.double()
    _, f2 = quant8.quant_force(x, inv, V)
    torch.cuda.synchronize()
    assert torch.equal(q8, q_ref)
    assert float((f.double() - f64).abs().max()) <= 1e-5 * float(
        f64.abs().max())
    assert torch.equal(f, f2)


def test_bf16_product_accumulates_at_f32_grade(dev):
    """On the card a bf16 product's f32 accumulation truncates on the
    tensor cores: X^T X of 65536 rows in one product comes out ~6e-5 low.
    _mm_bf16's K blocks keep it within 1e-5 of the exact value, the f32
    product's grade."""
    gen = torch.Generator(device=dev).manual_seed(0)
    H = torch.randn((65536, 512), generator=gen, device=dev).to(
        torch.bfloat16)
    ref = H.double().T @ H.double()
    got = stats._mm_bf16(H.T, H)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32
    assert float((got.double() - ref).abs().max()
                 / ref.abs().max()) < 1e-5


@pytest.mark.parametrize("r,c,k", [(33, 9397, 64), (9, 11, 13)])
def test_int8_product_at_sizes_cublaslt_refuses(dev, r, c, k):
    """torch._int_mm on the card wants more than 16 rows and inner and
    column sizes that are multiples of 8; _mm_int8 pads, so the int8 cross
    term runs at P=9397 and gives the exact int32 product."""
    gen = torch.Generator(device=dev).manual_seed(r)
    a = torch.randint(-127, 128, (r, k), dtype=torch.int8, device=dev,
                      generator=gen)
    b = torch.randint(-127, 128, (c, k), dtype=torch.int8, device=dev,
                      generator=gen)
    got = stats._mm_int8(a, b)
    assert got.shape == (r, c)
    assert torch.equal(got.cpu(), (a.cpu().long() @ b.cpu().long().T).int())


def _metropolis_inputs(dev, C, sweeps, base, seed=0):
    """Initial states of the global chains [base, base + C) and external
    uniforms of all base + C chains: every fourth chain starts outside
    the bump's support (lp = -inf) and draws its first 8 proposals on the
    ball's rim (radius uniform 1: lp = -inf as well), which must be
    rejected (-inf - -inf is NaN)."""
    G = base + C
    gen = torch.Generator(device=dev).manual_seed(seed)
    init = torch.full((G, 2), 0.25, device=dev)
    outside = torch.arange(G, device=dev) % 4 == 3
    init[outside, 0] = 0.75
    u = torch.rand((6, sweeps, G), generator=gen, device=dev) * 0.999 + 1e-4
    u[4, :8, outside] = 1.0
    return init, u.reshape(6, sweeps * G), outside


@pytest.mark.parametrize("C,n_steps,base", [(128, 24, 0), (256, 24, 0),
                                            (8192, 128, 0), (8192, 136, 0),
                                            (2048, 128, 2048)])
def test_metropolis_kernel_matches_plain(dev, C, n_steps, base):
    """The Metropolis kernel against its plain version on the card, on
    the same external uniforms and on the Philox stream (the plain version
    draws it on the host): the same samples and accept count, bit for bit
    up to 2e-6. The shapes: small ones, the VarState.sample launch (8192
    chains x 128 sweeps), a last chunk of 8 sweeps (136), and one rank's
    2048 chains from chain 2048, also held against the rows of those
    chains in the plain version over all 4096. States outside the
    bump's support reject proposals outside it (_metropolis_inputs)."""
    from vmc_pde_torch.kernels import metropolis

    off, G = (0.25, 0.25), base + C
    init_all, u_all, outside = _metropolis_inputs(dev, C, n_steps, base)
    init = init_all[base:].contiguous()
    u = u_all.reshape(6, n_steps, G)[:, :, base:].reshape(6, -1)
    before = metropolis.metropolis_chain_cuda.launches
    for ext in (True, False):
        uniforms = u if ext else None
        got = metropolis.metropolis_chain(11, init, n_steps, 0.25, off,
                                          uniforms, chain_base=base)
        ref = metropolis.metropolis_chain_plain(11, init, n_steps, 0.25, off,
                                                uniforms, chain_base=base)
        torch.cuda.synchronize()
        assert int(got[2]) == int(ref[2]) and 0 < int(got[2]) < n_steps * C
        for a, r in zip(got[:2], ref[:2]):
            assert float((a - r).abs().max()) <= 2e-6
        if base:
            full = metropolis.metropolis_chain_plain(
                11, init_all, n_steps, 0.25, off,
                u_all if ext else None)[0].reshape(n_steps, G, 2)
            rows = got[0].reshape(n_steps, C, 2)
            assert float((rows - full[:, base:]).abs().max()) <= 2e-6
        if ext:
            stuck = got[0].reshape(n_steps, C, 2)[:8, outside[base:]]
            assert torch.equal(stuck, init[outside[base:]].expand_as(stuck))
    assert metropolis.metropolis_chain_cuda.launches == before + 2
    with pytest.raises(ValueError, match="uniforms"):
        metropolis.metropolis_chain(0, init, n_steps, 0.25, off, u[:, :C])


@pytest.mark.parametrize("C,n_steps,plan", [
    (128, 24, (8, 32, 64)), (128, 24, (8, 16, 96)), (128, 24, (32, 8, 544)),
    (2048, 136, (16, 32, 288)), (2048, 136, (32, 16, 544)),
    (2048, 136, (8, 64, 160))])
def test_metropolis_kernel_tile_plans_agree(dev, monkeypatch, C, n_steps,
                                            plan):
    """Another tile plan than the wrapper's (one chunk or several, a short
    last chunk, one proposal warp or sixteen) gives the same bits, with
    external uniforms and with Philox; a plan the kernel does not take is
    refused at launch."""
    from vmc_pde_torch.kernels import metropolis

    init, u, _ = _metropolis_inputs(dev, C, n_steps, 0, seed=1)
    runs = []
    for p in (None, plan):
        if p is not None:
            TC, KS, threads = p
            monkeypatch.setattr(metropolis, "tile_plan", lambda *a: (
                TC, KS, threads, 2 * KS * TC * metropolis.PAIR_BYTES))
        runs.append([metropolis.metropolis_chain_cuda(3, init, n_steps, 0.25,
                                                      (0.25, 0.25), uu)
                     for uu in (u, None)])
    for a, b in zip(*runs):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    monkeypatch.setattr(metropolis, "tile_plan", lambda *a: (8, 12, 288, 0))
    with pytest.raises(RuntimeError, match="metropolis_f32"):
        metropolis.metropolis_chain_cuda(3, init, n_steps, 0.25,
                                         (0.25, 0.25))


@pytest.mark.parametrize("N,P,weight", [(1024, 512, None),
                                        (100, 937, None),
                                        (2048, 300, "signed"),
                                        (512, 200, "offset view")])
def test_syrk_kernel_matches_plain(dev, N, P, weight):
    """The triangle kernel against the plain split products and the f64
    product: padded tiles, a ragged N (a sample-major O, copied once for
    the split pass, which pads it), a signed weight, and a weight that is
    a view one float into its storage (not 16-byte aligned: the split pass
    reads it element by element); the result is symmetric."""
    from vmc_pde_torch.kernels import syrk

    gen = torch.Generator(device=dev).manual_seed(P)
    O = torch.randn((N, P), generator=gen, device=dev)
    w = None
    if weight == "signed":
        w = torch.randn((N,), generator=gen, device=dev)
    elif weight == "offset view":
        w = torch.randn((N + 1,), generator=gen, device=dev)[1:]
        assert w.is_contiguous() and w.data_ptr() % 16
    weighted = w is not None
    before = syrk.syrk_cuda.launches
    S = syrk.syrk(O, w)
    plain = syrk.syrk_plain(O, w)
    ref = O.double().T @ (O.double() if w is None
                          else O.double() * w.double()[:, None])
    torch.cuda.synchronize()
    assert syrk.syrk_cuda.launches == before + 1
    tol = (3e-5 if weighted else 2e-5) * float(ref.abs().max())
    assert float((S.double() - ref).abs().max()) <= tol
    assert float((S - plain).abs().max()) <= tol
    assert torch.equal(S, S.T) or float((S - S.T).abs().max()) <= tol


def _syrk_ref(O, w=None):
    return O.double().T @ (O.double() if w is None
                           else O.double() * w.double()[:, None])


def _assert_mirrored(S, tile):
    """Every upper tile is exactly the transpose of its lower tile."""
    P = S.shape[0]
    for i in range(0, P, tile):
        for j in range(0, i, tile):
            assert torch.equal(S[j:j + tile, i:i + tile],
                               S[i:i + tile, j:j + tile].T), (i, j)


@pytest.mark.parametrize("N", [100, 4100])
@pytest.mark.parametrize("P", [1, 100, 129, 937])
def test_syrk_kernel_ragged_shapes(dev, N, P):
    """Ragged P (one row, a part tile, one past a tile, many tiles) and N
    (not multiples of the 64-sample stage; O feature-major, as the
    per-sample kernel hands it over, so the split pass pads it): within
    2e-5 of the largest entry of the f64 product and of the plain
    version, and each upper tile exactly the mirror of its lower tile."""
    from vmc_pde_torch.kernels import syrk

    gen = torch.Generator(device=dev).manual_seed(N + P)
    O = torch.randn((P, N), generator=gen, device=dev).T
    S = syrk.syrk(O)
    plain = syrk.syrk_plain(O)
    ref = _syrk_ref(O)
    torch.cuda.synchronize()
    tol = 2e-5 * float(ref.abs().max())
    assert S.shape == (P, P) and S.dtype == torch.float32
    assert float((S.double() - ref).abs().max()) <= tol
    assert float((S - plain).abs().max()) <= tol
    _assert_mirrored(S, syrk.TILE)


def test_syrk_kernel_flushes_long_accumulations(dev):
    """N=65536 unweighted (128 accumulations of 512 samples): within 2e-5
    of the largest entry of the f64 product. One tensor-core accumulation
    over all samples comes out ~6e-5 low (the card truncates as it
    accumulates), so this guards the flush."""
    from vmc_pde_torch.kernels import syrk

    gen = torch.Generator(device=dev).manual_seed(0)
    O = torch.randn((300, 65536), generator=gen, device=dev).T
    S = syrk.syrk(O)
    ref = _syrk_ref(O)
    torch.cuda.synchronize()
    assert float((S.double() - ref).abs().max()) <= 2e-5 * float(
        ref.abs().max())


@pytest.mark.parametrize("weighted", [False, True])
def test_syrk_kernel_launches_are_deterministic(dev, weighted):
    """Two launches on the same operand give the same bits (no atomics;
    each tile's sums in a fixed order)."""
    from vmc_pde_torch.kernels import syrk

    gen = torch.Generator(device=dev).manual_seed(1)
    O = torch.randn((300, 4100), generator=gen, device=dev).T
    w = torch.randn((4100,), generator=gen, device=dev) if weighted else None
    a, b = syrk.syrk(O, w), syrk.syrk(O, w)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.parametrize("layout", ["feature-major", "ragged",
                                    "wide rows", "sample-major",
                                    "offset weight"])
def test_syrk_split_pass_matches_plain(dev, layout):
    """The split pass bit for bit against split_plain (stats._split_bf16
    of O w and O), zero padding included, on the layouts the wrapper
    hands it: feature-major storage with N a multiple of 8, ragged, with
    a row stride wider than N, a copied sample-major O, and a weight view
    that is not 16-byte aligned."""
    from vmc_pde_torch.kernels import syrk

    gen = torch.Generator(device=dev).manual_seed(2)
    P, N = 77, 1000
    if layout == "ragged":
        N = 1003
    base = torch.randn((P, N + 5), generator=gen, device=dev)
    X = base[:, 1:N + 1] if layout == "wide rows" else base[:, :N].clone()
    O = X.T.contiguous() if layout == "sample-major" else X.T
    w = torch.randn((N + 1,), generator=gen, device=dev)
    w = w[1:] if layout == "offset weight" else w[:N]
    for weight in (None, w):
        got = syrk.split_cuda(O, weight)
        ref = syrk.split_plain(O.T, weight)
        torch.cuda.synchronize()
        assert got.shape == ref.shape and torch.equal(got, ref)


@pytest.fixture(scope="module")
def sharded_run(tmp_path_factory):
    """Two ranks on the one card over gloo (tests/torch_mesh_worker.py,
    scenario "cuda"): per_sample_sharded on each rank's 1024 of 2048
    standard normal samples of a perturbed d=4 flow and of the same draws
    pushed through it, and metropolis_chain_sharded on each rank's 512 of
    1024 chains x 16 sweeps, with external uniforms and with Philox."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import torch_mesh_worker as worker

    flow, theta = build_flow(3, 4, depth=2, hidden=(3,), variant="affine",
                             dtype=torch.float64)
    theta = perturb_theta(flow, theta, np.random.default_rng(3),
                          out_scale=0.3)
    # the draws themselves as x, as for the other strongly perturbed small
    # flows here (pushed through such a flow they leave f32's range)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2048, 4))
    x_pushed = flow.push(flow.layout.unravel(theta), torch.as_tensor(x))[0]
    C, sweeps = 1024, 16
    inputs = dict(theta=theta.numpy(), x=x, x_pushed=x_pushed.numpy(),
                  init=np.tile(np.float32([0.25, 0.25]), (C, 1)),
                  uniforms=rng.uniform(1e-7, 1 - 1e-7, (6, sweeps * C))
                  .astype(np.float32), sweeps=np.int64(sweeps))
    spec = {"gauss": worker.spec_of(flow, "advection_hamiltonian_wDiss",
                                    {"T": 3.0})}
    return worker.run_ranks("cuda", 2, str(tmp_path_factory.mktemp("cu")),
                            spec, inputs)


def test_per_sample_sharded_kernel_matches_plain(sharded_run):
    """Each rank's launch of the plain-mode kernel on its shard against
    the plain version in f64 on the same rows, to TOL; one launch each."""
    for out in sharded_run:
        assert int(out["ps/launches"]) == 1
        for name in ("logp", "g", "quad", "O"):
            assert float(out[f"ps/{name}"]) < TOL[name], name


def test_per_sample_sharded_kernel_on_pushed_draws(sharded_run):
    """Each rank's launch on its rows of the draws pushed through the
    strongly perturbed flow (reaching far enough out that f32 itself loses
    digits) held to plain f32's own error sample by sample, as
    chip_smoke.py's phase 15 holds the Student-t kernel (_grade_ok): each
    sample's largest error relative to the largest f64 value, its
    quantiles 0.5, 0.99 and 0.999 within twice plain f32's, the largest
    within ten times plain f32's largest (or TOL)."""
    for out in sharded_run:
        for name in ("logp", "g", "quad", "O"):
            ek = np.asarray(out[f"psp/{name}/kernel"])
            ep = np.asarray(out[f"psp/{name}/plain"])
            qk = np.quantile(ek, (0.5, 0.99, 0.999))
            qp = np.quantile(ep, (0.5, 0.99, 0.999))
            assert (qk <= 2.0 * qp + 2.0**-24).all(), (name, qk, qp)
            assert ek.max() < max(TOL[name], 10.0 * ep.max()), name


@pytest.mark.parametrize("label", ["ext", "philox"])
def test_metropolis_sharded_kernel_matches_plain_and_single(sharded_run,
                                                            label):
    """Each rank's kernel launch against the plain version with its
    chain_base (2e-6, as the single-launch test), and the gathered shards
    against one launch on all chains, bit for bit, with the accept count
    summed over the ranks."""
    for out in sharded_run:
        assert float(out[f"mcmc/{label}/vs_plain"]) <= 2e-6
        assert bool(out[f"mcmc/{label}/vs_single"])
        acc, acc_single = out[f"mcmc/{label}/acc"]
        assert acc == acc_single > 0
        assert int(out["mcmc/launches"]) == 2


def _fp32_tdvp(dev, **over):
    """fokkerPlanck32's TDVP on the card (P=9264, f32, cholesky, so the
    adaptive stepper's S metric is the matrix-free one), its perturbed
    theta and 1000 pushed draws."""
    from vmc_pde_torch import driver
    from vmc_pde_torch.config import preset

    cfg = preset("fokkerPlanck32", device="cuda", n_samples_tdvp=1024,
                 n_samples_obs=1024, stepper="adaptive_heun", **over)
    state, tdvp = driver.build_problem(cfg)[:2]
    theta = perturb_theta(state.flow, state.get_parameters(),
                          np.random.default_rng(3), out_scale=0.03)
    theta_c = theta.float()
    params = state.flow.layout.unravel(theta_c)
    gen = torch.Generator(device=dev).manual_seed(4)
    x = state.flow.push(params, state.flow.latent_sample(
        gen, params, 1000, torch.float32))[0]
    return tdvp, theta, theta_c, x


def test_sexp_matfree_through_the_kernels_o_rows(dev):
    """The matrix-free S metric on the card takes a = O v from the
    per-sample kernel's O rows (the kept O of the direct statistics: no
    launch; re-made per chunk: one plain-mode launch per chunk) and holds
    against the forward-mode plain version in f64: a within 1e-4 of its
    largest value, v^T SExp v within 1e-4 relative."""
    from vmc_pde_torch.ops import score

    tdvp, theta, theta_c, x = _fp32_tdvp(dev)
    assert tdvp._sexp_matfree and tdvp.uses_kernel
    before = persample.per_sample_cuda.launches
    st = tdvp._direct_stats(theta_c, 0.0, x)
    assert persample.per_sample_cuda.launches == before + 1
    v = torch.randn(tdvp.n_params, generator=torch.Generator(
        device=dev).manual_seed(5), device=dev)
    f = score.make_flat_log_prob(tdvp.flow, tdvp.flow.layout.unravel)
    a_ref = score.batched_param_jvp(f, theta, x.double(), v.double())
    logp_ref = persample.per_sample_plain(tdvp.flow, theta, x.double())[0]
    l2 = logp_ref**2
    quad_ref = float((l2 * (a_ref - a_ref.mean())**2).mean())
    chunked = _fp32_tdvp(dev, chunk_size=512)[0]
    for t, O, launches in ((tdvp, st["O"], 0), (chunked, None, 2)):
        before = persample.per_sample_cuda.launches
        a = t._sexp_a(theta_c, x, v, O)
        quad = float(t._sexp_quad(theta_c, x, st["logp"], None, O, v))
        torch.cuda.synchronize()
        assert persample.per_sample_cuda.launches == before + 2 * launches
        scale = float(a_ref.abs().max())
        assert float((a.double() - a_ref).abs().max()) < 1e-4 * scale
        assert abs(quad - quad_ref) < 1e-4 * quad_ref


def test_syrk_kernel_with_the_sexp_weight(dev):
    """The weighted syrk with the dense SExp's weight logp^2 (non-negative,
    large far out) on the fokkerPlanck32 flow's centered O rows from the
    kernel: against its plain version and the f64 product, within the
    weighted syrk bar (3e-5 of the largest entry)."""
    from vmc_pde_torch.kernels import syrk

    tdvp, _, theta_c, x = _fp32_tdvp(dev)
    logp, _, _, O = persample.per_sample_cuda(tdvp.flow, theta_c, x)
    O_c = O - O.mean(0)
    w = logp**2
    S = syrk.syrk(O_c, w)
    plain = syrk.syrk_plain(O_c, w)
    ref = _syrk_ref(O_c, w)
    torch.cuda.synchronize()
    tol = 3e-5 * float(ref.abs().max())
    assert float((S.double() - ref).abs().max()) <= tol
    assert float((S - plain).abs().max()) <= tol


@pytest.mark.parametrize("method", ["cg", "minsr"])
def test_gram_free_rhs_kernel_against_plain_pipeline(dev, method):
    """One cg and one minSR RHS on fokkerPlanck32's flow (P=9264, N=1024,
    f32) with the per-sample kernel engaged, against the same RHS through
    the torch.func pipeline on the card, on the same draws (one launch
    against none). cg at the JAX test's setting (svd_tol 1e-5, 600
    iterations, cg_tol 1e-10), held as that test holds it against the
    Cholesky solve: cosine > 0.999, 2e-2 on the update; minSR: the
    spectrum within 1e-4 of its largest value, cosine > 0.999."""
    from vmc_pde_torch import driver
    from vmc_pde_torch.config import preset

    extra = (dict(svd_tol=1e-5, cg_maxiter=600, cg_tol=1e-10)
             if method == "cg" else {})
    out = {}
    for backend in ("cuda", "torch"):
        cfg = preset("fokkerPlanck32", device="cuda", n_samples_tdvp=1024,
                     n_samples_obs=1024, solver_method=method,
                     per_sample_backend=backend, **extra)
        state, tdvp = driver.build_problem(cfg)[:2]
        theta_c = state.get_parameters().float()
        before = persample.per_sample_cuda.launches
        aux = tdvp._rhs_impl(theta_c, 0.0, 11)
        torch.cuda.synchronize()
        assert persample.per_sample_cuda.launches - before == (
            1 if backend == "cuda" else 0)
        assert not bool(aux["nan"]) and float(aux["solver_res"]) < 1e-3
        out[backend] = aux
    u, ref = out["cuda"]["update"].double(), out["torch"]["update"].double()
    cos = float(u @ ref / (u.norm() * ref.norm()))
    assert cos > 0.999, cos
    if method == "cg":
        assert float((u - ref).norm() / ref.norm()) < 2e-2
    else:
        ev, ev_ref = out["cuda"]["ev"], out["torch"]["ev"]
        assert ev.shape == (1024,)
        assert float((ev - ev_ref).abs().max()) < 1e-4 * float(ev_ref[-1])


def test_default_product_is_one_bf16_pass(dev):
    """gram_precision='default' on the card: one bf16 pass with f32
    accumulation in _mm_bf16's K blocks, bit for bit (matrix, vector-
    matrix and matrix-vector forms), within bf16's rounding (1e-2 of the
    largest entry) of the f32 product and off it (TF32 and the f32 path
    would agree to ~1e-6)."""
    gen = torch.Generator(device=dev).manual_seed(8)
    a = torch.randn((4100, 300), generator=gen, device=dev) + 0.5
    v = torch.randn(4100, generator=gen, device=dev)
    bf = torch.bfloat16
    got = stats.contract(a.T, a, "default")
    assert torch.equal(got, stats._mm_bf16(a.T.to(bf), a.to(bf)))
    assert torch.equal(stats.contract(v, a, "default"),
                       stats._mm_bf16(v[None].to(bf), a.to(bf))[0])
    w = torch.randn(300, generator=gen, device=dev)
    assert torch.equal(stats.contract(a, w, "default"),
                       stats._mm_bf16(a.to(bf), w[:, None].to(bf))[:, 0])
    ref = a.double().T @ a.double()
    gap = float((got.double() - ref).abs().max() / ref.abs().max())
    full = stats.contract(a.T, a, "high")
    gap_f32 = float((full.double() - ref).abs().max() / ref.abs().max())
    assert 1e-5 < gap < 1e-2 and gap_f32 < 1e-6, (gap, gap_f32)


@pytest.mark.parametrize("dim,n", [(33, 65536), (1, 4097)])
def test_qmc_bits_on_the_card_match_the_cpu(dev, dim, n):
    """The scrambled Sobol net (sampling/qmc.py) from the same words on
    the card and on the CPU: bit for bit; the f32 normals on the card
    within 8 f32 ulps of max(|z|, 1) of the CPU's f64 ones."""
    from vmc_pde_torch.sampling import qmc

    lms, shift = qmc.draw_words(torch.Generator().manual_seed(dim), dim)
    cpu = qmc.scrambled_bits_from_words(n, lms, shift)
    got = qmc.scrambled_bits_from_words(n, lms.to(dev), shift.to(dev))
    assert torch.equal(got.cpu(), cpu)
    z = qmc._mirrored_ndtri(got, torch.float32).cpu().double()
    ref = qmc._mirrored_ndtri(cpu, torch.float64)
    assert float(((z - ref).abs() / ref.abs().clamp_min(1.0)).max()) \
        <= 8 * 2.0**-23


@pytest.mark.parametrize("nu", [1.05, 2.5, 50.0])
def test_qmc_chi2_on_the_card_matches_the_cpu(dev, nu):
    """chi2_from_bits (f64 Newton on torch.special.gammainc) on the card
    against the CPU on the same bits, both 30-bit extremes included:
    within 1e-10 relative plus the inversion's conditioning, 16 eps u /
    (x pdf(x)) (tests/test_torch_qmc.py's bound, with 1e-8 above nu = 40
    for torch's gammainc at large shape)."""
    from scipy.stats import chi2 as schi2

    from vmc_pde_torch.sampling import qmc

    bits = torch.cat([
        qmc.scrambled_bits(torch.Generator().manual_seed(4), 1, 65536)[:, 0],
        torch.tensor([0, 1, 2**29, 2**30 - 2, 2**30 - 1],
                     dtype=torch.int32)])
    cpu = qmc.chi2_from_bits(bits, nu, dtype=torch.float64).numpy()
    got = qmc.chi2_from_bits(bits.to(dev), torch.tensor(
        nu, dtype=torch.float64, device=dev), dtype=torch.float64)
    got = got.cpu().numpy()
    u = (bits.numpy().astype(np.float64) + 0.5) * 2.0**-30
    tol = (np.full(u.shape, 1e-8) if nu > 40 else
           1e-10 + 16 * np.finfo(np.float64).eps * u
           / (cpu * schi2.pdf(cpu, nu)))
    assert (np.abs(got - cpu) / cpu <= tol).all()
