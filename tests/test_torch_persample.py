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


# -- the CUDA kernel's launch plan (pure Python; the kernel runs on the card)

def _preset_flows():
    """(label, flow, trace directions or None) of every preset whose latent
    the kernel knows or not, fokkerPlanck32's flow with the Student-t
    latent and the global affine, and fokkerPlanck32's flow at d=64 (the
    preset's own hidden width, d/2, and the narrower 16)."""
    from vmc_pde_torch.config import PRESETS, preset
    from vmc_pde_torch.ops.evolution import make_equation

    out = []

    def add(label, cfg, **kw):
        flow, _ = build_flow(cfg.seed, cfg.dim, depth=cfg.depth,
                             hidden=kw.pop("hidden", cfg.hidden_resolved()),
                             variant=cfg.variant,
                             latent_name=kw.pop("latent_name",
                                                cfg.latent_name),
                             offset=cfg.offset, **kw)
        eq = make_equation(cfg.equation, cfg.dim, **cfg.equation_params)
        out.append((label, flow, eq.hessian_trace_dirs(cfg.dim)))

    for name in PRESETS:
        add(name, preset(name))
    add("fokkerPlanck32 Student-t + global affine", preset("fokkerPlanck32"),
        latent_name="Student_t", global_affine=True)
    d64 = preset("fokkerPlanck32", dim=64, offset=(0.0,) * 64)
    add("fokkerPlanck32 at d=64", d64)
    add("fokkerPlanck32 at d=64, hidden 16", d64, hidden=(16,))
    return out


def _parent_supports(flow, n_dirs):
    """The capability check before the tile layout: the same limits, and
    theta with the constants and the plan (154-int block records) within
    SMEM_LIMIT."""
    d, nb = flow.dim, len(flow.blocks)
    n_fconst = d * d + d + n_dirs * d + nb + 3
    n_meta = persample.HDR + nb * 154
    return (flow.latent_name in persample.LATENT_CODES
            and d <= persample.MAX_DIM
            and all(len(s.hidden) + 1 <= persample.MAX_LAYERS
                    and max((*s.hidden, len(s.ind_up), len(s.ind_down)))
                    <= persample.MAX_WIDTH
                    and max(len(s.ind_up), len(s.ind_down))
                    <= persample.MAX_HALF for s in flow.blocks)
            and 4 * (flow.layout.size + n_fconst + n_meta)
            <= persample.SMEM_LIMIT)


@pytest.mark.parametrize("label,flow,dirs", _preset_flows(),
                         ids=lambda v: v if isinstance(v, str) else "")
def test_tile_plan_keeps_the_envelope_and_fits(label, flow, dirs):
    """Every preset flow the kernel took before the tile layout it still
    takes, and at every batch size the chosen tile (T of TILES, jet slots
    within the threads and the pairs, the register width only with theta
    resident) fits the block's shared memory, counted region by region."""
    k = 0 if dirs is None else len(dirs)
    assert persample.supports(flow, dirs, None) >= _parent_supports(flow, k)
    if not persample.supports(flow, dirs, None):
        return
    meta, n_sv = persample.block_plan(flow, k)
    for n in (1, 7, 2048, 4096, 4097, 16384, 65536):
        T, threads, J, MW, resident, smem = persample.tile_plan(flow, k, n)
        assert T in persample.TILES and threads % 32 == 0 and T <= threads
        assert (J == 0) == (k == 0) and J <= min(threads, T * k)
        assert MW in (0, persample.register_width(flow))
        assert resident or MW == 0
        assert smem == 4 * persample.smem_floats(
            int(meta[11]), persample._n_fconst(flow, k), meta.size, n_sv,
            flow.dim, k, T, J, int(meta[14]), resident)
        assert smem <= persample.SMEM_LIMIT


def test_tile_plan_fills_the_card():
    """fokkerPlanck32 (one block of 207 KB per SM): the largest tile whose
    grid covers 132 SMs, every thread with a (sample, direction) pair in
    the jets; the pilot's 2048 rows and a rank's 4096 take smaller tiles."""
    flow, _ = build_flow(0, 32, depth=4, hidden=(16,), variant="affine")
    assert flow.layout.size == 9264
    plan = {n: persample.tile_plan(flow, 16, n)[:5]
            for n in (2048, 4096, 16384, 65536)}
    assert plan[16384] == plan[65536] == (32, 256, 256, 16, True)
    assert plan[4096] == (16, 256, 256, 16, True)
    assert plan[2048] == (8, 128, 128, 16, True)


@pytest.mark.parametrize("kw", [
    dict(dim=32, depth=4, hidden=(16,), variant="affine"),
    dict(dim=6, depth=3, hidden=(3, 4), variant="scale_shift",
         latent_name="Student_t", global_affine=True),
    dict(dim=64, depth=4, hidden=(32,), variant="affine")])
def test_kernel_layout_repacks_theta(kw):
    """The repacked theta the kernel reads: every layer's bias and
    weights (row by row, zero-padded, 16-byte aligned; MW x MW at the
    register width) at the table's offsets, the global affine's and the
    latent's vectors at theirs, and the plan's header pointing at them."""
    flow, theta = build_flow(0, **kw)
    kidx, table, mu, ld = persample.kernel_layout(flow)
    tk = torch.cat([theta, theta.new_zeros(1)])[torch.as_tensor(kidx)]
    params = flow.layout.unravel(theta)
    MW = persample.register_width(flow)
    meta, _ = persample.block_plan(flow, 2)
    ktab = meta[10]
    assert (meta[11], meta[12], meta[13]) == (len(kidx), mu, ld)
    for b, spec in enumerate(flow.blocks):
        assert (meta[ktab + b * persample.KL_REC:
                     ktab + (b + 1) * persample.KL_REC] == table[b]).all()
        for ni, net in enumerate(persample.NETS):
            if net not in spec.nets:
                continue
            n_in, n_out = spec.net_dims(net)
            dims = [n_in, *spec.hidden, n_out]
            for layer in range(len(dims) - 1):
                b_off, w_off, stride = table[b, 3 * (
                    ni * persample.MAX_LAYERS + layer):][:3]
                assert b_off % 4 == w_off % 4 == stride % 4 == 0
                assert stride == (MW or -(-dims[layer + 1] // 4) * 4)
                rows = tk[w_off:w_off + (MW or dims[layer]) * stride]
                rows = rows.reshape(-1, stride)
                W = params["blocks"][b][net]["w"][layer]
                assert torch.equal(rows[:dims[layer], :dims[layer + 1]], W)
                assert rows[:, dims[layer + 1]:].eq(0).all()
                assert rows[dims[layer]:].eq(0).all()
                assert torch.equal(tk[b_off:b_off + dims[layer + 1]],
                                   params["blocks"][b][net]["b"][layer])
        if spec.global_affine:
            g, g_off = table[b, -2:]
            assert tk[g] == params["blocks"][b]["g_scale"]
            assert torch.equal(tk[g_off:g_off + flow.dim],
                               params["blocks"][b]["g_offset"])
    assert torch.equal(tk[mu:mu + flow.dim], params["latent"]["mu"])
    assert torch.equal(tk[ld:ld + flow.dim], params["latent"]["L_diag"])


def test_constants_match_the_kernel_source():
    """The plan's and the launch's constants here equal csrc/persample.cu's
    (parsed from the source): record sizes, limits, threads, shared
    scratch rows, the coupling variants' codes, the tiles and the register
    width the launch accepts."""
    import pathlib
    import re

    src = (pathlib.Path(persample.__file__).parent / "csrc"
           / "persample.cu").read_text()
    env = {}
    for name, expr in re.findall(r"^constexpr int (\w+) = ([^;]+);", src,
                                 re.M):
        env[name] = eval(expr, {}, dict(env))  # noqa: S307
    for name in ("HDR", "MAX_HALF", "MAX_WIDTH", "MAX_LAYERS",
                 "NET_REC", "BLOCK_REC", "GA_REC", "KL_REC", "MAX_THREADS",
                 "N_SCRATCH", "N_PER_SAMPLE"):
        assert env[name] == getattr(persample, name), name
    enum = re.search(r"enum Variant \{([^}]*)\}", src).group(1)
    codes = {k.strip().lower(): int(v) for k, v in
             re.findall(r"(\w+) = (\d+)", enum)}
    assert codes == persample.VARIANT_CODES
    nets = re.search(r"enum Net \{([^}]*)\}", src).group(1)
    assert [k.lower() for k, _ in re.findall(r"(\w+) = (\d+)", nets)] == list(
        persample.NETS)
    tiles = re.search(r"\(T != (\d+) && T != (\d+) && T != (\d+)\)", src)
    assert sorted(map(int, tiles.groups())) == sorted(persample.TILES)
    widths = re.findall(r"case (\d+):\s*\n\s*return launch_mw", src)
    assert sorted(map(int, widths)) == [0, persample.REGISTER_WIDTH]


def test_probe_builds_edit_the_kernel_source():
    """tools/persample_probe.py's two builds of csrc/persample.cu: the
    phases copy has its six clock stamps in order at the kernel's section
    lines, the no-stores copy sends every streaming store through its
    sink, and neither changes anything else of the source."""
    import re

    from tools import persample_probe as probe
    from vmc_pde_torch.kernels import build

    src = (build.CSRC / "persample.cu").read_text()
    ph = probe.variant_source("phases")
    stamps = re.findall(r"^  PROBE_STAMP\((\d)\);\n", ph, re.M)
    assert stamps == [str(k) for k in range(6)]
    assert re.sub(r"^  PROBE_STAMP\(\d\);\n", "", ph, flags=re.M).replace(
        probe.PRELUDE["phases"], "") == src
    ns = probe.variant_source("no_stores")
    assert ns.replace(probe.PRELUDE["no_stores"], "") == src
    assert "#define __stcs probe_sink" in ns and src.count("__stcs(") == 4
