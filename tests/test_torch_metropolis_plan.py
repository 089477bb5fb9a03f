"""The Metropolis kernel's launch plan and bound (kernels/metropolis.py,
kernels/bounds.py), its constants against csrc/metropolis.cu, and
tools/metropolis_probe.py's edited sources, on the CPU. The Metropolis
path's numbers against the JAX package are in tests/test_torch_mcmc.py;
the two files are kept apart so that each holds fewer tests than
tests/test_oracle_and_e2e.py, which pytest-xdist's loadfile scheduling
then starts among the first files.
"""

import pytest
import torch

from vmc_pde_torch.kernels import metropolis

torch.set_num_threads(1)


def test_metropolis_constants_match_the_kernel_source():
    """The wrapper's constants equal csrc/metropolis.cu's (parsed from the
    source): the most threads of a block, the shared bytes of a pair and
    of a block, and the scan's unroll, the sweep rounding."""
    import pathlib
    import re

    src = (pathlib.Path(metropolis.__file__).parent / "csrc"
           / "metropolis.cu").read_text()
    k = {name: int(v) for name, v in
         re.findall(r"^constexpr int (\w+) = (\d+);", src, re.M)}
    for name in ("MAX_THREADS", "PAIR_BYTES", "SMEM_LIMIT"):
        assert k[name] == getattr(metropolis, name), name
    assert k["SCAN_UNROLL"] == metropolis.SWEEPS_PER_BLOCK


def test_metropolis_probe_builds_edit_the_kernel_source():
    """tools/metropolis_probe.py's builds: each copy is csrc/metropolis.cu
    with exactly its edits (undone, they give the source back), and the
    kernel's own Philox and proposal calls are gone where the probe takes
    them out."""
    from tools import gram_probe, metropolis_probe as probe
    from vmc_pde_torch.kernels import build

    src = (build.CSRC / "metropolis.cu").read_text()
    for (name, kind), (prelude, edits) in probe.EDITS.items():
        var = gram_probe.variant_source(name, kind, probe.EDITS)
        var = var.replace(prelude, "", 1)
        for old, new, count in edits:
            assert var.count(new) == count, kind
            var = var.replace(new, old)
        assert var == src, kind
    var = gram_probe.variant_source(probe.NAME, "no_philox", probe.EDITS)
    assert "philox4x32_10(w, k0, k1);" not in var
    var = gram_probe.variant_source(probe.NAME, "scan_only", probe.EDITS)
    assert "= propose<EXT>(" not in var


@pytest.mark.parametrize("sweeps", [8, 24, 128, 136])
@pytest.mark.parametrize("C", [128, 2048, 8192, 65536])
def test_metropolis_tile_plan(C, sweeps):
    """The tile plan of a launch takes what the kernel takes (a tile of
    8, 16 or 32 chains that divides C, a chunk of whole scan unrolls no
    longer than the sweeps, the scan warp and at least one proposal warp,
    both buffers within the shared-memory limit), gives every proposal
    thread a pair in each full chunk, and spreads at least two blocks over
    each of the H100's 132 SMs where C allows (C / 8 >= 264), the most
    blocks it can where it does not."""
    TC, KS, threads, smem = metropolis.tile_plan(C, sweeps)
    assert TC in metropolis.TILE_CHAINS and C % TC == 0
    assert KS % metropolis.SWEEPS_PER_BLOCK == 0 and 0 < KS <= sweeps
    assert threads % 32 == 0 and 64 <= threads <= metropolis.MAX_THREADS
    assert smem == 2 * KS * TC * metropolis.PAIR_BYTES
    assert smem <= metropolis.SMEM_LIMIT
    if KS < sweeps:
        assert KS * TC >= threads - 32
    if C // min(metropolis.TILE_CHAINS) >= 2 * 132:
        assert C // TC >= 2 * 132
    else:
        assert TC == min(metropolis.TILE_CHAINS)


@pytest.mark.parametrize("C,ext,ms,term", [
    (8192, False, 0.005014998, "int_mul"),
    (8192, True, 0.010016248, "bytes"),
    (2048, False, 0.001253750, "int_mul"),
    (2048, True, 0.002504062, "bytes")])
def test_metropolis_bound(C, ext, ms, term):
    """The Metropolis kernel's bound at 128 sweeps: with Philox the 80
    32-bit multiplies per proposal at 64 per clock per SM on 132 SMs at
    1980 MHz; with external uniforms the 32 bytes per proposal at 3.35
    TB/s, and no Philox. Without its integer term (the bound of the
    records before) the Philox launch is bound by its 8 stored bytes per
    proposal: 0.002504 ms at 8192 chains."""
    from vmc_pde_torch.kernels import bounds

    t = bounds.metropolis_terms(C * 128, 2, ext=ext)
    got, by = bounds.metropolis(C * 128, 2, ext=ext)
    assert got == pytest.approx(ms, rel=1e-6)
    assert max(t, key=t.get) == term and t[term] == got
    assert by == ("bytes" if term == "bytes" else "operations")
    assert t["int_mul"] == (0.0 if ext else pytest.approx(
        1e3 * C * 128 * 80 / (64 * 132 * 1.98e9)))
    if C == 8192 and not ext:
        assert max(t["bytes"], t["f32"]) == pytest.approx(0.002504062,
                                                          rel=1e-6)
