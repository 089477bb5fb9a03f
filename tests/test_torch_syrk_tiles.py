"""The syrk kernel's tile list (its coverage of the lower triangle and
its grouped order), and the tools that build and profile the port's
kernels (tools/gram_probe.py's edited sources, tools/profile_step.py's
kernel classes), on the CPU. The syrk backend's numbers against the JAX
package are in tests/test_torch_syrk.py; the two files are kept apart so
that each holds fewer tests than tests/test_oracle_and_e2e.py, which
pytest-xdist's loadfile scheduling then starts among the first files.
"""

import itertools

import numpy as np
import pytest
import torch

from vmc_pde_torch.kernels import syrk

torch.set_num_threads(1)


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
