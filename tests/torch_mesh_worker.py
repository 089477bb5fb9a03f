"""One rank of the port's multi-rank tests (tests/test_torch_mesh.py, and
the card tests in tests/test_torch_cuda.py). It imports nothing of JAX:
the parent computes the JAX package's references and hands this process
its inputs as files.

    python tests/torch_mesh_worker.py <scenario> <rank> <world> <dir>

The ranks meet through ``file://<dir>/rendezvous`` over gloo, read
``<dir>/spec.json`` and ``<dir>/inputs.npz`` (written by the parent), run
the scenario and write ``<dir>/out<rank>.npz``. One thread per rank.
"""

import json
import os
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from vmc_pde_torch import driver  # noqa: E402
from vmc_pde_torch.kernels import metropolis, persample  # noqa: E402
from vmc_pde_torch.models import coupling  # noqa: E402
from vmc_pde_torch.models.flow import Flow  # noqa: E402
from vmc_pde_torch.models.state import VarState  # noqa: E402
from vmc_pde_torch.ops.evolution import make_equation  # noqa: E402
from vmc_pde_torch.parallel import mesh  # noqa: E402
from vmc_pde_torch.parallel.mesh import ParallelCtx  # noqa: E402
from vmc_pde_torch.sampling.sampler import Sampler  # noqa: E402
from vmc_pde_torch.solver.tdvp import TDVP, TDVPConfig  # noqa: E402
from vmc_pde_torch.utils.dtypes import resolve  # noqa: E402


def spec_of(flow, equation, eq_params=None):
    """What ``flow_from_spec`` and ``tdvp_on`` need of a flow and its
    equation, as JSON."""
    return dict(
        dim=flow.dim, latent_name=flow.latent_name,
        offset=[float(o) for o in flow.offset],
        blocks=[dict(ind_up=[int(i) for i in b.ind_up],
                     ind_down=[int(i) for i in b.ind_down],
                     hidden=[int(h) for h in b.hidden], variant=b.variant,
                     alpha=float(b.alpha)) for b in flow.blocks],
        equation=equation, eq_params=eq_params or {})


def run_ranks(scenario, world, wdir, spec, inputs, timeout=240):
    """Run ``scenario`` in ``world`` rank processes of this file and
    return each rank's outputs; a rank that fails or outlives ``timeout``
    seconds fails the caller (every rank is killed)."""
    os.makedirs(wdir, exist_ok=True)
    with open(os.path.join(wdir, "spec.json"), "w") as f:
        json.dump(spec, f)
    np.savez(os.path.join(wdir, "inputs.npz"), **inputs)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), scenario, str(r),
         str(world), str(wdir)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0 or f"RANK_OK {r}" not in log:
            raise RuntimeError(f"rank {r} of {scenario!r} failed "
                               f"({p.returncode}):\n{log[-4000:]}")
    return [dict(np.load(os.path.join(wdir, f"out{r}.npz")))
            for r in range(world)]


def flow_from_spec(spec):
    """The flow the parent described: its blocks' partitions and
    hyperparameters, its latent and offset."""
    blocks = tuple(coupling.BlockSpec(
        ind_up=tuple(b["ind_up"]), ind_down=tuple(b["ind_down"]),
        hidden=tuple(b["hidden"]), variant=b["variant"], alpha=b["alpha"])
        for b in spec["blocks"])
    return Flow(dim=spec["dim"], blocks=blocks,
                latent_name=spec["latent_name"],
                offset=tuple(spec["offset"]))


def tdvp_on(ctx, spec, theta, precision, n, cfg, **sampler_kw):
    """A TDVP problem of a described flow and equation on ``ctx``; the
    sampler takes the flow's latent and ``sampler_kw``."""
    flow = flow_from_spec(spec)
    prec = resolve(precision)
    sampler = Sampler(flow.dim, name=flow.latent_name, dtype=prec.compute,
                      ctx=ctx, **sampler_kw)
    state = VarState(flow, torch.as_tensor(theta, dtype=prec.compute),
                     sampler=sampler, precision=prec, ctx=ctx)
    eq = make_equation(spec["equation"], flow.dim, **spec["eq_params"])
    return TDVP(state, eq, TDVPConfig(**cfg), n_samples=n, n_samples_obs=n,
                precision=prec)


def moments(st, keys=("S0", "F0", "A")):
    return {k: st[k].double().numpy() for k in keys}


# The shard_map cases: (label, precision, TDVPConfig fields). The chunked
# case takes the split kernel's path (its plain version on the CPU).
STATS_CASES = (
    ("f32", "tpu", dict(gram_precision="high")),
    ("tri2_int8", "tpu", dict(gram_backend="tri2", gram_cross="int8")),
    ("chunked", "tpu", dict(gram_backend="tri2", gram_cross="int8",
                            chunk_size=512, per_sample_backend="cuda")),
    ("f64", "f64", {}),
)


def scenario_stats(ctx, spec, inp):
    """The shard_map statistics on this rank's rows of the parent's x, for
    each of STATS_CASES on a dp-only and a dp x tp mesh of the world; then
    the sharded Metropolis plain version with external uniforms and with
    Philox, gathered."""
    out = {}
    n = inp["x"].shape[0]
    for label, precision, cfg in STATS_CASES:
        for dp, tp in ((ctx.world, 1), (ctx.world // 2, 2)):
            mctx = ParallelCtx(dp=dp, tp=tp, rank=ctx.rank,
                               device=ctx.device)
            tdvp = tdvp_on(mctx, spec["gauss"], inp["theta"], precision, n,
                           dict(cfg, compute_snr=True))
            assert tdvp._stats_shardmap
            theta_c = tdvp.state.theta
            x = mctx.local_rows(torch.as_tensor(
                inp["x64" if precision == "f64" else "x"]))
            stats_fn = (tdvp._chunked_stats if "chunk_size" in cfg
                        else tdvp._direct_stats)
            for k, v in moments(stats_fn(theta_c, 0.25, x)).items():
                out[f"{label}/dp{dp}tp{tp}/{k}"] = v

    sweeps = int(inp["sweeps"])
    init = ctx.local_rows(torch.as_tensor(inp["init"]))
    for label, u in (("ext", torch.as_tensor(inp["uniforms"])),
                     ("philox", None)):
        s, f, acc = metropolis.metropolis_chain_sharded(
            ctx, 5, init, sweeps, 0.25, (0.25, 0.25), uniforms=u)
        out[f"mcmc/{label}/samples"] = metropolis.gather_sweep_major(
            ctx, s, sweeps).numpy()
        out[f"mcmc/{label}/final"] = mesh.all_gather_rows(ctx, f).numpy()
        out[f"mcmc/{label}/acc"] = np.int64(acc)
    return out


def gspmd_cases(spec, inp):
    """(label, spec, theta, x, log_w, precision, TDVPConfig fields) of the
    GSPMD counterpart's cases: eloc_clip and is_gamma in f64, and the sym2
    Gram with the int8 cross term in f32 (its global column scales)."""
    return (("clip", spec["gauss"], inp["theta"], inp["x64"], None, "f64",
             dict(eloc_clip=2.0, compute_snr=True)),
            ("is", spec["student"], inp["theta_t"], inp["x_t"],
             inp["log_w"], "f64", dict(is_gamma=0.6, compute_snr=True)),
            ("int8", spec["gauss"], inp["theta"], inp["x"], None, "tpu",
             dict(stats_partitioning="gspmd", gram_backend="sym2",
                  gram_cross="int8", compute_snr=True)))


def fluid_problems(ctx, spec, inp):
    """fluidpaper's and doubleWell's TDVP problems (Metropolis chains in
    the RHS) at N=1200, on ``ctx``."""
    out = {}
    for label, kw in (("fluid", dict(n_chains=30)),
                      ("dw", dict(n_chains=30, proposal_mode="rw",
                                  rw_scale=0.8))):
        sp = spec[label]
        kw["mcmc_info"] = {"offset": np.asarray(sp["offset"]),
                           "bound": sp["bound"]}
        out[label] = tdvp_on(ctx, sp, inp[f"theta_{label}"], "f64", 1200,
                             {}, **kw)
    return out


def chain_outputs(ctx, tdvps):
    """Two RHS of each chain problem (acceptance, proposals, update, the
    adapted random-walk scale), then a standalone sample() of fluidpaper's
    sampler, gathered chain by chain."""
    out = {}
    for label, tdvp in tdvps.items():
        theta = tdvp.state.get_parameters()
        for key in (3, 4):
            upd, aux = tdvp.rhs(theta, 0.0, key)
        out[f"{label}/accepted"] = np.int64(aux["mcmc_accepted"])
        out[f"{label}/proposed"] = np.int64(aux["mcmc_proposed"])
        out[f"{label}/update"] = upd.numpy()
        out[f"{label}/rw_scale"] = np.float64(tdvp.sampler.rw_scale)
    sampler = tdvps["fluid"].sampler
    gen = torch.Generator().manual_seed(4)
    z, _ = sampler.sample(gen, tdvps["fluid"].flow,
                          tdvps["fluid"].state.params, 600)
    per_chain = z.reshape(-1, sampler.local_chains, 2).transpose(0, 1)
    out["fluid/sample"] = mesh.all_gather_rows(
        ctx, per_chain.contiguous()).transpose(0, 1).reshape(-1, 2).numpy()
    out["fluid/sample_accepted"] = np.int64(sampler.last_info.num_accepted)
    return out


def scenario_gspmd(ctx, spec, inp):
    """The GSPMD counterpart's direct statistics and one RHS for each of
    gspmd_cases; then chain_outputs. On one rank (the parent's reference)
    the same calls run the single-device path."""
    out = {}
    for label, sp, theta, x, log_w, precision, cfg in gspmd_cases(spec,
                                                                  inp):
        n = x.shape[0]
        tdvp = tdvp_on(ctx, sp, theta, precision, n, cfg)
        assert tdvp._gspmd == (ctx.world > 1)
        x = ctx.local_rows(torch.as_tensor(x))
        if log_w is not None:
            log_w = ctx.local_rows(torch.as_tensor(log_w))
        st = tdvp._direct_stats(tdvp.state.theta, 0.25, x, log_w=log_w)
        keys = ("S0", "F0", "A", "eloc_mean", "eloc_var") + (
            () if log_w is None else ("is_ess_share",))
        for k, v in moments(st, keys).items():
            out[f"{label}/{k}"] = v
        upd, aux = tdvp.rhs(tdvp.state.get_parameters(), 0.25, 21)
        out[f"{label}/update"] = upd.numpy()
        out[f"{label}/entropy"] = aux["entropy"].numpy()
    out.update(s_metric_outputs(ctx, spec, inp))
    out.update(chain_outputs(ctx, fluid_problems(ctx, spec, inp)))
    return out


def s_metric_outputs(ctx, spec, inp):
    """The adaptive steppers' S metric in f64: the dense SExp and the
    matrix-free v^T SExp v, on the direct statistics (shard_map on a
    mesh; the kept O rows), the chunked ones (O re-made chunk by chunk)
    and the IS-weighted direct ones (the GSPMD counterpart)."""
    v = torch.as_tensor(inp["v"])
    out = {"sexp/v": v.numpy()}
    cases = (("direct", spec["gauss"], inp["theta"], inp["x64"], None, {}),
             ("chunked", spec["gauss"], inp["theta"], inp["x64"], None,
              dict(chunk_size=512)),
             ("is", spec["student"], inp["theta_t"], inp["x_t"],
              inp["log_w"], dict(is_gamma=0.6)))
    for label, sp, theta, x, log_w, cfg in cases:
        tdvp = tdvp_on(ctx, sp, theta, "f64", x.shape[0],
                       dict(cfg, compute_sexp=True, sexp_mode="matfree"))
        x = ctx.local_rows(torch.as_tensor(x))
        if log_w is not None:
            log_w = ctx.local_rows(torch.as_tensor(log_w))
        theta_c = tdvp.state.theta
        stats_fn = (tdvp._chunked_stats if "chunk_size" in cfg
                    else tdvp._direct_stats)
        st = stats_fn(theta_c, 0.25, x, **({} if log_w is None
                                          else dict(log_w=log_w)))
        vv = v[:tdvp.n_params]
        out[f"sexp/{label}/dense"] = st["SExp"].numpy()
        out[f"sexp/{label}/quad"] = np.float64(tdvp._sexp_quad(
            theta_c, x, st["logp"], log_w, st["O"], vv))
    return out


def scenario_driver(ctx, spec, inp, rank, world, wdir):
    """The driver's CLI entry on the mesh: theta after every step, and
    whether it is bitwise the coordinator's."""
    thetas, same = [], []

    def record(n_step, t, state, info):
        theta = state.get_parameters()
        thetas.append(theta.numpy().copy())
        same.append(bool(torch.equal(
            theta, mesh.broadcast_from_coordinator(theta))))

    driver.main(json.loads(str(inp["argv"])) + [
        "--workdir", os.path.join(wdir, f"r{rank}"), "--distributed",
        "--coordinator", f"file://{wdir}/rendezvous",
        "--num-processes", str(world), "--process-id", str(rank),
        "--mesh-dp", str(world)], callbacks=[record])
    return {"theta": np.stack(thetas), "same": np.asarray(same)}


def scenario_cuda(ctx, spec, inp):
    """The two sharded wrappers' kernels against their plain versions on
    this rank's shard, and the gathered Metropolis shards against the
    single launch, on the card."""
    dev = ctx.device
    sp = spec["gauss"]
    flow = flow_from_spec(sp)
    theta = torch.as_tensor(inp["theta"], dtype=torch.float32, device=dev)
    x = ctx.local_rows(torch.as_tensor(inp["x"], dtype=torch.float32,
                                       device=dev))
    eq = make_equation(sp["equation"], flow.dim, **sp["eq_params"])
    dirs = torch.as_tensor(eq.hessian_trace_dirs(flow.dim),
                           dtype=torch.float32, device=dev)
    got = persample.per_sample_sharded(ctx, flow, theta, x, dirs)
    ref = persample.per_sample_plain(flow, theta.double(), x.double(),
                                     dirs.double())
    out = {"ps/launches": np.int64(persample.per_sample_sharded.launches)}
    for name, a, r in zip(("logp", "g", "quad", "O"), got, ref):
        out[f"ps/{name}"] = float((a.double() - r).abs().max()
                                  / r.abs().max().clamp_min(1.0))
    if "x_pushed" in inp:
        # per-sample errors on the pushed draws, kernel and plain f32,
        # each sample's largest relative to the largest f64 value
        x = ctx.local_rows(torch.as_tensor(inp["x_pushed"],
                                           dtype=torch.float32, device=dev))
        got = persample.per_sample_sharded(ctx, flow, theta, x, dirs)
        p32 = persample.per_sample_plain(flow, theta, x, dirs)
        ref = persample.per_sample_plain(flow, theta.double(), x.double(),
                                         dirs.double())
        for name, a, p, r in zip(("logp", "g", "quad", "O"), got, p32, ref):
            scale = r.abs().max().clamp_min(1.0)
            for label, v in (("kernel", a), ("plain", p)):
                e = (v.double() - r).abs()
                e = e if e.ndim == 1 else e.amax(1)
                out[f"psp/{name}/{label}"] = (e / scale).cpu().numpy()

    sweeps = int(inp["sweeps"])
    init_all = torch.as_tensor(inp["init"], device=dev)
    init = ctx.local_rows(init_all)
    C, C_loc = init_all.shape[0], init.shape[0]
    base = ctx.rank * C_loc
    u = torch.as_tensor(inp["uniforms"], device=dev)
    for label, uu in (("ext", u), ("philox", None)):
        s, f, acc = metropolis.metropolis_chain_sharded(
            ctx, 5, init, sweeps, 0.25, (0.25, 0.25), uniforms=uu)
        u_loc = None if uu is None else uu.reshape(6, sweeps, C)[
            :, :, base:base + C_loc].reshape(6, -1)
        ps, pf, _ = metropolis.metropolis_chain_plain(
            5, init, sweeps, 0.25, (0.25, 0.25), u_loc, chain_base=base)
        single = metropolis.metropolis_chain_cuda(
            5, init_all, sweeps, 0.25, (0.25, 0.25), uu)
        gathered = metropolis.gather_sweep_major(ctx, s, sweeps)
        out[f"mcmc/{label}/vs_plain"] = float(torch.maximum(
            (s - ps).abs().max(), (f - pf).abs().max()))
        out[f"mcmc/{label}/vs_single"] = bool(
            torch.equal(gathered, single[0])
            and torch.equal(mesh.all_gather_rows(ctx, f), single[1]))
        out[f"mcmc/{label}/acc"] = np.int64([int(acc), int(single[2])])
    out["mcmc/launches"] = np.int64(
        metropolis.metropolis_chain_sharded.launches)
    return out


def main():
    scenario, rank, world, wdir = sys.argv[1], int(sys.argv[2]), \
        int(sys.argv[3]), sys.argv[4]
    torch.set_num_threads(1)
    with open(os.path.join(wdir, "spec.json")) as f:
        spec = json.load(f)
    inp = dict(np.load(os.path.join(wdir, "inputs.npz")))
    if scenario == "driver":
        out = scenario_driver(None, spec, inp, rank, world, wdir)
    else:
        device = "cuda" if scenario == "cuda" else "cpu"
        mesh.distributed_init(f"file://{wdir}/rendezvous", world, rank,
                              device=device)
        ctx = ParallelCtx.create(dp=world, device=device)
        out = {"stats": scenario_stats, "gspmd": scenario_gspmd,
               "cuda": scenario_cuda}[scenario](ctx, spec, inp)
    if "jax" in sys.modules or "vmc_pde_tpu" in sys.modules:
        raise RuntimeError("a rank process imported JAX")
    np.savez(os.path.join(wdir, f"out{rank}.npz"), **out)
    print(f"RANK_OK {rank}", flush=True)


if __name__ == "__main__":
    main()
