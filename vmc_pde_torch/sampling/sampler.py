"""Latent-space samplers, the counterpart of
vmc_pde_tpu/sampling/sampler.py: exact draws z = mu + U eps + offset from
the Gauss latent (times sqrt(nu / chi^2_nu) for Student-t; models/latent.
py), and Metropolis MCMC for the latents without a
closed-form sampler (the ML-fluids paper's cosine bump ``cos_dist``, the
double-well Boltzmann ``double_well``).

The Metropolis chain is ``metropolis_chain``: all chains advance together,
with independence proposals uniform in a ball covering the target's
support (the reference's) or Gaussian random-walk proposals of scale
``rw_scale``; both have the MH ratio p(new)/p(old). The TDVP right-hand
side runs it with the chain state carried across calls (``make_chain_fn``,
``ensure_chain_state``, ``note_fused_acceptance``). ``Sampler.sample``
draws standalone batches and, for the cosine bump with independence
proposals and n_chains % 128 == 0 on a CUDA device, runs the hand-written
Metropolis kernel (kernels/metropolis.py) instead of the torch chain.

Random numbers come from explicit ``torch.Generator``s. They differ from
JAX's threefry streams for the same seed, so tests that compare the two
packages hand both the same draws, or compare statistics.

On a mesh (``ctx``, parallel/mesh.py) the chain count rounds up to a
multiple of the world and each rank runs its n_chains / W chains; every
random number is drawn for the whole ensemble from the one generator and
the rank keeps its chains' columns (exact draws: its rows), so a W-rank
run replays the one-rank run. Accept counts are summed over the ranks
before anything reads them, the random-walk adaptation included, so every
rank adapts to the same scale. The kernel route needs n_chains % (128 W)
== 0 and runs ``metropolis_chain_sharded``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..kernels import metropolis as mkernel
from ..models import latent as latent_mod
from ..parallel import mesh
from ..parallel.mesh import ParallelCtx
from ..utils.dtypes import device_constant


# The ML-fluid paper's compactly supported cosine bump for x of shape
# (..., d), log[(1 + cos(pi min(1, 4 |x - offset|))) / 2]: the chain's
# target, the same function the Metropolis kernel evaluates
cos_dist_log_prob = mkernel.cos_bump_log_prob


def radial_proposal(gen: torch.Generator, n_chains: int, dim: int, mcmc_info,
                    dtype=torch.float32):
    """Uniform-in-ball independence proposal around mcmc_info["offset"]
    with radius mcmc_info["bound"]: (n_chains, dim)."""
    u = torch.rand((n_chains, 1), generator=gen, dtype=dtype,
                   device=gen.device)
    r = u ** (1.0 / dim) * mcmc_info["bound"]
    d = torch.randn((n_chains, dim), generator=gen, dtype=dtype,
                    device=gen.device)
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    # made once per device (a host copy would wait for the device, and
    # cannot be captured into a CUDA graph)
    off = device_constant(
        tuple(float(o) for o in np.asarray(mcmc_info["offset"]).reshape(-1)),
        gen.device, dtype)
    return r * d + off


@dataclasses.dataclass
class MCSampleInfo:
    """Acceptance bookkeeping. Counts may be device tensors (the TDVP
    path does not wait for them); ``acceptance_rate`` reads them."""

    num_proposed: object
    num_accepted: object

    @property
    def acceptance_rate(self):
        return float(self.num_accepted) / max(float(self.num_proposed), 1.0)


def metropolis_chain(gen: torch.Generator, init_states, log_prob: Callable,
                     proposer: Callable, n_steps: int, mcmc_info,
                     rw_scale=None, chain_major: bool = False,
                     chain_block=None):
    """Run all chains for n_steps Metropolis updates. Returns (samples
    (n_steps * n_chains, dim), final states, accepted moves as a 0-d int64
    tensor).

    ``rw_scale=None``: independence proposals from ``proposer``; else
    Gaussian random-walk proposals x' = x + rw_scale N(0, I) (a float or a
    0-d tensor). Every random number is drawn up front in bulk; with
    independence proposals the target is evaluated on all proposals in
    one batch, so the sweep loop only accepts or rejects. Samples are
    sweep-major (row s * C + c is chain c after sweep s), or grouped by
    chain with ``chain_major``. ``chain_block``: (first, total), the
    chains being [first, first + C) of an ensemble of ``total`` whose
    random numbers are drawn whole, each chain keeping its own column (a
    rank's shard); default (0, C)."""
    C, dim = init_states.shape
    dtype, dev = init_states.dtype, init_states.device
    first, total = chain_block or (0, C)
    cols = slice(first, first + C)
    if rw_scale is None:
        props = proposer(gen, n_steps * total, dim, mcmc_info, dtype=dtype)
        props = props.reshape(n_steps, total, dim)[:, cols]
        lp_props = log_prob(props)
    else:
        noise = torch.randn((n_steps, total, dim), generator=gen,
                            dtype=dtype, device=dev)[:, cols]
    u = torch.rand((n_steps, total), generator=gen, dtype=dtype,
                   device=dev)[:, cols]
    states = init_states
    lp = log_prob(states)
    out, accepted = [], []
    for i in range(n_steps):
        if rw_scale is None:
            prop, lp_new = props[i], lp_props[i]
        else:
            prop = states + rw_scale * noise[i]
            lp_new = log_prob(prop)
        accept = u[i] < torch.exp(lp_new - lp)
        states = torch.where(accept[:, None], prop, states)
        lp = torch.where(accept, lp_new, lp)
        accepted.append(accept)
        out.append(states)
    out = torch.stack(out, dim=1 if chain_major else 0)
    return out.reshape(n_steps * C, dim), states, torch.stack(accepted).sum()


@dataclasses.dataclass
class Sampler:
    """Latent-space sampler. ``name`` selects the path: "Gauss" samples
    exactly from the flow's latent; "cos_dist" and "double_well" run
    Metropolis chains against their target (``latent_log_prob``)."""

    dim: int
    name: str = "Gauss"
    dtype: torch.dtype = torch.float32
    n_chains: int = 30
    mcmc_info: Optional[dict] = None
    latent_log_prob: Optional[Callable] = None
    proposer: Callable = radial_proposal
    burn_in: int = 0
    # "independence" (uniform ball covering the support, the reference's)
    # or "rw" (Gaussian random walk; the scale adapts between calls toward
    # the acceptance rw_target_accept by a Robbins-Monro step on its log)
    proposal_mode: str = "independence"
    # a float; after the first adaptation a 0-d tensor on the chains' device
    rw_scale: object = 0.5
    rw_adapt: bool = True
    rw_target_accept: float = 0.234
    # the rank's place on the mesh (parallel/mesh.py); one device if None
    ctx: Optional[ParallelCtx] = None

    def __post_init__(self):
        latent_mod.check_name(self.name)
        self.exact = self.name in latent_mod.EXACT_NAMES
        if self.ctx is None:
            self.ctx = ParallelCtx.single_device()
        w = self.ctx.world
        if not self.exact and self.n_chains % w:
            # every rank runs the same number of chains (budgets only grow)
            self.n_chains = -(-self.n_chains // w) * w
        if self.mcmc_info is None:
            self.mcmc_info = {"offset": np.zeros(self.dim), "bound": 0.25}
        if self.proposal_mode not in ("independence", "rw"):
            raise ValueError(f"unknown proposal_mode {self.proposal_mode!r}")
        if not self.exact and self.latent_log_prob is None:
            if self.name == "cos_dist":
                self.latent_log_prob = lambda x: cos_dist_log_prob(
                    x, self._offset_like(x))
            else:  # double_well, shifted by the chain offset
                self.latent_log_prob = lambda x: \
                    latent_mod.double_well_log_prob(
                        None, self.dim, x - self._offset_like(x))
        self._states = None
        self._offsets = {}
        self._rw_adapt_t = 0
        self.last_info: Optional[MCSampleInfo] = None

    def _offset_like(self, x):
        """The chain offset as a tensor of x's dtype on x's device, made
        once: the random-walk chain evaluates its target every sweep, and
        a host-to-device copy per sweep held the chain back."""
        key = (x.dtype, x.device)
        if key not in self._offsets:
            self._offsets[key] = torch.as_tensor(
                np.asarray(self.mcmc_info["offset"]), dtype=x.dtype,
                device=x.device)
        return self._offsets[key]

    def shard_over(self, ctx: ParallelCtx) -> None:
        """Shard the draws over ``ctx``, the GSPMD statistics' sample view
        of the sampler's mesh (parallel/mesh.py convention 5: samples and
        chains over dp only, the tp ranks of a dp index running the same
        ones). The chain count already divides by the mesh's world, hence
        by its dp; the chains must not have started on the mesh's own
        shards."""
        if self._states is not None and (ctx.world, ctx.rank) != (
                self.ctx.world, self.ctx.rank):
            raise ValueError("the chains already run on another sharding")
        self.ctx = ctx

    def _kernel_target(self) -> bool:
        return (not self.exact and self.name == "cos_dist"
                and self.n_chains % (128 * self.ctx.world) == 0
                and self.proposal_mode == "independence")

    def uses_kernel(self, device) -> bool:
        """Whether standalone sample() calls on ``device`` run the
        Metropolis kernel: the JAX package's gate with "on a CUDA device"
        in place of "on TPU"."""
        return torch.device(device).type == "cuda" and self._kernel_target()

    @property
    def local_chains(self) -> int:
        """The chains this rank runs."""
        return self.n_chains // self.ctx.world

    def _chain_block(self):
        """(first, total): this rank's chains in the ensemble."""
        return self.ctx.rank * self.local_chains, self.n_chains

    # ------------------------------------------------------------------
    def rounded_budget(self, n: int) -> int:
        """Global sample budget as drawn: a multiple of the dp axis and,
        for MCMC, of n_chains."""
        mult = 1 if self.exact else self.n_chains
        return self.ctx.shard_samples(n, multiple_of=mult)

    def sample(self, gen: torch.Generator, flow, params, n: int):
        """(z, n_total) with n_total = rounded_budget(n) and z this rank's
        latent draws, offset applied: its rows of the global exact draw,
        or its chains' sweeps for MCMC (n_total / W rows either way)."""
        n_total = self.rounded_budget(n)
        if self.exact:
            return self.ctx.local_rows(flow.latent_sample(
                gen, params, n_total, self.dtype)), n_total
        return self._sample_mcmc(gen, n_total), n_total

    # -- the chain carried across TDVP right-hand sides -----------------
    def make_chain_fn(self):
        """(gen, states, rw_scale, n_steps) -> (chain-major samples of this
        rank's chains, their final states, the accepted moves of all
        ranks)."""
        block = self._chain_block()

        def chain_fn(gen, states, rw_scale, n_steps: int):
            z, states, acc = metropolis_chain(
                gen, states, self.latent_log_prob, self.proposer, n_steps,
                self.mcmc_info, rw_scale=rw_scale, chain_major=True,
                chain_block=block)
            (acc,) = mesh.all_reduce_sum(self.ctx, [acc])
            return z, states, acc

        return chain_fn

    def chain_rw_scale(self):
        """The random-walk scale for the chain (None = independence)."""
        return self.rw_scale if self.proposal_mode == "rw" else None

    def ensure_chain_state(self, key: int, device):
        """Initialize this rank's (local_chains, dim) chain state (plus
        burn-in sweeps) on first use, from a generator seeded by ``key``;
        returns it."""
        if self._states is None:
            gen = torch.Generator(device=device)
            gen.manual_seed(key)
            self._states = self._init_states(gen)
            if self.burn_in:
                _, self._states, _ = self.make_chain_fn()(
                    gen, self._states, self.chain_rw_scale(), self.burn_in)
        return self._states

    def chain_state(self):
        """This rank's current chain state (None before the first use)."""
        return self._states

    def set_chain_state(self, states) -> None:
        """Carry on from ``states`` (a batched step's chains)."""
        self._states = states

    def note_fused_acceptance(self, new_states, n_accepted, n_proposed):
        """Absorb a right-hand side's chain: store the carried state and
        the counts of all ranks (device tensors stay on the device) and,
        in rw mode,
        take the Robbins-Monro step on the scale, on the counts' device,
        so nothing waits for the host."""
        self._states = new_states
        self.last_info = MCSampleInfo(num_proposed=n_proposed,
                                      num_accepted=n_accepted)
        if self.proposal_mode == "rw" and self.rw_adapt:
            self._adapt(n_accepted, n_proposed)

    def _adapt(self, n_accepted, n_proposed):
        """log rw_scale += clip(2 t^-0.7 (rate - target), -0.5, 0.5): the
        gain decays with the call count t, so the scale converges; the
        clip keeps one noisy call from blowing it up or down."""
        self._rw_adapt_t += 1
        gain = 2.0 / self._rw_adapt_t**0.7
        acc = torch.as_tensor(n_accepted, dtype=torch.float64)
        rate = acc / max(float(n_proposed), 1.0)
        step = torch.clamp(gain * (rate - self.rw_target_accept), -0.5, 0.5)
        self.rw_scale = torch.as_tensor(self.rw_scale, dtype=torch.float64,
                                        device=acc.device) * torch.exp(step)

    # ------------------------------------------------------------------
    def _init_states(self, gen):
        return self.ctx.local_rows(self.proposer(
            gen, self.n_chains, self.dim, self.mcmc_info, dtype=self.dtype))

    def _sample_mcmc(self, gen, n_total: int):
        if self._states is None:
            self._states = self._init_states(gen)
        n_steps = n_total // self.n_chains + self.burn_in
        if self.uses_kernel(self._states.device):
            return self._sample_mcmc_kernel(gen, n_total, n_steps)
        rw = self.chain_rw_scale()
        samples, self._states, n_acc = metropolis_chain(
            gen, self._states, self.latent_log_prob, self.proposer, n_steps,
            self.mcmc_info, rw_scale=rw, chain_block=self._chain_block())
        (n_acc,) = mesh.all_reduce_sum(self.ctx, [n_acc])
        if self.burn_in:
            samples = samples[self.burn_in * self.local_chains:]
        self.last_info = MCSampleInfo(num_proposed=n_steps * self.n_chains,
                                      num_accepted=int(n_acc))
        if rw is not None and self.rw_adapt:
            self._adapt(n_acc, n_steps * self.n_chains)
        return samples

    def _sample_mcmc_kernel(self, gen, n_total: int, n_steps: int):
        """This rank's chains in one launch of the Metropolis kernel with
        its Philox stream at the global chain index (the plain version for
        CPU tensors; one launch for the whole ensemble on one rank). The
        kernel rounds the sweep count up to whole blocks: the samples are
        trimmed to the budget and the proposals counted on the rounded
        sweeps, so acceptance_rate stays in [0, 1]."""
        seed = int(torch.randint(0, 2**31 - 1, (1,), generator=gen,
                                 device=gen.device))
        samples, final, n_acc = mkernel.metropolis_chain_sharded(
            self.ctx, seed, self._states.float(), n_steps,
            float(self.mcmc_info["bound"]),
            np.asarray(self.mcmc_info["offset"]))
        self._states = final.to(self.dtype)
        if self.burn_in:
            samples = samples[self.burn_in * self.local_chains:]
        samples = samples[:n_total // self.ctx.world]
        self.last_info = MCSampleInfo(
            num_proposed=mkernel.rounded_sweeps(n_steps) * self.n_chains,
            num_accepted=int(n_acc))
        return samples.to(self.dtype)
