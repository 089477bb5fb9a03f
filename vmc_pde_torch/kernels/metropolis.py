"""Independence Metropolis chains of the cosine-bump latent, the
counterpart of vmc_pde_tpu/kernels/metropolis.py::metropolis_chain_pallas.

All chains advance together for ``n_steps`` sweeps. Each sweep proposes,
per chain, a point uniform in the ball of radius ``bound`` around
``offset`` (Box-Muller directions, radius u^(1/d) bound), evaluates the
cosine-bump log-density there and accepts with probability
min(1, p(new) / p(old)). Row s * C + c of the returned samples is chain
c's state after sweep s (sweep-major, the JAX kernel's order).

Sweep s of chain c consumes 2d + 2 uniforms: rows 0..d-1 and d..2d-1 feed
Box-Muller, row 2d the radius, row 2d + 1 the accept test. They come
either from the caller (``uniforms`` of shape (2d + 2, n_steps * C),
column s * C + c: the JAX kernel's external-uniform contract, which
replays bit for bit) or from Philox-4x32-10 keyed by the 64-bit ``seed``
with the counter (chain_base + c, s, j, 0) for words 4j..4j+3: the
counterpart of the TPU's hardware PRNG, reproducible and independent of
the launch shape. ``chain_base`` (default 0) is the global index of the
launch's first chain.
Each 32-bit word becomes a uniform as the TPU path makes one: its low 23
bits times 2^-23, plus 1e-12 (so Box-Muller's log stays finite).

``metropolis_chain_cuda`` launches the hand-written kernel in
csrc/metropolis.cu: a block per tile of chains, proposal warps that fill
a chunk of sweeps for every (sweep, chain) pair of the tile while the
scan warp runs the accept tests of the chunk before, in order
(``tile_plan`` picks the tile, the chunk and the threads);
``metropolis_chain_plain`` is the same sequence of f32 operations in
torch (with ``philox_uniforms`` on the host when no uniforms are given);
``metropolis_chain`` takes the plain version only for a tensor on the
CPU, and for a CUDA tensor launches the kernel or raises.

``metropolis_chain_sharded`` replaces the shard_map wrapper
vmc_pde_tpu/kernels/metropolis.py::metropolis_chain_pallas_sharded: on a
mesh (parallel/mesh.py) each rank runs its n_chains / W chains (a
multiple of 128) with the global index of its first chain as the Philox
``chain_base``, external uniforms split by chain column, and the accept
count summed over the ranks; ``gather_sweep_major`` assembles the global
sweep-major block. The sampler's standalone route uses it
(sampling/sampler.py).

Contract kept from the JAX kernel: n_chains a multiple of 128 (else
ValueError), sweep counts rounded up to multiples of SWEEPS_PER_BLOCK,
a uniforms block of another shape a ValueError. The cosine bump is 2-D
(fluidpaper's latent), and so is the kernel: another dim is a ValueError.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from ..parallel import mesh

SWEEPS_PER_BLOCK = 8

# The CUDA kernel's constants (csrc/metropolis.cu, same names there;
# tests/test_torch_mcmc.py checks them): the most threads of a block (the
# scan warp and 16 proposal warps), the shared bytes of one (sweep, chain)
# pair and of a block. Its scan unroll is SWEEPS_PER_BLOCK.
MAX_THREADS = 544
PAIR_BYTES = 16
SMEM_LIMIT = 49152
TILE_CHAINS = (32, 16, 8)  # chains per block, largest first
PROPOSAL_WARPS = 8
H100_SMS = 132

_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_MASK32 = 0xFFFFFFFF


def rounded_sweeps(n_steps: int) -> int:
    K = SWEEPS_PER_BLOCK
    return -(-int(n_steps) // K) * K


def _check(init_states, n_steps: int, uniforms):
    """Validates the arguments of either version; returns the rounded
    sweep count."""
    if init_states.ndim != 2:
        raise ValueError("init_states must be (n_chains, dim)")
    C, d = init_states.shape
    if C % 128 or C == 0:
        raise ValueError("n_chains must be a multiple of 128 (the JAX "
                         "kernel's lane contract)")
    if d != 2:
        raise ValueError(f"the Metropolis kernel's cosine bump is 2-D, got "
                         f"dim={d}")
    n_steps = rounded_sweeps(n_steps)
    if uniforms is not None:
        expected = (2 * d + 2, n_steps * C)
        if tuple(uniforms.shape) != expected:
            raise ValueError(f"uniforms must have shape {expected}, got "
                             f"{tuple(uniforms.shape)}")
    return n_steps


def philox4x32_10(ctr, key):
    """Philox-4x32-10 on numpy uint64 arrays holding 32-bit words:
    ctr = (c0, c1, c2, c3), key = (k0, k1) -> four output words."""
    c0, c1, c2, c3 = (np.asarray(c, dtype=np.uint64) for c in ctr)
    k0, k1 = (np.uint64(k) for k in key)
    m0, m1 = np.uint64(_PHILOX_M[0]), np.uint64(_PHILOX_M[1])
    mask, shift = np.uint64(_MASK32), np.uint64(32)
    for r in range(10):
        if r:
            k0 = (k0 + np.uint64(_PHILOX_W[0])) & mask
            k1 = (k1 + np.uint64(_PHILOX_W[1])) & mask
        p0, p1 = m0 * c0, m1 * c2  # < 2^64: exact in uint64
        c0, c1, c2, c3 = ((p1 >> shift) ^ c1 ^ k0, p1 & mask,
                          (p0 >> shift) ^ c3 ^ k1, p0 & mask)
    return c0, c1, c2, c3


def philox_uniforms(seed: int, n_chains: int, n_steps: int, dim: int,
                    chain_base: int = 0):
    """The uniforms the kernel's Philox variant draws for the chains
    chain_base .. chain_base + n_chains - 1, as a (2 dim + 2, n_steps *
    n_chains) f32 numpy array in the external-uniform layout."""
    rows = 2 * dim + 2
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    key = (seed & _MASK32, seed >> 32)
    s, c = np.meshgrid(np.arange(n_steps, dtype=np.uint64),
                       np.arange(chain_base, chain_base + n_chains,
                                 dtype=np.uint64), indexing="ij")
    out = np.empty((rows, n_steps, n_chains), dtype=np.float32)
    for j in range(-(-rows // 4)):
        words = philox4x32_10((c, s, np.full_like(c, j), np.zeros_like(c)),
                              key)
        for w, word in enumerate(words):
            if 4 * j + w < rows:
                bits = (word & np.uint64(0x7FFFFF)).astype(np.float32)
                out[4 * j + w] = (bits * np.float32(2.0**-23)
                                  + np.float32(1e-12))
    return out.reshape(rows, n_steps * n_chains)


def cos_bump_log_prob(x, offset):
    """The unnormalized cosine-bump log-density log[(1 + cos(pi min(1,
    4 |x - offset|))) / 2] for x of shape (..., d), in the kernel's order
    of f32 operations."""
    diff = x - offset
    s = diff[..., 0] * diff[..., 0]
    for k in range(1, x.shape[-1]):
        s = s + diff[..., k] * diff[..., k]
    r = torch.clamp(4.0 * torch.sqrt(s), max=1.0)
    return torch.log(0.5 * (1.0 + torch.cos(math.pi * r)))


def _ball_proposal(u, bound, offset):
    """(C, d) proposals from one sweep's (2d + 2, C) uniforms."""
    d = offset.shape[0]
    dv = torch.sqrt(-2.0 * torch.log(u[:d])) * torch.cos(
        (2.0 * math.pi) * u[d:2 * d])
    s = dv[0] * dv[0]
    for k in range(1, d):
        s = s + dv[k] * dv[k]
    dv = dv / torch.sqrt(s)
    # a full exponent tensor keeps torch on powf, as the kernel: a scalar
    # 0.5 takes torch's sqrt shortcut, which rounds differently
    r = torch.pow(u[2 * d], torch.full_like(u[2 * d], 1.0 / d)) * bound
    return (r * dv + offset[:, None]).T


def metropolis_chain_plain(seed: int, init_states, n_steps: int,
                           bound: float, offset, uniforms=None,
                           chain_base: int = 0):
    """(samples (n_steps * C, d) f32, final states (C, d), accepted moves
    as a 0-d int64 tensor), the kernel's arithmetic in torch on the
    inputs' device. Without ``uniforms`` the Philox stream of ``seed``
    for the chains from ``chain_base`` on."""
    n_steps = _check(init_states, n_steps, uniforms)
    C, d = init_states.shape
    dev = init_states.device
    if uniforms is None:
        uniforms = torch.from_numpy(philox_uniforms(seed, C, n_steps, d,
                                                    chain_base))
    u = uniforms.to(device=dev, dtype=torch.float32).reshape(2 * d + 2,
                                                             n_steps, C)
    off = torch.as_tensor(np.asarray(offset, dtype=np.float32).reshape(d),
                          device=dev)
    states = init_states.to(torch.float32)
    lp = cos_bump_log_prob(states, off)
    out = torch.empty((n_steps, C, d), dtype=torch.float32, device=dev)
    accepted = torch.zeros((n_steps, C), dtype=torch.bool, device=dev)
    for i in range(n_steps):
        ui = u[:, i]
        prop = _ball_proposal(ui, bound, off)
        lp_new = cos_bump_log_prob(prop, off)
        # lp = -inf on both sides (outside the support) gives NaN: reject
        accept = ui[2 * d + 1] < torch.exp(lp_new - lp)
        states = torch.where(accept[:, None], prop, states)
        lp = torch.where(accept, lp_new, lp)
        accepted[i] = accept
        out[i] = states
    return (out.reshape(n_steps * C, d), states.contiguous(),
            accepted.sum())


@functools.lru_cache(maxsize=256)
def tile_plan(n_chains: int, n_steps: int, n_sm: int = H100_SMS):
    """(chains per block TC, sweeps per chunk KS, threads, shared bytes) of
    a launch on n_chains (a multiple of 128) x n_steps (a multiple of
    SWEEPS_PER_BLOCK) sweeps. TC: the largest of TILE_CHAINS that still
    gives two blocks per SM, else the smallest. Threads: the scan warp and
    PROPOSAL_WARPS proposal warps. KS: enough sweeps that every proposal
    thread has a pair in each chunk (at least 16), at most n_steps; the
    two buffers of KS x TC pairs take the shared memory."""
    TC = next((t for t in TILE_CHAINS if n_chains // t >= 2 * n_sm),
              TILE_CHAINS[-1])
    threads = 32 * (1 + PROPOSAL_WARPS)
    KS = min(max(16, 32 * PROPOSAL_WARPS // TC), n_steps)
    return TC, KS, threads, 2 * KS * TC * PAIR_BYTES


@functools.lru_cache(maxsize=16)
def _device_consts(offset: tuple, dev: torch.device):
    """The offset as an f32 tensor on the device and the device's SM
    count, made once per (offset, device): a launch copies nothing from
    the host (a copy from pageable host memory waits for the stream)."""
    return (torch.tensor(offset, dtype=torch.float32, device=dev),
            torch.cuda.get_device_properties(dev).multi_processor_count)


def metropolis_chain_cuda(seed: int, init_states, n_steps: int,
                          bound: float, offset, uniforms=None,
                          chain_base: int = 0):
    """Same outputs as ``metropolis_chain_plain``, from one launch of the
    CUDA kernel: init_states (C, d) and the optional uniforms f32 on one
    CUDA device."""
    from . import build

    n_steps = _check(init_states, n_steps, uniforms)
    C, d = init_states.shape
    dev = init_states.device
    if dev.type != "cuda":
        raise ValueError("metropolis_chain_cuda needs the chain states on a "
                         "CUDA device")
    if init_states.dtype != torch.float32:
        raise ValueError("metropolis_chain_cuda takes f32 chain states")
    if uniforms is not None and (uniforms.device != dev
                                 or uniforms.dtype != torch.float32):
        raise ValueError("uniforms must be f32 on the chains' device")
    init = init_states.contiguous()
    off, n_sm = _device_consts(
        tuple(np.asarray(offset, dtype=np.float32).reshape(d).tolist()), dev)
    TC, KS, threads, _ = tile_plan(C, n_steps, n_sm)
    u = None if uniforms is None else uniforms.contiguous()
    samples = torch.empty((n_steps * C, d), dtype=torch.float32, device=dev)
    final = torch.empty((C, d), dtype=torch.float32, device=dev)
    n_acc = torch.empty((), dtype=torch.int64, device=dev)  # zeroed there
    lib = build.library("metropolis")
    code = lib.metropolis_f32(
        init.data_ptr(), off.data_ptr(), ctypes.c_float(float(bound)),
        None if u is None else u.data_ptr(),
        ctypes.c_ulonglong(int(seed) & 0xFFFFFFFFFFFFFFFF), int(chain_base),
        C, n_steps, TC, KS, threads,
        samples.data_ptr(), final.data_ptr(), n_acc.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(code, "metropolis_f32")
    metropolis_chain_cuda.launches += 1
    return samples, final, n_acc


metropolis_chain_cuda.launches = 0


def metropolis_chain(seed: int, init_states, n_steps: int, bound: float,
                     offset, uniforms=None, chain_base: int = 0):
    """The plain version for a CPU tensor; the CUDA kernel otherwise (or
    an error: there is no fallback on the card)."""
    if init_states.device.type == "cpu":
        return metropolis_chain_plain(seed, init_states, n_steps, bound,
                                      offset, uniforms, chain_base)
    return metropolis_chain_cuda(seed, init_states, n_steps, bound, offset,
                                 uniforms, chain_base)


def metropolis_chain_sharded(ctx, seed: int, init_states, n_steps: int,
                             bound: float, offset, uniforms=None):
    """Rank ``ctx.rank``'s shard of a chain ensemble of n_chains = W * C
    chains: ``init_states`` are its C chains, the global chains
    [rank C, (rank + 1) C); C must be a multiple of 128 (ValueError).
    ``uniforms``: the GLOBAL (2d + 2, n_steps * n_chains) block, split here
    by chain column; without it the Philox stream of ``seed`` at the
    global chain index. Returns (the rank's sweep-major samples
    (n_steps * C, d), its final states (C, d), the accepted moves of ALL
    ranks as a 0-d int64 tensor): the single launch's rows of these
    chains, bit for bit (``gather_sweep_major`` assembles them). One rank
    passes through to ``metropolis_chain``. ``.launches`` counts this
    rank's kernel launches."""
    if ctx.world == 1:
        return metropolis_chain(seed, init_states, n_steps, bound, offset,
                                uniforms)
    C, d = init_states.shape
    if C % 128 or C == 0:
        raise ValueError(f"n_chains = {C * ctx.world} must be a multiple of "
                         f"128 * world (= {128 * ctx.world}) for the "
                         "sharded kernel")
    base = ctx.rank * C
    if uniforms is not None:
        n_steps = rounded_sweeps(n_steps)
        expected = (2 * d + 2, n_steps * C * ctx.world)
        if tuple(uniforms.shape) != expected:
            raise ValueError(f"uniforms must have shape {expected}, got "
                             f"{tuple(uniforms.shape)}")
        uniforms = uniforms.reshape(2 * d + 2, n_steps, C * ctx.world)[
            :, :, base:base + C].reshape(2 * d + 2, n_steps * C)
    samples, final, n_acc = metropolis_chain(seed, init_states, n_steps,
                                             bound, offset, uniforms, base)
    if init_states.device.type != "cpu":
        metropolis_chain_sharded.launches += 1
    (n_acc,) = mesh.all_reduce_sum(ctx, [n_acc])
    return samples, final, n_acc


metropolis_chain_sharded.launches = 0


def gather_sweep_major(ctx, samples, n_steps: int):
    """The global sweep-major (n_steps * n_chains, d) block from every
    rank's ``metropolis_chain_sharded`` samples (n_steps * C, d), on every
    rank; ``n_steps`` is the rounded sweep count."""
    if ctx.world == 1:
        return samples
    d = samples.shape[1]
    per_chain = samples.reshape(n_steps, -1, d).transpose(0, 1).contiguous()
    full = mesh.all_gather_rows(ctx, per_chain)
    return full.transpose(0, 1).reshape(-1, d)
