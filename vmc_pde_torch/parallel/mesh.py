"""Ranks, shards and collectives, the counterpart of
vmc_pde_tpu/parallel/mesh.py on ``torch.distributed``: one process per
rank, Monte Carlo samples and Metropolis chains sharded over the ranks,
and the statistics' moments summed across them.

Conventions (every sharded module follows them):

1. Ranks and mesh. A ``ParallelCtx`` holds ``dp``, ``tp`` (the JAX
   package's dp_size, tp_size), the rank, the world ``dp * tp`` and the
   rank's device. Rank r is mesh position
   (r // tp, r % tp): the row-major order in which the JAX package's
   ``PartitionSpec(("dp", "tp"))`` flattens its mesh into one sample axis.
   ``ParallelCtx.single_device(device)`` is world 1, needs no process
   group and is the default everywhere. On a mesh the device is
   ``cuda:(rank % torch.cuda.device_count())`` (one host: the rank is its
   local rank), or the CPU when the caller asks for it.
2. Shards. A global batch of N rows is held as rank r's contiguous rows
   [r N/W, (r+1) N/W) (``local_rows``), as ``P("dp")`` places them.
   Sample budgets round up to a multiple of the world with
   ``shard_samples``, Metropolis chain counts too (sampling/sampler.py).
3. Randomness. Every rank draws the global block from the same generator
   and keeps its slice: the exact latents, the Student-t chi^2 variable,
   the importance proposal, the torch chain's uniforms and proposals, the
   observables' batch. A W-rank run then replays the one-rank run up to
   the order of the all-reduce's sums, as JAX's global draw sharded by
   GSPMD does, for a few MB of draws at d=32. The Metropolis kernel's
   Philox counter carries the global chain index (its ``chain_base``), so
   sharded Philox launches replay the single launch bit for bit, and
   external uniforms split by chain column (kernels/metropolis.py). The
   JAX package's hardware-PRNG rule (seed + dp_index * n_blocks) has no
   counterpart: the TPU's bits cannot be reproduced on the card anyway.
4. Collectives. ``all_reduce_sum`` packs its tensors into one contiguous
   flat buffer per dtype and makes one ``all_reduce(SUM)`` of each: the
   statistics' moments cross ranks so, once per evaluation, as the JAX
   package's one psum of (F0, S0, A, SExp) does (two buffers where f64
   moments meet a compute-dtype scalar). The small reductions (global
   means, the pilot shift, maxima) go separately. The backend is NCCL when
   every rank has a card of its own and gloo otherwise (several ranks on
   one card, or the CPU); it is chosen from that topology, printed by the
   coordinator, and never swapped after a failure. gloo takes CUDA tensors
   only in ``broadcast`` and ``all_reduce``, so the gathers here
   (``all_gather_rows``, ``all_gather_row_blocks``) are all-reduces into
   a zeroed global buffer.
5. Axes. Rank r has the dp index r // tp and the tp index r % tp. Its dp
   group is the dp ranks of its tp index (they hold other samples and the
   same rows of the tp-sharded Gram), its tp group the tp ranks of its dp
   index (the same samples, the other rows). The shard_map statistics
   flatten the mesh into W sample shards and reduce over every rank. The
   GSPMD statistics shard the samples over dp only, as the JAX package's
   ``P("dp")`` places them, and split the Gram's result rows over tp
   (``gram_spec``, ``P("tp", None)``): they run on ``samples_over_dp()``,
   a view whose world is dp, whose rank is the dp index and whose
   collectives run over the dp group, and gather the Gram's row blocks
   over the tp group. Groups are made on first use, every group of a
   (dp, tp) mesh at once and in one order (``new_group`` is itself
   collective), and cached on the process group; one rank makes none.

The JAX package's ``PartitionSpec`` roles have no counterpart: nothing
here is placed by annotation, every rank holds its shard explicitly.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Declarative mesh: ``dp`` sample shards (-1: all ranks) times ``tp``
    (on the shard_map statistics, more sample shards)."""

    dp: int = -1
    tp: int = 1

    def resolve(self, world: int):
        """(dp, tp) on a process group of ``world`` ranks."""
        dp = self.dp if self.dp > 0 else max(1, world // self.tp)
        if dp * self.tp != world:
            raise ValueError(f"mesh {dp}x{self.tp} needs {dp * self.tp} "
                             f"ranks, the process group has {world}")
        return dp, self.tp


def _rank_device(device, rank: int) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", rank % torch.cuda.device_count())
    return device


@dataclasses.dataclass(frozen=True)
class ParallelCtx:
    """The rank's place on the mesh and its device."""

    dp: int = 1
    tp: int = 1
    rank: int = 0
    device: torch.device = torch.device("cpu")
    # the collectives' process group: None, every rank (the default
    # group); ("dp" | "tp", mesh dp, mesh tp, index), one group of that
    # mesh axis (a view's; convention 5)
    group: Optional[tuple] = None

    @classmethod
    def create(cls, dp: int = -1, tp: int = 1,
               device="cuda") -> "ParallelCtx":
        """The mesh over the initialized process group (world 1 without
        one); on a mesh a CUDA device becomes the rank's card, which is
        also made the current device."""
        world = dist.get_world_size() if dist.is_initialized() else 1
        dp, tp = MeshConfig(dp, tp).resolve(world)
        if world == 1:
            return cls.single_device(device)
        rank = dist.get_rank()
        device = _rank_device(device, rank)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        return cls(dp=dp, tp=tp, rank=rank, device=device)

    @classmethod
    def single_device(cls, device="cpu") -> "ParallelCtx":
        return cls(device=torch.device(device))

    @property
    def world(self) -> int:
        return self.dp * self.tp

    @property
    def dp_index(self) -> int:
        return self.rank // self.tp

    @property
    def tp_index(self) -> int:
        return self.rank % self.tp

    def samples_over_dp(self) -> "ParallelCtx":
        """The GSPMD statistics' sample view (convention 5): a dp-only mesh
        of the dp ranks of this rank's tp index, whose rank is the dp
        index; the ctx itself when tp == 1."""
        if self.tp == 1:
            return self
        return ParallelCtx(dp=self.dp, rank=self.dp_index,
                           device=self.device,
                           group=("dp", self.dp, self.tp, self.tp_index))

    def over_tp(self) -> "ParallelCtx":
        """The tp ranks of this rank's dp index as a mesh of their own,
        whose rank is the tp index (the Gram's row blocks gather over
        it)."""
        if self.tp == 1:
            return ParallelCtx.single_device(self.device)
        return ParallelCtx(dp=self.tp, rank=self.tp_index,
                           device=self.device,
                           group=("tp", self.dp, self.tp, self.dp_index))

    def row_block(self, n: int):
        """(r0, r1): this rank's rows of an (n, ...) result split over tp
        in blocks of ceil(n / tp) rows, the last one shorter (the JAX
        package's ``gram_spec``); (0, n) at tp == 1."""
        b = -(-n // self.tp)
        r0 = min(self.tp_index * b, n)
        return r0, min(r0 + b, n)

    def shard_samples(self, n: int, multiple_of: int = 1) -> int:
        """A global sample budget rounded UP to a multiple of lcm(world,
        multiple_of): the global count, of which each rank holds its
        ``local_rows``. (The JAX package rounds to dp: its tp replicas
        share a shard under GSPMD; here the shard_map statistics give every
        rank one, so budgets round to the world on either route.)"""
        block = math.lcm(self.world, max(int(multiple_of), 1))
        return -(-int(n) // block) * block

    def local_rows(self, block):
        """Rank r's contiguous rows [r N/W, (r+1) N/W) of a global block
        of N rows (N a multiple of the world, else ValueError)."""
        n = block.shape[0]
        if n % self.world:
            raise ValueError(f"{n} rows do not shard over {self.world} "
                             "ranks")
        m = n // self.world
        return block[self.rank * m:(self.rank + 1) * m]


# (dp, tp) -> (the default group they were made in, dp groups by tp index,
# tp groups by dp index)
_GROUPS = {}


def _process_group(ctx: ParallelCtx):
    """The process group of ctx's collectives (None: the default group).
    The first call on a (dp, tp) mesh makes all of its groups, on every
    rank in the same order, since ``new_group`` is collective."""
    if ctx.group is None:
        return None
    axis, dp, tp, index = ctx.group
    hit = _GROUPS.get((dp, tp))
    if hit is None or hit[0] is not dist.group.WORLD:
        hit = _GROUPS[dp, tp] = (
            dist.group.WORLD,
            [dist.new_group([j + k * tp for k in range(dp)])
             for j in range(tp)],
            [dist.new_group([i * tp + j for j in range(tp)])
             for i in range(dp)])
    return (hit[1] if axis == "dp" else hit[2])[index]


def _global_rank(ctx: ParallelCtx, shard: int) -> int:
    """The process rank of ``shard`` (a rank of ctx's own mesh)."""
    if ctx.group is None:
        return shard
    axis, _, tp, index = ctx.group
    return shard * tp + index if axis == "dp" else index * tp + shard


def distributed_init(coordinator: str, num_processes: int = 1,
                     process_id: int = 0, device="cuda") -> str:
    """Start the process group (the JAX package's ``jax.distributed.
    initialize`` from --coordinator, --num-processes, --process-id). The
    coordinator is host:port, or a torch init URL such as
    ``file:///path/rendezvous`` (what tests use: no port to collide on).
    The backend follows the topology: NCCL when every rank has a card of
    its own, gloo for several ranks on one card or on the CPU. Returns it;
    the coordinator prints it."""
    if dist.is_initialized():
        raise RuntimeError("torch.distributed is already initialized")
    if not coordinator:
        raise ValueError("distributed_init needs a coordinator (host:port "
                         "or an init URL)")
    init_method = (coordinator if "://" in coordinator
                   else f"tcp://{coordinator}")
    on_cuda = torch.device(device).type == "cuda"
    own_card = on_cuda and num_processes <= torch.cuda.device_count()
    backend = "nccl" if own_card else "gloo"
    dist.init_process_group(backend, init_method=init_method,
                            world_size=num_processes, rank=process_id)
    if process_id == 0:
        where = ("a card each" if own_card else
                 f"{torch.cuda.device_count()} card(s)" if on_cuda
                 else "the CPU")
        print(f"torch.distributed: {num_processes} ranks on {where}, "
              f"backend {backend}", flush=True)
    return backend


def is_coordinator() -> bool:
    """Rank 0 (or no process group): the rank that writes and prints."""
    return not dist.is_initialized() or dist.get_rank() == 0


def broadcast_from_coordinator(tensor: torch.Tensor) -> torch.Tensor:
    """The coordinator's value on every rank (a copy; the input is left
    alone). No-op without a process group."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return tensor
    out = tensor.clone()
    dist.broadcast(out, 0)
    return out


def sync_global_devices() -> None:
    """Cross-process barrier (no-op without a process group)."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def all_reduce_sum(ctx: ParallelCtx,
                   tensors: Sequence[Optional[torch.Tensor]]):
    """Each tensor summed over ctx's ranks, in ONE all-reduce of one flat
    buffer per dtype (None entries pass through). The tensors share one
    device. On one rank the tensors come back as they are."""
    if ctx.world == 1:
        return list(tensors)
    live = [i for i, t in enumerate(tensors) if t is not None]
    if len({tensors[i].device for i in live}) > 1:
        raise ValueError("all_reduce_sum packs tensors of one device")
    by_dtype = {}
    for i in live:
        by_dtype.setdefault(tensors[i].dtype, []).append(i)
    out = list(tensors)
    for idx in by_dtype.values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM,
                        group=_process_group(ctx))
        off = 0
        for i in idx:
            t = tensors[i]
            out[i] = flat[off:off + t.numel()].view(t.shape)
            off += t.numel()
    return out


def all_reduce_max(ctx: ParallelCtx, tensor: torch.Tensor) -> torch.Tensor:
    """The elementwise maximum over ctx's ranks (the tensor itself on one
    rank)."""
    if ctx.world == 1:
        return tensor
    out = tensor.clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=_process_group(ctx))
    return out


def broadcast(ctx: ParallelCtx, tensor: torch.Tensor, src: int):
    """``tensor`` of ctx's rank ``src`` on every rank of ctx, in place
    (every rank passes a contiguous tensor of the same shape and dtype:
    the storage crosses as it lies)."""
    if not tensor.is_contiguous():
        raise ValueError("broadcast sends a contiguous tensor")
    if ctx.world > 1:
        dist.broadcast(tensor, _global_rank(ctx, src),
                       group=_process_group(ctx))
    return tensor


def all_gather_rows(ctx: ParallelCtx, local: torch.Tensor) -> torch.Tensor:
    """The global (N, ...) block from every rank's (N/W, ...) rows, in rank
    order: an all-reduce into a zeroed global buffer (gloo gathers no
    CUDA tensors; adding zeros is exact)."""
    if ctx.world == 1:
        return local
    m = local.shape[0]
    full = local.new_zeros((m * ctx.world, *local.shape[1:]))
    full[ctx.rank * m:(ctx.rank + 1) * m] = local
    dist.all_reduce(full, op=dist.ReduceOp.SUM, group=_process_group(ctx))
    return full


def all_gather_row_blocks(ctx: ParallelCtx, blocks, n: int):
    """The whole (n, ...) results from this rank's ``row_block(n)`` rows
    of each (a list of blocks of one dtype; None entries pass through),
    gathered over the tp group in one all-reduce; at tp == 1 the blocks
    themselves."""
    live = [i for i, t in enumerate(blocks) if t is not None]
    if ctx.tp == 1 or not live:
        return list(blocks)
    r0, r1 = ctx.row_block(n)
    first = blocks[live[0]]
    local = first.new_zeros((-(-n // ctx.tp), len(live), *first.shape[1:]))
    local[:r1 - r0] = torch.stack([blocks[i] for i in live], 1)
    full = all_gather_rows(ctx.over_tp(), local)[:n].unbind(1)
    out = list(blocks)
    for i, t in zip(live, full):
        out[i] = t
    return out
