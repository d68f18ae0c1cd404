"""Shard groups: the port's counterpart of ``spec_viterbi_tpu/parallel/mesh.py``.

The JAX package shards over a named ``jax.sharding.Mesh`` and lets XLA
place the collectives. The port names the shards of one axis explicitly,
in one of two forms:

- :class:`LocalGroup`: K shards held by one process on one device. It
  stands for the JAX package's virtual CPU mesh and its one-chip window
  harness: the decoders run every shard's kernels on the one device.
- :class:`DistributedGroup`: one shard per rank of the ``torch.distributed``
  world, on an explicit device per rank (NCCL between cards, gloo between
  CPU processes; :func:`~spec_viterbi_tpu_torch.parallel.distributed.
  init_distributed` opens the world).

Both gather results with :meth:`all_gather`, over ``parts``, the list of
per-shard tensors this process holds (K for a local group, one for a
rank): the DP lane results, and a rank's final TP scores. A distributed
group also offers what a rank of the state-sharded decode needs of its
neighbours: :meth:`DistributedGroup.exchange_halo` and
:meth:`DistributedGroup.min_reduce` (the sharded backtrace). In a local
group the halo exchange is the decoder's swap of two global carries, and
its pointers are global, so no reduce is needed.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

DATA_AXIS = "data"
STATE_AXIS = "state"
TIME_AXIS = "time"


class LocalGroup:
    """``size`` shards of ``axis`` held by one process on ``device``."""

    is_local = True

    def __init__(self, size: int, device: torch.device | str, axis: str = STATE_AXIS):
        if size < 1:
            raise ValueError(f"a group needs at least one shard, got {size}")
        self.size = int(size)
        self.device = torch.device(device)
        self.axis = axis

    def shards(self) -> range:
        """The shard indices this process holds: all of them."""
        return range(self.size)

    def all_gather(self, parts: list[torch.Tensor]) -> torch.Tensor:
        """Every shard's part, concatenated along dim 0 in shard order."""
        return torch.cat(parts, dim=0)


class DistributedGroup:
    """One shard of ``axis`` per rank of the ``torch.distributed`` world,
    this rank's on ``device`` (a CUDA device under NCCL, the CPU under
    gloo)."""

    is_local = False

    def __init__(self, device: torch.device | str, axis: str = STATE_AXIS):
        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError("no torch.distributed process group: call init_distributed() first")
        self.size = dist.get_world_size()
        self.rank = dist.get_rank()
        self.device = torch.device(device)
        self.axis = axis
        if self.device.type == "cuda" and self.device.index is not None:
            torch.cuda.set_device(self.device)
        # NCCL wants its first operation to involve every rank before any
        # point-to-point batch (batch_isend_irecv)
        dist.all_reduce(torch.zeros(1, device=self.device))

    def shards(self) -> tuple[int]:
        """The shard index this process holds: its rank."""
        return (self.rank,)

    def all_gather(self, parts: list[torch.Tensor]) -> torch.Tensor:
        """Every rank's part, concatenated along dim 0 in rank order."""
        (x,) = parts
        x = x.contiguous()
        out = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(out, x)
        return torch.cat(out, dim=0)

    def min_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """Elementwise min of ``x`` over the ranks (a new tensor)."""
        x = x.contiguous().clone()
        dist.all_reduce(x, op=dist.ReduceOp.MIN)
        return x

    def exchange_halo(self, win: torch.Tensor, h_lo: int, block: int, h_hi: int) -> None:
        """Refresh the halo rows of this rank's ``win`` [h_lo + block +
        h_hi, B] in place from its neighbours' interiors: rows [0, h_lo)
        take rank r-1's last h_lo interior rows, rows [h_lo + block, ...)
        rank r+1's first h_hi. The counterpart of the JAX package's two
        ``ppermute``s. Halo rows with no neighbour lie outside the state
        space and are set to +inf (the JAX package's ``valid`` mask)."""
        r, k = self.rank, self.size
        interior = win[h_lo : h_lo + block]
        lo_halo, hi_halo = win[:h_lo], win[h_lo + block :]
        ops = []
        if h_lo:
            if r + 1 < k:
                ops.append(dist.P2POp(dist.isend, interior[block - h_lo :], r + 1))
            if r > 0:
                ops.append(dist.P2POp(dist.irecv, lo_halo, r - 1))
        if h_hi:
            if r > 0:
                ops.append(dist.P2POp(dist.isend, interior[:h_hi], r - 1))
            if r + 1 < k:
                ops.append(dist.P2POp(dist.irecv, hi_halo, r + 1))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        if r == 0:
            lo_halo.fill_(float("inf"))
        if r == k - 1:
            hi_halo.fill_(float("inf"))


def make_group(
    device: torch.device | str, shards: int | None = None, axis: str = STATE_AXIS
) -> LocalGroup | DistributedGroup:
    """The port's counterpart of ``make_mesh``: a :class:`LocalGroup` of
    ``shards`` shards on ``device``, or, with ``shards=None``, a
    :class:`DistributedGroup` over the ``torch.distributed`` world."""
    if shards is None:
        return DistributedGroup(device, axis)
    return LocalGroup(shards, device, axis)
