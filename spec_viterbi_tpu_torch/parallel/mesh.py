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

The per-step collectives of the dense and structured TP decodes allocate
nothing: :meth:`all_gather_into` gathers in place into a buffer
allocated once a call, whose rows at this rank's place are its part, and
:meth:`min_reduce_` reduces in place. A local group has them too, with
nothing to do: its shards write their rows of the one global carry, and a
local caller reduces over its shards itself before the call.

:func:`make_grid` is the counterpart of ``make_mesh(data=D, state=S)``:
a ``data`` group and a ``state`` group, as :class:`Grid`. Its distributed
form lays the D × S ranks out row-major (rank ``d·S + s``) and gives each
rank the process group of its row (``state``) and of its column
(``data``).
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

    def all_gather_into(self, out: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """``out``, unchanged: the shards of a local group write their
        parts into it themselves."""
        return out

    def min_reduce_(self, x: torch.Tensor) -> torch.Tensor:
        """``x``, unchanged: a local caller has reduced over its shards."""
        return x


class DistributedGroup:
    """One shard of ``axis`` per rank of a ``torch.distributed`` process
    group (the world by default, or ``group``, one made by
    :func:`make_grid`), this rank's on ``device`` (a CUDA device under NCCL,
    the CPU under gloo). ``rank`` and ``size`` are read within the group."""

    is_local = False

    def __init__(self, device: torch.device | str, axis: str = STATE_AXIS, group=None):
        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError("no torch.distributed process group: call init_distributed() first")
        self.pg = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.device = torch.device(device)
        self.axis = axis
        if self.device.type == "cuda" and self.device.index is not None:
            torch.cuda.set_device(self.device)
        # NCCL wants its first operation to involve every rank before any
        # point-to-point batch (batch_isend_irecv)
        dist.all_reduce(torch.zeros(1, device=self.device), group=group)

    def shards(self) -> tuple[int]:
        """The shard index this process holds: its rank."""
        return (self.rank,)

    def all_gather(self, parts: list[torch.Tensor]) -> torch.Tensor:
        """Every rank's part, concatenated along dim 0 in rank order."""
        (x,) = parts
        x = x.contiguous()
        out = torch.empty((self.size * x.shape[0], *x.shape[1:]), dtype=x.dtype, device=x.device)
        return self.all_gather_into(out, x)

    def all_gather_into(self, out: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` (contiguous), concatenated along dim 0 in rank
        order into ``out`` (contiguous, ``size`` times ``x``'s rows);
        returns ``out``. ``x`` may be this rank's rows of ``out`` itself
        (an in-place gather)."""
        dist.all_gather_into_tensor(out, x, group=self.pg)
        return out

    def min_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """Elementwise min of ``x`` over the ranks (a new tensor)."""
        return self.min_reduce_(x.contiguous().clone())

    def min_reduce_(self, x: torch.Tensor) -> torch.Tensor:
        """Elementwise min of ``x`` (contiguous) over the ranks, in place;
        returns ``x``."""
        dist.all_reduce(x, op=dist.ReduceOp.MIN, group=self.pg)
        return x

    def _peer(self, r: int) -> int:
        """The world rank of this group's rank ``r``."""
        return r if self.pg is None else dist.get_global_rank(self.pg, r)

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
        peer, pg = self._peer, self.pg
        if h_lo:
            if r + 1 < k:
                ops.append(dist.P2POp(dist.isend, interior[block - h_lo :], peer(r + 1), pg))
            if r > 0:
                ops.append(dist.P2POp(dist.irecv, lo_halo, peer(r - 1), pg))
        if h_hi:
            if r > 0:
                ops.append(dist.P2POp(dist.isend, interior[:h_hi], peer(r - 1), pg))
            if r + 1 < k:
                ops.append(dist.P2POp(dist.irecv, hi_halo, peer(r + 1), pg))
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


class Grid:
    """A ``data`` group and a ``state`` group: the port's counterpart of a
    two-axis mesh ``make_mesh(data=D, state=S)``."""

    def __init__(self, data, state):
        if data.axis != DATA_AXIS or state.axis != STATE_AXIS:
            raise ValueError(f"a grid takes a {DATA_AXIS!r} and a {STATE_AXIS!r} group")
        self.data = data
        self.state = state
        self.shape = {DATA_AXIS: data.size, STATE_AXIS: state.size}


def make_grid(device: torch.device | str, data: int = 1, state: int = 1, *,
              distributed: bool = False) -> Grid:
    """A :class:`Grid` of ``data`` × ``state`` shards on ``device``: D·S
    shards held by this process (local), or, with ``distributed``, one a
    rank of a world of exactly D·S ranks. Rank ``d·S + s`` holds data shard
    ``d`` and state shard ``s``; every rank makes every row's and every
    column's process group, in the same order, as ``dist.new_group``
    requires, and keeps its own two."""
    if not distributed:
        return Grid(LocalGroup(data, device, DATA_AXIS), LocalGroup(state, device, STATE_AXIS))
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("no torch.distributed process group: call init_distributed() first")
    world, me = dist.get_world_size(), dist.get_rank()
    if world != data * state:
        raise ValueError(f"a {data} x {state} grid needs {data * state} ranks, the world has {world}")
    rows = [dist.new_group([d * state + s for s in range(state)]) for d in range(data)]
    cols = [dist.new_group([d * state + s for d in range(data)]) for s in range(state)]
    d, s = divmod(me, state)
    return Grid(DistributedGroup(device, DATA_AXIS, cols[s]),
                DistributedGroup(device, STATE_AXIS, rows[d]))
