"""Sharded decoding over ``data``, ``state`` and ``time`` shard groups: DP,
TP, DP × TP and SP.

The port of ``spec_viterbi_tpu/parallel/sharded.py``. Every function
takes a shard group (:func:`~spec_viterbi_tpu_torch.parallel.mesh.make_group`) or a grid
(:func:`~spec_viterbi_tpu_torch.parallel.mesh.make_grid`) where the JAX
package takes a mesh, and runs on the group's device, in its local form
(every shard on one device) or over the ranks of ``torch.distributed``:

- **dense DP** (:func:`decode_batch_dp`): the lanes split over ``data``;
  each shard runs the dense decoder's batch step on its lanes, one
  ``svt_minplus`` launch a step with the emission add and the length mask
  in its epilogue, between two carries allocated once;
- **fused DP** (:func:`make_fused_dp`, :func:`decode_batch_dp_fused`,
  :func:`decode_path_batch_dp_fused`) and **streaming DP**
  (:class:`StreamDP`): each data shard runs the fused kernels on its
  lanes, with no collective until the result is gathered;
- **dense TP** (:func:`make_tp_decode`, :func:`decode_tp`): each state
  shard owns a row block ``[Nb, Np]`` of ``a_t``; a step launches one
  J = 1 step on the block, then gathers the ``[Np]`` carry;
- **dense DP × TP** (:func:`make_dp_tp_decode`,
  :func:`decode_batch_dp_tp`): a step launches one batch step on the
  state shard's row block of the transposed operator, the masked lanes
  keeping the carry's rows from ``row0 = r·Nb``, then gathers the data
  shard's ``[Np, Bd]`` carry over ``state``;
- **SP**, time parallelism (:func:`make_time_parallel_decode`,
  :func:`decode_time_parallel`): each ``time`` shard composes the dense
  operator of its block of symbols, one ``svt_minplus`` product a symbol
  (``dispatch.matmul_tn``); the group gathers the ``[S, Np, Np]`` blocks
  and every process folds them into the start vector (``dispatch.step_mv``).

A TP rank holds only its state block of the model (:func:`state_block`).
Every shard writes its block of the next carry, a buffer allocated once a
call, and the group gathers the carry in place; in the local form the
blocks already make it and nothing moves. Every score is bit-equal to the
unsharded decoders': each candidate is one rounded add and the min is
exact, so the split cannot change a bit. The SP's scores are bit-equal to
the JAX function's (the same products in the same order) and within ±1.0
of serial decode: a block operator pre-combines the steps' values.
"""

from __future__ import annotations

import numpy as np
import torch

from spec_viterbi_tpu_torch.hmm import HMM, pad_to_lane, validate_obs_seq
from spec_viterbi_tpu_torch.models.decoder import (
    SUBLANE,
    DeviceHMM,
    _decode_scores_batch,
    _stream_of,
    resolve_device,
)
from spec_viterbi_tpu_torch.ops import dispatch, tropical
from spec_viterbi_tpu_torch.ops.fused import BB, PathStreamState, StreamState, fetch_paths
from spec_viterbi_tpu_torch.parallel.mesh import DATA_AXIS, STATE_AXIS, TIME_AXIS
from spec_viterbi_tpu_torch.utils.batching import pad_batch


def _want_axis(group, axis: str) -> None:
    if group.axis != axis:
        raise ValueError(f"this decode shards the {axis!r} axis, not {group.axis!r}")


def _lanes(x: torch.Tensor, shard: int, per: int) -> torch.Tensor:
    """Shard ``shard``'s ``per`` lanes of ``x`` (lanes on the last dim),
    contiguous."""
    return x[..., shard * per : (shard + 1) * per].contiguous()


def _per_shard(lanes: int, shards: int) -> int:
    if lanes % shards:
        raise ValueError(f"{lanes} lanes do not split over {shards} shards")
    return lanes // shards


def _dense_batch(dev: DeviceHMM, seqs: list[np.ndarray], multiple: int):
    """Validate and pad a dense batch as the JAX package pads it (lanes to
    ``multiple``, symbols 0, lengths 0) → (seqs_t [T, B], lengths [B]) on
    the device."""
    if dev.a is None:
        raise ValueError("dense sharded decode needs a dense DeviceHMM (dense=True)")
    emit = dev.emissions.shape[0]
    batch, lengths = pad_batch([validate_obs_seq(s, emit) for s in seqs], multiple)
    device = dev.emissions.device
    return (torch.as_tensor(batch.T.copy(), device=device),
            torch.as_tensor(lengths, device=device))


def _rows(dev: DeviceHMM, scores: torch.Tensor, count: int) -> list[np.ndarray]:
    v = scores[:count, : dev.states_num].cpu().numpy()
    return [v[i] for i in range(count)]


# --------------------------------------------------------------------------
# dense DP
# --------------------------------------------------------------------------


def decode_batch_dp(dev: DeviceHMM, seqs: list[np.ndarray], group) -> list[np.ndarray]:
    """Data-parallel batched dense decode: the lanes split over ``data``.

    The batch is padded to a multiple of (shards × 8) lanes and to its
    longest sequence; each shard runs the dense decoder's batch step on
    its lanes (one ``svt_minplus`` launch a step), masking finished lanes,
    with no collective until the scores are gathered."""
    if not seqs:
        return []
    _want_axis(group, DATA_AXIS)
    seqs_t, lengths = _dense_batch(dev, seqs, group.size * SUBLANE)
    per = _per_shard(seqs_t.shape[1], group.size)
    parts = [
        _decode_scores_batch(dev.a, dev.pi, dev.emissions, _lanes(seqs_t, s, per),
                             _lanes(lengths, s, per))
        for s in group.shards()
    ]
    return _rows(dev, group.all_gather(parts), len(seqs))


# --------------------------------------------------------------------------
# fused DP and streaming DP
# --------------------------------------------------------------------------


def make_fused_dp(fd, group, masked: bool = True):
    """(scores_fn, path_fn) running ``fd``'s fused kernels over ``data``.

    ``fd`` is a :class:`~spec_viterbi_tpu_torch.ops.fused.FusedStructuredDecoder`
    on this process's device. Both take globally shaped ``seqs_t`` [T, B]
    int32 and ``lengths`` [B] int32 (B a multiple of the group's size);
    each shard runs ``fd``'s scores (or path and backtrace) kernels on its
    lanes, and every process gets the gathered result: scores [n, B], and
    for ``path_fn`` also paths [T, B]. The pair is kept on the decoder
    (keyed by group and ``masked``), as the JAX package keeps its jitted
    pair, so dropping the decoder frees it."""
    _want_axis(group, DATA_AXIS)
    cache = fd.__dict__.setdefault("_dp_fn_cache", {})
    key = (group, masked)
    if key in cache:
        return cache[key]

    def scores_fn(seqs_t, lengths):
        per = _per_shard(seqs_t.shape[1], group.size)
        parts = [fd._scores_core(_lanes(seqs_t, s, per), _lanes(lengths, s, per), masked).T
                 for s in group.shards()]
        return group.all_gather(parts).T

    def path_fn(seqs_t, lengths):
        per = _per_shard(seqs_t.shape[1], group.size)
        scores, paths = [], []
        for s in group.shards():
            sc, p = fd._path_core(_lanes(seqs_t, s, per), _lanes(lengths, s, per), masked)
            scores.append(sc.T)
            paths.append(p.T)
        return group.all_gather(scores).T, group.all_gather(paths).T

    cache[key] = (scores_fn, path_fn)
    return cache[key]


def _fused_dp_stage(fd, seqs: list[np.ndarray], group):
    """Stage a batch for the fused DP path → (seqs_t, lengths). The batch
    is padded with copies of its first sequence to a multiple of the group
    size (a copy keeps a uniform batch uniform), so every shard's result
    has one shape for the all-gather."""
    _want_axis(group, DATA_AXIS)
    per = -(-len(seqs) // group.size)
    padded = list(seqs) + [seqs[0]] * (per * group.size - len(seqs))
    seqs_t, lengths, _ = fd.prepare(padded)
    return seqs_t, lengths


def decode_batch_dp_fused(fd, seqs: list[np.ndarray], group) -> list[np.ndarray]:
    """Fused-kernel batched decode sharded over ``data``; score vectors.

    A uniform-length batch runs unmasked, which takes the FS kernel for
    its class (``fd._fs_ok``), anything else the masked kernel; no
    bucketing."""
    if not seqs:
        return []
    uniform = len({len(s) for s in seqs}) == 1 and len(seqs[0]) >= 2
    scores_fn, _ = make_fused_dp(fd, group, masked=not uniform)
    v = scores_fn(*_fused_dp_stage(fd, seqs, group)).T[: len(seqs), : fd.states_num].cpu().numpy()
    return [v[i] for i in range(len(seqs))]


def decode_path_batch_dp_fused(
    fd, seqs: list[np.ndarray], group
) -> list[tuple[np.ndarray, np.ndarray]]:
    """Fused-kernel batched path decode sharded over ``data``: [(scores,
    exact path)] per sequence with the oracle's tie rule, through the
    masked path kernel and the backtrace kernel on each shard."""
    if not seqs:
        return []
    _, path_fn = make_fused_dp(fd, group)
    scores, paths = path_fn(*_fused_dp_stage(fd, seqs, group))
    scores = scores.T[: len(seqs), : fd.states_num].cpu().numpy()
    paths = fetch_paths(paths.T[: len(seqs)], [len(s) for s in seqs])
    return list(zip(scores, paths))


class StreamDP:
    """DP-sharded streaming decode: the carry lives lane-sharded over
    ``data``, and every feed runs ``fd``'s fused kernels on each shard's
    lanes with no collective; :meth:`scores` and :meth:`path_finalize`
    gather.

    The single-device stream API of ``fd`` (a
    :class:`~spec_viterbi_tpu_torch.ops.fused.FusedStructuredDecoder`):
    ``begin/feed/scores`` for constant-memory scores, and
    ``begin_path/feed_path/path_scores/path_finalize`` for exact paths by
    checkpoint and rematerialize. Lanes are padded with symbol 0 to a
    multiple of (shards × 128), as the JAX package pads them. A state's
    ``carry`` (and each checkpoint and chunk of a path state) is the tuple
    of this process's shards' parts. Bit-equal to the single-device stream:
    the work is per lane, and sharding cannot reorder it."""

    def __init__(self, fd, group):
        _want_axis(group, DATA_AXIS)
        self.fd = fd
        self.group = group
        self._lane_mult = group.size * BB

    # ---- lanes ---------------------------------------------------------

    def _per(self, b_real: int) -> int:
        m = self._lane_mult
        return -(-b_real // m) * m // self.group.size

    def _split(self, x: np.ndarray, b_real: int) -> list[np.ndarray]:
        """This process's shards' lanes of ``x`` (lanes on the last axis,
        padded with 0)."""
        per = self._per(b_real)
        pad = [(0, 0)] * (x.ndim - 1) + [(0, per * self.group.size - b_real)]
        x = np.pad(x, pad)
        return [x[..., s * per : (s + 1) * per] for s in self.group.shards()]

    def _shard_state(self, state, i: int, per: int):
        if isinstance(state, PathStreamState):
            return PathStreamState(state.carry[i], per, tuple(c[i] for c in state.checkpoints),
                                   tuple(c[i] for c in state.chunks))
        return StreamState(state.carry[i], per)

    def _begin(self, first_symbols, begin):
        syms = validate_obs_seq(first_symbols, self.fd.emit_num)
        if len(syms) == 0:
            raise ValueError("cannot stream an empty lane set")
        return tuple(begin(part).carry for part in self._split(syms, len(syms))), len(syms)

    def _feed(self, state, chunk, valid, feed):
        """Feed every shard its lanes of ``chunk`` → the shards' new states,
        or None for an empty chunk."""
        prep = self.fd._prep_stream_chunk(state.b_real, chunk, valid)
        if prep is None:
            return None
        chunk, _, valid = prep
        per = self._per(state.b_real)
        parts = self._split(chunk, state.b_real)
        valids = [None] * len(parts) if valid is None else self._split(valid, state.b_real)
        return [feed(self._shard_state(state, i, per), part, v)
                for i, (part, v) in enumerate(zip(parts, valids))]

    def _gather(self, parts: list[np.ndarray], b_real: int) -> np.ndarray:
        dev = self.group.device
        return self.group.all_gather([torch.as_tensor(p, device=dev) for p in parts])[:b_real].cpu().numpy()

    # ---- scores streaming ----------------------------------------------

    def begin(self, first_symbols) -> StreamState:
        return StreamState(*self._begin(first_symbols, self.fd.stream_begin))

    def feed(self, state: StreamState, chunk, valid=None) -> StreamState:
        shards = self._feed(state, chunk, valid, self.fd.stream_feed)
        if shards is None:
            return state
        return StreamState(tuple(s.carry for s in shards), state.b_real)

    def scores(self, state) -> np.ndarray:
        """Current [B, states_num] scores; the state stays valid."""
        per = self._per(state.b_real)
        return self.group.all_gather(
            [self.fd._extract(c, per) for c in state.carry])[: state.b_real].cpu().numpy()

    # ---- exact-path streaming ------------------------------------------

    def begin_path(self, first_symbols) -> PathStreamState:
        return PathStreamState(*self._begin(first_symbols, self.fd.stream_begin_path), (), ())

    def feed_path(self, state: PathStreamState, chunk, valid=None) -> PathStreamState:
        """Advance by a [T_c, B] block. Each shard keeps its own pointer
        budget: the chunk must fit ``fd.path_supported`` at the shard's
        lanes (the JAX package's per-device rule), or this raises."""
        shards = self._feed(state, chunk, valid, self.fd.stream_feed_path)
        if shards is None:
            return state
        return PathStreamState(
            tuple(s.carry for s in shards),
            state.b_real,
            state.checkpoints + (state.carry,),
            state.chunks + (tuple(s.chunks[-1] for s in shards),),
        )

    path_scores = scores

    def path_finalize(self, state: PathStreamState) -> tuple[np.ndarray, np.ndarray]:
        """→ (scores [B, states_num], paths [B, T_total]); the state is not
        consumed. Each shard rematerializes and walks its own lanes."""
        per = self._per(state.b_real)
        done = [self.fd.stream_path_finalize(self._shard_state(state, i, per))
                for i in range(len(state.carry))]
        return (self._gather([sc for sc, _ in done], state.b_real),
                self._gather([p for _, p in done], state.b_real))


# --------------------------------------------------------------------------
# dense TP and DP × TP
# --------------------------------------------------------------------------


def _blocks(n: int, group) -> int:
    if n % group.size:
        raise ValueError(f"padded states {n} not divisible by state axis {group.size}")
    return n // group.size


def _own_rows(group, nb: int, rows: int) -> slice:
    """The carry rows of the state shards this process holds, checked
    against the ``rows`` of the operator block it was given."""
    shards = group.shards()
    if rows != len(shards) * nb:
        raise ValueError(f"{rows} operator rows for {len(shards)} state shards of {nb}: a rank "
                         f"of a distributed group takes its own block (state_block)")
    return slice(shards[0] * nb, (shards[-1] + 1) * nb)


def _block_views(a_view, em_t, bufs, nb: int, group, own: slice):
    """Views taken once a call, since a view costs the host microseconds a
    step: for each state shard this process holds, (its rows of
    ``a_view`` and ``em_t``, ``row0``, its rows of each carry of the
    ping-pong pair ``bufs``), and this process's rows of each carry."""
    blocks = [(a_view[i * nb : (i + 1) * nb], em_t[i * nb : (i + 1) * nb], r * nb,
               tuple(b[r * nb : (r + 1) * nb] for b in bufs))
              for i, r in enumerate(group.shards())]
    return blocks, tuple(b[own] for b in bufs)


def state_block(hmm: HMM, group, *, device: torch.device | str) -> DeviceHMM:
    """The dense model's states that ``group``'s shards on this process
    own, on ``device``: the whole model for a local group, and for a rank of
    a distributed group only its block ``[r·Nb, (r+1)·Nb)`` of ``Np``
    padded states: ``a_t`` [Nb, Np] (rows of the transposed operator),
    ``a`` [Np, Nb] (columns of the matrix, so ``a.T`` is the block's rows
    of the batched step's view), π [Nb] and the emissions [E, Nb];
    ``padded`` stays ``Np``. A rank so holds ``Nb·Np`` of each operator, as
    the JAX package's ``P(STATE_AXIS, None)`` places ``a_t``. The dense TP
    and DP × TP decoders take this, and the decoders of one device the
    whole model (:meth:`DeviceHMM.from_hmm`)."""
    _want_axis(group, STATE_AXIS)
    if group.is_local:
        return DeviceHMM.from_hmm(hmm, device=device)
    device = resolve_device(device)
    n = pad_to_lane(hmm.states_num)
    nb = _blocks(n, group)
    rows = slice(group.rank * nb, (group.rank + 1) * nb)
    mat = hmm.transition_matrix(pad_to=n)

    def up(x):
        return torch.as_tensor(np.ascontiguousarray(x), device=device)

    return DeviceHMM(a_t=up(mat.T[rows]), a=up(mat[:, rows]),
                     pi=up(hmm.start_vector(pad_to=n)[rows]),
                     emissions=up(hmm.emission_matrix(pad_to=n)[:, rows]),
                     states_num=hmm.states_num, padded=n)


def make_tp_decode(group):
    """A state-sharded (TP) single-sequence dense decoder
    ``fn(a_t, pi, emissions, seq) → [Np]`` scores on every process.

    The tensors are the rows of the state shards this process holds
    (:func:`state_block`): the whole model in the local form, a rank's
    ``[Nb, Np]`` block of ``a_t`` (and its rows of π and the emissions)
    in the distributed one. A step launches one J = 1 step
    (``dense_step_mv``: the emission add in its epilogue) a shard, each
    writing its block of the next carry, then gathers that carry: in the
    local form the blocks already make it."""
    _want_axis(group, STATE_AXIS)

    def tp_decode(a_t, pi, emissions, seq) -> torch.Tensor:
        n = a_t.shape[1]
        nb = _blocks(n, group)
        own = _own_rows(group, nb, a_t.shape[0])
        em_t = emissions.T
        seq = np.asarray(seq, np.int64)
        ctx, stream = _stream_of(pi.device)
        with ctx:
            bufs = [pi.new_empty(n), pi.new_empty(n)]
            blocks, mine = _block_views(a_t, em_t, bufs, nb, group, own)
            torch.add(emissions[int(seq[0])], pi, out=mine[0])
            group.all_gather_into(bufs[0], mine[0])
            for t, o in enumerate(seq[1:].tolist()):
                cur, nxt = bufs[t % 2], (t + 1) % 2
                for a_blk, em_blk, _, outs in blocks:
                    tropical.dense_step_mv(a_blk, cur, em_blk, o, outs[nxt], stream=stream)
                group.all_gather_into(bufs[nxt], mine[nxt])
        return bufs[(len(seq) - 1) % 2]

    return tp_decode


def decode_tp(dev: DeviceHMM, seq: np.ndarray, group) -> np.ndarray:
    """State-sharded dense decode of one sequence; the score vector.
    ``dev`` is :func:`state_block` of the model for ``group``."""
    seq = validate_obs_seq(seq, dev.emissions.shape[0])
    if len(seq) == 0:
        raise ValueError("cannot decode an empty sequence")
    if dev.a_t is None:
        raise ValueError("dense sharded decode needs a dense DeviceHMM (dense=True)")
    _blocks(dev.padded, group)
    v = make_tp_decode(group)(dev.a_t, dev.pi, dev.emissions, seq)
    return v[: dev.states_num].cpu().numpy()


def make_dp_tp_decode(grid):
    """A batched dense decoder sharded over ``data`` × ``state``,
    ``fn(a, pi, em_t, seqs_t, lengths) → [B, Np]`` on every process.

    ``a``, ``pi`` and ``em_t`` are the rows of the state shards this
    process holds (:func:`state_block`: ``a.T`` is ``[Nb, Np]`` on a rank,
    the TN layout the dense decoder reads). Each data shard takes B / D
    lanes and keeps its own contiguous ``[Np, Bd]`` ping-pong pair; a step
    launches one ``dense_step`` with ``row0 = r·Nb`` a state shard, each
    writing its row block of the next carry, then gathers that carry over
    ``state``."""
    data, state = grid.data, grid.state
    _want_axis(data, DATA_AXIS)
    _want_axis(state, STATE_AXIS)

    def dp_tp_decode(a, pi, em_t, seqs_t, lengths) -> torch.Tensor:
        n = a.shape[0]
        nb = _blocks(n, state)
        own = _own_rows(state, nb, a.shape[1])
        per = _per_shard(seqs_t.shape[1], data.size)
        steps = seqs_t.shape[0]
        parts = []
        ctx, stream = _stream_of(pi.device)
        with ctx:
            for d in data.shards():
                obs, ln = _lanes(seqs_t, d, per), _lanes(lengths, d, per)
                bufs = [pi.new_empty((n, per)), pi.new_empty((n, per))]
                blocks, mine = _block_views(a.T, em_t, bufs, nb, state, own)
                torch.add(em_t[:, obs[0].long()], pi[:, None], out=mine[0])
                state.all_gather_into(bufs[0], mine[0])
                for t in range(1, steps):
                    cur, nxt = bufs[(t - 1) % 2], t % 2
                    for a_blk, em_blk, r0, outs in blocks:
                        tropical.dense_step(a_blk, cur, em_blk, obs, ln, t, outs[nxt], row0=r0,
                                            stream=stream)
                    state.all_gather_into(bufs[nxt], mine[nxt])
                parts.append(bufs[(steps - 1) % 2].T)
        return data.all_gather(parts)

    return dp_tp_decode


def decode_batch_dp_tp(dev: DeviceHMM, seqs: list[np.ndarray], grid) -> list[np.ndarray]:
    """Batched dense decode sharded over ``data`` × ``state``. The batch
    is padded to a multiple of (data shards × 8) lanes. ``dev`` is
    :func:`state_block` of the model for ``grid.state``."""
    if not seqs:
        return []
    _blocks(dev.padded, grid.state)
    seqs_t, lengths = _dense_batch(dev, seqs, grid.data.size * SUBLANE)
    v = make_dp_tp_decode(grid)(dev.a, dev.pi, dev.emissions.T, seqs_t, lengths)
    return _rows(dev, v, len(seqs))


# --------------------------------------------------------------------------
# SP: time-parallel decode via associative operator composition
# --------------------------------------------------------------------------


def _identity_op(n: int) -> np.ndarray:
    """Tropical identity: 0 on the diagonal, +inf elsewhere."""
    m = np.full((n, n), np.inf, dtype=np.float32)
    np.fill_diagonal(m, 0.0)
    return m


def make_time_parallel_decode(group):
    """A time-parallel dense decoder ``fn(ops_t, v0, obs) → [Np]`` on
    every process of the ``time`` group.

    ``ops_t`` [E+1, Np, Np] holds the level-1 operators pre-transposed (TN)
    with the identity at index ``E``, so ``obs`` (the ``T−1`` symbols after
    the first on the host, padded with ``E`` to ``S × block``) splits
    evenly. Each shard this process holds composes its block operator
    ``M_block = M_{o_k} ⊗ … ⊗ M_{o_1}`` from the identity, one ``dispatch.matmul_tn``
    (an ``svt_minplus`` product on the TN view) a symbol; the group gathers
    the ``[S, Np, Np]`` blocks (a local group holds them all already), and
    every process folds them into ``v0`` with S ``dispatch.step_mv``
    launches."""
    _want_axis(group, TIME_AXIS)

    def sp_decode(ops_t, v0, obs) -> torch.Tensor:
        n = ops_t.shape[1]
        block = obs.shape[0] // group.size
        blocks = v0.new_empty((group.size, n, n))
        for r in group.shards():
            m = ops_t[ops_t.shape[0] - 1]  # the identity
            for o in obs[r * block : (r + 1) * block].tolist():
                m = dispatch.matmul_tn(ops_t[o], m)  # this step after the block so far
            blocks[r] = m
        group.all_gather_into(blocks.view(-1, n), blocks[group.shards()[0]])
        v = v0
        for m in blocks:
            v = dispatch.step_mv(m, v)
        return v

    return sp_decode


def decode_time_parallel(hmm: HMM, seq: np.ndarray, group) -> np.ndarray:
    """Time-parallel decode of a single sequence over the ``time`` group,
    on the group's device.

    The DENSE block-operator form: O(N³·(T−1)/S) composition against serial
    decode's O(N²·T), the cross-check for the structured schedule of
    :class:`~spec_viterbi_tpu_torch.ops.time_parallel.TimeParallelDecoder`,
    which composes in the banded+low-rank closure and maps time blocks onto
    one device's lanes."""
    seq = validate_obs_seq(seq, hmm.emit_num)
    if len(seq) == 0:
        raise ValueError("cannot decode an empty sequence")
    n = pad_to_lane(hmm.states_num)
    e = hmm.emit_num
    device = group.device
    a_t = torch.as_tensor(hmm.transposed_transition_matrix(pad_to=n), device=device)
    em = torch.as_tensor(hmm.emission_matrix(pad_to=n), device=device)
    pi = torch.as_tensor(hmm.start_vector(pad_to=n), device=device)
    # level-1 operators ops[o][i, j] = em[o, i] + a_t[i, j] + trailing
    # identity for padding, built on the device and stored pre-transposed
    # (TN layout) so composition does no per-step transpose
    ops_t = torch.empty((e + 1, n, n), device=device)
    torch.add(em[:, None, :], a_t.T[None], out=ops_t[:e])
    ops_t[e] = torch.as_tensor(_identity_op(n), device=device)

    rest = seq[1:]
    block = -(-len(rest) // group.size)  # ceil
    obs = np.concatenate([rest, np.full(group.size * block - len(rest), e, dtype=np.int32)])
    v = make_time_parallel_decode(group)(ops_t, em[int(seq[0])] + pi, obs)
    return v[: hmm.states_num].cpu().numpy()
