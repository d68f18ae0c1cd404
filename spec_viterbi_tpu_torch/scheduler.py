"""Execution-route scheduler: which regime decodes a workload, and why.

The port of ``spec_viterbi_tpu/scheduler.py``. The port has several
regimes: the single-device batched decoder (the fused kernels, the plain
structured loop, dense mode on ``svt_minplus``), the fused data-parallel
decode over a ``data`` group, two state-sharded (TP) schedules (the
chunked-halo window kernels of banded operators, the per-step halo TP of
coupled ones), time-parallel single-sequence decode, and two streaming
engines. :func:`plan_route` picks one from the shape of the workload and
the structure of the operator, and :func:`execute_route` runs it; a caller
that does not want to know the regimes' names calls :func:`decode_auto`.

The decision table is the JAX package's, branch for branch, with its
thresholds unchanged (they are the structure the parity tests hold; the
card's own values wait for benchmark cells):

- **DP is the throughput tool.** A materialized multi-sequence workload on
  a grid with a ``data`` axis routes to data parallelism (no per-step
  collective); on one device, to the batched decoder, which makes the
  fused/structured/dense sub-choice itself.
- **TP is the capacity and latency tool.** It is chosen only when the
  model's device-resident arrays exceed the device's memory (by default
  the device's own), or when the caller optimizes latency on a model of
  ``TP_LATENCY_STATES`` states or more. Banded operators take the chunked
  schedule (:class:`~spec_viterbi_tpu_torch.parallel.fused_tp.FusedTPDecoder`);
  coupled operators need a per-step exchange and take the halo TP
  (:mod:`~spec_viterbi_tpu_torch.parallel.structured_tp`). On an H100
  both sharded schedules are set by the host, the card 77-85% idle in
  the structured TP (PERF.md §5).
- **Time parallelism is opt-in only.** On the H100 the time-parallel
  decoder ran at 0.020-0.10 of the serial one-lane decode at every block
  length (PERF.md §6: the fold is a host loop), so a long single
  sequence routes to the batched decoder; the route stays exact and runs
  on ``Workload.prefer_time_parallel`` or ``cli decode --time-parallel``.
- **Streaming engine by eligibility**: the fused engine for fused-eligible
  operators, the plain engine for the rest, the same protocol either way.

A grid is a :class:`~spec_viterbi_tpu_torch.parallel.mesh.Grid` (a ``data``
and a ``state`` group) or one group, taken as the axis it names; None is
one device.
"""

from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np
import torch

from spec_viterbi_tpu_torch.hmm import HMM
from spec_viterbi_tpu_torch.models.decoder import ViterbiDecoder, resolve_device
from spec_viterbi_tpu_torch.ops.structured import StructuredOperator
from spec_viterbi_tpu_torch.parallel.mesh import DATA_AXIS, STATE_AXIS, Grid
from spec_viterbi_tpu_torch.utils.profiling import span

# The decision thresholds, the JAX package's values.
TP_LATENCY_STATES = 10_000  # below this, a shard's step is not faster
TIME_PARALLEL_MIN_T = 512  # shorter sequences: dispatch dominates
TP_CHUNK_DEFAULT = 16
TIME_PARALLEL_K_DEFAULT = 8

STREAM_KINDS = ("stream_fused", "stream_xla")


@dataclasses.dataclass(frozen=True)
class Workload:
    """Shape of the work to schedule (not the data itself)."""

    n_seqs: int
    max_len: int
    total_symbols: int = 0
    paths: bool = False  # exact Viterbi paths required?
    streaming: bool = False  # unbounded/incremental input?
    optimize: str = "throughput"  # or "latency"
    # the memory a device holds for the model; None: the device's own
    # (resolved by plan_route)
    hbm_bytes: int | None = None
    # explicit opt-in: time parallelism was a no-go on the H100 (PERF.md §6)
    prefer_time_parallel: bool = False

    @classmethod
    def from_seqs(cls, seqs, **kw) -> "Workload":
        lens = [len(s) for s in seqs]
        return cls(
            n_seqs=len(lens),
            max_len=max(lens, default=0),
            total_symbols=sum(lens),
            **kw,
        )


@dataclasses.dataclass(frozen=True)
class Route:
    """A scheduling decision: which regime runs this workload and why."""

    kind: str  # batch | dp | tp_chunked | tp_halo | time_parallel | stream_fused | stream_xla
    reason: str
    params: dict = dataclasses.field(default_factory=dict)


def model_resident_bytes(sop: StructuredOperator, emit_num: int) -> int:
    """Device-resident bytes of the structured model (operator components
    + emissions + start vector, f32). The dense [N, N] operators never
    materialize in structured mode, so this is the capacity that must fit
    a device (or a shard under TP)."""
    n = sop.n
    comps = len(sop.diag_offsets) + len(sop.row_idx) + len(sop.col_idx)
    return 4 * (n * (comps + emit_num + 1) + sop.residual_nnz)


def device_memory_bytes(device: torch.device | str) -> int:
    """The memory of ``device``: a CUDA device's ``total_memory``, or the
    host's physical memory for the CPU."""
    device = resolve_device(device)
    if device.type == "cuda":
        return int(torch.cuda.get_device_properties(device).total_memory)
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")


def _mesh_shape(grid) -> tuple[int, int]:
    """(data shards, state shards) of a grid or a group; (1, 1) for None."""
    if grid is None:
        return 1, 1
    shape = dict(grid.shape) if isinstance(grid, Grid) else {grid.axis: grid.size}
    return shape.get(DATA_AXIS, 1), shape.get(STATE_AXIS, 1)


def _axis_group(grid, axis: str):
    """The ``axis`` group of a grid, or the grid itself when it is one
    group of that axis."""
    if isinstance(grid, Grid):
        return getattr(grid, axis)
    if grid is not None and grid.axis == axis:
        return grid
    raise ValueError(f"this route shards the {axis!r} axis: pass a Grid or a {axis!r} group")


def plan_route(
    hmm: HMM,
    workload: Workload,
    grid=None,
    sop: StructuredOperator | None = None,
    *,
    device: torch.device | str,
) -> Route:
    """The decision table as code. Pure: inspects shapes and operator
    structure only, launches nothing. ``device`` resolves the memory
    budget when ``workload.hbm_bytes`` is None."""
    from spec_viterbi_tpu_torch.ops.fused import fused_eligible
    from spec_viterbi_tpu_torch.ops.time_parallel import time_parallel_supported
    from spec_viterbi_tpu_torch.parallel.fused_tp import fused_tp_supported
    from spec_viterbi_tpu_torch.parallel.structured_tp import structured_tp_supported

    if sop is None:
        sop = StructuredOperator.from_hmm(hmm)
    data_shards, state_shards = _mesh_shape(grid)

    if workload.streaming:
        if fused_eligible(sop):
            return Route(
                "stream_fused",
                "fused-eligible operator: the fused streaming engine",
            )
        return Route(
            "stream_xla",
            "irregular operator: the plain streaming engine",
        )

    # TP: capacity first (the model MUST shard), then latency.
    budget = workload.hbm_bytes
    if budget is None:
        budget = device_memory_bytes(device)
    resident = model_resident_bytes(sop, hmm.emit_num)
    capacity_bound = resident > budget
    latency_bound = (
        workload.optimize == "latency" and sop.n >= TP_LATENCY_STATES
    )
    if state_shards > 1 and (capacity_bound or latency_bound):
        why = (
            f"model arrays ({resident >> 20} MiB) exceed the per-device "
            f"budget ({budget >> 20} MiB)"
            if capacity_bound
            else f"latency-bound at N={sop.n} ≥ {TP_LATENCY_STATES}"
        )
        chunk = TP_CHUNK_DEFAULT
        if fused_tp_supported(sop, state_shards, chunk):
            return Route(
                "tp_chunked",
                f"{why}; banded operator: chunked-halo fused TP "
                f"(2 halo exchanges per {chunk}-step chunk)",
                {
                    "chunk": chunk,
                    "shards": state_shards,
                    "capacity_bound": capacity_bound,
                },
            )
        if structured_tp_supported(sop, state_shards):
            return Route(
                "tp_halo",
                f"{why}; coupled operator needs per-step exchange "
                "(halo TP: a halo exchange and one min-reduce a step)",
                {"shards": state_shards, "capacity_bound": capacity_bound},
            )
        # fall through: unshardable operator; DP is still correct
        # (a capacity-bound model may simply run out of memory: the
        # reason says so)
        return Route(
            "batch" if data_shards <= 1 else "dp",
            f"{why} but the operator fits neither TP schedule "
            f"(n={sop.n} % shards={state_shards}); falling back",
        )

    # Time parallelism: one long sequence leaves all lanes but one idle,
    # but on the H100 the time-parallel decoder ran at 0.020-0.10 of the
    # serial one-lane decode (PERF.md §6), so the scheduler picks
    # it only on explicit request.
    k = TIME_PARALLEL_K_DEFAULT
    tp_dropped = ""
    if workload.prefer_time_parallel:
        if workload.n_seqs != 1:
            tp_dropped = (
                f"; time-parallel request dropped: {workload.n_seqs} "
                "sequences (lanes are better spent on real batch lanes)"
            )
        elif workload.max_len < TIME_PARALLEL_MIN_T:
            tp_dropped = (
                f"; time-parallel request dropped: T={workload.max_len} < "
                f"{TIME_PARALLEL_MIN_T} (dispatch would dominate)"
            )
        elif not time_parallel_supported(sop, k):
            tp_dropped = (
                "; time-parallel request dropped: operator outside the "
                f"banded+low-rank closure at k={k}"
            )
        else:
            return Route(
                "time_parallel",
                f"single {workload.max_len}-symbol sequence, time "
                f"parallelism requested: lanes-as-time-blocks compose+fold "
                f"(k={k}); note it was a no-go on the H100 against the "
                "serial one-lane decode (PERF.md §6)",
                {"k": k},
            )

    if data_shards > 1:
        return Route(
            "dp",
            f"throughput workload ({workload.n_seqs} seqs): data "
            f"parallelism over {data_shards} shards, zero per-step "
            "collectives" + tp_dropped,
            {"shards": data_shards},
        )
    return Route(
        "batch",
        f"single-device batched decode ({workload.n_seqs} seqs); the "
        "decoder picks fused/structured/dense internally" + tp_dropped,
    )


# ---------------------------------------------------------------------------
# Route execution: dispatch to the owning machinery
# ---------------------------------------------------------------------------


def _model(hmm: HMM, sop: StructuredOperator | None):
    """(operator, emissions [E, n], π [n]) of ``hmm`` at the operator's
    padded width; ``sop`` is the operator when the caller has it."""
    if sop is None:
        sop = StructuredOperator.from_hmm(hmm)
    return sop, hmm.emission_matrix(pad_to=sop.n), hmm.start_vector(pad_to=sop.n)


def execute_route(
    hmm: HMM,
    seqs: list[np.ndarray],
    route: Route,
    grid=None,
    *,
    device: torch.device | str,
    sop: StructuredOperator | None = None,
):
    """Run ``seqs`` through ``route`` on ``device`` (a sharded route on its
    group's device). Returns ``[scores]`` per sequence, or ``[(scores,
    path)]`` when the route carries ``paths`` in its params. ``sop`` is
    ``hmm``'s structured operator at its lane-padded width, where the
    caller built it already (``decode_auto`` hands over its plan's), so
    the route does not decompose the model again. A kernel's failure
    propagates: no route carries on in plain PyTorch."""
    from spec_viterbi_tpu_torch.ops import fused

    device = resolve_device(device)
    paths = bool(route.params.get("paths"))

    if route.kind in STREAM_KINDS:
        raise ValueError(
            "streaming routes are driven incrementally: get the engine "
            "via stream_engine(hmm, route, device=) and use stream_begin/feed"
        )

    if route.kind == "time_parallel":
        from spec_viterbi_tpu_torch.ops.time_parallel import TimeParallelDecoder

        with span("svt.build"):
            sop, em, pi = _model(hmm, sop)
            tp = TimeParallelDecoder(
                sop, em, pi, k=route.params.get("k", TIME_PARALLEL_K_DEFAULT), device=device
            )
            # the blocks' pointers from the fused path kernel when the
            # operator takes it; else the plain argmin scan
            engine = (
                fused.FusedStructuredDecoder(sop, em, pi, device=device)
                if paths and fused.fused_eligible(sop) else None
            )
        if not paths:
            return [tp.decode(s) for s in seqs]
        return [tp.decode_path(s, engine=engine) for s in seqs]

    if route.kind == "tp_chunked":
        from spec_viterbi_tpu_torch.parallel.fused_tp import FusedTPDecoder

        with span("svt.build"):
            sop, em, pi = _model(hmm, sop)
            tp = FusedTPDecoder(
                sop, em, pi, _axis_group(grid, STATE_AXIS),
                chunk=route.params.get("chunk", TP_CHUNK_DEFAULT),
            )
        return tp.decode_path_batch(seqs) if paths else tp.decode_batch(seqs)

    if route.kind == "tp_halo":
        from spec_viterbi_tpu_torch.parallel.structured_tp import decode_batch_structured_tp

        if paths:
            # halo TP has no sharded-backpointer path. Chosen for LATENCY,
            # the model fits one device, so the paths come from the
            # unsharded plain structured scan (the JAX route's own
            # definition, use_pallas=False there; exact, same oracle).
            # Chosen for CAPACITY, an unsharded decode would not fit by
            # the very premise that picked TP: refuse.
            if route.params.get("capacity_bound"):
                raise ValueError(
                    "exact paths are not available under capacity-bound "
                    "halo TP (no state-sharded backpointers for coupled "
                    "operators); decode scores, or stream per time chunk"
                )
            with span("svt.build"):
                dec = ViterbiDecoder(hmm, use_kernels=False, device=device, sop=sop)
            return [dec.decode_path(s) for s in seqs]
        return decode_batch_structured_tp(hmm, seqs, _axis_group(grid, STATE_AXIS))

    if route.kind == "dp":
        from spec_viterbi_tpu_torch.parallel.sharded import (
            decode_batch_dp_fused,
            decode_path_batch_dp_fused,
        )

        group = _axis_group(grid, DATA_AXIS)
        with span("svt.build"):
            sop, em, pi = _model(hmm, sop)
            fd = (fused.FusedStructuredDecoder(sop, em, pi, device=group.device)
                  if fused.fused_eligible(sop) else None)
        if fd is not None:
            if paths:
                return decode_path_batch_dp_fused(fd, seqs, group)
            return decode_batch_dp_fused(fd, seqs, group)
        # an irregular operator: the JAX route's own definitions, the
        # plain argmin scan a sequence for paths and the structured DP
        # (plain tensor ops) for scores
        if paths:
            with span("svt.build"):
                dec = ViterbiDecoder(hmm, use_kernels=False, device=group.device, sop=sop)
            return [dec.decode_path(s) for s in seqs]
        from spec_viterbi_tpu_torch.parallel.structured_tp import decode_batch_structured_dp

        return decode_batch_structured_dp(hmm, seqs, group)

    if route.kind != "batch":
        raise ValueError(f"unknown route kind {route.kind!r}")
    # the single-device decoder owns the fused/structured/dense sub-choice
    # (and its own bucketing and backpointer budget)
    with span("svt.build"):
        dec = ViterbiDecoder(hmm, device=device, sop=sop)
    return dec.decode_path_batch(seqs) if paths else dec.decode_batch(seqs)


def stream_engine(hmm: HMM, route: Route | None = None, *, device: torch.device | str):
    """The streaming engine a stream_* route names (or plans itself)."""
    if route is not None and route.kind not in STREAM_KINDS:
        raise ValueError(f"not a streaming route: {route.kind}")
    # ViterbiDecoder.streaming() applies the same eligibility split the
    # planner encodes; the route only documents the decision
    return ViterbiDecoder(hmm, device=device).streaming()


def decode_auto(
    hmm: HMM,
    seqs: list[np.ndarray],
    grid=None,
    paths: bool = False,
    optimize: str = "throughput",
    verbose: bool = False,
    *,
    device: torch.device | str,
    **workload_kw,
):
    """Plan and execute in one call: ``[(scores, path)]`` or ``[scores]``.

    The one-stop entry for callers that do not want to know route names.
    Extra keyword arguments go to :meth:`Workload.from_seqs`, so every
    planner knob (``prefer_time_parallel``, ``hbm_bytes``, ...) is
    reachable from here. ``verbose`` prints the route and its reason to
    stderr. A ``torch.profiler`` trace holds the call's stages as spans
    (``utils/profiling.py::span``): ``svt.plan``, then ``svt.build``. The
    model is decomposed once a call, in the plan, and the route runs on
    that operator."""
    if not seqs:
        return []
    with span("svt.plan"):
        workload = Workload.from_seqs(seqs, paths=paths, optimize=optimize, **workload_kw)
        sop = StructuredOperator.from_hmm(hmm)
        route = plan_route(hmm, workload, grid, sop, device=device)
        route = Route(route.kind, route.reason, {**route.params, "paths": paths})
    if verbose:
        print(f"[scheduler] {route.kind}: {route.reason}", file=sys.stderr)
    return execute_route(hmm, seqs, route, grid, device=device, sop=sop)
