"""The port's scheduler against the JAX package's, on the CPU.

``plan_route`` must pick the JAX route (``kind`` and ``params`` equal, the
reason carrying the same numbers) for every tested model × workload ×
mesh shape: the JAX side on the virtual 8-device CPU mesh, the port's on
``make_grid("cpu", ...)``. ``execute_route``, ``decode_auto`` and
``stream_engine`` run every route on seeded models against the JAX
functions: bit-equal where the JAX route runs XLA, within ±1.0 where it
runs Pallas in interpret mode (the fused DP, the chunked TP, the fused
stream engine); scores bit-equal to ``viterbi_scores_oracle`` (the
time-parallel route's within ±1.0 of it, as the JAX route's are) and
paths equal to ``viterbi_path_oracle`` throughout.
"""

import os
import re
from collections import Counter

import numpy as np
import pytest
import torch

from test_torch_host import ref_from_port

from spec_viterbi_tpu import scheduler as ref_sched
from spec_viterbi_tpu.ops.structured import StructuredOperator as RefOperator
from spec_viterbi_tpu.parallel.mesh import make_mesh

from spec_viterbi_tpu_torch import (
    almost_equal_vec,
    scheduler,
    viterbi_path_oracle,
    viterbi_scores_oracle,
)
from spec_viterbi_tpu_torch.io.generators import (
    generate_banded_hmm,
    generate_profile_hmm,
    generate_random_hmm,
    generate_tie_heavy_hmm,
)
from spec_viterbi_tpu_torch.models.streaming_xla import PlainStreamDecoder
from spec_viterbi_tpu_torch.ops.fused import FusedStructuredDecoder
from spec_viterbi_tpu_torch.ops.structured import StructuredOperator
from spec_viterbi_tpu_torch.parallel import DATA_AXIS, Grid, make_grid, make_group

torch.set_num_threads(1)

MODELS = {
    "profile": lambda: generate_profile_hmm(100, seed=0),  # coupled: dense row and columns
    "banded": lambda: generate_banded_hmm(256, (1,), 4, seed=5),
    "tie": lambda: generate_tie_heavy_hmm(150, seed=1),  # residual entries
    "random": lambda: generate_random_hmm(200, trans_per_state=6, emit_range=8, seed=3),  # irregular
    "wide_band": lambda: generate_banded_hmm(256, (-20, 20), 4, seed=4),  # outside the k=8 closure
    "big_banded": lambda: generate_banded_hmm(10240, (1,), 4, seed=2),  # N ≥ TP_LATENCY_STATES
}
MESHES = {
    "none": {},
    "data2": {"data": 2},
    "state4": {"state": 4},
    "data2_state2": {"data": 2, "state": 2},
    "state3": {"state": 3},  # n % shards != 0: neither TP schedule
}
JAX_BUDGET = 16 << 30  # the JAX package's default per-chip budget, passed to both
WORKLOADS = {
    "throughput": dict(n_seqs=50, max_len=3500),
    "single_long": dict(n_seqs=1, max_len=3500),
    "capacity": dict(n_seqs=50, max_len=3500, hbm_bytes=1024),
    "capacity_paths": dict(n_seqs=50, max_len=3500, hbm_bytes=1024, paths=True),
    "latency": dict(n_seqs=8, max_len=3500, optimize="latency"),
    "streaming": dict(n_seqs=4, max_len=100, streaming=True),
    "time_parallel": dict(n_seqs=1, max_len=3500, prefer_time_parallel=True),
    "time_parallel_many": dict(n_seqs=2, max_len=3500, prefer_time_parallel=True),
    "time_parallel_short": dict(n_seqs=1, max_len=64, prefer_time_parallel=True),
}
# numbers of the JAX reasons that cite TPU records ("round 4" of the
# time-parallel go/no-go, the "64 B/step" halo); the port cites its own
TPU_RECORD_NUMBERS = {"time_parallel": ["4"], "tp_halo": ["64"]}

_cache = {}


def model(name):
    if name not in _cache:
        _cache[name] = MODELS[name]()
    return _cache[name]


def _numbers(reason: str) -> Counter:
    return Counter(re.findall(r"\d+(?:\.\d+)?", reason))


def _seqs(hmm, lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, hmm.emit_num, size=t).astype(np.int32) for t in lengths]


def _grids(shape):
    return (make_mesh(**shape) if shape else None), (make_grid("cpu", **shape) if shape else None)


# ---- planning ----------------------------------------------------------


@pytest.mark.parametrize("name", sorted(MODELS))
def test_plan_route_matches_jax(name):
    hmm = model(name)
    ref = ref_from_port(hmm)
    sop, ref_sop = StructuredOperator.from_hmm(hmm), RefOperator.from_hmm(ref)
    kinds = set()
    for wname, kw in WORKLOADS.items():
        kw = {"hbm_bytes": JAX_BUDGET, **kw}
        for mname, shape in MESHES.items():
            mesh, grid = _grids(shape)
            want = ref_sched.plan_route(ref, ref_sched.Workload(**kw), mesh, sop=ref_sop)
            got = scheduler.plan_route(hmm, scheduler.Workload(**kw), grid, sop=sop, device="cpu")
            case = (name, wname, mname)
            assert (got.kind, got.params) == (want.kind, want.params), case
            missing = _numbers(want.reason) - _numbers(got.reason)
            assert not missing - Counter(TPU_RECORD_NUMBERS.get(got.kind, [])), (case, got.reason)
            kinds.add(got.kind)
    assert "batch" in kinds and "dp" in kinds  # every model reaches both


def test_plan_route_reaches_every_kind():
    """Across the models above the table reaches every route kind, and
    drops a time-parallel request for each of its three reasons."""
    seen, dropped = set(), set()
    for name in ("profile", "banded", "random", "wide_band", "big_banded"):
        hmm = model(name)
        for kw in WORKLOADS.values():
            for shape in MESHES.values():
                r = scheduler.plan_route(hmm, scheduler.Workload(**{"hbm_bytes": JAX_BUDGET, **kw}),
                                         _grids(shape)[1], device="cpu")
                seen.add(r.kind)
                m = re.search(r"time-parallel request dropped: (\S+ \S+)", r.reason)
                if m:
                    dropped.add(m.group(1).split()[0].rstrip(":"))
    assert seen == {"batch", "dp", "tp_chunked", "tp_halo", "time_parallel",
                    "stream_fused", "stream_xla"}
    assert dropped == {"2", "T=64", "operator"}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_model_resident_bytes_matches_jax(name):
    hmm = model(name)
    ref = ref_from_port(hmm)
    assert scheduler.model_resident_bytes(StructuredOperator.from_hmm(hmm), hmm.emit_num) == \
        ref_sched.model_resident_bytes(RefOperator.from_hmm(ref), ref.emit_num)


def test_default_budget_is_the_devices_memory():
    host = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    assert scheduler.device_memory_bytes("cpu") == host
    assert scheduler.Workload(n_seqs=1, max_len=1).hbm_bytes is None
    hmm = model("profile")
    r = scheduler.plan_route(hmm, scheduler.Workload(n_seqs=8, max_len=100), make_grid("cpu", state=4),
                             device="cpu")
    assert r.kind == "batch"  # 12.5 KiB of model fits the host
    tight = scheduler.Workload(n_seqs=8, max_len=100, hbm_bytes=1024)
    assert scheduler.plan_route(hmm, tight, make_grid("cpu", state=4), device="cpu").kind == "tp_halo"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            scheduler.plan_route(hmm, scheduler.Workload(n_seqs=8, max_len=100), device="cuda")


def test_mesh_shape_and_route_groups():
    grid = make_grid("cpu", data=2, state=3)
    assert scheduler._mesh_shape(None) == (1, 1)
    assert scheduler._mesh_shape(grid) == (2, 3)
    assert scheduler._mesh_shape(make_group("cpu", 4)) == (1, 4)
    assert scheduler._mesh_shape(make_group("cpu", 2, axis=DATA_AXIS)) == (2, 1)
    assert scheduler._axis_group(grid, "state") is grid.state
    assert scheduler._axis_group(grid, "data") is grid.data
    single = make_group("cpu", 4)
    assert scheduler._axis_group(single, "state") is single
    with pytest.raises(ValueError, match="'data' axis"):
        scheduler._axis_group(single, "data")
    with pytest.raises(ValueError, match="'state' axis"):
        scheduler._axis_group(None, "state")
    hmm = model("banded")
    with pytest.raises(ValueError, match="'state' axis"):  # tp_chunked takes the state group
        scheduler.execute_route(hmm, _seqs(hmm, (5,)), scheduler.Route("tp_chunked", "", {"chunk": 16}),
                                make_group("cpu", 2, axis=DATA_AXIS), device="cpu")


# ---- execution -----------------------------------------------------------

LENGTHS = (30, 7, 41, 2, 33, 1)
# (model, route kind, params, mesh shape, how the JAX route computes)
ROUTES = {
    "batch": ("profile", "batch", {}, {}, "xla"),
    "batch_paths": ("tie", "batch", {"paths": True}, {}, "xla"),
    "dp_fused": ("profile", "dp", {}, {"data": 2}, "pallas"),
    "dp_fused_paths": ("profile", "dp", {"paths": True}, {"data": 2, "state": 2}, "pallas"),
    "dp_irregular": ("random", "dp", {}, {"data": 2}, "xla"),
    "dp_irregular_paths": ("random", "dp", {"paths": True}, {"data": 2}, "xla"),
    "tp_chunked": ("banded", "tp_chunked", {"chunk": 16}, {"state": 4}, "pallas"),
    "tp_chunked_paths": ("banded", "tp_chunked", {"chunk": 16, "paths": True}, {"data": 2, "state": 2},
                         "pallas"),
    "tp_halo": ("profile", "tp_halo", {"capacity_bound": True}, {"state": 4}, "xla"),
    "tp_halo_latency_paths": ("profile", "tp_halo", {"capacity_bound": False, "paths": True},
                              {"state": 4}, "xla"),
    "time_parallel": ("profile", "time_parallel", {"k": 8}, {}, "xla"),
    "time_parallel_paths": ("banded", "time_parallel", {"k": 4, "paths": True}, {}, "xla"),
}


def _check_against(hmm, seqs, got, want, paths, exact, kind):
    """Scores bit-equal to the oracle (the time-parallel composition
    within ±1.0 of it: its operator values pre-combine), paths equal to
    the oracle's and the JAX route's, scores bit-equal to the JAX route's
    (``exact``) or within ±1.0."""
    oracle_same = almost_equal_vec if kind == "time_parallel" else np.array_equal
    assert len(got) == len(want) == len(seqs)
    for s, g, w in zip(seqs, got, want):
        if paths:
            want_sc, want_p = viterbi_path_oracle(hmm, s)
            assert oracle_same(g[0], want_sc) and np.array_equal(g[1], want_p)
            assert np.array_equal(g[1], w[1])
            g, w = g[0], w[0]
        else:
            assert oracle_same(g, viterbi_scores_oracle(hmm, s))
        assert np.array_equal(g, w) if exact else almost_equal_vec(g, w)


@pytest.mark.parametrize("case", sorted(ROUTES))
def test_execute_route_matches_jax(case):
    name, kind, params, shape, jax_path = ROUTES[case]
    hmm = model(name)
    seqs = _seqs(hmm, LENGTHS if kind != "time_parallel" else (600, 37, 1))
    mesh, grid = _grids(shape)
    want = ref_sched.execute_route(ref_from_port(hmm), seqs, ref_sched.Route(kind, "", params), mesh)
    got = scheduler.execute_route(hmm, seqs, scheduler.Route(kind, "", params), grid, device="cpu")
    _check_against(hmm, seqs, got, want, params.get("paths", False), jax_path == "xla", kind)


def test_execute_route_refusals():
    hmm = model("profile")
    seqs = _seqs(hmm, (5, 6))
    for kind in ("stream_fused", "stream_xla"):
        with pytest.raises(ValueError, match="stream_engine"):
            scheduler.execute_route(hmm, seqs, scheduler.Route(kind, ""), device="cpu")
    capacity = scheduler.Route("tp_halo", "", {"capacity_bound": True, "paths": True})
    with pytest.raises(ValueError, match="capacity-bound halo TP"):
        scheduler.execute_route(hmm, seqs, capacity, make_grid("cpu", state=4), device="cpu")
    with pytest.raises(ValueError, match="not a streaming route"):
        scheduler.stream_engine(hmm, scheduler.Route("batch", ""), device="cpu")
    with pytest.raises(ValueError, match="unknown route kind"):
        scheduler.execute_route(hmm, seqs, scheduler.Route("bogus", ""), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            scheduler.execute_route(hmm, seqs, scheduler.Route("batch", ""), device="cuda")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            scheduler.decode_auto(hmm, seqs, device="cuda")


@pytest.mark.parametrize("name,engine,exact", [("profile", FusedStructuredDecoder, False),
                                               ("random", PlainStreamDecoder, True)])
def test_stream_engine_matches_jax(name, engine, exact):
    """A planned stream route's engine: the fused engine for a
    fused-eligible operator, the plain one for the rest; its scores over
    chunked feeds against the JAX engine the JAX route names."""
    hmm = model(name)
    ref = ref_from_port(hmm)
    wl = dict(n_seqs=3, max_len=40, streaming=True)
    route = scheduler.plan_route(hmm, scheduler.Workload(**wl), device="cpu")
    assert route.kind == ref_sched.plan_route(ref, ref_sched.Workload(**wl)).kind
    eng, ref_eng = scheduler.stream_engine(hmm, route, device="cpu"), ref_sched.stream_engine(ref, route)
    assert type(eng) is engine and eng is not None
    block = np.stack(_seqs(hmm, (40, 40, 40)), axis=1)
    outs = []
    for e in (eng, ref_eng):
        st = e.stream_begin(block[0])
        for pos in (1, 14, 30):
            st = e.stream_feed(st, block[pos : pos + {1: 13, 14: 16, 30: 10}[pos]])
        outs.append(np.asarray(e.stream_scores(st))[:, : hmm.states_num])
    for j in range(block.shape[1]):
        assert np.array_equal(outs[0][j], viterbi_scores_oracle(hmm, block[:, j]))
        same = np.array_equal if exact else almost_equal_vec
        assert same(outs[0][j], outs[1][j])


# (model, mesh shape, decode_auto keyword arguments, the route it plans,
# how the JAX route computes)
AUTO = {
    "batch": ("profile", {}, {}, "batch", "xla"),
    "batch_paths": ("profile", {}, {"paths": True}, "batch", "xla"),
    "dp": ("profile", {"data": 2}, {}, "dp", "pallas"),
    "tp_chunked": ("banded", {"state": 4}, {"hbm_bytes": 1024}, "tp_chunked", "pallas"),
    "tp_halo": ("profile", {"state": 4}, {"hbm_bytes": 1024}, "tp_halo", "xla"),
    "time_parallel": ("profile", {}, {"paths": True, "prefer_time_parallel": True}, "time_parallel", "xla"),
}


@pytest.mark.parametrize("case", sorted(AUTO))
def test_decode_auto_matches_jax(case, capsys):
    name, shape, kw, kind, jax_path = AUTO[case]
    hmm = model(name)
    seqs = _seqs(hmm, (600,) if kind == "time_parallel" else LENGTHS)
    mesh, grid = _grids(shape)
    want = ref_sched.decode_auto(ref_from_port(hmm), seqs, mesh, verbose=True, **kw)
    ref_line = capsys.readouterr().err.strip().splitlines()[-1]
    got = scheduler.decode_auto(hmm, seqs, grid, verbose=True, device="cpu", **kw)
    line = capsys.readouterr().err.strip().splitlines()[-1]
    assert ref_line.startswith(f"[scheduler] {kind}: ") and line.startswith(f"[scheduler] {kind}: ")
    _check_against(hmm, seqs, got, want, kw.get("paths", False), jax_path == "xla", kind)


def test_decode_auto_forwards_workload_keywords(monkeypatch):
    hmm = model("profile")
    seqs = _seqs(hmm, (600,))
    seen = []
    real = scheduler.execute_route

    def spy(hmm_, seqs_, route, grid=None, *, device, sop=None):
        seen.append(route)
        assert sop is not None  # the plan's operator, decomposed once a call
        return real(hmm_, seqs_, route, grid, device=device, sop=sop)

    monkeypatch.setattr(scheduler, "execute_route", spy)
    scheduler.decode_auto(hmm, seqs, device="cpu", prefer_time_parallel=True)
    scheduler.decode_auto(hmm, seqs, make_grid("cpu", state=4), optimize="latency", device="cpu")
    scheduler.decode_auto(hmm, seqs, make_grid("cpu", state=4), paths=False, hbm_bytes=1024, device="cpu")
    assert [(r.kind, r.params) for r in seen] == [
        ("time_parallel", {"k": 8, "paths": False}),
        ("batch", {"paths": False}),  # 128 states: not latency-bound
        ("tp_halo", {"shards": 4, "capacity_bound": True, "paths": False}),
    ]
    assert scheduler.decode_auto(hmm, [], device="cpu") == []
    with pytest.raises(TypeError):
        scheduler.decode_auto(hmm, seqs, device="cpu", no_such_knob=1)


def test_grid_routes_take_their_axis():
    """A two-axis grid hands ``dp`` its data group and the TP routes their
    state group (the JAX package passes one mesh with both axes)."""
    grid = make_grid("cpu", data=2, state=2)
    assert isinstance(grid, Grid)
    banded = model("banded")
    seqs = _seqs(banded, (20, 9))
    for kind, params in (("dp", {}), ("tp_chunked", {"chunk": 16}), ("tp_halo", {})):
        got = scheduler.execute_route(banded, seqs, scheduler.Route(kind, "", params), grid, device="cpu")
        assert all(np.array_equal(g, viterbi_scores_oracle(banded, s)) for g, s in zip(got, seqs))
