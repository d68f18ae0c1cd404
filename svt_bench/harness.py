"""One run of one cell: set-up, the measured window, the metrics, and the
check of what the window produced against the plain reference.

Everything that belongs to one configuration, traffic mix, entry or metric
sits in a file of its own, found by the name ``BENCHMARK.json`` gives it:

- ``configs/<config>.json``: the model's sizes, its structure, its limits;
- ``structures/<structure>.py``: ``build(config, seed)`` → the model's arrays;
- ``traffic/<mix>.json``: the parameters ``generate.py`` reads;
- ``entries/<entry>.py``: ``setup(arrays, mix, device)`` and ``call(state,
  batch)``, the program's entry the window drives;
- ``metrics/<metric>.py``: ``read(run)`` → a number, or None where there is
  nothing to read.

The window is one closed-loop caller: the calls go back to back through the
pool's batches in turn, each ending with host arrays. For every call the
harness keeps ``keep`` lanes' answers, drawn from the seed; after the window
it checks a sample of them, drawn from the seed and holding the longest
sequences, against ``reference.py`` on the same device.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from svt_bench import generate, reference
from svt_bench.trace import CALL_SPAN, Trace, from_profiler

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "spec_viterbi_tpu")
KEEP_STREAM, SAMPLE_STREAM = 2, 3  # sub-streams of the seed
NAME_CHARS = 160  # a kernel's name in the breakdown, cut (C++ templates run to kilobytes)


def load_module(kind: str, name: str):
    """``svt_bench/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = HERE / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"svt_bench.{kind}.{name}", path)
    if spec is None or not path.exists():
        raise FileNotFoundError(f"no {kind} named {name!r} ({path})")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_json(kind: str, name: str) -> dict:
    return json.loads((HERE / kind / f"{name}.json").read_text())


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


@dataclasses.dataclass
class Cell:
    """A cell of ``BENCHMARK.json`` with what its names point to."""

    name: str
    chips: int
    config: dict
    mix: dict
    end_to_end: list  # the metric entries this cell reports, per mode
    per_layer: list

    @classmethod
    def load(cls, name: str, spec: dict | None = None) -> "Cell":
        spec = spec or json.loads((ROOT / "BENCHMARK.json").read_text())
        cell = next((w for w in spec["workloads"] if w["name"] == name), None)
        if cell is None:
            raise KeyError(f"no workload named {name!r} in BENCHMARK.json")

        def mine(metrics):
            return [m for m in metrics if name in m.get("workloads", [name])]

        return cls(name, int(cell["chips"]), load_json("configs", cell["config"]),
                   load_json("traffic", cell["traffic"]), mine(spec["end_to_end"]),
                   mine(spec["per_layer"]))


@dataclasses.dataclass
class Run:
    """What the readers of ``metrics/`` read."""

    cell: Cell
    arrays: dict
    setup_s: float
    calls: list  # (start, end, pool index), host clock
    lengths: list  # per pool entry, the lengths of its batch
    window_peak_bytes: int | None
    trace: Trace | None

    def symbols(self) -> int:
        return int(sum(self.lengths[p].sum() for _, _, p in self.calls))

    def call_ms(self) -> list[float]:
        return [(t1 - t0) * 1e3 for t0, t1, _ in self.calls]

    def lengths_done(self) -> np.ndarray:
        return np.concatenate([self.lengths[p] for _, _, p in self.calls])


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Arena:
    """Copies of the kept answers, packed into large byte blocks allocated
    once in a while. A small copy a call, left on the heap that the program
    allocates its per-lane answers from, fragments it: on the card the path
    cell's calls then slowed from about 40 to 60-80 ms after some 20 s of a
    window, and the copies into blocks took that away."""

    BLOCK = 1 << 24

    def __init__(self):
        self.blocks: list[np.ndarray] = []
        self.used = 0

    def put(self, arr):
        arr = np.asarray(arr)
        if arr.dtype.hasobject:
            return np.array(arr, copy=True)
        shape, arr = arr.shape, np.ascontiguousarray(arr)  # the latter is never 0-d
        if not self.blocks or self.used + arr.nbytes > len(self.blocks[-1]):
            self.blocks.append(np.empty(max(self.BLOCK, arr.nbytes), np.uint8))
            self.used = 0
        block, at = self.blocks[-1], self.used
        block[at:at + arr.nbytes] = arr.reshape(-1).view(np.uint8)
        self.used += arr.nbytes
        return np.frombuffer(block, arr.dtype, arr.size, at).reshape(shape)

    def keep(self, answer, paths: bool):
        """A copy of one lane's answer, so the call's arrays can be freed."""
        if paths:
            scores, path = answer
            return self.put(scores), self.put(path)
        return self.put(answer)


def window(entry, state, batches, seconds, keep_lanes, longest, paths, device, traced):
    """The measured window. Returns (calls, kept answers, failures, trace)."""
    calls, kept, failed, arena = [], {}, None, Arena()
    prof = None
    if traced:
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
        prof = profile(activities=acts)
        prof.__enter__()
    try:
        w0 = time.perf_counter()
        i = 0
        while True:
            p = i % len(batches)
            t0 = time.perf_counter()
            try:
                if traced:
                    with record_function(CALL_SPAN):
                        out = entry.call(state, batches[p])
                else:
                    out = entry.call(state, batches[p])
            except Exception as exc:  # a failed call ends the window; the run reports it
                failed = i
                print(f"call {i} (pool batch {p}) failed: {exc!r}"[:2000], file=sys.stderr)
                break
            t1 = time.perf_counter()
            lanes = set(keep_lanes(i).tolist())
            if i < len(batches):
                lanes.add(longest[p])
            for lane in lanes:
                kept[(i, p, lane)] = arena.keep(out[lane], paths) if lane < len(out) else None
            del out
            calls.append((t0, t1, p))
            i += 1
            if t1 - w0 >= seconds:
                break
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
    return calls, kept, failed, (from_profiler(prof) if prof is not None else None)


def judge(kept: dict, batches, arrays, mix, config, seed, device) -> tuple[dict, int]:
    """(the numbers compared with their limits, the answers checked): the
    entries of the sample that differ from the reference (scores: states not
    equal, paths: positions not equal; an answer missing or of the wrong shape
    counts whole)."""
    paths = bool(mix["paths"])
    keys = sorted(kept)
    rng = np.random.default_rng([seed, SAMPLE_STREAM])
    size = int(mix["sample"])
    lens = {k: len(batches[k[1]][k[2]]) for k in keys}
    top = max(lens.values(), default=0)
    must = [k for k in keys if lens[k] == top][:1]
    rest = [k for k in keys if k not in must]
    take = list(rng.choice(len(rest), size=min(len(rest), max(size - len(must), 0)),
                           replace=False)) if rest else []
    sample = must + [rest[j] for j in sorted(take)]
    seqs = sorted({(p, lane) for _, p, lane in sample})
    model = reference.Model(arrays, device)
    ref = reference.decode(model, [batches[p][lane] for p, lane in seqs], paths=paths,
                           block=int(mix["block"]))
    ref = dict(zip(seqs, ref))
    n = int(arrays["states"])
    bad_scores = bad_paths = 0
    for i, p, lane in sample:
        got, want = kept[(i, p, lane)], ref[(p, lane)]
        if paths:
            got_s, got_p = got if got is not None else (None, None)
            want_s, want_p = want
            bad_paths += _differ(got_p, want_p, len(want_p))
        else:
            got_s, want_s = got, want
        bad_scores += _differ(got_s, want_s, n)
    limits = config["limits"]
    checks = {"score_mismatches": {"value": bad_scores, "limit": limits["score_mismatches"]}}
    if paths:
        checks["path_mismatches"] = {"value": bad_paths, "limit": limits["path_mismatches"]}
    return checks, len(sample)


def _differ(got, want, whole: int) -> int:
    """Entries of ``got`` not equal to ``want`` (``+inf`` equals ``+inf``);
    all of them where the shapes differ."""
    if got is None:
        return whole
    got = np.asarray(got)
    if got.shape != np.shape(want):
        return whole
    return int(np.count_nonzero(got != want))


def passed(checks: dict) -> bool:
    """Every number compared within its limit."""
    return all(c["value"] <= c["limit"] for c in checks.values())


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool, device, t_start: float,
             entry=None, keep: int | None = None) -> dict:
    """One run; returns the result object (its keys in the printed order).
    ``entry`` and ``keep`` replace the mix's entry and kept lanes a call
    (the control and the tests use them)."""
    device = torch.device(device)
    config, mix = cell.config, cell.mix
    arrays = load_module("structures", config["structure"]).build(config, seed)
    batches = generate.pool(mix, int(arrays["symbols"]), seed)
    lengths = [np.array([len(s) for s in b], np.int64) for b in batches]
    longest = [int(np.argmax(ln)) for ln in lengths]
    entry = entry or load_module("entries", mix["entry"])
    paths = bool(mix["paths"])
    lanes = int(mix["lanes"])
    keep = int(mix["keep"]) if keep is None else keep
    keep_rng = np.random.default_rng([seed, KEEP_STREAM])

    def keep_lanes(i):  # the call's lanes kept for the check
        return np.arange(lanes) if keep >= lanes else keep_rng.integers(0, lanes, size=keep)

    t_ready = time.perf_counter()
    state = entry.setup(arrays, mix, device)
    for b in batches:  # warm every shape of the pool
        entry.call(state, b)
    _sync(device)
    warm_s = time.perf_counter() - t_ready
    setup_peak = None
    if device.type == "cuda":
        setup_peak = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t_start
    calls, kept, failed, trace = window(entry, state, batches, seconds, keep_lanes, longest,
                                       paths, device, traced)
    _sync(device)
    window_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
    memory_peak = max(setup_peak, window_peak) if device.type == "cuda" else 0
    del state
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    run = Run(cell, arrays, setup_s, calls, lengths, window_peak, trace)
    wanted = cell.per_layer if traced else cell.end_to_end
    metrics = {}
    for m in wanted:
        value = load_module("metrics", m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    t_judge = time.perf_counter()
    checks, checked = judge(kept, batches, arrays, mix, config, seed, device)
    ms = run.call_ms() or [float("nan")]
    half = len(ms) // 2
    print(f"{cell.name} seed {seed}: setup {setup_s:.3f} s (entry set-up and warm-up {warm_s:.3f}),"
          f" {len(calls)} calls (median ms: all {np.median(ms):.3f}, first half"
          f" {np.median(ms[:half] or ms):.3f}, second half {np.median(ms[half:]):.3f}; max"
          f" {max(ms):.3f}), {checked} answers checked in {time.perf_counter() - t_judge:.3f} s",
          file=sys.stderr)
    attempted = lanes * (len(calls) + (failed is not None))
    result = {
        "correct": failed is None and checked > 0 and passed(checks),
        "attempted": attempted,
        "failed": lanes if failed is not None else 0,
        "metrics": metrics,
        "device": device_info(device, memory_peak, trace),
    }
    if trace is not None:
        result["breakdown"] = breakdown(trace)
    result["checks"] = checks
    return result


def device_info(device: torch.device, memory_peak: int, trace: Trace | None) -> dict:
    info = {
        "platform": "gpu" if device.type == "cuda" else device.type,
        "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "count": 1,
        "memory_peak_bytes": int(memory_peak),
    }
    if trace is not None:
        lo, hi = trace.window
        info["busy_s"] = trace.busy_s()
        info["window_s"] = hi - lo
    return info


def breakdown(trace: Trace) -> dict:
    """The ten device activities that took most time, and the ten longest
    idle gaps, each named by the innermost host event at its middle."""
    ops = sorted(trace.device_sums().items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(trace.gaps(), key=lambda g: g[0] - g[1])[:10]
    return {
        "device_ops": [[name[:NAME_CHARS], s] for name, s in ops],
        "idle_gaps": [[trace.host_at((a + b) / 2), b - a] for a, b in gaps],
    }
