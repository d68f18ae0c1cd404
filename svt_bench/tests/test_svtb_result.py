"""A whole run on the CPU at a small size: the result line's keys, the
metrics it reports, and the refusal to run without a card."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import pytest

from svt_bench.harness import ROOT, run_cell
from svt_bench.tests import tiny

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("name,length", [("msv2405.scores.uniform", 60),
                                         ("msv2405.scores.ragged", 90),
                                         ("msv2405.path.uniform", 50)])
def test_result_keys_and_metrics(name, length):
    lanes = 160 if "ragged" in name else 16  # past one 128-lane block: the bucketed path
    cell = tiny.cell(name, lanes=lanes, length=length, keep=2, sample=24)
    result = run_cell(cell, 2**31 + 99, 0.3, False, "cpu", time.perf_counter())
    assert list(result) == KEYS + ["checks"]
    assert result["correct"] is True and result["failed"] == 0
    assert result["attempted"] % lanes == 0 and result["attempted"] >= lanes
    # the CPU reads no device memory: peak_mem_gib is left out, the rest is there
    assert set(result["metrics"]) == {"symbols_per_s", "call_p95_ms", "setup_s"}
    assert all(set(m) == {"value", "unit"} and m["value"] > 0 for m in result["metrics"].values())
    assert set(result["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    checks = result["checks"]
    assert checks["score_mismatches"] == {"value": 0, "limit": 0}
    assert set(checks) == {"score_mismatches"} | ({"path_mismatches"} if "path" in name else set())
    json.dumps(result)


def test_traced_result_keys():
    cell = tiny.cell("msv500.scores.uniform", keep=1)
    result = run_cell(cell, 5, 0.3, True, "cpu", time.perf_counter())
    assert list(result) == KEYS + ["breakdown", "checks"]
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert {"busy_s", "window_s"} <= set(result["device"]) and result["device"]["window_s"] > 0
    assert result["correct"] is True


def test_refuses_to_run_without_a_card():
    pytest.importorskip("torch")
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is for a machine without one")
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run([sys.executable, "svt_bench/run.py", "--workload", "msv500.scores.uniform",
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=ROOT, capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "CUDA device" in proc.stderr


def test_kept_answers_are_copies_in_blocks():
    import numpy as np

    from svt_bench.harness import Arena

    arena = Arena()
    path = np.arange(7, dtype=np.int32)
    scores = np.linspace(0, 1, 5, dtype=np.float32)[::2]  # not contiguous
    got_s, got_p = arena.keep((scores, path), paths=True)
    path[0] = 99
    assert got_p.dtype == np.int32 and got_p.tolist() == list(range(7))
    assert got_s.dtype == np.float32 and np.array_equal(got_s, scores)
    assert len(arena.blocks) == 1 and arena.used == 7 * 4 + 3 * 4
