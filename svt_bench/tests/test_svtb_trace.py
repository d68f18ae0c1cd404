"""The trace arithmetic on hand-made intervals, and the labels of a traced
run's idle gaps."""

from __future__ import annotations

import time

import pytest

from svt_bench import trace
from svt_bench.harness import run_cell
from svt_bench.tests import tiny


def test_union_gaps_and_exposed_host():
    t = trace.Trace(
        device=[(0.1, 0.3, "k1"), (0.2, 0.4, "Memcpy HtoD"), (0.6, 0.7, "k2"), (1.2, 1.3, "k3")],
        host=[(0.0, 0.9, "aten::to"), (0.45, 0.55, "aten::copy_")],
        calls=[(0.0, 1.0), (1.0, 1.5)],
    )
    assert t.window == (0.0, 1.5)
    assert t.union == pytest.approx([(0.1, 0.4), (0.6, 0.7), (1.2, 1.3)])
    assert t.busy_s() == pytest.approx(0.3 + 0.1 + 0.1)
    assert t.gaps() == pytest.approx([(0.0, 0.1), (0.4, 0.6), (0.7, 1.2), (1.3, 1.5)])
    assert t.exposed_s() == pytest.approx([1.0 - 0.4, 0.5 - 0.1])
    assert t.device_sums(kernels_only=True) == pytest.approx({"k1": 0.2, "k2": 0.1, "k3": 0.1})
    assert t.host_at(0.5) == "aten::copy_"
    assert t.host_at(0.8) == "aten::to"
    assert t.host_at(1.4) == "python"
    assert t.host_at(1.6) == "between calls"


@pytest.mark.parametrize("order", [(0, 1, 2), (2, 0, 1), (1, 2, 0)])
def test_exposed_host_ignores_launch_order(order):
    # one call, three kernels of 1, 2 and 4 ms launched in any order, with the
    # same host time between them: the exposed host time stays 3 ms
    lengths = [0.001, 0.002, 0.004]
    device, t = [], 0.0
    for k in order:
        t += 0.001
        device.append((t, t + lengths[k], f"k{k}"))
        t += lengths[k]
    t_end = t + 0.0  # the call ends with its last kernel
    tr = trace.Trace(device=device, host=[], calls=[(0.0, t_end)])
    assert tr.exposed_s() == pytest.approx([0.003])


def test_traced_run_labels_the_gaps():
    cell = tiny.cell("msv2405.scores.uniform", keep=1)
    result = run_cell(cell, 8, 0.2, True, "cpu", time.perf_counter())
    (label, _), = result["breakdown"]["idle_gaps"]  # no device: the whole window is one gap
    assert isinstance(label, str) and label
    assert result["correct"] is True
