"""The ``dense.read_share`` reader: nothing without the program's counter
or its ``read`` count, 100 × read / launched with them; a traced CPU run of
the Plan7 cell reports it beside ``dense.fill_share``."""

from __future__ import annotations

import time

import pytest

from svt_bench.harness import load_module, run_cell
from svt_bench.tests import tiny


def test_read_share_reader(monkeypatch):
    from spec_viterbi_tpu_torch.ops import tropical

    read = load_module("metrics", "dense.read_share").read
    monkeypatch.setattr(tropical, "dense_work", {"launched": 1024**2 * 512 * 3499,
                                                 "read": 308 * 64 * 16 * 512 * 3499,
                                                 "real": 127_749 * 512 * 3499})
    assert read(None) == pytest.approx(30.078125)
    monkeypatch.setattr(tropical, "dense_work", {"launched": 10, "real": 1})  # no read count
    assert read(None) is None
    monkeypatch.setattr(tropical, "dense_work", {"launched": 0, "read": 0, "real": 0})
    assert read(None) is None
    monkeypatch.delattr(tropical, "dense_work")
    assert read(None) is None


def test_traced_cpu_run_reports_the_read_share():
    from spec_viterbi_tpu_torch.ops import tropical

    # 40 nodes: 81 states padded to 128; 10 of the operator's 16 (64-row,
    # 16-k) blocks hold a finite entry
    tropical.reset_launches()
    cell = tiny.cell("plan7_500.scores.uniform", keep=1)
    result = run_cell(cell, 2**31 + 23, 0.3, True, "cpu", time.perf_counter())
    assert result["correct"] is True
    assert result["metrics"]["dense.read_share"] == {"value": 100 * 10 * 64 * 16 / 128**2,
                                                     "unit": "%"}
