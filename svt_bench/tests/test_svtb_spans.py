"""The readers of the program's spans and of its lane-step counter, on
hand-made traces and runs, and on a traced run on the CPU."""

from __future__ import annotations

import time

import pytest

from svt_bench import spans, trace
from svt_bench.harness import Run, load_module, run_cell
from svt_bench.tests import tiny

STAGES = ("plan", "build", "stage", "launch", "fetch")


def _run(tr):
    return Run(cell=None, arrays={}, setup_s=0.0, calls=[], lengths=[], window_peak_bytes=None,
               trace=tr)


def test_exposed_time_leaves_out_the_device_and_sums_instances():
    tr = trace.Trace(
        device=[(0.15, 0.25, "k1"), (0.35, 0.45, "Memcpy DtoH"), (1.1, 1.6, "k2")],
        host=[(0.1, 0.3, "svt.stage"), (0.3, 0.5, "svt.stage"), (0.6, 0.7, "svt.launch"),
              (1.0, 1.2, "svt.stage"), (0.12, 0.14, "aten::copy_")],
        calls=[(0.0, 1.0), (1.0, 2.0)],
    )
    # call 0: two instances of 0.2 s, each half covered; call 1: 0.2 s, half covered
    assert spans.exposed_s(tr, "svt.stage", tr.calls) == pytest.approx([0.2, 0.1])
    assert spans.exposed_s(tr, "svt.launch", tr.calls) == pytest.approx([0.1, 0.0])
    assert spans.mean_exposed_ms(tr, "svt.stage") == pytest.approx(150.0)
    assert spans.exposed_s(tr, "svt.fetch", tr.calls) is None
    assert spans.mean_exposed_ms(tr, "svt.fetch") is None
    assert spans.mean_exposed_ms(None, "svt.stage") is None


def test_an_instance_is_cut_to_its_call():
    tr = trace.Trace(device=[], host=[(0.9, 1.3, "svt.fetch")], calls=[(0.0, 1.0), (1.0, 2.0)])
    assert spans.exposed_s(tr, "svt.fetch", tr.calls) == pytest.approx([0.1, 0.0])


@pytest.mark.parametrize("stage", STAGES)
def test_stage_readers(stage):
    # the stage once a call, 10 ms long, with 4 ms of device work in the
    # first call and none in the second; the other stages after it
    host, device = [(0.0, 2.0, "svt.outer")], [(0.002, 0.006, "k")]
    for call in (0, 1):
        host.append((call, call + 0.01, f"svt.{stage}"))
        for k, other in enumerate([s for s in STAGES if s != stage], 1):
            host.append((call + 0.1 * k, call + 0.1 * k + 0.01, f"svt.{other}"))
    tr = trace.Trace(device=device, host=host, calls=[(0.0, 1.0), (1.0, 2.0)])
    read = load_module("metrics", f"host.{stage}_ms").read
    assert read(_run(tr)) == pytest.approx((6.0 + 10.0) / 2)
    without = trace.Trace(device=device, host=[h for h in host if h[2] != f"svt.{stage}"],
                          calls=tr.calls)
    assert read(_run(without)) is None
    assert read(_run(None)) is None


def test_pad_share_reader(monkeypatch):
    from spec_viterbi_tpu_torch.ops import fused

    read = load_module("metrics", "pad_share").read
    monkeypatch.setattr(fused, "lane_steps", {"launched": 1_137_672, "real": 593_754})
    assert read(_run(None)) == pytest.approx(47.8098, abs=1e-4)
    monkeypatch.setattr(fused, "lane_steps", {"launched": 100, "real": 100})
    assert read(_run(None)) == 0.0
    monkeypatch.setattr(fused, "lane_steps", {"launched": 0, "real": 0})
    assert read(_run(None)) is None
    monkeypatch.delattr(fused, "lane_steps")
    assert read(_run(None)) is None


def test_traced_cpu_run_reads_the_scheduler_spans():
    # on the CPU the decoder is the plain one: the call records svt.plan and
    # svt.build, and no staging, launch or fetch span, so those are left out
    cell = tiny.cell("msv2405.scores.uniform", keep=1)
    result = run_cell(cell, 2**31 + 17, 0.3, True, "cpu", time.perf_counter())
    metrics = result["metrics"]
    assert metrics["host.plan_ms"]["value"] > 0 and metrics["host.build_ms"]["value"] > 0
    assert metrics["host.plan_ms"]["unit"] == "ms"
    assert not {"host.stage_ms", "host.launch_ms", "host.fetch_ms", "pad_share"} & set(metrics)
    # the whole CPU window is idle, so the spans' time is inside the exposed time
    spent = metrics["host.plan_ms"]["value"] + metrics["host.build_ms"]["value"]
    assert spent <= metrics["host.exposed_ms"]["value"]
    assert result["correct"] is True
