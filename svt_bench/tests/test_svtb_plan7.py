"""The Plan7 configuration and the two cells this benchmark added with it
(``plan7_500.scores.uniform``, ``msv2405.path.ragged``): the structure's
sizes and seeding, the cells' per-layer metrics, the Plan7 reference's
imports, the ``dense.fill_share`` reader, and traced runs on the CPU at a
small size."""

from __future__ import annotations

import time

import numpy as np
import pytest

from svt_bench import generate
from svt_bench.harness import Cell, load_json, load_module, run_cell
from svt_bench.structures import plan7_profile
from svt_bench.tests import tiny
from svt_bench.tests.test_svtb_imports import HERE, top_level_imports

HOST = ["host.exposed_ms", "device.idle_share", "kernels_roofline", "decode_mfu",
        "host.plan_ms", "host.build_ms", "host.stage_ms", "host.launch_ms", "host.fetch_ms"]


def test_configuration_builds_its_stated_sizes():
    config = load_json("configs", "plan7_500")
    arrays = plan7_profile.build(config, seed=2**31 + 3)
    assert arrays["states"] == config["states"] == 1001
    assert len(arrays["src"]) == config["transitions"] == 127_749
    assert arrays["emissions"].shape == (config["symbols"], 1001)
    assert np.isfinite(arrays["cost"]).all() and arrays["cost"].dtype == np.float32
    # 124,251 of them are folded delete chains Mk → Mj, j ≥ k + 2
    src, dst = arrays["src"], arrays["dst"]
    assert int(((src >= 1) & (dst <= 500) & (dst >= src + 2)).sum()) == 124_251
    assert config["reduced"] == [] and config["limits"] == {"score_mismatches": 0,
                                                            "path_mismatches": 0}


def test_structure_is_seeded():
    config = {"match_states": 30, "symbols": 20}
    a, b = plan7_profile.build(config, 7), plan7_profile.build(config, 7)
    c = plan7_profile.build(config, 8)
    assert all(np.array_equal(a[k], b[k]) for k in a)
    assert not np.array_equal(a["cost"], c["cost"])
    assert not np.array_equal(a["emissions"], c["emissions"])


def test_structure_is_the_programs_generator():
    from spec_viterbi_tpu_torch.io.generators import generate_plan7_hmm

    for big_l, seed in ((2, 0), (40, 7), (500, 2**31 + 11)):
        hmm = generate_plan7_hmm(big_l, seed=seed)
        arrays = plan7_profile.build({"match_states": big_l, "symbols": 20}, seed)
        assert arrays["states"] == hmm.states_num
        for key, want in (("src", hmm.trans_rows), ("dst", hmm.trans_cols),
                          ("cost", hmm.trans_probs), ("emissions", hmm.emissions),
                          ("start_states", hmm.start_probabilities_cols),
                          ("start_cost", hmm.start_probabilities)):
            assert arrays[key].dtype == want.dtype and np.array_equal(arrays[key], want), key


@pytest.mark.parametrize("name,extra", [("plan7_500.scores.uniform", ["dense.fill_share"]),
                                        ("msv2405.path.ragged", ["pad_share"])])
def test_new_cells_load_with_their_metrics(name, extra):
    cell = Cell.load(name)
    assert cell.chips == 1
    assert [m["name"] for m in cell.per_layer] == HOST + extra
    assert [m["name"] for m in cell.end_to_end] == ["symbols_per_s", "call_p95_ms",
                                                    "peak_mem_gib", "setup_s"]
    for m in cell.per_layer + cell.end_to_end:
        load_module("metrics", m["name"])


def test_path_ragged_law():
    mix = load_json("traffic", "path.ragged")
    assert mix["paths"] is True and (mix["pool"], mix["sample"], mix["block"]) == (4, 128, 64)
    assert mix["lengths"] == load_json("traffic", "scores.ragged")["lengths"]
    lens = generate.lengths_of(mix["lengths"], mix["lanes"])
    assert len(lens) == 504 and lens.sum() == 42 * 14_149


def test_plan7_reference_imports_nothing_of_the_program():
    import sys

    allowed = set(sys.stdlib_module_names) | {"numpy", "torch", "svt_bench"}
    for name in ("plan7_reference.py", "structures/plan7_profile.py"):
        assert top_level_imports(HERE / name) <= allowed


def test_fill_share_reader(monkeypatch):
    from spec_viterbi_tpu_torch.ops import tropical

    read = load_module("metrics", "dense.fill_share").read
    monkeypatch.setattr(tropical, "dense_work", {"launched": 1024**2 * 512 * 3499,
                                                 "real": 127_749 * 512 * 3499})
    assert read(None) == pytest.approx(12.1831, abs=1e-4)
    monkeypatch.setattr(tropical, "dense_work", {"launched": 0, "real": 0})
    assert read(None) is None
    monkeypatch.delattr(tropical, "dense_work")
    assert read(None) is None


def test_traced_cpu_run_of_the_plan7_cell():
    from spec_viterbi_tpu_torch.ops import tropical

    # 40 nodes: 81 states padded to 128, 1,019 transitions, dense mode; the
    # counter starts at 0, as in a run's own process
    tropical.reset_launches()
    cell = tiny.cell("plan7_500.scores.uniform", keep=1)
    result = run_cell(cell, 2**31 + 17, 0.3, True, "cpu", time.perf_counter())
    metrics = result["metrics"]
    assert result["correct"] is True
    for name in ("host.plan_ms", "host.build_ms", "host.stage_ms", "host.launch_ms",
                 "host.fetch_ms"):
        assert metrics[name]["value"] > 0, name
    assert metrics["dense.fill_share"] == {"value": 100 * 1019 / 128**2, "unit": "%"}


def test_cpu_run_of_the_path_ragged_cell():
    cell = tiny.cell("msv2405.path.ragged", lanes=160, length=90, keep=2, sample=24)
    result = run_cell(cell, 2**31 + 19, 0.3, False, "cpu", time.perf_counter())
    assert result["correct"] is True
    assert result["checks"]["path_mismatches"] == {"value": 0, "limit": 0}
