"""The control: the reference in bfloat16 put in the program's place must
come out not correct; the reference in float32 and the program itself must
come out correct. On the CPU at a small size, and on the card at the cells'
own shapes."""

from __future__ import annotations

import dataclasses
import time

import pytest
import torch

from svt_bench import control
from svt_bench.harness import Cell, run_cell
from svt_bench.tests import tiny

CELLS = ["msv2405.scores.uniform", "msv500.scores.uniform", "msv2405.scores.ragged",
         "msv2405.path.uniform"]


class F32Entry(control.Bf16Entry):
    @staticmethod
    def setup(arrays, mix, device):
        state = control.Bf16Entry.setup(arrays, mix, device)
        state["model"] = control.reference.Model(arrays, device)
        return state


def small(name):
    return tiny.cell(name, lanes=160 if "ragged" in name else 16, length=120)


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    cell = small(name)
    for seed in (1, 2, 3):
        result = run_cell(cell, seed, 0.0, False, "cpu", time.perf_counter(), entry=control.Bf16Entry)
        assert result["correct"] is False
        assert result["checks"]["score_mismatches"]["value"] > 0


@pytest.mark.parametrize("name", CELLS)
def test_float32_reference_and_program_are_correct(name):
    cell = small(name)
    for entry in (F32Entry, None):
        result = run_cell(cell, 4, 0.0, False, "cpu", time.perf_counter(), entry=entry)
        assert result["correct"] is True


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cell = Cell.load(name)
    cell = dataclasses.replace(cell, mix={**cell.mix, "lanes": 128, "sample": 128})
    for seed in (11, 12, 13):
        assert control.readings(cell, seed, "cuda:0")["correct"] is False
    assert control.readings(cell, 14, "cuda:0", program=True)["correct"] is True
