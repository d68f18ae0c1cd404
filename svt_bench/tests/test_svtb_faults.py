"""A run with the timed path broken underneath comes out not correct, once
for each fault a cell can have: a step that returns its state unchanged; half
of the batch left out, the mean taken over the rest; an answer altered where
it is produced. The cells run on one card, so no exchange between chips can
be left out. The run skips the look for a card and decodes on the CPU, where
the program takes its plain structured loop (``ops/structured.py``)."""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

import spec_viterbi_tpu_torch.models.decoder as decoder
from spec_viterbi_tpu_torch.models.decoder import ViterbiDecoder
from svt_bench.harness import run_cell
from svt_bench.tests import tiny

SCORES = ["msv2405.scores.uniform", "msv500.scores.uniform", "msv2405.scores.ragged"]
PATHS = ["msv2405.path.uniform"]


def run(name):
    cell = tiny.cell(name, lanes=160 if "ragged" in name else 16, length=80)
    return run_cell(cell, 2**31 + 3, 0.0, False, "cpu", time.perf_counter())


def stale_step(real):
    def scores(op, arrs, em_t, v0, obs, lengths):
        return real(op, arrs, em_t, v0, obs[:-1], lengths)  # the last step leaves the state
    return scores


def half_batch(v):
    h = v.shape[1] // 2
    v = v.clone()
    v[:, h:] = v[:, :h].mean(dim=1, keepdim=True)
    return v


def altered(v):
    v = v.clone()
    v[1] = torch.nextafter(v[1], torch.full_like(v[1], float("inf")))  # one ulp, every lane
    return v


@pytest.mark.parametrize("name", SCORES)
@pytest.mark.parametrize("fault", ["stale_step", "half_batch", "altered"])
def test_scores_faults(monkeypatch, name, fault):
    assert run(name)["correct"] is True
    real = decoder.structured_scores_batch
    if fault == "stale_step":
        monkeypatch.setattr(decoder, "structured_scores_batch", stale_step(real))
    else:
        post = half_batch if fault == "half_batch" else altered
        monkeypatch.setattr(decoder, "structured_scores_batch", lambda *a: post(real(*a)))
    assert run(name)["correct"] is False


@pytest.mark.parametrize("name", PATHS)
@pytest.mark.parametrize("fault", ["stale_step", "half_batch", "altered"])
def test_path_faults(monkeypatch, name, fault):
    assert run(name)["correct"] is True
    if fault == "stale_step":
        real = decoder.structured_path_batch

        def path(op, arrs, em_t, v0, obs, lengths, ptr_dtype, base=0):
            v, src = real(op, arrs, em_t, v0, obs[:-1], lengths, ptr_dtype, base)
            ident = torch.arange(src.shape[2], dtype=src.dtype).expand(1, *src.shape[1:])
            return v, torch.cat([src, ident])  # the last step leaves the state and points home
        monkeypatch.setattr(decoder, "structured_path_batch", path)
    elif fault == "half_batch":
        real = ViterbiDecoder.decode_path_batch

        def batch(self, seqs):
            h = len(seqs) // 2
            done = real(self, seqs[:h])
            mean = np.mean([s for s, _ in done], axis=0).astype(np.float32)
            return done + [(mean, done[0][1][: len(s)]) for s in seqs[h:]]
        monkeypatch.setattr(ViterbiDecoder, "decode_path_batch", batch)
    else:
        real = decoder.fused.backtrace_plain

        def walk(src, boundary):
            rev = real(src, boundary)
            rev[0] = (rev[0] + 1) % src.shape[2]  # the first state of every path
            return rev
        monkeypatch.setattr(decoder.fused, "backtrace_plain", walk)
    assert run(name)["correct"] is False
