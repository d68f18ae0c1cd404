"""The seeded traffic: the same for a seed, different across seeds, and
the same work in every batch and every seed."""

from __future__ import annotations

import numpy as np
import pytest

from svt_bench import generate
from svt_bench.harness import load_json

MIXES = ["scores.uniform", "scores.ragged", "path.uniform"]


def small(mix: str) -> dict:
    return {**load_json("traffic", mix), "pool": 3}


@pytest.mark.parametrize("mix", MIXES)
def test_same_seed_same_pool(mix):
    a, b = generate.pool(small(mix), 20, 2**31 + 7), generate.pool(small(mix), 20, 2**31 + 7)
    assert all(np.array_equal(x, y) for ba, bb in zip(a, b) for x, y in zip(ba, bb))


@pytest.mark.parametrize("mix", MIXES)
def test_seeds_and_batches_differ(mix):
    a, b = generate.pool(small(mix), 20, 1), generate.pool(small(mix), 20, 2)
    assert not np.array_equal(np.concatenate(a[0]), np.concatenate(b[0]))
    assert not np.array_equal(np.concatenate(a[0]), np.concatenate(a[1]))


@pytest.mark.parametrize("mix", MIXES)
def test_every_batch_holds_the_same_lengths(mix):
    spec = small(mix)
    want = sorted(generate.lengths_of(spec["lengths"], spec["lanes"]))
    for seed in (5, 6):
        for batch in generate.pool(spec, 20, seed):
            assert len(batch) == spec["lanes"]
            assert sorted(len(s) for s in batch) == want
            assert all(s.dtype == np.int32 and s.min() >= 0 and s.max() < 20 for s in batch)


def test_ragged_law():
    mix = load_json("traffic", "scores.ragged")
    lens = generate.lengths_of(mix["lengths"], mix["lanes"])
    # the 12 proteins of the SARS-CoV-2 reference proteome, 42 copies each
    assert len(lens) == 504 and lens.min() == 38 and lens.max() == 7096
    assert lens.sum() == 42 * 14_149
    assert sorted(set(lens.tolist())) == sorted(set(mix["lengths"]["values"]))
    orders = [[len(s) for s in generate.pool(small("scores.ragged"), 20, seed)[0]] for seed in (1, 2)]
    assert orders[0] != orders[1]
