"""The frozen count against the hand sums."""

from __future__ import annotations

import numpy as np
import pytest

from svt_bench import counts
from svt_bench.harness import load_json
from svt_bench.structures import msv_profile


# adds: one a finite transition and one a state's emission; mins: d - 1 for a
# state with d finite incoming transitions (every state of an MSV profile has some)
@pytest.mark.parametrize("name,per_symbol", [("msv2405", 9621 + (9621 - 2407) + 2407),
                                             ("msv500", 2001 + (2001 - 502) + 502)])
def test_operations_a_symbol(name, per_symbol):
    arrays = msv_profile.build(load_json("configs", name), seed=3)
    assert counts.ops_per_symbol(arrays) == per_symbol
    assert per_symbol in (19_242, 4_002)


def test_mins_skip_states_with_no_way_in():
    # 4 states; state 1 has 3 finite ways in, state 2 one, state 3 none (its one is +inf)
    arrays = {"states": 4, "src": np.array([0, 2, 3, 1, 0]), "dst": np.array([1, 1, 1, 2, 3]),
              "cost": np.array([1.0, 2.0, 0.5, 1.0, np.inf], np.float32)}
    assert counts.ops_per_symbol(arrays) == 4 + (3 - 1) + (1 - 1) + 4


def test_work_of_a_call():
    arrays = msv_profile.build(load_json("configs", "msv2405"), seed=3)
    lengths = np.full(512, 3500)
    ops, nbytes = counts.work(arrays, lengths, paths=False)
    assert ops == 19_242 * 3499 * 512
    tables = (9621 * 3 + 20 * 2407 + 2) * 4
    assert nbytes == 512 * 3500 * 4 + 512 * 2407 * 4 + tables
    ops_p, bytes_p = counts.work(arrays, lengths, paths=True)
    assert ops_p == ops and bytes_p == nbytes + 512 * 3500 * 4
    seconds, which = counts.bound_s(ops, nbytes)
    assert which == "operations" and seconds == pytest.approx(ops / 33.45408e12, rel=1e-6)
    # a one-symbol sequence adds no operation, two calls read the tables twice
    ops2, bytes2 = counts.work(arrays, [1, 1], paths=False, calls=2)
    assert ops2 == 0 and bytes2 == 2 * 4 + 2 * 2407 * 4 + 2 * tables
