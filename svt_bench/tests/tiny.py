"""Small cells for the tests: the real configurations' structure and the
real mixes' laws at sizes a CPU run holds."""

from __future__ import annotations

import dataclasses

from svt_bench.harness import Cell


def cell(name: str = "msv2405.scores.uniform", lanes: int = 16, length: int = 60,
         match_states: int = 40, **mix) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` cut to ``lanes`` lanes, its
    lengths to ``length`` (a list's longest) and its model to
    ``match_states``; every answer kept, a sample of up to 64."""
    c = Cell.load(name)
    lengths = dict(c.mix["lengths"])
    if lengths["kind"] == "fixed":
        lengths["value"] = length
    else:  # a list: scaled so that its longest is ``length``
        top = max(lengths["values"])
        lengths["values"] = [max(1, v * length // top) for v in lengths["values"]]
    new_mix = {**c.mix, "lanes": lanes, "lengths": lengths, "pool": 2, "keep": lanes,
               "sample": 64, "block": 8, **mix}
    config = {**c.config, "match_states": match_states}
    return dataclasses.replace(c, mix=new_mix, config=config)
