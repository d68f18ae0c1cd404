"""The one traffic generator: a mix's data file in, a seeded pool of batches
out.

A mix (``traffic/<mix>.json``) holds only parameters:

- ``entry``: the program entry the calls go through (``entries/<entry>.py``);
- ``paths``: whether the calls ask for exact paths;
- ``lanes``: sequences a call;
- ``lengths``: ``{"kind": "fixed", "value": T}``, or ``{"kind": "list",
  "values": [...]}``: a published set of lengths, repeated until it fills
  the ``lanes``; the same set in every batch and every seed, in a seeded
  order (so the seed changes which lane is long, never how much work a
  batch holds). Further keys, such as the set's ``source``, are notes;
- ``pool``: distinct batches made before the window; the calls go through
  them in turn;
- ``keep``: lanes of every call whose answers are kept for the check;
- ``sample``: answers checked against the reference after the window;
- ``block``: lanes a block of the reference.

Symbols are drawn uniformly over the model's alphabet, as the reference
corpus's ``ess_gen.py`` draws them.
"""

from __future__ import annotations

import numpy as np

TRAFFIC_STREAM = 1  # the sub-stream of the seed that draws the pool


def lengths_of(spec: dict, lanes: int) -> np.ndarray:
    """The sorted set of sequence lengths of one batch."""
    kind = spec["kind"]
    if kind == "fixed":
        return np.full(lanes, int(spec["value"]), np.int64)
    if kind == "list":
        return np.sort(np.resize(np.asarray(spec["values"], np.int64), lanes))
    raise ValueError(f"unknown length law {kind!r}")


def pool(mix: dict, symbols: int, seed: int) -> list[list[np.ndarray]]:
    """``mix["pool"]`` batches of ``mix["lanes"]`` int32 sequences."""
    rng = np.random.default_rng([seed, TRAFFIC_STREAM])
    lanes = int(mix["lanes"])
    base = lengths_of(mix["lengths"], lanes)
    batches = []
    for _ in range(int(mix["pool"])):
        lens = rng.permutation(base)
        flat = rng.integers(0, symbols, size=int(lens.sum()), dtype=np.int32)
        cuts = np.cumsum(lens)[:-1]
        batches.append(np.split(flat, cuts))
    return batches
