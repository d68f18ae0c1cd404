"""Core HMM data model in modified-probability (−log2) space.

A copy of ``spec_viterbi_tpu/hmm.py``'s numpy layer (that package imports
jax on import, and the port must run where jax is absent);
``tests/test_torch_host.py`` holds the two equal. Probabilities are stored
as ``−log2(p)``; ``p == 0`` maps to ``+inf``, the (min,+) semiring zero.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math

import numpy as np

MOD_PROB_DTYPE = np.float32

# The (min,+) semiring zero: probability 0 → +inf.
ZERO_PROB = float("inf")

# Fuzzy-equality delta in −log2 space (the reference's ±1.0 contract).
ALMOST_EQUAL_DELTA = 1.0

# The state dimension is padded to a multiple of this. The port keeps the
# JAX package's width so both build the identical structured operator.
LANE = 128


def to_modified_prob(p: float) -> float:
    """``−log2(p)`` for p > 0, else the semiring zero ``+inf``."""
    if p > 0.0:
        return -math.log2(p)
    return ZERO_PROB


def to_modified_prob_np(p: np.ndarray) -> np.ndarray:
    """Vectorized :func:`to_modified_prob`."""
    p = np.asarray(p, dtype=np.float64)
    out = np.full(p.shape, ZERO_PROB, dtype=MOD_PROB_DTYPE)
    pos = p > 0.0
    out[pos] = (-np.log2(p[pos])).astype(MOD_PROB_DTYPE)
    return out


def almost_equal(x: float, y: float, delta: float = ALMOST_EQUAL_DELTA) -> bool:
    """Both +inf, or ``|x−y| ≤ delta``."""
    if math.isinf(x) and math.isinf(y) and x > 0 and y > 0:
        return True
    return abs(x - y) <= delta


def almost_equal_vec(
    x: np.ndarray, y: np.ndarray, delta: float = ALMOST_EQUAL_DELTA
) -> bool:
    """Both +inf, or ``|x−y| ≤ delta``, elementwise."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    if x.shape != y.shape:
        return False
    both_inf = np.isposinf(x) & np.isposinf(y)
    with np.errstate(invalid="ignore"):  # inf - inf → nan is handled by both_inf
        close = np.abs(x - y) <= delta
    return bool(np.all(both_inf | close))


def validate_obs_seq(seq, emit_num: int) -> np.ndarray:
    """Validate an observation sequence against the model's alphabet.

    Returns the sequence as a contiguous int32 array. Raises ``ValueError``
    on any symbol outside ``[0, emit_num)``: the CUDA kernels index the
    emission table by symbol, so an unchecked symbol is an out-of-bounds
    device read, not just a wrong answer.
    """
    arr = np.ascontiguousarray(np.asarray(seq, dtype=np.int32))
    if arr.ndim != 1:
        raise ValueError(f"observation sequence must be 1-D, got shape {arr.shape}")
    if arr.size:
        lo, hi = int(arr.min()), int(arr.max())
        if lo < 0 or hi >= emit_num:
            raise ValueError(
                f"observation symbol out of range: sequence contains "
                f"{lo if lo < 0 else hi} but the model emits {emit_num} "
                f"symbols (0..{emit_num - 1}) — mismatched .chmm/.ess pair?"
            )
    return arr


def pad_to_lane(n: int, lane: int = LANE) -> int:
    """Round ``n`` up to a multiple of ``lane`` (min ``lane``)."""
    return max(lane, ((n + lane - 1) // lane) * lane)


@dataclasses.dataclass
class HMM:
    """An HMM in −log2 space; the fields are what a ``.chmm`` file carries.

    - ``states_num`` / ``emit_num``: state and alphabet sizes.
    - COO transitions ``trans_rows`` (src), ``trans_cols`` (dst),
      ``trans_probs`` (−log2).
    - ``emissions[symbol, state]`` (−log2), transposed from the file layout.
    - sparse start distribution ``start_probabilities_cols`` /
      ``start_probabilities`` (−log2).
    """

    states_num: int = 0
    emit_num: int = 0
    trans_rows: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, dtype=np.int64)
    )
    trans_cols: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, dtype=np.int64)
    )
    trans_probs: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, dtype=MOD_PROB_DTYPE)
    )
    emissions: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0, 0), dtype=MOD_PROB_DTYPE)
    )
    start_probabilities_cols: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, dtype=np.int64)
    )
    start_probabilities: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, dtype=MOD_PROB_DTYPE)
    )

    @property
    def trans_num(self) -> int:
        return int(self.trans_rows.shape[0])

    @property
    def non_zero_start_probs(self) -> int:
        return int(self.start_probabilities_cols.shape[0])

    def transition_matrix(self, pad_to: int | None = None) -> np.ndarray:
        """Dense ``[N, N]`` matrix ``A[src, dst]``; missing edges are
        ``+inf`` and duplicate COO entries take the min."""
        n = pad_to if pad_to is not None else self.states_num
        mat = np.full((n, n), ZERO_PROB, dtype=MOD_PROB_DTYPE)
        if self.trans_num:
            np.minimum.at(
                mat,
                (self.trans_rows, self.trans_cols),
                self.trans_probs.astype(MOD_PROB_DTYPE),
            )
        return mat

    def transposed_transition_matrix(self, pad_to: int | None = None) -> np.ndarray:
        """Dense ``Aᵀ[dst, src]``, the operator the recurrence multiplies by."""
        return self.transition_matrix(pad_to=pad_to).T.copy()

    def start_vector(self, pad_to: int | None = None) -> np.ndarray:
        """Dense start column π in −log2 space, default ``+inf``."""
        n = pad_to if pad_to is not None else self.states_num
        vec = np.full(n, ZERO_PROB, dtype=MOD_PROB_DTYPE)
        if self.non_zero_start_probs:
            np.minimum.at(
                vec,
                self.start_probabilities_cols,
                self.start_probabilities.astype(MOD_PROB_DTYPE),
            )
        return vec

    def emission_matrix(self, pad_to: int | None = None) -> np.ndarray:
        """Dense ``[emit_num, N]`` emission rows, padded states are ``+inf``."""
        n = pad_to if pad_to is not None else self.states_num
        mat = np.full((self.emit_num, n), ZERO_PROB, dtype=MOD_PROB_DTYPE)
        mat[:, : self.states_num] = self.emissions
        return mat

    @property
    def padded_states(self) -> int:
        """The state count rounded up to a multiple of ``LANE``."""
        return pad_to_lane(self.states_num)

    def fingerprint(self) -> str:
        """Stable content hash, the operator cache's key (the JAX package's
        hash, so both packages key a model alike). Shape and dtype delimit
        each array, and index arrays hash as int64, floats as float32."""
        h = hashlib.sha256()
        h.update(np.int64([self.states_num, self.emit_num, self.trans_num]).tobytes())
        for arr in (
            self.trans_rows,
            self.trans_cols,
            self.trans_probs,
            self.emissions,
            self.start_probabilities_cols,
            self.start_probabilities,
        ):
            a = np.ascontiguousarray(arr)
            canon = (
                a.astype(np.int64) if np.issubdtype(a.dtype, np.integer)
                else a.astype(np.float32)
            )
            h.update(repr((canon.shape, str(canon.dtype))).encode())
            h.update(canon.tobytes())
        return h.hexdigest()[:32]

    def validate(self) -> None:
        """Structural sanity checks (bounds, shapes)."""
        n, e = self.states_num, self.emit_num
        if self.emissions.shape != (e, n):
            raise ValueError(
                f"emissions shape {self.emissions.shape} != ({e}, {n})"
            )
        for name, idx, bound in (
            ("trans_rows", self.trans_rows, n),
            ("trans_cols", self.trans_cols, n),
            ("start_probabilities_cols", self.start_probabilities_cols, n),
        ):
            if idx.size and (idx.min() < 0 or idx.max() >= bound):
                raise ValueError(f"{name} has out-of-range state index")
        if self.trans_rows.shape != self.trans_cols.shape or self.trans_rows.shape != self.trans_probs.shape:
            raise ValueError("COO transition arrays have mismatched lengths")
        if self.start_probabilities_cols.shape != self.start_probabilities.shape:
            raise ValueError("start probability arrays have mismatched lengths")
