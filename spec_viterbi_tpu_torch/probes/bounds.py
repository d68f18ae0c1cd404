"""The least time an H100 could take for a kernel's work: its bound.

``bound = max(ops / op rate, bytes / HBM rate)``, from the H100 SXM data
sheet at 700 W:

- bytes over 3.35 TB/s, each input byte counted once and each output
  byte once, whatever the kernel reads again;
- f32 adds and mins over 33.45 T/s: one such operation per FP32 lane per
  clock, 132 SMs x 128 lanes x 1.98 GHz, half the 67 TFLOP/s FMA rate
  (a min-plus step has no multiply to fuse).

Only the work that the function needs is counted, not what a kernel
chooses to do for it: the one-hot products of ``svt_probe_emsel``'s
tensor-core schemes compute a select that one read gives, so they are
left out of its bound (:func:`emsel_mma_ms` gives their time apart).

Counts follow the recurrence per (state, step, lane), one count per
operator whatever kernel runs it (:func:`operator_step`: the uniform
plans' count where the operator has them); where lanes stop early the
steps they take are counted, not the most they could take. The few
special rows patched by one warp are left out (40 of 2,432 rows at
most). What no bound shows is the chain: each step waits for the last
through a barrier; ``chip_smoke.py`` measures that as the chain floor
(the ``empty`` probe's time a step).
"""

from __future__ import annotations

import dataclasses

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 132 * 128 * 1.98e9
TENSOR_OPS_PER_S = {"bf16": 989e12, "tf32": 495e12}  # dense, H100 SXM data sheet
F32, I32, I16, BF16 = 4, 4, 2, 2


@dataclasses.dataclass(frozen=True)
class Work:
    ops: float  # f32 adds and mins
    bytes: float

    def bound(self) -> tuple[float, str]:
        """(bound in ms, "operations" or "bytes")."""
        op_s = self.ops / F32_OPS_PER_S
        byte_s = self.bytes / HBM_BYTES_PER_S
        return max(op_s, byte_s) * 1e3, ("operations" if op_s >= byte_s else "bytes")


def _carry_bytes(n: int, lanes: int) -> int:
    return 2 * n * lanes * F32  # v0 in, scores out


@dataclasses.dataclass(frozen=True)
class Step:
    """One operator's step as every bound of a scores or path kernel counts
    it, whichever kernel or arm runs it: the padded state count, the f32
    operations one state takes a step, and the bytes of the operator's
    tables (each read once)."""

    n: int
    ops_per_state: int
    table_bytes: int


def operator_step(n: int, n_diag: int, n_row: int, n_col: int, planned: bool) -> Step:
    """The one count of an operator. With both uniform plans (``planned``:
    the FS class, ``FusedStructuredDecoder._fs`` exists) a state takes the
    diagonal add, the min with the uniform rows' scalar candidate, the
    emission add and the shared column's min: 4, with the diagonal and a
    byte of flags a state as its tables. Without them, an add and a min per
    diagonal, dense row and dense column, and the emission add, with their
    value vectors as its tables. The few special rows are left out."""
    if planned:
        return Step(n, 4, n * (F32 + 1))
    return Step(n, 2 * (n_diag + n_row + n_col) + 1, (n_diag + n_row + n_col) * n * F32)


def masked_scores(step: Step, lanes: int, steps: int, lane_steps: int, em_rows: int,
                  lengths: bool) -> Work:
    """``svt_scores_masked`` (either arm; and ``svt_scores_variant`` with no
    flag): ``step``'s work per state and lane step, where ``lane_steps`` is
    the steps the lanes take in all."""
    nbytes = (_carry_bytes(step.n, lanes) + steps * lanes * I32 + (lanes * I32 if lengths else 0)
              + em_rows * step.n * F32 + step.table_bytes)
    return Work(step.ops_per_state * step.n * lane_steps, nbytes)


def fs_scores(step: Step, lanes: int, steps: int, em_rows: int) -> Work:
    """``svt_scores_fs``: the unmasked scores work, every lane every step."""
    return masked_scores(step, lanes, steps, lanes * steps, em_rows, False)


def path(step: Step, lanes: int, steps: int, lane_steps: int, em_rows: int,
         lengths: bool) -> Work:
    """``svt_path`` (either arm): the scores work plus one int16 pointer per
    state, lane and step (frozen steps write identity pointers)."""
    base = masked_scores(step, lanes, steps, lane_steps, em_rows, lengths)
    return Work(base.ops, base.bytes + steps * lanes * step.n * I16)


def backtrace(lanes: int, steps: int) -> Work:
    """``svt_backtrace``: one int16 pointer read and one int32 state
    written per lane and step (the walk reads one pointer of each row)."""
    return Work(0.0, steps * lanes * (I16 + I32) + lanes * I32)


def window_scores(n_diag: int, n_win: int, windows: int, n_global: int, lanes: int,
                  steps: int, launches: int, em_rows: int) -> Work:
    """``launches`` launches of ``svt_scores_window`` over ``steps`` steps
    in all: the banded step on every window row, and each launch reads
    and writes the [n_global, B] carry."""
    per = 2 * n_diag + 1
    nbytes = (launches * _carry_bytes(n_global, lanes) + steps * lanes * I32
              + launches * lanes * I32 + (em_rows + n_diag) * n_global * F32)
    return Work(per * n_win * windows * lanes * steps, nbytes)


def window_path(n_diag: int, n_win: int, windows: int, n_global: int, lanes: int, steps: int,
                launches: int, em_rows: int, block: int) -> Work:
    """``svt_path_window``: the scores window work plus one int16 pointer
    per interior row (``windows`` x ``block`` of them), lane and step."""
    base = window_scores(n_diag, n_win, windows, n_global, lanes, steps, launches, em_rows)
    return Work(base.ops, base.bytes + steps * lanes * windows * block * I16)


def probe_pass(cls: str, n: int, lanes: int, steps: int, p: int, e: int = 32) -> Work:
    """``svt_probe_pass``: ``v + 0.5`` and, per pass, a candidate add and
    a min (emission: a min of the row read); colred adds the final min;
    twosym, per composed step, 22 (the diagonal add, five rank-1 applies of
    four each, the emission add); chase reads one pointer a hop and adds
    nothing."""
    nbytes = _carry_bytes(n, lanes)
    if cls in ("chase", "chase_hbm"):
        # a pointer read a hop, and the shared table once
        return Work(0.0, nbytes + steps * p * lanes * I16 + (n * I16 if cls == "chase" else 0))
    if cls == "twosym":
        return Work(22 * n * lanes * (steps // 2),
                    nbytes + steps * lanes * I32 + 12 * e * n * F32)
    per = {"empty": 1, "stream": 1 + 2 * p, "neighbour": 1 + 2 * p, "bcast": 1 + 2 * p,
           "colred": 2 + 2 * p, "emission": 1 + p}[cls]
    if cls in ("stream", "neighbour", "bcast", "colred"):
        nbytes += p * n * F32
    if cls == "stream":
        nbytes += p * n * F32
    if cls == "emission":
        nbytes += steps * lanes * I32 + e * n * F32
    return Work(per * n * lanes * steps, nbytes)


def probe_emsel(scheme: str, n: int, lanes: int, steps: int, p: int, e: int = 32) -> Work:
    """``svt_probe_emsel``: ``v + 0.5`` and a min per select, in f32,
    whatever the scheme; the bytes of the scheme's table terms."""
    terms = {"gather": 1, "tf32": 1, "bf16": 1, "split2": 2, "split3": 3}[scheme]
    elem = F32 if scheme in ("gather", "tf32") else BF16
    nbytes = _carry_bytes(n, lanes) + steps * lanes * I32 + terms * e * n * elem
    return Work((1 + p) * n * lanes * steps, nbytes)


def emsel_mma_ms(scheme: str, n: int, lanes: int, steps: int, p: int, e: int = 32) -> float:
    """The tensor-core time of ``svt_probe_emsel``'s one-hot products at
    the type's peak: 2·e multiply-adds per state, lane, select and table
    term (0 for ``gather``). Not part of the bound: the select they
    compute needs none of them."""
    terms = {"gather": 0, "tf32": 1, "bf16": 1, "split2": 2, "split3": 3}[scheme]
    kind = "tf32" if scheme == "tf32" else "bf16"
    return 2 * e * terms * p * n * lanes * steps / TENSOR_OPS_PER_S[kind] * 1e3


def minplus(g: int, i: int, k: int, j: int, a_operators: int, argmin: bool = False,
            gathered: bool = False) -> Work:
    """``svt_minplus``, ``C[g] = A_g ⊗ B[g]``: an add and a min per
    candidate, 2·G·I·K·J; the ``a_operators`` distinct [I, K] operators the
    products read (1 when shared; for a gathered launch the distinct
    indices this launch's data holds), B read and C written once, the int32
    argmin and the int64 index vector where there is one. All bytes go at
    the HBM rate: a launch whose operator a previous launch left in the
    50 MB L2 can beat this (the data sheet gives no L2 rate), so a time
    held to it must read its operator from HBM."""
    nbytes = (a_operators * i * k + g * k * j + g * i * j) * F32
    if argmin:
        nbytes += g * i * j * I32
    if gathered:
        nbytes += g * 8
    return Work(2.0 * g * i * k * j, nbytes)
