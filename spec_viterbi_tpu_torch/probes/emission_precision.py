"""S2: the emission-select ladder of ``scripts/exp_mxu_precision.py``, on
the H100.

The TPU has no per-lane gather, so its kernels select the emission row of
each lane with a dot against a one-hot on the MXU, and the precision of
that dot was the question: ``micro_mxu_prec`` times P selects a step per
scheme and takes the marginal cost of one (P = 2 minus P = 1). The card
can read the row directly; ``svt_probe_emsel`` times that read beside
the tensor-core selects, at the production shape (2,432 states, 512
lanes, 3,488 steps, a finite normal(6, 1) table of 32 rows), 8 lanes a
CTA in every scheme:

===========  ===========================  ==========================
this probe   the TPU scheme               what the select returns
===========  ===========================  ==========================
``gather``   ``highest`` (f32 HIGHEST)    the exact f32 entry
``tf32``     none (Mosaic has no HIGH)    the entry rounded to tf32
``bf16``     ``default`` and ``bf16``     the entry rounded to bf16
``split2``   ``split2``                   hi + lo, 16 mantissa bits
``split3``   ``split3``                   hi + lo + lo2, the f32 entry
===========  ===========================  ==========================

On the TPU ``DEFAULT`` precision is one bf16 pass, hence ``default`` ↔
``bf16``; ``highest`` and ``gather`` both give the exact select.
"""

from __future__ import annotations

from spec_viterbi_tpu_torch.ops import probes
from spec_viterbi_tpu_torch.probes.common import LANES, N_STATES, T_SUB, PassInputs, Record, median_ms

TPU_SCHEME = {"gather": "highest", "tf32": None, "bf16": "default", "split2": "split2",
              "split3": "split3"}
PASSES = (1, 2)


def emsel_call(inp: PassInputs, scheme: str, p: int, steps: int):
    tabs = probes.emsel_tables(inp.em, scheme)
    return lambda: probes.probe_emsel(scheme, tabs, inp.v0, inp.obs, steps, p)


def run(rec: Record, device, seed: int = 0, inp: PassInputs | None = None) -> dict:
    """µs per step at P = 1 and 2 and the marginal µs per select, per
    scheme."""
    inp = inp or PassInputs.make(N_STATES, LANES, T_SUB, seed, device)
    out = {}
    for scheme in probes.EMSEL_SCHEMES:
        steps = inp.obs.shape[0]
        ts = {p: median_ms(emsel_call(inp, scheme, p, steps)) * 1e3 / steps for p in PASSES}
        out[scheme] = rec.emit(
            f"emsel_{scheme}", tpu_scheme=TPU_SCHEME[scheme], us_p1=ts[1], us_p2=ts[2],
            marginal_us_per_select=ts[2] - ts[1], lanes=inp.v0.shape[1], steps=steps)
    return out
