"""S4: the ablation of ``scripts/exp_kernel_variants.py``, on the H100.

``svt_scores_variant`` launches the template of ``svt_scores_masked``'s
generic arm (``csrc/generic.cuh``) with compile-time flags; each ablation
drops one component of the step (wrong scores on purpose), and its time
against the baseline's is that component's cost. Timed on the
corpus-shaped stand-in at 512 × 3,500, unmasked (a uniform batch), with
the generic arm forced, as the TPU harness timed its variants:

- ``baseline``: no flag, ``svt_scores_masked`` itself; held bit-equal to
  it, and its time beside that kernel's shows the spread of a timing;
- ``no_cols``: no dense-column folds and merges;
- ``no_em``: one constant emission row (the TPU's ``no_mxu``);
- ``no_special``: no column folds, no residual candidates, no patch warp
  (the step has one barrier either way);
- ``short_chain``: the emission folded into the candidates before the
  carry is read (``make_shortchain_kernel``).

Two TPU flags have no counterpart: ``slice_roll`` chose between two
Mosaic lowerings of a shift, where a CUDA loop reads ``cur[i - d]``; and
``unroll3`` set the steps per grid cell, a TPU grid parameter.
"""

from __future__ import annotations

import torch

from spec_viterbi_tpu_torch.ops import fused, probes
from spec_viterbi_tpu_torch.probes.common import (
    LANES,
    STATES_MATCH,
    T_LEN,
    CorpusBatch,
    Record,
    median_ms,
)

VARIANTS = ("baseline", "no_cols", "no_em", "no_special", "short_chain")


def run(rec: Record, device, seed: int = 0, corpus: CorpusBatch | None = None) -> dict:
    corpus = corpus or CorpusBatch.make(STATES_MATCH, LANES, T_LEN, seed, device)
    fd = corpus.fd
    steps = corpus.obs.shape[0]
    masked_ms = median_ms(lambda: fused.scores_masked(fd._masked, fd.em, corpus.v0, corpus.obs, None))
    out = {}
    base_us = None
    for name in VARIANTS:
        t = probes.VariantTables.build(fd._masked, fd.em, probes.variant_flag(name))
        ms = median_ms(lambda: probes.scores_variant(t, corpus.v0, corpus.obs, None))
        us = ms * 1e3 / steps
        extra = {}
        if name == "baseline":
            base_us = us
            same = torch.equal(probes.scores_variant(t, corpus.v0, corpus.obs, None),
                               fused.scores_masked(fd._masked, fd.em, corpus.v0, corpus.obs, None))
            if not same:
                raise RuntimeError("the all-off variant differs from svt_scores_masked")
            extra = {"equal_to_scores_masked": same, "scores_masked_us_per_step": masked_ms * 1e3 / steps}
        out[name] = rec.emit(f"variant_{name}", us_per_step=us, saved_us_per_step=base_us - us,
                             lanes=corpus.v0.shape[1], steps=steps, **extra)
    return out
