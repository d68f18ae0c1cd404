"""H100 probes: where a step of the port's scores kernels goes.

The counterparts of the TPU probes under ``scripts/`` (each a function
that reaches ``pl.pallas_call``), built on the probe kernels of
``csrc/probes.cu`` and the flagged masked kernel of ``csrc/scores.cu``
(wrappers in :mod:`spec_viterbi_tpu_torch.ops.probes`):

- :mod:`.roofline` (S1, ``scripts/exp_roofline.py``): per-pass costs, the
  speed-of-light sum, bf16 operands, the two-symbol step, staged
  emissions;
- :mod:`.emission_precision` (S2, ``scripts/exp_mxu_precision.py``): the
  emission select per scheme;
- :mod:`.laneblock` (S3, ``scripts/exp_fs_laneblock2.py``): the empty
  floor at 1, 2 and 4 lanes a CTA, the FS kernel at 512 and 1,024 lanes,
  the chain floors (the empty step; the backtrace's pointer hop, ``chase``);
- :mod:`.kernel_variants` (S4, ``scripts/exp_kernel_variants.py``): the
  ablated masked kernel;
- :mod:`.bounds`: the least time the card could take for a kernel's work;
- :mod:`.emulation`: the redesigned kernels' step orders in torch (the
  staged backtrace's misses, the one-barrier FS step).

``python3 -m spec_viterbi_tpu_torch.probes [--stage ...] [--out DIR]``
runs them on the card, one JSON line per measurement. They measure; no
serving path calls them.
"""

from __future__ import annotations

from spec_viterbi_tpu_torch.probes import emission_precision, kernel_variants, laneblock, roofline
from spec_viterbi_tpu_torch.probes.common import (
    LANES,
    N_STATES,
    STATES_MATCH,
    T_LEN,
    T_SUB,
    CorpusBatch,
    PassInputs,
    Record,
)

STAGES = {
    "roofline": roofline.run,
    "emission_precision": emission_precision.run,
    "laneblock": laneblock.run,
    "kernel_variants": kernel_variants.run,
}


def run_all(rec: Record, device, seed: int = 0, stages=tuple(STAGES),
            corpus: CorpusBatch | None = None) -> dict:
    """Run ``stages`` in order on ``device``, sharing the seeded pass
    inputs and the corpus-shaped batch (``corpus``, else a seeded one of
    512 × 3,500 on ``generate_profile_hmm(2405)``); returns each stage's
    results."""
    inp = PassInputs.make(N_STATES, LANES, T_SUB, seed, device)
    corpus = corpus or CorpusBatch.make(STATES_MATCH, LANES, T_LEN, seed, device)
    shared = {"roofline": {"corpus": corpus, "inp": inp}, "emission_precision": {"inp": inp},
              "laneblock": {"corpus": corpus}, "kernel_variants": {"corpus": corpus}}
    return {name: STAGES[name](rec, device, seed, **shared[name]) for name in stages}
