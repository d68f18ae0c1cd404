"""``dense.read_share``: the share of the dense operator's entries that the
dense decoder's ``svt_minplus`` steps read, in %: 100 × read / launched from
``spec_viterbi_tpu_torch.ops.tropical.dense_work``, which
``ViterbiDecoder.prepare_batch`` counts from the host's shapes and lengths
(``launched`` += n_pad² × lanes a step, ``read`` += the entries of the
blocks the step's launch reads × lanes a step: its block list's blocks,
every entry without a list). The counts cover the warm-up and the window,
both of which cycle the same pool. Nothing where the program has no such
counter or ran no dense step."""

from __future__ import annotations


def read(run):
    try:
        from spec_viterbi_tpu_torch.ops import tropical
    except ImportError:
        return None
    work = getattr(tropical, "dense_work", None)
    if not work or not work.get("launched") or "read" not in work:
        return None
    return 100.0 * work["read"] / work["launched"]
