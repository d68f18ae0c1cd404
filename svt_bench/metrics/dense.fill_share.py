"""``dense.fill_share``: the share of the operator entries that the dense
decoder's ``svt_minplus`` steps read that are real work, in %: 100 × real /
launched from ``spec_viterbi_tpu_torch.ops.tropical.dense_work``, which
``ViterbiDecoder.prepare_batch`` counts from the host's shapes and lengths
(``launched`` += n_pad² × lanes a step, ``real`` += the finite transitions
× the lanes still live at that step). The counts cover the warm-up and the
window, both of which cycle the same pool, so the ratio is the window's
where every batch of the pool holds the same lengths. Nothing where the
program has no such counter or ran no dense step."""

from __future__ import annotations


def read(run):
    try:
        from spec_viterbi_tpu_torch.ops import tropical
    except ImportError:
        return None
    work = getattr(tropical, "dense_work", None)
    if not work or not work.get("launched"):
        return None
    return 100.0 * work["real"] / work["launched"]
