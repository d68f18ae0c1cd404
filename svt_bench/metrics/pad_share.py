"""``pad_share``: the share of the lane-steps that the program's launches
ran on padding, in %: 100 × (1 − real / launched) from
``spec_viterbi_tpu_torch.ops.fused.lane_steps``, which ``stage_batch``
counts from the host's lengths. The counts cover the warm-up and the window,
both of which cycle the same pool, so the ratio is the window's where every
batch of the pool holds the same lengths. Nothing where the program has no
such counter or staged nothing."""


def read(run):
    try:
        from spec_viterbi_tpu_torch.ops import fused
    except ImportError:
        return None
    steps = getattr(fused, "lane_steps", None)
    if not steps or not steps.get("launched"):
        return None
    return 100.0 * (1.0 - steps["real"] / steps["launched"])
