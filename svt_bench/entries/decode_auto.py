"""The entry ``decode_auto``: the port's one-stop call, as its CLI's default
mode runs it.

``setup`` builds the program's ``HMM`` from the model's arrays once, as a
user holds a parsed model; every ``call`` is one
``spec_viterbi_tpu_torch.scheduler.decode_auto`` over a batch, which plans
the route, builds the decoder and returns host arrays: ``[scores]``, or
``[(scores, path)]`` when the mix asks for paths.
"""

from __future__ import annotations

from spec_viterbi_tpu_torch.hmm import HMM
from spec_viterbi_tpu_torch.scheduler import decode_auto


def setup(arrays: dict, mix: dict, device) -> dict:
    hmm = HMM(
        states_num=int(arrays["states"]),
        emit_num=int(arrays["symbols"]),
        trans_rows=arrays["src"],
        trans_cols=arrays["dst"],
        trans_probs=arrays["cost"],
        emissions=arrays["emissions"],
        start_probabilities_cols=arrays["start_states"],
        start_probabilities=arrays["start_cost"],
    )
    hmm.validate()
    return {"hmm": hmm, "paths": bool(mix["paths"]), "device": device}


def call(state: dict, batch: list) -> list:
    return decode_auto(state["hmm"], batch, paths=state["paths"], device=state["device"])
