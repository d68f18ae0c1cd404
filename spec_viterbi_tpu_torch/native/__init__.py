"""The native (C++) data layer: the ``.chmm`` and ``.ess`` parsers.

``src/svt_native.cpp`` is compiled with the host's C++ compiler on first
use, never on import, into ``spec_viterbi_tpu_torch/.build/``
(:mod:`.loader`). ``io.read_hmm`` and ``io.read_emit_seq`` take it when it
is there; without a compiler, or with ``SVT_DISABLE_NATIVE`` set, they
take the Python tokenizer.
"""
