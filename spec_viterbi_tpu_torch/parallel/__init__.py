"""More than one shard: data-parallel (DP), state-sharded (TP), DP × TP
and time-parallel (SP) decode.

The port of ``spec_viterbi_tpu/parallel``, over shard
groups in place of a mesh: :func:`make_group` (one axis) and
:func:`make_grid` (``data`` × ``state``), the counterparts of
``make_mesh``, held by one process on one device or spread over the ranks
of ``torch.distributed``. It holds the chunked-halo TP decode of banded
operators on the fused kernels (:class:`FusedTPDecoder`), the fused DP
entry points and :class:`StreamDP`, the dense DP, TP and DP × TP decodes
on ``svt_minplus`` (a TP rank holding its state block of the model,
:func:`state_block`), and the halo TP and DP of coupled structured operators
(``structured_tp``), and the dense time-parallel decode
(:func:`decode_time_parallel`: each ``time`` shard composes its block of
symbols into one operator on ``svt_minplus``, the blocks are gathered and
folded). ``batch_sharding`` and ``replicated`` name shardings of a JAX
mesh and have no counterpart here: a group splits the lanes, the states or
the symbols itself.
"""

from spec_viterbi_tpu_torch.parallel.distributed import init_distributed, process_info
from spec_viterbi_tpu_torch.parallel.fused_tp import FusedTPDecoder, fused_tp_supported
from spec_viterbi_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    STATE_AXIS,
    TIME_AXIS,
    DistributedGroup,
    Grid,
    LocalGroup,
    make_grid,
    make_group,
)
from spec_viterbi_tpu_torch.parallel.sharded import (
    StreamDP,
    decode_batch_dp,
    decode_batch_dp_fused,
    decode_batch_dp_tp,
    decode_path_batch_dp_fused,
    decode_time_parallel,
    decode_tp,
    make_dp_tp_decode,
    make_fused_dp,
    make_time_parallel_decode,
    make_tp_decode,
    state_block,
)
from spec_viterbi_tpu_torch.parallel.structured_tp import (
    decode_batch_structured_dp,
    decode_batch_structured_tp,
    make_structured_dp_decode,
    make_structured_tp_decode,
    structured_tp_supported,
)

__all__ = [
    "DATA_AXIS",
    "STATE_AXIS",
    "TIME_AXIS",
    "LocalGroup",
    "DistributedGroup",
    "Grid",
    "make_group",
    "make_grid",
    "init_distributed",
    "process_info",
    "decode_batch_dp",
    "decode_batch_dp_fused",
    "decode_batch_dp_tp",
    "decode_path_batch_dp_fused",
    "make_fused_dp",
    "StreamDP",
    "decode_tp",
    "make_dp_tp_decode",
    "make_tp_decode",
    "state_block",
    "decode_time_parallel",
    "make_time_parallel_decode",
    "decode_batch_structured_dp",
    "decode_batch_structured_tp",
    "make_structured_dp_decode",
    "make_structured_tp_decode",
    "structured_tp_supported",
    "FusedTPDecoder",
    "fused_tp_supported",
]
