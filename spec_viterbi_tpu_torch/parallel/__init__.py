"""More than one shard: state-sharded (TP) and data-parallel (DP) decode.

The port of ``spec_viterbi_tpu/parallel``, for the fused kernels: the
chunked-halo TP decode of banded operators (:class:`FusedTPDecoder`) and
the fused DP entry points, over a shard group (:func:`make_group`, the
counterpart of ``make_mesh``) held by one process or spread over the
ranks of ``torch.distributed``. Still to port: ``StreamDP``, the halo TP
of coupled operators (``structured_tp``), dense TP and time parallelism.
"""

from spec_viterbi_tpu_torch.parallel.distributed import init_distributed, process_info
from spec_viterbi_tpu_torch.parallel.fused_tp import FusedTPDecoder, fused_tp_supported
from spec_viterbi_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    STATE_AXIS,
    TIME_AXIS,
    DistributedGroup,
    LocalGroup,
    make_group,
)
from spec_viterbi_tpu_torch.parallel.sharded import (
    decode_batch_dp_fused,
    decode_path_batch_dp_fused,
)

__all__ = [
    "DATA_AXIS",
    "STATE_AXIS",
    "TIME_AXIS",
    "LocalGroup",
    "DistributedGroup",
    "make_group",
    "init_distributed",
    "process_info",
    "decode_batch_dp_fused",
    "decode_path_batch_dp_fused",
    "FusedTPDecoder",
    "fused_tp_supported",
]
