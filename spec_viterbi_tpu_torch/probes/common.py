"""What the probe runners share: the card's line, CUDA-event
timing, the slope fit, the record of measurements, and the seeded inputs at
the production shape."""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess

import numpy as np
import torch

# the production shape of the TPU probes: the 2405-state corpus model
# padded to 2,432 states, 512 lanes, 3,488 substeps (divisible by 2 and 4)
N_STATES = 2432
LANES = 512
T_SUB = 3488
E_PAD = 32  # emission table rows the probes read (symbols < 20)
STATES_MATCH = 2405  # + the N and C states: the 2,407-state corpus stand-in
T_LEN = 3500  # symbols per sequence of the corpus-shaped batches
REPEATS = 5


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of the first card."""
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return proc.stdout.strip().splitlines()[0]


def median_ms(fn, repeats: int = REPEATS) -> float:
    """Median of ``repeats`` CUDA-event timings of ``fn`` after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def profiled(fn, kernel: str) -> tuple[float, float | None, float | None]:
    """(device µs of the kernels whose name holds ``kernel``, device busy
    µs, device span µs) of one call of ``fn`` under ``torch.profiler``;
    ``(0.0, None, None)`` where it saw no device activity."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans = sorted(
        (e.time_range.start, e.time_range.end, e.name)
        for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
    )
    if not spans:
        return 0.0, None, None
    busy_kernel = sum(end - start for start, end, name in spans if kernel in name)
    busy, reach = 0.0, spans[0][0]
    for start, end, _ in spans:  # the union of the device intervals
        if end > reach:
            busy += end - max(start, reach)
            reach = end
    return busy_kernel, busy, reach - spans[0][0]


def fit_slope(ps, ts) -> float:
    """Least-squares slope of time over pass count."""
    return float(np.polyfit(np.asarray(ps, np.float64), np.asarray(ts, np.float64), 1)[0])


class Record:
    """Prints one JSON line per measurement, each naming the card, and
    keeps them by name. ``tag`` adds a ``phase`` key (``chip_smoke.py``)."""

    def __init__(self, card: str, tag: str | None = None):
        self.card = card
        self.tag = tag
        self.results: dict[str, dict] = {}

    def emit(self, name: str, **payload) -> dict:
        self.results[name] = payload
        head = {"phase": self.tag} if self.tag else {}
        print(json.dumps({**head, "name": name, "card": self.card, **payload}), flush=True)
        return payload


@dataclasses.dataclass
class PassInputs:
    """Seeded operands of the pass and select probes on one device, drawn
    as the TPU scripts draw theirs: carry normal(5, 1), cols normal(3, 1),
    stream rows normal(8, 1), emission table normal(6, 1), twosym tables
    normal(5, 1), symbols uniform in [0, 20)."""

    v0: torch.Tensor  # [n, B]
    cols: torch.Tensor  # [16, n]
    bufs: torch.Tensor  # [12, n]
    em: torch.Tensor  # [32, n]
    tabs: torch.Tensor  # [12, 32, n]
    obs: torch.Tensor  # [steps, B] int32

    @classmethod
    def make(cls, n: int, lanes: int, steps: int, seed: int, device) -> "PassInputs":
        rng = np.random.default_rng(seed)

        def f32(*shape, mean):
            return torch.as_tensor(rng.normal(mean, 1.0, size=shape).astype(np.float32), device=device)

        return cls(
            v0=f32(n, lanes, mean=5.0),
            cols=f32(16, n, mean=3.0),
            bufs=f32(12, n, mean=8.0),
            em=f32(E_PAD, n, mean=6.0),
            tabs=f32(12, E_PAD, n, mean=5.0),
            obs=torch.as_tensor(rng.integers(0, 20, size=(steps, lanes)).astype(np.int32), device=device),
        )


@dataclasses.dataclass
class CorpusBatch:
    """A corpus-shaped model (``generate_profile_hmm``, seeded) with its
    fused decoder and one uniform batch staged on the device: the symbols
    ``seqs`` [T, B] int32, ``v0`` [n, B] after the first symbol and
    ``obs`` = ``seqs[1:]``."""

    hmm: object
    fd: object  # FusedStructuredDecoder
    seqs: torch.Tensor
    v0: torch.Tensor
    obs: torch.Tensor

    @classmethod
    def make(cls, match_states: int, lanes: int, t_len: int, seed: int, device) -> "CorpusBatch":
        from spec_viterbi_tpu_torch.io import generate_profile_hmm
        from spec_viterbi_tpu_torch.ops.fused import FusedStructuredDecoder
        from spec_viterbi_tpu_torch.ops.structured import StructuredOperator

        hmm = generate_profile_hmm(match_states, seed=seed)
        sop = StructuredOperator.from_hmm(hmm)
        fd = FusedStructuredDecoder(
            sop, hmm.emission_matrix(pad_to=sop.n), hmm.start_vector(pad_to=sop.n), device=device
        )
        rng = np.random.default_rng(seed + 1)
        seqs = torch.as_tensor(
            rng.integers(0, hmm.emit_num, size=(t_len, lanes)).astype(np.int32), device=device
        )
        return cls.of(hmm, fd, seqs)

    @classmethod
    def of(cls, hmm, fd, seqs: torch.Tensor) -> "CorpusBatch":
        """The batch of symbols ``seqs`` [T, B] int32 on ``fd``'s device."""
        v0 = fd.em_t[:, seqs[0].long()] + fd.pi[:, None]
        return cls(hmm, fd, seqs, v0.contiguous(), seqs[1:].contiguous())

    def widened(self, lanes: int) -> "CorpusBatch":
        """The same model with the batch's lanes repeated or cut to
        ``lanes``."""
        reps = -(-lanes // self.seqs.shape[1])
        return self.of(self.hmm, self.fd, self.seqs.repeat(1, reps)[:, :lanes].contiguous())
