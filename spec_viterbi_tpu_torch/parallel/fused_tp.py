"""State-sharded (TP) decode of banded operators on the window kernels.

The port of ``spec_viterbi_tpu/parallel/fused_tp.py``. A banded operator
(diagonal components only: no dense rows or columns, no residual) moves
information at most ``max|d|`` states a step, so a ``c``-step chunk needs
only a ``c·max|d|``-row halo: each shard runs ``c`` steps of the fused
recurrence on its state window (own block plus halo rows) and then takes
fresh halo rows from its neighbours. After ``c`` steps the interior rows
are exact, so TP scores are bit-equal to the unsharded decode. Coupled
operators (the Pfam corpus models) move information across the whole
state space every step and are refused (:func:`fused_tp_supported`).

Two kernels replace the JAX package's two window launches
(``csrc/window.cu``):

- :func:`scores_window` (kernel ``svt_scores_window``) replaces
  ``FusedTPDecoder._pallas_win``;
- :func:`path_window` (kernel ``svt_path_window``) replaces
  ``FusedTPDecoder._path_pallas_win``.

Each wrapper runs its plain PyTorch version (:func:`scores_window_plain`,
:func:`path_window_plain`) for CPU tensors and launches its kernel for
CUDA tensors; any other device raises.

:class:`FusedTPDecoder` runs on a shard group
(:mod:`spec_viterbi_tpu_torch.parallel.mesh`):

- on a :class:`~spec_viterbi_tpu_torch.parallel.mesh.LocalGroup` of K
  shards, one launch per chunk runs all K windows over a global padded
  carry, and the halo exchange is a swap of two such carries; the path
  kernel writes global pointers into one ``[T-1, B, n]`` tensor that
  ``svt_backtrace`` walks (the counterpart of the JAX one-chip harness,
  ``decode_batch_emulated``);
- on a :class:`~spec_viterbi_tpu_torch.parallel.mesh.DistributedGroup`,
  each rank runs its own window and exchanges halo rows with its
  neighbours after every chunk; it keeps window-local pointers for its
  block, and the backtrace walks them with one min-reduce per step.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from spec_viterbi_tpu_torch.ops import _build, fused
from spec_viterbi_tpu_torch.ops.structured import (
    OperatorTensors,
    StructuredOperator,
    structured_path_batch,
    structured_scores_batch,
)
from spec_viterbi_tpu_torch.parallel.mesh import STATE_AXIS, LocalGroup

# pointer a rank contributes to the backtrace's min-reduce for a state it
# does not own
_NOT_OWNED = 2**30


def _round8(x: int) -> int:
    return -(-x // 8) * 8


def _halos(sop: StructuredOperator, chunk: int) -> tuple[int, int]:
    """(h_lo, h_hi): the rows a c-step chunk pulls from below and above."""
    h_lo = _round8(chunk * max([d for d in sop.diag_offsets if d > 0], default=0))
    h_hi = _round8(chunk * max([-d for d in sop.diag_offsets if d < 0], default=0))
    return h_lo, h_hi


def fused_tp_supported(sop: StructuredOperator, shards: int, chunk: int) -> bool:
    """Whether the chunked-halo window kernels can TP-shard this operator.

    Requires a purely banded operator (coupled components need per-step
    exchange), an evenly divisible state space, and halos that reach only
    the adjacent shard. The JAX package's rule, unchanged."""
    if sop.row_idx or sop.col_idx or sop.residual_nnz:
        return False
    if shards < 2 or sop.n % shards:
        return False
    block = sop.n // shards
    if block % 8:
        return False
    h_lo, h_hi = _halos(sop, chunk)
    return h_lo <= block and h_hi <= block


# ---- the window kernels ----------------------------------------------------


def _guard(diag_offsets) -> int:
    """+inf guard rows either side of a window carry in the kernels' shared
    memory: max|d| (csrc/window.cu)."""
    return max((abs(d) for d in diag_offsets), default=0)


def window_smem(staged: bool, n_win: int, n_diag: int, n_em: int, guard: int) -> int:
    """Shared memory (bytes) a CTA of the window kernels takes: the staged
    arm's tables [E + D, n_win] and its lanes' double-buffered carries of
    ``n_win + 2·guard`` rows; the global arm one lane's carries."""
    tables = (n_em + n_diag) * n_win if staged else 0
    lanes = _build.WINDOW_STAGED_LANES if staged else 1
    return 4 * (tables + lanes * 2 * (n_win + 2 * guard))


@dataclasses.dataclass(frozen=True)
class WindowTables:
    """What the window kernels need of one banded operator on one device:
    the padded operands and the geometry of the windows one launch runs.

    Rows are in the padded space ``[h_lo + n + h_hi]`` (guard rows +inf).
    Window ``s`` of a launch reads carry rows ``[s·block, s·block + n_win)``
    and operand rows ``op_row0 + s·block + ...``, and writes its interior
    rows ``[h_lo, h_lo + block)``; its pointers are ``window source +
    ptr_base + s·block``. ``staged`` is the kernels' arm, chosen once from
    the shapes: the window's tables in shared memory where they fit
    ``WINDOW_STAGED_SMEM`` with four lanes' carries, else read from global
    memory.
    """

    desc: _build.ScoresDesc  # the window operator: n = n_win, the diagonals
    dv: torch.Tensor  # [D, P] f32, diagonal values, +inf guard rows
    em: torch.Tensor  # [E, P] f32, emissions, +inf guard rows
    block: int
    h_lo: int
    shards: int  # windows per launch
    op_row0: int  # operand row of the first window
    ptr_base: int  # pointer stored for row 0 of the first window
    # per window, for the plain versions: the window operator (diagonal
    # values +inf where the source lies outside the window, as the
    # kernel's guard rows), its tensors and the emission table [n_win, E]
    windows: tuple[tuple[StructuredOperator, OperatorTensors, torch.Tensor], ...]
    staged: bool  # the kernels' arm

    @classmethod
    def build(cls, diag_offsets, dv: torch.Tensor, em: torch.Tensor, block: int,
              h_lo: int, h_hi: int, shards: int, op_row0: int, ptr_base: int) -> "WindowTables":
        n_win = h_lo + block + h_hi
        if op_row0 < 0 or op_row0 + (shards - 1) * block + n_win > dv.shape[1]:
            raise ValueError("windows reach past the padded operand rows")
        if len(diag_offsets) > _build.MAX_DIAG:
            raise ValueError(f"operator has {len(diag_offsets)} diagonals; the kernel takes {_build.MAX_DIAG}")
        if any(x % 2 for x in (block, h_lo, h_hi)):
            raise ValueError("window geometry must be even (the kernels store pointers in pairs)")
        desc = _build.ScoresDesc(n=n_win, n_diag=len(diag_offsets))
        desc.diag_off[: len(diag_offsets)] = diag_offsets
        staged = (window_smem(True, n_win, len(diag_offsets), em.shape[0], _guard(diag_offsets))
                  <= _build.WINDOW_STAGED_SMEM)
        rows = np.arange(n_win)
        dv_np = dv.cpu().numpy()
        windows = []
        for s in range(shards):
            r0 = op_row0 + s * block
            vals = dv_np[:, r0 : r0 + n_win].copy()
            for k, d in enumerate(diag_offsets):
                vals[k, (rows - d < 0) | (rows - d >= n_win)] = np.inf
            op = StructuredOperator(
                n=n_win, states_num=n_win, diag_offsets=tuple(diag_offsets), diag_vals=vals,
                row_idx=(), row_vals=np.zeros((0, n_win), np.float32),
                col_idx=(), col_vals=np.zeros((0, n_win), np.float32),
                res_src=np.zeros(0, np.int32), res_dst=np.zeros(0, np.int32),
                res_vals=np.zeros(0, np.float32), nnz=0,
            )
            windows.append((op, op.to(dv.device), em[:, r0 : r0 + n_win].T.contiguous()))
        return cls(desc, dv, em, block, h_lo, shards, op_row0, ptr_base, tuple(windows), staged)

    @property
    def n_win(self) -> int:
        return self.desc.n

    @property
    def rows(self) -> int:
        """Rows of the carries a launch reads and writes."""
        return (self.shards - 1) * self.block + self.n_win

    @functools.cached_property
    def launch_head(self) -> tuple:
        """The leading arguments of every launch of these tables."""
        return (ctypes.byref(self.desc), self.dv.data_ptr(), self.em.data_ptr(), self.dv.shape[1],
                self.op_row0, self.block, self.h_lo)

    @property
    def smem(self) -> int:
        """Shared memory (bytes) a CTA of this arm takes."""
        offsets = self.desc.diag_off[: self.desc.n_diag]
        return window_smem(self.staged, self.n_win, self.desc.n_diag, self.em.shape[0], _guard(offsets))

    @property
    def ptr_max(self) -> int:
        """Largest pointer a launch can store. Only finite candidates are
        adopted, so hi-halo rows that are guard rows (the launch ends at
        the end of the padded space) are never sources."""
        top = self.ptr_base + self.rows - 1
        if self.op_row0 + self.rows == self.dv.shape[1]:
            top -= self.n_win - self.h_lo - self.block  # h_hi
        return top


def _check_ptr_range(t: WindowTables) -> None:
    if t.ptr_max > fused.INT16_STATES:
        raise ValueError(f"pointers up to {t.ptr_max} do not fit int16 backpointers")


def _check_operands(t: WindowTables, v_in, obs, lengths, out=None, bp=None) -> None:
    """What the window kernels take, whatever the device: contiguous
    tensors of one device, of the launch's shapes and types."""
    if t.smem > _build.MAX_SMEM:
        raise ValueError(f"a window of {t.n_win} rows does not fit one block's shared memory")
    dev = v_in.device
    b, steps = v_in.shape[1], obs.shape[0]
    want = [
        (t.dv, torch.float32, tuple(t.dv.shape), "dv"),
        (t.em, torch.float32, (t.em.shape[0], t.dv.shape[1]), "em"),
        (v_in, torch.float32, (t.rows, b), "v_in"),
        (obs, torch.int32, (steps, b), "obs"),
        (lengths, torch.int32, (b,), "lengths"),
    ]
    if out is not None:
        if out.data_ptr() == v_in.data_ptr():
            raise ValueError("out must not be v_in")
        want.append((out, torch.float32, (t.rows, b), "out"))
    if bp is not None:
        want.append((bp, torch.int16, (steps, b, t.shards * t.block), "bp"))
    for x, dtype, shape, name in want:
        if x.device != dev or x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(
                f"{name}: want {dtype} {shape} on {dev}, "
                f"got {x.dtype} {tuple(x.shape)} on {x.device}"
            )
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_window(t: WindowTables, v_in, obs, lengths, out=None, bp=None) -> None:
    """What the window kernels take: :func:`_check_operands` on CUDA."""
    if v_in.device.type != "cuda":
        raise ValueError(f"no kernel for device {v_in.device}")
    _check_operands(t, v_in, obs, lengths, out, bp)


def _new_carry(v_in: torch.Tensor) -> torch.Tensor:
    return torch.full_like(v_in, float("inf"))


def _launch(lib, t: WindowTables, v_in: int, obs: int, lengths: int, out: int, batch: int,
            steps: int, stream: int, bp: int | None = None) -> None:
    """One launch of a window kernel on checked tensors, given as device
    addresses: svt_path_window where ``bp`` is given, else
    svt_scores_window."""
    head = (*t.launch_head, v_in, obs, lengths, out)
    tail = (t.em.shape[0], int(t.staged), stream)
    if bp is None:
        _build.check(lib, lib.svt_scores_window(*head, batch, t.shards, steps, *tail),
                     "svt_scores_window")
        fused.launches["scores_window"] += 1
    else:
        _build.check(lib, lib.svt_path_window(*head, bp, t.shards * t.block, t.ptr_base, batch,
                                              t.shards, steps, *tail), "svt_path_window")
        fused.launches["path_window"] += 1


def scores_window_plain(t: WindowTables, v_in, obs, lengths, out=None) -> torch.Tensor:
    """Plain version of ``svt_scores_window``: the structured scan of
    :func:`structured_scores_batch` on each window operator."""
    out = _new_carry(v_in) if out is None else out
    for s, (op, arrs, em_t) in enumerate(t.windows):
        r0 = s * t.block
        v = structured_scores_batch(op, arrs, em_t, v_in[r0 : r0 + t.n_win], obs, lengths)
        out[r0 + t.h_lo : r0 + t.h_lo + t.block] = v[t.h_lo : t.h_lo + t.block]
    return out


def scores_window(t: WindowTables, v_in, obs, lengths, out=None) -> torch.Tensor:
    """Advance each window of ``v_in`` [rows, B] through ``obs`` [c, B]
    (lane ``b`` takes ``lengths[b] - 1`` of the steps) and write the
    interior rows into ``out`` (a new +inf carry when None; other rows are
    left as they are). Returns ``out``."""
    if v_in.device.type == "cpu":
        return scores_window_plain(t, v_in, obs, lengths, out)
    _check_window(t, v_in, obs, lengths, out)
    out = _new_carry(v_in) if out is None else out
    b = v_in.shape[1]
    if b == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(v_in.device):
        _launch(lib, t, v_in.data_ptr(), obs.data_ptr(), lengths.data_ptr(), out.data_ptr(), b,
                obs.shape[0], torch.cuda.current_stream(v_in.device).cuda_stream)
    return out


def path_window_plain(t: WindowTables, v_in, obs, lengths, out=None, bp=None):
    """Plain version of ``svt_path_window``: the masked argmin scan of
    :func:`structured_path_batch` on each window operator."""
    _check_ptr_range(t)
    out = _new_carry(v_in) if out is None else out
    if bp is None:
        bp = torch.empty((obs.shape[0], v_in.shape[1], t.shards * t.block),
                         dtype=torch.int16, device=v_in.device)
    lo, hi = t.h_lo, t.h_lo + t.block
    for s, (op, arrs, em_t) in enumerate(t.windows):
        r0 = s * t.block
        v, src = structured_path_batch(op, arrs, em_t, v_in[r0 : r0 + t.n_win], obs, lengths,
                                       torch.int16, base=t.ptr_base + r0)
        out[r0 + lo : r0 + hi] = v[lo:hi]
        bp[:, :, r0 : r0 + t.block] = src[:, :, lo:hi]
    return out, bp


def path_window(t: WindowTables, v_in, obs, lengths, out=None, bp=None):
    """:func:`scores_window` keeping the winning source of every interior
    row and step: returns ``(out, bp [c, B, shards·block] int16)``, ``bp``
    allocated when None. Pointers are ``window source + base``; a row no
    finite candidate reaches stores 0, a frozen step ``window row + base``."""
    if v_in.device.type == "cpu":
        return path_window_plain(t, v_in, obs, lengths, out, bp)
    _check_ptr_range(t)
    steps, b = obs.shape
    if bp is None:
        bp = torch.empty((steps, b, t.shards * t.block), dtype=torch.int16, device=v_in.device)
    _check_window(t, v_in, obs, lengths, out, bp)
    out = _new_carry(v_in) if out is None else out
    if b == 0:
        return out, bp
    lib = _build.library()
    with torch.cuda.device(v_in.device):
        _launch(lib, t, v_in.data_ptr(), obs.data_ptr(), lengths.data_ptr(), out.data_ptr(), b,
                steps, torch.cuda.current_stream(v_in.device).cuda_stream, bp=bp.data_ptr())
    return out, bp


def window_occupancy(t: WindowTables, kernel: str, device) -> tuple[int, int, int]:
    """(registers a thread, resident CTAs an SM, lanes a CTA) of the arm of
    ``svt_scores_window`` (``kernel="scores"``) or ``svt_path_window``
    (``"path"``) that ``t`` runs, as the card reports them."""
    if torch.device(device).type != "cuda":
        raise ValueError(f"no kernel for device {device}")
    offsets = t.desc.diag_off[: t.desc.n_diag]
    lib = _build.library()
    regs, ctas, lanes = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    with torch.cuda.device(device):
        rc = lib.svt_window_occupancy(
            {"scores": 0, "path": 1}[kernel], int(t.staged), t.n_win, t.desc.n_diag,
            max(abs(d) for d in offsets), t.em.shape[0],
            ctypes.byref(regs), ctypes.byref(ctas), ctypes.byref(lanes))
    _build.check(lib, rc, "svt_window_occupancy")
    return regs.value, ctas.value, lanes.value


# ---- the decoder -------------------------------------------------------------


class FusedTPDecoder:
    """Chunked-halo TP decode for one banded HMM over a ``state`` group."""

    def __init__(
        self,
        sop: StructuredOperator,
        emissions: np.ndarray,
        pi: np.ndarray,
        group=None,
        chunk: int = 16,
        shards: int | None = None,
        device: torch.device | str | None = None,
    ):
        """``group=None`` with ``shards=K`` and ``device`` makes a local
        group of K shards on that device: the counterpart of the JAX
        package's window harness (``mesh=None``)."""
        if group is None:
            if shards is None:
                raise ValueError("group=None (window harness) requires shards=")
            if device is None:
                raise ValueError("group=None (window harness) requires device=")
            group = LocalGroup(shards, device)
        elif shards is not None and shards != group.size:
            raise ValueError(f"shards={shards} but the group has {group.size}")
        elif device is not None and torch.device(device) != group.device:
            raise ValueError(f"device={device} but the group is on {group.device}")
        if group.axis != STATE_AXIS:
            raise ValueError(f"TP shards the {STATE_AXIS!r} axis, not {group.axis!r}")
        self.group = group
        self.device = group.device
        self.chunk = int(chunk)
        self.sop = sop
        self.states_num = sop.states_num
        self.emit_num = int(emissions.shape[0])
        if not fused_tp_supported(sop, group.size, self.chunk):
            raise ValueError(
                "operator/group/chunk outside the chunked-halo TP class "
                "(banded only; see fused_tp_supported)"
            )
        n = sop.n
        if emissions.shape != (self.emit_num, n) or np.shape(pi) != (n,):
            raise ValueError(f"want emissions [E, {n}] and pi [{n}]")
        self.n = n
        self.shards = group.size
        self.block = n // self.shards
        self.h_lo, self.h_hi = _halos(sop, self.chunk)
        self.n_win = self.h_lo + self.block + self.h_hi

        # globally padded operands: h_lo/h_hi +inf guard rows, so every
        # shard reads a uniform window with no clamping
        rows = self.h_lo + n + self.h_hi

        def pad(a):
            out = np.full((a.shape[0], rows), np.inf, np.float32)
            out[:, self.h_lo : self.h_lo + n] = a
            return torch.as_tensor(out, device=self.device)

        dv = pad(np.asarray(sop.diag_vals, np.float32).reshape(len(sop.diag_offsets), n))
        self._em = pad(np.asarray(emissions, np.float32))  # [E, P]
        self._em_t = self._em.T.contiguous()  # [P, E]
        self._pi = pad(np.asarray(pi, np.float32)[None, :])[0]  # [P]
        # all K windows in one launch, global pointers
        self._local = WindowTables.build(
            sop.diag_offsets, dv, self._em, self.block, self.h_lo, self.h_hi,
            self.shards, op_row0=0, ptr_base=-self.h_lo,
        )
        # this rank's window, window-local pointers (as the JAX package)
        self._rank = None if group.is_local else WindowTables.build(
            sop.diag_offsets, dv, self._em, self.block, self.h_lo, self.h_hi,
            1, op_row0=group.rank * self.block, ptr_base=0,
        )

    def _stage(self, seqs):
        seqs_t, lengths, _ = fused.stage_batch(seqs, self.emit_num, self.device)
        return seqs_t, lengths

    def _chunk_lengths(self, steps: int, lengths: torch.Tensor) -> torch.Tensor:
        """[n_chunks, B] int32: the lengths each chunk of ``steps`` steps
        hands the window kernel. Chunk k starts at symbol s0 = 1 + k·c
        (symbol 0 is the initial carry), so a lane of length L takes
        clip(L − s0 + 1, 1, c + 1) − 1 of its steps."""
        c = self.chunk
        s0 = 1 + c * torch.arange(-(-steps // c), dtype=torch.int32, device=lengths.device)
        return torch.clamp(lengths[None, :] - s0[:, None] + 1, 1, c + 1).to(torch.int32).contiguous()

    def _chunks(self, steps: int, lengths: torch.Tensor):
        """[(first step, end step, lengths [B] int32)] of the chunks of
        ``steps`` steps; the last chunk has the remaining steps."""
        c = self.chunk
        len_c = self._chunk_lengths(steps, lengths)
        return [(k * c, min(steps, (k + 1) * c), len_c[k]) for k in range(len_c.shape[0])]

    def _run_chunks(self, t: WindowTables, v, obs, lengths, bp=None, exchange=None):
        """Every chunk of ``obs`` [T-1, B] through the window kernel from the
        carry ``v``: the path kernel into ``bp`` where it is given, else the
        scores kernel; ``exchange(carry)`` refreshes the halo rows after
        each chunk. Returns the last carry.

        The tensors are checked once a call, as the wrappers check them;
        on CUDA each chunk is then one launch at offsets into them (no
        per-chunk checks or views), on the CPU the wrappers' plain
        versions."""
        nxt = _new_carry(v)
        len_c = self._chunk_lengths(obs.shape[0], lengths)
        c, steps, b = self.chunk, obs.shape[0], v.shape[1]
        spans = [(k, k * c, min(steps, (k + 1) * c)) for k in range(len_c.shape[0])]
        if not spans:
            return v
        on_cpu = v.device.type == "cpu"
        (_check_operands if on_cpu else _check_window)(t, v, obs, len_c[0], out=nxt, bp=bp)
        if bp is not None:
            _check_ptr_range(t)
        carries = (v, nxt)
        if on_cpu or b == 0:
            for k, k0, k1 in spans:
                src, dst = carries[k % 2], carries[1 - k % 2]
                if bp is None:
                    scores_window(t, src, obs[k0:k1], len_c[k], out=dst)
                else:
                    path_window(t, src, obs[k0:k1], len_c[k], out=dst, bp=bp[k0:k1])
                if exchange is not None:
                    exchange(dst)
            return carries[len(spans) % 2]
        lib = _build.library()
        ptrs = (v.data_ptr(), nxt.data_ptr())
        step_bytes = b * 4  # one step of obs, one chunk of len_c
        bp_step = b * t.shards * t.block * 2
        with torch.cuda.device(v.device):
            stream = torch.cuda.current_stream(v.device).cuda_stream
            for k, k0, k1 in spans:
                _launch(lib, t, ptrs[k % 2], obs.data_ptr() + k0 * step_bytes,
                        len_c.data_ptr() + k * step_bytes, ptrs[1 - k % 2], b, k1 - k0, stream,
                        bp=None if bp is None else bp.data_ptr() + k0 * bp_step)
                if exchange is not None:
                    exchange(carries[1 - k % 2])
        return carries[len(spans) % 2]

    def _run_local(self, seqs_t, lengths, path: bool, check_path_kernel: bool = False):
        """All K shards on this device: [T, B] symbols → (carry [n, B],
        global pointers [T-1, B, n] int16 or None)."""
        t = self._local
        v = self._em_t[:, seqs_t[0].long()] + self._pi[:, None]  # [P, B]
        # the kernels write interior rows only, so the guard rows of both
        # carries stay +inf: the JAX package's `valid` re-mask
        obs = seqs_t[1:]
        bp = None
        if path:
            if self.n > fused.INT16_STATES:
                raise ValueError(f"{self.n} states do not fit int16 backpointers; use a distributed group")
            bp = torch.empty((obs.shape[0], v.shape[1], self.n), dtype=torch.int16, device=v.device)
        if not check_path_kernel:
            # the exchange: the next chunk's windows read the fresh interiors
            v = self._run_chunks(t, v, obs, lengths, bp)
            return v[self.h_lo : self.h_lo + self.n], bp
        nxt = _new_carry(v)
        for k, (k0, k1, len_c) in enumerate(self._chunks(obs.shape[0], lengths)):
            obs_c = obs[k0:k1]
            scores_window(t, v, obs_c, len_c, out=nxt)
            out_pk, _ = path_window(t, v, obs_c, len_c)
            # both kernels are exact f32: the carries agree bit for bit
            if not torch.equal(out_pk, nxt):
                raise AssertionError(f"window path kernel diverged from the scores kernel (chunk {k})")
            v, nxt = nxt, v
        return v[self.h_lo : self.h_lo + self.n], bp

    def _run_rank(self, seqs_t, lengths, path: bool):
        """This rank's window: [T, B] symbols → (interior carry [block, B],
        window-local pointers [T-1, B, block] int16 or None)."""
        t, g = self._rank, self.group
        w0 = g.rank * self.block
        win = slice(w0, w0 + self.n_win)
        v = self._em_t[win][:, seqs_t[0].long()] + self._pi[win, None]  # [n_win, B]
        obs = seqs_t[1:]
        bp = None
        if path:
            bp = torch.empty((obs.shape[0], v.shape[1], self.block), dtype=torch.int16, device=v.device)
        v = self._run_chunks(t, v, obs, lengths, bp,
                             exchange=lambda w: g.exchange_halo(w, self.h_lo, self.block, self.h_hi))
        return v[self.h_lo : self.h_lo + self.block], bp

    def _backtrace_sharded(self, bp, last):
        """Walk this rank's window-local pointers ``bp`` [T-1, B, block]
        back from ``last`` [B] (global end states) → ``rev`` [T-1, B] int32,
        one min-reduce per step: the owner of each lane's state contributes
        its pointer, the others 2**30.

        Window-local pointer ``p`` on rank ``r`` is global row ``p + r·block
        − h_lo``. Dead (all-inf) rows store 0 (window coordinates); the
        ``max(·, 0)`` clamp maps those to global 0 on rank 0 only, which is
        the only rank whose dead rows the walk can reach: it starts at the
        per-lane argmin, an all-inf lane argmins to global state 0 (rank 0)
        and stays there, and a finite walk only follows pointers of
        finite-score states. The clamp also keeps the degenerate walk's
        indices in range; it is not a general dead-pointer-to-0 mapping on
        ranks r > 0."""
        g = self.group
        off = g.rank * self.block
        rev = torch.empty(bp.shape[:2], dtype=torch.int32, device=bp.device)
        never = torch.full_like(last, _NOT_OWNED)
        state = last
        for k in range(bp.shape[0] - 1, -1, -1):
            local = state - off
            owned = (local >= 0) & (local < self.block)
            idx = local.clamp(0, self.block - 1).long()[:, None]
            ptr = bp[k].gather(1, idx)[:, 0].to(torch.int32)
            ptr = torch.clamp_min(ptr + (off - self.h_lo), 0)
            state = g.min_reduce(torch.where(owned, ptr, never))
            rev[k] = state
        return rev

    def _path_core(self, seqs_t, lengths):
        """[T, B] symbols → (scores [n, B], paths [T, B] int32)."""
        if self.group.is_local:
            carry, bp = self._run_local(seqs_t, lengths, path=True)
            last = torch.argmin(carry, dim=0).to(torch.int32)  # lowest index on ties
            rev = fused.backtrace(bp, last)
        else:
            interior, bp = self._run_rank(seqs_t, lengths, path=True)
            carry = self.group.all_gather([interior])  # [n, B], once
            last = torch.argmin(carry, dim=0).to(torch.int32)
            rev = self._backtrace_sharded(bp, last)
        return carry, torch.cat([rev, last[None]], dim=0)

    def _split_scores(self, v: torch.Tensor, b: int) -> list[np.ndarray]:
        v = v.T[:, : self.states_num].cpu().numpy()
        return [v[i] for i in range(b)]

    def decode_batch(self, seqs: list[np.ndarray]) -> list[np.ndarray]:
        """Batched TP decode; a [states_num] score vector per sequence."""
        if not seqs:
            return []
        if self.group.is_local:
            return self.decode_batch_emulated(seqs)
        seqs_t, lengths = self._stage(seqs)
        interior, _ = self._run_rank(seqs_t, lengths, path=False)
        return self._split_scores(self.group.all_gather([interior]), len(seqs))

    def decode_batch_emulated(
        self, seqs: list[np.ndarray], check_path_kernel: bool = False
    ) -> list[np.ndarray]:
        """The K-shard schedule on this process's device, whatever the
        group: every chunk is one launch of the scores window kernel over
        all K windows. ``check_path_kernel`` also runs the path window
        kernel on each chunk and raises unless its carry equals the scores
        kernel's bit for bit."""
        if not seqs:
            return []
        seqs_t, lengths = self._stage(seqs)
        v, _ = self._run_local(seqs_t, lengths, path=False, check_path_kernel=check_path_kernel)
        return self._split_scores(v, len(seqs))

    def decode_path_batch(self, seqs: list[np.ndarray]) -> list[tuple[np.ndarray, np.ndarray]]:
        """[(scores, path)] per sequence, with the oracle's tie rule. On a
        distributed group the backpointers are state-sharded: each rank
        holds [T-1, B, block]."""
        if not seqs:
            return []
        seqs_t, lengths = self._stage(seqs)
        scores, paths = self._path_core(seqs_t, lengths)
        scores = scores.T[:, : self.states_num].cpu().numpy()
        paths = fused.fetch_paths(paths.T, [len(s) for s in seqs])
        return list(zip(scores, paths))
