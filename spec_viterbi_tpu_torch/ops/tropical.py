"""Tropical (min,+) semiring linear algebra: the plain PyTorch functions
and the hand-written product kernel.

The port of ``spec_viterbi_tpu/ops/tropical.py``. The semiring zero is
``+inf``: ``inf + x = inf`` and ``min(inf, x) = x`` hold in IEEE float32,
so no masking is needed. Orientation conventions (all row-major):

- ``tropical_mv(M, v)[i]   = min_j M[i, j] + v[j]``        (operator ⊗ vector)
- ``tropical_mm(A, B)[i,j] = min_k A[i, k] + B[k, j]``     (A ⊗ B)
- ``tropical_mm_tn_blocked(AT, B)[i, j] = min_k AT[k, i] + B[k, j]``

The five functions of the JAX module are written here as plain PyTorch
(broadcast and reduce, chunked over K where the JAX module chunks).
Beside them, :func:`minplus` is the wrapper of the CUDA kernel
``svt_minplus`` (``csrc/tropical.cu``), which every dense product of the
specializer goes through (:mod:`.dispatch`), and :func:`minplus_plain` is
its plain version. :func:`dense_step` and :func:`dense_step_mv` launch the
same kernel with its epilogue, one launch a step of the dense decoder
(the emission add and the length mask folded in), beside their plain
versions :func:`dense_step_plain` and :func:`dense_step_mv_plain`.
:func:`block_list` builds, once an operator, the list of its blocks that
hold a finite entry, which :func:`dense_step` hands the kernel so that it
reads only those (the same bits: the skipped candidates are +inf). Each
wrapper runs the plain version for CPU tensors and launches the kernel
for CUDA tensors; any other device raises. All of them count their
launches under ``launches["minplus"]``. Each candidate is one f32 add, rounded once, and the
min is exact, so every function here gives the same bits whatever order
it takes K in.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses

import numpy as np
import torch

from spec_viterbi_tpu_torch.ops import _build

INF = float("inf")

# elements of the [G, I, k_block, J] candidate block of the plain version
PLAIN_BLOCK_ELEMS = 1 << 25

# Launch count of svt_minplus; the wrappers (minplus, dense_step,
# dense_step_mv) add one where they launch the kernel and nowhere else.
launches = {"minplus": 0}

# Operator entries of the dense decoder's steps, counted by
# ``ViterbiDecoder.prepare_batch`` from the host's shapes and lengths: every
# entry of the operator for every lane (``launched``, n_pad² a lane), the
# entries of the blocks the step's launch reads for every lane (``read``:
# its block list's, else n_pad²) and the finite ones for the lanes still
# live at that step (``real``).
dense_work = {"launched": 0, "read": 0, "real": 0}

# The blocks of a block list (csrc/tropical.cu): k a stage of the tiled
# arm's ring (MP_BK) and the rows of a list launch's tiles (MP_LIST_ROWS).
STAGE_K = 16
LIST_ROWS = 64


def reset_launches() -> None:
    for counts in (launches, dense_work):
        for k in counts:
            counts[k] = 0


def tropical_mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``(M ⊗ v)[i] = min_j M[i,j] + v[j]``. Shapes: [N, K] ⊗ [K] → [N]."""
    return (M + v[None, :]).amin(dim=1)


def tropical_mv_argmin(M: torch.Tensor, v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Tropical matvec that also returns the argmin index per output row
    (int32); ties break to the lowest index, an all-inf row points to 0."""
    val, idx = (M + v[None, :]).min(dim=1)
    return val, idx.to(torch.int32)


def tropical_mm(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """``(A ⊗ B)[i,j] = min_k A[i,k] + B[k,j]``. [I, K] ⊗ [K, J] → [I, J].
    Materializes the [I, K, J] broadcast: small operands only."""
    return (A[:, :, None] + B[None, :, :]).amin(dim=1)


def _pad_k(x: torch.Tensor, dim: int, pad: int) -> torch.Tensor:
    shape = list(x.shape)
    shape[dim] = pad
    return torch.cat([x, torch.full(shape, INF, dtype=x.dtype, device=x.device)], dim=dim)


def tropical_mm_blocked(A: torch.Tensor, B: torch.Tensor, k_block: int = 8) -> torch.Tensor:
    """Blocked tropical matmul: a running min over K chunks of ``k_block``
    (K padded with +inf, which never wins the min)."""
    I, K = A.shape
    K2, J = B.shape
    assert K == K2, (A.shape, B.shape)
    if K % k_block:
        pad = k_block - K % k_block
        A, B, K = _pad_k(A, 1, pad), _pad_k(B, 0, pad), K + pad
    out = None
    for k0 in range(0, K, k_block):
        part = (A[:, k0 : k0 + k_block, None] + B[None, k0 : k0 + k_block, :]).amin(dim=1)
        out = part if out is None else torch.minimum(out, part)
    return out


def tropical_mm_tn_blocked(AT: torch.Tensor, B: torch.Tensor, k_block: int = 8) -> torch.Tensor:
    """TN tropical matmul ``C[i,j] = min_k AT[k,i] + B[k,j]``, the same
    chunked-K min accumulation."""
    K, I = AT.shape
    K2, J = B.shape
    assert K == K2, (AT.shape, B.shape)
    if K % k_block:
        pad = k_block - K % k_block
        AT, B, K = _pad_k(AT, 0, pad), _pad_k(B, 0, pad), K + pad
    out = None
    for k0 in range(0, K, k_block):
        part = (AT[k0 : k0 + k_block, :, None] + B[k0 : k0 + k_block, None, :]).amin(dim=0)
        out = part if out is None else torch.minimum(out, part)
    return out


def minplus_plain(
    a: torch.Tensor,
    b: torch.Tensor,
    a_idx: torch.Tensor | None = None,
    argmin: bool = False,
    k_block: int | None = None,
):
    """Plain version of ``svt_minplus``: ``C[g, i, j] = min_k A_g[i, k] +
    B[g, k, j]``, a running min over K chunks of ``k_block`` (by default as
    many as keep the candidate block near 2^25 elements). Arguments as
    :func:`minplus`; with ``argmin``, a chunk's index replaces the running
    one only on a strictly lower value, so the lowest k wins a tie."""
    g, k, j = b.shape
    i = a.shape[1]
    if k_block is None:
        k_block = max(1, min(k, PLAIN_BLOCK_ELEMS // max(1, g * i * j)))
    best = torch.full((g, i, j), INF, dtype=torch.float32, device=b.device)
    arg = torch.zeros((g, i, j), dtype=torch.int32, device=b.device) if argmin else None
    for k0 in range(0, k, k_block):
        a_c = a[:, :, k0 : k0 + k_block]
        a_c = a_c[a_idx.long()] if a_idx is not None else a_c.expand(g, -1, -1)
        cand = a_c[:, :, :, None] + b[:, None, k0 : k0 + k_block, :]  # [G, I, kc, J]
        if argmin:
            val, idx = cand.min(dim=2)
            take = val < best
            best = torch.where(take, val, best)
            arg = torch.where(take, (idx + k0).to(torch.int32), arg)
        else:
            best = torch.minimum(best, cand.amin(dim=2))
    return (best, arg) if argmin else best




@dataclasses.dataclass(frozen=True)
class BlockList:
    """The blocks of an operator ``A[i, k]`` that hold a finite entry, at
    :data:`LIST_ROWS` rows a tile and :data:`STAGE_K` k a stage: ``table``
    (int32 on the operator's device) holds the offset of each row tile's
    run, ``tiles + 1`` of them, then each tile's stage indices in ascending
    order; ``listed`` blocks in all, ``most`` the most one tile lists."""

    tiles: int
    listed: int
    most: int
    table: torch.Tensor


def block_list(finite: np.ndarray, device: torch.device | str) -> BlockList | None:
    """The block list of an operator from its pattern ``finite`` ([I, K]
    bool, ``A[i, k]`` finite; a transposed view of a contiguous [K, I]
    array is read without a copy), on ``device``: None where every block
    holds a finite entry, since the launch reads every stage anyway."""
    i, k = finite.shape
    stages, tiles = -(-k // STAGE_K), -(-i // LIST_ROWS)
    whole = finite.T  # [K, I]
    if (k, i) != (stages * STAGE_K, tiles * LIST_ROWS):  # pad with +inf to whole blocks
        whole = np.zeros((stages * STAGE_K, tiles * LIST_ROWS), dtype=bool)
        whole[:k, :i] = finite.T
    by_stage = whole.reshape(stages, STAGE_K, -1).any(axis=1)  # [stages, I]
    held = by_stage.reshape(stages, tiles, LIST_ROWS).any(axis=2).T  # [tiles, stages]
    if held.all():
        return None
    counts = held.sum(axis=1)
    table = np.concatenate(([0], np.cumsum(counts), np.nonzero(held)[1])).astype(np.int32)
    return BlockList(tiles, int(counts.sum()), int(counts.max(initial=0)),
                     torch.as_tensor(table, device=device))


def _device_guard(device: torch.device):
    """The device context of ``device``, entered only where it is not the
    current device already (entering costs the host a few µs a launch)."""
    if torch.cuda.current_device() == device.index:
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def _want(x: torch.Tensor | None, name: str, dtype, shape: tuple, device: torch.device,
          contiguous: bool = True) -> None:
    """Raise unless ``x`` is a ``dtype`` tensor of ``shape`` on ``device``
    (contiguous where asked)."""
    if (x is None or x.device != device or x.dtype != dtype or tuple(x.shape) != shape
            or (contiguous and not x.is_contiguous())):
        got = "None" if x is None else f"{x.dtype} {tuple(x.shape)} on {x.device}"
        raise ValueError(f"{name}: want {'contiguous ' if contiguous else ''}{dtype} {shape} "
                         f"on {device}, got {got}")


def _launch(a: torch.Tensor, a_idx, b: torch.Tensor, c: torch.Tensor, arg, sa_g: int, g: int,
            i: int, k: int, j: int, em_t=None, obs_ptr=None, o: int = 0, lengths=None, t: int = 0,
            row0: int = 0, blocks: BlockList | None = None, stream: int | None = None) -> None:
    """One launch of ``svt_minplus`` on the operands' device (the epilogue
    where ``em_t`` is given, only the listed blocks where ``blocks`` is);
    counts it."""
    lib = _build.library()
    with _device_guard(b.device):
        if stream is None:
            stream = torch.cuda.current_stream(b.device).cuda_stream
        rc = lib.svt_minplus(
            a.data_ptr(), None if a_idx is None else a_idx.data_ptr(), b.data_ptr(), c.data_ptr(),
            None if arg is None else arg.data_ptr(), sa_g, a.stride(-2), a.stride(-1), g, i, k, j,
            None if em_t is None else em_t.data_ptr(),
            0 if em_t is None else em_t.stride(0), 0 if em_t is None else em_t.stride(1),
            obs_ptr, o, None if lengths is None else lengths.data_ptr(), t, row0,
            None if blocks is None else blocks.table.data_ptr(), -1 if blocks is None else blocks.most,
            stream,
        )
    _build.check(lib, rc, "svt_minplus")
    launches["minplus"] += 1


def minplus(
    a: torch.Tensor,
    b: torch.Tensor,
    a_idx: torch.Tensor | None = None,
    argmin: bool = False,
    out: torch.Tensor | None = None,
):
    """``C[g, i, j] = min_k A_g[i, k] + B[g, k, j]`` (kernel
    ``svt_minplus``).

    ``a`` [GA, I, K] f32, any strides (a transposed view costs nothing);
    ``b`` [G, K, J] f32, contiguous. ``A_g`` is ``a[a_idx[g]]`` when
    ``a_idx`` ([G] int64) is given, else ``a[g]``, or the one ``a[0]``
    when GA = 1. Returns ``C`` [G, I, J] f32 and, with ``argmin``, also
    the lowest k of each minimum, [G, I, J] int32 (0 for an all-inf row).
    ``a_idx`` values must lie in ``[0, GA)``: they are not checked on the
    card (that would cost a host sync a launch). ``out``, a contiguous
    [G, I, J] f32 tensor, receives ``C`` in place of a new one.
    """
    if b.device.type == "cpu":
        res = minplus_plain(a, b, a_idx, argmin)
        if out is None:
            return res
        out.copy_(res[0] if argmin else res)
        return (out, res[1]) if argmin else out
    if b.device.type != "cuda":
        raise ValueError(f"no kernel for device {b.device}")
    if a.dim() != 3 or b.dim() != 3:
        raise ValueError(f"a and b must be 3-D, got {tuple(a.shape)} and {tuple(b.shape)}")
    g, k, j = b.shape
    ga, i, ka = a.shape
    for x, name in ((a, "a"), (b, "b")):
        if x.device != b.device or x.dtype != torch.float32:
            raise ValueError(f"{name}: want float32 on {b.device}, got {x.dtype} on {x.device}")
    if ka != k:
        raise ValueError(f"a has K = {ka}, b has K = {k}")
    if not b.is_contiguous():
        raise ValueError("b must be contiguous")
    if max(g, i, k, j) >= 2**31:
        raise ValueError("each of G, I, K, J must be below 2^31")
    if a_idx is None:
        if ga not in (1, g):
            raise ValueError(f"a has {ga} operators for {g} products and no a_idx")
        stride_g = 0 if ga == 1 else a.stride(0)
    else:
        if (a_idx.device != b.device or a_idx.dtype != torch.int64
                or tuple(a_idx.shape) != (g,) or not a_idx.is_contiguous()):
            raise ValueError(f"a_idx: want contiguous int64 ({g},) on {b.device}, got "
                             f"{a_idx.dtype} {tuple(a_idx.shape)} on {a_idx.device}")
        stride_g = a.stride(0)
    if out is None:
        c = torch.empty((g, i, j), dtype=torch.float32, device=b.device)
    else:
        _want(out, "out", torch.float32, (g, i, j), b.device)
        c = out
    arg = torch.empty((g, i, j), dtype=torch.int32, device=b.device) if argmin else None
    if c.numel():
        _launch(a, a_idx, b, c, arg, stride_g, g, i, k, j)
    return (c, arg) if argmin else c


def dense_step_plain(a_view: torch.Tensor, v: torch.Tensor, em_t: torch.Tensor, obs: torch.Tensor,
                     lengths: torch.Tensor | None, t: int, row0: int = 0) -> torch.Tensor:
    """Plain version of :func:`dense_step`: the product
    (:func:`minplus_plain`), then the JAX package's step,
    ``where(t < lengths, em_t[:, obs[t]] + u, v[row0 : row0 + n_out])``."""
    u = minplus_plain(a_view[None], v[None])[0]
    v_new = em_t[:, obs[t].long()] + u
    if lengths is None:
        return v_new
    return torch.where((t < lengths)[None, :], v_new, v[row0 : row0 + u.shape[0]])


def dense_step(a_view: torch.Tensor, v: torch.Tensor, em_t: torch.Tensor, obs: torch.Tensor,
               lengths: torch.Tensor | None, t: int, out: torch.Tensor, *,
               row0: int = 0, blocks: BlockList | None = None,
               stream: int | None = None) -> torch.Tensor:
    """One step of the dense batched decode in one ``svt_minplus`` launch
    (counted under ``minplus``), the emission add and the length mask in
    its epilogue::

        out[i, b] = em_t[i, obs[t, b]] + min_k a_view[i, k] + v[k, b]   where t < lengths[b]
                  = v[row0 + i, b]                                     elsewhere

    (every lane steps where ``lengths`` is None). ``a_view`` [n, n] f32, any
    strides (the decoder passes the transposed view of the untransposed
    matrix); ``v`` and ``out`` [n, B] f32, contiguous and distinct (a
    ping-pong pair of carries); ``em_t`` [n, E] f32, any strides; ``obs``
    [T, B] int32, contiguous; ``lengths`` [B] int32. Symbols must lie in
    ``[0, E)``: the card does not check them. ``blocks``, the block list
    of ``a_view`` (:func:`block_list`), has the kernel read only the
    listed blocks, with the same result (more than one lane: J = 1 takes
    the row arm, which reads every entry).
    ``stream`` (a CUDA stream handle) saves the lookup of the current
    stream a step. Returns ``out``. A CPU tensor takes the plain version.

    A step may also be one row block of a state-sharded step: ``a_view``
    [n_out, K] (the block's rows of the operator), ``v`` the whole [K, B]
    carry, ``out`` and ``em_t`` with ``n_out`` rows; a masked lane keeps
    rows ``row0 .. row0 + n_out - 1`` of ``v``."""
    if v.device.type == "cpu":
        return out.copy_(dense_step_plain(a_view, v, em_t, obs, lengths, t, row0))
    if v.device.type != "cuda":
        raise ValueError(f"no kernel for device {v.device}")
    dev = v.device
    k, lanes = v.shape
    n = a_view.shape[0]
    if not (0 <= row0 and row0 + n <= k):
        raise ValueError(f"rows {row0} .. {row0 + n} of the block lie outside the carry's {k}")
    _want(v, "v", torch.float32, (k, lanes), dev)
    _want(out, "out", torch.float32, (n, lanes), dev)
    _want(a_view, "a_view", torch.float32, (n, k), dev, contiguous=False)
    _want(em_t, "em_t", torch.float32, (n, em_t.shape[1]), dev, contiguous=False)
    _want(obs, "obs", torch.int32, (obs.shape[0], lanes), dev)
    if lengths is not None:
        _want(lengths, "lengths", torch.int32, (lanes,), dev)
    if out.data_ptr() == v.data_ptr():
        raise ValueError("out must not be v: other CTAs still read v")
    if not 0 <= t < obs.shape[0]:
        raise ValueError(f"t = {t} outside obs's {obs.shape[0]} steps")
    if blocks is not None:
        if lanes < 2 or blocks.tiles != -(-n // LIST_ROWS):
            raise ValueError(f"a list of {blocks.tiles} tiles of {LIST_ROWS} rows does not fit "
                             f"{n} rows at {lanes} lanes")
        if a_view.stride(0) != 1 or blocks.table.device != dev:
            raise ValueError("a block list takes the transposed view (stride 1 over rows) and "
                             "its table on the operands' device")
    if n and lanes:
        _launch(a_view, None, v, out, None, 0, 1, n, k, lanes, em_t=em_t,
                obs_ptr=obs.data_ptr() + t * obs.stride(0) * obs.element_size(), lengths=lengths,
                t=t, row0=row0, blocks=blocks, stream=stream)
    return out


def dense_step_mv_plain(a_view: torch.Tensor, v: torch.Tensor, em_t: torch.Tensor, o: int,
                        argmin: bool = False):
    """Plain version of :func:`dense_step_mv`: ``em_t[:, o] + u`` after the
    product (:func:`minplus_plain`), and the product's argmin with
    ``argmin``."""
    res = minplus_plain(a_view[None], v[None, :, None], argmin=argmin)
    u = res[0] if argmin else res
    w = em_t[:, o] + u[0, :, 0]
    return (w, res[1][0, :, 0]) if argmin else w


def dense_step_mv(a_view: torch.Tensor, v: torch.Tensor, em_t: torch.Tensor, o: int,
                  out: torch.Tensor, src: torch.Tensor | None = None, *,
                  stream: int | None = None) -> torch.Tensor:
    """One step of the dense single-sequence decode in one ``svt_minplus``
    launch (counted under ``minplus``): ``out[i] = em_t[i, o] + min_k
    a_view[i, k] + v[k]``, and, where ``src`` is given, the lowest such k
    written into it (int32, a row of the caller's pointer tensor). ``a_view``
    [n, K] f32, any strides; ``v`` [K] and ``out`` [n] f32, contiguous and
    distinct; ``em_t`` [n, E] f32, any strides; ``o`` in ``[0, E)``.
    Returns ``out``. A CPU tensor takes the plain version."""
    if v.device.type == "cpu":
        res = dense_step_mv_plain(a_view, v, em_t, o, argmin=src is not None)
        if src is None:
            return out.copy_(res)
        src.copy_(res[1])
        return out.copy_(res[0])
    if v.device.type != "cuda":
        raise ValueError(f"no kernel for device {v.device}")
    dev = v.device
    n, k = a_view.shape
    _want(a_view, "a_view", torch.float32, (n, k), dev, contiguous=False)
    _want(v, "v", torch.float32, (k,), dev)
    _want(out, "out", torch.float32, (n,), dev)
    _want(em_t, "em_t", torch.float32, (n, em_t.shape[1]), dev, contiguous=False)
    if src is not None:
        _want(src, "src", torch.int32, (n,), dev)
    if out.data_ptr() == v.data_ptr():
        raise ValueError("out must not be v: other CTAs still read v")
    if not 0 <= o < em_t.shape[1]:
        raise ValueError(f"symbol {o} outside [0, {em_t.shape[1]})")
    if n:
        _launch(a_view, None, v, out, src, 0, 1, n, k, 1, em_t=em_t, o=o, stream=stream)
    return out


_shapes: dict[tuple, dict] = {}


def minplus_shape(g: int, i: int, k: int, j: int, device: torch.device, *,
                  i_contiguous: bool = True, argmin: bool = False,
                  blocks: BlockList | None = None) -> dict:
    """The shape ``svt_minplus`` launches for a [g, i, j] output over ``k``
    with A i-contiguous (the batch step's transposed view) or k-contiguous,
    with or without argmin, with or without the block list ``blocks``
    (cached): ``tile`` rows and columns (1 x 1 is
    the J = 1 row arm), ``thread_tile`` (a thread's minima; the row arm's
    1 x 4 is a lane's float4 of k), ``slices`` (thread groups that split a
    stage's k in a CTA), ``threads`` a CTA, ``cluster`` (the CTAs that
    split K, or a tile's listed stages, 1 for none), ``k_split`` (with a
    list, the heaviest tile's share), ``stages`` of the shared-memory ring
    (0 for none), ``resident_ctas`` (the launch's CTAs the card holds at
    once) and ``ctas`` in all."""
    device = torch.device(device)
    most = -1 if blocks is None else blocks.most
    key = (device.index, g, i, k, j, i_contiguous, argmin, most)
    if key not in _shapes:
        lib = _build.library()
        vals = (ctypes.c_int * 10)()
        ctas = ctypes.c_longlong()
        sa_i, sa_k = (1, i) if i_contiguous else (k, 1)
        with torch.cuda.device(device):
            rc = lib.svt_minplus_shape(g, i, k, j, sa_i, sa_k, int(argmin), most, vals,
                                       ctypes.byref(ctas))
        _build.check(lib, rc, "svt_minplus_shape")
        bm, bn, tm, tn, slices, threads, cluster, k_split, stages, resident = vals
        _shapes[key] = {"tile": [bm, bn], "thread_tile": [tm, tn], "slices": slices,
                        "threads": threads, "cluster": cluster, "k_split": k_split,
                        "stages": stages, "resident_ctas": resident, "ctas": ctas.value}
    return _shapes[key]


def minplus_tune(cluster: int = 0) -> None:
    """Pin the tiled arm's cluster size (1-16) for a test or a
    measurement; ``minplus_tune()`` restores the shape function's
    choice."""
    _build.library().svt_minplus_tune(cluster)
    _shapes.clear()
