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
decoder and the specializer goes through (:mod:`.dispatch`), and
:func:`minplus_plain` is its plain version. The wrapper runs the plain
version for CPU tensors and launches the kernel for CUDA tensors; any
other device raises. Each candidate is one f32 add, rounded once, and the
min is exact, so every function here gives the same bits whatever order
it takes K in.
"""

from __future__ import annotations

import ctypes

import torch

from spec_viterbi_tpu_torch.ops import _build

INF = float("inf")

# elements of the [G, I, k_block, J] candidate block of the plain version
PLAIN_BLOCK_ELEMS = 1 << 25

# Launch count of svt_minplus; the wrapper adds one where it launches the
# kernel and nowhere else.
launches = {"minplus": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


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
    elif (out.device != b.device or out.dtype != torch.float32 or tuple(out.shape) != (g, i, j)
          or not out.is_contiguous()):
        raise ValueError(f"out: want contiguous float32 {(g, i, j)} on {b.device}, got "
                         f"{out.dtype} {tuple(out.shape)} on {out.device}")
    else:
        c = out
    arg = torch.empty((g, i, j), dtype=torch.int32, device=b.device) if argmin else None
    if c.numel():
        # K split over CTAs: the wrapper allocates the splits' workspace
        splits = minplus_shape(g, i, k, j, b.device)["splits"]
        ws = ws_arg = None
        if splits > 1:
            ws = torch.empty((splits, g, i, j), dtype=torch.float32, device=b.device)
            if argmin:
                ws_arg = torch.empty((splits, g, i, j), dtype=torch.int32, device=b.device)
        lib = _build.library()
        with torch.cuda.device(b.device):
            rc = lib.svt_minplus(
                a.data_ptr(), None if a_idx is None else a_idx.data_ptr(), b.data_ptr(),
                c.data_ptr(), None if arg is None else arg.data_ptr(),
                stride_g, a.stride(1), a.stride(2), g, i, k, j,
                None if ws is None else ws.data_ptr(), None if ws_arg is None else ws_arg.data_ptr(),
                torch.cuda.current_stream(b.device).cuda_stream,
            )
            _build.check(lib, rc, "svt_minplus")
            launches["minplus"] += 1
    return (c, arg) if argmin else c


_shapes: dict[tuple, dict] = {}


def minplus_shape(g: int, i: int, k: int, j: int, device: torch.device) -> dict:
    """The shape ``svt_minplus`` launches for a [g, i, j] output over ``k``
    (cached): tile rows and columns (1 x 1 is the J = 1 row arm), threads
    a CTA, CTAs, and the splits of K over CTAs."""
    device = torch.device(device)
    key = (device.index, g, i, k, j)
    if key not in _shapes:
        lib = _build.library()
        bm, bn, threads, splits = (ctypes.c_int() for _ in range(4))
        ctas = ctypes.c_longlong()
        with torch.cuda.device(device):
            rc = lib.svt_minplus_shape(g, i, k, j, ctypes.byref(bm), ctypes.byref(bn),
                                       ctypes.byref(threads), ctypes.byref(ctas), ctypes.byref(splits))
        _build.check(lib, rc, "svt_minplus_shape")
        _shapes[key] = {"tile": [bm.value, bn.value], "threads": threads.value, "ctas": ctas.value,
                        "splits": splits.value}
    return _shapes[key]
