"""Probe kernels: wrappers and plain versions of ``csrc/probes.cu`` and
of the flagged masked scores kernel in ``csrc/scores.cu``.

The H100 counterparts of the TPU probes under ``scripts/``, which measure
where a step of the production kernels goes. The runners that time them
are in :mod:`spec_viterbi_tpu_torch.probes`.

- :func:`probe_pass` (kernel ``svt_probe_pass``): P passes of one
  primitive class per step over a lane's carry, the ``micro_*`` bodies of
  ``scripts/exp_roofline.py`` (``_micro_pallas``) and the empty floor of
  ``scripts/exp_fs_laneblock2.py`` (``empty_run``);
- :func:`probe_emsel` (kernel ``svt_probe_emsel``): P emission selects per
  step in one of five schemes, the ladder of
  ``scripts/exp_mxu_precision.py`` (``micro_mxu_prec``);
- :func:`scores_variant` (kernel ``svt_scores_variant``): the generic
  arm of the production masked scores kernel with compile-time flags (no
  flag: that kernel itself), the B1 bodies that
  ``exp_roofline.py`` (``_make_bf16_kernel``, ``_make_embatch_kernel``)
  and ``scripts/exp_kernel_variants.py`` (``make_variant_kernel``,
  ``make_shortchain_kernel``) patch into the Pallas decoder.

Each wrapper runs its plain PyTorch version for CPU tensors and launches
its kernel for CUDA tensors; any other device raises. Launches are
counted in :data:`launches`, apart from ``fused.launches``.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from spec_viterbi_tpu_torch.ops import _build, fused
from spec_viterbi_tpu_torch.ops.structured import (
    OperatorTensors,
    StructuredOperator,
    structured_scores_batch,
)

# pass classes of svt_probe_pass, numbered as in csrc/probes.cu
PASS_CLASSES = ("empty", "stream", "neighbour", "colred", "bcast", "emission", "twosym", "chase",
                "chase_hbm")
CHASE_HOPS = 16  # hops a step at most
# emission-select schemes of svt_probe_emsel, numbered as in csrc/probes.cu
EMSEL_SCHEMES = ("gather", "tf32", "bf16", "split2", "split3")
# flags of svt_scores_variant, one at a time (0: the production kernel)
VARIANT_FLAGS = {
    "bf16_ops": 1, "em_staged": 2, "no_cols": 4, "no_em": 8, "no_special": 16, "short_chain": 32,
}

PROBE_COLS = 16  # columns of the cols operand
COLRED_CAP = 8  # colred passes a step
SYMBOLS = 20  # the probes' alphabet: symbol (o + k) mod 20
EMSEL_E = 32  # rows of the emission table the one-hot spans
EMSEL_LANES = 8  # lanes of one svt_probe_emsel CTA
TWOSYM_TABLES = 12  # value tables of the composed two-symbol step
TWOSYM_RANK1 = 5
EM_STAGE_STEPS = 4  # emission rows a svt_scores_variant EM_STAGED block stages

# Launch counts of the probe kernels; a wrapper adds one where it launches
# its kernel and nowhere else.
launches = {"probe_pass": 0, "probe_emsel": 0, "scores_variant": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _check(device: torch.device, specs) -> None:
    """Raise unless every ``(tensor, dtype, shape, name)`` is a contiguous
    tensor of that type and shape on ``device``."""
    for x, dtype, shape, name in specs:
        if x.device != device or x.dtype != dtype or tuple(x.shape) != tuple(shape):
            raise ValueError(
                f"{name}: want {dtype} {tuple(shape)} on {device}, "
                f"got {x.dtype} {tuple(x.shape)} on {x.device}"
            )
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _kernel_device(x: torch.Tensor) -> torch.device:
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    return x.device


def _ptr(x: torch.Tensor | None):
    return None if x is None else x.data_ptr()


# ---- svt_probe_pass ---------------------------------------------------------


def probe_pass_plain(
    cls: str,
    v0: torch.Tensor,
    steps: int,
    obs: torch.Tensor | None = None,
    cols: torch.Tensor | None = None,
    bufs: torch.Tensor | None = None,
    tab: torch.Tensor | None = None,
    p: int = 0,
) -> torch.Tensor:
    """Plain version of ``svt_probe_pass``: ``steps`` steps of class
    ``cls`` on the carry ``v0`` [n, B] (twosym: ``steps`` symbols, two a
    step). Per step ``acc = v + 0.5``, then ``acc = min(acc, X_k)`` for
    ``k < p``, as ``exp_roofline.py``'s bodies:

    - empty: no X; with ``obs``, ``v + obs[t]`` instead (``empty_run``);
    - stream: ``bufs[k] + cols[k]`` (``bufs`` [P, n]: one row per pass,
      shared by every lane);
    - neighbour: ``cols[k] + roll(v, k % 7 + 1)``;
    - colred: ``v' = min(v + 0.5, min_k min_i (cols[k] + v) + 4)``;
    - bcast: ``cols[k] + v[(37k) mod n]``;
    - emission: ``tab[(obs[t] + k) mod 20]`` (``tab`` [E, n]);
    - twosym: the composed step of ``micro_twosym`` on ``tab``
      [12, E, n];
    - chase, chase_hbm: no pass; lane ``b`` walks ``p`` dependent hops a
      step from state ``b mod n`` through ``tab``, an [n] int16 table
      (chase) or an [R, B, n] one whose row ``(t p + k) mod R`` hop ``k`` of
      step ``t`` reads (chase_hbm); the carry passes through and row 0
      holds each lane's final state.

    ``cols`` is [16, n]: the script's [N, 16] transposed."""
    if cls in ("chase", "chase_hbm"):
        n, b = v0.shape
        state = torch.arange(b, device=v0.device) % n
        lanes = torch.arange(b, device=v0.device)
        for t in range(steps):
            for k in range(p):
                if cls == "chase":
                    state = tab[state].long()
                else:
                    state = tab[(t * p + k) % tab.shape[0], lanes, state].long()
        out = v0.clone()
        out[0] = state.to(v0.dtype)
        return out
    v = v0
    if cls == "twosym":
        def table(j, s):
            return tab[j][s].T  # [n, B]

        for c in range(steps // 2):
            mid, end = obs[2 * c].long(), obs[2 * c + 1].long()
            acc = table(0, mid) + torch.roll(v, 2, dims=0)
            for k in range(TWOSYM_RANK1):
                m = (table(1 + 2 * k, mid) + v).amin(dim=0, keepdim=True)
                acc = torch.minimum(acc, table(2 + 2 * k, mid) + m)
            v = table(11, end) + acc
        return v
    n = v.shape[0]
    for t in range(steps):
        if cls == "empty":
            v = v + (0.5 if obs is None else obs[t].to(v.dtype)[None, :])
            continue
        acc = v + 0.5
        if cls == "colred":
            extra = (cols[:p, :, None] + v[None]).amin(dim=1).amin(dim=0, keepdim=True)
            v = torch.minimum(acc, extra + 4.0)
            continue
        for k in range(p):
            if cls == "stream":
                cand = (bufs[k] + cols[k])[:, None]
            elif cls == "neighbour":
                cand = cols[k][:, None] + torch.roll(v, k % 7 + 1, dims=0)
            elif cls == "bcast":
                cand = cols[k][:, None] + v[(37 * k) % n][None, :]
            elif cls == "emission":
                cand = tab[(obs[t].long() + k) % SYMBOLS].T
            else:
                raise ValueError(f"unknown pass class {cls!r}")
            acc = torch.minimum(acc, cand)
        v = acc
    return v


def probe_pass(
    cls: str,
    v0: torch.Tensor,
    steps: int,
    obs: torch.Tensor | None = None,
    cols: torch.Tensor | None = None,
    bufs: torch.Tensor | None = None,
    tab: torch.Tensor | None = None,
    p: int = 0,
    lanes_per_cta: int = 1,
) -> torch.Tensor:
    """Run ``steps`` steps of pass class ``cls`` (see
    :func:`probe_pass_plain`) on ``v0`` [n, B] f32; returns [n, B].
    ``lanes_per_cta`` (1, 2 or 4; above 1 for ``empty`` only) puts that
    many lanes' carries in one CTA."""
    if cls not in PASS_CLASSES:
        raise ValueError(f"pass class {cls!r} not in {PASS_CLASSES}")
    p_range = {"empty": (0, 0), "colred": (1, COLRED_CAP), "emission": (1, PROBE_COLS),
               "twosym": (0, 0), "chase": (1, CHASE_HOPS),
               "chase_hbm": (1, CHASE_HOPS)}.get(cls, (1, PROBE_COLS))
    if not p_range[0] <= p <= p_range[1]:
        raise ValueError(f"{cls} takes {p_range[0]}..{p_range[1]} passes, got {p}")
    if lanes_per_cta not in (1, 2, 4) or (lanes_per_cta > 1 and cls != "empty"):
        raise ValueError(f"lanes_per_cta {lanes_per_cta}: 1 for every class, 2 or 4 for empty")
    if cls == "twosym" and steps % 2:
        raise ValueError("twosym consumes two symbols a step: steps must be even")
    needs_obs = cls in ("emission", "twosym")
    if cls in ("chase", "chase_hbm") and tab is None:
        raise ValueError(f"{cls} walks tab")
    if needs_obs and obs is None:
        raise ValueError(f"{cls} reads symbols: pass obs")
    if v0.device.type == "cpu":
        return probe_pass_plain(cls, v0, steps, obs, cols, bufs, tab, p)
    dev = _kernel_device(v0)
    n, b = v0.shape
    if b % lanes_per_cta:
        raise ValueError(f"{b} lanes are not a multiple of {lanes_per_cta} lanes per CTA")
    if 2 * lanes_per_cta * n * 4 + (2 * n if cls == "chase" else 0) + 1024 > _build.MAX_SMEM:
        raise ValueError(f"{n} states x {lanes_per_cta} lanes do not fit one block's shared memory")
    specs = [(v0, torch.float32, (n, b), "v0")]
    if obs is not None:
        specs.append((obs, torch.int32, (max(steps, obs.shape[0]), b), "obs"))
    if cls in ("stream", "neighbour", "colred", "bcast"):
        if cols is None:
            raise ValueError(f"{cls} reads cols")
        specs.append((cols, torch.float32, (PROBE_COLS, n), "cols"))
    if cls == "stream":
        if bufs is None:
            raise ValueError("stream reads bufs")
        specs.append((bufs, torch.float32, (max(p, bufs.shape[0]), n), "bufs"))
    e = 0
    if cls in ("emission", "twosym") and tab is None:
        raise ValueError(f"{cls} reads tab")
    if cls == "emission":
        e = tab.shape[0]
        specs.append((tab, torch.float32, (max(e, SYMBOLS), n), "tab"))
    if cls == "twosym":
        e = tab.shape[1]
        specs.append((tab, torch.float32, (TWOSYM_TABLES, max(e, SYMBOLS), n), "tab"))
    if cls == "chase":
        specs.append((tab, torch.int16, (n,), "tab"))
    if cls == "chase_hbm":
        e = tab.shape[0]
        specs.append((tab, torch.int16, (max(e, 1), b, n), "tab"))
    _check(dev, specs)
    out = torch.empty_like(v0)
    if b == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(dev):
        rc = lib.svt_probe_pass(
            PASS_CLASSES.index(cls), lanes_per_cta, v0.data_ptr(), _ptr(cols), _ptr(bufs),
            _ptr(tab), _ptr(obs), out.data_ptr(), n, b, steps, p, e,
            torch.cuda.current_stream(dev).cuda_stream,
        )
        _build.check(lib, rc, "svt_probe_pass")
        launches["probe_pass"] += 1
    return out


# ---- svt_probe_emsel --------------------------------------------------------


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 values rounded to tf32 (10 mantissa bits), to nearest with ties
    away from zero, as ``cvt.rna.tf32.f32``; finite input."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def emsel_tables(em: torch.Tensor, scheme: str) -> torch.Tensor:
    """The table terms of ``scheme`` from the emission table ``em`` [E, n]
    f32: [1, E, n] f32 for ``gather`` (as it is) and ``tf32`` (rounded);
    [terms, E, n] bf16 for ``bf16``, ``split2`` and ``split3``, the
    exact-residual split of ``exp_mxu_precision.py::split_bf16``
    (``hi = bf16(em)``, ``lo = bf16(em - hi)``, ...)."""
    em = em.float()
    if scheme == "gather":
        return em[None].contiguous()
    if scheme == "tf32":
        return round_tf32(em)[None].contiguous()
    terms = {"bf16": 1, "split2": 2, "split3": 3}.get(scheme)
    if terms is None:
        raise ValueError(f"scheme {scheme!r} not in {EMSEL_SCHEMES}")
    parts, r = [], em
    for _ in range(terms):
        h = r.to(torch.bfloat16)
        parts.append(h)
        r = r - h.float()
    return torch.stack(parts).contiguous()


def probe_emsel_plain(
    tabs: torch.Tensor, v0: torch.Tensor, obs: torch.Tensor, steps: int, p: int
) -> torch.Tensor:
    """Plain version of ``svt_probe_emsel``: per step ``acc = v + 0.5``,
    then ``acc = min(acc, sel_k)`` for ``k < p``, ``sel_k`` the sum over
    the table terms (in order, in f32) of row ``(obs[t] + k) mod 20``."""
    v = v0
    for t in range(steps):
        acc = v + 0.5
        for k in range(p):
            s = (obs[t].long() + k) % SYMBOLS
            sel = tabs[0][s].float()
            for j in range(1, tabs.shape[0]):
                sel = sel + tabs[j][s].float()
            acc = torch.minimum(acc, sel.T)
        v = acc
    return v


def probe_emsel(
    scheme: str, tabs: torch.Tensor, v0: torch.Tensor, obs: torch.Tensor, steps: int, p: int
) -> torch.Tensor:
    """``steps`` steps of ``p`` emission selects by ``scheme`` from
    ``tabs`` (:func:`emsel_tables`) on ``v0`` [n, B]; returns [n, B]. On
    the card B is a multiple of 8, n of 16, and the table has 32 rows."""
    if scheme not in EMSEL_SCHEMES:
        raise ValueError(f"scheme {scheme!r} not in {EMSEL_SCHEMES}")
    if p < 1:
        raise ValueError("p must be at least 1")
    if v0.device.type == "cpu":
        return probe_emsel_plain(tabs, v0, obs, steps, p)
    dev = _kernel_device(v0)
    n, b = v0.shape
    if b % EMSEL_LANES or n % 16:
        raise ValueError(f"[{n}, {b}]: the kernel takes n a multiple of 16 and B of {EMSEL_LANES}")
    if n * EMSEL_LANES * 4 > _build.MAX_SMEM:
        raise ValueError(f"{n} states x {EMSEL_LANES} lanes do not fit one block's shared memory")
    terms = {"gather": 1, "tf32": 1, "bf16": 1, "split2": 2, "split3": 3}[scheme]
    dtype = torch.float32 if scheme in ("gather", "tf32") else torch.bfloat16
    _check(dev, [
        (v0, torch.float32, (n, b), "v0"),
        (obs, torch.int32, (max(steps, obs.shape[0]), b), "obs"),
        (tabs, dtype, (terms, EMSEL_E, n), "tabs"),
    ])
    out = torch.empty_like(v0)
    if b == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(dev):
        rc = lib.svt_probe_emsel(
            EMSEL_SCHEMES.index(scheme), v0.data_ptr(), tabs.data_ptr(), obs.data_ptr(),
            out.data_ptr(), n, b, steps, p, torch.cuda.current_stream(dev).cuda_stream,
        )
        _build.check(lib, rc, "svt_probe_emsel")
        launches["probe_emsel"] += 1
    return out


# ---- svt_scores_variant -----------------------------------------------------


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


@dataclasses.dataclass(frozen=True)
class VariantTables:
    """What :func:`scores_variant` needs for one flag set: the kernel's
    operands (bf16 under ``bf16_ops``) and what its plain version runs
    (an operator without its dense columns under ``no_cols``, without its
    special rows under ``no_special``, a one-row emission table under
    ``no_em``, bf16-rounded values under ``bf16_ops``)."""

    flags: int
    n: int
    desc: _build.ScoresDesc
    dv: torch.Tensor  # [D, n]
    rv: torch.Tensor  # [R, n]
    cv: torch.Tensor  # [C, n]
    em: torch.Tensor  # [E, n]
    plain_sop: StructuredOperator
    plain_arrs: OperatorTensors
    plain_em_t: torch.Tensor  # [n, E] f32

    @classmethod
    def build(cls, masked: fused.MaskedTables, em: torch.Tensor, flags: int) -> "VariantTables":
        """``masked``: the operator as ``svt_scores_masked`` takes it;
        ``em``: its [E, n] f32 emission table; ``flags``: 0 or one value
        of :data:`VARIANT_FLAGS`."""
        if flags != 0 and flags not in VARIANT_FLAGS.values():
            raise ValueError(f"flags {flags}: 0 or one of {VARIANT_FLAGS}")
        sop, arrs = masked.sop, masked.arrs
        if len(sop.col_idx) > COLRED_CAP:
            raise ValueError(f"{len(sop.col_idx)} dense columns; the variant kernel takes {COLRED_CAP}")
        desc = _build.ScoresDesc.from_buffer_copy(masked.desc)
        dv, rv, cv = arrs.diag_vals, arrs.row_vals, arrs.col_vals
        plain_sop, plain_arrs, plain_em_t = sop, arrs, em.T.contiguous()
        if flags == VARIANT_FLAGS["bf16_ops"]:
            dv, rv, cv, em = (x.to(torch.bfloat16).contiguous() for x in (dv, rv, cv, em))
            res = _bf16(arrs.res_vals)
            desc.res_val[: res.numel()] = res.tolist()
            plain_arrs = arrs._replace(diag_vals=dv.float(), row_vals=rv.float(),
                                       col_vals=cv.float(), res_vals=res)
            plain_em_t = em.float().T.contiguous()
        elif flags in (VARIANT_FLAGS["no_cols"], VARIANT_FLAGS["no_special"]):
            plain_sop = dataclasses.replace(sop, col_idx=(), col_vals=sop.col_vals[:0])
            plain_arrs = arrs._replace(col_vals=arrs.col_vals[:0])
            if flags == VARIANT_FLAGS["no_special"]:
                plain_sop = dataclasses.replace(
                    plain_sop, res_src=sop.res_src[:0], res_dst=sop.res_dst[:0],
                    res_vals=sop.res_vals[:0])
                plain_arrs = plain_arrs._replace(res_src=arrs.res_src[:0], res_dst=arrs.res_dst[:0],
                                                 res_vals=arrs.res_vals[:0])
        elif flags == VARIANT_FLAGS["no_em"]:
            plain_em_t = em[:1].T.expand(-1, em.shape[0]).contiguous()
        elif flags == VARIANT_FLAGS["em_staged"] and sop.n % 4:
            raise ValueError("em_staged copies 16-byte chunks: n must be a multiple of 4")
        return cls(flags, sop.n, desc, dv.contiguous(), rv.contiguous(), cv.contiguous(),
                   em.contiguous(), plain_sop, plain_arrs, plain_em_t)


def _short_chain_plain(sop, arrs, em_t, v0, obs, lengths):
    """The ``short_chain`` step: ``v' = min((e + dv) + shift(v), (e + rv)
    + v[s])``, and at a special row ``min(that, e + x)``, ``x`` its column
    and residual candidates (``make_shortchain_kernel``)."""
    diag_vals, row_vals, col_vals, res_src, res_dst, res_vals = arrs
    inf = float("inf")
    v = v0
    for k in range(obs.shape[0]):
        e = em_t[:, obs[k].long()]
        a = torch.full_like(v, inf)
        for q, d in enumerate(sop.diag_offsets):
            a = torch.minimum(a, (e + diag_vals[q][:, None]) + torch.roll(v, d, dims=0))
        for r, s in enumerate(sop.row_idx):
            a = torch.minimum(a, (e + row_vals[r][:, None]) + v[s][None, :])
        x = torch.full_like(v, inf)
        if sop.col_idx:
            x[list(sop.col_idx)] = (col_vals[:, :, None] + v[None, :, :]).amin(dim=1)
        if sop.residual_nnz:
            cand = res_vals[:, None] + v[res_src]
            x = x.scatter_reduce(0, res_dst[:, None].expand_as(cand), cand, reduce="amin")
        v_new = torch.minimum(a, e + x)
        if lengths is not None:
            v_new = torch.where(((k + 1) < lengths)[None, :], v_new, v)
        v = v_new
    return v


def scores_variant_plain(
    t: VariantTables, v0: torch.Tensor, obs: torch.Tensor, lengths: torch.Tensor | None
) -> torch.Tensor:
    """Plain version of ``svt_scores_variant``: with no flag (and under
    ``em_staged``) the masked recurrence of ``scores_masked_plain``; under
    an ablation flag, that recurrence on what the flag leaves."""
    if t.flags == VARIANT_FLAGS["short_chain"]:
        return _short_chain_plain(t.plain_sop, t.plain_arrs, t.plain_em_t, v0, obs, lengths)
    return structured_scores_batch(t.plain_sop, t.plain_arrs, t.plain_em_t, v0, obs, lengths)


def scores_variant(
    t: VariantTables, v0: torch.Tensor, obs: torch.Tensor, lengths: torch.Tensor | None
) -> torch.Tensor:
    """Advance ``v0`` [n, B] through ``obs`` [T-1, B] as
    :func:`~spec_viterbi_tpu_torch.ops.fused.scores_masked` does, with the
    flags of ``t``; returns [n, B] f32."""
    if v0.device.type == "cpu":
        return scores_variant_plain(t, v0, obs, lengths)
    dev = _kernel_device(v0)
    n, b = v0.shape
    smem = 2 * n * 4 + (2 * EM_STAGE_STEPS * n * 4 if t.flags == VARIANT_FLAGS["em_staged"] else 0)
    if smem + 4096 > _build.MAX_SMEM:
        raise ValueError(f"{n} states do not fit one block's shared memory")
    op_dtype = t.em.dtype
    specs = [
        (v0, torch.float32, (n, b), "v0"),
        (obs, torch.int32, (obs.shape[0], b), "obs"),
        (t.em, op_dtype, (t.em.shape[0], n), "em"),
        (t.dv, op_dtype, (t.dv.shape[0], n), "dv"),
        (t.rv, op_dtype, (t.rv.shape[0], n), "rv"),
        (t.cv, op_dtype, (t.cv.shape[0], n), "cv"),
    ]
    if lengths is not None:
        specs.append((lengths, torch.int32, (b,), "lengths"))
    _check(dev, specs)
    out = torch.empty_like(v0)
    if b == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(dev):
        rc = lib.svt_scores_variant(
            t.flags, ctypes.byref(t.desc), t.dv.data_ptr(), t.rv.data_ptr(), t.cv.data_ptr(),
            t.em.data_ptr(), v0.data_ptr(), obs.data_ptr(), _ptr(lengths), out.data_ptr(), b,
            obs.shape[0], torch.cuda.current_stream(dev).cuda_stream,
        )
        _build.check(lib, rc, "svt_scores_variant")
        launches["scores_variant"] += 1
    return out


# the kernels scores_occupancy reports: (entry point, which)
OCCUPANCY_KERNELS = {
    "fs": ("svt_scores_occupancy", 0),
    "fs_few_lanes": ("svt_scores_occupancy", 3),
    "masked": ("svt_scores_occupancy", 1),
    "masked_planned": ("svt_scores_occupancy", 2),
    "path": ("svt_path_occupancy", 0),
    "path_planned": ("svt_path_occupancy", 1),
}


def scores_occupancy(kernel: str, n: int, device: torch.device) -> tuple[int, int]:
    """(registers a thread, resident CTAs an SM) for ``n`` states, as the
    card reports them, of ``svt_scores_fs`` (``"fs"``: the shape of many
    lanes; ``"fs_few_lanes"``: the shape one wave of which holds few
    lanes), the generic and planned arms of ``svt_scores_masked``
    (``"masked"``: the shape the generic arm takes for 512 lanes of the
    corpus model's operator, one diagonal, one dense row and two dense
    columns; ``"masked_planned"``) or of ``svt_path`` (``"path"``,
    ``"path_planned"``)."""
    entry, which = OCCUPANCY_KERNELS[kernel]
    if torch.device(device).type != "cuda":
        raise ValueError(f"no kernel for device {device}")
    lib = _build.library()
    regs, ctas = ctypes.c_int(), ctypes.c_int()
    with torch.cuda.device(device):
        rc = getattr(lib, entry)(which, n, ctypes.byref(regs), ctypes.byref(ctas))
    _build.check(lib, rc, entry)
    return regs.value, ctas.value


def variant_flag(name: str) -> int:
    """The flag value of a variant name ("baseline" is 0)."""
    return 0 if name == "baseline" else VARIANT_FLAGS[name]

