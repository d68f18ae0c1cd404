"""The probe kernels' plain versions against the TPU probe bodies.

The probes under ``scripts/`` are timing harnesses around Pallas kernel
bodies. Here each body runs once in interpret mode on the CPU at the tiny
shape ``exp_roofline.py::smoke`` uses (N 256, B 256, 4 substeps): the test
imports the script as a module of its own, sets its shape globals and
replaces its timing harness by one interpret-mode call; nothing under
``scripts/`` or ``spec_viterbi_tpu/`` changes. The port's plain version
(``ops/probes.py``, what the CUDA kernel is held to on the card) then
runs on the same inputs, and the two must agree:

- pass bodies and exact selects: bit-equal (every candidate one f32 add
  rounded once, min exact, the one-hot dot of an exact table exact);
- ablated and bf16 scores kernels: within ``almost_equal_vec`` (±1.0),
  the reference's own contract, because the Pallas decoder selects
  emissions through a bf16 split of a ``BIG``-clamped table where the
  port reads the f32 row; each ablation that ±1.0 is to judge is more
  than ±1.0 from the baseline at the test size, and the one that only
  rounds differently (``short_chain``) is held bit-equal to a numpy
  transcription of its TPU body instead.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from spec_viterbi_tpu.hmm import almost_equal_vec
from spec_viterbi_tpu.models.oracle import viterbi_scores_oracle
from spec_viterbi_tpu.ops import fused_pallas as ref_fused
from spec_viterbi_tpu.ops.structured import StructuredOperator as RefOperator

from spec_viterbi_tpu_torch.convert import structured_operator_from_reference
from spec_viterbi_tpu_torch.io.generators import generate_profile_hmm
from spec_viterbi_tpu_torch.ops import fused, probes
from spec_viterbi_tpu_torch.probes import bounds
from spec_viterbi_tpu_torch.probes.roofline import dense_oracle_scores
from test_torch_host import ref_from_port
from test_torch_kernels import _structured_model

torch.set_num_threads(1)

SCRIPTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts")
# exp_roofline.py::smoke's shape: N, B, lane blocks, substeps
N, B, NB, T_SUB = 256, 256, 2, 4


def _script(name: str):
    """``scripts/<name>.py`` as a fresh module (never the one in sys.modules)."""
    spec = importlib.util.spec_from_file_location(f"probe_script_{name}", os.path.join(SCRIPTS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.N, mod.B, mod.NB, mod.T_SUB, mod.CALLS, mod.REPS = N, B, NB, T_SUB, 1, 1
    return mod


class _InterpretPallas:
    """The ``pl`` a script sees, with every ``pallas_call`` in interpret mode."""

    def __getattr__(self, name):
        return getattr(pl, name)

    @staticmethod
    def pallas_call(*args, **kwargs):
        return pl.pallas_call(*args, **{**kwargs, "interpret": True})


# ---- S1: the pass bodies of exp_roofline.py --------------------------------


@pytest.fixture(scope="module")
def roofline():
    """exp_roofline.py with ``_micro_pallas`` replaced by one interpret-mode
    call of the same pallas_call; ``runs`` keeps (v0, inputs, output).
    With ``runs["lane_uniform"]`` the stream rows are made equal across the
    lanes of a block (the port's stream rows are one per pass, shared by
    every lane)."""
    mod = _script("exp_roofline")
    runs = {"lane_uniform": False}

    def one_call(kernel, extra_inputs, extra_specs, unroll):
        v0 = np.random.default_rng(0).normal(5.0, 1.0, size=(mod.N, mod.B)).astype(np.float32)
        extra = list(extra_inputs)
        if runs["lane_uniform"]:
            extra[0] = np.ascontiguousarray(np.broadcast_to(extra[0][..., :1], extra[0].shape))
        out = pl.pallas_call(
            kernel,
            grid=(mod.NB, mod.T_SUB // unroll),
            in_specs=[pl.BlockSpec((mod.N, mod.BB), lambda i, t: (0, i)), *extra_specs],
            out_specs=pl.BlockSpec((mod.N, mod.BB), lambda i, t: (0, i)),
            out_shape=mod.jax.ShapeDtypeStruct((mod.N, mod.B), np.float32),
            interpret=True,
        )(v0, *extra)
        runs["last"] = (v0, extra, np.asarray(out))
        return 0.0

    mod._micro_pallas = one_call
    return mod, runs


@pytest.mark.parametrize(
    "cls,p",
    [("empty", 0), ("stream", 2), ("neighbour", 2), ("neighbour", 8), ("colred", 2),
     ("colred", 8), ("bcast", 2), ("emission", 2), ("twosym", 0)],
)
def test_pass_plain_equals_tpu_body(roofline, cls, p):
    """Bit-equal: each class against its micro_* body (roll = neighbour,
    mxu = emission)."""
    mod, runs = roofline
    body = {
        "empty": lambda: mod.micro_empty(2), "stream": lambda: mod.micro_stream(p),
        "neighbour": lambda: mod.micro_roll(p), "colred": lambda: mod.micro_colred(p),
        "bcast": lambda: mod.micro_bcast(p), "emission": lambda: mod.micro_mxu(p),
        "twosym": mod.micro_twosym,
    }[cls]
    runs["lane_uniform"] = cls == "stream"
    body()
    v0, extra, want = runs["last"]
    kw = {}
    if cls in ("stream", "neighbour", "colred", "bcast"):
        kw["cols"] = torch.as_tensor(extra[-1].T.copy())  # [N, 16] -> [16, N]
    if cls == "stream":
        kw["bufs"] = torch.as_tensor(extra[0][:, :, 0].copy())  # one row per pass
    if cls == "emission":
        kw["tab"] = torch.as_tensor(extra[0].T.copy())  # [N, E] -> [E, N]
    if cls == "twosym":
        kw["tab"] = torch.as_tensor(extra[0].transpose(0, 2, 1).copy())  # [12, N, E] -> [12, E, N]
    if cls in ("emission", "twosym"):
        kw["obs"] = torch.as_tensor(extra[1][:, 0, :].copy())  # [T, 1, B] -> [T, B]
    got = probes.probe_pass(cls, torch.as_tensor(v0), T_SUB, p=p, **kw)
    np.testing.assert_array_equal(got.numpy(), want)


def test_pass_plain_refuses_bad_arguments():
    v0 = torch.zeros((N, 8))
    with pytest.raises(ValueError, match="passes"):
        probes.probe_pass("colred", v0, 2, cols=torch.zeros((16, N)), p=9)
    with pytest.raises(ValueError, match="lanes_per_cta"):
        probes.probe_pass("bcast", v0, 2, cols=torch.zeros((16, N)), p=1, lanes_per_cta=2)
    with pytest.raises(ValueError, match="symbols"):
        probes.probe_pass("emission", v0, 2, tab=torch.zeros((32, N)), p=1)
    with pytest.raises(ValueError, match="no kernel"):
        probes.probe_pass("empty", v0.to("meta"), 2)


# ---- S2: the emission-select ladder of exp_mxu_precision.py ----------------


@pytest.fixture(scope="module")
def mxu_precision():
    """exp_mxu_precision.py with every pallas_call in interpret mode and
    ``_time_calls`` replaced by one call whose output is kept."""
    mod = _script("exp_mxu_precision")
    outs = {}

    def one_call(enqueue, n_substeps):
        outs["last"] = np.asarray(enqueue(0))
        return 0.0

    mod._time_calls = one_call
    mod.pl = _InterpretPallas()
    # micro_mxu_prec's own draws: table and symbols from seed 5, the first
    # carry from seed 0 (the carry of enqueue(0))
    rng = np.random.default_rng(5)
    em = rng.normal(6.0, 1.0, size=(N, mod.E_PAD)).astype(np.float32)
    seq = rng.integers(0, 20, size=(T_SUB, 1, B)).astype(np.int32)
    v0 = np.random.default_rng(0).normal(5.0, 1.0, size=(N, B)).astype(np.float32)
    return mod, outs, em, seq, v0


@pytest.mark.parametrize("p", [1, 2])
@pytest.mark.parametrize(
    "tpu_scheme,scheme",
    [("highest", "gather"), ("bf16", "bf16"), ("split2", "split2"), ("split3", "split3")],
)
def test_emsel_plain_equals_tpu_body(mxu_precision, tpu_scheme, scheme, p):
    """Bit-equal: a one-hot dot of an f32 table at HIGHEST is the exact
    select (the port's direct read), and of exact bf16 terms with f32
    accumulation is the sum of the selected terms in order."""
    mod, outs, em, seq, v0 = mxu_precision
    mod.micro_mxu_prec(tpu_scheme, p)
    tabs = probes.emsel_tables(torch.as_tensor(em.T.copy()), scheme)
    got = probes.probe_emsel(scheme, tabs, torch.as_tensor(v0), torch.as_tensor(seq[:, 0, :].copy()),
                             T_SUB, p)
    np.testing.assert_array_equal(got.numpy(), outs["last"])


def test_emsel_default_is_one_bf16_pass(mxu_precision):
    """The TPU's ``default`` is one bf16 pass; on the CPU JAX's DEFAULT dot
    is exact f32 (it equals ``highest`` here), so ``bf16`` is held against
    a numpy transcription of the TPU's pass instead: the select of the
    table rounded to bf16."""
    import ml_dtypes

    mod, outs, em, seq, v0 = mxu_precision
    mod.micro_mxu_prec("default", 2)
    cpu_default = outs["last"]
    mod.micro_mxu_prec("highest", 2)
    np.testing.assert_array_equal(cpu_default, outs["last"])

    em_bf16 = em.astype(ml_dtypes.bfloat16).astype(np.float32)
    want = v0
    for t in range(T_SUB):
        acc = want + np.float32(0.5)
        for k in range(2):
            acc = np.minimum(acc, em_bf16[:, (seq[t, 0] + k) % 20])
        want = acc
    tabs = probes.emsel_tables(torch.as_tensor(em.T.copy()), "bf16")
    got = probes.probe_emsel("bf16", tabs, torch.as_tensor(v0), torch.as_tensor(seq[:, 0, :].copy()),
                             T_SUB, 2)
    np.testing.assert_array_equal(got.numpy(), want)


def test_tf32_rounding():
    """tf32 keeps 10 mantissa bits, rounding to nearest with ties away
    from zero (cvt.rna)."""
    x = torch.tensor([1.0, 1.0 + 2.0**-11, 1.0 + 2.0**-10 + 2.0**-11, -(1.0 + 2.0**-11), 6.3])
    got = probes.round_tf32(x)
    assert got[:4].tolist() == [1.0, 1.0 + 2.0**-10, 1.0 + 2.0**-9, -(1.0 + 2.0**-10)]
    assert abs(float(got[4]) - 6.3) <= 6.3 * 2.0**-11
    assert (got.view(torch.int32) & 0x1FFF).eq(0).all()


# ---- S3: the lane-block floor of exp_fs_laneblock2.py ----------------------


@pytest.mark.parametrize("lanes_per_cta", [1, 2, 4])
def test_empty_with_symbols_equals_numpy(lanes_per_cta):
    """``empty_run`` adds each step's symbol to the carry. The JAX body
    never receives a starting carry (``exp_fs_laneblock2.py:114-127``), so
    its values are undefined; the port starts from zeros and is held
    against a numpy transcription, bit-equal."""
    rng = np.random.default_rng(7)
    obs = rng.integers(0, 20, size=(40, 16)).astype(np.int32)
    want = np.zeros((N, 16), np.float32)
    for t in range(obs.shape[0]):
        want = want + obs[t].astype(np.float32)[None, :]
    got = probes.probe_pass("empty", torch.zeros((N, 16)), 40, obs=torch.as_tensor(obs),
                            lanes_per_cta=lanes_per_cta)
    np.testing.assert_array_equal(got.numpy(), want)


# ---- S1 3a/3c and S4: the scores variants ----------------------------------


def _pair(model, seqs):
    """(JAX Pallas decoder in interpret mode, port decoder on the CPU, the
    port's staged batch) for one model."""
    ref_sop = RefOperator.from_hmm(model)
    em = model.emission_matrix(pad_to=ref_sop.n)
    pi = model.start_vector(pad_to=ref_sop.n)
    ref = ref_fused.FusedStructuredDecoder(ref_sop, em, pi, interpret=True)
    port = fused.FusedStructuredDecoder(structured_operator_from_reference(ref_sop), em, pi, device="cpu")
    return ref, port, port.prepare(seqs)


def _variant_scores(port, handle, name):
    st, ln, masked = handle
    t = probes.VariantTables.build(port._masked, port.em, probes.variant_flag(name))
    v0 = port.em_t[:, st[0].long()] + port.pi[:, None]
    out = probes.scores_variant(t, v0, st[1:], ln if masked else None)
    return out.T[:, : port.states_num].numpy()


def _ref_variant(ref, seqs, factory, bf16=False):
    """The Pallas decoder's scores with ``_make_unrolled_kernel`` replaced
    by ``factory``, as the TPU harnesses run it: generic column and row
    forms, unmasked. ``_fs_ok`` is cleared too: since the FS kernel took
    uniform batches of FS-class models, ``_scores_core`` routes them to
    ``_pallas_fs`` before the patched factory is reached (and the FS
    kernel then fails on the cleared row plan)."""
    import jax
    import jax.numpy as jnp

    orig = ref_fused._make_unrolled_kernel
    ref_fused._make_unrolled_kernel = factory
    try:
        ref._col_plan = None
        ref._row_plan = None
        ref._fs_ok = False
        if bf16:
            for a in ("dv", "rv", "cv", "resv"):
                setattr(ref, a, getattr(ref, a).astype(jnp.bfloat16))
        run = jax.jit(ref._run, static_argnames=("masked", "b_real"))
        st, ln, _ = ref.prepare(seqs)
        return np.asarray(run(st, ln, masked=False, b_real=len(seqs)))
    finally:
        ref_fused._make_unrolled_kernel = orig


def _profile(match_states=60, seed=3):
    return ref_from_port(generate_profile_hmm(match_states, seed=seed))


@pytest.mark.parametrize("model_id", ["profile", "structured_residual"])
def test_variant_all_off_equals_masked_plain_and_oracle(model_id):
    """No flag, and ``em_staged``: bit-equal to ``scores_masked_plain`` and
    to the oracle, ragged and uniform."""
    rng = np.random.default_rng(11)
    model = _profile() if model_id == "profile" else ref_from_port(_structured_model(rng, 70, 6, (-1, 2), 3))
    for lengths in ([1, 5, 30, 17, 9], [24] * 4):
        seqs = [rng.integers(0, model.emit_num, size=t).astype(np.int32) for t in lengths]
        _, port, handle = _pair(model, seqs)
        st, ln, masked = handle
        v0 = port.em_t[:, st[0].long()] + port.pi[:, None]
        lens = ln if masked else None
        want = fused.scores_masked_plain(port._masked, port.em_t, v0, st[1:], lens)
        for name in ("baseline", "em_staged"):
            t = probes.VariantTables.build(port._masked, port.em, probes.variant_flag(name))
            got = probes.scores_variant(t, v0, st[1:], lens)
            assert torch.equal(got, want)
        got = want.T[:, : port.states_num].numpy()
        for g, s in zip(got, seqs):
            np.testing.assert_array_equal(g, viterbi_scores_oracle(model, s))


def test_variant_bf16_within_tpu_bf16_arm():
    """``bf16_ops`` against ``_make_bf16_kernel`` (interpret mode, as
    ``exp_roofline.py::smoke`` runs it), and both against the oracle:
    within ±1.0. Both round dv/rv/cv/resv and the emission table to bf16."""
    mod = _script("exp_roofline")
    model = _profile(seed=4)
    rng = np.random.default_rng(4)
    seqs = [rng.integers(0, 20, size=48).astype(np.int32) for _ in range(3)]
    ref, port, handle = _pair(model, seqs)
    got = _variant_scores(port, handle, "bf16_ops")
    want = _ref_variant(ref, seqs, mod._make_bf16_kernel, bf16=True)
    for g, w, s in zip(got, want, seqs):
        assert almost_equal_vec(g, w)
        assert almost_equal_vec(g, viterbi_scores_oracle(model, s))
    assert not np.array_equal(got, _variant_scores(port, handle, "baseline"))  # it does round


@pytest.mark.parametrize("name", ["no_cols", "no_em", "no_special", "short_chain", "em_staged"])
def test_variant_ablations_within_tpu_variants(name):
    """Each ablation against ``make_variant_kernel`` with the same flag
    (``make_shortchain_kernel`` for ``short_chain``), factory patched as
    ``time_variant`` patches it, and ``em_staged`` against
    ``_make_embatch_kernel``; within ±1.0 on 16 symbols (the Pallas side
    selects from the bf16 split, ``no_mxu`` from its hi half only).

    For ``no_cols``, ``no_em`` and ``no_special`` the baseline is more than
    ±1.0 from the TPU ablation on every lane, so the limit tells a right
    ablation from one that ignores its flag. ``short_chain`` and
    ``em_staged`` differ from the baseline in rounding at most, so the
    limit cannot: they are held bit for bit instead, ``short_chain`` to a
    numpy transcription of the TPU body's addition order
    (:func:`test_short_chain_plain_equals_tpu_addition_order`),
    ``em_staged`` to ``scores_masked_plain``
    (:func:`test_variant_all_off_equals_masked_plain_and_oracle`)."""
    mod = _script("exp_kernel_variants")
    model = _profile(seed=5)
    rng = np.random.default_rng(5)
    seqs = [rng.integers(0, 20, size=16).astype(np.int32) for _ in range(3)]
    ref, port, handle = _pair(model, seqs)
    if name == "short_chain":
        def factory(sop, masked, u, t0, *a, **kw):
            return mod.make_shortchain_kernel(sop, u)
    elif name == "em_staged":
        factory = _script("exp_roofline")._make_embatch_kernel
    else:
        flag = {"no_cols": "no_cols", "no_em": "no_mxu", "no_special": "no_spec"}[name]

        def factory(sop, masked, u, t0, *a, **kw):
            return mod.make_variant_kernel(sop, u, **{flag: True})
    got = _variant_scores(port, handle, name)
    want = _ref_variant(ref, seqs, factory)
    base = _variant_scores(port, handle, "baseline")
    for g, w, b in zip(got, want, base):
        assert almost_equal_vec(g, w)
        if name not in ("short_chain", "em_staged"):
            assert not almost_equal_vec(b, w)


def _short_chain_numpy(ref_sop, em, v0, obs):
    """``make_shortchain_kernel``'s step in numpy, f32 throughout, with the
    exact emission row ``e`` where the Pallas body selects from the bf16
    split: ``A_k = e + dv_k`` and ``C_k = e + rv_k`` first, then ``vn`` the
    min in candidate order of ``A_k + roll(v, d_k)`` and ``C_k + v[s_k]``,
    then at each column target ``min(vn, e + m)``, ``m`` the min over its
    columns of ``min_j (cv_j + v_j)``."""
    n = ref_sop.n
    v = v0
    for o in obs:
        e = em[o].T  # [n, B]
        cands = [(e + ref_sop.diag_vals[k][:, None]) + np.roll(v, d % n, axis=0)
                 for k, d in enumerate(ref_sop.diag_offsets)]
        cands += [(e + ref_sop.row_vals[k][:, None]) + v[s][None, :] for k, s in enumerate(ref_sop.row_idx)]
        vn = cands[0]
        for cand in cands[1:]:
            vn = np.minimum(vn, cand)
        specials = {}
        for k, c in enumerate(ref_sop.col_idx):
            specials.setdefault(c, []).append((ref_sop.col_vals[k][:, None] + v).min(axis=0))
        vn = vn.copy()
        for row, mins in specials.items():
            m = mins[0]
            for x in mins[1:]:
                m = np.minimum(m, x)
            vn[row] = np.minimum(vn[row], e[row] + m)
        v = vn
    return v


@pytest.mark.parametrize("model_id", ["profile", "structured"])
def test_short_chain_plain_equals_tpu_addition_order(model_id):
    """``short_chain`` against a numpy transcription of
    ``make_shortchain_kernel``'s addition order, bit for bit, on 64
    symbols (models without residual entries, which that body has no code
    for); it does round differently from the baseline."""
    rng = np.random.default_rng(9)
    model = _profile(seed=9) if model_id == "profile" else ref_from_port(_structured_model(rng, 70, 6, (-1, 2), 0))
    ref_sop = RefOperator.from_hmm(model)
    assert ref_sop.residual_nnz == 0 and ref_sop.col_idx and ref_sop.row_idx
    em = model.emission_matrix(pad_to=ref_sop.n)
    pi = model.start_vector(pad_to=ref_sop.n)
    seqs_t = rng.integers(0, model.emit_num, size=(65, 5)).astype(np.int32)
    v0 = em[seqs_t[0]].T + pi[:, None]
    want = _short_chain_numpy(ref_sop, em, v0, seqs_t[1:])

    port = fused.FusedStructuredDecoder(structured_operator_from_reference(ref_sop), em, pi, device="cpu")
    obs = torch.as_tensor(seqs_t[1:])
    got, base = (
        probes.scores_variant(probes.VariantTables.build(port._masked, port.em, probes.variant_flag(name)),
                              torch.as_tensor(v0), obs, None).numpy()
        for name in ("short_chain", "baseline")
    )
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, base)


def test_variant_refuses_two_flags():
    _, port, _ = _pair(_profile(), [np.zeros(3, np.int32)])
    with pytest.raises(ValueError, match="flags"):
        probes.VariantTables.build(port._masked, port.em, 5)


# ---- the dense oracle and the bounds ---------------------------------------


def test_dense_oracle_equals_numpy_oracle():
    """``dense_oracle_scores`` (the drift reference of stage 3a on the
    card) is the numpy oracle batched over lanes, bit for bit."""
    rng = np.random.default_rng(2)
    for model in (_profile(40, seed=2), ref_from_port(_structured_model(rng, 50, 4, (0, -2), 2))):
        seqs = rng.integers(0, model.emit_num, size=(5, 30))
        got = dense_oracle_scores(model, torch.as_tensor(seqs)).numpy()
        for g, s in zip(got, seqs):
            np.testing.assert_array_equal(g, viterbi_scores_oracle(model, s))


def test_bounds_convention():
    """The FS kernel at the serving shape is bound by its operations: 4
    per state and step, 17.4 G at 2,432 × 512 × 3,499, over 33.45 T/s.
    One operator has one count, whichever kernel runs it: the corpus
    shape's plans give 4 ops a state to the FS kernel, the masked kernel
    and the path kernel alike (without the plans it would be 9)."""
    step = bounds.operator_step(2432, 1, 1, 2, planned=True)
    work = bounds.fs_scores(step, 512, 3499, 20)
    assert work.ops == 4 * 2432 * 512 * 3499
    ms, by = work.bound()
    assert by == "operations" and ms == pytest.approx(0.5207, rel=1e-3)
    lane_steps = 512 * 3499
    assert bounds.masked_scores(step, 512, 3499, lane_steps, 20, True).ops == work.ops
    assert bounds.path(step, 512, 3499, lane_steps, 20, False).ops == work.ops
    assert bounds.operator_step(2432, 1, 1, 2, planned=False).ops_per_state == 9
    assert bounds.operator_step(2432, 2, 1, 1, planned=False).ops_per_state == 9
    # the path kernel's 4.36 GB of int16 pointers bound it by bytes
    ms, by = bounds.path(step, 256, 3499, 256 * 3499, 20, False).bound()
    assert by == "bytes" and ms == pytest.approx(1.30, rel=1e-2)
    assert bounds.backtrace(256, 3499).bound() == (pytest.approx(3499 * 256 * 6 / 3.35e9, rel=1e-3), "bytes")
    # the window path kernel writes pointers for the shards' own rows
    # (4 x 608), not for the 2,480 rows of the padded global carry
    geometry = (2, 656, 4, 2480, 256, 3499, 219, 4)
    extra = bounds.window_path(*geometry, block=608).bytes - bounds.window_scores(*geometry).bytes
    assert extra == 3499 * 256 * 4 * 608 * 2
    # a select needs v + 0.5 and one min, whatever the scheme: the one-hot
    # products of the tensor-core schemes are timed apart, not bounded
    for scheme in ("gather", "tf32", "bf16", "split2", "split3"):
        ms, by = bounds.probe_emsel(scheme, 2432, 512, 64, 2).bound()
        assert by == "operations" and ms == pytest.approx(3 * 2432 * 512 * 64 / 33.45e12 * 1e3, rel=1e-3)
    assert bounds.emsel_mma_ms("gather", 2432, 512, 64, 2) == 0.0
    assert bounds.emsel_mma_ms("split2", 2432, 512, 64, 1) == pytest.approx(
        2 * 32 * 2 * 2432 * 512 * 64 / 989e12 * 1e3)
