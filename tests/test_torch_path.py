"""The exact-path flow of the port against the JAX package.

On the CPU, ``path`` and ``backtrace`` run their plain torch versions (the
kernels themselves are tested on a card by ``test_torch_kernels.py``).
Paths and scores must be bit-equal to ``viterbi_path_oracle`` and to the
JAX XLA structured path (``ViterbiDecoder(mode="structured",
use_pallas=False)``), and the paths equal to the JAX Pallas path kernel's,
run in interpret mode; its scores come through a ``BIG``-clamped carry and
are compared within ``almost_equal_vec``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_property_random import _random_structured_hmm
from test_torch_host import ref_from_port
from test_torch_kernels import (
    COLLISION_ROWS,
    _collision_model,
    _generic_models,
    _negative_zero_carry,
    _negative_zero_model,
    _structured_model,
)

from spec_viterbi_tpu.hmm import almost_equal_vec
from spec_viterbi_tpu.models.decoder import ViterbiDecoder as RefDecoder
from spec_viterbi_tpu.models.oracle import viterbi_path_oracle
from spec_viterbi_tpu.ops import fused_pallas as ref_fused
from spec_viterbi_tpu.ops.structured import StructuredOperator as RefOperator
from spec_viterbi_tpu.ops.structured import structured_mv_argmin as ref_mv_argmin

import spec_viterbi_tpu_torch as port
from spec_viterbi_tpu_torch.convert import hmm_from_reference, structured_operator_from_reference
from spec_viterbi_tpu_torch.io.generators import (
    generate_profile_hmm,
    generate_random_hmm,
    generate_tie_heavy_hmm,
)
from spec_viterbi_tpu_torch.ops import fused
from spec_viterbi_tpu_torch.ops.structured import StructuredOperator, structured_mv_argmin

torch.set_num_threads(1)


def _models():
    """Seeded reference HMMs: corpus-shaped, tie-heavy, random structured
    (negative and zero offsets, residual entries), heavy residual."""
    return {
        "profile": ref_from_port(generate_profile_hmm(126, seed=3)),
        "tie_heavy": ref_from_port(generate_tie_heavy_hmm(300, seed=1)),
        "structured": _random_structured_hmm(np.random.default_rng(17), 60, 5),
        "residual": ref_from_port(_structured_model(np.random.default_rng(8), 70, 6, (-1, 2), 3)),
        "heavy_residual": ref_from_port(generate_random_hmm(37, trans_per_state=9, emit_range=5, seed=7)),
    }


MODELS = _models()


def _seqs(rng, lengths, emit):
    return [rng.integers(0, emit, size=int(t)).astype(np.int32) for t in lengths]


def _pair(model):
    """(JAX Pallas decoder in interpret mode, port decoder on the CPU),
    built from the identical operator."""
    ref_sop = RefOperator.from_hmm(model)
    em = model.emission_matrix(pad_to=ref_sop.n)
    pi = model.start_vector(pad_to=ref_sop.n)
    ref = ref_fused.FusedStructuredDecoder(ref_sop, em, pi, interpret=True)
    got = fused.FusedStructuredDecoder(structured_operator_from_reference(ref_sop), em, pi, device="cpu")
    return ref, got


def _assert_oracle(model, seqs, got):
    for (sc, pa), s in zip(got, seqs):
        want_sc, want_pa = viterbi_path_oracle(model, s)
        np.testing.assert_array_equal(sc, want_sc)
        np.testing.assert_array_equal(pa, want_pa)
        assert pa.dtype == np.int32 and pa.shape == (len(s),) and pa.flags.c_contiguous


def _carry(rng, n, b):
    """Small-integer carries: ties everywhere, +inf, and -0.0 entries."""
    v = rng.integers(0, 4, size=(n, b)).astype(np.float32)
    v[rng.uniform(size=v.shape) < 0.15] = np.inf
    v[(v == 0) & (rng.uniform(size=v.shape) < 0.5)] = -0.0
    return v


@pytest.mark.parametrize("name", sorted(MODELS))
def test_mv_argmin_matches_jax(name):
    """The batched argmin step against the JAX single-lane step, mapped
    over lanes: (u, src) equal."""
    model = MODELS[name]
    ref_sop = RefOperator.from_hmm(model)
    sop = structured_operator_from_reference(ref_sop)
    rng = np.random.default_rng(len(name))
    v = _carry(rng, sop.n, 6)
    want_u, want_src = jax.vmap(
        lambda vv: ref_mv_argmin(ref_sop, ref_sop.device_arrays(), vv), in_axes=1, out_axes=1
    )(jnp.asarray(v))
    u, src = structured_mv_argmin(sop, sop.to("cpu"), torch.as_tensor(v))
    np.testing.assert_array_equal(u.numpy(), np.asarray(want_u))
    np.testing.assert_array_equal(src.numpy(), np.asarray(want_src))


def test_mv_argmin_negative_zero_matches_jax():
    model = ref_from_port(_negative_zero_model())
    ref_sop = RefOperator.from_hmm(model)
    sop = structured_operator_from_reference(ref_sop)
    v = _negative_zero_carry(sop.n)
    want_u, want_src = jax.vmap(
        lambda vv: ref_mv_argmin(ref_sop, ref_sop.device_arrays(), vv), in_axes=1, out_axes=1
    )(jnp.asarray(v))
    u, src = structured_mv_argmin(sop, sop.to("cpu"), torch.as_tensor(v))
    np.testing.assert_array_equal(src.numpy(), np.asarray(want_src))
    np.testing.assert_array_equal(u.numpy(), np.asarray(want_u))
    assert src[model.states_num - 1].tolist() == [3, 1]


@pytest.mark.parametrize("t", [1, 2, 40])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_decode_path_matches_jax_and_oracle(name, t):
    """ViterbiDecoder.decode_path (the plain argmin scan) against the JAX
    XLA structured path and the oracle."""
    model = MODELS[name]
    rng = np.random.default_rng(t)
    seq = rng.integers(0, model.emit_num, size=t).astype(np.int32)
    dec = port.ViterbiDecoder(hmm_from_reference(model), mode="structured", device="cpu")
    got_sc, got_pa = dec.decode_path(seq)
    ref_sc, ref_pa = RefDecoder(model, mode="structured", use_pallas=False).decode_path(seq)
    np.testing.assert_array_equal(got_sc, ref_sc)
    np.testing.assert_array_equal(got_pa, ref_pa)
    _assert_oracle(model, [seq], [(got_sc, got_pa)])


def _cases():
    rng = np.random.default_rng(23)
    tie = MODELS["tie_heavy"]
    dead = _seqs(rng, [40, 31, 12, 40, 2, 1], tie.emit_num - 1)
    dead[0][7] = dead[1][30] = dead[3][39] = tie.emit_num - 1
    return {
        "uniform": ("profile", _seqs(rng, [33] * 6, 20)),
        "ragged": ("profile", _seqs(rng, [1, 2, 17, 40, 9], 20)),
        "bucketed": ("profile", _seqs(rng, list(rng.integers(2, 12, 200)) + list(rng.integers(100, 127, 60)), 20)),
        "dead_symbol": ("tie_heavy", dead),
        "tie_heavy": ("tie_heavy", _seqs(rng, [40] * 8, tie.emit_num - 1)),
        "residual": ("residual", _seqs(rng, [3, 40, 22, 17], 6)),
        "structured": ("structured", _seqs(rng, [25] * 3 + [4], 5)),
    }


CASES = _cases()


@pytest.mark.parametrize("case", sorted(CASES))
def test_fused_path_batch_matches_oracle_and_pallas(case):
    """FusedStructuredDecoder.decode_path_batch of the port (plain
    versions) against the oracle, and against the JAX Pallas path kernel
    in interpret mode on at most 8 lanes."""
    name, seqs = CASES[case]
    model = MODELS[name]
    ref, got_dec = _pair(model)
    got = got_dec.decode_path_batch(seqs)
    if case == "bucketed":
        assert fused.bucket_plan([len(s) for s in seqs], lane_block=fused.BB) is not None
        for (sc, pa), (sc2, pa2) in zip(got, got_dec.decode_path_batch(seqs, bucketed=False)):
            np.testing.assert_array_equal(sc, sc2)
            np.testing.assert_array_equal(pa, pa2)
    _assert_oracle(model, seqs, got)
    some = list(range(0, len(seqs), max(1, len(seqs) // 8)))[:8]
    pallas = ref.decode_path_batch([seqs[i] for i in some])
    for i, (ref_sc, ref_pa) in zip(some, pallas):
        np.testing.assert_array_equal(got[i][1], ref_pa)
        assert almost_equal_vec(got[i][0], ref_sc)


GENERIC_MODELS = {name: ref_from_port(hmm) for name, hmm in _generic_models().items()}


@pytest.mark.parametrize("batch", ["uniform", "ragged"])
@pytest.mark.parametrize("name", sorted(GENERIC_MODELS))
def test_generic_path_arm_matches_jax(name, batch):
    """The models the card tests hold the generic arms on (banded (1, 3),
    tie-heavy banded (-1, 1), a model at the caps): the port's generic path
    arm (on the CPU, path_plain and backtrace_plain through
    decode_path_batch) against the oracle and the JAX XLA structured path
    bit for bit, and the JAX Pallas path kernel in interpret mode (paths
    equal, scores within ±1.0)."""
    model = GENERIC_MODELS[name]
    ref, fd = _pair(model)
    assert not fd._fs_ok and fd._path_arm is fd._masked
    rng = np.random.default_rng(len(name) * 3 + len(batch))
    live = model.emit_num - (name == "tie_banded")
    lengths = [24] * 5 if batch == "uniform" else [1, 2, 24, 9, 17]
    seqs = _seqs(rng, lengths, live)
    seqs[-1][-1] = model.emit_num - 1
    got = fd.decode_path_batch(seqs)
    _assert_oracle(model, seqs, got)
    xla = RefDecoder(model, mode="structured", use_pallas=False)
    for (sc, pa), (ref_sc, ref_pa), s in zip(got, ref.decode_path_batch(seqs), seqs):
        want_sc, want_pa = xla.decode_path(s)
        np.testing.assert_array_equal(sc, want_sc)
        np.testing.assert_array_equal(pa, want_pa)
        np.testing.assert_array_equal(pa, ref_pa)
        assert almost_equal_vec(sc, ref_sc)


@pytest.mark.parametrize("case", ["uniform", "ragged", "bucketed"])
def test_planned_path_arm_matches_generic_oracle_and_jax(case):
    """The planned arm of path (on the CPU: path_planned_plain, the
    two-pass column argmin included) against the generic arm (carry and
    pointers, masked and unmasked), and its decodes against the oracle,
    the JAX XLA structured path and the Pallas path kernel in interpret
    mode (at most 8 lanes)."""
    name, seqs = CASES[case]
    model = MODELS[name]
    ref, fd = _pair(model)
    assert fd._fs_ok and fd._path_arm is fd._fs
    st, ln, _ = fd.prepare(seqs)
    v0 = fd.em_t[:, st[0].long()] + fd.pi[:, None]
    for lens in (ln, None):
        out, src = fused.path_plain(fd._fs, fd.em_t, v0, st[1:], lens)
        g_out, g_src = fused.path_plain(fd._masked, fd.em_t, v0, st[1:], lens)
        assert torch.equal(out, g_out) and torch.equal(src, g_src)
    got = fd.decode_path_batch(seqs)
    _assert_oracle(model, seqs, got)
    some = list(range(0, len(seqs), max(1, len(seqs) // 8)))[:8]
    xla = RefDecoder(model, mode="structured", use_pallas=False)
    for i, (ref_sc, ref_pa) in zip(some, ref.decode_path_batch([seqs[i] for i in some])):
        want_sc, want_pa = xla.decode_path(seqs[i])
        np.testing.assert_array_equal(got[i][0], want_sc)
        np.testing.assert_array_equal(got[i][1], want_pa)
        np.testing.assert_array_equal(got[i][1], ref_pa)


@pytest.mark.parametrize("which", ["negative_zero", "collision"])
def test_planned_step_matches_jax_argmin(which):
    """One planned step against the JAX argmin step on the two hard cases
    of the two-pass column argmin: a -0.0/+0.0 tie and a rounding
    collision (two carries, one column sum); the column target points to
    the lower row in both."""
    if which == "negative_zero":
        hmm = _negative_zero_model()
        v = _negative_zero_carry(StructuredOperator.from_hmm(hmm).n)
        want_last = [3, 1]
    else:
        hmm = _collision_model()
        v = hmm.start_vector(pad_to=StructuredOperator.from_hmm(hmm).n)[:, None].astype(np.float32)
        want_last = [COLLISION_ROWS[0]]
    model = ref_from_port(hmm)
    ref_sop = RefOperator.from_hmm(model)
    _, fd = _pair(model)
    assert fd._fs_ok and fd._path_arm is fd._fs
    want_u, want_src = jax.vmap(
        lambda vv: ref_mv_argmin(ref_sop, ref_sop.device_arrays(), vv), in_axes=1, out_axes=1
    )(jnp.asarray(v))
    obs = torch.zeros((1, v.shape[1]), dtype=torch.int32)
    out, src = fused.path_plain(fd._fs, fd.em_t, torch.as_tensor(v), obs, None)
    np.testing.assert_array_equal(src[0].numpy().T, np.asarray(want_src))
    np.testing.assert_array_equal(out.numpy(), fd.em_t[:, :1].numpy() + np.asarray(want_u))
    assert src[0, :, hmm.states_num - 1].tolist() == want_last


def test_rounding_collision_path_matches_jax():
    """The collision model's decoded path through the planned arm equals
    the oracle's, the JAX XLA structured path's and the Pallas path
    kernel's (interpret mode): the lower of the colliding rows."""
    hmm = _collision_model()
    model = ref_from_port(hmm)
    ref, fd = _pair(model)
    seq = np.array([0, 0], np.int32)
    (sc, pa), = fd.decode_path_batch([seq])
    _assert_oracle(model, [seq], [(sc, pa)])
    assert pa.tolist() == [COLLISION_ROWS[0], hmm.states_num - 1]
    want_sc, want_pa = RefDecoder(model, mode="structured", use_pallas=False).decode_path(seq)
    np.testing.assert_array_equal(sc, want_sc)
    np.testing.assert_array_equal(pa, want_pa)
    np.testing.assert_array_equal(pa, ref.decode_path_batch([seq])[0][1])


def test_path_budget_quantization_fallback():
    """When the quantized bucket length crosses the backpointer budget but
    the real max length fits, the bucket runs at the real length instead
    of raising."""
    model = MODELS["profile"]
    _, fd = _pair(model)
    rng = np.random.default_rng(5)
    lens = list(rng.integers(2, 10, 250)) + list(rng.integers(100, 127, 20))
    seqs = _seqs(rng, lens, model.emit_num)
    assert fused.bucket_plan(lens) is not None
    t_max, n = max(lens), fd.n
    # the budget admits the real max length at 128 lanes but not its quantized one
    fd.MAX_PATH_BYTES = (t_max - 1) * n * 128 * 2 + 1
    assert fd.path_supported(t_max) and not fd.path_supported(fused.quantize_t(t_max))
    got = fd.decode_path_batch(seqs)
    _assert_oracle(model, [seqs[i] for i in (0, 150, 249, 255, 269)],
                   [got[i] for i in (0, 150, 249, 255, 269)])


@pytest.mark.parametrize("case", ["uniform", "ragged", "chunked"])
def test_path_fetch_is_lane_major(case, monkeypatch):
    """decode_path_batch's fetch on a uniform batch, a ragged one of several
    buckets and one cut into lane chunks by the pointer budget: every
    _run_path call hands back a C-contiguous [lanes, T] int32 tensor, and
    every path is a 1-D C-contiguous int32 array of its sequence's length,
    the oracle's, with the oracle's scores bit for bit."""
    model = MODELS["profile"]
    _, fd = _pair(model)
    rng = np.random.default_rng(11)
    lens = {
        "uniform": [40] * 130,
        "ragged": list(rng.integers(2, 12, 200)) + list(rng.integers(100, 127, 60)),
        "chunked": [40] * 256,
    }[case]
    seqs = _seqs(rng, lens, model.emit_num)
    if case == "chunked":
        fd.MAX_PATH_BYTES = (40 - 1) * fd.n * 128 * 2
    calls = fd._path_calls(seqs, bucketed=True)
    assert len(calls) == {"uniform": 1, "ragged": 2, "chunked": 2}[case]
    outs = []
    run_path = fd._run_path
    monkeypatch.setattr(fd, "_run_path", lambda *a, **k: outs.append(run_path(*a, **k)) or outs[-1])
    got = fd.decode_path_batch(seqs)
    for (idx, t_q), (_, paths) in zip(calls, outs, strict=True):
        assert paths.dtype == torch.int32 and paths.is_contiguous()
        assert paths.shape == (len(idx), max(t_q, max(lens[i] for i in idx)))
    _assert_oracle(model, seqs, got)


def test_decoder_path_batch_delegates_and_chunks(monkeypatch):
    """ViterbiDecoder.decode_path_batch reaches the fused path whenever ONE
    128-lane block fits the budget, and lane chunking does the rest."""
    model = MODELS["profile"]
    hmm = hmm_from_reference(model)
    dec = port.ViterbiDecoder(hmm, mode="structured", use_kernels=False, device="cpu")
    _, fd = _pair(model)
    dec._fused = fd  # on the CPU no decoder builds the fused engine itself
    calls = []
    run_path = fd._run_path
    monkeypatch.setattr(fd, "_run_path", lambda *a, **k: calls.append(a[0].shape) or run_path(*a, **k))
    rng = np.random.default_rng(6)
    t, b, n = 40, 256, fd.n
    # one 128-lane call fits, the whole 256-lane batch does not
    fd.MAX_PATH_BYTES = (t - 1) * n * 128 * 2
    assert fd.path_supported(t) and not fd.path_supported(t, b)
    seqs = _seqs(rng, [t] * b, model.emit_num)
    got = dec.decode_path_batch(seqs)
    assert calls == [(t, 128), (t, 128)]
    _assert_oracle(model, [seqs[i] for i in (0, 127, 128, 255)], [got[i] for i in (0, 127, 128, 255)])
    # over budget even at one block: one sequence at a time, the plain scan
    fd.MAX_PATH_BYTES = 1024
    calls.clear()
    got = dec.decode_path_batch(seqs[:3])
    assert calls == []
    _assert_oracle(model, seqs[:3], got)


def test_whole_batch_path_budget_refusal():
    """bucketed=False refuses an over-budget shape before any launch."""
    _, fd = _pair(MODELS["profile"])
    seqs = [np.zeros(64, np.int32) for _ in range(4)]
    fd.MAX_PATH_BYTES = 1024  # force the budget wall
    with pytest.raises(ValueError, match="budget"):
        fd.decode_path_batch(seqs, bucketed=False)


def test_decode_path_validates_input():
    dec = port.ViterbiDecoder(generate_profile_hmm(20, seed=1), mode="structured", device="cpu")
    with pytest.raises(ValueError, match="empty"):
        dec.decode_path(np.array([], np.int32))
    with pytest.raises(ValueError, match="out of range"):
        dec.decode_path(np.array([0, 20], np.int32))
    assert dec.decode_path_batch([]) == []
