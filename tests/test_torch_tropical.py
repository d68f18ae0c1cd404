"""The port's (min,+) functions against the JAX package's, bit for bit.

Every function of ``spec_viterbi_tpu_torch/ops/tropical.py`` and
``ops/dispatch.py`` takes the same seeded numpy inputs as its JAX namesake
(XLA on the CPU): real-valued matrices with +inf entries, integer-valued
ones that force argmin ties, and all-inf rows. ``minplus_plain``, the plain
version of the ``svt_minplus`` kernel, is held to a numpy oracle in every
mode (strided views, an index vector, a shared operator, argmin, K in
chunks); on the CPU the wrapper ``minplus`` runs it and counts no launch.
The block list the kernel walks (``block_list``) is held to a
block-by-block count.
"""

import block_operators
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spec_viterbi_tpu.ops import dispatch as ref_dispatch
from spec_viterbi_tpu.ops import tropical as ref_tropical

from spec_viterbi_tpu_torch.ops import dispatch, tropical

torch.set_num_threads(1)

KINDS = ("real", "ties", "inf_rows")


def _mat(rng, shape, kind):
    """Seeded f32 operands: ``real`` normal values with ~20% +inf, ``ties``
    integers in [0, 3] with ~20% +inf (argmin ties everywhere), ``inf_rows``
    the ties with every third leading-axis row all +inf."""
    if kind == "real":
        x = rng.normal(4.0, 2.0, size=shape).astype(np.float32)
    else:
        x = rng.integers(0, 4, size=shape).astype(np.float32)
    x[rng.uniform(size=shape) < 0.2] = np.inf
    if kind == "inf_rows":
        x[::3] = np.inf
    return x


def _eq(got: torch.Tensor, want) -> None:
    want = np.array(want)  # a writable copy of a jax array
    assert got.dtype == torch.from_numpy(want).dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got.numpy(), want)


def _oracle(a_g, b, argmin):
    """numpy ``min_k a_g[g, i, k] + b[g, k, j]`` and its lowest argmin."""
    cand = a_g[:, :, :, None] + b[:, None, :, :]  # [G, I, K, J]
    if argmin:
        return cand.min(axis=2), cand.argmin(axis=2).astype(np.int32)
    return cand.min(axis=2)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n,k", [(7, 13), (16, 16), (1, 5)])
def test_matvec_functions_match_jax(kind, n, k):
    rng = np.random.default_rng(n * 100 + k)
    m = _mat(rng, (n, k), kind)
    v = _mat(rng, (k,), "real" if kind == "real" else "ties")
    tm, tv = torch.from_numpy(m), torch.from_numpy(v)
    jm, jv = jnp.asarray(m), jnp.asarray(v)
    _eq(tropical.tropical_mv(tm, tv), ref_tropical.tropical_mv(jm, jv))
    _eq(dispatch.step_mv(tm, tv), ref_dispatch.step_mv(jm, jv))
    for port_fn, ref_fn in ((tropical.tropical_mv_argmin, ref_tropical.tropical_mv_argmin),
                            (dispatch.step_mv_argmin, ref_dispatch.step_mv_argmin)):
        (u, idx), (ru, ridx) = port_fn(tm, tv), ref_fn(jm, jv)
        _eq(u, ru)
        _eq(idx, ridx)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("i,k,j,k_block", [(9, 13, 5, 8), (8, 16, 3, 8), (5, 7, 4, 3), (3, 1, 2, 8)])
def test_matmul_functions_match_jax(kind, i, k, j, k_block):
    """K off the k_block multiple, on it, and below it."""
    rng = np.random.default_rng(i * 1000 + k * 10 + j)
    a = _mat(rng, (i, k), kind)
    at = _mat(rng, (k, i), kind)
    b = _mat(rng, (k, j), "ties" if kind != "real" else "real")
    ta, tat, tb = (torch.from_numpy(x) for x in (a, at, b))
    ja, jat, jb = (jnp.asarray(x) for x in (a, at, b))
    _eq(tropical.tropical_mm(ta, tb), ref_tropical.tropical_mm(ja, jb))
    _eq(tropical.tropical_mm_blocked(ta, tb, k_block=k_block),
        ref_tropical.tropical_mm_blocked(ja, jb, k_block=k_block))
    _eq(tropical.tropical_mm_tn_blocked(tat, tb, k_block=k_block),
        ref_tropical.tropical_mm_tn_blocked(jat, jb, k_block=k_block))
    _eq(dispatch.batch_step_t(tat, tb), ref_dispatch.batch_step_t(jat, jb))
    _eq(dispatch.matmul_tn(tat, tb), ref_dispatch.matmul_tn(jat, jb))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("argmin", [False, True])
@pytest.mark.parametrize("mode", ["own", "shared", "tn_view", "a_idx"])
@pytest.mark.parametrize("k_block", [None, 3])
def test_minplus_plain_every_mode(kind, argmin, mode, k_block):
    """Each mode of the kernel's interface through its plain version: one
    operator a product, one shared operator, a transposed (strided) view,
    and an index vector with repeats; K = 11 in one chunk or in chunks of
    3, whose merge must keep the lowest k on equal values."""
    rng = np.random.default_rng(KINDS.index(kind) * 8 + argmin * 4 + len(mode))
    g, i, k, j = 4, 6, 11, 5
    b = _mat(rng, (g, k, j), "real" if kind == "real" else "ties")
    if mode == "own":
        a = _mat(rng, (g, i, k), kind)
        ta, a_g, idx = torch.from_numpy(a), a, None
    elif mode == "shared":
        a = _mat(rng, (1, i, k), kind)
        ta, a_g, idx = torch.from_numpy(a), np.repeat(a, g, axis=0), None
    elif mode == "tn_view":
        at = _mat(rng, (k, i), kind)
        ta = torch.from_numpy(at).T[None]  # [1, I, K], stride_i = 1
        assert not ta.is_contiguous()
        a_g, idx = np.repeat(at.T[None], g, axis=0), None
    else:
        a = _mat(rng, (7, i, k), kind)
        sel = np.array([6, 0, 6, 3])
        ta, a_g, idx = torch.from_numpy(a), a[sel], torch.from_numpy(sel)
    got = tropical.minplus_plain(ta, torch.from_numpy(b), idx, argmin=argmin, k_block=k_block)
    want = _oracle(a_g, b, argmin)
    if argmin:
        _eq(got[0], want[0])
        _eq(got[1], want[1])
    else:
        _eq(got, want)


def test_minplus_wrapper_on_cpu_runs_plain():
    rng = np.random.default_rng(5)
    a = torch.from_numpy(_mat(rng, (3, 8, 9), "ties"))
    b = torch.from_numpy(_mat(rng, (3, 9, 4), "ties"))
    tropical.reset_launches()
    c, arg = tropical.minplus(a, b, argmin=True)
    pc, parg = tropical.minplus_plain(a, b, argmin=True)
    assert torch.equal(c, pc) and torch.equal(arg, parg)
    out = torch.empty(3, 8, 4)
    assert tropical.minplus(a, b, out=out) is out and torch.equal(out, pc)
    assert tropical.launches == {"minplus": 0}  # the plain version counts no launch
    with pytest.raises(ValueError, match="no kernel"):
        tropical.minplus(a.to("meta"), b.to("meta"))


def test_all_inf_rows_point_to_zero():
    """A row that no finite candidate reaches: +inf, source 0, in every
    function that returns a source."""
    m = np.full((3, 5), np.inf, np.float32)
    m[1, 3] = 2.0
    v = np.zeros(5, np.float32)
    for fn in (tropical.tropical_mv_argmin, dispatch.step_mv_argmin):
        u, idx = fn(torch.from_numpy(m), torch.from_numpy(v))
        assert u.tolist() == [np.inf, 2.0, np.inf] and idx.tolist() == [0, 3, 0]
    c, arg = tropical.minplus_plain(torch.from_numpy(m)[None], torch.from_numpy(v)[None, :, None],
                                    argmin=True, k_block=2)
    assert arg[0, :, 0].tolist() == [0, 3, 0]


def _step_inputs(rng, kind, n=13, lanes=11, e=5, steps=10):
    """Seeded operands of one dense batch step: the untransposed matrix,
    a carry, the [E, n] emissions and [T, B] symbols."""
    a = _mat(rng, (n, n), kind)
    v = _mat(rng, (n, lanes), "real" if kind == "real" else "ties")
    em = _mat(rng, (e, n), kind)
    obs = rng.integers(0, e, size=(steps, lanes)).astype(np.int32)
    return a, v, em, obs


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("with_lengths", [False, True])
@pytest.mark.parametrize("t", [1, 4, 9])
def test_dense_step_plain_matches_jax_step(kind, with_lengths, t):
    """``dense_step_plain`` against the JAX dense step
    (``spec_viterbi_tpu/models/decoder.py``: ``batch_step_t``, then
    ``em_t[:, s_t] +``, then the ``where`` on ``t < lengths``), with lanes
    below, at and past ``t`` and padded lanes of length 0; the wrapper on
    the CPU gives the same bits into ``out`` and counts no launch."""
    rng = np.random.default_rng(KINDS.index(kind) * 10 + t)
    a, v, em, obs = _step_inputs(rng, kind)
    lanes = v.shape[1]
    lengths = np.array([0, 0, 1, t - 1, t, t, t + 1, t + 2, 10, 3, 7][:lanes], np.int32)
    u = ref_dispatch.batch_step_t(jnp.asarray(a), jnp.asarray(v))
    v_new = jnp.asarray(em).T[:, obs[t]] + u
    want = jnp.where((t < jnp.asarray(lengths))[None, :], v_new, jnp.asarray(v)) if with_lengths else v_new
    ta, tv, tem, tobs = (torch.from_numpy(x) for x in (a, v, em, obs))
    tlen = torch.from_numpy(lengths) if with_lengths else None
    _eq(tropical.dense_step_plain(ta.T, tv, tem.T, tobs, tlen, t), want)
    out = torch.full_like(tv, -1.0)
    tropical.reset_launches()
    assert tropical.dense_step(ta.T, tv, tem.T, tobs, tlen, t, out) is out
    _eq(out, want)
    assert tropical.launches == {"minplus": 0}
    if with_lengths:  # frozen lanes keep the carry's bits, +inf included
        keep = lengths > t
        np.testing.assert_array_equal(out.numpy()[:, ~keep], v[:, ~keep])


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("o", [0, 4])
def test_dense_step_mv_writes_argmin_into_src_row(kind, o):
    """The J = 1 step with its epilogue: ``em_t[:, o] + u`` bit-equal to
    ``minplus_plain`` followed by the add and to the JAX step
    (``step_mv_argmin``, then ``em[o] +``), its argmin written into a row
    of a preallocated pointer tensor and nowhere else."""
    rng = np.random.default_rng(KINDS.index(kind) * 3 + o)
    n, e = 12, 5
    a_t = _mat(rng, (n, n), kind)
    v = _mat(rng, (n,), "real" if kind == "real" else "ties")
    em = _mat(rng, (e, n), kind)
    ta, tv, tem = (torch.from_numpy(x) for x in (a_t, v, em))
    src = torch.full((3, 1, n), -1, dtype=torch.int32)
    out = torch.empty(n)
    assert tropical.dense_step_mv(ta, tv, tem.T, o, out, src[1, 0]) is out
    u, idx = tropical.minplus_plain(ta[None], tv[None, :, None], argmin=True)
    assert torch.equal(out, tem[o] + u[0, :, 0]) and torch.equal(src[1, 0], idx[0, :, 0])
    assert (src[0] == -1).all() and (src[2] == -1).all()
    ru, ridx = ref_dispatch.step_mv_argmin(jnp.asarray(a_t), jnp.asarray(v))
    _eq(out, jnp.asarray(em)[o] + ru)
    _eq(src[1, 0], ridx)
    w, i = tropical.dense_step_mv_plain(ta, tv, tem.T, o, argmin=True)
    assert torch.equal(w, out) and torch.equal(i, src[1, 0])
    assert torch.equal(tropical.dense_step_mv(ta, tv, tem.T, o, torch.empty(n)), out)


def test_dense_step_wrappers_refuse_other_devices():
    a = torch.zeros(4, 4, device="meta")
    v = torch.zeros(4, 2, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tropical.dense_step(a, v, a, torch.zeros(3, 2, dtype=torch.int32, device="meta"), None, 1,
                            torch.empty_like(v))
    with pytest.raises(ValueError, match="no kernel"):
        tropical.dense_step_mv(a, v[:, 0], a, 0, torch.empty(4, device="meta"))


# ---- the block list of svt_minplus -------------------------------------


@pytest.mark.parametrize("name", block_operators.NAMES)
def test_block_list_matches_brute_force(name):
    """``block_list`` against a block-by-block ``isfinite(...).any()`` of
    the batched step's view ``A = a.T`` at 64 rows and 16 k a block,
    padding rows and the ragged last tile and stage included: each tile's
    run holds exactly its blocks with a finite entry, in ascending stage
    order. The fully dense operator gets no list; the all-+inf one lists
    nothing."""
    a = block_operators.operator(name)
    blk = tropical.block_list(np.isfinite(a).T, "cpu")
    want = block_operators.brute_blocks(a, tropical.LIST_ROWS, tropical.STAGE_K)
    assert (blk is None) == bool(want.all()) == (name == "dense")
    if blk is None:
        return
    table = blk.table.numpy()
    assert table.dtype == np.int32 and blk.tiles == len(want)
    off, stages = table[: blk.tiles + 1], table[blk.tiles + 1 :]
    assert off[0] == 0 and len(stages) == off[-1] == blk.listed == int(want.sum())
    for t, held in enumerate(want):
        assert stages[off[t] : off[t + 1]].tolist() == np.nonzero(held)[0].tolist()
    assert blk.most == int(want.sum(axis=1).max())
    if name == "all_inf":
        assert blk.listed == 0 and blk.most == 0


def test_plan7_block_counts():
    """The benchmark's Plan7 operator (LENG 500, 1,024 padded states): 308
    of its 1,024 (64-row, 16-k) blocks hold a finite entry (30.08%), the
    heaviest tile 36 of 64; at 128 rows it would be 228 of 512 (44.53%),
    the heaviest tile 40."""
    a = block_operators.plan7(500)
    blk = tropical.block_list(np.isfinite(a).T, "cpu")
    assert (blk.tiles, blk.listed, blk.most) == (16, 308, 36)
    wide = block_operators.brute_blocks(a, 128, tropical.STAGE_K)
    assert (int(wide.sum()), int(wide.sum(axis=1).max())) == (228, 40)


def test_dense_step_with_a_list_on_the_cpu_runs_plain():
    """``dense_step`` on the CPU takes the plain version and gives the same
    bits with a list as without."""
    a = block_operators.operator("blocky_300")
    blk = tropical.block_list(np.isfinite(a).T, "cpu")
    rng = np.random.default_rng(4)
    v = torch.from_numpy(_mat(rng, (300, 9), "real"))
    em = torch.from_numpy(_mat(rng, (5, 300), "real"))
    obs = torch.from_numpy(rng.integers(0, 5, size=(4, 9)).astype(np.int32))
    ta = torch.from_numpy(a)
    got = tropical.dense_step(ta.T, v, em.T, obs, None, 2, torch.empty_like(v), blocks=blk)
    assert torch.equal(got, tropical.dense_step_plain(ta.T, v, em.T, obs, None, 2))
