#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

Run from the repository root::

    python3 chip_smoke.py [--seed N]

Phases, each printed on its own line; any failure raises and the script
exits non-zero:

1. require a CUDA device; print its name and power limit (nvidia-smi);
2. build the kernels from ``spec_viterbi_tpu_torch/csrc`` (build seconds);
3. make a corpus-shaped model (2,407 states × 20 symbols, seeded), write
   it as ``.chmm`` and read it back with the port's ``read_hmm``;
4. make a uniform set (512 × 3,500 symbols) and a ragged set (512
   lengths over 200-3,500), write them as ``.ess`` and read them back;
5. decode through ``ViterbiDecoder(mode="structured", device="cuda")``:
   ``prepare_batch``/``run_batch`` on the uniform set (the FS kernel),
   ``decode_batch`` on the ragged set (the masked kernel, bucketed) and
   ``decode`` on one sequence, with the kernel launch counts read around
   that run;
6. hold each scores kernel against its plain PyTorch version on the card
   at the same shapes: bit-equal (``torch.equal``, +inf at the same places);
7. hold the plain path and both scores kernels against the numpy oracle on
   4 lanes × 64 symbols: bit-equal;
8. ``path_main``: ``decode_path_batch`` on both sets (the path and
   backtrace kernels, 2 uniform calls of 256 lanes and one per ragged
   bucket) and ``decode_path`` on one sequence (the plain argmin scan on
   the card), with the launch counts read around that run; paths of the
   right length and range, scores equal to the scores flow's;
9. ``path_kernel_vs_plain``: the path kernel against its plain version
   (carry and backpointers) and the backtrace kernel against its plain
   version, at one 256-lane uniform call (unmasked) and at the largest
   ragged bucket (masked);
10. ``path_oracle``: paths and scores against ``viterbi_path_oracle`` on a
    prefix of both sets and on a seeded tie-heavy model: bit-equal;
11. ``stream``: the uniform set through ``dec.streaming()`` in chunks of
    999, 1,500 and 1,000 symbols (scores equal to ``run_batch``'s), then
    the ragged set through the path stream with per-lane valid counts and
    a save/load round trip in the middle (paths and scores equal to
    ``decode_path_batch``'s);
12. time kernel and plain version: the scores kernels at the uniform shape,
    the path kernels at one 256-lane call (median of 5; the plain path scan
    on fewer repeats, as its line says).

The line before the card's line is a JSON object with one entry per
kernel; the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

STATES_MATCH = 2405  # + the N and C states: the 2,407-state benchmark model
LANES = 512
T_LEN = 3500
REPEATS = 5
PLAIN_PATH_REPEATS = 2  # the plain path scan takes seconds per call
STREAM_CHUNKS = (999, 1500, 1000)  # after the first symbol: 3,500 in all
NO_PATH_LAUNCHES = {"path": 0, "backtrace": 0}


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def phase(name: str, **fields) -> None:
    print(json.dumps({"phase": name, **fields}), flush=True)


def card_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return proc.stdout.strip().splitlines()[0]


def equal_with_err(a, b) -> tuple[bool, float]:
    """(bit-equal, max |a-b| over the entries finite in both)."""
    import torch

    same_inf = torch.equal(torch.isinf(a), torch.isinf(b))
    fin = torch.isfinite(a) & torch.isfinite(b)
    err = float((a[fin] - b[fin]).abs().max()) if bool(fin.any()) else 0.0
    return torch.equal(a, b) and same_inf, err


def median_ms(fn, repeats: int = REPEATS) -> float:
    """Median of ``repeats`` CUDA-event timings of ``fn`` after one warm-up."""
    import torch

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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0, help="seed of the model and the sequences")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    from spec_viterbi_tpu_torch import (
        ViterbiDecoder,
        read_emit_seq,
        read_hmm,
        viterbi_path_oracle,
        viterbi_scores_oracle,
    )
    from spec_viterbi_tpu_torch.io import (
        generate_profile_hmm,
        generate_tie_heavy_hmm,
        write_chmm,
        write_ess,
    )
    from spec_viterbi_tpu_torch.ops import _build, fused
    from spec_viterbi_tpu_torch.utils.batching import bucket_plan

    card = card_line()
    phase("device", nvidia_smi=card, torch=torch.__version__, cuda=torch.version.cuda)
    dev = torch.device("cuda")

    t0 = time.perf_counter()
    _build.library()
    phase("build", seconds=time.perf_counter() - t0)

    rng = np.random.default_rng(args.seed)
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        write_chmm(generate_profile_hmm(STATES_MATCH, seed=args.seed), f"{tmp}/model.chmm")
        hmm = read_hmm(f"{tmp}/model.chmm")
        phase("model", states=hmm.states_num, symbols=hmm.emit_num, transitions=hmm.trans_num)

        uniform = [rng.integers(0, hmm.emit_num, size=T_LEN).astype(np.int32) for _ in range(LANES)]
        lengths = np.exp(rng.uniform(np.log(200), np.log(T_LEN), size=LANES)).astype(int)
        lengths[:2] = (200, T_LEN)
        ragged = [rng.integers(0, hmm.emit_num, size=int(t)).astype(np.int32) for t in lengths]
        write_ess(uniform, f"{tmp}/uniform.ess")
        write_ess(ragged, f"{tmp}/ragged.ess")
        uniform = read_emit_seq(f"{tmp}/uniform.ess")
        ragged = read_emit_seq(f"{tmp}/ragged.ess")
    plan = bucket_plan([len(s) for s in ragged], lane_block=fused.BB)
    check(plan is not None and len(plan) >= 2, "the ragged set is bucketed")
    phase("sequences", uniform=[LANES, T_LEN], ragged_lanes=len(ragged),
          ragged_symbols=int(sum(len(s) for s in ragged)), buckets=[[len(i), t] for i, t in plan])

    # ---- the main path, with the launch counts read around it ----------
    dec = ViterbiDecoder(hmm, mode="structured", device=dev)
    fd = dec._fused
    check(fd is not None and fd._fs_ok, "the decoder takes the fused kernels, FS class")
    fused.reset_launches()
    secs = {}
    t0 = time.perf_counter()
    handle = dec.prepare_batch(uniform)
    torch.cuda.synchronize()
    secs["uniform_prepare_batch"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    scores_u = dec.run_batch(handle)
    torch.cuda.synchronize()
    secs["uniform_run_batch"] = time.perf_counter() - t0
    check(fused.launches == {"scores_masked": 0, "scores_fs": 1, **NO_PATH_LAUNCHES},
          "uniform batch ran the FS kernel")
    t0 = time.perf_counter()
    scores_r = dec.decode_batch(ragged)
    secs["ragged_decode_batch"] = time.perf_counter() - t0
    check(fused.launches["scores_masked"] == len(plan), "every ragged bucket ran the masked kernel")
    t0 = time.perf_counter()
    scores_1 = dec.decode(uniform[0])
    secs["decode_one"] = time.perf_counter() - t0
    counts = dict(fused.launches)
    check(counts["scores_fs"] > 0 and counts["scores_masked"] > 0, "both kernels launched")
    n_real = hmm.states_num
    u_np = scores_u.cpu().numpy()
    check(u_np.shape == (LANES, fd.n), "uniform scores shape")
    check(bool(np.isinf(u_np[:, n_real:]).all()), "padding states stay +inf")
    check(bool(np.isfinite(u_np[:, :n_real]).all()), "uniform scores finite")
    check(len(scores_r) == LANES and all(s.shape == (n_real,) for s in scores_r), "ragged shapes")
    check(all(bool(np.isfinite(s).all()) for s in scores_r), "ragged scores finite")
    check(np.array_equal(scores_1, u_np[0, :n_real]), "decode() equals lane 0 of run_batch()")
    phase("main_path", seconds=secs, launches=counts)

    # ---- each kernel against its plain version at the main path's shapes
    seqs_t, lens_t, masked = handle
    check(not masked, "uniform batch is unmasked")
    v0 = fd.em_t[:, seqs_t[0].long()] + fd.pi[:, None]
    obs = seqs_t[1:]
    k_fs = fused.scores_fs(fd._fs, fd.em, v0, obs)
    p_fs = fused.scores_fs_plain(fd._fs, fd.em_t, v0, obs)
    same, err_fs = equal_with_err(k_fs, p_fs)
    check(same, "FS kernel == plain at 512 x 3500")
    check(torch.equal(k_fs.T, scores_u), "FS kernel == run_batch output")
    err_masked = 0.0
    for idx, t_q in plan:
        st, ln, m = fd.prepare([ragged[i] for i in idx], t_pad=t_q)
        check(m, "ragged bucket is masked")
        bv0 = fd.em_t[:, st[0].long()] + fd.pi[:, None]
        k = fused.scores_masked(fd._masked, fd.em, bv0, st[1:], ln)
        p = fused.scores_masked_plain(fd._masked, fd.em_t, bv0, st[1:], ln)
        same, err = equal_with_err(k, p)
        check(same, f"masked kernel == plain, bucket of {len(idx)} lanes x {t_q}")
        err_masked = max(err_masked, err)
        k_np = k.T.cpu().numpy()
        check(all(np.array_equal(scores_r[i], k_np[j, :n_real]) for j, i in enumerate(idx)),
              "decode_batch output == masked kernel")
    phase("kernel_vs_plain", fs_max_abs_err=err_fs, masked_max_abs_err=err_masked)

    # ---- plain path and kernels against the numpy oracle on a prefix ---
    small = [s[:64] for s in uniform[:4]]
    small_ragged = [s[: 16 * (j + 1)] for j, s in enumerate(uniform[4:8])]
    want = [viterbi_scores_oracle(hmm, s) for s in small + small_ragged]
    plain_dec = ViterbiDecoder(hmm, use_kernels=False, mode="structured", device=dev)
    check(plain_dec._fused is None, "use_kernels=False pins the plain path")
    plain_got = plain_dec.decode_batch(small + small_ragged, bucketed=False)
    check(all(np.array_equal(g, w) for g, w in zip(plain_got, want)), "plain path == oracle")
    fused.reset_launches()
    kern_got = dec.decode_batch(small) + dec.decode_batch(small_ragged)
    check(fused.launches == {"scores_masked": 1, "scores_fs": 1, **NO_PATH_LAUNCHES},
          "prefix check ran both kernels")
    check(all(np.array_equal(g, w) for g, w in zip(kern_got, want)), "kernels == oracle")
    phase("oracle", lanes=len(want), bit_equal=True)

    # ---- the path main path, with the launch counts read around it -----
    budget = fd._path_lane_budget
    want_calls = -(-LANES // max(fused.BB, budget(T_LEN)))
    want_calls += sum(-(-len(idx) // max(fused.BB, budget(t))) for idx, t in plan)
    fused.reset_launches()
    psecs = {}
    t0 = time.perf_counter()
    paths_u = dec.decode_path_batch(uniform)
    psecs["uniform_decode_path_batch"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    paths_r = dec.decode_path_batch(ragged)
    psecs["ragged_decode_path_batch"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    path_1 = dec.decode_path(uniform[0])
    psecs["decode_path_one"] = time.perf_counter() - t0
    path_counts = dict(fused.launches)
    check(path_counts["path"] == want_calls and path_counts["backtrace"] == want_calls,
          f"every decode_path_batch call ran the path and backtrace kernels ({want_calls} calls)")
    for seqs, got in ((uniform, paths_u), (ragged, paths_r)):
        check(len(got) == len(seqs), "one path per sequence")
        for s, (_, p) in zip(seqs, got):
            check(p.shape == (len(s),) and p.dtype == np.int32, "path length")
            check(bool((p >= 0).all() and (p < n_real).all()), "path states in range")
    check(all(np.array_equal(sc, u_np[i, :n_real]) for i, (sc, _) in enumerate(paths_u)),
          "uniform path scores == run_batch scores")
    check(all(np.array_equal(sc, w) for (sc, _), w in zip(paths_r, scores_r)),
          "ragged path scores == decode_batch scores")
    check(np.array_equal(path_1[0], paths_u[0][0]) and np.array_equal(path_1[1], paths_u[0][1]),
          "decode_path (plain scan) == lane 0 of decode_path_batch")
    phase("path_main", seconds=psecs, launches=path_counts, calls=want_calls)

    # ---- the path kernels against their plain versions -----------------
    half = budget(T_LEN)
    big_idx, big_t = max(plan, key=lambda e: e[1])
    err_path = err_bt = 0.0
    plain_path_s = {}
    for name, seqs, t_pad in (
        ("uniform", uniform[:half], T_LEN),
        ("ragged_bucket", [ragged[i] for i in big_idx], big_t),
    ):
        st, ln, m = fd.prepare(seqs, t_pad=t_pad)
        check(m == (name == "ragged_bucket"), f"{name} call masking")
        pv0 = fd.em_t[:, st[0].long()] + fd.pi[:, None]
        lens = ln if m else None
        k_out, k_src = fused.path(fd._masked, fd.em, pv0, st[1:], lens)
        t0 = time.perf_counter()
        p_out, p_src = fused.path_plain(fd._masked, fd.em_t, pv0, st[1:], lens)
        torch.cuda.synchronize()
        plain_path_s[name] = time.perf_counter() - t0
        same, err = equal_with_err(k_out, p_out)
        check(same, f"path kernel carry == plain, {name} ({len(seqs)} x {st.shape[0] - 1})")
        check(torch.equal(k_src, p_src), f"path kernel backpointers == plain, {name}")
        err_path = max(err_path, err)
        last = torch.argmin(k_out, dim=0).to(torch.int32)
        k_rev = fused.backtrace(k_src, last)
        p_rev = fused.backtrace_plain(k_src, last)
        check(torch.equal(k_rev, p_rev), f"backtrace kernel == plain, {name}")
        err_bt = max(err_bt, float((k_rev - p_rev).abs().max()))
        if name == "uniform":
            check(torch.equal(k_out.T, scores_u[:half]), "path kernel carry == FS kernel scores")
            bt_args = (k_src, last)
            path_args = (pv0, st[1:])
        del k_src, p_src, k_rev, p_rev
    phase("path_kernel_vs_plain", path_max_abs_err=err_path, backtrace_max_abs_err=err_bt,
          plain_path_seconds=plain_path_s)

    # ---- paths against the numpy path oracle ---------------------------
    tie_hmm = generate_tie_heavy_hmm(300, seed=args.seed)
    tie_dec = ViterbiDecoder(tie_hmm, mode="structured", device=dev)
    check(tie_dec._fused is not None, "the tie-heavy model takes the kernels")
    tie_rng = np.random.default_rng(args.seed + 1)
    tie_seqs = [tie_rng.integers(0, tie_hmm.emit_num - 1, size=int(t)).astype(np.int32)
                for t in [64] * 4 + [1, 2, 40, 63]]
    tie_seqs[3][30] = tie_hmm.emit_num - 1  # the dead symbol
    cases = (
        (hmm, dec, [s[:64] for s in uniform[:3]]),
        (hmm, dec, [s[: 16 * (j + 1)] for j, s in enumerate(ragged[3:6])]),
        (tie_hmm, tie_dec, tie_seqs[:4]),
        (tie_hmm, tie_dec, tie_seqs[4:]),
    )
    fused.reset_launches()
    for model, d, seqs in cases:
        for (sc, p), s in zip(d.decode_path_batch(seqs), seqs):
            want_sc, want_p = viterbi_path_oracle(model, s)
            check(np.array_equal(sc, want_sc) and np.array_equal(p, want_p),
                  f"path decode == oracle ({model.states_num} states, {len(s)} symbols)")
    check(fused.launches["path"] == len(cases), "the oracle checks ran the path kernel")
    phase("path_oracle", lanes=sum(len(c[2]) for c in cases), bit_equal=True)

    # ---- streaming on the kernels ----------------------------------------
    eng = dec.streaming()
    check(eng is fd, "streaming() hands out the fused engine")
    block = np.stack(uniform, axis=1)  # [T, B]
    fused.reset_launches()
    ssecs = {}
    t0 = time.perf_counter()
    st = eng.stream_begin(block[0])
    pos = 1
    for w in STREAM_CHUNKS:
        st = eng.stream_feed(st, block[pos : pos + w])
        pos += w
    got = eng.stream_scores(st)
    ssecs["scores_stream"] = time.perf_counter() - t0
    check(fused.launches == {"scores_masked": len(STREAM_CHUNKS), "scores_fs": 0, **NO_PATH_LAUNCHES},
          "one masked launch per feed")
    check(np.array_equal(got, u_np[:, :n_real]), "stream scores == run_batch scores (masked == FS)")
    stream_counts = {"scores": dict(fused.launches)}

    lens_r = np.array([len(s) for s in ragged])
    block_r = np.zeros((T_LEN, LANES), np.int32)
    for i, s in enumerate(ragged):
        block_r[: len(s), i] = s
    fused.reset_launches()
    t0 = time.perf_counter()
    st = eng.stream_begin_path(block_r[0])
    pos = 1
    for k, w in enumerate(STREAM_CHUNKS):
        st = eng.stream_feed_path(st, block_r[pos : pos + w], valid=np.clip(lens_r - pos, 0, w))
        pos += w
        if k == 1:  # persist and resume mid-stream
            with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
                eng.stream_save(st, f"{tmp}/stream.npz")
                loaded = eng.stream_load(f"{tmp}/stream.npz")
            check(torch.equal(loaded.carry, st.carry) and len(loaded.chunks) == 2,
                  "stream_load restores the saved state")
            st = loaded
    check(fused.launches["scores_masked"] == len(STREAM_CHUNKS), "one masked launch per path feed")
    scores_s, paths_s = eng.stream_path_finalize(st)
    torch.cuda.synchronize()
    ssecs["path_stream"] = time.perf_counter() - t0
    check(fused.launches["path"] == len(STREAM_CHUNKS) and fused.launches["backtrace"] == len(STREAM_CHUNKS),
          "finalize ran one path and one backtrace launch per chunk")
    check(paths_s.shape == (LANES, T_LEN), "path stream shape")
    for i, (sc, p) in enumerate(paths_r):
        check(np.array_equal(scores_s[i], sc) and np.array_equal(paths_s[i, : lens_r[i]], p),
              "path stream == decode_path_batch")
    stream_counts["path"] = dict(fused.launches)
    phase("stream", seconds=ssecs, launches=stream_counts, chunks=list(STREAM_CHUNKS))

    # ---- times at the uniform shape ------------------------------------
    steps = obs.shape[0]
    timed = {
        "scores_fs": (
            median_ms(lambda: fused.scores_fs(fd._fs, fd.em, v0, obs)),
            median_ms(lambda: fused.scores_fs_plain(fd._fs, fd.em_t, v0, obs)),
        ),
        "scores_masked": (
            median_ms(lambda: fused.scores_masked(fd._masked, fd.em, v0, obs, lens_t)),
            median_ms(lambda: fused.scores_masked_plain(fd._masked, fd.em_t, v0, obs, lens_t)),
        ),
    }
    for name, (ms, plain_ms) in timed.items():
        phase("time", kernel=name, card=card, lanes=LANES, steps=steps,
              ms=ms, us_per_step=ms * 1e3 / steps, symbols_per_s=LANES * T_LEN / (ms / 1e3),
              plain_ms=plain_ms, plain_us_per_step=plain_ms * 1e3 / steps,
              plain_symbols_per_s=LANES * T_LEN / (plain_ms / 1e3))
    pv0, pobs = path_args
    timed["path"] = (
        median_ms(lambda: fused.path(fd._masked, fd.em, pv0, pobs, None)),
        median_ms(lambda: fused.path_plain(fd._masked, fd.em_t, pv0, pobs, None),
                  repeats=PLAIN_PATH_REPEATS),
    )
    timed["backtrace"] = (
        median_ms(lambda: fused.backtrace(*bt_args)),
        median_ms(lambda: fused.backtrace_plain(*bt_args)),
    )
    for name in ("path", "backtrace"):
        ms, plain_ms = timed[name]
        phase("time", kernel=name, card=card, lanes=half, steps=steps, ms=ms,
              us_per_step=ms * 1e3 / steps, repeats=REPEATS, plain_ms=plain_ms,
              plain_us_per_step=plain_ms * 1e3 / steps,
              plain_repeats=PLAIN_PATH_REPEATS if name == "path" else REPEATS)

    source = "spec_viterbi_tpu_torch/csrc/scores.cu"
    kernels = [
        {"name": "scores_fs", "route": "cuda", "source": source,
         "replaces": "spec_viterbi_tpu/ops/fused_pallas.py:360",
         "launches": counts["scores_fs"], "max_abs_err": err_fs,
         "ms": timed["scores_fs"][0], "plain_ms": timed["scores_fs"][1]},
        {"name": "scores_masked", "route": "cuda", "source": source,
         "replaces": "spec_viterbi_tpu/ops/fused_pallas.py:203",
         "launches": counts["scores_masked"], "max_abs_err": err_masked,
         "ms": timed["scores_masked"][0], "plain_ms": timed["scores_masked"][1]},
        {"name": "path", "route": "cuda", "source": "spec_viterbi_tpu_torch/csrc/path.cu",
         "replaces": "spec_viterbi_tpu/ops/fused_pallas.py:490",
         "launches": path_counts["path"], "max_abs_err": err_path,
         "ms": timed["path"][0], "plain_ms": timed["path"][1]},
        {"name": "backtrace", "route": "cuda", "source": "spec_viterbi_tpu_torch/csrc/path.cu",
         "replaces": "spec_viterbi_tpu/ops/fused_pallas.py:695",
         "launches": path_counts["backtrace"], "max_abs_err": err_bt,
         "ms": timed["backtrace"][0], "plain_ms": timed["backtrace"][1]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
