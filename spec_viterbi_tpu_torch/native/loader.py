"""Builds the native C++ parsers of ``src/`` and binds them with ctypes.

The C ABI is the JAX package's (``spec_viterbi_tpu/native/loader.py``):
``svt_read_hmm``/``svt_hmm_dims``/``svt_hmm_fill``/``svt_hmm_free`` and
``svt_read_ess``/``svt_ess_dims``/``svt_ess_lengths``/``svt_ess_fill``/
``svt_ess_free``. The library is compiled on first use, never on import,
with ``$CXX`` (``g++`` when it is not set) into
``spec_viterbi_tpu_torch/.build/``; its name carries a hash of the source,
the compiler and the flags, so an edited source builds anew.

Only two things send the readers to the Python tokenizer: no C++ compiler
on ``PATH``, or ``SVT_DISABLE_NATIVE`` set (read at every call). A
compiler that is there but fails raises, with its output. A parse error
returns ``None``, and the Python tokenizer then raises the precise error.
``parses`` counts the files each native reader parsed.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

from spec_viterbi_tpu_torch.hmm import HMM

SRC = Path(__file__).resolve().parent / "src"
BUILD_DIR = Path(__file__).resolve().parent.parent / ".build"
CXX_FLAGS = ("-O3", "-std=c++20", "-Wall", "-Wextra", "-fPIC", "-shared")
SANITIZER_FLAGS = ("-O1", "-g", "-std=c++20", "-Wall", "-Wextra",
                   "-fsanitize=address,undefined", "-fno-omit-frame-pointer")

# files parsed by each native reader; the Python tokenizer counts nothing
parses = {"hmm": 0, "ess": 0}

_lib: ctypes.CDLL | None = None


def compiler() -> str | None:
    """The C++ compiler: ``$CXX`` or ``g++``, resolved on ``PATH``; None
    when there is none."""
    return shutil.which(os.environ.get("CXX") or "g++")


def _compile(cxx: str, flags, sources, out: Path) -> Path:
    """Compile ``sources`` into ``out`` (atomically); raises with the
    compiler's output on a failure."""
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    try:
        tmp = work / out.name
        cmd = [cxx, *flags, "-o", str(tmp), *(str(s) for s in sources)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"native build failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                f"{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, out)  # a concurrent build sees all or nothing
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out


def _tagged(cxx: str, flags, sources, stem: str, suffix: str) -> Path:
    h = hashlib.sha256(" ".join([cxx, *flags]).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"{stem}_{h.hexdigest()[:16]}{suffix}"


def build() -> Path | None:
    """Compile the parser library if this source is not built yet; returns
    its path, or None when there is no C++ compiler."""
    cxx = compiler()
    if cxx is None:
        return None
    sources = [SRC / "svt_native.cpp"]
    return _compile(cxx, CXX_FLAGS, sources, _tagged(cxx, CXX_FLAGS, sources, "libsvt_native", ".so"))


def library() -> ctypes.CDLL | None:
    """The bound library, built on first call; None when the Python
    tokenizer is to run (no compiler, or ``SVT_DISABLE_NATIVE``)."""
    global _lib
    if os.environ.get("SVT_DISABLE_NATIVE"):
        return None
    if _lib is not None:
        return _lib
    path = build()
    if path is None:
        return None
    lib = ctypes.CDLL(str(path))
    _bind(lib)
    _lib = lib
    return lib


def _bind(lib) -> None:
    i64p, f32p, vp = ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_float), ctypes.c_void_p
    lib.svt_read_hmm.restype, lib.svt_read_hmm.argtypes = vp, [ctypes.c_char_p]
    lib.svt_hmm_dims.restype, lib.svt_hmm_dims.argtypes = None, [vp, i64p]
    lib.svt_hmm_fill.restype = None
    lib.svt_hmm_fill.argtypes = [vp, i64p, i64p, f32p, f32p, i64p, f32p]
    lib.svt_hmm_free.restype, lib.svt_hmm_free.argtypes = None, [vp]
    lib.svt_read_ess.restype, lib.svt_read_ess.argtypes = vp, [ctypes.c_char_p]
    lib.svt_ess_dims.restype, lib.svt_ess_dims.argtypes = None, [vp, i64p]
    lib.svt_ess_lengths.restype, lib.svt_ess_lengths.argtypes = None, [vp, i64p]
    lib.svt_ess_fill.restype = None
    lib.svt_ess_fill.argtypes = [vp, ctypes.POINTER(ctypes.c_int32)]
    lib.svt_ess_free.restype, lib.svt_ess_free.argtypes = None, [vp]


def native_available() -> bool:
    return library() is not None


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def read_hmm_native(path: str) -> HMM | None:
    """Parse a ``.chmm`` with the C++ library; None when it is not to run
    or the file does not parse."""
    lib = library()
    if lib is None:
        return None
    handle = lib.svt_read_hmm(os.fsencode(path))
    if not handle:
        return None  # the Python tokenizer raises the precise error
    try:
        dims = (ctypes.c_int64 * 4)()
        lib.svt_hmm_dims(handle, dims)
        n, e, t, s = (int(d) for d in dims)
        trans_rows = np.empty(t, dtype=np.int64)
        trans_cols = np.empty(t, dtype=np.int64)
        trans_probs = np.empty(t, dtype=np.float32)
        emissions = np.empty((e, n), dtype=np.float32)
        start_cols = np.empty(s, dtype=np.int64)
        start_probs = np.empty(s, dtype=np.float32)
        lib.svt_hmm_fill(
            handle,
            _ptr(trans_rows, ctypes.c_int64), _ptr(trans_cols, ctypes.c_int64),
            _ptr(trans_probs, ctypes.c_float), _ptr(emissions, ctypes.c_float),
            _ptr(start_cols, ctypes.c_int64), _ptr(start_probs, ctypes.c_float),
        )
    finally:
        lib.svt_hmm_free(handle)
    hmm = HMM(
        states_num=n,
        emit_num=e,
        trans_rows=trans_rows,
        trans_cols=trans_cols,
        trans_probs=trans_probs,
        emissions=emissions,
        start_probabilities_cols=start_cols,
        start_probabilities=start_probs,
    )
    hmm.validate()
    parses["hmm"] += 1
    return hmm


def read_ess_native(path: str) -> list[np.ndarray] | None:
    """Parse an ``.ess`` with the C++ library; None when it is not to run
    or the file does not parse."""
    lib = library()
    if lib is None:
        return None
    handle = lib.svt_read_ess(os.fsencode(path))
    if not handle:
        return None
    try:
        dims = (ctypes.c_int64 * 2)()
        lib.svt_ess_dims(handle, dims)
        count, total = int(dims[0]), int(dims[1])
        lengths = np.empty(count, dtype=np.int64)
        lib.svt_ess_lengths(handle, _ptr(lengths, ctypes.c_int64))
        flat = np.empty(total, dtype=np.int32)
        lib.svt_ess_fill(handle, _ptr(flat, ctypes.c_int32))
    finally:
        lib.svt_ess_free(handle)
    ends = np.cumsum(lengths)
    parses["ess"] += 1
    return [flat[end - length : end].copy() for end, length in zip(ends.tolist(), lengths.tolist())]


def run_sanitizer_check(model: str, states: int, seqs: str, count: int,
                        bad_model: str, bad_seqs: str) -> str:
    """Build the parsers with the sanitizer harness (``src/
    svt_native_test.cpp``, AddressSanitizer and UBSan) and run it on a
    well-formed model and sequence set and two hostile files; returns its
    output, and raises when the build or a check fails."""
    cxx = compiler()
    if cxx is None:
        raise RuntimeError("no C++ compiler: the sanitizer check cannot be built")
    sources = [SRC / "svt_native.cpp", SRC / "svt_native_test.cpp"]
    exe = _compile(cxx, SANITIZER_FLAGS, sources,
                   _tagged(cxx, SANITIZER_FLAGS, sources, "svt_native_asan_test", ""))
    proc = subprocess.run([str(exe), model, str(states), seqs, str(count), bad_model, bad_seqs],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"native sanitizer check failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
    return proc.stdout
