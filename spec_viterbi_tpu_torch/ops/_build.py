"""Builds the CUDA kernels in ``csrc/`` and loads them with ctypes.

The sources are compiled with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, on first use and never on import, into
``spec_viterbi_tpu_torch/.build/`` (listed in ``.gitignore``): one
``nvcc`` per source, all started together, then one link. The library
name carries a hash of the sources and flags, so an edited source builds
anew. A build failure raises.

The ctypes structures here mirror the descriptor structs of
``csrc/common.cuh`` and ``csrc/scores.cu`` field for field;
:func:`library` checks their sizes against the library's own ``sizeof``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / ".build"

# svt_backtrace's staged walk (csrc/path.cu). The kernel reads these from
# the -D flags below and probes/emulation.py from here, so the two share
# one value of each.
BT_TILE = 32  # steps a tile (a warp's lanes hold one state each)
BT_BAND = 64  # pointers staged a step: a multiple of 8 (16-byte copies)
BT_AHEAD = 1  # tiles in flight ahead of the walk
BT_JUMP = 16  # a step that moves the state further starts a new stretch
BT_MIN_ROWS = 4  # steps a stretch needs before its drift is taken

# no --use_fast_math: flush-to-zero and approximate adds break bit-equality
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    f"-DSVT_BT_TILE={BT_TILE}", f"-DSVT_BT_BAND={BT_BAND}", f"-DSVT_BT_AHEAD={BT_AHEAD}",
    f"-DSVT_BT_JUMP={BT_JUMP}", f"-DSVT_BT_MIN_ROWS={BT_MIN_ROWS}",
)

# caps of the descriptors, as #defined in csrc/common.cuh
MAX_DIAG = 8
MAX_ROW = 24
MAX_COL = 24
MAX_RES = 8
MAX_SPECIAL = 40
MAX_UNI = 24
MAX_CANDS = 216

# usable shared memory of one block on an H100 (bytes)
MAX_SMEM = 232448

# the window kernels' staged arm (csrc/window.cu): shared memory a CTA at
# most, lanes a CTA
WINDOW_STAGED_SMEM = 56 * 1024
WINDOW_STAGED_LANES = 4

SP_USE_ACC = 1
SP_SHARED = 2
ST_SHARED = 1
ST_BULK = 2
ST_SPECIAL = 4
ST_USE_ACC = 8


class ScoresDesc(ctypes.Structure):
    _fields_ = [
        ("n", ctypes.c_int), ("n_diag", ctypes.c_int), ("n_row", ctypes.c_int),
        ("n_col", ctypes.c_int), ("n_res", ctypes.c_int), ("n_special", ctypes.c_int),
        ("diag_off", ctypes.c_int * MAX_DIAG),
        ("row_idx", ctypes.c_int * MAX_ROW),
        ("col_idx", ctypes.c_int * MAX_COL),
        ("res_src", ctypes.c_int * MAX_RES),
        ("res_dst", ctypes.c_int * MAX_RES),
        ("res_val", ctypes.c_float * MAX_RES),
        ("sp_row", ctypes.c_int * MAX_SPECIAL),
    ]


class FsDesc(ctypes.Structure):
    _fields_ = [
        ("n", ctypes.c_int), ("d", ctypes.c_int),
        ("n_uni", ctypes.c_int), ("n_special", ctypes.c_int),
        ("uni_src", ctypes.c_int * MAX_UNI),
        ("uni_val", ctypes.c_float * MAX_UNI),
        ("sp_row", ctypes.c_int * MAX_SPECIAL),
        ("sp_flags", ctypes.c_int * MAX_SPECIAL),
        ("sp_rmin_base", ctypes.c_float * MAX_SPECIAL),
        ("sp_begin", ctypes.c_int * (MAX_SPECIAL + 1)),
        ("cand_src", ctypes.c_int * MAX_CANDS),
        ("cand_val", ctypes.c_float * MAX_CANDS),
        ("n_real", ctypes.c_int), ("n_col", ctypes.c_int),
        ("col_base", ctypes.c_float * MAX_COL),
        ("sp_col", ctypes.c_int * MAX_SPECIAL),
    ]


_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build() -> Path:
    """Compile the kernels (if this source hash is not built yet);
    returns the path of the shared library."""
    sources = sorted(CSRC.glob("*.cu*"))  # .cu and .cuh
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    lib_path = BUILD_DIR / f"libsvt_kernels_{h.hexdigest()[:16]}.so"
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    work = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    try:
        units = [src for src in sources if src.suffix == ".cu"]
        objs = [work / f"{src.stem}.o" for src in units]
        jobs = [
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            for src, obj in zip(units, objs)
        ]
        procs = [
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for cmd in jobs
        ]
        failed = []
        for cmd, proc in zip(jobs, procs):
            out, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}")
        if failed:
            raise RuntimeError("\n".join(failed))
        tmp = work / "lib.so"
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *(str(o) for o in objs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, lib_path)  # atomic: a concurrent builder sees all or nothing
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.svt_desc_size.argtypes, lib.svt_desc_size.restype = [i32], i32
    lib.svt_error_string.argtypes, lib.svt_error_string.restype = [i32], ctypes.c_char_p
    lib.svt_scores_masked.argtypes = [vp] * 9 + [i32, i32, vp]
    lib.svt_scores_masked.restype = i32
    lib.svt_scores_fs.argtypes = [vp] * 7 + [i32, i32, vp]
    lib.svt_scores_fs.restype = i32
    lib.svt_scores_masked_planned.argtypes = [vp] * 8 + [i32, i32, vp]
    lib.svt_scores_masked_planned.restype = i32
    lib.svt_path.argtypes = [vp] * 10 + [i32, i32, vp]
    lib.svt_path.restype = i32
    lib.svt_path_planned.argtypes = [vp] * 9 + [i32, i32, vp]
    lib.svt_path_planned.restype = i32
    lib.svt_path_occupancy.argtypes = [i32, i32, vp, vp]
    lib.svt_path_occupancy.restype = i32
    lib.svt_backtrace.argtypes = [vp] * 3 + [i32, i32, i32, vp]
    lib.svt_backtrace.restype = i32
    lib.svt_scores_window.argtypes = [vp] * 3 + [i32] * 4 + [vp] * 4 + [i32] * 5 + [vp]
    lib.svt_scores_window.restype = i32
    lib.svt_path_window.argtypes = [vp] * 3 + [i32] * 4 + [vp] * 5 + [i32] * 7 + [vp]
    lib.svt_path_window.restype = i32
    lib.svt_window_occupancy.argtypes = [i32] * 6 + [vp] * 3
    lib.svt_window_occupancy.restype = i32
    lib.svt_probe_pass.argtypes = [i32, i32] + [vp] * 6 + [i32] * 5 + [vp]
    lib.svt_probe_pass.restype = i32
    lib.svt_probe_emsel.argtypes = [i32] + [vp] * 4 + [i32] * 4 + [vp]
    lib.svt_probe_emsel.restype = i32
    lib.svt_scores_variant.argtypes = [i32] + [vp] * 9 + [i32, i32, vp]
    lib.svt_scores_variant.restype = i32
    lib.svt_scores_occupancy.argtypes = [i32, i32, vp, vp]
    lib.svt_scores_occupancy.restype = i32
    lib.svt_scores_fs_shape.argtypes = [i32, i32, vp, vp, vp]
    lib.svt_scores_fs_shape.restype = i32
    for shape in (lib.svt_scores_masked_shape, lib.svt_path_shape):
        shape.argtypes, shape.restype = [vp, i32] + [vp] * 5, i32
    i64 = ctypes.c_longlong
    lib.svt_minplus.argtypes = ([vp] * 5 + [i64] * 3 + [i32] * 4  # the product
                                + [vp, i64, i64, vp, i32, vp, i32, i32]  # the step's epilogue
                                + [vp])
    lib.svt_minplus.restype = i32
    lib.svt_minplus_shape.argtypes = [i32] * 4 + [i64] * 2 + [i32] + [vp] * 2
    lib.svt_minplus_shape.restype = i32
    lib.svt_minplus_tune.argtypes, lib.svt_minplus_tune.restype = [i32], None
    for which, struct in ((0, ScoresDesc), (1, FsDesc)):
        if lib.svt_desc_size(which) != ctypes.sizeof(struct):
            raise RuntimeError(f"{struct.__name__} layout differs from csrc/")
    _lib = lib
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise on a non-zero CUDA error code returned by an entry point."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}: {lib.svt_error_string(rc).decode()}")
