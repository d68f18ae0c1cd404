"""Compare the SASS of two builds of the kernel library, kernel by kernel.

Run on a machine with the CUDA toolkit::

    python3 spec_viterbi_tpu_torch/probes/sass_diff.py LIB_A LIB_B [--only NAME ...]

Each library is dumped with ``cuobjdump -sass`` and cut at its
``Function :`` lines. What moves between two builds of the same code is
masked: the address and encoding comments, hex immediates, branch labels,
and the anonymous-namespace hash in a kernel's name (it follows the compile
flags). Only instruction lines are compared. One JSON line per kernel
(those whose name holds one of ``--only``, or all): whether the masked
instructions are identical, each build's instruction count, and the first
differing lines.
"""

from __future__ import annotations

import argparse
import difflib
import json
import os
import re
import shutil
import subprocess
import sys

MASKS = (
    (re.compile(r"/\*[0-9a-f]{4,}\*/"), ""),  # addresses
    (re.compile(r"/\* 0x[0-9a-f]+ \*/"), ""),  # encodings
    (re.compile(r"0x[0-9a-f]+"), "0xH"),  # immediates and targets
    (re.compile(r"\.L_x_\d+"), ".L_x_N"),  # branch labels
    (re.compile(r"_GLOBAL__N__[0-9a-f]+"), "_GLOBAL__N__H"),  # anonymous namespaces
)


def _cuobjdump() -> str:
    found = shutil.which("cuobjdump")
    if found:
        return found
    path = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if os.path.exists(path):
        return path
    raise RuntimeError("cuobjdump not found")


def _mask(line: str) -> str:
    for pattern, repl in MASKS:
        line = pattern.sub(repl, line)
    return " ".join(line.split())


def kernels(lib: str) -> dict[str, list[str]]:
    """{masked kernel name: its masked instruction lines} of ``lib``."""
    text = subprocess.run([_cuobjdump(), "-sass", lib], check=True, capture_output=True,
                          text=True).stdout
    out: dict[str, list[str]] = {}
    name = None
    for line in text.splitlines():
        if "Function :" in line:
            name = _mask(line.split("Function :", 1)[1])
            out[name] = []
        elif name is not None and ";" in line:
            out[name].append(_mask(line))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("lib_a")
    ap.add_argument("lib_b")
    ap.add_argument("--only", nargs="*", default=[], help="kernels whose name holds one of these")
    args = ap.parse_args()
    a, b = kernels(args.lib_a), kernels(args.lib_b)
    for name in sorted(set(a) | set(b)):
        if args.only and not any(o in name for o in args.only):
            continue
        ka, kb = a.get(name), b.get(name)
        diff = [] if ka is None or kb is None else [
            d for d in difflib.unified_diff(ka, kb, lineterm="", n=0) if d[:1] in "+-" and d[:3] not in ("+++", "---")]
        print(json.dumps({"kernel": name, "identical": ka == kb, "instructions_a": len(ka or []),
                          "instructions_b": len(kb or []), "diff_lines": len(diff), "first_diff": diff[:12]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
