"""Persistent specialization-operator cache.

A copy of ``spec_viterbi_tpu/utils/cache.py`` (numpy only), with the same
format version and entry names, so either package reads an entry the
other wrote to the same directory; the default directory is the port's own
(``~/.cache/spec_viterbi_tpu_torch``). Precomputed operator stacks are
persisted and loaded on the next specialization: prep cost is paid once
per model per machine.

Format (v3): one directory per ``(kind, hmm fingerprint, level, padded
size)`` holding one ``.npy`` per array. Loads are memory-mapped and
read-only (copy them before handing them to torch). Stores are atomic:
arrays are written into a temp directory that is renamed into place (a
concurrent writer losing the race discards its copy).
"""

from __future__ import annotations

import os
import re
import shutil
import tempfile
import time

import numpy as np

# v3: `kind` joined the directory name (dense/struct schema namespacing);
# the first store sweeps entries of older versions, unreachable under it
_FORMAT_VERSION = 3


class OperatorCache:
    """File-backed cache of specialized operator stacks."""

    def __init__(self, cache_dir: str | None = None):
        self.cache_dir = cache_dir or os.path.join(
            os.path.expanduser("~"), ".cache", "spec_viterbi_tpu_torch"
        )
        self._swept = False

    def _sweep_stale_tmp(self, max_age_s: float = 3600.0) -> None:
        """Remove ``*.tmp`` staging directories older than ``max_age_s``
        (left by a process that died mid-``store``) and entries of older
        format versions. Runs on the first ``store`` only, never on
        construction, so a reader never races a writer out of its entries;
        it matches the full historical entry pattern, so unrelated names in
        a shared directory are never touched."""
        try:
            entries = os.listdir(self.cache_dir)
        except OSError:
            return
        now = time.time()
        old_versions = "|".join(str(v) for v in range(1, _FORMAT_VERSION))
        old_entry = re.compile(rf"^ops_v(?:{old_versions})_.+_L\d+_N\d+$")
        for name in entries:
            stale_tmp = name.endswith(".tmp")
            old_layout = bool(old_entry.match(name))
            if not (stale_tmp or old_layout):
                continue
            p = os.path.join(self.cache_dir, name)
            try:
                if old_layout or now - os.path.getmtime(p) > max_age_s:
                    shutil.rmtree(p, ignore_errors=True)
            except OSError:
                pass

    def _path(self, fingerprint: str, level: int, padded: int, kind: str) -> str:
        # `kind` namespaces incompatible operator schemas
        return os.path.join(
            self.cache_dir,
            f"ops_v{_FORMAT_VERSION}_{kind}_{fingerprint}_L{level}_N{padded}",
        )

    def load(self, fingerprint: str, level: int, padded: int, kind: str = "dense"):
        """Returns a dict of read-only memory-mapped arrays, or None on a
        miss or a corrupt entry (which is dropped)."""
        path = self._path(fingerprint, level, padded, kind)
        if not os.path.isdir(path):
            return None
        try:
            out = {}
            for f in sorted(os.listdir(path)):
                if f.endswith(".npy"):
                    out[f[:-4]] = np.load(os.path.join(path, f), mmap_mode="r")
            return out or None
        except Exception:
            shutil.rmtree(path, ignore_errors=True)
            return None

    def store(
        self, fingerprint: str, level: int, padded: int, arrays: dict,
        kind: str = "dense",
    ) -> None:
        os.makedirs(self.cache_dir, exist_ok=True)
        if not self._swept:  # the first write proves we own this directory
            self._swept = True
            self._sweep_stale_tmp()
        path = self._path(fingerprint, level, padded, kind)
        tmp = tempfile.mkdtemp(dir=self.cache_dir, suffix=".tmp")
        try:
            for k, a in arrays.items():
                np.save(os.path.join(tmp, f"{k}.npy"), np.asarray(a))
            try:
                os.rename(tmp, path)  # atomic publish
            except OSError:
                # another process published first: keep theirs
                shutil.rmtree(tmp, ignore_errors=True)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
