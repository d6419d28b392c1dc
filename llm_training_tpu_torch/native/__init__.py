"""ctypes loader of the host packer (`packing.cc` beside this module).

Counterpart of `llm_training_tpu/native/__init__.py`: the shared object is
built on first use with the system g++ (`-O3 -shared -fPIC -std=c++17`)
into `_build/` (gitignored), named by a hash of the source so an edit
recompiles, under a file lock and a per-process temporary name so
processes that start together (a `datasets.map` with `num_proc`) build it
once and never load a half-written file. The C ABI, ctypes and numpy
buffers are the whole binding.

One divergence from JAX's loader: a failed build or load raises, where
JAX's `lib()` returns None and its callers fall back to Python. The Python
versions (`best_fit_bin_packing_py`, the collators' numpy loops) stay as
the plain versions that the tests hold these functions to.

Nothing is built or loaded when this module is imported.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import logging
import os
import subprocess
from pathlib import Path

import numpy as np

logger = logging.getLogger(__name__)

SOURCE = Path(__file__).resolve().parent / "packing.cc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lib: ctypes.CDLL | None = None

_I64P = ctypes.POINTER(ctypes.c_int64)
_I32P = ctypes.POINTER(ctypes.c_int32)


def build() -> Path:
    """Compile `packing.cc` (once per source hash) and return the library's
    path. Raises with the compiler's output when the build fails."""
    digest = hashlib.sha256(" ".join(FLAGS).encode() + SOURCE.read_bytes()).hexdigest()[:16]
    so_path = BUILD_DIR / f"packing-{digest}.so"
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not so_path.exists():
                tmp_path = so_path.with_suffix(f".tmp-{os.getpid()}")
                cmd = ["g++", *FLAGS, str(SOURCE), "-o", str(tmp_path)]
                try:
                    run = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
                except (OSError, subprocess.SubprocessError) as e:
                    raise RuntimeError(f"the host packer's build failed: {' '.join(cmd)}: "
                                       f"{e}") from e
                if run.returncode != 0:
                    tmp_path.unlink(missing_ok=True)
                    raise RuntimeError(f"the host packer's build failed: {' '.join(cmd)}\n"
                                       f"{run.stdout}{run.stderr}")
                os.rename(tmp_path, so_path)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return so_path


def lib() -> ctypes.CDLL:
    """The loaded library, built on the first call."""
    global _lib
    if _lib is None:
        cdll = ctypes.CDLL(str(build()))
        cdll.bfd_pack.restype = ctypes.c_int64
        cdll.bfd_pack.argtypes = [ctypes.c_int64, _I64P, ctypes.c_int64, _I64P]
        cdll.pad_batch.restype = None
        cdll.pad_batch.argtypes = [
            _I32P, _I32P, _I32P, _I64P, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_int32, _I32P, _I32P, _I32P, _I32P, ctypes.c_int32,
        ]
        _lib = cdll
        logger.info("host packer loaded: %s", SOURCE.name)
    return _lib


def _i64(a: np.ndarray):
    return a.ctypes.data_as(_I64P)


def _i32(a: np.ndarray):
    return a.ctypes.data_as(_I32P)


def bfd_pack(capacity: int, lengths: list[int]) -> list[list[int]]:
    """Best fit in arrival order: the item indices of each bin, the same
    groups as `best_fit_bin_packing_py`. Raises ValueError when an item
    exceeds `capacity` (or is negative)."""
    n = len(lengths)
    arr = np.ascontiguousarray(lengths, np.int64)
    bins = np.empty(n, np.int64)
    num_bins = lib().bfd_pack(capacity, _i64(arr), n, _i64(bins))
    if num_bins < 0:
        raise ValueError(f"an item exceeds capacity {capacity}")
    groups: list[list[int]] = [[] for _ in range(num_bins)]
    for i, b in enumerate(bins.tolist()):
        groups[b].append(i)
    return groups


def pad_batch(
    rows_tokens: list[np.ndarray],
    rows_segments: list[np.ndarray] | None,
    rows_labels: list[np.ndarray] | None,
    width: int,
    pad_id: int,
    ignore_index: int = -100,
    restart_positions: bool = True,
) -> dict[str, np.ndarray]:
    """Right-padded [rows, width] int32 `input_ids`, `segment_ids`, `labels`
    and `position_ids` in one pass: padding gets `pad_id`, segment 0,
    `ignore_index` and position 0; positions restart where the segment id
    changes when `restart_positions`, else run on through the row. Missing
    segments read as 1, missing labels as the tokens."""
    n = len(rows_tokens)
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum([len(r) for r in rows_tokens], out=offsets[1:])

    def flat(rows):
        return np.ascontiguousarray(np.concatenate(rows), np.int32) if n else np.zeros(0, np.int32)

    tokens = flat(rows_tokens)
    segments = flat(rows_segments) if rows_segments is not None else None
    labels = flat(rows_labels) if rows_labels is not None else None
    out = {key: np.empty((n, width), np.int32)
           for key in ("input_ids", "segment_ids", "labels", "position_ids")}
    lib().pad_batch(
        _i32(tokens), _i32(segments) if segments is not None else _I32P(),
        _i32(labels) if labels is not None else _I32P(), _i64(offsets), n, width, pad_id,
        ignore_index, *(_i32(out[key]) for key in out), 1 if restart_positions else 0,
    )
    return out
