"""Build and load the port's CUDA kernels.

Every `csrc/*.cu` is compiled by plain `nvcc` for sm_90a into one shared
library with a plain C interface, at the first launch of any kernel, into
`_build/` (gitignored). The library's name carries a hash of the sources,
the headers and the flags, and the build runs under a file lock, so
processes that start together build it once. Each source compiles in its
own `nvcc` process, all started together, then one `nvcc` links them. The
library is loaded with `ctypes`; each kernel module declares the argument
types of its own entry points on it.

Nothing is built or loaded when this module is imported.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = (
    *ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lib: ctypes.CDLL | None = None
# what the last build printed (ptxas register/shared-memory report per
# source) and how long it took; empty until a build ran in this process
build_info: dict = {}


def _nvcc() -> str:
    for candidate in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if candidate and os.path.exists(candidate):
            return candidate
    raise RuntimeError("nvcc not found: the port's CUDA kernels cannot be built")


def _digest(sources: list[Path], headers: list[Path]) -> str:
    digest = hashlib.sha256(" ".join(COMPILE_FLAGS).encode())
    for path in [*sources, *headers]:
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    return digest.hexdigest()[:16]


def build_library() -> Path:
    """Compile `csrc/*.cu` (once per source hash) and return the library
    path. Raises with the compiler's output when a step fails."""
    sources = sorted(CSRC.glob("*.cu"))
    headers = sorted(CSRC.glob("*.cuh"))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = BUILD_DIR / f"libport_kernels_{_digest(sources, headers)}.so"
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not lib_path.exists():
                _compile_and_link(sources, lib_path)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return lib_path


def _compile_and_link(sources: list[Path], lib_path: Path) -> None:
    nvcc = _nvcc()
    tag = f"{lib_path.stem}.{os.getpid()}"
    t0 = time.perf_counter()
    procs = []
    for src in sources:
        obj = BUILD_DIR / f"{src.stem}.{tag}.o"
        cmd = [nvcc, *COMPILE_FLAGS, "-I", str(CSRC), "-c", "-o", str(obj), str(src)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )))
    logs, failed = [], []
    for src, _, proc in procs:
        out, _ = proc.communicate()
        logs.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {src.name} ({proc.returncode}):\n{out}")
    objects = [obj for _, obj, _ in procs]
    try:
        if failed:
            raise RuntimeError("\n".join(failed))
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objects)],
            capture_output=True, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stdout}{link.stderr}")
        os.replace(tmp, lib_path)
    finally:
        for obj in objects:
            obj.unlink(missing_ok=True)
    build_info.update(seconds=time.perf_counter() - t0, log="\n".join(logs))


def load() -> ctypes.CDLL:
    """The kernels' library, built if needed and loaded once per process."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build_library()))
        lib.port_error_string.argtypes = [ctypes.c_int]
        lib.port_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check_launch(code: int, what: str) -> None:
    """Raise if a launch function returned a CUDA error (0 is success)."""
    if code != 0:
        raise RuntimeError(f"{what} kernel launch failed: {load().port_error_string(code).decode()}")
