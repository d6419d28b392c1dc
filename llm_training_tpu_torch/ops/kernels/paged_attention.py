"""Ragged paged-decode attention: the CUDA kernel, its wrapper and its plain
PyTorch version.

Replaces the Pallas TPU kernel `_decode_kernel` of
`llm_training_tpu/ops/pallas/paged_attention.py` (`paged_decode_attention`
there). One decode token per row attends over that row's own cache,
reading K/V pages through the row's block table.

What bounds it on an H100: HBM bytes. A call must read
`sum_b len_b * Hkv * D * 2 (K and V) * bytes/elem` plus q, out and the
`ceil(len_b / page)` table entries of each row, and does ~4 flops per
byte read -- far below the ~295 flops per byte where the tensor cores
would become the limit. The kernel (`csrc/paged_decode.cu`) reads each
needed byte once and keeps scores, the running max/denominator and the
accumulator on chip; its source says what this first version leaves on
the table.

The wrapper is a public entry point with its own device routing: it
launches the kernel for CUDA tensors and raises on what it cannot take;
it takes the plain version only for tensors on the CPU. The model reaches
it through `ops/paged_attention.py`, whose `impl` chooses between decode
through this wrapper and the gather path for chunks.
`paged_decode_attention.launches` counts kernel launches.

Build: `nvcc` compiles `csrc/*.cu` for sm_90a into a shared library with a
plain C interface, at the first launch, into `_build/` (keyed by a hash of
the sources and flags, under a file lock), loaded with `ctypes`. Nothing is
built or imported from CUDA when this module is imported.
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

import torch

from llm_training_tpu_torch.ops.attention import _xla_attention

_CSRC = Path(__file__).parent / "csrc"
_BUILD_DIR = Path(__file__).parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
_MAX_GROUP = 8

_lib: ctypes.CDLL | None = None
# what the last build printed (ptxas register/shared-memory report) and
# how long it took; empty until a build ran in this process
build_info: dict = {}


def _nvcc() -> str:
    for candidate in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if candidate and os.path.exists(candidate):
            return candidate
    raise RuntimeError("nvcc not found: the paged-decode kernel cannot be built")


def build_library() -> Path:
    """Compile `csrc/*.cu` (once per source hash) and return the library
    path. Raises with the compiler's output when the build fails."""
    sources = sorted(_CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = _BUILD_DIR / f"libpaged_decode_{digest.hexdigest()[:16]}.so"
    with open(_BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not lib_path.exists():
                tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
                cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
                t0 = time.perf_counter()
                proc = subprocess.run(cmd, capture_output=True, text=True)
                seconds = time.perf_counter() - t0
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}"
                    )
                os.replace(tmp, lib_path)
                build_info.update(seconds=seconds, log=proc.stdout + proc.stderr)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return lib_path


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build_library()))
        lib.paged_decode_launch.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int,  # q dtype, kv dtype, head_dim
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # q, k pool, v pool
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # tables, lens, out
            ctypes.c_int, ctypes.c_int, ctypes.c_int,  # batch, kv heads, group
            ctypes.c_int, ctypes.c_int,  # page, pages per row
            ctypes.c_float, ctypes.c_float, ctypes.c_int,  # scale, cap, window
            ctypes.c_void_p,  # stream
        ]
        lib.paged_decode_launch.restype = ctypes.c_int
        lib.paged_decode_error_string.argtypes = [ctypes.c_int]
        lib.paged_decode_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(q, k_pages, v_pages, block_tables, lengths) -> int:
    """Validate what the kernel takes; returns the GQA group."""
    if q.dim() != 3 or k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(
            f"expected q [B, Hq, D] and pools [N, page, Hkv, D]; got q "
            f"{tuple(q.shape)}, k {tuple(k_pages.shape)}, v {tuple(v_pages.shape)}"
        )
    batch, num_q_heads, head_dim = q.shape
    _, page_size, num_kv_heads, pool_dim = k_pages.shape
    if pool_dim != head_dim or num_q_heads % num_kv_heads:
        raise ValueError(
            f"q {tuple(q.shape)} does not match pool {tuple(k_pages.shape)}: "
            "head_dim must agree and Hq must be a multiple of Hkv"
        )
    group = num_q_heads // num_kv_heads
    if head_dim not in _HEAD_DIMS:
        raise ValueError(f"head_dim {head_dim} not supported (expected one of {_HEAD_DIMS})")
    if group > _MAX_GROUP:
        raise ValueError(f"GQA group {group} (Hq {num_q_heads} / Hkv {num_kv_heads}) exceeds {_MAX_GROUP}")
    if block_tables.dim() != 2 or block_tables.shape[0] != batch or lengths.shape != (batch,):
        raise ValueError(
            f"block_tables {tuple(block_tables.shape)} / lengths {tuple(lengths.shape)} "
            f"do not match batch {batch}"
        )
    if block_tables.shape[1] < 1:
        raise ValueError("block_tables needs at least one page per row")
    if q.dtype not in _DTYPE_CODES or k_pages.dtype not in _DTYPE_CODES:
        raise ValueError(f"dtypes q {q.dtype} / pool {k_pages.dtype} not supported")
    if v_pages.dtype != k_pages.dtype:
        raise ValueError(f"k pool {k_pages.dtype} and v pool {v_pages.dtype} differ")
    if block_tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise ValueError("block_tables and lengths must be int32")
    tensors = (q, k_pages, v_pages, block_tables, lengths)
    if any(t.device != q.device for t in tensors):
        raise ValueError("all inputs must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the paged-decode kernel takes contiguous tensors only")
    return group


def paged_decode_attention(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,
    lengths: torch.Tensor,
    *,
    scale: float | None = None,
    sliding_window: int | None = None,
    logits_soft_cap: float | None = None,
) -> torch.Tensor:
    """One ragged decode step: q `[B, Hq, D]` against pools `[N, page, Hkv,
    D]` through `block_tables [B, P]` (int32); `lengths [B]` (int32) counts
    tokens written INCLUDING this step's. Idle rows carry length 1 and a
    table of trash block 0. Returns `[B, Hq, D]` in q's dtype."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return paged_decode_attention_torch(
            q, k_pages, v_pages, block_tables, lengths, scale=scale,
            sliding_window=sliding_window, logits_soft_cap=logits_soft_cap,
        )
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention runs on cuda or cpu, not {q.device}")
    group = _check(q, k_pages, v_pages, block_tables, lengths)
    if sliding_window is not None and sliding_window < 1:
        raise ValueError(f"sliding_window must be >= 1, got {sliding_window}")
    if logits_soft_cap is not None and logits_soft_cap <= 0:
        raise ValueError(f"logits_soft_cap must be > 0, got {logits_soft_cap}")
    lib = _load()
    batch, _, head_dim = q.shape
    _, page_size, num_kv_heads, _ = k_pages.shape
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.paged_decode_launch(
            _DTYPE_CODES[q.dtype], _DTYPE_CODES[k_pages.dtype], head_dim,
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            batch, num_kv_heads, group, page_size, block_tables.shape[1],
            float(scale), float(logits_soft_cap or 0.0), int(sliding_window or 0),
            stream,
        )
    if err != 0:
        raise RuntimeError(
            f"paged-decode kernel launch failed: {lib.paged_decode_error_string(err).decode()}"
        )
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0


def paged_decode_attention_torch(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,
    lengths: torch.Tensor,
    *,
    scale: float | None = None,
    sliding_window: int | None = None,
    logits_soft_cap: float | None = None,
) -> torch.Tensor:
    """The kernel's plain version: gather each row's pages into a dense
    `[B, P*page, Hkv, D]` view, mask positions past `lengths - 1` (and
    outside the window), and run the reference attention."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    batch, _, _ = q.shape
    page_size = k_pages.shape[1]
    num_pages = block_tables.shape[1]
    tables = block_tables.long()
    gk = k_pages[tables].reshape(batch, num_pages * page_size, *k_pages.shape[2:])
    gv = v_pages[tables].reshape(batch, num_pages * page_size, *v_pages.shape[2:])
    q_pos = lengths.long()[:, None] - 1
    kv_pos = torch.arange(num_pages * page_size, device=q.device)[None, :]
    mask = kv_pos <= q_pos
    if sliding_window is not None:
        mask &= q_pos - kv_pos < sliding_window
    out = _xla_attention(
        q[:, None], gk.to(q.dtype), gv.to(q.dtype), mask[:, None, None, :],
        scale, logits_soft_cap,
    )
    return out[:, 0]
