"""Run-environment metadata capture.

Counterpart of `llm_training_tpu/run_metadata.py` (`collect_run_metadata`):
the record embedded in every checkpoint's `meta.json` -- launcher
environment, git revision, versions -- with torch's and CUDA's versions
and the device's name where the JAX package records JAX's.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

import torch

# launcher / cluster env vars worth preserving: SLURM and torch's own
# launcher (torchrun) wiring
_ENV_KEYS = (
    "SLURM_JOB_ID",
    "SLURM_JOB_NAME",
    "SLURM_NNODES",
    "SLURM_NODEID",
    "SLURM_PROCID",
    "SLURM_NTASKS",
    "SLURM_NODELIST",
    "MASTER_ADDR",
    "MASTER_PORT",
    "WORLD_SIZE",
    "RANK",
    "LOCAL_RANK",
)


def _git_revision(cwd: str | None = None) -> dict:
    try:
        rev = subprocess.run(
            ["git", "rev-parse", "HEAD"],
            cwd=cwd, capture_output=True, text=True, timeout=5,
        )
        if rev.returncode != 0:
            return {}
        dirty = subprocess.run(
            ["git", "status", "--porcelain"],
            cwd=cwd, capture_output=True, text=True, timeout=5,
        )
        return {
            "git_rev": rev.stdout.strip(),
            "git_dirty": bool(dirty.stdout.strip()) if dirty.returncode == 0 else None,
        }
    except (OSError, subprocess.TimeoutExpired):
        return {}


def collect_run_metadata() -> dict:
    """World size, launcher env, git rev, versions -- JSON-serializable."""
    meta: dict = {
        "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S%z"),
        "argv": list(sys.argv),
        "python": sys.version.split()[0],
        "env": {k: os.environ[k] for k in _ENV_KEYS if k in os.environ},
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
    }
    # the rev of the package's own checkout, not the caller's cwd
    meta.update(_git_revision(cwd=os.path.dirname(os.path.dirname(__file__))))
    distributed = torch.distributed.is_available() and torch.distributed.is_initialized()
    meta["world"] = {
        "num_processes": torch.distributed.get_world_size() if distributed else 1,
        "process_index": torch.distributed.get_rank() if distributed else 0,
        "device_count": torch.cuda.device_count(),
        "local_device_count": torch.cuda.device_count(),
        "backend": "cuda" if torch.cuda.is_available() else "cpu",
        "device_kind": torch.cuda.get_device_name(0) if torch.cuda.is_available() else "cpu",
    }
    return meta
