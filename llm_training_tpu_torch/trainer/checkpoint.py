"""Checkpointing with the run's config embedded, and loss-exact resume.

Counterpart of `CheckpointConfig` and `Checkpointer` in
`llm_training_tpu/trainer/checkpoint.py`, on `torch.distributed.checkpoint`
(DCP) in its single-process mode where the JAX package uses orbax:

- one directory per step, `<dirpath>/step_{n}/`, holding the DCP files of
  `TrainState.state_dict()` and `meta.json` (the step, the consumed
  counters, the run config, the run metadata, the optimizer's layout and
  the trainer's riders: data cursor, callback state). A step is written
  under a temporary name and committed by one `rename`, so a process that
  dies mid-save leaves the steps before it intact and never a partial
  `step_{n}`;
- `max_to_keep` prunes the oldest committed steps after each commit;
- `async_save` copies the state to host memory on the caller's thread
  (into buffers reused across saves, pinned when the state is on the
  card) and writes on a background thread; a failed write is raised by the
  next `save`, `check_errors` or `wait`;
- restore loads in place into a live `TrainState`; tensors are read with
  `torch.load(weights_only=True)` and DCP's pickled index is read by an
  unpickler that admits only DCP's own metadata classes, so a checkpoint
  cannot carry code.

The durability plane of the JAX checkpointer (integrity manifests and
`verify`, the mirror daemon and scrubber, `.stale/` promotion, save
retries, restore fallback to older steps) is not ported yet (ROADMAP A.4);
its config keys raise.
"""

from __future__ import annotations

import json
import logging
import os
import pickle
import re
import shutil
import threading
import time
import uuid
from dataclasses import dataclass
from pathlib import Path
from typing import Any

import torch
import torch.distributed.checkpoint as dcp

from llm_training_tpu_torch.dataclass_config import build_dataclass
from llm_training_tpu_torch.run_metadata import collect_run_metadata
from llm_training_tpu_torch.trainer.state import TrainState

logger = logging.getLogger(__name__)

_STEP_DIR = re.compile(r"step_(\d+)")
_META = "meta.json"
_WRITE_THREADS = 8  # DCP writer threads: one file each
# the JAX CheckpointConfig's keys of its durability plane
_DURABILITY_KEYS = (
    "save_retries", "retry_backoff_s", "retry_backoff_max_s", "verify", "mirror_dir",
    "mirror_interval_s", "mirror_keep_last", "mirror_keep_every", "scrub_interval_s",
)


@dataclass
class CheckpointConfig:
    """The JAX `CheckpointConfig` without its durability keys.
    `save_on_exit` is accepted only as True: the reference always saves at
    the end of `fit` (the field is unused there)."""

    dirpath: str | None = None
    max_to_keep: int = 3
    async_save: bool = True
    save_on_exit: bool = True

    def __post_init__(self):
        if self.max_to_keep < 1:
            raise ValueError(f"max_to_keep must be >= 1, got {self.max_to_keep}")
        if not self.save_on_exit:
            raise ValueError(
                "save_on_exit=False is not supported: fit always saves its last step, as "
                "the reference does"
            )

    @classmethod
    def from_node(cls, node: dict[str, Any]) -> "CheckpointConfig":
        """From a config file's `trainer.checkpoint` node: unknown keys raise
        ValueError, the durability plane's keys NotImplementedError."""
        durability = sorted(set(node) & set(_DURABILITY_KEYS))
        if durability:
            raise NotImplementedError(
                f"trainer.checkpoint keys {durability} belong to the checkpoint durability "
                "plane (manifests and verify, mirror, scrubber, save retries), which is not "
                "ported yet (ROADMAP A.4)"
            )
        return build_dataclass(cls, node, "trainer.checkpoint")


class _MetadataUnpickler(pickle.Unpickler):
    """Reads DCP's `.metadata` index: admits DCP's own metadata classes,
    torch's size, dtypes and layouts and a path, and nothing else."""

    _ALLOWED = {
        ("torch", "Size"), ("torch.serialization", "_get_layout"),
        ("torch._utils", "_get_layout"), ("pathlib", "PosixPath"),
    }

    def find_class(self, module: str, name: str) -> Any:
        if (module, name) in self._ALLOWED:
            return super().find_class(module, name)
        if module == "torch" and isinstance(getattr(torch, name, None), torch.dtype):
            return getattr(torch, name)
        if module.startswith("torch.distributed.checkpoint."):
            found = super().find_class(module, name)
            if isinstance(found, type):
                return found
        raise pickle.UnpicklingError(
            f"checkpoint index refers to {module}.{name}, which a DCP index never holds"
        )


class _SafeReader(dcp.FileSystemReader):
    """DCP's file reader with the index read by `_MetadataUnpickler`."""

    def read_metadata(self, *args: Any, **kwargs: Any):
        with open(os.path.join(self.path, ".metadata"), "rb") as f:
            metadata = _MetadataUnpickler(f).load()
        storage_meta = getattr(metadata, "storage_meta", None)
        if storage_meta is not None:
            storage_meta.load_id = self.load_id
        return metadata


def _single_process() -> bool:
    return not (torch.distributed.is_available() and torch.distributed.is_initialized())


def _dir_bytes(path: Path) -> int:
    return sum(p.stat().st_size for p in path.rglob("*") if p.is_file())


def _fsync_dir(path: Path) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class Checkpointer:
    """Saves and restores `TrainState`s under `config.dirpath`. After each
    call `last_save` / `last_restore` hold what it took: bytes, the
    blocking seconds of `save` (the copy to host), the seconds to commit,
    the steps pruned, and the seconds of a restore."""

    def __init__(self, config: CheckpointConfig, run_config: dict | None = None):
        if config.dirpath is None:
            raise ValueError("CheckpointConfig.dirpath is required")
        self.config = config
        self.run_config = run_config or {}
        # launcher env, git rev, versions: captured once, embedded in every save
        self.run_metadata = collect_run_metadata()
        self.directory = Path(config.dirpath).absolute()
        self._staging: dict[str, torch.Tensor] = {}
        self._thread: threading.Thread | None = None
        self._inflight_step: int | None = None
        self._error: BaseException | None = None
        self._lock = threading.Lock()
        self.last_save: dict[str, Any] = {}
        self.last_restore: dict[str, Any] = {}

    # ------------------------------------------------------------ layout

    def step_dir(self, step: int) -> Path:
        return self.directory / f"step_{step}"

    def all_steps(self) -> list[int]:
        """Committed steps, oldest first."""
        if not self.directory.is_dir():
            return []
        steps = []
        for entry in self.directory.iterdir():
            match = _STEP_DIR.fullmatch(entry.name)
            if match and entry.is_dir():
                steps.append(int(match.group(1)))
        return sorted(steps)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def read_meta(self, step: int | None = None) -> dict | None:
        """`meta.json` of `step` (newest when None) without loading any
        tensor. Failure-tolerant, as the reference's: a missing or unreadable
        file returns None (the restore then reports the problem)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            return None
        try:
            return json.loads((self.step_dir(step) / _META).read_text())
        except (OSError, ValueError) as e:
            logger.warning("could not read checkpoint metadata for step %s in %s (%s)",
                           step, self.directory, e)
            return None

    # ------------------------------------------------------------ save

    def check_errors(self) -> None:
        """Raise a failed background write now (once)."""
        with self._lock:
            error, self._error = self._error, None
        if error is not None:
            raise RuntimeError(f"async checkpoint save to {self.directory} failed") from error

    def save(
        self,
        step: int,
        state: TrainState,
        counters: dict[str, int] | None = None,
        force: bool = False,
        extra: dict | None = None,
    ) -> None:
        """Checkpoint `state` as `step`. A step that exists (or is being
        written) is left alone unless `force`. With `async_save` the call
        returns once the state is in host memory."""
        # a parked async failure surfaces even when this call dedupes away
        self.check_errors()
        if not force and (step in self.all_steps() or step == self._inflight_step):
            return
        t0 = time.perf_counter()
        # one write at a time: the staging buffers are the previous write's
        self.wait()
        meta = {
            "step": step,
            "counters": dict(counters or {}),
            "config": self.run_config,
            "run_metadata": self.run_metadata,
            **(extra or {}),
        }
        if state.optimizer is not None:
            meta["optimizer"] = state.optimizer.layout()
        staged = self._stage(state.state_dict())
        blocking = time.perf_counter() - t0
        self.last_save = {
            "step": step,
            "tensor_bytes": sum(t.numel() * t.element_size() for t in staged.values()),
            "blocking_s": blocking,
        }
        self._clear_partial()
        if self.config.async_save:
            self._inflight_step = step
            self._thread = threading.Thread(
                target=self._write_guarded, args=(step, staged, meta, t0),
                name=f"checkpoint-save-{step}",
            )
            self._thread.start()
            logger.info("checkpoint save started at step %d -> %s (async; durable after "
                        "the wait() barrier)", step, self.directory)
        else:
            self._write(step, staged, meta, t0)
            logger.info("checkpoint committed at step %d -> %s", step, self.directory)

    def _stage(self, state_dict: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """Host copies of the state's tensors, in buffers kept for the next
        save (pinned when the tensor lives on the card)."""
        staged = {}
        on_card = False
        for name, tensor in state_dict.items():
            buffer = self._staging.get(name)
            if buffer is None or buffer.shape != tensor.shape or buffer.dtype != tensor.dtype:
                buffer = torch.empty(tensor.shape, dtype=tensor.dtype, pin_memory=tensor.is_cuda)
                self._staging[name] = buffer
            buffer.copy_(tensor.detach(), non_blocking=tensor.is_cuda)
            on_card |= tensor.is_cuda
            staged[name] = buffer
        if on_card:
            torch.cuda.synchronize()
        return staged

    def _clear_partial(self) -> None:
        """Remove temporary directories a dead writer left behind."""
        if not self.directory.is_dir():
            return
        for entry in self.directory.iterdir():
            if entry.name.startswith((".tmp-step_", ".old-step_")) and entry.is_dir():
                shutil.rmtree(entry, ignore_errors=True)

    def _write_guarded(self, step, staged, meta, t0) -> None:
        try:
            self._write(step, staged, meta, t0)
        except Exception as e:  # parked for check_errors / wait / the next save
            logger.error("async checkpoint save of step %d failed: %r", step, e)
            with self._lock:
                self._error = e

    def _write(self, step: int, staged: dict[str, torch.Tensor], meta: dict, t0: float) -> None:
        self.directory.mkdir(parents=True, exist_ok=True)
        tag = f"{os.getpid()}-{uuid.uuid4().hex[:8]}"
        tmp = self.directory / f".tmp-step_{step}-{tag}"
        try:
            dcp.save(staged, storage_writer=dcp.FileSystemWriter(tmp, thread_count=_WRITE_THREADS),
                     no_dist=_single_process())
        except dcp.CheckpointException as e:  # a BaseException: not an Exception
            raise RuntimeError(f"writing checkpoint step {step} to {tmp} failed: {e}") from e
        with open(tmp / _META, "w") as f:
            json.dump(meta, f, default=str)
            f.flush()
            os.fsync(f.fileno())
        final = self.step_dir(step)
        if final.exists():  # a forced save over a committed step
            old = self.directory / f".old-step_{step}-{tag}"
            os.replace(final, old)
            os.replace(tmp, final)
            shutil.rmtree(old)
        else:
            os.replace(tmp, final)
        _fsync_dir(self.directory)
        pruned = self._prune()
        self.last_save.update(commit_s=time.perf_counter() - t0, bytes=_dir_bytes(final),
                              pruned=pruned)

    def _prune(self) -> list[int]:
        keep = self.config.max_to_keep
        steps = self.all_steps()
        if len(steps) <= keep:
            return []
        drop = steps[:-keep]
        for step in drop:
            shutil.rmtree(self.step_dir(step))
        return drop

    def wait(self) -> None:
        """Barrier: the last save is committed (or its failure raised)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
            if self._inflight_step is not None and self._error is None:
                logger.info("checkpoint committed at step %d -> %s", self._inflight_step,
                            self.directory)
            self._inflight_step = None
        self.check_errors()

    def close(self) -> None:
        """Wait for the last save, then release the host staging buffers."""
        try:
            self.wait()
        finally:
            self._staging = {}

    # ------------------------------------------------------------ restore

    def maybe_restore(self, state: TrainState, step: int | None = None) -> dict | None:
        """Load the newest (or the given) step into `state` in place and
        return its metadata; None when the directory holds no step. A state
        without an optimizer (the read-only inference restore) loads the
        parameters, the step and the key only. Never writes to the
        directory. Raises when the optimizer's layout differs from the
        checkpoint's or a tensor is missing."""
        if step is None:
            step = self.latest_step()
            if step is None:
                return None
        path = self.step_dir(step)
        if not path.is_dir():
            raise FileNotFoundError(
                f"checkpoint step {step} not found in {self.directory} "
                f"(committed steps: {self.all_steps()})"
            )
        t0 = time.perf_counter()
        meta = json.loads((path / _META).read_text())
        if state.optimizer is not None:
            if "optimizer" not in meta:
                raise ValueError(f"checkpoint step {step} holds no optimizer state")
            state.optimizer.check_layout(meta["optimizer"])
        state_dict = state.state_dict()
        try:
            dcp.load(state_dict, storage_reader=_SafeReader(path), no_dist=_single_process())
        except dcp.CheckpointException as e:  # a BaseException: not an Exception
            raise RuntimeError(f"loading checkpoint step {step} from {path} failed: {e}") from e
        state.load_state_dict(state_dict)
        if any(t.is_cuda for t in state_dict.values()):
            torch.cuda.synchronize()
        self.last_restore = {
            "step": step, "seconds": time.perf_counter() - t0,
            "tensor_bytes": sum(t.numel() * t.element_size() for t in state_dict.values()),
        }
        logger.info("restored checkpoint step %d from %s", step, self.directory)
        return meta
