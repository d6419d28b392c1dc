"""Checkpointing with the run's config embedded, loss-exact resume, and the
durability plane.

Counterpart of `CheckpointConfig` and `Checkpointer` in
`llm_training_tpu/trainer/checkpoint.py`, on `torch.distributed.checkpoint`
(DCP) in its single-process mode where the JAX package uses orbax:

- one directory per step, `<dirpath>/step_{n}/`, holding the DCP files of
  `TrainState.state_dict()` and `meta.json` (the step, the consumed
  counters, the run config, the run metadata, the optimizer's layout and
  the trainer's riders: data cursor, topology, callback state). A step is
  written under a temporary name and committed by one `rename`, so a
  process that dies mid-save leaves the steps before it intact and never a
  partial `step_{n}`;
- `max_to_keep` prunes the oldest committed steps (and their manifests)
  after each commit;
- `async_save` copies the state to host memory on the caller's thread
  (into buffers reused across saves, pinned when the state is on the
  card) and writes on a background thread; a failed write is raised by the
  next `save`, `check_errors` or `wait`;
- restore loads in place into a live `TrainState`; tensors are read with
  `torch.load(weights_only=True)` and DCP's pickled index is read by an
  unpickler that admits only DCP's own metadata classes, so a checkpoint
  cannot carry code.

Durability, as JAX's (`resilience/durability.py`): the blocking part of a
save is retried on transient I/O errors (`checkpoint/retries`, the
`checkpoint_save` chaos point); each committed step gets an integrity
manifest `manifest-{n}.json`, hashed on the caller's thread once the
write has finished (`checkpoint/manifest`); a forced save over a committed
step first parks a hard-link clone in `.stale/step_{n}`, cleared only
after the replacement and its manifest landed, and a new `Checkpointer`
promotes it when the kill came inside the swap. Restore verifies each
candidate first (`verify: off|fast|full`), heals a step that fails from
the mirror (`mirror_dir` / `LLMT_CKPT_MIRROR_DIR`, kept warm by a
`MirrorDaemon`) only after the mirror's copy passes full verification,
else falls back to the next older step; `repair` deletes a fallen-back
step only when its manifest verification failed. `save_on_exit` is
accepted and unused, as in JAX: `fit` always saves its last step.
"""

from __future__ import annotations

import json
import logging
import os
import pickle
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
from llm_training_tpu_torch.resilience import durability
from llm_training_tpu_torch.resilience.chaos import chaos_point, get_chaos
from llm_training_tpu_torch.resilience.retry import RetryPolicy, is_transient, retry_call
from llm_training_tpu_torch.run_metadata import collect_run_metadata
from llm_training_tpu_torch.telemetry.registry import get_registry
from llm_training_tpu_torch.trainer.state import TrainState

logger = logging.getLogger(__name__)

_META = "meta.json"
_WRITE_THREADS = 8  # DCP writer threads: one file each
# entries a dead writer or healer leaves behind (never `.stale/`, which holds
# the durable copy of a forced save's swap)
_PARTIAL_PREFIXES = (".tmp-step_", ".old-step_", ".tmp-heal-")
VERIFY_MODES = ("off", "fast", "full")


@dataclass
class CheckpointConfig:
    """The JAX `CheckpointConfig`, its keys and defaults."""

    dirpath: str | None = None
    max_to_keep: int = 3
    async_save: bool = True
    # unused, as in JAX: fit always saves its last step
    save_on_exit: bool = True
    # transient-I/O retries around the blocking part of save (the copy to
    # host and the write's launch; the whole write when async_save=False)
    save_retries: int = 3
    retry_backoff_s: float = 0.5
    retry_backoff_max_s: float = 30.0
    # verify-before-restore: `fast` checks the file set and sizes against
    # the step's manifest, `full` also re-hashes every file, `off` restores
    # blind. The post-fallback repair always consults manifests
    verify: str = "fast"
    # async mirror target (LLMT_CKPT_MIRROR_DIR overrides); None disables
    # mirroring, healing and the scrubber
    mirror_dir: str | None = None
    mirror_interval_s: float = 2.0
    # mirror-side retention: the newest `mirror_keep_last` steps plus every
    # step divisible by `mirror_keep_every`, never the newest committed step
    # nor a copy that is the last intact one
    mirror_keep_last: int = 3
    mirror_keep_every: int | None = None
    # background scrubber: re-verify (full) one retained step per interval,
    # alternating primary and mirror; <= 0 disables
    scrub_interval_s: float = 60.0

    def __post_init__(self):
        if self.max_to_keep < 1:
            raise ValueError(f"max_to_keep must be >= 1, got {self.max_to_keep}")
        if self.verify not in VERIFY_MODES:
            raise ValueError(f"verify must be one of {VERIFY_MODES}, got {self.verify!r}")

    @classmethod
    def from_node(cls, node: dict[str, Any]) -> "CheckpointConfig":
        """From a config file's `trainer.checkpoint` node: unknown keys raise
        ValueError."""
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
    call `last_save` / `last_restore` / `last_manifest` hold what it took:
    bytes, the blocking seconds of `save` (the copy to host), the seconds to
    commit, the steps pruned, the seconds of a restore and of a manifest."""

    def __init__(self, config: CheckpointConfig, run_config: dict | None = None):
        if config.dirpath is None:
            raise ValueError("CheckpointConfig.dirpath is required")
        self.config = config
        self.run_config = run_config or {}
        # launcher env, git rev, versions: captured once, embedded in every save
        self.run_metadata = collect_run_metadata()
        self.directory = Path(config.dirpath).absolute()
        # a predecessor killed inside a forced save's swap left the step parked
        # under `.stale/` with no committed replacement: put it back first
        durability.promote_stale_steps(self.directory)
        self._staging: dict[str, torch.Tensor] = {}
        self._thread: threading.Thread | None = None
        self._inflight_step: int | None = None
        self._error: BaseException | None = None
        self._lock = threading.Lock()
        # committed steps still owed a manifest (flushed once the write has
        # finished: a manifest hashes final bytes only)
        self._pending_manifest: set[int] = set()
        self.last_save: dict[str, Any] = {}
        self.last_restore: dict[str, Any] = {}
        self.last_manifest: dict[str, Any] = {}
        mirror_raw = os.environ.get("LLMT_CKPT_MIRROR_DIR") or config.mirror_dir
        self.mirror_dir = Path(mirror_raw).absolute() if mirror_raw else None
        self._mirror: durability.MirrorDaemon | None = None
        if self.mirror_dir is not None:
            self._mirror = durability.MirrorDaemon(
                self.directory, self.mirror_dir,
                interval_s=config.mirror_interval_s,
                keep_last=config.mirror_keep_last,
                keep_every=config.mirror_keep_every,
                scrub_interval_s=config.scrub_interval_s,
            ).start()

    # ------------------------------------------------------------ layout

    def step_dir(self, step: int) -> Path:
        return durability.step_dir(self.directory, step)

    def all_steps(self) -> list[int]:
        """Committed steps, oldest first."""
        return durability.committed_steps(self.directory)

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

    def _retry_policy(self) -> RetryPolicy:
        return RetryPolicy(max_retries=self.config.save_retries,
                           backoff_base_s=self.config.retry_backoff_s,
                           backoff_max_s=self.config.retry_backoff_max_s)

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
        # a previous async save may have committed since: its manifest is
        # writable now (and the mirror can pick it up)
        self._flush_manifests()
        if not force and (step in self.all_steps() or step == self._inflight_step):
            return
        t0 = time.perf_counter()
        # one write at a time: the staging buffers are the previous write's
        self._join()
        self.check_errors()
        self._flush_manifests()
        meta = {
            "step": step,
            "counters": dict(counters or {}),
            "config": self.run_config,
            "run_metadata": self.run_metadata,
            **(extra or {}),
        }
        if state.optimizer is not None:
            meta["optimizer"] = state.optimizer.layout()
        registry = get_registry()

        def _save(attempt: int) -> None:
            chaos_point("checkpoint_save", step=step)
            # a failed attempt's temporary directory goes first
            self._clear_partial()
            staged = self._stage(state.state_dict())
            self.last_save = {
                "step": step,
                "tensor_bytes": sum(t.numel() * t.element_size() for t in staged.values()),
                "blocking_s": time.perf_counter() - t0,
            }
            if self.config.async_save:
                self._inflight_step = step
                self._thread = threading.Thread(
                    target=self._write_guarded, args=(step, staged, meta, t0),
                    name=f"checkpoint-save-{step}",
                )
                self._thread.start()
            else:
                self._write(step, staged, meta, t0)

        # with async_save this times only the blocking part (the copy to host
        # and the thread's launch); wait() times the barrier
        with registry.timer("checkpoint/save").time():
            retry_call(_save, self._retry_policy(), label=f"checkpoint save (step {step})",
                       counter=registry.counter("checkpoint/retries"))
        self._pending_manifest.add(step)
        if self.config.async_save:
            logger.info("checkpoint save started at step %d -> %s (async; durable after "
                        "the wait() barrier)", step, self.directory)
        else:
            self._flush_manifests()
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
        """Remove temporary directories a dead writer or healer left behind
        (never `.stale/`: it holds a durable copy)."""
        if not self.directory.is_dir():
            return
        for entry in self.directory.iterdir():
            if entry.name.startswith(_PARTIAL_PREFIXES) and entry.is_dir():
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
            # park a hard-link clone and its manifest first: the durable copy
            # while the step is swapped; its manifest no longer describes the
            # bytes about to land, so it leaves the root until the new one
            durability.stage_stale_step(self.directory, step)
            durability.manifest_path(self.directory, step).unlink(missing_ok=True)
            old = self.directory / f".old-step_{step}-{tag}"
            os.replace(final, old)
            chaos = get_chaos()
            if chaos is not None:
                chaos.maybe_ckpt_kill_in_swap(step)
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
            durability.manifest_path(self.directory, step).unlink(missing_ok=True)
        return drop

    def _writing(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def _flush_manifests(self) -> None:
        """Write the manifest of every pending committed step, unless a
        write is in flight (a manifest hashes final bytes only). Clears the
        step's staged `.stale/` copy (its replacement is durable and
        manifested now) and wakes the mirror."""
        if not self._pending_manifest or self._writing():
            return
        registry = get_registry()
        for step in sorted(self._pending_manifest):
            self._pending_manifest.discard(step)
            sdir = self.step_dir(step)
            if not sdir.is_dir():
                continue  # pruned, or its write failed
            t0 = time.perf_counter()
            with registry.timer("checkpoint/manifest").time():
                manifest = durability.build_manifest(sdir, step)
                durability.write_manifest(self.directory, step, manifest)
            self.last_manifest = {"step": step, "seconds": time.perf_counter() - t0,
                                  "bytes": manifest["total_bytes"]}
            durability.clear_stale_step(self.directory, step)
            chaos = get_chaos()
            if chaos is not None:
                # the targeted corruption fires here: after the manifest,
                # before the mirror copies the step (its re-hash must reject it)
                chaos.maybe_corrupt_checkpoint(self.directory, step)
        if self._mirror is not None:
            self._mirror.notify()

    def _join(self) -> None:
        """Wait for the in-flight write, if any (its failure stays parked)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
            if self._inflight_step is not None and self._error is None:
                logger.info("checkpoint committed at step %d -> %s", self._inflight_step,
                            self.directory)
            self._inflight_step = None

    def wait(self) -> None:
        """Barrier: the last save is committed (or its failure raised), its
        manifest written and the mirror drained."""
        registry = get_registry()
        with registry.timer("checkpoint/wait").time():
            self._join()
        self.check_errors()
        self._flush_manifests()
        if self._mirror is not None:
            # the run must not end (or roll back) with its newest step
            # unmirrored
            with registry.timer("checkpoint/mirror_drain").time():
                self._mirror.drain()
        chaos = get_chaos()
        if chaos is not None:
            steps = self.all_steps()
            if steps:
                # the untargeted corruption fires here, after the mirror
                # drained: the restore's heal has a clean copy to land on
                chaos.maybe_corrupt_checkpoint(self.directory, steps[-1], at_final_barrier=True)

    def close(self) -> None:
        """Wait for the last save, stop the mirror, then release the host
        staging buffers."""
        try:
            self.wait()
        finally:
            if self._mirror is not None:
                self._mirror.stop()
            self._staging = {}

    # ------------------------------------------------------------ restore

    def _record_verify_failure(self, result: durability.VerifyResult) -> None:
        get_registry().counter("checkpoint/verify_failures").inc()
        for finding in result.findings:
            logger.warning("checkpoint verification failed in %s: %s", self.directory, finding)

    def _heal_from_mirror(self, step: int) -> bool:
        """Replace a corrupt step with the mirror's copy, but only after the
        mirror's copy passes FULL verification (healing from a rotten mirror
        would just move the corruption). Counted in
        `checkpoint/mirror_restores`."""
        if self.mirror_dir is None:
            return False
        mirror_check = durability.verify_step(self.mirror_dir, step, mode="full")
        if not mirror_check.ok:
            for finding in mirror_check.findings:
                logger.warning("mirror copy unusable for healing (%s): %s", self.mirror_dir,
                               finding)
            return False
        try:
            tmp = self.directory / f".tmp-heal-{step}"
            durability.clone_tree(durability.step_dir(self.mirror_dir, step), tmp)
            durability.replace_dir(tmp, self.step_dir(step))
            durability.write_manifest(self.directory, step,
                                      durability.load_manifest(self.mirror_dir, step))
        except OSError as e:
            logger.warning("healing step %d from mirror %s failed: %s", step, self.mirror_dir, e)
            return False
        get_registry().counter("checkpoint/mirror_restores").inc()
        logger.warning("healed checkpoint step %d from mirror %s", step, self.mirror_dir)
        return True

    def _load(self, state: TrainState, step: int) -> dict:
        """Load committed `step` into `state` in place; its metadata."""
        path = self.step_dir(step)
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
        return meta

    def maybe_restore(self, state: TrainState, step: int | None = None,
                      repair: bool = True) -> dict | None:
        """Load the newest (or the given) step into `state` in place and
        return its metadata; None when the directory holds no step. A state
        without an optimizer (the read-only inference restore) loads the
        parameters, the step and the key only.

        Without an explicit step each candidate is verified against its
        manifest first (`verify`) and, when that fails, healed from the
        mirror or skipped; a restore error likewise falls back to the next
        older step, counted in `resilience/restore_fallbacks`. An explicit
        step never falls back. When every step fails, the first error is
        raised again (a systematic problem, such as another optimizer
        layout, keeps its diagnosis). `repair=True` (the fit path) then
        deletes the fallen-back steps whose manifest verification FAILED,
        and legacy steps without a manifest that failed to restore; a step
        whose bytes verify clean is never deleted. Read-only callers pass
        False."""
        explicit = step is not None
        if explicit:
            if not self.step_dir(step).is_dir():
                raise FileNotFoundError(
                    f"checkpoint step {step} not found in {self.directory} "
                    f"(committed steps: {self.all_steps()})"
                )
            candidates = [step]
        else:
            candidates = sorted(self.all_steps(), reverse=True)
            if not candidates:
                return None
        registry = get_registry()
        policy = self._retry_policy()

        # transient I/O is retried as in save; a missing file is corruption,
        # which no retry brings back
        def _restore_transient(e: BaseException) -> bool:
            return is_transient(e) and not isinstance(e, FileNotFoundError)

        def _restore(candidate: int) -> dict:
            return retry_call(lambda attempt: self._load(state, candidate), policy,
                              label=f"checkpoint restore (step {candidate})",
                              counter=registry.counter("checkpoint/retries"),
                              transient=_restore_transient)

        def _fall_back(candidate: int, why: str) -> None:
            registry.counter("resilience/restore_fallbacks").inc()
            logger.warning("checkpoint step %d in %s %s; falling back to the previous "
                           "retained step", candidate, self.directory, why)

        first_error: Exception | None = None
        corrupt: list[int] = []  # FAILED manifest verification: repairable
        legacy: list[int] = []  # no manifest and a failed restore: legacy delete
        for candidate in candidates:
            healed = False
            if self.config.verify != "off" and not explicit:
                check = durability.verify_step(self.directory, candidate,
                                               mode=self.config.verify)
                if check.verifiable and not check.ok:
                    self._record_verify_failure(check)
                    healed = self._heal_from_mirror(candidate)
                    if not healed:
                        corrupt.append(candidate)
                        _fall_back(candidate, "failed manifest verification")
                        continue
            meta = None
            for on_healed_bytes in (False, True):
                try:
                    meta = _restore(candidate)
                    break
                except Exception as e:
                    if explicit:
                        raise
                    if first_error is None:
                        first_error = e
                    if on_healed_bytes or healed:
                        # already a verified-clean mirror copy: a second
                        # failure is not a byte problem
                        _fall_back(candidate, f"failed restore after healing ({e})")
                        break
                    # a restore error is corruption only when the bytes
                    # disagree with the manifest
                    check = durability.verify_step(self.directory, candidate, mode="full")
                    if not check.verifiable:
                        legacy.append(candidate)
                        _fall_back(candidate, "failed restore with no manifest to verify "
                                   f"against (unverifiable legacy step; {e})")
                        break
                    if check.ok:
                        _fall_back(candidate, "failed restore but verifies clean against its "
                                   f"manifest (environmental error, step preserved: {e})")
                        break
                    self._record_verify_failure(check)
                    healed = self._heal_from_mirror(candidate)
                    if not healed:
                        corrupt.append(candidate)
                        _fall_back(candidate, "failed manifest verification")
                        break
            if meta is None:
                continue
            logger.info("restored checkpoint step %d from %s", candidate, self.directory)
            # left in place, an unrestorable newer step would stay the newest
            # every later restore falls back past, and the resumed run's save
            # of that step would dedupe away: the corruption never repaired
            for bad in (corrupt + legacy) if repair else ():
                try:
                    shutil.rmtree(self.step_dir(bad))
                    durability.manifest_path(self.directory, bad).unlink(missing_ok=True)
                    logger.warning("deleted unrestorable checkpoint step %d (%s)", bad,
                                   "verified corrupt" if bad in corrupt
                                   else "unverifiable legacy step")
                except OSError as e:
                    logger.warning("could not delete unrestorable checkpoint step %d (%s); "
                                   "later restores will keep falling back past it", bad, e)
            return meta
        message = (f"all retained checkpoint steps {candidates} in {self.directory} "
                   "failed to restore")
        if first_error is None:
            raise RuntimeError(message)
        first_error.add_note(message)
        raise first_error
