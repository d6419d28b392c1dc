"""Checkpoint durability plane: hashed manifests, mirroring, retention GC.

Counterpart of `llm_training_tpu/resilience/durability.py` on the port's
checkpoint layout (`trainer/checkpoint.py`):

- a step is `<root>/step_N`, committed by one `rename` (so a `step_N`
  directory is always whole); `.tmp-step_*` entries are writes in flight;
- **integrity manifests** are `manifest-N.json` beside the steps: sha256 +
  size per payload file plus a tree-structure fingerprint, written
  tmp-then-rename so a manifest is either absent or whole.
  `verify_step(fast|full)` checks presence and sizes (fast) or full hashes
  (full) and names every offending file;
- **staged force-saves**: before a forced save replaces a committed step,
  a hard-link clone and its manifest are parked in `.stale/step_N`; the
  next `Checkpointer` promotes the clone when `step_N` is missing (a kill
  inside the swap), and drops it when the replacement committed;
- **async mirroring** (`MirrorDaemon`): a background thread copies
  manifested steps to a mirror directory with tmp-then-rename and
  re-verifies the copy against the manifest before publishing it;
- **retention GC**: keep-last-N + keep-every-K over the mirror, with two
  absolute vetoes: never the newest committed step, never a step whose
  mirror copy is the only intact one;
- **scrubber**: re-verifies one retained step (alternating primary /
  mirror) per interval, so silent decay is found before a restore needs
  the copy;
- the `ckpt` CLI (`verify` / `ls` / `gc` / `mirror`) over the same
  functions; exit 0 clean, 1 findings, 2 unusable.

Standard library only (plus the port's metric registry): the `ckpt` CLI and
the mirror thread never touch CUDA. A mirror thread that waited on a
wedged stream could block the very restore that is about to recover from
it. The daemon's lock guards only its bookkeeping sets; file work and
metric publication happen outside it.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import re
import shutil
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from pathlib import Path

from llm_training_tpu_torch.telemetry.registry import get_registry

logger = logging.getLogger(__name__)

MANIFEST_VERSION = 1
_HASH_CHUNK = 1 << 20
# files hashed at once: `hashlib` releases the GIL on large updates, and one
# core hashes sha256 at ~0.8 GB/s on the card's host (PERF.md), so a step's
# DCP files (one a writer thread) hash side by side
_HASH_THREADS = 8

# sidecar names in a checkpoint root that are not steps: the manifests, the
# staged-replacement trash (`.stale/`) and in-flight tmp entries
STALE_DIR = ".stale"
_TMP_PREFIX = ".tmp-"
_STEP_NAME = re.compile(r"step_(\d+)")
_MANIFEST_NAME = re.compile(r"manifest-(\d+)\.json")


def manifest_path(root: str | Path, step: int) -> Path:
    return Path(root) / f"manifest-{int(step)}.json"


def step_dir(root: str | Path, step: int) -> Path:
    return Path(root) / f"step_{int(step)}"


def _step_of(name: str) -> int | None:
    match = _STEP_NAME.fullmatch(name)
    return int(match.group(1)) if match else None


def committed_steps(root: str | Path) -> list[int]:
    """Committed step numbers under `root`, ascending: every `step_N`
    directory (a step lands by one rename, so none is partial)."""
    root = Path(root)
    if not root.is_dir():
        return []
    return sorted(
        step for p in root.iterdir()
        if (step := _step_of(p.name)) is not None and p.is_dir()
    )


def manifested_steps(root: str | Path) -> list[int]:
    """Steps that are committed AND carry a manifest: the mirrorable set."""
    return [s for s in committed_steps(root) if manifest_path(root, s).exists()]


def _sha256(path: Path) -> str:
    digest = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            chunk = f.read(_HASH_CHUNK)
            if not chunk:
                break
            digest.update(chunk)
    return digest.hexdigest()


def _sha256_files(dirpath: Path, rels: list[str]) -> dict[str, str]:
    """sha256 of each of `rels` under `dirpath`, several files at once."""
    if len(rels) <= 1:
        return {rel: _sha256(dirpath / rel) for rel in rels}
    with ThreadPoolExecutor(min(_HASH_THREADS, len(rels))) as pool:
        return dict(zip(rels, pool.map(lambda rel: _sha256(dirpath / rel), rels)))


def payload_files(dirpath: str | Path) -> list[str]:
    """Every regular file under the step dir as sorted POSIX-relative
    paths: the manifest's file universe."""
    dirpath = Path(dirpath)
    return sorted(
        p.relative_to(dirpath).as_posix()
        for p in dirpath.rglob("*") if p.is_file()
    )


def build_manifest(dirpath: str | Path, step: int) -> dict:
    """Hash a committed step dir: sha256 + size per payload file plus a
    tree-structure fingerprint (hash of the sorted relative-path list, so
    an added or vanished file is a finding even when every surviving file
    still hashes clean)."""
    dirpath = Path(dirpath)
    rels = payload_files(dirpath)
    digests = _sha256_files(dirpath, rels)
    files = {rel: {"sha256": digests[rel], "bytes": (dirpath / rel).stat().st_size}
             for rel in rels}
    tree = hashlib.sha256("\n".join(sorted(files)).encode()).hexdigest()
    return {
        "manifest_version": MANIFEST_VERSION,
        "step": int(step),
        "tree_sha256": tree,
        "total_bytes": sum(entry["bytes"] for entry in files.values()),
        "files": files,
    }


def write_manifest(root: str | Path, step: int, manifest: dict) -> Path:
    """tmp-then-rename: a reader (or a crash) sees the old manifest or the
    new one, never a torn one."""
    target = manifest_path(root, step)
    tmp = target.with_name(target.name + ".tmp")
    tmp.write_text(json.dumps(manifest, indent=1, sort_keys=True))
    os.replace(tmp, target)
    return target


def load_manifest(root: str | Path, step: int) -> dict | None:
    """The step's manifest, or None when absent. An unreadable or torn
    manifest raises ValueError: callers treat that as a finding (the
    manifest itself is part of the verified surface)."""
    path = manifest_path(root, step)
    if not path.exists():
        return None
    try:
        manifest = json.loads(path.read_text())
        if not isinstance(manifest, dict) or "files" not in manifest:
            raise ValueError("not a manifest object")
        return manifest
    except (json.JSONDecodeError, ValueError, OSError) as e:
        raise ValueError(f"unreadable manifest {path}: {e}") from e


@dataclass
class VerifyResult:
    """Outcome of verifying one step against its manifest. `verifiable` is
    False only when no manifest exists (a legacy step): then `findings` is
    empty and the caller owns the policy decision."""

    step: int
    mode: str
    verifiable: bool
    findings: list[str] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return self.verifiable and not self.findings


def verify_step(root: str | Path, step: int, mode: str = "fast") -> VerifyResult:
    """Check a step dir against its manifest. `fast` checks the file set
    (the tree fingerprint catches extra or renamed files) and per-file
    sizes; `full` also re-hashes every file. Every finding names the step
    and the offending file."""
    if mode not in ("fast", "full"):
        raise ValueError(f"verify mode must be fast|full, got {mode!r}")
    root = Path(root)
    prefix = f"step {int(step)}"
    sdir = step_dir(root, step)
    try:
        manifest = load_manifest(root, step)
    except ValueError as e:
        return VerifyResult(int(step), mode, True, [
            f"{prefix}: {manifest_path(root, step).name}: {e}"
        ])
    if manifest is None:
        return VerifyResult(int(step), mode, False)
    findings: list[str] = []
    if not sdir.is_dir():
        return VerifyResult(int(step), mode, True, [
            f"{prefix}: {sdir}: step directory missing"
        ])
    present = payload_files(sdir)
    expected = manifest.get("files", {})
    for rel in sorted(set(expected) - set(present)):
        findings.append(f"{prefix}: {rel}: missing (manifest expects "
                        f"{expected[rel]['bytes']} bytes)")
    for rel in sorted(set(present) - set(expected)):
        findings.append(f"{prefix}: {rel}: not in manifest (unexpected file)")
    common = sorted(set(present) & set(expected))
    sized = [rel for rel in common
             if (sdir / rel).stat().st_size == int(expected[rel]["bytes"])]
    digests = _sha256_files(sdir, sized) if mode == "full" else {}
    for rel in common:
        size = (sdir / rel).stat().st_size
        want = int(expected[rel]["bytes"])
        if size != want:
            findings.append(f"{prefix}: {rel}: size {size} != manifest {want}")
        elif rel in digests and digests[rel] != expected[rel]["sha256"]:
            findings.append(
                f"{prefix}: {rel}: sha256 {digests[rel][:12]}… != manifest "
                f"{expected[rel]['sha256'][:12]}…"
            )
    return VerifyResult(int(step), mode, True, findings)


# ------------------------------------------------------------- tree ops


def clone_tree(src: str | Path, dst: str | Path, link: bool = False) -> None:
    """Copy a step dir. `link=True` hardlinks payload files where the
    filesystem allows (instant and space-free): safe ONLY for the staged
    swap, whose hazard is deletion (a hardlink survives the unlink of its
    sibling). Mirror and heal copies must be real bytes (`link=False`, the
    default): a hardlinked mirror shares inodes with the primary, so an
    in-place bit-flip would damage both copies at once."""
    src, dst = Path(src), Path(dst)
    if dst.exists():
        shutil.rmtree(dst)

    def _link_or_copy(a: str, b: str) -> object:
        try:
            os.link(a, b)
            return b
        except OSError:
            return shutil.copy2(a, b)

    shutil.copytree(src, dst, copy_function=_link_or_copy if link else shutil.copy2)


def replace_dir(staged: Path, target: Path) -> None:
    """Publish `staged` at `target` with rename-level atomicity: an
    existing target is renamed aside first and removed only after the
    replacement landed."""
    trash = target.with_name(target.name + ".replaced")
    if trash.exists():
        shutil.rmtree(trash)
    if target.exists():
        os.replace(target, trash)
    os.replace(staged, target)
    if trash.exists():
        shutil.rmtree(trash)


# ----------------------------------------------------- staged force-save


def _stale_manifest(staging: Path, step: int) -> Path:
    return staging / manifest_path(staging, step).name


def stage_stale_step(root: str | Path, step: int) -> Path | None:
    """Before a forced save replaces a committed step, park a hardlink
    clone and its manifest under `.stale/step_N`: the durable copy a kill
    inside the swap would otherwise destroy. Returns the staged path, or
    None when the step dir does not exist."""
    root = Path(root)
    src = step_dir(root, step)
    if not src.is_dir():
        return None
    staging = root / STALE_DIR
    staging.mkdir(exist_ok=True)
    staged = staging / src.name
    clone_tree(src, staged, link=True)
    src_manifest = manifest_path(root, step)
    if src_manifest.exists():
        shutil.copy2(src_manifest, _stale_manifest(staging, step))
    return staged


def clear_stale_step(root: str | Path, step: int) -> None:
    """Drop the staged copy once its replacement committed (and its
    manifest landed)."""
    staging = Path(root) / STALE_DIR
    staged = step_dir(staging, step)
    if staged.exists():
        shutil.rmtree(staged, ignore_errors=True)
    stale_manifest = _stale_manifest(staging, step)
    if stale_manifest.exists():
        stale_manifest.unlink()
    try:
        staging.rmdir()  # only when empty
    except OSError:
        pass


def promote_stale_steps(root: str | Path) -> list[int]:
    """Startup sweep: a step parked in `.stale/` whose replacement never
    committed (the kill-mid-swap signature) moves back into place. A
    committed replacement wins: the staged copy is then trash from an
    interrupted cleanup. Returns the promoted step numbers."""
    root = Path(root)
    staging = root / STALE_DIR
    if not staging.is_dir():
        return []
    promoted: list[int] = []
    for entry in sorted(staging.iterdir()):
        step = _step_of(entry.name)
        if step is None or not entry.is_dir():
            continue
        target = step_dir(root, step)
        stale_manifest = _stale_manifest(staging, step)
        if target.is_dir():
            shutil.rmtree(entry, ignore_errors=True)
            if stale_manifest.exists():
                stale_manifest.unlink()
            continue
        os.replace(entry, target)
        if stale_manifest.exists():
            os.replace(stale_manifest, manifest_path(root, step))
        promoted.append(step)
        logger.warning(
            "promoted staged checkpoint step %d back into %s (its "
            "force-save replacement never committed)", step, root,
        )
    try:
        staging.rmdir()
    except OSError:
        pass
    return promoted


# ------------------------------------------------------------ corruption


def corrupt_step(root: str | Path, step: int, mode: str, *,
                 target: str | None = None) -> str:
    """Deterministically damage one payload file of a committed step: the
    chaos harness's byte-level fault. The victim is the LARGEST payload
    file (ties broken lexically): deterministic, and always a real data
    file rather than a marker. Returns the relative path damaged. `target`
    overrides victim selection."""
    if mode not in ("flip", "truncate", "delete"):
        raise ValueError(f"corrupt mode must be flip|truncate|delete, got {mode!r}")
    sdir = step_dir(root, step)
    files = payload_files(sdir)
    if not files:
        raise FileNotFoundError(f"no payload files under {sdir}")
    if target is not None:
        if target not in files:
            raise FileNotFoundError(f"{target} not in step {step} payload")
        victim = target
    else:
        victim = max(files, key=lambda rel: ((sdir / rel).stat().st_size, rel))
    path = sdir / victim
    if mode == "delete":
        path.unlink()
    elif mode == "truncate":
        size = path.stat().st_size
        with open(path, "r+b") as f:
            f.truncate(size // 2)
    else:  # flip one byte in the middle
        size = path.stat().st_size
        offset = size // 2
        with open(path, "r+b") as f:
            f.seek(offset)
            byte = f.read(1) or b"\x00"
            f.seek(offset)
            f.write(bytes([byte[0] ^ 0xFF]))
    return victim


# ------------------------------------------------------------- mirroring


def mirror_step(primary: str | Path, mirror: str | Path, step: int) -> list[str]:
    """Copy one manifested step into the mirror with tmp-then-rename and
    FULL manifest re-verification on the mirror side before publishing.
    Returns findings ([] = the mirror now holds a verified copy); a copy
    that fails re-verification is torn down, never published."""
    primary, mirror = Path(primary), Path(mirror)
    try:
        manifest = load_manifest(primary, step)
    except ValueError as e:
        return [str(e)]
    if manifest is None:
        return [f"step {step}: no manifest in {primary} (not mirrorable)"]
    mirror.mkdir(parents=True, exist_ok=True)
    if verify_step(mirror, step, mode="fast").ok:
        return []  # already mirrored and intact
    # unique per mirroring thread: two writers over one target (a relaunch's
    # daemon racing a leaked one) must stage independently
    tmp = mirror / f"{_TMP_PREFIX}step_{int(step)}-{os.getpid()}-{threading.get_ident()}"
    try:
        clone_tree(step_dir(primary, step), tmp)
    except OSError as e:
        shutil.rmtree(tmp, ignore_errors=True)
        return [f"step {step}: mirror copy failed: {e}"]
    # re-verify the COPY against the primary's manifest: rot picked up in
    # transit (or a source that decayed after its manifest) never publishes
    findings: list[str] = []
    expected = manifest.get("files", {})
    present = set(payload_files(tmp))
    for rel in sorted(set(expected) - present):
        findings.append(f"step {step}: {rel}: missing from mirror copy")
    for rel in sorted(present - set(expected)):
        findings.append(f"step {step}: {rel}: unexpected in mirror copy")
    digests = _sha256_files(tmp, sorted(present & set(expected)))
    for rel, digest in digests.items():
        if digest != expected[rel]["sha256"]:
            findings.append(
                f"step {step}: {rel}: mirror copy sha256 mismatch "
                f"({digest[:12]}… != {expected[rel]['sha256'][:12]}…)"
            )
    if findings:
        shutil.rmtree(tmp, ignore_errors=True)
        return findings
    write_manifest(mirror, step, manifest)
    replace_dir(tmp, step_dir(mirror, step))
    return []


def gc_orphan_manifests(root: str | Path) -> list[int]:
    """Drop manifests whose step dir is gone. Returns the orphaned step
    numbers."""
    root = Path(root)
    orphans: list[int] = []
    if not root.is_dir():
        return orphans
    for path in sorted(root.glob("manifest-*.json")):
        match = _MANIFEST_NAME.fullmatch(path.name)
        if match and not step_dir(root, int(match.group(1))).exists():
            path.unlink()
            orphans.append(int(match.group(1)))
    return orphans


# ----------------------------------------------------------- retention GC


def retention_victims(
    steps: list[int],
    keep_last: int,
    keep_every: int | None = None,
    protected: set[int] | frozenset[int] = frozenset(),
) -> list[int]:
    """Which of `steps` the retention policy may delete: keep the newest
    `keep_last`, keep every step divisible by `keep_every` (the long-tail
    archive), and NEVER the newest step or anything in `protected` (steps
    whose mirror copy is the only intact one). Pure policy, shared by the
    daemon and the `ckpt gc` CLI."""
    if keep_last < 1:
        raise ValueError("keep_last must be >= 1 (the newest step is never a victim)")
    steps = sorted(set(int(s) for s in steps))
    if not steps:
        return []
    keep = set(steps[-keep_last:])
    keep.add(steps[-1])
    if keep_every:
        keep.update(s for s in steps if s % int(keep_every) == 0)
    keep.update(int(s) for s in protected)
    return [s for s in steps if s not in keep]


def apply_retention(
    root: str | Path,
    keep_last: int,
    keep_every: int | None = None,
    protected: set[int] | frozenset[int] = frozenset(),
    dry_run: bool = False,
) -> list[int]:
    """Delete retention victims (step dir + manifest) under `root`."""
    root = Path(root)
    victims = retention_victims(committed_steps(root), keep_last, keep_every, protected)
    if dry_run:
        return victims
    for step in victims:
        shutil.rmtree(step_dir(root, step), ignore_errors=True)
        mpath = manifest_path(root, step)
        if mpath.exists():
            mpath.unlink()
    return victims


def last_intact_on_mirror(primary: str | Path, mirror: str | Path) -> set[int]:
    """Mirror steps whose primary copy is broken or gone: the copies the
    retention policy must never delete (fast verification: the question is
    'does a plausible primary copy exist', not 'is it bit-perfect')."""
    protected: set[int] = set()
    for step in committed_steps(mirror):
        primary_ok = verify_step(primary, step, mode="fast")
        if not (primary_ok.ok or (not primary_ok.verifiable
                                  and step_dir(primary, step).is_dir())):
            protected.add(step)
    return protected


# ---------------------------------------------------------- mirror daemon


class MirrorDaemon:
    """Background mirror + retention GC + scrubber over one checkpoint
    root. The owning Checkpointer calls `notify()` after each manifest
    commit and `drain()` at its barrier; the daemon thread does everything
    else. File work happens outside `_lock` (which guards only the
    bookkeeping sets) and metrics are published after its release."""

    def __init__(
        self,
        primary: str | Path,
        mirror: str | Path,
        interval_s: float = 2.0,
        keep_last: int = 3,
        keep_every: int | None = None,
        scrub_interval_s: float = 60.0,
        registry=None,
        clock=time.monotonic,
    ):
        self.primary = Path(primary)
        self.mirror = Path(mirror)
        self.interval_s = float(interval_s)
        self.keep_last = int(keep_last)
        self.keep_every = keep_every
        self.scrub_interval_s = float(scrub_interval_s)
        self._registry = registry
        self._clock = clock
        self._lock = threading.Lock()
        # drain() waits on this for pass completions; it shares _lock
        self._pass_done = threading.Condition(self._lock)
        self._mirrored: set[int] = set()  # guarded by: _lock
        self._failed: set[int] = set()  # guarded by: _lock
        # steps the mirror's retention deleted: never copied again (JAX's
        # daemon copies them back on its next pass, and deletes them again)
        self._retired: set[int] = set()  # guarded by: _lock
        self._passes = 0  # guarded by: _lock
        self._scrub_cursor = 0  # guarded by: _lock
        self._last_scrub_t = 0.0  # guarded by: _lock
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._thread: threading.Thread | None = None  # guarded by: _lock

    # ------------------------------------------------------ owner surface

    def start(self) -> "MirrorDaemon":
        thread = threading.Thread(target=self._run, name="ckpt-mirror", daemon=True)
        with self._lock:
            self._thread = thread
        thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()
        with self._lock:
            thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=30.0)

    def notify(self) -> None:
        """A new step committed (manifest written): wake the loop now
        instead of waiting out the poll interval."""
        self._wake.set()

    def drain(self, timeout_s: float = 120.0) -> bool:
        """Block until every currently committed step has been attempted
        (mirrored or marked failed): the Checkpointer's exit barrier, so a
        run never ends with its newest step unmirrored. Returns False on
        timeout (mirror storage wedged: the run must still exit)."""
        deadline = self._clock() + timeout_s
        while not self._stop.is_set():
            with self._lock:
                attempted = self._mirrored | self._failed | self._retired
            pending = [s for s in manifested_steps(self.primary) if s not in attempted]
            if not pending:
                return True
            remaining = deadline - self._clock()
            if remaining <= 0:
                logger.warning("mirror drain timed out with steps %s pending", pending)
                return False
            self._wake.set()
            with self._lock:
                self._pass_done.wait(timeout=min(remaining, 1.0))
        return False

    def stats(self) -> dict:
        with self._lock:
            return {
                "mirrored": sorted(self._mirrored),
                "failed": sorted(self._failed),
                "passes": self._passes,
            }

    # ------------------------------------------------------ daemon thread

    def _registry_now(self):
        return self._registry if self._registry is not None else get_registry()

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self._pass()
            except Exception:
                # best-effort scaffolding under the run: a surprise here must
                # never kill the daemon (the primary copy is untouched)
                logger.exception("mirror pass failed")
            with self._lock:
                self._passes += 1
                self._pass_done.notify_all()
            self._wake.wait(timeout=self.interval_s)
            self._wake.clear()

    def _pass(self) -> None:
        registry = self._registry_now()
        committed = manifested_steps(self.primary)
        with self._lock:
            done = self._mirrored | self._failed | self._retired
            todo = [s for s in committed if s not in done]
        for step in todo:
            findings = mirror_step(self.primary, self.mirror, step)
            if findings:
                for finding in findings:
                    logger.warning("mirror rejected: %s", finding)
                registry.counter("ckpt/mirror_verify_rejects").inc()
                with self._lock:
                    self._failed.add(step)
            else:
                logger.info("mirrored checkpoint step %d -> %s", step, self.mirror)
                with self._lock:
                    self._mirrored.add(step)
                    self._failed.discard(step)
        # retention GC on the mirror side: never the newest committed step,
        # never a copy that is the last intact one (primary broken)
        protected = last_intact_on_mirror(self.primary, self.mirror)
        victims = apply_retention(self.mirror, self.keep_last, self.keep_every, protected)
        if victims:
            registry.counter("ckpt/gc_deleted").inc(len(victims))
            logger.info("mirror retention GC deleted steps %s", victims)
            with self._lock:
                self._mirrored.difference_update(victims)
                self._retired.update(victims)
        gc_orphan_manifests(self.primary)
        mirrored_now = committed_steps(self.mirror)
        lag = len([s for s in committed if s not in mirrored_now])
        registry.gauge("ckpt/mirrored_steps").set(len(mirrored_now))
        registry.gauge("ckpt/mirror_lag_steps").set(lag)
        self._maybe_scrub(registry)

    def _maybe_scrub(self, registry) -> None:
        """Re-verify ONE retained step per scrub interval, alternating
        primary and mirror: decay is found on a cadence, not at restore."""
        if self.scrub_interval_s <= 0:
            return
        now = self._clock()
        with self._lock:
            if now - self._last_scrub_t < self.scrub_interval_s:
                return
            self._last_scrub_t = now
            cursor = self._scrub_cursor
            self._scrub_cursor += 1
        targets = [(root, step) for root in (self.primary, self.mirror)
                   for step in manifested_steps(root)]
        if not targets:
            return
        root, step = targets[cursor % len(targets)]
        result = verify_step(root, step, mode="full")
        registry.gauge("ckpt/scrub_last_step").set(step)
        registry.gauge("ckpt/scrub_last_ok").set(1.0 if result.ok else 0.0)
        if result.ok:
            registry.counter("ckpt/scrub_ok").inc()
        else:
            registry.counter("ckpt/scrub_failures").inc()
            for finding in result.findings:
                logger.warning("scrub (%s): %s", root, finding)


# ------------------------------------------------------------------- CLI


def _cli_findings(primary: Path, mirror: Path | None, step: int | None,
                  mode: str) -> tuple[list[str], int]:
    """(findings, steps examined) across primary + mirror."""
    findings: list[str] = []
    examined = 0
    for root in [primary] + ([mirror] if mirror else []):
        steps = committed_steps(root)
        if step is not None:
            steps = [s for s in steps if s == step]
        for s in steps:
            examined += 1
            result = verify_step(root, s, mode=mode)
            if not result.verifiable:
                print(f"{root}: step {s}: no manifest (legacy step, unverifiable)")
                continue
            for finding in result.findings:
                findings.append(f"{root}: {finding}")
    return findings, examined


def ckpt_main(args) -> int:
    """`ckpt {verify,ls,gc,mirror}`: standard library and this module only
    (runs on a machine with no card). Exit 0 clean / 1 findings / 2
    unusable, naming every searched path."""
    primary = Path(args.dir)
    mirror_raw = args.mirror_dir or os.environ.get("LLMT_CKPT_MIRROR_DIR")
    mirror = Path(mirror_raw) if mirror_raw else None
    searched = [str(primary)] + ([str(mirror)] if mirror else [])

    def _unusable(reason: str) -> int:
        print(f"ckpt {args.ckpt_command}: {reason} (searched: {', '.join(searched)})")
        return 2

    if args.ckpt_command == "ls":
        rows = 0
        for root in [primary] + ([mirror] if mirror else []):
            for step in committed_steps(root):
                rows += 1
                try:
                    manifest = load_manifest(root, step)
                    label = (
                        f"manifest {len(manifest['files'])} files, "
                        f"{manifest['total_bytes']:,} bytes"
                        if manifest else "no manifest (legacy)"
                    )
                except ValueError:
                    label = "manifest UNREADABLE"
                print(f"{root}: step {step}: {label}")
        if rows == 0:
            return _unusable("no committed checkpoint steps found")
        return 0

    if args.ckpt_command == "verify":
        findings, examined = _cli_findings(primary, mirror, args.step, args.mode)
        if examined == 0:
            return _unusable("no committed checkpoint steps found")
        for finding in findings:
            print(f"FINDING: {finding}")
        print(f"ckpt verify: {examined} step copies checked, {len(findings)} finding(s)")
        return 1 if findings else 0

    if args.ckpt_command == "gc":
        target = mirror if mirror else primary
        if not target.is_dir() or not committed_steps(target):
            return _unusable(f"no committed steps to GC under {target}")
        protected = last_intact_on_mirror(primary, mirror) if mirror else set()
        victims = apply_retention(target, args.keep_last, args.keep_every, protected,
                                  dry_run=args.dry_run)
        orphans = [] if args.dry_run else gc_orphan_manifests(target)
        verb = "would delete" if args.dry_run else "deleted"
        print(f"ckpt gc: {verb} steps {victims or '[]'} under {target} "
              f"(kept newest + last-{args.keep_last}"
              + (f" + every-{args.keep_every}" if args.keep_every else "")
              + (f", protected last-intact {sorted(protected)}" if protected else "")
              + (f"; dropped orphan manifests {orphans}" if orphans else "")
              + ")")
        return 0

    if args.ckpt_command == "mirror":
        if mirror is None:
            return _unusable("mirror needs --mirror-dir or LLMT_CKPT_MIRROR_DIR")
        steps = manifested_steps(primary)
        if not steps:
            return _unusable("no manifested checkpoint steps to mirror")
        failures: list[str] = []
        for step in steps:
            findings = mirror_step(primary, mirror, step)
            failures.extend(findings)
            print(f"step {step}: {'REJECTED' if findings else 'mirrored'}")
        for finding in failures:
            print(f"FINDING: {finding}")
        print(f"ckpt mirror: {len(steps)} step(s), {len(failures)} rejection finding(s) "
              f"-> {mirror}")
        return 1 if failures else 0

    raise ValueError(f"unknown ckpt subcommand {args.ckpt_command!r}")
