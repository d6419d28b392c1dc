"""Port parity of the checkpoint durability plane on the CPU: manifests,
verify, the corruption matrix, retention, mirroring, staged force-saves,
the chaos triggers of the checkpoint, the `ckpt` command and the
`Checkpointer`'s restore ladder, on the port's layout (`step_N`,
`manifest-N.json` beside it, `.stale/step_N`). The counterparts of
`tests/test_durability.py`, plus the same files and scenarios through the
JAX package (`llm_training_tpu/resilience/durability.py`, the JAX
`Checkpointer`) where the two can be compared: equal manifests, findings,
retention victims, exit codes and restore outcomes.
"""

import json
import os
import shutil
import signal
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_training_tpu.resilience import durability as jax_durability
from llm_training_tpu.telemetry import TelemetryRegistry as JaxRegistry
from llm_training_tpu.telemetry import set_registry as jax_set_registry
from llm_training_tpu.trainer.checkpoint import CheckpointConfig as JaxCheckpointConfig
from llm_training_tpu.trainer.checkpoint import Checkpointer as JaxCheckpointer
from llm_training_tpu.trainer.state import TrainState as JaxTrainState
from llm_training_tpu_torch import prng
from llm_training_tpu_torch.resilience import (
    ChaosConfig,
    MirrorDaemon,
    config_from_env,
    install_chaos,
    uninstall_chaos,
)
from llm_training_tpu_torch.resilience import durability
from llm_training_tpu_torch.telemetry import TelemetryRegistry, set_registry
from llm_training_tpu_torch.trainer.checkpoint import CheckpointConfig, Checkpointer
from llm_training_tpu_torch.trainer.state import TrainState

ROOT = Path(__file__).resolve().parent.parent
# the files of a step: a DCP data file, its index and the trainer's meta
PAYLOAD = "__0_0.distcp"


@pytest.fixture(autouse=True)
def _no_leaked_chaos():
    yield
    uninstall_chaos()


@pytest.fixture()
def registry():
    registry = TelemetryRegistry()
    previous = set_registry(registry)
    yield registry
    set_registry(previous)


def _write_files(sdir: Path, step: int, payload: bytes) -> None:
    sdir.mkdir(parents=True)
    (sdir / PAYLOAD).write_bytes(payload)
    (sdir / ".metadata").write_bytes(b"index" * 8)
    (sdir / "meta.json").write_text(json.dumps({"step": step}))


def _fake_step(root: Path, step: int, payload: bytes = b"x" * 256,
               manifest: bool = True) -> Path:
    """A committed step of the port's layout with three payload files."""
    sdir = root / f"step_{step}"
    _write_files(sdir, step, payload)
    if manifest:
        durability.write_manifest(root, step, durability.build_manifest(sdir, step))
    return sdir


def _jax_fake_step(root: Path, step: int, payload: bytes = b"x" * 256) -> Path:
    """The same files as a JAX (orbax-layout) step, with its commit marker;
    the port's twin of it gets the marker too, so both hold one file set."""
    sdir = root / str(step)
    _write_files(sdir, step, payload)
    (sdir / "_CHECKPOINT_METADATA").write_text("{}")
    jax_durability.write_manifest(root, step, jax_durability.build_manifest(sdir, step))
    return sdir


# ------------------------------------------------------------- manifests


def test_manifest_round_trip_and_atomic_write(tmp_path):
    _fake_step(tmp_path, 3)
    manifest = durability.load_manifest(tmp_path, 3)
    assert manifest["step"] == 3
    assert set(manifest["files"]) == {PAYLOAD, ".metadata", "meta.json"}
    assert manifest["total_bytes"] == sum(e["bytes"] for e in manifest["files"].values())
    # tmp-then-rename left no torn intermediate behind
    assert not list(tmp_path.glob("*.tmp"))
    assert durability.verify_step(tmp_path, 3, mode="full").ok


def test_load_manifest_absent_vs_torn(tmp_path):
    assert durability.load_manifest(tmp_path, 9) is None
    durability.manifest_path(tmp_path, 9).write_text("{not json")
    with pytest.raises(ValueError):
        durability.load_manifest(tmp_path, 9)


@pytest.mark.parametrize("payload", [b"", b"x" * 256, bytes(range(256)) * 4099],
                         ids=["empty", "small", "multi_chunk"])
def test_manifest_equals_jax(tmp_path, payload):
    """The same files hash to JAX's manifest, key for key (the chunked
    hash crosses its 1 MiB chunk at the largest payload)."""
    sdir = _fake_step(tmp_path / "port", 4, payload=payload, manifest=False)
    (sdir / "sub").mkdir()
    (sdir / "sub" / "nested.bin").write_bytes(b"n" * 17)
    assert durability.build_manifest(sdir, 4) == jax_durability.build_manifest(sdir, 4)
    assert durability.payload_files(sdir) == jax_durability.payload_files(sdir)


# -------------------------------------------------- corruption matrix


@pytest.mark.parametrize("corrupt_mode", ["flip", "truncate", "delete"])
@pytest.mark.parametrize("target", [PAYLOAD, "meta.json"])
def test_verify_full_names_step_and_file(tmp_path, corrupt_mode, target):
    _fake_step(tmp_path, 5)
    victim = durability.corrupt_step(tmp_path, 5, corrupt_mode, target=target)
    assert victim == target
    result = durability.verify_step(tmp_path, 5, mode="full")
    assert result.verifiable and result.findings
    # every finding names the step and the damaged file
    assert all(f.startswith("step 5: ") for f in result.findings)
    assert any(target in f for f in result.findings)


@pytest.mark.parametrize("corrupt_mode,fast_catches", [
    ("flip", False),      # same size, same file set: needs the hash pass
    ("truncate", True),   # size mismatch
    ("delete", True),     # file-set mismatch
])
def test_verify_fast_catches_shape_not_content(tmp_path, corrupt_mode, fast_catches):
    _fake_step(tmp_path, 1)
    durability.corrupt_step(tmp_path, 1, corrupt_mode)
    fast = durability.verify_step(tmp_path, 1, mode="fast")
    assert bool(fast.findings) == fast_catches
    assert not durability.verify_step(tmp_path, 1, mode="full").ok


@pytest.mark.parametrize("corrupt_mode", ["flip", "truncate", "delete"])
@pytest.mark.parametrize("mode", ["fast", "full"])
def test_verify_findings_equal_jax(tmp_path, corrupt_mode, mode):
    """One file set in both layouts, one corruption: the same victim, the
    same findings word for word, in both verify modes."""
    port, ref = tmp_path / "port", tmp_path / "jax"
    sdir = _fake_step(port, 2, payload=b"p" * 1000, manifest=False)
    (sdir / "_CHECKPOINT_METADATA").write_text("{}")
    durability.write_manifest(port, 2, durability.build_manifest(sdir, 2))
    _jax_fake_step(ref, 2, payload=b"p" * 1000)
    assert (durability.corrupt_step(port, 2, corrupt_mode)
            == jax_durability.corrupt_step(ref, 2, corrupt_mode))
    got = durability.verify_step(port, 2, mode=mode)
    want = jax_durability.verify_step(ref, 2, mode=mode)
    assert (got.step, got.mode, got.verifiable, got.findings) == (
        want.step, want.mode, want.verifiable, want.findings)


def test_verify_catches_manifest_corruption_itself(tmp_path):
    """The manifest is part of the verified surface: a torn manifest is a
    named finding, not a crash and not a silent pass."""
    _fake_step(tmp_path, 2)
    mpath = durability.manifest_path(tmp_path, 2)
    mpath.write_text(mpath.read_text()[: len(mpath.read_text()) // 2])
    result = durability.verify_step(tmp_path, 2, mode="fast")
    assert result.verifiable and result.findings
    assert any("manifest-2.json" in f for f in result.findings)


def test_verify_catches_unexpected_file(tmp_path):
    _fake_step(tmp_path, 4)
    (tmp_path / "step_4" / "stray.bin").write_bytes(b"stray")
    result = durability.verify_step(tmp_path, 4, mode="fast")
    assert any("stray.bin" in f and "not in manifest" in f for f in result.findings)


def test_verify_legacy_step_is_unverifiable_not_a_finding(tmp_path):
    _fake_step(tmp_path, 7, manifest=False)
    result = durability.verify_step(tmp_path, 7, mode="full")
    assert not result.verifiable and not result.findings and not result.ok


def test_corrupt_step_picks_largest_payload(tmp_path):
    sdir = _fake_step(tmp_path, 1, payload=b"y" * 4096)
    victim = durability.corrupt_step(tmp_path, 1, "flip")
    assert victim == PAYLOAD  # the largest file, not the index or meta
    assert (sdir / victim).stat().st_size == 4096  # flip preserves size


# ------------------------------------------------------------ retention


def test_retention_victims_policy():
    steps = [10, 20, 30, 40, 50, 60]
    assert durability.retention_victims(steps, 2) == [10, 20, 30, 40]
    assert durability.retention_victims(steps, 1, keep_every=30) == [10, 20, 40, 50]
    assert durability.retention_victims(steps, 1, protected={20}) == [10, 30, 40, 50]
    with pytest.raises(ValueError):
        durability.retention_victims(steps, 0)


def test_retention_never_deletes_newest():
    """Property: for any step set and policy, the newest step survives."""
    for steps in ([1], [1, 2], [3, 7, 9, 12], list(range(1, 30, 3))):
        for keep_last in (1, 2, 5):
            for keep_every in (None, 2, 10):
                victims = durability.retention_victims(steps, keep_last, keep_every)
                assert max(steps) not in victims
                assert len(set(steps) - set(victims)) >= min(len(steps), keep_last)


def test_retention_victims_equal_jax():
    """JAX's policy over a grid of step sets, keep-last, keep-every and
    protected sets."""
    rng = np.random.default_rng(0)
    sets = [[], [5], [1, 2], [3, 7, 9, 12], list(range(1, 60, 4)),
            sorted(set(rng.integers(1, 200, 25).tolist()))]
    cases = 0
    for steps in sets:
        for keep_last in (1, 2, 3, 7):
            for keep_every in (None, 2, 5, 50):
                for protected in (set(), set(steps[:1]), set(steps[::3])):
                    got = durability.retention_victims(steps, keep_last, keep_every, protected)
                    want = jax_durability.retention_victims(steps, keep_last, keep_every,
                                                            protected)
                    assert got == want, (steps, keep_last, keep_every, protected)
                    cases += 1
    assert cases == 6 * 4 * 4 * 3
    for bad in (0, -1):
        with pytest.raises(ValueError):
            durability.retention_victims([1], bad)
        with pytest.raises(ValueError):
            jax_durability.retention_victims([1], bad)


def test_apply_retention_and_orphan_manifests(tmp_path):
    for step in (1, 2, 3, 4):
        _fake_step(tmp_path, step)
    assert durability.apply_retention(tmp_path, keep_last=2) == [1, 2]
    assert durability.committed_steps(tmp_path) == [3, 4]
    assert not durability.manifest_path(tmp_path, 1).exists()
    # a step deleted outside the policy leaves its manifest orphaned
    shutil.rmtree(tmp_path / "step_3")
    assert durability.gc_orphan_manifests(tmp_path) == [3]
    assert not durability.manifest_path(tmp_path, 3).exists()


def test_committed_steps_ignore_sidecars(tmp_path):
    """Only `step_N` directories are steps: manifests, in-flight
    temporaries, the staging directory and stray names are not."""
    for step in (2, 10):
        _fake_step(tmp_path, step)
    for name in (".tmp-step_3-1-abc", ".old-step_2-1-abc", ".stale", "step_x", "3"):
        (tmp_path / name).mkdir()
    (tmp_path / "step_4").write_text("a file, not a step")
    assert durability.committed_steps(tmp_path) == [2, 10]
    assert durability.manifested_steps(tmp_path) == [2, 10]
    assert durability.committed_steps(tmp_path / "missing") == []


# ------------------------------------------------------------ mirroring


def test_mirror_step_publishes_verified_copy(tmp_path):
    primary, mirror = tmp_path / "p", tmp_path / "m"
    _fake_step(primary, 1)
    assert durability.mirror_step(primary, mirror, 1) == []
    assert durability.verify_step(mirror, 1, mode="full").ok
    # idempotent: an intact mirror copy is not re-copied or disturbed
    assert durability.mirror_step(primary, mirror, 1) == []
    # a mirror copy is real bytes, not a hardlink back to the primary
    src = primary / "step_1" / PAYLOAD
    dst = mirror / "step_1" / PAYLOAD
    assert os.stat(src).st_ino != os.stat(dst).st_ino


def test_mirror_step_rejects_post_manifest_rot(tmp_path):
    """A source that decayed after its manifest landed never publishes: the
    mirror-side re-hash rejects the copy and tears it down."""
    primary, mirror = tmp_path / "p", tmp_path / "m"
    _fake_step(primary, 2)
    durability.corrupt_step(primary, 2, "flip")
    findings = durability.mirror_step(primary, mirror, 2)
    assert findings and any("sha256 mismatch" in f for f in findings)
    assert not (mirror / "step_2").exists()
    assert not list(mirror.glob(".tmp-*"))


def test_last_intact_on_mirror_protects_broken_primaries(tmp_path):
    primary, mirror = tmp_path / "p", tmp_path / "m"
    for step in (1, 2):
        _fake_step(primary, step)
        assert durability.mirror_step(primary, mirror, step) == []
    durability.corrupt_step(primary, 2, "truncate")
    assert durability.last_intact_on_mirror(primary, mirror) == {2}
    victims = durability.apply_retention(
        mirror, keep_last=1, protected=durability.last_intact_on_mirror(primary, mirror))
    assert victims == [1]
    assert durability.committed_steps(mirror) == [2]


def test_mirror_daemon_mirrors_gcs_and_scrubs(tmp_path, registry):
    primary, mirror = tmp_path / "p", tmp_path / "m"
    primary.mkdir()
    for step in (1, 2, 3):
        _fake_step(primary, step)
    daemon = MirrorDaemon(primary, mirror, interval_s=0.05, keep_last=2,
                          scrub_interval_s=0.0, registry=registry).start()
    try:
        assert daemon.drain(timeout_s=30.0)
        stats = daemon.stats()
        assert stats["mirrored"] and not stats["failed"]
        # drain() barriers the mirroring attempts; wait out the GC pass
        deadline = time.monotonic() + 30.0
        while durability.committed_steps(mirror) != [2, 3] and time.monotonic() < deadline:
            time.sleep(0.02)
        assert durability.committed_steps(mirror) == [2, 3]
    finally:
        daemon.stop()
    snap = registry.snapshot()
    assert snap["ckpt/mirrored_steps"] == 2
    assert snap["ckpt/mirror_lag_steps"] == 1  # step 1 GC'd mirror-side
    assert snap["ckpt/gc_deleted"] >= 1
    # scrubber: drive _maybe_scrub directly with a fake clock
    clock = iter([100.0, 200.0]).__next__
    scrubber = MirrorDaemon(primary, mirror, scrub_interval_s=1.0, registry=registry,
                            clock=clock)
    scrubber._maybe_scrub(registry)
    snap = registry.snapshot()
    assert snap["ckpt/scrub_ok"] == 1 and snap["ckpt/scrub_last_ok"] == 1.0
    durability.corrupt_step(primary, 1, "flip")
    scrubber._scrub_cursor = 0
    scrubber._maybe_scrub(registry)
    snap = registry.snapshot()
    assert snap["ckpt/scrub_failures"] == 1 and snap["ckpt/scrub_last_ok"] == 0.0


def test_mirror_retention_does_not_recopy_retired_steps(tmp_path, registry):
    """The primary keeps 3 steps, the mirror 2: retention deletes step 1
    from the mirror once, and later passes neither copy it back nor delete
    it again, so a drain after them returns at once. JAX's daemon drops the
    step from its mirrored set, copies it back on every pass and deletes it
    again (ROADMAP C.23): its `ckpt/gc_deleted` grows with every pass, and
    its drain returns only when it samples a pass between the copy and the
    deletion."""
    from llm_training_tpu.resilience.durability import MirrorDaemon as JaxDaemon

    primary, ref = tmp_path / "p", tmp_path / "jax"
    for step in (1, 2, 3):
        _fake_step(primary, step)
        _jax_fake_step(ref, step)
    daemon = MirrorDaemon(primary, tmp_path / "m", interval_s=0.01, keep_last=2,
                          scrub_interval_s=0.0, registry=registry).start()
    jax_registry = JaxRegistry()
    jax_daemon = JaxDaemon(ref, tmp_path / "jm", interval_s=0.01, keep_last=2,
                           scrub_interval_s=0.0, registry=jax_registry).start()
    try:
        deadline = time.monotonic() + 30.0
        while (min(daemon.stats()["passes"], jax_daemon.stats()["passes"]) < 20
               and time.monotonic() < deadline):
            time.sleep(0.02)
        assert daemon.drain(timeout_s=5.0)
    finally:
        daemon.stop()
        jax_daemon.stop()
    assert registry.snapshot()["ckpt/gc_deleted"] == 1
    assert durability.committed_steps(tmp_path / "m") == [2, 3]
    assert jax_registry.snapshot_with_kinds()[0]["ckpt/gc_deleted"] > 5


# -------------------------------------------------------- staged swaps


def test_stale_stage_promote_round_trip(tmp_path):
    _fake_step(tmp_path, 1)
    staged = durability.stage_stale_step(tmp_path, 1)
    assert staged == tmp_path / ".stale" / "step_1" and staged.is_dir()
    # the kill-mid-swap signature: the step moved away, no replacement
    shutil.rmtree(tmp_path / "step_1")
    durability.manifest_path(tmp_path, 1).unlink()
    assert durability.promote_stale_steps(tmp_path) == [1]
    assert durability.verify_step(tmp_path, 1, mode="full").ok
    assert not (tmp_path / durability.STALE_DIR).exists()


def test_promote_skips_committed_replacement(tmp_path):
    _fake_step(tmp_path, 1)
    durability.stage_stale_step(tmp_path, 1)
    # the replacement committed: the staged copy is just swap trash
    assert durability.promote_stale_steps(tmp_path) == []
    assert not (tmp_path / durability.STALE_DIR).exists()
    assert durability.verify_step(tmp_path, 1, mode="full").ok


# ----------------------------------------------------------- chaos env


def test_chaos_ckpt_env_parsing(monkeypatch):
    monkeypatch.setenv("LLMT_CHAOS_CKPT_CORRUPT", "flip:3")
    monkeypatch.setenv("LLMT_CHAOS_CKPT_KILL_IN_SWAP", "2")
    monkeypatch.setenv("LLMT_CHAOS_CHECKPOINT_ERROR_STEPS", "4, 6")
    monkeypatch.setenv("LLMT_CHAOS_CHECKPOINT_ERROR_PROB", "0.25")
    monkeypatch.setenv("LLMT_CHAOS_SIGKILL_STEP", "5")
    config = config_from_env(ChaosConfig())
    from llm_training_tpu.resilience import ChaosConfig as JaxChaosConfig
    from llm_training_tpu.resilience import config_from_env as jax_config_from_env

    ref = jax_config_from_env(JaxChaosConfig())
    for key in ("ckpt_corrupt", "ckpt_kill_in_swap", "checkpoint_error_steps",
                "checkpoint_error_prob", "sigkill_step"):
        assert getattr(config, key) == getattr(ref, key), key
    assert config.ckpt_corrupt == "flip:3" and config.ckpt_kill_in_swap == 2
    assert config.any_active()


def test_chaos_corrupts_targeted_step_once(tmp_path, registry):
    _fake_step(tmp_path, 3)
    _fake_step(tmp_path, 4)
    chaos = install_chaos(ChaosConfig(ckpt_corrupt="truncate:3"), registry=registry)
    assert chaos.maybe_corrupt_checkpoint(tmp_path, 4) is None  # wrong step
    assert chaos.maybe_corrupt_checkpoint(tmp_path, 3) is not None
    assert not durability.verify_step(tmp_path, 3, mode="fast").ok
    # fire-once: the second matching call is a no-op
    assert chaos.maybe_corrupt_checkpoint(tmp_path, 3) is None
    assert registry.snapshot()["resilience/chaos_injections"] == 1


def test_chaos_untargeted_waits_for_final_barrier(tmp_path, registry):
    _fake_step(tmp_path, 1)
    chaos = install_chaos(ChaosConfig(ckpt_corrupt="flip"), registry=registry)
    assert chaos.maybe_corrupt_checkpoint(tmp_path, 1) is None  # mid-run: no
    assert chaos.maybe_corrupt_checkpoint(tmp_path, 1, at_final_barrier=True) is not None


# ------------------------------------------------------------ ckpt CLI


def _run_ckpt(*argv):
    from llm_training_tpu_torch.cli.main import main

    return main(["ckpt", *[str(a) for a in argv]])


def _run_jax_ckpt(*argv):
    from llm_training_tpu.cli.main import main

    return main(["ckpt", *[str(a) for a in argv]])


def test_ckpt_cli_exit_codes(tmp_path, capsys):
    """0 clean, 1 findings naming step and file, 2 unusable; JAX's command
    answers the same codes on the same files in its layout."""
    primary, ref = tmp_path / "p", tmp_path / "jax"
    codes = []
    for run, root in ((_run_ckpt, primary), (_run_jax_ckpt, ref)):
        codes.append([run("verify", root)])
    assert str(primary) in capsys.readouterr().out
    for step in (1, 2):
        _fake_step(primary, step)
        _jax_fake_step(ref, step)
    for i, (run, root) in enumerate(((_run_ckpt, primary), (_run_jax_ckpt, ref))):
        codes[i] += [run("verify", root, "--mode", "full"), run("ls", root)]
    assert "step 1" in capsys.readouterr().out
    durability.corrupt_step(primary, 2, "flip", target=PAYLOAD)
    jax_durability.corrupt_step(ref, 2, "flip", target=PAYLOAD)
    for i, (run, root) in enumerate(((_run_ckpt, primary), (_run_jax_ckpt, ref))):
        codes[i].append(run("verify", root, "--mode", "full"))
        out = capsys.readouterr().out
        assert "FINDING" in out and "step 2" in out and PAYLOAD in out
        # fast mode cannot see a same-size flip: that asymmetry is the point
        codes[i].append(run("verify", root, "--mode", "fast"))
    assert codes[0] == codes[1] == [2, 0, 0, 1, 0]


def test_ckpt_cli_mirror_and_gc(tmp_path, capsys):
    primary, mirror = tmp_path / "p", tmp_path / "m"
    for step in (1, 2, 3):
        _fake_step(primary, step)
    assert _run_ckpt("mirror", primary, "--mirror-dir", mirror) == 0
    assert durability.committed_steps(mirror) == [1, 2, 3]
    # dry-run reports victims without deleting
    assert _run_ckpt("gc", primary, "--mirror-dir", mirror, "--keep-last", "1",
                     "--dry-run") == 0
    assert durability.committed_steps(mirror) == [1, 2, 3]
    assert _run_ckpt("gc", primary, "--mirror-dir", mirror, "--keep-last", "1") == 0
    assert durability.committed_steps(mirror) == [3]
    # mirror with no mirror dir configured = unusable
    capsys.readouterr()
    assert _run_ckpt("mirror", primary) == 2


# ----------------------------------------- Checkpointer integration


class _Tiny(torch.nn.Module):
    def __init__(self, value: float):
        super().__init__()
        self.w = torch.nn.Parameter(torch.full((4,), float(value)))


def _tiny_state(value: float) -> TrainState:
    return TrainState(step=0, model=_Tiny(value), optimizer=None, rng=prng.key(0))


def _checkpointer(dirpath, **overrides) -> Checkpointer:
    kwargs = dict(dirpath=str(dirpath), async_save=False, retry_backoff_s=0.0,
                  mirror_interval_s=0.05)
    kwargs.update(overrides)
    return Checkpointer(CheckpointConfig(**kwargs))


def _restored(ckpt: Checkpointer, **kw) -> tuple[dict | None, float]:
    state = _tiny_state(0.0)
    meta = ckpt.maybe_restore(state, **kw)
    values = state.model.w.detach()
    assert torch.all(values == values[0])
    return meta, float(values[0])


def test_save_writes_manifest_at_commit(tmp_path, registry):
    ckpt = _checkpointer(tmp_path / "p")
    ckpt.save(1, _tiny_state(1.0))
    assert durability.verify_step(tmp_path / "p", 1, mode="full").ok
    assert registry.snapshot()["checkpoint/manifest_n"] == 1
    assert ckpt.last_manifest["step"] == 1 and ckpt.last_manifest["bytes"] > 0
    ckpt.close()


def test_async_save_manifests_after_the_write(tmp_path, registry):
    """An async save's manifest lands once its write finished: at the next
    save or at wait(), never over a step still being written."""
    ckpt = _checkpointer(tmp_path / "p", async_save=True, max_to_keep=2)
    for step in (1, 2, 3):
        ckpt.save(step, _tiny_state(float(step)))
    ckpt.wait()
    assert durability.committed_steps(tmp_path / "p") == [2, 3]
    assert sorted(p.name for p in (tmp_path / "p").glob("manifest-*.json")) == [
        "manifest-2.json", "manifest-3.json"]
    assert all(durability.verify_step(tmp_path / "p", s, mode="full").ok for s in (2, 3))
    ckpt.close()


def test_restore_heals_corrupt_primary_from_mirror(tmp_path, registry):
    """Flip a byte in the newest primary step: verify-before-restore finds
    it, the mirror's copy replaces it in place, and no fallback happens."""
    primary, mirror = tmp_path / "p", tmp_path / "m"
    ckpt = _checkpointer(primary, mirror_dir=str(mirror), verify="full")
    ckpt.save(1, _tiny_state(1.0))
    ckpt.save(2, _tiny_state(2.0))
    ckpt.wait()  # manifest flush + mirror drain
    assert durability.committed_steps(mirror) == [1, 2]
    durability.corrupt_step(primary, 2, "flip")
    meta, value = _restored(ckpt)
    assert meta["step"] == 2 and value == 2.0  # healed in place, NOT a fallback
    snap = registry.snapshot()
    assert snap["checkpoint/verify_failures"] == 1
    assert snap["checkpoint/mirror_restores"] == 1
    assert snap.get("resilience/restore_fallbacks", 0) == 0
    assert durability.verify_step(primary, 2, mode="full").ok
    ckpt.close()


def test_restore_falls_back_when_mirror_also_rotten(tmp_path, registry):
    """Both copies of the newest step are bad: one fallback leg to the older
    step, and the verified-corrupt step is repaired away."""
    primary, mirror = tmp_path / "p", tmp_path / "m"
    ckpt = _checkpointer(primary, mirror_dir=str(mirror), verify="full")
    ckpt.save(1, _tiny_state(1.0))
    ckpt.save(2, _tiny_state(2.0))
    ckpt.wait()
    durability.corrupt_step(primary, 2, "flip")
    durability.corrupt_step(mirror, 2, "flip")
    meta, value = _restored(ckpt)
    assert meta["step"] == 1 and value == 1.0
    snap = registry.snapshot()
    assert snap["resilience/restore_fallbacks"] == 1
    assert snap["checkpoint/verify_failures"] >= 1
    assert ckpt.all_steps() == [1]
    assert not durability.manifest_path(primary, 2).exists()
    ckpt.close()


def test_environmental_error_preserves_checkpoint(tmp_path, registry, monkeypatch):
    """A restore failure whose bytes verify clean is environmental: fall
    back, but do NOT delete the good checkpoint."""
    ckpt = _checkpointer(tmp_path / "p", save_retries=0)
    ckpt.save(1, _tiny_state(1.0))
    ckpt.save(2, _tiny_state(2.0))
    ckpt.wait()
    real_load = ckpt._load

    def broken_env(state, step):
        if step == 2:
            raise PermissionError("mount went read-only")
        return real_load(state, step)

    monkeypatch.setattr(ckpt, "_load", broken_env)
    meta, _ = _restored(ckpt)
    assert meta["step"] == 1
    assert 2 in ckpt.all_steps()  # NOT deleted
    assert durability.manifest_path(tmp_path / "p", 2).exists()
    snap = registry.snapshot()
    assert snap["resilience/restore_fallbacks"] >= 1
    assert snap.get("checkpoint/verify_failures", 0) == 0
    ckpt.close()


def test_legacy_step_without_manifest_keeps_repair_delete(tmp_path, registry):
    """A step without a manifest restores unverified; an unrestorable one
    is dropped so the resumed run can save it again."""
    ckpt = _checkpointer(tmp_path / "p", verify="full")
    ckpt.save(1, _tiny_state(1.0))
    ckpt.save(2, _tiny_state(2.0))
    durability.manifest_path(tmp_path / "p", 2).unlink()  # make it legacy
    meta, value = _restored(ckpt, repair=False)
    assert meta["step"] == 2 and value == 2.0  # unverifiable is not a finding
    assert registry.snapshot().get("checkpoint/verify_failures", 0) == 0
    for data in (tmp_path / "p" / "step_2").glob("*.distcp"):
        data.unlink()
    meta, _ = _restored(ckpt)
    assert meta["step"] == 1
    assert ckpt.all_steps() == [1]  # legacy path still repairs
    ckpt.close()


def test_explicit_step_never_falls_back(tmp_path, registry):
    ckpt = _checkpointer(tmp_path / "p", verify="full")
    ckpt.save(1, _tiny_state(1.0))
    ckpt.save(2, _tiny_state(2.0))
    durability.corrupt_step(tmp_path / "p", 2, "truncate")
    with pytest.raises(Exception):
        ckpt.maybe_restore(_tiny_state(0.0), step=2)
    assert registry.snapshot().get("resilience/restore_fallbacks", 0) == 0
    assert ckpt.all_steps() == [1, 2]  # an explicit request repairs nothing
    meta, value = _restored(ckpt, step=1)
    assert meta["step"] == 1 and value == 1.0
    with pytest.raises(FileNotFoundError):
        ckpt.maybe_restore(_tiny_state(0.0), step=7)
    ckpt.close()


def test_every_step_failing_raises_the_first_error(tmp_path, monkeypatch):
    ckpt = _checkpointer(tmp_path / "p", save_retries=0)
    ckpt.save(1, _tiny_state(1.0))
    ckpt.save(2, _tiny_state(2.0))
    errors = iter([ValueError("layout of step 2"), ValueError("layout of step 1")])

    def failing(state, step):
        raise next(errors)

    monkeypatch.setattr(ckpt, "_load", failing)
    with pytest.raises(ValueError, match="layout of step 2") as info:
        ckpt.maybe_restore(_tiny_state(0.0))
    assert any("all retained checkpoint steps [2, 1]" in n for n in info.value.__notes__)
    assert ckpt.all_steps() == [1, 2]  # clean bytes: nothing deleted
    ckpt.close()


def test_save_retries_an_injected_checkpoint_error(tmp_path, registry):
    """`checkpoint_error_steps` raises a transient error at the save's
    chaos point once; the retry commits the step, counted in
    `checkpoint/retries`."""
    install_chaos(ChaosConfig(checkpoint_error_steps=(2,)), registry=registry)
    ckpt = _checkpointer(tmp_path / "p")
    ckpt.save(1, _tiny_state(1.0))
    ckpt.save(2, _tiny_state(2.0))
    snap = registry.snapshot()
    assert snap["checkpoint/retries"] == 1 and snap["resilience/chaos_injections"] == 1
    assert durability.verify_step(tmp_path / "p", 2, mode="full").ok
    ckpt.close()
    ckpt = _checkpointer(tmp_path / "q", save_retries=0)
    with pytest.raises(OSError, match="injected checkpoint_save"):
        install_chaos(ChaosConfig(checkpoint_error_steps=(1,)))
        ckpt.save(1, _tiny_state(1.0))
    assert ckpt.all_steps() == []


def test_force_save_leaves_no_stale_residue_on_success(tmp_path):
    for async_save in (False, True):
        root = tmp_path / str(async_save)
        ckpt = _checkpointer(root, async_save=async_save)
        ckpt.save(1, _tiny_state(1.0))
        ckpt.save(1, _tiny_state(3.0), force=True)
        ckpt.wait()
        assert not (root / durability.STALE_DIR).exists()
        assert sorted(p.name for p in root.iterdir()) == ["manifest-1.json", "step_1"]
        assert durability.verify_step(root, 1, mode="full").ok
        meta, value = _restored(ckpt)
        assert value == 3.0
        ckpt.close()


def test_startup_promotes_interrupted_force_save(tmp_path):
    """A kill inside the swap window: the staged copy is promoted by the
    next Checkpointer before it reads the directory."""
    ckpt = _checkpointer(tmp_path / "p")
    ckpt.save(1, _tiny_state(1.0))
    ckpt.close()
    durability.stage_stale_step(tmp_path / "p", 1)
    shutil.rmtree(tmp_path / "p" / "step_1")  # the step the kill left moved aside
    ckpt = _checkpointer(tmp_path / "p")
    assert ckpt.all_steps() == [1]
    meta, value = _restored(ckpt)
    assert meta["step"] == 1 and value == 1.0
    ckpt.close()


def test_forced_save_killed_between_renames_keeps_the_step(tmp_path, monkeypatch):
    """R1: a forced save over committed step 3 dies between the two renames
    of its swap (the committed step moved aside, the replacement not yet in
    place). A new Checkpointer restores step 3 with every tensor bit-equal
    to the saved one, and a later save never deletes the durable copy."""
    root = tmp_path / "p"
    saved = _tiny_state(0.0)
    with torch.no_grad():
        saved.model.w.copy_(torch.tensor([0.1, -2.5, 3.25, 1e-30]))
    saved.step = 3
    ckpt = _checkpointer(root, max_to_keep=1)
    ckpt.save(3, saved)
    ckpt.close()
    real_replace = os.replace

    def dying_replace(src, dst):
        if Path(src).name.startswith(".tmp-step_3") and Path(dst).name == "step_3":
            raise SystemExit("killed inside the swap")
        return real_replace(src, dst)

    ckpt = _checkpointer(root, max_to_keep=1)
    monkeypatch.setattr(os, "replace", dying_replace)
    with pytest.raises(SystemExit):
        ckpt.save(3, _tiny_state(9.0), force=True)
    monkeypatch.setattr(os, "replace", real_replace)
    assert not (root / "step_3").exists()
    # the dead process's successor: promote, then save another step first
    ckpt = _checkpointer(root, max_to_keep=1)
    assert ckpt.all_steps() == [3]
    state = _tiny_state(0.0)
    assert ckpt.maybe_restore(state)["step"] == 3
    for name, tensor in saved.state_dict().items():
        assert torch.equal(state.state_dict()[name], tensor), name
    assert durability.verify_step(root, 3, mode="full").ok
    ckpt.close()


def test_force_save_survives_sigkill_in_swap(tmp_path):
    """The chaos kill of a forced save's swap in a process of its own
    (`LLMT_CHAOS_CKPT_KILL_IN_SWAP`): the process dies on SIGKILL, and the
    relaunch finds the pre-force copy whole."""
    child = textwrap.dedent(
        f"""
        import sys, torch
        sys.path.insert(0, {str(ROOT)!r})
        from llm_training_tpu_torch import prng
        from llm_training_tpu_torch.resilience import ChaosConfig, config_from_env, install_chaos
        from llm_training_tpu_torch.trainer.checkpoint import CheckpointConfig, Checkpointer
        from llm_training_tpu_torch.trainer.state import TrainState

        install_chaos(config_from_env(ChaosConfig()))

        class Tiny(torch.nn.Module):
            def __init__(self, v):
                super().__init__()
                self.w = torch.nn.Parameter(torch.full((4,), v))

        def tiny(v):
            return TrainState(step=0, model=Tiny(v), optimizer=None, rng=prng.key(0))

        ckpt = Checkpointer(CheckpointConfig(dirpath={str(tmp_path / "p")!r},
                                             async_save=False, retry_backoff_s=0.0))
        ckpt.save(1, tiny(1.0))
        ckpt.save(1, tiny(9.0), force=True)  # chaos SIGKILLs mid-swap
        raise SystemExit("survived the kill window")
        """
    )
    env = dict(os.environ, LLMT_CHAOS_CKPT_KILL_IN_SWAP="1")
    proc = subprocess.run([sys.executable, "-c", child], env=env, capture_output=True,
                          text=True, timeout=120, cwd=tmp_path)
    assert proc.returncode == -signal.SIGKILL, proc.stdout + proc.stderr
    assert (tmp_path / "p" / ".stale" / "step_1").is_dir()
    assert not (tmp_path / "p" / "step_1").exists()
    ckpt = _checkpointer(tmp_path / "p")
    assert ckpt.all_steps() == [1]
    meta, value = _restored(ckpt)
    assert meta["step"] == 1 and value == 1.0
    ckpt.close()


def test_targeted_chaos_exercises_mirror_reject_then_fallback(tmp_path, registry):
    """`ckpt_corrupt=truncate:2` fires after the manifest, before the
    mirror: the mirror rejects the rotten copy, and the restore falls back
    primary (2 corrupt) -> mirror (2 absent) -> older step 1."""
    primary, mirror = tmp_path / "p", tmp_path / "m"
    install_chaos(ChaosConfig(ckpt_corrupt="truncate:2"), registry=registry)
    ckpt = _checkpointer(primary, mirror_dir=str(mirror), verify="fast")
    ckpt.save(1, _tiny_state(1.0))
    ckpt.save(2, _tiny_state(2.0))  # corrupted right after its manifest
    ckpt.wait()
    assert durability.committed_steps(mirror) == [1]  # 2 was rejected
    meta, _ = _restored(ckpt)
    assert meta["step"] == 1
    snap = registry.snapshot()
    assert snap["ckpt/mirror_verify_rejects"] >= 1
    assert snap["resilience/restore_fallbacks"] == 1
    assert snap["checkpoint/verify_failures"] >= 1
    ckpt.close()


def test_untargeted_chaos_flip_heals_at_restore(tmp_path, registry):
    """`ckpt_corrupt=flip` (no step) fires at the final barrier AFTER the
    mirror drained: the restore lands on the mirror copy."""
    primary, mirror = tmp_path / "p", tmp_path / "m"
    install_chaos(ChaosConfig(ckpt_corrupt="flip"), registry=registry)
    ckpt = _checkpointer(primary, mirror_dir=str(mirror), verify="full")
    ckpt.save(2, _tiny_state(7.0))
    ckpt.wait()  # drain, then the flip lands on the newest primary step
    assert not durability.verify_step(primary, 2, mode="full").ok
    meta, value = _restored(ckpt)
    assert meta["step"] == 2 and value == 7.0
    assert registry.snapshot()["checkpoint/mirror_restores"] == 1
    ckpt.close()


# ---------------------------------------- the ladder against JAX's


def _jax_tiny(value: float):
    return JaxTrainState.create(params={"w": jnp.full((4,), value, jnp.float32)},
                                opt_state={"m": jnp.zeros((4,), jnp.float32)},
                                rng=jax.random.key(0))


def _jax_restored(ckpt, step=None):
    state = _jax_tiny(0.0)
    abstract = jax.eval_shape(lambda: state)
    shardings = jax.tree.map(lambda leaf: None, abstract)
    restored = ckpt.maybe_restore(abstract, shardings, step=step)
    return restored[1], float(np.asarray(restored[0].params["w"])[0])


LADDER_KEYS = ("checkpoint/verify_failures", "checkpoint/mirror_restores",
               "resilience/restore_fallbacks")


def _scenario(kind: str, primary: Path, mirror: Path, corrupt, drop_manifest, break_data):
    """What happens to the saved steps 1 and 2 before the restore."""
    if kind == "heal":
        corrupt(primary, 2, "flip")
    elif kind == "fallback":
        corrupt(primary, 2, "flip")
        corrupt(mirror, 2, "flip")
    elif kind == "explicit_older":
        corrupt(primary, 2, "truncate")
    elif kind == "legacy_clean":
        drop_manifest(primary, 2)
    elif kind == "legacy_broken":
        drop_manifest(primary, 2)
        break_data(primary, 2)


@pytest.mark.parametrize("kind", ["heal", "fallback", "explicit_older", "legacy_clean",
                                  "legacy_broken"])
def test_restore_ladder_matches_jax(tmp_path, kind):
    """One scenario through both checkpointers (mirror on, `verify: full`,
    steps 1 and 2 of values 1 and 2): the restored step and value, the
    ladder's counters and the steps left in the directory are JAX's."""
    explicit = 1 if kind == "explicit_older" else None
    mirrored = kind in ("heal", "fallback")
    outcomes = []
    for pkg in ("port", "jax"):
        primary, mirror = tmp_path / pkg / "p", tmp_path / pkg / "m"
        if pkg == "port":
            reg = TelemetryRegistry()
            previous = set_registry(reg)
            ckpt = _checkpointer(primary, mirror_dir=str(mirror) if mirrored else None,
                                 verify="full")
            tiny, restored, steps, corrupt = (_tiny_state, _restored, ckpt.all_steps,
                                              durability.corrupt_step)

            def break_data(root, step):
                for data in (root / f"step_{step}").glob("*.distcp"):
                    data.unlink()
        else:
            reg = JaxRegistry()
            previous = jax_set_registry(reg)
            ckpt = JaxCheckpointer(JaxCheckpointConfig(
                dirpath=str(primary), async_save=False, retry_backoff_s=0.0,
                mirror_interval_s=0.05, mirror_dir=str(mirror) if mirrored else None,
                verify="full"))
            tiny, restored, corrupt = _jax_tiny, _jax_restored, jax_durability.corrupt_step
            steps = ckpt.manager.all_steps

            def break_data(root, step):
                shutil.rmtree(next((root / str(step)).glob("state*")))
        try:
            ckpt.save(1, tiny(1.0))
            ckpt.save(2, tiny(2.0))
            ckpt.wait()

            def drop_manifest(root, step, mod=durability if pkg == "port" else jax_durability):
                mod.manifest_path(root, step).unlink()

            _scenario(kind, primary, mirror, corrupt, drop_manifest, break_data)
            meta, value = restored(ckpt, step=explicit)
            snap = reg.snapshot()
            outcomes.append((meta["step"], value, {k: snap.get(k, 0) for k in LADDER_KEYS},
                             sorted(steps())))
        finally:
            ckpt.close()
            (set_registry if pkg == "port" else jax_set_registry)(previous)
    assert outcomes[0] == outcomes[1], outcomes


# ------------------------------------------------------------ config


def test_checkpoint_config_matches_jax_defaults():
    """Every key of JAX's CheckpointConfig, with JAX's defaults; a node
    setting every durability key builds in both packages."""
    ours = CheckpointConfig()
    want = JaxCheckpointConfig().model_dump()
    assert {k: getattr(ours, k) for k in want} == want
    assert set(CheckpointConfig.__dataclass_fields__) == set(want)
    node = {"dirpath": "x", "save_retries": 5, "retry_backoff_s": 0.1,
            "retry_backoff_max_s": 2.0, "verify": "full", "mirror_dir": "m",
            "mirror_interval_s": 0.5, "mirror_keep_last": 2, "mirror_keep_every": 10,
            "scrub_interval_s": 0.0, "save_on_exit": False}
    assert vars(CheckpointConfig.from_node(node)) == JaxCheckpointConfig(**node).model_dump()
    with pytest.raises(ValueError, match="verify"):
        CheckpointConfig(verify="paranoid")
