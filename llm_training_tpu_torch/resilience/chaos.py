"""Fault injection: deterministic and probabilistic failures at the
recovery sites of `fit`.

Counterpart of the part of `llm_training_tpu/resilience/chaos.py` that the
port's fit runs: data-source errors in the prefetcher (`data_error_steps`,
`data_error_prob`), checkpoint-save errors (`checkpoint_error_steps`,
`checkpoint_error_prob`), a real SIGTERM or SIGKILL at an optimizer step
(`sigterm_step`, `sigkill_step`), divergence poisoned into the host
metrics (`nan_step`, `spike_step`, `spike_scale`), a sustained slow regime
(`slow_step_s` from `slow_step_from`), byte-level corruption of a
committed checkpoint (`ckpt_corrupt`) and a SIGKILL inside a forced
save's swap (`ckpt_kill_in_swap`), all seeded by `seed`; and the serving
tier's faults, at the top of an engine step and in the `serve` CLI's
intake: a wedged step (`serve_stall_step`), a SIGTERM mid-stream
(`serve_sigterm_step`) and a flood of malformed request lines
(`serve_malformed_flood`), each on the first supervisor attempt only;
and the router's, in the `route` CLI: a SIGKILL of the replica that
produced the Nth forwarded token (`router_kill_replica_at`) and an
assignment accepted but never submitted (`router_blackhole_at`). Injected
I/O faults raise `ChaosError`, an `OSError`, so they take the production
retry path.

The harness is a process global the trainer installs at fit start
(`install_chaos`) and removes in its fit's `finally`; call sites poll
`chaos_point(site, step)`, a no-op when nothing is installed.
`config_from_env` overlays `LLMT_CHAOS_*` variables with JAX's names.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import random
import signal
import threading
import time
from dataclasses import dataclass

logger = logging.getLogger(__name__)

# injection sites: data-source pull / checkpoint save I/O
SITES = ("data", "checkpoint_save")


class ChaosError(OSError):
    """An injected transient fault (OSError so retry policies treat it as
    they would a real storage/network error)."""


@dataclass
class ChaosConfig:
    seed: int = 0
    # fire exactly once at these step numbers (data: prefetcher production
    # index; checkpoint_save: optimizer step)
    data_error_steps: tuple[int, ...] = ()
    checkpoint_error_steps: tuple[int, ...] = ()
    # per-call probability in [0, 1]
    data_error_prob: float = 0.0
    checkpoint_error_prob: float = 0.0
    # deliver a real SIGTERM to this process at this optimizer step
    sigterm_step: int | None = None
    # deliver SIGKILL at this optimizer step: a hard death only `supervise`
    # survives. Fires only in a run that STARTED from step 0, so the
    # supervisor's relaunch (resuming past a checkpoint) survives it
    sigkill_step: int | None = None
    # at the first log step >= the trigger, poison the host loss/grad_norm:
    # nan_step makes them non-finite, spike_step scales them by spike_scale
    # (host-side only: the device state stays healthy)
    nan_step: int | None = None
    spike_step: int | None = None
    spike_scale: float = 1e3
    # sleep this long at every optimizer-step boundary from slow_step_from on
    slow_step_s: float = 0.0
    slow_step_from: int = 0
    # byte-level checkpoint corruption: `{flip,truncate,delete}[:step]`.
    # With `:step` it fires right after that step's manifest lands (before
    # the mirror copies it: the mirror's re-verification must reject the
    # copy); without a step, on the newest committed step at the final
    # wait() barrier (after the mirror drained: the restore must heal)
    ckpt_corrupt: str | None = None
    # SIGKILL this process inside a forced save's swap at this step: the
    # staged `.stale/` copy must be promotable on relaunch
    ckpt_kill_in_swap: int | None = None
    # serving-tier faults, all gated to the FIRST supervisor attempt
    # (LLMT_SUPERVISOR_ATTEMPT <= 1) so a supervised relaunch survives
    # re-crossing the trigger step:
    # wedge the serving engine at this engine step (sleep far past any
    # watchdog window): the hang watchdog's dump + SIGABRT path
    serve_stall_step: int | None = None
    # deliver a real SIGTERM at this engine step, mid-stream: the
    # drain -> exit 75 -> supervised replay path
    serve_sigterm_step: int | None = None
    # inject this many malformed request lines into the serve CLI's intake
    # at startup: the error boundary must answer each and keep serving
    serve_malformed_flood: int = 0
    # router-tier faults, consumed by the `route` CLI (the router strips
    # LLMT_CHAOS_ROUTER_* from its replicas' environments, so only the
    # router reacts): SIGKILL the replica that produced the Nth forwarded
    # token (failover replay with exactly-once terminals) ...
    router_kill_replica_at: int | None = None
    # ... and accept the Nth request->replica assignment but never submit
    # it: only a hedge can finish that request
    router_blackhole_at: int | None = None

    def __post_init__(self):
        self.data_error_steps = tuple(int(s) for s in self.data_error_steps)
        self.checkpoint_error_steps = tuple(int(s) for s in self.checkpoint_error_steps)
        checks = (
            (0 <= self.data_error_prob <= 1, "data_error_prob must be in [0, 1]"),
            (0 <= self.checkpoint_error_prob <= 1, "checkpoint_error_prob must be in [0, 1]"),
            (self.spike_scale > 0, "spike_scale must be > 0"),
            (self.slow_step_s >= 0, "slow_step_s must be >= 0"),
            (self.slow_step_from >= 0, "slow_step_from must be >= 0"),
            (self.serve_malformed_flood >= 0, "serve_malformed_flood must be >= 0"),
        )
        for ok, message in checks:
            if not ok:
                raise ValueError(f"chaos: {message} ({self})")

    def any_active(self) -> bool:
        return bool(
            self.data_error_steps
            or self.checkpoint_error_steps
            or self.data_error_prob
            or self.checkpoint_error_prob
            or self.sigterm_step is not None
            or self.sigkill_step is not None
            or self.nan_step is not None
            or self.spike_step is not None
            or self.serve_stall_step is not None
            or self.serve_sigterm_step is not None
            or self.serve_malformed_flood > 0
            or self.router_kill_replica_at is not None
            or self.router_blackhole_at is not None
            or self.ckpt_corrupt is not None
            or self.ckpt_kill_in_swap is not None
            or self.slow_step_s > 0
        )


def config_from_env(base: ChaosConfig | None = None) -> ChaosConfig:
    """Overlay `LLMT_CHAOS_*` environment variables on `base`:
    LLMT_CHAOS_DATA_ERROR_STEPS / LLMT_CHAOS_CHECKPOINT_ERROR_STEPS
    (comma-separated ints), LLMT_CHAOS_DATA_ERROR_PROB /
    LLMT_CHAOS_CHECKPOINT_ERROR_PROB / LLMT_CHAOS_SPIKE_SCALE /
    LLMT_CHAOS_SLOW_STEP_S (floats), LLMT_CHAOS_SIGTERM_STEP /
    LLMT_CHAOS_SIGKILL_STEP / LLMT_CHAOS_NAN_STEP / LLMT_CHAOS_SPIKE_STEP /
    LLMT_CHAOS_CKPT_KILL_IN_SWAP / LLMT_CHAOS_SLOW_STEP_FROM /
    LLMT_CHAOS_SERVE_STALL_STEP / LLMT_CHAOS_SERVE_SIGTERM_STEP /
    LLMT_CHAOS_SERVE_MALFORMED_FLOOD / LLMT_CHAOS_ROUTER_KILL_REPLICA /
    LLMT_CHAOS_ROUTER_BLACKHOLE / LLMT_CHAOS_SEED (ints),
    LLMT_CHAOS_CKPT_CORRUPT ({flip,truncate,delete}[:step])."""
    update: dict = {}
    for field, env_name, cast in (
        ("data_error_steps", "LLMT_CHAOS_DATA_ERROR_STEPS", _int_tuple),
        ("checkpoint_error_steps", "LLMT_CHAOS_CHECKPOINT_ERROR_STEPS", _int_tuple),
        ("data_error_prob", "LLMT_CHAOS_DATA_ERROR_PROB", float),
        ("checkpoint_error_prob", "LLMT_CHAOS_CHECKPOINT_ERROR_PROB", float),
        ("sigterm_step", "LLMT_CHAOS_SIGTERM_STEP", int),
        ("sigkill_step", "LLMT_CHAOS_SIGKILL_STEP", int),
        ("nan_step", "LLMT_CHAOS_NAN_STEP", int),
        ("spike_step", "LLMT_CHAOS_SPIKE_STEP", int),
        ("spike_scale", "LLMT_CHAOS_SPIKE_SCALE", float),
        ("serve_stall_step", "LLMT_CHAOS_SERVE_STALL_STEP", int),
        ("serve_sigterm_step", "LLMT_CHAOS_SERVE_SIGTERM_STEP", int),
        ("serve_malformed_flood", "LLMT_CHAOS_SERVE_MALFORMED_FLOOD", int),
        ("router_kill_replica_at", "LLMT_CHAOS_ROUTER_KILL_REPLICA", int),
        ("router_blackhole_at", "LLMT_CHAOS_ROUTER_BLACKHOLE", int),
        ("ckpt_corrupt", "LLMT_CHAOS_CKPT_CORRUPT", str),
        ("ckpt_kill_in_swap", "LLMT_CHAOS_CKPT_KILL_IN_SWAP", int),
        ("slow_step_s", "LLMT_CHAOS_SLOW_STEP_S", float),
        ("slow_step_from", "LLMT_CHAOS_SLOW_STEP_FROM", int),
        ("seed", "LLMT_CHAOS_SEED", int),
    ):
        raw = os.environ.get(env_name)
        if raw is not None and raw != "":
            update[field] = cast(raw)
    base = base or ChaosConfig()
    return dataclasses.replace(base, **update) if update else base


def _int_tuple(raw: str) -> tuple[int, ...]:
    return tuple(int(part) for part in raw.split(",") if part.strip())


class Chaos:
    """Live harness: tracks which deterministic triggers already fired (each
    fires exactly once, so a retried operation succeeds on its second
    attempt)."""

    def __init__(self, config: ChaosConfig, registry=None):
        self.config = config
        self._rng = random.Random(config.seed)
        self._fired: set[tuple] = set()  # guarded by: _lock
        self._lock = threading.Lock()
        self._registry = registry

    def _count(self) -> None:
        registry = self._registry
        if registry is None:
            from llm_training_tpu_torch.telemetry.registry import get_registry

            registry = get_registry()
        registry.counter("resilience/chaos_injections").inc()

    def maybe_raise(self, site: str, step: int | None = None) -> None:
        """Raise ChaosError if a trigger for `site` fires at `step`."""
        if site not in SITES:
            raise ValueError(f"unknown chaos site {site!r}; expected one of {SITES}")
        kind = site.split("_")[0]
        steps = getattr(self.config, f"{kind}_error_steps")
        prob = getattr(self.config, f"{kind}_error_prob")
        with self._lock:
            deterministic = step is not None and step in steps and (site, step) not in self._fired
            if deterministic:
                self._fired.add((site, step))
            fire = deterministic or (prob > 0 and self._rng.random() < prob)
        if fire:
            self._count()
            logger.warning("chaos: injecting %s failure at step %s", site, step)
            raise ChaosError(f"chaos: injected {site} failure at step {step}")

    def maybe_sigterm(self, step: int) -> bool:
        """Deliver SIGTERM to this process when `step` hits the trigger
        (once). Returns True when the signal was sent."""
        if self.config.sigterm_step is None:
            return False
        with self._lock:
            if step != self.config.sigterm_step or ("sigterm", step) in self._fired:
                return False
            self._fired.add(("sigterm", step))
        self._count()
        logger.warning("chaos: delivering SIGTERM to self at step %d", step)
        os.kill(os.getpid(), signal.SIGTERM)
        return True

    def maybe_sigkill(self, step: int, fresh_start: bool) -> None:
        """SIGKILL this process at the trigger step, but only in a run that
        started from step 0 (`fresh_start`): SIGKILL leaves no chance to
        record the shot, so a supervisor's relaunch (which resumes past a
        checkpoint) must survive re-crossing the trigger step."""
        if self.config.sigkill_step is None or not fresh_start:
            return
        if step != self.config.sigkill_step:
            return
        self._count()
        logger.warning("chaos: delivering SIGKILL to self at step %d", step)
        os.kill(os.getpid(), signal.SIGKILL)

    def _ckpt_corrupt_parsed(self) -> tuple[str, int | None] | None:
        """(mode, target_step|None) from `ckpt_corrupt`, or None."""
        raw = self.config.ckpt_corrupt
        if not raw:
            return None
        mode, _, rest = raw.partition(":")
        return mode, (int(rest) if rest else None)

    def maybe_corrupt_checkpoint(self, root, step: int,
                                 at_final_barrier: bool = False) -> str | None:
        """Damage one payload file of the just-committed checkpoint `step`
        (once). The targeted form (`mode:step`) fires when that step's
        manifest lands; the untargeted form fires on the newest committed
        step at the final wait() barrier (`at_final_barrier`), after the
        mirror drained. Returns the damaged file's relative path."""
        parsed = self._ckpt_corrupt_parsed()
        if parsed is None:
            return None
        mode, target = parsed
        if target is not None:
            if step != target:
                return None
        elif not at_final_barrier:
            return None
        with self._lock:
            if ("ckpt_corrupt",) in self._fired:
                return None
            self._fired.add(("ckpt_corrupt",))
        from llm_training_tpu_torch.resilience.durability import corrupt_step

        victim = corrupt_step(root, step, mode)
        self._count()
        logger.warning("chaos: %s-corrupted checkpoint step %d payload file %s in %s",
                       mode, step, victim, root)
        return victim

    def maybe_ckpt_kill_in_swap(self, step: int) -> None:
        """SIGKILL this process inside a forced save's swap (the committed
        step moved aside, its replacement not yet in place) at the trigger
        step: the staged `.stale/` copy is then the step's only durable
        copy and a relaunch must promote it. Meant for single-shot
        processes: a relaunch that re-crosses the trigger with the variable
        still set dies again."""
        if self.config.ckpt_kill_in_swap is None or step != self.config.ckpt_kill_in_swap:
            return
        self._count()
        logger.warning("chaos: delivering SIGKILL inside force-save swap at step %d", step)
        os.kill(os.getpid(), signal.SIGKILL)

    # ------------------------------------------------------- serving tier

    def _serve_first_attempt(self) -> bool:
        """Serve faults fire only on the first supervisor attempt: the
        relaunch that replays the journal must survive re-crossing the
        trigger step."""
        from llm_training_tpu_torch.resilience.elastic import segment_attempt

        return segment_attempt() <= 1

    def maybe_serve_stall(self, step: int, sleep=None) -> bool:
        """Wedge the serving engine at the trigger step (once, first
        attempt only): sleep far past any watchdog window, so the hang
        watchdog's dump + SIGABRT ends the process, not this sleep. Returns
        True when the stall fired (tests inject a no-op `sleep`)."""
        if self.config.serve_stall_step is None or not self._serve_first_attempt():
            return False
        with self._lock:
            if step != self.config.serve_stall_step or ("serve_stall", step) in self._fired:
                return False
            self._fired.add(("serve_stall", step))
        self._count()
        logger.warning("chaos: wedging serve engine step %d", step)
        (sleep or time.sleep)(3600.0)
        return True

    def maybe_serve_sigterm_mid_stream(self, step: int) -> bool:
        """Deliver SIGTERM to this process at the trigger engine step (once,
        first attempt only): the serve CLI's GracefulShutdown turns it into
        drain -> journal -> exit 75."""
        if self.config.serve_sigterm_step is None or not self._serve_first_attempt():
            return False
        with self._lock:
            if step != self.config.serve_sigterm_step or ("serve_sigterm", step) in self._fired:
                return False
            self._fired.add(("serve_sigterm", step))
        self._count()
        logger.warning("chaos: delivering SIGTERM to serve process at engine step %d", step)
        os.kill(os.getpid(), signal.SIGTERM)
        return True

    def serve_malformed_lines(self) -> list[str]:
        """The malformed-flood payload for the serve CLI's intake (first
        attempt only): broken lines the error boundary must answer with
        {"type": "error"} chunks while every well-formed request still
        completes."""
        n = self.config.serve_malformed_flood
        if n <= 0 or not self._serve_first_attempt():
            return []
        self._count()
        shapes = (
            "{not json at all",
            '{"id": "flood", "prompt": "not-a-token-list"}',
            '{"prompt": [1, 2, 3]}',  # no id
            '{"id": "flood", "prompt": [1], "max_new_tokens": "junk"}',
        )
        return [shapes[i % len(shapes)] for i in range(n)]

    # ------------------------------------------------------- router tier

    def maybe_router_kill_replica(self, n_tokens: int) -> bool:
        """Fire once when the router's forwarded-token count reaches the
        trigger: the router (not this harness) SIGKILLs the replica that
        produced the token, then folds its journal and replays every leg in
        flight with exactly-once terminals. No first-attempt gate: the
        router is unsupervised and the trigger consumes itself."""
        trigger = self.config.router_kill_replica_at
        if trigger is None or n_tokens < trigger:
            return False
        with self._lock:
            if ("router_kill", trigger) in self._fired:
                return False
            self._fired.add(("router_kill", trigger))
        self._count()
        logger.warning("chaos: router kill-replica trigger at forwarded token %d", n_tokens)
        return True

    def maybe_router_blackhole(self, n_assign: int) -> bool:
        """Fire once at the Nth request->replica assignment: the router
        accepts it but never submits the leg, so only a hedge (or a
        failover) can produce the terminal."""
        trigger = self.config.router_blackhole_at
        if trigger is None or n_assign != trigger:
            return False
        with self._lock:
            if ("router_blackhole", trigger) in self._fired:
                return False
            self._fired.add(("router_blackhole", trigger))
        self._count()
        logger.warning("chaos: blackholing router assignment %d", n_assign)
        return True

    def maybe_slow_step(self, step: int, sleep=None) -> bool:
        """Inject `slow_step_s` of dead time at this optimizer-step boundary
        (every step >= `slow_step_from`; counted once, as one regime).
        Returns True when the sleep fired."""
        if self.config.slow_step_s <= 0 or step < self.config.slow_step_from:
            return False
        with self._lock:
            first = ("slow_step",) not in self._fired
            if first:
                self._fired.add(("slow_step",))
        if first:
            self._count()
            logger.warning("chaos: slowing every step from %d on by %.2fs", step,
                           self.config.slow_step_s)
        (sleep or time.sleep)(self.config.slow_step_s)
        return True

    def maybe_poison_metrics(self, step: int, metrics: dict, fresh_start: bool = True) -> list[str]:
        """At the first log step >= each armed trigger, poison the host
        metrics in place: `nan_step` makes loss/grad_norm non-finite,
        `spike_step` multiplies them by `spike_scale`. Each fires once per
        process, and only in a run that started from step 0 (a relaunch
        resuming past a checkpoint must not re-fire its predecessor's
        trigger). Returns the kinds fired."""
        if not fresh_start:
            return []
        fired: list[str] = []
        for kind, trigger in (("nan", self.config.nan_step), ("spike", self.config.spike_step)):
            if trigger is None or step < trigger:
                continue
            with self._lock:
                if (kind, trigger) in self._fired:
                    continue
                self._fired.add((kind, trigger))
            self._count()
            logger.warning("chaos: injecting %s into loss/grad_norm at step %d (trigger %d)",
                           kind, step, trigger)
            for name in ("loss", "grad_norm"):
                if name not in metrics:
                    continue
                if kind == "nan":
                    metrics[name] = float("nan")
                else:
                    metrics[name] = float(metrics[name]) * self.config.spike_scale
            fired.append(kind)
        return fired


# ---------------------------------------------------------------- current
_active: Chaos | None = None  # guarded by: _active_lock
_active_lock = threading.Lock()


def install_chaos(config: ChaosConfig | None, registry=None) -> Chaos | None:
    """Install the process-global harness (None or an all-default config
    uninstalls). Returns the installed Chaos, or None."""
    global _active
    with _active_lock:
        if config is None or not config.any_active():
            _active = None
        else:
            _active = Chaos(config, registry=registry)
        return _active


def uninstall_chaos() -> None:
    install_chaos(None)


def get_chaos() -> Chaos | None:
    return _active


def chaos_point(site: str, step: int | None = None) -> None:
    """Call-site hook: no-op unless a harness is installed."""
    chaos = _active
    if chaos is not None:
        chaos.maybe_raise(site, step)
