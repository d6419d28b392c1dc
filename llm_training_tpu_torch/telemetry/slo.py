"""Declarative SLOs with multi-window burn-rate alerting.

Counterpart of `llm_training_tpu/telemetry/slo.py` (standard library
only). It evaluates a declarative SLO config over sliding windows:

- **serve**: `ttft_p99_ms`, `tpot_p99_ms` (latency SLOs: at most 1% of
  requests may exceed the target), `error_rate` (at most this fraction of
  requests may end without a full completion);
- **train**: `step_time_p99_s` (a latency SLO over optimizer-step wall
  intervals) and `goodput_pct_min` (a level floor), fed by `fit`.

A breach fires when the violation fraction burns the error budget at
>= `fast_burn`x over the FAST window AND >= `slow_burn`x over the SLOW
window. Every breach bumps `slo/breaches_total` and `slo/<key>/breaches`,
emits a trace instant (`cat="slo"`), flight-dumps the trace ring to
`trace-flight-slo-*.jsonl` in the run dir (capped per target), and asks
the profile trigger for a capture under the same tag.

Config comes from an explicit dict (`{"serve": {...}, "train": {...}}`)
overlaid by `LLMT_SLO_*` env vars. No target armed -> `build_slo_monitor`
returns None and every caller stays zero-cost.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from collections import deque
from dataclasses import dataclass

logger = logging.getLogger(__name__)

# ring dumps per breaching target: the post-mortem value is in the FIRST
# few breach windows; a day-long violation must not litter the run dir
MAX_FLIGHT_DUMPS_PER_TARGET = 3

# env overlay (docs/observability.md#slo): targets
_TARGET_ENVS = (
    ("serve", "ttft_p99_ms", "LLMT_SLO_TTFT_P99_MS"),
    ("serve", "tpot_p99_ms", "LLMT_SLO_TPOT_P99_MS"),
    ("serve", "error_rate", "LLMT_SLO_ERROR_RATE"),
    ("train", "step_time_p99_s", "LLMT_SLO_STEP_TIME_P99_S"),
    ("train", "goodput_pct_min", "LLMT_SLO_GOODPUT_PCT_MIN"),
)


@dataclass(frozen=True)
class SLOSpec:
    """One target. `kind` fixes the violation predicate and the budget:
    latency -> value > target violates, budget 1%; error_rate -> a failed
    event violates, budget = target itself; floor -> value < target
    violates, budget 1%."""

    key: str  # e.g. "serve/ttft_p99_ms" — the metric family it guards
    target: float
    kind: str  # "latency" | "error_rate" | "floor"

    @property
    def budget(self) -> float:
        if self.kind == "error_rate":
            return max(1e-9, self.target)
        return 0.01

    @property
    def domain(self) -> str:
        """Which observation stream feeds this spec: `serve/*` targets
        consume request terminals, `train/*` targets consume step/goodput
        observations. A spec never sees the other stream's events — an
        error-rate SLO armed fleet-wide must not count a training fit's
        healthy steps as healthy requests (that would dilute the real
        request-error fraction and mask a breach)."""
        return self.key.split("/", 1)[0]

    def violated(self, value: float | None, ok: bool = True) -> bool | None:
        """None = this observation carries nothing for this spec."""
        if self.kind == "error_rate":
            return not ok
        if value is None:
            return None
        if self.kind == "floor":
            return value < self.target
        return value > self.target


class _Window:
    """Sliding event window with running (total, violated) counts: append
    and horizon-eviction are amortized O(1), so the per-request serve
    emit path never rescans a 300s window per observation."""

    __slots__ = ("horizon_s", "events", "total", "violated")

    def __init__(self, horizon_s: float):
        self.horizon_s = horizon_s
        self.events: deque = deque()  # (t, violated)
        self.total = 0
        self.violated = 0

    def add(self, now: float, bad: bool) -> None:
        self.events.append((now, bad))
        self.total += 1
        self.violated += bad
        while self.events and now - self.events[0][0] > self.horizon_s:
            _, old_bad = self.events.popleft()
            self.total -= 1
            self.violated -= old_bad

    def burn(self, budget: float) -> float:
        if self.total == 0:
            return 0.0
        return (self.violated / self.total) / budget


def _env_float(name: str) -> float | None:
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return None
    try:
        return float(raw)
    except ValueError:
        logger.warning("ignoring malformed %s=%r (want a float)", name, raw)
        return None


def slo_config_from_env(base: dict | None = None) -> dict:
    """Overlay `LLMT_SLO_*` targets on `base` ({"serve": {...}, "train":
    {...}}); returns the merged config (possibly empty)."""
    config: dict[str, dict] = {
        "serve": dict((base or {}).get("serve") or {}),
        "train": dict((base or {}).get("train") or {}),
    }
    for section, field, env in _TARGET_ENVS:
        value = _env_float(env)
        if value is not None:
            config[section][field] = value
    return {k: v for k, v in config.items() if v}


def specs_from_config(config: dict) -> list[SLOSpec]:
    specs: list[SLOSpec] = []
    serve = config.get("serve") or {}
    train = config.get("train") or {}
    if serve.get("ttft_p99_ms") is not None:
        specs.append(SLOSpec("serve/ttft_p99_ms", float(serve["ttft_p99_ms"]), "latency"))
    if serve.get("tpot_p99_ms") is not None:
        specs.append(SLOSpec("serve/tpot_p99_ms", float(serve["tpot_p99_ms"]), "latency"))
    if serve.get("error_rate") is not None:
        specs.append(SLOSpec("serve/error_rate", float(serve["error_rate"]), "error_rate"))
    if train.get("step_time_p99_s") is not None:
        specs.append(SLOSpec("train/step_time_p99_s", float(train["step_time_p99_s"]), "latency"))
    if train.get("goodput_pct_min") is not None:
        specs.append(SLOSpec("train/goodput_pct_min", float(train["goodput_pct_min"]), "floor"))
    return specs


class SLOMonitor:
    """Sliding-window burn-rate evaluator over the armed `SLOSpec`s.

    Observations arrive from the owning loop (serve: per done event;
    train: per optimizer step + per log step) and the exporter's scrape
    thread reads `last_alert()`; all state is guarded by one lock. Breach
    side effects (registry counters, trace instant, flight dump) are
    emitted AFTER the lock is released, so the monitor adds no lock-order
    edges into the registry/trace leaves.
    """

    def __init__(
        self,
        specs: list[SLOSpec],
        registry=None,
        run_dir=None,
        clock=time.monotonic,
        fast_window_s: float | None = None,
        slow_window_s: float | None = None,
        fast_burn: float | None = None,
        slow_burn: float | None = None,
        min_events: int | None = None,
        cooldown_s: float | None = None,
    ):
        from pathlib import Path

        self.specs = list(specs)
        self._registry = registry
        self.run_dir = Path(run_dir) if run_dir else None
        self._clock = clock

        # env overlay for the evaluation knobs (explicit args win). An
        # explicit 0 is a real setting (cooldown 0 = count every breach,
        # burn 0 = page on any violation), so None-checks, never `or`
        def knob(explicit, env, default):
            if explicit is not None:
                return explicit
            value = _env_float(env)
            return value if value is not None else default

        self.fast_window_s = knob(fast_window_s, "LLMT_SLO_WINDOW_FAST_S", 60.0)
        self.slow_window_s = knob(slow_window_s, "LLMT_SLO_WINDOW_SLOW_S", 300.0)
        self.fast_burn = knob(fast_burn, "LLMT_SLO_BURN_FAST", 14.4)
        self.slow_burn = knob(slow_burn, "LLMT_SLO_BURN_SLOW", 6.0)
        self.min_events = max(
            1, int(knob(min_events, "LLMT_SLO_MIN_SAMPLES", 4))
        )
        self.cooldown_s = knob(cooldown_s, "LLMT_SLO_COOLDOWN_S", 30.0)
        self._lock = threading.Lock()
        # per-spec fast/slow windows (running-count _Window pairs) —
        # guarded by: _lock
        self._windows: dict[str, tuple[_Window, _Window]] = {
            s.key: (_Window(self.fast_window_s), _Window(self.slow_window_s))
            for s in self.specs
        }
        self._worst: dict[str, float] = {}  # guarded by: _lock
        self._breaches: dict[str, int] = {s.key: 0 for s in self.specs}  # guarded by: _lock
        self._last_alert: dict | None = None  # guarded by: _lock
        self._last_fired: dict[str, float] = {}  # guarded by: _lock
        self._requests_seen = 0  # guarded by: _lock
        self._publish_targets()

    # --------------------------------------------------------- publication

    def _publish_targets(self) -> None:
        if self._registry is None:
            return
        for spec in self.specs:
            self._registry.gauge(f"slo/{spec.key}/target").set(spec.target)

    def _gauge(self, name: str, value: float) -> None:
        if self._registry is not None:
            self._registry.gauge(name).set(value)

    # -------------------------------------------------------- observations

    def observe_request(
        self,
        ttft_ms: float | None = None,
        tpot_ms: float | None = None,
        ok: bool = True,
    ) -> None:
        """One serve terminal: latency numbers when the engine reported
        them, `ok` = a full completion (eos/max_tokens)."""
        values = {
            "serve/ttft_p99_ms": ttft_ms,
            "serve/tpot_p99_ms": tpot_ms,
        }
        with self._lock:
            self._requests_seen += 1
            n = self._requests_seen
        self._observe(values, domain="serve", ok=ok, request_n=n)

    def observe_step(self, step_time_s: float, step: int | None = None) -> None:
        """One optimizer-step wall interval (host-observed cadence)."""
        self._observe(
            {"train/step_time_p99_s": step_time_s}, domain="train", step=step
        )

    def observe_goodput(self, goodput_pct: float, step: int | None = None) -> None:
        self._observe(
            {"train/goodput_pct_min": goodput_pct}, domain="train", step=step
        )

    def _observe(
        self,
        values: dict[str, float | None],
        domain: str,
        ok: bool = True,
        step: int | None = None,
        request_n: int | None = None,
    ) -> None:
        fired: list[dict] = []
        gauges: dict[str, float] = {}
        now = self._clock()
        with self._lock:
            for spec in self.specs:
                if spec.domain != domain:
                    continue  # a spec never eats the other stream's events
                violated = spec.violated(values.get(spec.key), ok=ok)
                if violated is None:
                    continue
                value = values.get(spec.key)
                if value is not None:
                    worst = self._worst.get(spec.key)
                    if worst is None:
                        self._worst[spec.key] = value
                    elif spec.kind == "floor":
                        self._worst[spec.key] = min(worst, value)
                    else:
                        self._worst[spec.key] = max(worst, value)
                fast, slow = self._windows[spec.key]
                fast.add(now, bool(violated))
                slow.add(now, bool(violated))
                alert = self._evaluate_locked(spec, now, step, request_n, gauges)
                if alert is not None:
                    fired.append(alert)
        # registry publication happens AFTER _lock is released: the monitor
        # introduces no slo->registry lock nesting at all
        for name, value in gauges.items():
            self._gauge(name, value)
        for alert in fired:
            self._emit(alert)

    # ---------------------------------------------------------- evaluation

    def _evaluate_locked(self, spec, now, step, request_n, gauges) -> dict | None:  # guarded by: _lock
        fast, slow = self._windows[spec.key]
        burn_fast, n_fast = fast.burn(spec.budget), fast.total
        burn_slow, n_slow = slow.burn(spec.budget), slow.total
        # gauge values are computed here but PUBLISHED by the caller after
        # _lock is released (no slo->registry lock nesting)
        gauges[f"slo/{spec.key}/burn_fast"] = burn_fast
        gauges[f"slo/{spec.key}/burn_slow"] = burn_slow
        if spec.key in self._worst:
            gauges[f"slo/{spec.key}/worst"] = self._worst[spec.key]
        # min_events gates the SLOW window only — it is the straggler
        # guard. The fast window just needs recent evidence (>= 1 event):
        # requiring a full sample count there would leave sparse streams
        # (goodput on log steps, multi-second optimizer steps) permanently
        # inert — burn gauges showing the violation but an alert that can
        # never arm. Size the windows to cover >= min_events observation
        # intervals (docs/observability.md#slo).
        if n_fast < 1 or n_slow < self.min_events:
            return None
        if burn_fast < self.fast_burn or burn_slow < self.slow_burn:
            return None
        last = self._last_fired.get(spec.key)
        if last is not None and now - last < self.cooldown_s:
            return None
        self._last_fired[spec.key] = now
        self._breaches[spec.key] += 1
        alert = {
            "key": spec.key,
            "target": spec.target,
            "worst": self._worst.get(spec.key),
            "burn_fast": burn_fast,
            "burn_slow": burn_slow,
            "n": self._breaches[spec.key],
            "step": step,
            "request_n": request_n,
        }
        self._last_alert = alert
        return alert

    def _emit(self, alert: dict) -> None:
        """Breach side effects, OUTSIDE the monitor lock: counters, trace
        instant, and the flight dump that makes the breach window
        post-mortemable."""
        key = alert["key"]
        if self._registry is not None:
            self._registry.counter("slo/breaches_total").inc()
            self._registry.counter(f"slo/{key}/breaches").inc()
            if alert.get("step") is not None:
                self._registry.gauge("slo/last_breach_step").set(float(alert["step"]))
            if alert.get("request_n") is not None:
                self._registry.gauge("slo/last_breach_request_n").set(
                    float(alert["request_n"])
                )
        logger.warning(
            "SLO breach: %s target %s worst %s — burn %.1fx (fast) / "
            "%.1fx (slow)", key, alert["target"], alert.get("worst"),
            alert["burn_fast"], alert["burn_slow"],
        )
        # lazy import mirrors watchdog.dump: the monitor stays importable
        # without the tracer, and flight_dump itself never raises
        from llm_training_tpu_torch.telemetry.trace import get_tracer

        tracer = get_tracer()
        tracer.instant(
            "slo", "breach", target=key, slo_target=alert["target"],
            worst=alert.get("worst"), burn_fast=round(alert["burn_fast"], 2),
            burn_slow=round(alert["burn_slow"], 2),
            **({"step": alert["step"]} if alert.get("step") is not None else {}),
            **({"request_n": alert["request_n"]}
               if alert.get("request_n") is not None else {}),
        )
        # flight dumps are capped per target (unlike counters/instants,
        # which always record): a persistently breaching run re-alerts
        # every cooldown, and after the first few ring dumps the rest are
        # near-identical disk churn — the HangWatchdog's one-shot latch,
        # relaxed to N shots
        if self.run_dir is not None and alert["n"] <= MAX_FLIGHT_DUMPS_PER_TARGET:
            tag = "slo-" + key.replace("/", "-") + f"-{alert['n']}"
            tracer.flight_dump(self.run_dir, tag)
            # arm a device-profile capture with the SAME tag, so the host
            # ring dump and the device trace of one breach correlate by
            # name (docs/observability.md#profiling). Request-side only —
            # the owning loop performs the capture, and
            # the trigger's own budget/cooldown (not ours) decides
            from llm_training_tpu_torch.telemetry.profiling import (
                get_profile_trigger,
            )

            trigger = get_profile_trigger()
            if trigger is not None:
                trigger.request(tag, source="slo")

    # ------------------------------------------------------------- queries

    def last_alert(self) -> dict | None:
        with self._lock:
            return dict(self._last_alert) if self._last_alert else None

    def breach_count(self) -> int:
        with self._lock:
            return sum(self._breaches.values())


def build_slo_monitor(
    base_config: dict | None = None,
    registry=None,
    run_dir=None,
    **kwargs,
) -> SLOMonitor | None:
    """The one-call entry the trainer / serve CLI use: env-overlaid config
    -> monitor, or None when no target is armed (zero cost)."""
    config = slo_config_from_env(base_config)
    specs = specs_from_config(config)
    if not specs:
        return None
    return SLOMonitor(specs, registry=registry, run_dir=run_dir, **kwargs)
