"""Pull-based live-telemetry exporter: `/metrics`, `/statusz`, `/healthz`,
`/profilez`.

Counterpart of `llm_training_tpu/telemetry/exporter.py` (standard library
only). A background daemon thread runs a small HTTP server (enabled by
`LLMT_METRICS_PORT`, 0 = off) exposing

- **`/metrics`**: Prometheus text format 0.0.4 rendered from ONE
  consistent `TelemetryRegistry` snapshot (`snapshot_with_kinds()`),
  merged with the goodput ledger summary and the owner's live gauges (the
  serve CLI's queue depth and rolling TTFT percentiles);
- **`/statusz`**: a one-page text status: health, watchdog beat age, the
  owner's status lines and the SLO monitor's last alert;
- **`/healthz`**: liveness keyed off the `HangWatchdog` heartbeat: 503 once
  the beat is older than `stale_after_s` (default HALF the watchdog
  timeout), so a scraper sees a wedged loop before the watchdog aborts;
- **`/profilez`**: arms a capture through the profile trigger's request
  surface; the owning loop performs it.

Scrape handler threads never touch the card: everything rendered here is
host-side state. A port collision degrades to a logged warning and a
disabled exporter, never a crash. With `LLMT_FLEET_DIR` set, an armed
exporter announces itself with a discovery card in that directory
(`telemetry/fleet.py`), removed on a clean stop.
"""

from __future__ import annotations

import json
import logging
import os
import re
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

logger = logging.getLogger(__name__)

METRICS_PORT_ENV = "LLMT_METRICS_PORT"

# Prometheus metric-name charset; everything else becomes '_'
_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")
_PROM_PREFIX = "llmt_"


def find_free_port(host: str = "127.0.0.1") -> int:
    """Bind-then-release an OS-assigned ephemeral port — the shared probe
    for callers that must know the port BEFORE the exporter owner starts
    (a smoke run that scrapes its child). Inherently racy
    against other port grabbers, but the loser degrades to the exporter's
    logged-warning path, never a crash."""
    import socket

    probe = socket.socket()
    probe.bind((host, 0))
    port = probe.getsockname()[1]
    probe.close()
    return port


def resolve_metrics_port() -> int:
    """The exporter port from `LLMT_METRICS_PORT` (0/unset/malformed =
    disabled; malformed values warn once here rather than crash a fit)."""
    raw = os.environ.get(METRICS_PORT_ENV)
    if not raw:
        return 0
    try:
        port = int(raw)
    except ValueError:
        logger.warning(
            "ignoring malformed %s=%r (want an int port, 0=off)",
            METRICS_PORT_ENV, raw,
        )
        return 0
    return max(0, port)


def prometheus_name(key: str) -> str:
    """`goodput/total_s` -> `llmt_goodput_total_s` (Prometheus charset)."""
    return _PROM_PREFIX + _NAME_RE.sub("_", key)


def _prom_value(value: float) -> str:
    value = float(value)
    if value != value:  # NaN
        return "NaN"
    if value == float("inf"):
        return "+Inf"
    if value == float("-inf"):
        return "-Inf"
    return repr(value)


# strict label block: `{key="value",...}` — no spaces, no escapes, no
# trailing comma; exactly what the fleet federation endpoint emits
_LABELS_RE = re.compile(
    r"\{[a-zA-Z_][a-zA-Z0-9_]*=\"[^\"\\]*\""
    r"(?:,[a-zA-Z_][a-zA-Z0-9_]*=\"[^\"\\]*\")*\}"
)


def parse_prometheus_text(text: str, labels: bool = False) -> dict[str, float]:
    """Strict inverse of `render_prometheus`: {key_name: value}. Raises
    ValueError on ANY malformed line, so scrape validators (a smoke run's
    scrapes, the unit tests) all fail loudly —
    and identically — on format drift.

    Per-process exporters emit no labels, so the default rejects them.
    `labels=True` (the fleet aggregator's federation output) accepts a
    strict `name{key="value",...}` block and keys the result by the FULL
    labeled name — distinct replicas stay distinct samples."""
    metrics: dict[str, float] = {}
    for line in text.splitlines():
        if not line.strip():
            continue
        if line.startswith("#"):
            if not line.startswith(("# TYPE ", "# HELP ")):
                raise ValueError(f"bad comment line: {line!r}")
            continue
        parts = line.split()
        if len(parts) != 2:
            raise ValueError(f"bad sample line: {line!r}")
        name, raw = parts
        bare, brace, label_block = name.partition("{")
        if brace:
            if not labels or not _LABELS_RE.fullmatch(brace + label_block):
                raise ValueError(f"bad label block: {name!r}")
        if not re.fullmatch(r"[a-zA-Z_:][a-zA-Z0-9_:]*", bare):
            raise ValueError(f"bad metric name: {name!r}")
        try:
            metrics[name] = float(raw)
        except ValueError:
            raise ValueError(f"bad sample value: {line!r}") from None
    if not metrics:
        raise ValueError("scrape held no samples")
    return metrics


def parse_prometheus_kinds(text: str) -> dict[str, str]:
    """{metric_name: 'counter'|'gauge'} from the `# TYPE` lines — the
    fleet aggregator needs kinds to roll up correctly (counters sum,
    gauges spread min/mean/max). Same strictness posture: a malformed
    TYPE line raises."""
    kinds: dict[str, str] = {}
    for line in text.splitlines():
        if not line.startswith("# TYPE "):
            continue
        parts = line.split()
        if len(parts) != 4 or parts[3] not in ("counter", "gauge"):
            raise ValueError(f"bad TYPE line: {line!r}")
        kinds[parts[2]] = parts[3]
    return kinds


def render_prometheus(
    values: dict[str, float], kinds: dict[str, str] | None = None
) -> str:
    """Prometheus text exposition (format version 0.0.4) for a flat metric
    dict. `kinds` maps source keys to 'counter'/'gauge'; unknown keys
    render as gauges. Keys whose values are not numeric are skipped — one
    bad gauge must not sink the whole scrape."""
    kinds = kinds or {}
    lines: list[str] = []
    seen: set[str] = set()
    for key in sorted(values):
        try:
            rendered = _prom_value(values[key])
        except (TypeError, ValueError):
            continue
        name = prometheus_name(key)
        if name in seen:  # sanitization collision: first key wins
            continue
        seen.add(name)
        kind = kinds.get(key, "gauge")
        if kind not in ("counter", "gauge"):
            kind = "gauge"
        lines.append(f"# TYPE {name} {kind}")
        lines.append(f"{name} {rendered}")
    lines.append("")
    return "\n".join(lines)


class MetricsExporter:
    """Background-thread HTTP exporter over the run's live telemetry.

    Sources are all optional and polled per request (never cached — a
    scrape is a *now* question): `registry` (snapshot_with_kinds),
    `ledger` (goodput summary + open phase), `watchdog` (beat age ->
    /healthz), `slo` (an SLOMonitor: last alert for /statusz), `extra_fn`
    (live gauges merged into /metrics, e.g. serve queue depth), and
    `status_fn` (extra key:value lines for /statusz, e.g. current step).
    """

    def __init__(
        self,
        port: int,
        registry=None,
        ledger=None,
        watchdog=None,
        slo=None,
        profile=None,
        extra_fn=None,
        status_fn=None,
        stale_after_s: float | None = None,
        host: str = "",
        role: str = "train",
        clock=time.monotonic,
    ):
        self.requested_port = int(port)
        self.registry = registry
        self.ledger = ledger
        self.watchdog = watchdog
        self.slo = slo
        # a ProfileTrigger's REQUEST surface: /profilez arms a
        # capture window for the owning loop; the handler thread itself
        # never touches the device (docs/observability.md#profiling)
        self.profile = profile
        self.extra_fn = extra_fn
        self.status_fn = status_fn
        self.host = host
        # fleet discovery role (train|serve|bench|router) stamped on the
        # replica card when LLMT_FLEET_DIR is armed
        self.role = role
        self._clock = clock
        # /healthz turns red at HALF the watchdog window by default: early
        # enough that a scraper sees the wedge before the SIGABRT
        if stale_after_s is None and watchdog is not None:
            stale_after_s = float(watchdog.timeout_s) / 2.0
        self.stale_after_s = stale_after_s
        self._started_at = clock()
        self._lock = threading.Lock()
        self._server: ThreadingHTTPServer | None = None  # guarded by: _lock
        self._thread: threading.Thread | None = None  # guarded by: _lock
        self.port: int | None = None  # bound port; guarded by: _lock
        self._scrapes = 0  # guarded by: _lock
        self._errors = 0  # guarded by: _lock
        self._card_path = None  # fleet discovery card; guarded by: _lock

    # ----------------------------------------------------------- lifecycle

    def start(self) -> bool:
        """Bind and serve; False (with a logged warning) when the port is
        taken or the bind fails any other way — the run must keep going
        without its exporter rather than die for observability."""
        exporter = self
        try:
            server = ThreadingHTTPServer(
                (self.host, self.requested_port), _Handler
            )
        except OSError as e:
            logger.warning(
                "metrics exporter disabled: cannot bind port %d (%s) — "
                "the run continues unscrapeable", self.requested_port, e,
            )
            return False
        server.daemon_threads = True
        server.exporter = exporter  # type: ignore[attr-defined]
        thread = threading.Thread(
            target=server.serve_forever, name="metrics-exporter", daemon=True,
            kwargs={"poll_interval": 0.2},
        )
        with self._lock:
            self._server = server
            self._thread = thread
            self.port = server.server_address[1]
        thread.start()
        logger.info(
            "metrics exporter listening on port %d "
            "(/metrics /statusz /healthz)", self.port,
        )
        # fleet discovery: an armed exporter announces itself by card so an
        # aggregator finds the fleet without static config (lazy import:
        # fleet imports this module at module level)
        from llm_training_tpu_torch.telemetry.fleet import (
            resolve_fleet_dir,
            write_replica_card,
        )

        fleet_dir = resolve_fleet_dir()
        card = None
        if fleet_dir is not None:
            card = write_replica_card(fleet_dir, port=self.port, role=self.role)
        with self._lock:
            self._card_path = card
        return True

    def stop(self) -> None:
        # swap under the lock, shutdown/join outside it (the serve thread
        # never takes _lock, but symmetry with HangWatchdog.stop keeps the
        # pattern auditable)
        with self._lock:
            server, self._server = self._server, None
            thread, self._thread = self._thread, None
            card, self._card_path = self._card_path, None
        if card is not None:
            # a clean stop removes the discovery card; a SIGKILL cannot, and
            # the aggregator's stale-pid check covers that hole
            from llm_training_tpu_torch.telemetry.fleet import remove_replica_card

            remove_replica_card(card)
        if server is not None:
            server.shutdown()
            server.server_close()
        if thread is not None:
            thread.join(timeout=5.0)

    # ------------------------------------------------------------- content

    def metrics_snapshot(self) -> tuple[dict[str, float], dict[str, str]]:
        """(values, kinds) for /metrics: one consistent registry snapshot,
        the goodput summary, and the owner's live extras. Each source does
        its own locking; the exporter holds nothing while composing."""
        values: dict[str, float] = {}
        kinds: dict[str, str] = {}
        if self.registry is not None:
            snap, snap_kinds = self.registry.snapshot_with_kinds()
            values.update(snap)
            kinds.update(snap_kinds)
        if self.ledger is not None:
            values.update(self.ledger.summary())
        if self.extra_fn is not None:
            try:
                values.update(self.extra_fn())
            except Exception:  # a live-gauge bug must not kill the scrape
                logger.exception("exporter extra_fn failed (gauges dropped)")
        values["exporter/uptime_s"] = self._clock() - self._started_at
        with self._lock:
            values["exporter/scrapes"] = float(self._scrapes)
            values["exporter/render_errors"] = float(self._errors)
        kinds["exporter/scrapes"] = "counter"
        kinds["exporter/render_errors"] = "counter"
        return values, kinds

    def render_metrics(self) -> str:
        with self._lock:
            self._scrapes += 1
        if self.registry is not None:
            # the fit's registry carries the scrape counters into
            # telemetry.jsonl, so `report` shows whether anyone scraped
            self.registry.counter("exporter/scrapes").inc()
        values, kinds = self.metrics_snapshot()
        return render_prometheus(values, kinds)

    def health(self) -> tuple[bool, dict]:
        """(healthy, detail) for /healthz. Unhealthy when the watchdog's
        primary beat is older than `stale_after_s` — i.e. the step loop is
        wedged but the watchdog has not yet aborted. With no watchdog the
        probe only asserts the process answers (which the reply proves)."""
        detail: dict = {"status": "ok"}
        if self.ledger is not None:
            detail["phase"] = self.ledger.current_phase
        watchdog = self.watchdog
        if watchdog is not None:
            age = watchdog.beat_age()
            detail["beat_age_s"] = round(age, 3) if age is not None else None
            detail["watchdog_timeout_s"] = watchdog.timeout_s
            if (
                self.stale_after_s is not None
                and age is not None
                and age > self.stale_after_s
            ):
                detail["status"] = "unhealthy"
                detail["reason"] = (
                    f"no {watchdog.primary_source} heartbeat for "
                    f"{age:.1f}s (> {self.stale_after_s:.1f}s; watchdog "
                    f"aborts at {watchdog.timeout_s:.1f}s)"
                )
                return False, detail
        else:
            detail["watchdog"] = "none"
        return True, detail

    def _durability_status(self) -> tuple[str | None, str | None]:
        """(health-line warning, detail line) from the registry's ckpt/*
        gauges + verify counters — a red mirror or a failed scrub must be
        visible on /statusz BEFORE a restore needs the copy. (None, None)
        when the run has no durability surface armed."""
        if self.registry is None:
            return None, None
        values, _ = self.registry.snapshot_with_kinds()
        watched = (
            "checkpoint/verify_failures", "ckpt/mirror_lag_steps",
            "ckpt/mirrored_steps", "ckpt/mirror_verify_rejects",
            "ckpt/scrub_failures", "ckpt/scrub_last_ok",
        )
        if not any(key in values for key in watched):
            return None, None
        verify_failures = int(values.get("checkpoint/verify_failures", 0))
        rejects = int(values.get("ckpt/mirror_verify_rejects", 0))
        lag = values.get("ckpt/mirror_lag_steps")
        scrub_failures = int(values.get("ckpt/scrub_failures", 0))
        scrub_last_ok = values.get("ckpt/scrub_last_ok")
        problems: list[str] = []
        if verify_failures:
            problems.append(f"{verify_failures} verify failure(s)")
        if rejects:
            problems.append(f"{rejects} mirror reject(s)")
        if lag:
            problems.append(f"mirror {int(lag)} step(s) behind")
        if scrub_failures or scrub_last_ok == 0.0:
            problems.append(
                f"scrub failing ({scrub_failures} failure(s), last step "
                f"{int(values.get('ckpt/scrub_last_step', -1))})"
            )
        scrub = (
            "n/a" if scrub_last_ok is None
            else ("ok" if scrub_last_ok else "FAILED")
        )
        line = (
            f"durability: verify failures {verify_failures}  mirror lag "
            f"{int(lag) if lag is not None else 'n/a'} step(s) "
            f"({int(values.get('ckpt/mirrored_steps', 0))} mirrored)  "
            f"scrub last {scrub}"
        )
        return ("; ".join(problems) or None), line

    def render_statusz(self) -> str:
        lines = ["llm-training-tpu statusz", ""]
        healthy, detail = self.health()
        durability_warn, durability_line = self._durability_status()
        health_line = f"health: {'ok' if healthy else 'UNHEALTHY'}"
        if durability_warn:
            health_line += f"  [durability: {durability_warn}]"
        lines.append(health_line)
        if detail.get("reason"):
            lines.append(f"  {detail['reason']}")
        if self.ledger is not None:
            summary = self.ledger.summary()
            lines.append(
                f"goodput phase: {self.ledger.current_phase or '<none>'}  "
                f"({summary.get('goodput/goodput_pct', 0.0):.1f}% of "
                f"{summary.get('goodput/total_s', 0.0):.1f}s wall)"
            )
        if detail.get("beat_age_s") is not None:
            lines.append(
                f"watchdog: beat {detail['beat_age_s']:.1f}s ago "
                f"(timeout {detail['watchdog_timeout_s']:.1f}s)"
            )
        if durability_line is not None:
            lines.append(durability_line)
        if self.status_fn is not None:
            try:
                for key, value in self.status_fn().items():
                    lines.append(f"{key}: {value}")
            except Exception:
                logger.exception("exporter status_fn failed")
                lines.append("status provider failed (see log)")
        slo = self.slo
        if slo is not None:
            alert = slo.last_alert()
            if alert is not None:
                lines.append(
                    f"last alert: {alert['key']} burn "
                    f"{alert['burn_fast']:.1f}x/{alert['burn_slow']:.1f}x "
                    f"(breach #{alert['n']})"
                )
            else:
                lines.append("slo: no breaches")
        with self._lock:
            scrapes = self._scrapes
        lines.append(f"scrapes: {scrapes}")
        lines.append("")
        return "\n".join(lines)

    def render_profilez(self, query: str = "") -> tuple[int, str]:
        """(status, json body) for /profilez: arm an on-demand device
        profile through the trigger's request surface. `?tag=`
        names the capture (sanitized into the artifact name); the default
        tag counts requests so repeated pokes stay distinguishable. A
        suppressed request (budget/cooldown/busy) answers 429 — the
        refusal IS the budget working, not a server error."""
        trigger = self.profile
        if trigger is None:
            return 404, json.dumps(
                {"error": "no profile trigger armed on this process"}
            ) + "\n"
        params = urllib.parse.parse_qs(query)
        tag = params.get("tag", [None])[0]
        if not tag:
            tag = f"profilez-{trigger.status()['requested'] + 1}"
        result = trigger.request(tag, source="profilez")
        body = {**result, "status": trigger.status()}
        return (200 if result["accepted"] else 429), json.dumps(body) + "\n"

    def _note_error(self) -> None:
        with self._lock:
            self._errors += 1
        if self.registry is not None:
            # like exporter/scrapes: the registry copy rides into
            # telemetry.jsonl, so `report` shows render failures even
            # though the failing surface itself couldn't
            self.registry.counter("exporter/render_errors").inc()


class _Handler(BaseHTTPRequestHandler):
    """Routes /metrics, /statusz, /healthz, /profilez; anything else is
    404. Runs on the server's per-request daemon threads — all content
    comes from MetricsExporter methods that never touch the card (/profilez
    only ARMS a capture; the owning loop performs it)."""

    server_version = "llmt-exporter/1"

    def _send(self, code: int, content_type: str, body: str) -> None:
        payload = body.encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)

    def do_GET(self) -> None:  # noqa: N802 — BaseHTTPRequestHandler API
        exporter: MetricsExporter = self.server.exporter  # type: ignore[attr-defined]
        path, _, query = self.path.partition("?")
        try:
            if path == "/metrics":
                self._send(
                    200, "text/plain; version=0.0.4; charset=utf-8",
                    exporter.render_metrics(),
                )
            elif path == "/healthz":
                healthy, detail = exporter.health()
                self._send(
                    200 if healthy else 503, "application/json",
                    json.dumps(detail) + "\n",
                )
            elif path == "/statusz":
                self._send(
                    200, "text/plain; charset=utf-8", exporter.render_statusz()
                )
            elif path == "/profilez":
                code, body = exporter.render_profilez(query)
                self._send(code, "application/json", body)
            else:
                self._send(404, "text/plain", "not found\n")
        except BrokenPipeError:
            pass  # scraper hung up mid-reply
        except Exception:
            exporter._note_error()
            logger.exception("exporter request failed (%s)", self.path)
            try:
                self._send(500, "text/plain", "internal error\n")
            except OSError:
                pass

    def log_message(self, format: str, *args) -> None:  # noqa: A002
        # scrape-per-second access logs belong in debug, not the run log
        logger.debug("exporter: " + format, *args)


def start_exporter(port: int | None = None, **sources) -> MetricsExporter | None:
    """Construct + start an exporter when enabled; None when the port is 0
    (`LLMT_METRICS_PORT` unset) or the bind fails. The one-call entry the
    serve CLI uses."""
    if port is None:
        port = resolve_metrics_port()
    if not port:
        return None
    exporter = MetricsExporter(port, **sources)
    return exporter if exporter.start() else None


# ------------------------------------------------------------------ profile


def profile_main(
    port: int | None = None,
    host: str = "127.0.0.1",
    tag: str | None = None,
    timeout_s: float = 5.0,
) -> int:
    """`python -m llm_training_tpu_torch profile [--port N] [--tag T]`: fire a live run's
    `/profilez` endpoint so the owning loop captures a device profile over
    its next steps (docs/observability.md#profiling). Stdlib-only like
    `watch` — runs from any operator machine. Exit 0 when the capture was
    armed, 3 when the trigger suppressed it (budget/cooldown/busy — the
    response says which), 2 when the exporter is unreachable."""
    import sys
    import urllib.error
    import urllib.request

    if port is None:
        port = resolve_metrics_port()
    if not port:
        print(
            "profile: no port — pass --port or set LLMT_METRICS_PORT "
            "(the run must export; docs/observability.md#profiling)",
            file=sys.stderr,
        )
        return 2
    url = f"http://{host}:{port}/profilez"
    if tag:
        url += "?" + urllib.parse.urlencode({"tag": tag})
    try:
        with urllib.request.urlopen(url, timeout=timeout_s) as resp:
            body = resp.read().decode("utf-8", "replace")
            code = resp.status
    except urllib.error.HTTPError as e:  # 429 (suppressed) / 404 carry JSON
        body = e.read().decode("utf-8", "replace")
        code = e.code
    except (urllib.error.URLError, OSError) as e:
        print(f"profile: {url} unreachable ({e})", file=sys.stderr)
        return 2
    print(body.rstrip("\n"), flush=True)
    return 0 if code == 200 else 3


# -------------------------------------------------------------------- watch


def watch_main(
    port: int | None = None,
    host: str = "127.0.0.1",
    interval_s: float = 2.0,
    once: bool = False,
    timeout_s: float = 3.0,
) -> int:
    """`python -m llm_training_tpu_torch watch [--port N]`: poll a live run's `/statusz`
    and print each snapshot — a terminal dashboard over the exporter.
    Exit 2 when --once cannot reach the exporter; Ctrl-C exits 0."""
    import sys
    import urllib.error
    import urllib.request

    if port is None:
        port = resolve_metrics_port()
    if not port:
        print(
            "watch: no port — pass --port or set LLMT_METRICS_PORT "
            "(the run must export; docs/observability.md#live-telemetry)",
            file=sys.stderr,
        )
        return 2
    url = f"http://{host}:{port}/statusz"
    try:
        while True:
            try:
                with urllib.request.urlopen(url, timeout=timeout_s) as resp:
                    body = resp.read().decode("utf-8", "replace")
                print(body.rstrip("\n"), flush=True)
            except (urllib.error.URLError, OSError) as e:
                print(f"watch: {url} unreachable ({e})", file=sys.stderr)
                if once:
                    return 2
            if once:
                return 0
            print("---", flush=True)
            time.sleep(interval_s)
    except KeyboardInterrupt:
        return 0
