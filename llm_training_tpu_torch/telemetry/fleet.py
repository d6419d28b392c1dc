"""Fleet observability plane: replica discovery, multi-target aggregation,
and the federation and `/fleetz` surfaces.

Counterpart of `llm_training_tpu/telemetry/fleet.py` (standard library
only). The exporter answers "is THIS process healthy right now", one
`/metrics` port per process; this module answers the fleet's questions
(how many replicas, which are red, the total queue depth, whether every
accepted request completed somewhere), in three parts:

- **replica discovery**: every armed `MetricsExporter` drops a
  `replica-<pid>.json` card into the `LLMT_FLEET_DIR` directory (port,
  role train|serve|bench|router, supervisor attempt, and a wall/monotonic
  start anchor) and removes it on a clean stop. A SIGKILLed replica cannot
  remove its card, so discovery flags cards whose pid is dead as
  **stale**. Static `--targets host:port,...` skips discovery.
- **aggregator**: `FleetAggregator` sweeps every replica's `/metrics`
  (the exporter's strict Prometheus parser) and `/healthz` into ONE
  snapshot: per-replica series, fleet rollups (counters summed; gauges as
  min/mean/max; summed serve and router queue/completed views), and a
  health verdict that names red replicas and stale cards. A fleet-level
  `SLOMonitor` can ride the merged serve stream: each sweep feeds every
  serve replica's rolling TTFT/TPOT as one observation.
- **surfaces**: `/metrics` (federation: per-replica series labelled
  `{replica="<id>"}` plus unlabelled `llmt_fleet_*` rollups), `/fleetz` (a
  one-pager) and `/healthz` (the verdict); `fleet_main` wraps them
  (one-shot `--json`, a polling dashboard, exit 2 naming the searched
  paths when no replica is found).

Sweeps compose entirely outside `FleetAggregator._lock` (network I/O,
parsing, rollups, the SLO feed); only the finished snapshot swap happens
under it. An unreachable replica is a red entry in the verdict, never an
exception out of the sweep loop. Nothing here touches the card.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

from llm_training_tpu_torch.telemetry.exporter import (
    parse_prometheus_kinds,
    parse_prometheus_text,
)

logger = logging.getLogger(__name__)

FLEET_DIR_ENV = "LLMT_FLEET_DIR"
SCRAPE_INTERVAL_ENV = "LLMT_FLEET_SCRAPE_S"
CARD_SCHEMA = 1
ROLES = ("train", "serve", "bench", "router")

# serve gauges that roll up as FLEET SUMS (queue depth / in-flight /
# completed are "how much work, fleet-wide" — the census cross-check and
# the router's least-loaded pick read exactly these)
_SERVE_SUM_KEYS = (
    "llmt_serve_queue_depth",
    "llmt_serve_running",
    "llmt_serve_requests_completed",
    "llmt_serve_requests_failed",
    "llmt_serve_requests_shed",
    "llmt_serve_tokens_generated",
)

# router gauges that roll up the same way (the loadgen's --router census
# cross-check reads the fleet sums after a failover)
_ROUTER_SUM_KEYS = (
    "llmt_router_queue_depth",
    "llmt_router_inflight",
    "llmt_router_requests_total",
    "llmt_router_requests_completed",
    "llmt_router_requests_failed",
    "llmt_router_replays",
)


def resolve_fleet_dir() -> Path | None:
    """The discovery directory from `LLMT_FLEET_DIR` (unset/empty = fleet
    discovery off)."""
    raw = os.environ.get(FLEET_DIR_ENV)
    if not raw:
        return None
    return Path(raw)


def supervisor_attempt() -> int:
    """The 1-based supervised-relaunch attempt this process runs as, 0
    when unsupervised (`LLMT_SUPERVISOR_ATTEMPT` is set by the supervisor
    before each launch — docs/resilience.md)."""
    raw = os.environ.get("LLMT_SUPERVISOR_ATTEMPT")
    try:
        return int(raw) if raw else 0
    except ValueError:
        return 0


# ------------------------------------------------------------------ cards


def write_replica_card(
    fleet_dir: str | Path,
    port: int,
    role: str = "train",
    host: str = "127.0.0.1",
) -> Path | None:
    """Drop this process's `replica-<pid>.json` discovery card. The card
    carries a wall+monotonic start anchor pair so fleet consumers can
    align replica uptimes the same way `trace --merge` aligns events.
    Never raises — discovery is observability, not the run's problem."""
    pid = os.getpid()
    attempt = supervisor_attempt()
    card = {
        "schema": CARD_SCHEMA,
        "replica_id": f"{role}-{attempt}-{pid}",
        "pid": pid,
        "host": host,
        "port": int(port),
        "role": role if role in ROLES else "train",
        "attempt": attempt,
        "start_wall_s": time.time(),
        "start_mono_s": time.monotonic(),
    }
    try:
        fleet_dir = Path(fleet_dir)
        fleet_dir.mkdir(parents=True, exist_ok=True)
        path = fleet_dir / f"replica-{pid}.json"
        # write-then-rename so a sweeping aggregator never reads a torn card
        tmp = path.with_suffix(".json.tmp")
        tmp.write_text(json.dumps(card) + "\n")
        tmp.replace(path)
    except OSError:
        logger.exception("fleet card write failed (discovery disabled)")
        return None
    logger.info("fleet: replica card %s (%s)", path.name, card["replica_id"])
    return path


def remove_replica_card(path: str | Path | None) -> None:
    if path is None:
        return
    try:
        Path(path).unlink(missing_ok=True)
    except OSError:
        logger.exception("fleet card remove failed: %s", path)


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except (PermissionError, OSError):
        return True  # exists but not ours
    return True


def discover_replicas(fleet_dir: str | Path) -> list[dict]:
    """Read every `replica-*.json` card under `fleet_dir`. Each returned
    descriptor carries `stale=True` when the card's pid is dead — the
    SIGKILL signature (a clean stop removes the card). Torn/malformed
    cards are skipped, never raised."""
    replicas: list[dict] = []
    try:
        paths = sorted(Path(fleet_dir).glob("replica-*.json"))
    except OSError:
        return replicas
    for path in paths:
        try:
            card = json.loads(path.read_text())
        except (OSError, json.JSONDecodeError):
            continue  # torn mid-write or vanished mid-sweep
        if not isinstance(card, dict) or "port" not in card:
            continue
        pid = card.get("pid")
        card = dict(card)
        card.setdefault("host", "127.0.0.1")
        card.setdefault("role", "train")
        card.setdefault(
            "replica_id", f"{card['role']}-?-{pid if pid else path.stem}"
        )
        card["card_path"] = str(path)
        card["stale"] = not (isinstance(pid, int) and _pid_alive(pid))
        replicas.append(card)
    return replicas


def parse_targets(raw: str) -> list[dict]:
    """`host:port,host:port` -> static replica descriptors (role unknown:
    a static target has no card; its series still label by replica id)."""
    out: list[dict] = []
    for item in raw.split(","):
        item = item.strip()
        if not item:
            continue
        host, _, port_s = item.rpartition(":")
        try:
            port = int(port_s)
        except ValueError:
            logger.warning("fleet: ignoring malformed target %r", item)
            continue
        out.append({
            "replica_id": f"target-{host or '127.0.0.1'}:{port}",
            "host": host or "127.0.0.1",
            "port": port,
            "role": "serve",
            "stale": False,
            "static": True,
        })
    return out


def resolve_scrape_interval(default: float = 2.0) -> float:
    """The sweep cadence from `LLMT_FLEET_SCRAPE_S` (malformed/<=0 falls
    back to the default — observability never crashes the owner)."""
    raw = os.environ.get(SCRAPE_INTERVAL_ENV)
    if not raw:
        return default
    try:
        interval = float(raw)
    except ValueError:
        logger.warning(
            "ignoring malformed %s=%r (want seconds)", SCRAPE_INTERVAL_ENV, raw
        )
        return default
    return interval if interval > 0 else default


# ------------------------------------------------------------- aggregator


class FleetAggregator:
    """Background multi-target scrape loop -> one consistent fleet
    snapshot (per-replica series + rollups + health verdict), re-exported
    over HTTP (/metrics federation, /fleetz, /healthz).

    Sweeps compose outside `_lock` (every scrape, parse, rollup, and the
    optional SLO feed) and swap the finished snapshot under it; handler
    threads and `snapshot()` readers take the lock only for the swap-out.
    """

    def __init__(
        self,
        fleet_dir: str | Path | None = None,
        targets: str = "",
        interval_s: float | None = None,
        slo=None,
        timeout_s: float = 2.0,
        clock=time.monotonic,
    ):
        self.fleet_dir = Path(fleet_dir) if fleet_dir else None
        self.static_targets = parse_targets(targets)
        self.interval_s = (
            interval_s if interval_s else resolve_scrape_interval()
        )
        self.slo = slo
        self.timeout_s = timeout_s
        self._clock = clock
        self._lock = threading.Lock()
        self._snapshot: dict = _empty_snapshot()  # guarded by: _lock
        self._sweeps = 0  # guarded by: _lock
        self._server: ThreadingHTTPServer | None = None  # guarded by: _lock
        self._http_thread: threading.Thread | None = None  # guarded by: _lock
        self._sweep_thread: threading.Thread | None = None  # guarded by: _lock
        self._stop = threading.Event()
        self.port: int | None = None  # bound federation port; guarded by: _lock

    # ------------------------------------------------------------- sweep

    def _scrape(self, host: str, port: int, path: str) -> tuple[int, str]:
        """(status, body) for one replica endpoint; raises OSError family
        on unreachable — callers turn that into a red entry."""
        import urllib.error
        import urllib.request

        url = f"http://{host}:{port}{path}"
        try:
            with urllib.request.urlopen(url, timeout=self.timeout_s) as resp:
                return resp.status, resp.read().decode("utf-8", "replace")
        except urllib.error.HTTPError as e:
            # /healthz answers 503 WITH a body — that is an answer, not
            # an unreachable replica
            return e.code, e.read().decode("utf-8", "replace")

    def sweep(self) -> dict:
        """One full fleet sweep: discover, scrape every live replica,
        compose the snapshot, feed the fleet SLO — all outside `_lock` —
        then publish. Returns the fresh snapshot."""
        discovered = (
            discover_replicas(self.fleet_dir) if self.fleet_dir else []
        )
        replicas = discovered + list(self.static_targets)
        entries: dict[str, dict] = {}
        stale_cards: list[str] = []
        red: list[str] = []
        slo_feed: list[tuple[float | None, float | None, bool]] = []
        for card in replicas:
            rid = str(card["replica_id"])
            entry = {
                "role": card.get("role", "train"),
                "host": card["host"],
                "port": card["port"],
                "attempt": card.get("attempt"),
                "stale": bool(card.get("stale")),
                "healthy": False,
                "error": None,
                "metrics": {},
                "kinds": {},
            }
            if entry["stale"]:
                # a SIGKILLed replica's card: flagged, never scraped —
                # scraping a dead pid's port forever is how aggregators
                # rot (the port may have been reused by anything)
                stale_cards.append(rid)
                entry["error"] = "stale card (pid dead, card not removed)"
                entries[rid] = entry
                continue
            try:
                status, body = self._scrape(
                    card["host"], card["port"], "/metrics"
                )
                if status != 200:
                    raise OSError(f"/metrics answered {status}")
                entry["metrics"] = parse_prometheus_text(body)
                entry["kinds"] = parse_prometheus_kinds(body)
                h_status, h_body = self._scrape(
                    card["host"], card["port"], "/healthz"
                )
                entry["healthy"] = h_status == 200
                try:
                    entry["health_detail"] = json.loads(h_body)
                except (json.JSONDecodeError, ValueError):
                    entry["health_detail"] = {"raw": h_body[:200]}
                if not entry["healthy"]:
                    red.append(rid)
            except (OSError, ValueError) as e:
                entry["error"] = str(e)
                red.append(rid)
            entries[rid] = entry
            if entry["role"] == "serve" and not entry["stale"]:
                metrics = entry["metrics"]
                slo_feed.append((
                    metrics.get("llmt_serve_ttft_p99_ms"),
                    metrics.get("llmt_serve_tpot_p99_ms"),
                    entry["healthy"],
                ))
        verdict = "empty" if not entries else (
            "red" if (red or stale_cards) else "green"
        )
        snapshot = {
            "verdict": verdict,
            "replicas": entries,
            "red": red,
            "stale_cards": stale_cards,
            "rollup": _rollup(entries),
            "fleet_dir": str(self.fleet_dir) if self.fleet_dir else None,
        }
        # the fleet SLO rides the merged serve stream: one observation per
        # serve replica per sweep (rolling p99s as the latency sample, the
        # health verdict as ok) — outside _lock like everything above
        slo = self.slo
        if slo is not None:
            for ttft, tpot, ok in slo_feed:
                slo.observe_request(ttft_ms=ttft, tpot_ms=tpot, ok=ok)
            snapshot["slo_breaches"] = slo.breach_count()
        with self._lock:
            self._sweeps += 1
            snapshot["sweeps"] = self._sweeps
            self._snapshot = snapshot
        return snapshot

    def snapshot(self) -> dict:
        with self._lock:
            return self._snapshot

    def sweep_count(self) -> int:
        with self._lock:
            return self._sweeps

    # --------------------------------------------------------- lifecycle

    def start(self, port: int | None = None, host: str = "") -> bool:
        """Arm the background sweep loop and (when `port` is not None)
        the federation HTTP server. Bind failure degrades to a logged
        warning with the sweep loop still running — same never-the-run's-
        problem posture as the exporter."""
        aggregator = self
        server = None
        if port is not None:
            try:
                server = ThreadingHTTPServer((host, port), _FleetHandler)
            except OSError as e:
                logger.warning(
                    "fleet federation endpoint disabled: cannot bind "
                    "port %d (%s) — sweeps continue unexported", port, e,
                )
                server = None
        sweep_thread = threading.Thread(
            target=self._sweep_loop, name="fleet-sweep", daemon=True
        )
        http_thread = None
        if server is not None:
            server.daemon_threads = True
            server.aggregator = aggregator  # type: ignore[attr-defined]
            http_thread = threading.Thread(
                target=server.serve_forever, name="fleet-federation",
                daemon=True, kwargs={"poll_interval": 0.2},
            )
        with self._lock:
            self._server = server
            self._http_thread = http_thread
            self._sweep_thread = sweep_thread
            self.port = server.server_address[1] if server else None
        sweep_thread.start()
        if http_thread is not None:
            http_thread.start()
            logger.info(
                "fleet aggregator listening on port %d "
                "(/metrics /fleetz /healthz)", self.port,
            )
        return True

    def _sweep_loop(self) -> None:
        # sweep-then-wait: the first snapshot exists one sweep after
        # start(), not one interval after
        while True:
            try:
                self.sweep()
            except Exception:
                logger.exception("fleet sweep failed (loop continues)")
            if self._stop.wait(self.interval_s):
                return

    def stop(self) -> None:
        self._stop.set()
        with self._lock:
            server, self._server = self._server, None
            http_thread, self._http_thread = self._http_thread, None
            sweep_thread, self._sweep_thread = self._sweep_thread, None
        if server is not None:
            server.shutdown()
            server.server_close()
        if http_thread is not None:
            http_thread.join(timeout=5.0)
        if sweep_thread is not None:
            sweep_thread.join(timeout=5.0)

    # ----------------------------------------------------------- surfaces

    def render_metrics(self) -> str:
        """Federation text: every replica's series re-exported with a
        strict `{replica="<id>"}` label block, then the unlabeled
        `llmt_fleet_*` rollups. Output round-trips through
        `parse_prometheus_text(labels=True)` — pinned by the fleet smoke."""
        snapshot = self.snapshot()
        lines: list[str] = []
        typed: set[str] = set()
        for rid in sorted(snapshot["replicas"]):
            entry = snapshot["replicas"][rid]
            metrics = entry.get("metrics", {})
            kinds = entry.get("kinds", {})
            for name in sorted(metrics):
                if name not in typed:
                    typed.add(name)
                    lines.append(
                        f"# TYPE {name} {kinds.get(name, 'gauge')}"
                    )
                lines.append(
                    f'{name}{{replica="{rid}"}} {float(metrics[name])!r}'
                )
        rollup = snapshot["rollup"]
        for name in sorted(rollup):
            # rollups are derived views of the moment's sweep — gauges all
            lines.append(f"# TYPE {name} gauge")
            lines.append(f"{name} {float(rollup[name])!r}")
        lines.append("# TYPE llmt_fleet_sweeps counter")
        lines.append(f"llmt_fleet_sweeps {float(snapshot.get('sweeps', 0))!r}")
        lines.append("")
        return "\n".join(lines)

    def health(self) -> tuple[bool, dict]:
        snapshot = self.snapshot()
        detail = {
            "status": "ok" if snapshot["verdict"] == "green" else "unhealthy",
            "verdict": snapshot["verdict"],
            "replicas": len(snapshot["replicas"]),
            "red": snapshot["red"],
            "stale_cards": snapshot["stale_cards"],
        }
        return snapshot["verdict"] == "green", detail

    def render_fleetz(self) -> str:
        """The one-pager: verdict first, red replicas and stale cards BY
        NAME, then one line per replica and the serve rollup."""
        snapshot = self.snapshot()
        rollup = snapshot["rollup"]
        lines = [
            "llm-training-tpu fleetz",
            "",
            f"verdict: {snapshot['verdict'].upper()}  "
            f"({len(snapshot['replicas'])} replica(s), "
            f"sweep #{snapshot.get('sweeps', 0)})",
        ]
        for rid in snapshot["red"]:
            entry = snapshot["replicas"].get(rid, {})
            lines.append(f"  RED: {rid} — {entry.get('error') or 'unhealthy'}")
        for rid in snapshot["stale_cards"]:
            lines.append(f"  STALE CARD: {rid} (pid dead; card not removed)")
        lines.append("")
        for rid in sorted(snapshot["replicas"]):
            entry = snapshot["replicas"][rid]
            state = (
                "stale" if entry["stale"]
                else "up" if entry["healthy"] else "RED"
            )
            parts = [
                f"{rid:<28s} {entry['role']:<5s} "
                f"{entry['host']}:{entry['port']:<6d} {state}"
            ]
            metrics = entry.get("metrics", {})
            if entry["role"] == "serve" and metrics:
                parts.append(
                    f"queue={metrics.get('llmt_serve_queue_depth', 0):.0f} "
                    f"running={metrics.get('llmt_serve_running', 0):.0f} "
                    f"done={metrics.get('llmt_serve_requests_completed', 0):.0f}"
                )
                ttft = metrics.get("llmt_serve_ttft_p99_ms")
                if ttft is not None:
                    parts.append(f"ttft_p99={ttft:.1f}ms")
            lines.append("  " + "  ".join(parts))
        serve_keys = [
            k for k in sorted(rollup) if k.startswith("llmt_fleet_serve_")
        ]
        if serve_keys:
            lines.append("")
            lines.append("serve rollup:")
            for key in serve_keys:
                lines.append(f"  {key} = {rollup[key]:.3f}")
        if "slo_breaches" in snapshot:
            lines.append("")
            lines.append(f"fleet slo breaches: {snapshot['slo_breaches']}")
        lines.append("")
        return "\n".join(lines)


def _empty_snapshot() -> dict:
    return {
        "verdict": "empty", "replicas": {}, "red": [], "stale_cards": [],
        "rollup": {}, "sweeps": 0, "fleet_dir": None,
    }


def _rollup(entries: dict[str, dict]) -> dict[str, float]:
    """Fleet rollups over the live, scrape-successful replicas: counters
    sum (`llmt_X` -> `llmt_fleet_X`), gauges spread to
    `llmt_fleet_X_min/_mean/_max`, and the serve work gauges ALSO sum
    unsuffixed (`_SERVE_SUM_KEYS` — queue/in-flight/completed are
    fleet-total questions; the census cross-check reads
    `llmt_fleet_serve_requests_completed`). Replica-count meta gauges ride
    along."""
    rollup: dict[str, float] = {}
    series: dict[str, list[float]] = {}
    kinds: dict[str, str] = {}
    live = 0
    healthy = 0
    stale = 0
    for entry in entries.values():
        if entry.get("stale"):
            stale += 1
            continue
        live += 1
        if entry.get("healthy"):
            healthy += 1
        for name, value in entry.get("metrics", {}).items():
            series.setdefault(name, []).append(float(value))
            kind = entry.get("kinds", {}).get(name, "gauge")
            if kinds.get(name, kind) == kind:
                kinds[name] = kind
    for name, values in series.items():
        fleet_name = "llmt_fleet_" + name.removeprefix("llmt_")
        if kinds.get(name) == "counter":
            rollup[fleet_name] = sum(values)
        else:
            rollup[f"{fleet_name}_min"] = min(values)
            rollup[f"{fleet_name}_mean"] = sum(values) / len(values)
            rollup[f"{fleet_name}_max"] = max(values)
        if name in _SERVE_SUM_KEYS or name in _ROUTER_SUM_KEYS:
            rollup[fleet_name] = sum(values)
    rollup["llmt_fleet_replicas"] = float(len(entries))
    rollup["llmt_fleet_replicas_live"] = float(live)
    rollup["llmt_fleet_replicas_healthy"] = float(healthy)
    rollup["llmt_fleet_replicas_red"] = float(live - healthy)
    rollup["llmt_fleet_stale_cards"] = float(stale)
    return rollup


class _FleetHandler(BaseHTTPRequestHandler):
    """Routes /metrics (federation), /fleetz, /healthz; anything else is
    404. Same posture as the exporter's handler: per-request daemon
    threads, content composed without the aggregator's lock held."""

    server_version = "llmt-fleet/1"

    def _send(self, code: int, content_type: str, body: str) -> None:
        payload = body.encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)

    def do_GET(self) -> None:  # noqa: N802 — BaseHTTPRequestHandler API
        aggregator: FleetAggregator = self.server.aggregator  # type: ignore[attr-defined]
        path = self.path.split("?", 1)[0]
        try:
            if path == "/metrics":
                self._send(
                    200, "text/plain; version=0.0.4; charset=utf-8",
                    aggregator.render_metrics(),
                )
            elif path == "/healthz":
                healthy, detail = aggregator.health()
                self._send(
                    200 if healthy else 503, "application/json",
                    json.dumps(detail) + "\n",
                )
            elif path == "/fleetz":
                self._send(
                    200, "text/plain; charset=utf-8",
                    aggregator.render_fleetz(),
                )
            else:
                self._send(404, "text/plain", "not found\n")
        except BrokenPipeError:
            pass  # scraper hung up mid-reply
        except Exception:
            logger.exception("fleet request failed (%s)", self.path)
            try:
                self._send(500, "text/plain", "internal error\n")
            except OSError:
                pass

    def log_message(self, format: str, *args) -> None:  # noqa: A002
        logger.debug("fleet: " + format, *args)


# -------------------------------------------------------------------- CLI


def fleet_main(
    fleet_dir: str | None = None,
    targets: str = "",
    interval_s: float | None = None,
    port: int | None = None,
    host: str = "127.0.0.1",
    once: bool = False,
    as_json: bool = False,
    out: str | None = None,
    slo=None,
) -> int:
    """`llm-training-tpu fleet [--dir D | --targets h:p,...]`: sweep the
    fleet and render `/fleetz` (or `--json`). `--once` exits after one
    sweep — exit 2, naming every path searched, when no replicas were
    found. Without `--once` it polls like `watch`; `--port` additionally
    serves the federation endpoint. `--out` writes the snapshot JSON
    (what `report --format json` picks up as its `fleet` block)."""
    import sys

    resolved_dir = Path(fleet_dir) if fleet_dir else resolve_fleet_dir()
    if resolved_dir is None and not targets:
        print(
            f"fleet: nowhere to look — pass --dir/--targets or set "
            f"{FLEET_DIR_ENV} (docs/observability.md#fleet)",
            file=sys.stderr,
        )
        return 2
    aggregator = FleetAggregator(
        fleet_dir=resolved_dir, targets=targets,
        interval_s=interval_s, slo=slo,
    )

    def _render(snapshot: dict) -> str:
        if as_json:
            return json.dumps(snapshot, indent=2, sort_keys=True)
        return aggregator.render_fleetz().rstrip("\n")

    def _write_out(snapshot: dict) -> None:
        if out:
            try:
                Path(out).write_text(
                    json.dumps(snapshot, indent=2, sort_keys=True) + "\n"
                )
            except OSError as e:
                print(f"fleet: --out {out} unwritable ({e})", file=sys.stderr)

    if once:
        snapshot = aggregator.sweep()
        if not snapshot["replicas"]:
            searched = []
            if resolved_dir is not None:
                searched.append(
                    f"{resolved_dir}/replica-*.json"
                    + ("" if resolved_dir.is_dir() else " (dir absent)")
                )
            if targets:
                searched.append(f"targets [{targets}]")
            print(
                "fleet: no replicas found — searched "
                + " and ".join(searched)
                + " (arm exporters with LLMT_FLEET_DIR, or pass live "
                "--targets; docs/observability.md#fleet)",
                file=sys.stderr,
            )
            return 2
        print(_render(snapshot))
        _write_out(snapshot)
        return 0

    aggregator.start(port=port, host="" if port is not None else host)
    try:
        while True:
            time.sleep(aggregator.interval_s)
            snapshot = aggregator.snapshot()
            print(_render(snapshot), flush=True)
            _write_out(snapshot)
            if not as_json:
                print("---", flush=True)
    except KeyboardInterrupt:
        return 0
    finally:
        aggregator.stop()
