"""Health-aware router tier over N ``serve`` replicas.

Counterpart of `llm_training_tpu/serve/router.py` (standard library only;
its replicas are the port's own ``serve`` children). The router speaks
``serve``'s JSONL request protocol on its own stdin/stdout and fans
requests out over a fleet of ``serve`` children:

* **Routing / eviction**: least-loaded admission over the
  :class:`~llm_training_tpu_torch.telemetry.fleet.FleetAggregator`'s
  per-replica queue and TTFT series; a replica leaves the rotation as soon
  as its ``/healthz`` goes red or its discovery card goes stale.
* **Failover replay**: exactly-once terminals across a replica's death.
  Every request-to-replica assignment is journaled; when a replica dies
  mid-stream its requests in flight are replayed (prompt plus the
  ``emitted`` watermark, as ``submit_resumed`` folds them) onto a live
  replica without streaming delivered tokens again. Request ids are
  namespaced per replica, so ``replay_journal``'s fold never merges two
  replicas' ``req-0``.
* **Hedged retries**: when a request's projected TTFT on its replica
  breaches its budget and another replica has free slots, the request is
  sent to the second one too; the first token wins and the loser is
  suppressed (never two terminals).
* **SLO-driven elasticity**: a sustained TTFT burn spawns another
  ``serve`` child; sustained idleness drains and retires one. Every scale
  event is a ``cat="router"`` trace instant and ``router/*`` gauges.

The chaos triggers ``LLMT_CHAOS_ROUTER_KILL_REPLICA`` (SIGKILL the replica
that produced the Nth forwarded token) and ``LLMT_CHAOS_ROUTER_BLACKHOLE``
(accept the Nth assignment but never submit it, so only a hedge can
finish it) drive the failover and hedging paths.

The router is a control plane: it imports ``torch`` through the CLI's
modules but never initialises CUDA, which would take card memory from its
own replicas. The replicas run on ``cuda`` unless ``-- --device cpu`` is
forwarded.
"""

from __future__ import annotations

import json
import logging
import os
import queue
import shutil
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

from llm_training_tpu_torch.serve.journal import RequestJournal, replay_journal

logger = logging.getLogger(__name__)

# Stop reasons that terminate a stream, mirrored from the serve engine.
TERMINAL_REASONS = ("eos", "max_tokens", "deadline", "overloaded", "rejected", "capacity")
# Stop reasons that count as completed (vs failed) for SLO purposes.
COMPLETED_REASONS = ("eos", "max_tokens")

ROUTER_JOURNAL = "router-journal.jsonl"
ROUTER_JOURNAL_REPLAYING = "router-journal.replaying.jsonl"


def namespaced_id(rid: str, client_id: str) -> str:
    """Namespace a client request id under a replica id.

    Two replicas can both be carrying a ``req-0`` (e.g. a replay of replica
    A's ``req-0`` onto replica B while B already had its own); folding their
    journals without namespacing would merge them.  ``::`` never appears in
    loadgen/client ids.
    """
    return f"{rid}::{client_id}"


def split_namespaced_id(nsid: str) -> tuple[str, str]:
    """Inverse of :func:`namespaced_id`. Returns ``(rid, client_id)``."""
    rid, _, client_id = nsid.partition("::")
    return rid, client_id


def fold_replica_journals(journals: dict[str, Path | str]) -> list[dict]:
    """Fold several replicas' serve journals into one namespaced entry list.

    Each journal is folded *independently* via
    :func:`~llm_training_tpu_torch.serve.journal.replay_journal` (last acceptance
    wins per id, done drops the id, torn tails are skipped) and only then are
    the surviving entries merged, with ids namespaced per replica.  Entries
    gain ``source_replica`` and ``client_id`` annotations so the router can
    map them back to client streams.
    """
    folded: list[dict] = []
    for rid, path in journals.items():
        for entry in replay_journal(str(path)):
            out = dict(entry)
            out["client_id"] = entry["id"]
            out["id"] = namespaced_id(rid, entry["id"])
            out["source_replica"] = rid
            folded.append(out)
    return folded


class RoutedRequest:
    """Per-client-request state held by the router.

    Duck-typed for :class:`RequestJournal` (``id``/``prompt``/``generated``/
    ``emitted``/``stop_reason``/``max_new_tokens``/``priority``/
    ``deadline_ms``).  ``generated`` holds every token *forwarded to the
    client* and ``emitted == len(generated)`` always (the router never buffers
    between generated and emitted; per-leg caches live in ``legs``).

    A *leg* is one submission of this request to one replica (the primary
    assignment, a hedge, or a failover replay).  ``legs`` maps replica id →
    ``{"base": int, "tokens": list, "done": dict | None, "open": bool}``
    where ``base`` is ``emitted`` at the moment the leg was submitted and
    ``tokens`` are all tokens received from that leg (absolute position of
    ``tokens[i]`` is ``base + i``; greedy decode makes overlapping legs agree
    position-for-position).
    """

    __slots__ = (
        "id",
        "prompt",
        "max_new_tokens",
        "priority",
        "deadline_ms",
        "arrival_s",
        "generated",
        "emitted",
        "stop_reason",
        "winner",
        "primary",
        "replays",
        "legs",
        "first_token_s",
        "generation",
    )

    def __init__(
        self,
        id: str,
        prompt: list[int],
        max_new_tokens: int,
        priority: int = 0,
        deadline_ms: float | None = None,
        arrival_s: float = 0.0,
    ) -> None:
        self.id = id
        self.prompt = list(prompt)
        self.max_new_tokens = int(max_new_tokens)
        self.priority = int(priority)
        self.deadline_ms = deadline_ms
        self.arrival_s = arrival_s
        self.generated: list[int] = []
        self.emitted = 0
        self.stop_reason: str | None = None
        self.winner: str | None = None
        self.primary: str | None = None
        self.replays = 0
        self.legs: dict[str, dict] = {}
        self.first_token_s: float | None = None
        self.generation = 0


class ReplicaHandle:
    """One supervised ``serve`` child plus its stdout reader thread.

    Every attribute is read-only after ``__init__`` (racecheck: the reader
    thread only *reads* ``proc``/``events``; all mutation flows through the
    thread-safe ``queue.Queue``).  The reader forwards each JSON line from
    the child's stdout as ``("chunk", rid, obj)`` onto the shared event
    queue, skipping non-JSON lines (serve logs to stdout), and posts
    ``("eof", rid, None)`` exactly once when the pipe closes.
    """

    def __init__(
        self,
        rid: str,
        proc: subprocess.Popen,
        events: "queue.Queue[tuple[str, str, object]]",
        run_dir: Path,
        port: int,
        started_s: float,
    ) -> None:
        self.rid = rid
        self.proc = proc
        self.events = events
        self.run_dir = Path(run_dir)
        self.journal_path = self.run_dir / "serve-journal.jsonl"
        self.port = port
        self.started_s = started_s
        self._thread = threading.Thread(
            target=self._read_loop, name=f"router-read-{rid}", daemon=True
        )
        self._thread.start()

    def _read_loop(self) -> None:
        stdout = self.proc.stdout
        if stdout is not None:
            for line in stdout:
                line = line.strip()
                if not line or not line.startswith("{"):
                    continue
                try:
                    obj = json.loads(line)
                except json.JSONDecodeError:
                    continue  # serve logs to stdout; skip non-protocol lines
                self.events.put(("chunk", self.rid, obj))
        self.events.put(("eof", self.rid, None))

    def submit(self, record: dict) -> bool:
        """Write one JSONL record to the child's stdin. Main loop only."""
        stdin = self.proc.stdin
        if stdin is None:
            return False
        try:
            stdin.write(json.dumps(record) + "\n")
            stdin.flush()
            return True
        except (BrokenPipeError, OSError, ValueError):
            return False

    def close_stdin(self) -> None:
        stdin = self.proc.stdin
        if stdin is not None:
            try:
                stdin.close()
            except OSError:
                pass

    def alive(self) -> bool:
        return self.proc.poll() is None

    def kill(self) -> None:
        if self.alive():
            try:
                self.proc.kill()
            except OSError:
                pass

    def join_reader(self, timeout: float = 5.0) -> None:
        self._thread.join(timeout=timeout)


class Router:
    """Thread-shared routing core: assignment, legs, failover, elasticity.

    Shared between the main loop and the exporter's ``extra_fn`` /
    ``status_fn`` callbacks (HTTP server thread), hence every post-init
    mutable attribute is guarded by ``_lock``.  Journal appends happen under
    the router lock (LOCK_ORDER: router before journal); chaos hooks and all
    stdout printing happen strictly *outside* it, in the runtime.
    """

    def __init__(
        self,
        journal: RequestJournal | None = None,
        clock=time.monotonic,
        hedge_ttft_ms: float = 0.0,
        min_replicas: int = 1,
        max_replicas: int = 1,
        scale_cooldown_s: float = 30.0,
        idle_retire_s: float = 0.0,
    ) -> None:
        self.journal = journal
        self.clock = clock
        self.hedge_ttft_ms = float(hedge_ttft_ms)
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.scale_cooldown_s = float(scale_cooldown_s)
        self.idle_retire_s = float(idle_retire_s)
        self._lock = threading.Lock()
        self._replicas: dict[str, ReplicaHandle] = {}  # guarded by: _lock
        self._requests: dict[str, RoutedRequest] = {}  # guarded by: _lock
        self._finished: set[str] = set()  # guarded by: _lock
        self._pending: list[RoutedRequest] = []  # guarded by: _lock
        self._health: dict[str, dict] = {}  # guarded by: _lock
        self._evicted: set[str] = set()  # guarded by: _lock
        self._retiring: set[str] = set()  # guarded by: _lock
        self._assigned_since_scrape: dict[str, int] = {}  # guarded by: _lock
        self._counters: dict[str, int] = {}  # guarded by: _lock
        self._next_ordinal = 0  # guarded by: _lock
        self._target = int(min_replicas)  # guarded by: _lock
        self._last_scale_s = -1e18  # guarded by: _lock
        self._last_breaches = 0  # guarded by: _lock
        self._last_traffic_s = 0.0  # guarded by: _lock
        self._peak_inflight = 0  # guarded by: _lock
        self._assign_seq = 0  # guarded by: _lock

    # -- internal helpers (callers hold _lock) ------------------------------

    # guarded by: _lock
    def _bump(self, name: str, delta: int = 1) -> None:
        self._counters[name] = self._counters.get(name, 0) + delta

    # guarded by: _lock
    def _note(self, record: dict) -> None:
        if self.journal is not None:
            self.journal.note(record)

    # guarded by: _lock
    def _inflight(self) -> int:
        return sum(1 for r in self._requests.values() if r.stop_reason is None)

    # guarded by: _lock
    def _flush_winner(self, req: RoutedRequest, rid: str) -> list[dict]:
        """Forward any cached tokens from the winning leg past the watermark."""
        leg = req.legs[rid]
        events: list[dict] = []
        while req.emitted < leg["base"] + len(leg["tokens"]):
            tok = leg["tokens"][req.emitted - leg["base"]]
            req.generated.append(tok)
            req.emitted += 1
            events.append(
                {
                    "type": "token",
                    "id": req.id,
                    "token": tok,
                    "generation": req.generation,
                }
            )
        if events and self.journal is not None:
            self.journal.progress(req)
        return events

    # guarded by: _lock
    def _finish(self, req: RoutedRequest, rid: str, done: dict) -> dict:
        """Mark terminal, rewrite the done chunk to router coordinates."""
        req.stop_reason = str(done.get("stop_reason", "eos"))
        out = dict(done)
        out["type"] = "done"
        out["id"] = req.id
        out["tokens"] = list(req.generated)
        out["n_tokens"] = len(req.generated)
        out["replica"] = rid
        out["replays"] = req.replays
        if req.first_token_s is not None:
            out["ttft_ms"] = (req.first_token_s - req.arrival_s) * 1000.0
        if self.journal is not None:
            self.journal.finished(req)
        if req.stop_reason in COMPLETED_REASONS:
            self._bump("requests_completed")
        else:
            self._bump("requests_failed")
        self._finished.add(req.id)
        del self._requests[req.id]
        return out

    # -- replica lifecycle --------------------------------------------------

    def next_ordinal(self) -> int:
        """Ordinals are never reused within a router incarnation."""
        with self._lock:
            n = self._next_ordinal
            self._next_ordinal += 1
            return n

    def register_replica(self, handle: ReplicaHandle) -> None:
        with self._lock:
            self._replicas[handle.rid] = handle
            self._assigned_since_scrape[handle.rid] = 0
            self._note({"event": "replica_up", "replica": handle.rid, "port": handle.port})

    def replica(self, rid: str) -> ReplicaHandle | None:
        with self._lock:
            return self._replicas.get(rid)

    def replicas(self) -> list[ReplicaHandle]:
        with self._lock:
            return list(self._replicas.values())

    def mark_retiring(self, rid: str) -> None:
        with self._lock:
            self._retiring.add(rid)
            self._note({"event": "replica_retiring", "replica": rid})

    def retire_replica(self, rid: str) -> None:
        """Clean removal (rc==0 after drain): no in-flight legs expected."""
        with self._lock:
            self._replicas.pop(rid, None)
            self._retiring.discard(rid)
            self._evicted.discard(rid)
            self._health.pop(rid, None)
            self._assigned_since_scrape.pop(rid, None)
            self._note({"event": "replica_retired", "replica": rid})

    def fail_replica(self, rid: str, folded: list[dict] | None = None) -> dict:
        """Replica died. Adopt hedge legs or journal extensions; orphan the rest.

        ``folded`` is the dead replica's journal folded via
        :func:`fold_replica_journals` (already namespaced).  Returns
        ``{"events": [...], "orphans": [RoutedRequest, ...]}`` — events are
        recovered token/done chunks to print, orphans need resubmission.
        """
        by_client: dict[str, dict] = {}
        for entry in folded or []:
            by_client[entry.get("client_id", entry["id"])] = entry
        events: list[dict] = []
        orphans: list[RoutedRequest] = []
        with self._lock:
            self._replicas.pop(rid, None)
            self._retiring.discard(rid)
            self._evicted.discard(rid)
            self._health.pop(rid, None)
            self._assigned_since_scrape.pop(rid, None)
            self._bump("failovers")
            self._note({"event": "replica_failed", "replica": rid})
            for req in list(self._requests.values()):
                leg = req.legs.get(rid)
                if leg is None:
                    continue
                leg["open"] = False
                if req.stop_reason is not None:
                    continue
                # Another leg may still be carrying this request.
                others = [
                    (orid, oleg)
                    for orid, oleg in req.legs.items()
                    if orid != rid and (oleg["open"] or oleg["done"] is not None)
                ]
                if req.winner is not None and req.winner != rid and others:
                    continue  # the winner is elsewhere and still covered
                adopted = False
                if others:
                    # Prefer a finished leg, then maximum token coverage.
                    others.sort(
                        key=lambda kv: (
                            kv[1]["done"] is not None,
                            kv[1]["base"] + len(kv[1]["tokens"]),
                        ),
                        reverse=True,
                    )
                    orid, oleg = others[0]
                    req.winner = orid
                    events.extend(self._flush_winner(req, orid))
                    if oleg["done"] is not None:
                        events.append(self._finish(req, orid, oleg["done"]))
                    adopted = True
                    self._bump("leg_adoptions")
                if adopted:
                    continue
                # Orphaned: fold in the dead replica's journal watermark if it
                # prefix-extends what the client has already seen.
                req.winner = None
                req.primary = None  # replay's next assignment is a fresh primary
                entry = by_client.get(req.id)
                if entry is not None:
                    jgen = list(entry.get("generated", ()))
                    if (
                        len(jgen) > len(req.generated)
                        and jgen[: len(req.generated)] == req.generated
                    ):
                        for tok in jgen[len(req.generated) :]:
                            req.generated.append(tok)
                            req.emitted += 1
                            events.append(
                                {
                                    "type": "token",
                                    "id": req.id,
                                    "token": tok,
                                    "generation": req.generation,
                                }
                            )
                            self._bump("recovered_tokens")
                        if self.journal is not None:
                            self.journal.progress(req)
                orphans.append(req)
        return {"events": events, "orphans": orphans}

    # -- health / fleet -----------------------------------------------------

    def update_fleet(self, snapshot: dict) -> list[str]:
        """Fold an aggregator snapshot into health state. Returns new evictions."""
        entries = snapshot.get("replicas", {}) or {}
        by_port: dict[int, dict] = {}
        for entry in entries.values():
            try:
                by_port[int(entry.get("port", -1))] = entry
            except (TypeError, ValueError):
                continue
        newly_evicted: list[str] = []
        with self._lock:
            for rid, handle in self._replicas.items():
                entry = by_port.get(handle.port)
                if entry is None:
                    continue
                metrics = entry.get("metrics") or {}
                bad = bool(entry.get("stale")) or not entry.get("healthy", True)
                self._health[rid] = {
                    "healthy": not bad,
                    "stale": bool(entry.get("stale")),
                    "queue_depth": float(metrics.get("llmt_serve_queue_depth", 0.0)),
                    "running": float(metrics.get("llmt_serve_running", 0.0)),
                    "ttft_p99_ms": float(metrics.get("llmt_serve_ttft_p99_ms", 0.0)),
                }
                self._assigned_since_scrape[rid] = 0
                if bad and rid not in self._evicted:
                    self._evicted.add(rid)
                    self._bump("evictions")
                    self._note({"event": "replica_evicted", "replica": rid})
                    newly_evicted.append(rid)
                elif not bad and rid in self._evicted:
                    self._evicted.discard(rid)
                    self._note({"event": "replica_restored", "replica": rid})
        return newly_evicted

    # guarded by: _lock
    def _load(self, rid: str) -> float:
        health = self._health.get(rid, {})
        return (
            float(health.get("queue_depth", 0.0))
            + float(health.get("running", 0.0))
            + float(self._assigned_since_scrape.get(rid, 0))
        )

    # -- admission ----------------------------------------------------------

    def assign(self, req: RoutedRequest, exclude: tuple[str, ...] = ()) -> tuple[str, int] | None:
        """Least-loaded assignment; opens a leg. Returns (rid, assign ordinal)."""
        with self._lock:
            candidates = [
                rid
                for rid in self._replicas
                if rid not in self._evicted
                and rid not in self._retiring
                and rid not in exclude
                and rid not in req.legs
            ]
            if not candidates:
                return None
            rid = min(candidates, key=self._load)
            self._assigned_since_scrape[rid] = self._assigned_since_scrape.get(rid, 0) + 1
            req.legs[rid] = {"base": req.emitted, "tokens": [], "done": None, "open": True}
            if req.primary is None:
                req.primary = rid
            if req.id not in self._requests:
                self._requests[req.id] = req
                self._bump("requests_total")
                inflight = self._inflight()
                if inflight > self._peak_inflight:
                    self._peak_inflight = inflight
            self._assign_seq += 1
            seq = self._assign_seq
            self._last_traffic_s = self.clock()
            self._note(
                {
                    "event": "assigned",
                    "id": req.id,
                    "replica": rid,
                    "emitted": req.emitted,
                    "seq": seq,
                }
            )
            return rid, seq

    def park(self, req: RoutedRequest) -> None:
        with self._lock:
            if req.id not in self._requests:
                self._requests[req.id] = req
                self._bump("requests_total")
            self._pending.append(req)

    def take_pending(self) -> list[RoutedRequest]:
        with self._lock:
            pending, self._pending = self._pending, []
            return pending

    def intake(self, record: dict) -> RoutedRequest | None:
        """Build a RoutedRequest from a client JSONL record; dedupe terminals."""
        rid = str(record.get("id", ""))
        with self._lock:
            if rid in self._finished or rid in self._requests:
                self._bump("duplicate_requests")
                return None
        req = RoutedRequest(
            id=rid,
            prompt=record.get("prompt", []),
            max_new_tokens=int(record.get("max_new_tokens", 32)),
            priority=int(record.get("priority", 0)),
            deadline_ms=record.get("deadline_ms"),
            arrival_s=self.clock(),
        )
        if self.journal is not None:
            self.journal.delivered(
                req.id,
                req.prompt,
                req.max_new_tokens,
                priority=req.priority,
                deadline_ms=req.deadline_ms,
            )
        return req

    def resume(self, entry: dict) -> RoutedRequest:
        """Rebuild a RoutedRequest from a folded router-journal entry."""
        req = RoutedRequest(
            id=entry["id"],
            prompt=entry.get("prompt", []),
            max_new_tokens=int(entry.get("max_new_tokens", 32)),
            priority=int(entry.get("priority", 0)),
            deadline_ms=entry.get("deadline_ms"),
            arrival_s=self.clock(),
        )
        req.generated = list(entry.get("generated", ()))
        req.emitted = len(req.generated)
        req.replays = 1
        with self._lock:
            self._requests[req.id] = req
            self._bump("requests_total")
            self._bump("resumed")
        if self.journal is not None:
            self.journal.delivered(
                req.id,
                req.prompt,
                req.max_new_tokens,
                priority=req.priority,
                deadline_ms=req.deadline_ms,
            )
            with self._lock:
                self.journal.progress(req)
        return req

    # -- stream events ------------------------------------------------------

    def record_token(self, rid: str, ev: dict) -> list[dict]:
        """Fold a token chunk from replica ``rid``. Returns events to print."""
        client_id = ev.get("client_id") or split_namespaced_id(str(ev.get("id", "")))[1]
        with self._lock:
            req = self._requests.get(client_id)
            if req is None or req.stop_reason is not None:
                self._bump("suppressed_chunks")
                return []
            leg = req.legs.get(rid)
            if leg is None or not leg["open"]:
                # unknown leg, or one fail_replica already closed — the
                # journal fold is the authority for a dead replica's tail
                self._bump("suppressed_chunks")
                return []
            leg["tokens"].append(ev.get("token"))
            req.generation = max(req.generation, int(ev.get("generation", 0)))
            if req.winner is None and leg["base"] + len(leg["tokens"]) > req.emitted:
                req.winner = rid
                if leg.get("hedge"):
                    self._bump("hedge_wins")
            if rid != req.winner:
                self._bump("suppressed_chunks")
                return []
            if req.first_token_s is None:
                req.first_token_s = self.clock()
            self._last_traffic_s = self.clock()
            return self._flush_winner(req, rid)

    def record_done(self, rid: str, ev: dict) -> list[dict]:
        """Fold a done chunk. At most one terminal per client id, ever."""
        client_id = ev.get("client_id") or split_namespaced_id(str(ev.get("id", "")))[1]
        with self._lock:
            if client_id in self._finished:
                self._bump("duplicate_terminals_suppressed")
                return []
            req = self._requests.get(client_id)
            if req is None or req.stop_reason is not None:
                self._bump("duplicate_terminals_suppressed")
                return []
            leg = req.legs.get(rid)
            if leg is None or not leg["open"]:
                # a done from a leg fail_replica closed must not finish an
                # orphan the runtime is about to resubmit — one terminal,
                # one authority
                self._bump("duplicate_terminals_suppressed")
                return []
            leg["done"] = ev
            leg["open"] = False
            if req.winner is not None and req.winner != rid:
                self._bump("suppressed_chunks")
                return []
            req.winner = rid
            events = self._flush_winner(req, rid)
            if req.first_token_s is None and req.generated:
                req.first_token_s = self.clock()
            events.append(self._finish(req, rid, ev))
            self._last_traffic_s = self.clock()
            return events

    def synthesize_done(self, req: RoutedRequest, stop_reason: str) -> list[dict]:
        """Terminal produced by the router itself (e.g. replay budget spent)."""
        with self._lock:
            if req.id in self._finished or req.id not in self._requests:
                self._bump("duplicate_terminals_suppressed")
                return []
            done = {
                "type": "done",
                "stop_reason": stop_reason,
                "generation": req.generation,
            }
            return [self._finish(req, "router", done)]

    # -- hedging ------------------------------------------------------------

    def maybe_hedge(self, now: float) -> list[tuple[RoutedRequest, str]]:
        """Open hedge legs for requests whose projected TTFT breaches budget.

        Returns ``[(req, hedge_rid), ...]``; the runtime submits the legs
        (chaos + stdin writes stay outside the router lock).
        """
        hedged: list[tuple[RoutedRequest, str]] = []
        with self._lock:
            for req in self._requests.values():
                if req.stop_reason is not None or req.first_token_s is not None:
                    continue
                open_legs = [r for r, leg in req.legs.items() if leg["open"]]
                if len(open_legs) != 1:
                    continue
                budget_ms = req.deadline_ms if req.deadline_ms else self.hedge_ttft_ms
                if not budget_ms or budget_ms <= 0:
                    continue
                elapsed_ms = (now - req.arrival_s) * 1000.0
                primary = open_legs[0]
                projected = max(
                    elapsed_ms,
                    float(self._health.get(primary, {}).get("ttft_p99_ms", 0.0)),
                )
                if projected <= budget_ms:
                    continue
                candidates = [
                    rid
                    for rid in self._replicas
                    if rid not in self._evicted
                    and rid not in self._retiring
                    and rid not in req.legs
                    and float(self._health.get(rid, {}).get("queue_depth", 1.0)) == 0.0
                ]
                if not candidates:
                    continue
                rid = min(candidates, key=self._load)
                self._assigned_since_scrape[rid] = self._assigned_since_scrape.get(rid, 0) + 1
                req.legs[rid] = {
                    "base": req.emitted,
                    "tokens": [],
                    "done": None,
                    "open": True,
                    "hedge": True,
                }
                self._bump("hedges")
                self._note(
                    {"event": "hedged", "id": req.id, "replica": rid, "emitted": req.emitted}
                )
                hedged.append((req, rid))
        return hedged

    # -- elasticity ---------------------------------------------------------

    def scale_decision(self, now: float, breaches: int) -> tuple[str, str | None] | None:
        """SLO-burn scale-out / idle scale-in. Returns ("out", None),
        ("in", rid) or None."""
        with self._lock:
            if now - self._last_scale_s < self.scale_cooldown_s:
                return None
            live = len(self._replicas) - len(self._retiring)
            if breaches > self._last_breaches and live < self.max_replicas:
                self._last_breaches = breaches
                self._last_scale_s = now
                self._target = live + 1
                self._bump("scale_out_total")
                return ("out", None)
            self._last_breaches = breaches
            if (
                self.idle_retire_s > 0
                and live > self.min_replicas
                and self._inflight() == 0
                and not self._pending
                and now - self._last_traffic_s >= self.idle_retire_s
            ):
                candidates = [
                    rid for rid in self._replicas if rid not in self._retiring
                ]
                if not candidates:
                    return None
                rid = max(candidates)  # retire the youngest ordinal
                self._retiring.add(rid)
                self._last_scale_s = now
                self._target = live - 1
                self._bump("scale_in_total")
                self._note({"event": "replica_retiring", "replica": rid})
                return ("in", rid)
            return None

    def set_target(self, target: int) -> None:
        with self._lock:
            self._target = int(target)

    def target(self) -> int:
        with self._lock:
            return self._target

    def bump(self, name: str, delta: int = 1) -> None:
        with self._lock:
            self._bump(name, delta)

    def note(self, record: dict) -> None:
        with self._lock:
            self._note(record)

    def inflight(self) -> int:
        with self._lock:
            return self._inflight()

    def request_ids_inflight(self) -> list[str]:
        with self._lock:
            return [r.id for r in self._requests.values() if r.stop_reason is None]

    # -- observability ------------------------------------------------------

    def live_stats(self) -> dict:
        """``router/*`` gauges for the exporter's ``extra_fn``."""
        with self._lock:
            stats = {
                "router/replicas": float(len(self._replicas)),
                "router/replicas_target": float(self._target),
                "router/queue_depth": float(len(self._pending)),
                "router/inflight": float(self._inflight()),
                "router/peak_inflight": float(self._peak_inflight),
                "router/evicted": float(len(self._evicted)),
            }
            for name in (
                "requests_total",
                "requests_completed",
                "requests_failed",
                "duplicate_requests",
                "replays",
                "recovered_tokens",
                "hedges",
                "hedge_wins",
                "duplicate_terminals_suppressed",
                "suppressed_chunks",
                "failovers",
                "evictions",
                "leg_adoptions",
                "scale_out_total",
                "scale_in_total",
                "blackholed",
                "resumed",
            ):
                stats[f"router/{name}"] = float(self._counters.get(name, 0))
            return stats

    def stats(self) -> dict:
        stats = {k.replace("router/", "", 1): v for k, v in self.live_stats().items()}
        return stats


# --------------------------------------------------------------------------
# Runtime: the `route` CLI subcommand.  Everything below runs on the main
# thread (plus the stdin reader and per-replica stdout readers, which only
# touch thread-safe queues); chaos hooks and stdout printing live here,
# strictly outside the Router lock.
# --------------------------------------------------------------------------

_EOF = object()


def _publish_router_telemetry(run_dir: Path, stats: dict) -> None:
    """The CLI's run-telemetry publish for the router: overlay router
    gauges onto the last telemetry.jsonl record so `report` sees them."""
    path = Path(run_dir) / "telemetry.jsonl"
    record: dict = {}
    if path.exists():
        try:
            with path.open("r", encoding="utf-8") as handle:
                for line in handle:
                    line = line.strip()
                    if line:
                        try:
                            record = json.loads(line)
                        except json.JSONDecodeError:
                            continue
        except OSError:
            record = {}
    record.setdefault("step", 0)
    for key, value in stats.items():
        if isinstance(value, (int, float)):
            record[f"router/{key}"] = float(value)
    path.parent.mkdir(parents=True, exist_ok=True)
    with path.open("a", encoding="utf-8") as handle:
        handle.write(json.dumps(record) + "\n")


def _clean_replica_root(child_run_dir: Path) -> None:
    """The router is the sole replay authority: a respawned replica must
    never find a stale serve journal and self-replay (that would duplicate
    the router's own failover replay)."""
    for name in ("serve-journal.jsonl", "serve-journal.replaying.jsonl"):
        try:
            (child_run_dir / name).unlink()
        except OSError:
            pass


def _seed_checkpoints(seed_run_dir: Path | None, child_run_dir: Path) -> None:
    if seed_run_dir is None:
        return
    src = Path(seed_run_dir) / "checkpoints"
    dst = child_run_dir / "checkpoints"
    if src.is_dir() and not dst.exists():
        try:
            shutil.copytree(src, dst)
        except OSError:
            logger.warning("could not seed checkpoints into %s", dst)


def _provision_replica(
    router: Router,
    args,
    overrides: list[str],
    fleet_dir: Path,
    events: "queue.Queue[tuple[str, str, object]]",
) -> ReplicaHandle | None:
    """Spawn one `serve` child with an isolated run root + exporter port."""
    from llm_training_tpu_torch.cli.config import load_config
    from llm_training_tpu_torch.cli.main import _jsonl_run_dir
    from llm_training_tpu_torch.telemetry.exporter import find_free_port

    ordinal = router.next_ordinal()
    rid = f"r{ordinal}"
    root = Path(args.replica_run_root) / rid
    child_overrides = [*overrides, f"run_root={root}"]
    child_run_dir = Path(_jsonl_run_dir(load_config(args.config, child_overrides)))
    child_run_dir.mkdir(parents=True, exist_ok=True)
    _clean_replica_root(child_run_dir)
    _seed_checkpoints(args.seed_run_dir, child_run_dir)
    port = find_free_port()
    env = {
        key: value
        for key, value in os.environ.items()
        if not key.startswith("LLMT_CHAOS_ROUTER_")
    }
    env["LLMT_METRICS_PORT"] = str(port)
    env["LLMT_FLEET_DIR"] = str(fleet_dir)
    argv = [sys.executable, "-m", "llm_training_tpu_torch", "serve", "--config", args.config]
    if args.ckpt_path:
        argv += ["--ckpt-path", args.ckpt_path]
    argv += [a for a in args.serve_args if a != "--"]
    argv += [f"run_root={root}"]
    try:
        proc = subprocess.Popen(
            argv,
            stdin=subprocess.PIPE,
            stdout=subprocess.PIPE,
            stderr=sys.stderr,
            text=True,
            env=env,
        )
    except OSError as exc:
        logger.error("failed to spawn replica %s: %s", rid, exc)
        return None
    handle = ReplicaHandle(
        rid=rid,
        proc=proc,
        events=events,
        run_dir=child_run_dir,
        port=port,
        started_s=time.monotonic(),
    )
    router.register_replica(handle)
    logger.info("replica %s up: pid=%d port=%d run_dir=%s", rid, proc.pid, port, child_run_dir)
    return handle


def _leg_record(req: RoutedRequest, rid: str, clock=time.monotonic) -> dict:
    """The JSONL record submitted to a replica for one leg of a request.

    Delivered tokens are folded into the prompt (the `submit_resumed`
    watermark semantics) so replays and hedges never re-stream them; ids are
    namespaced per replica so journal folds never collide."""
    record = {
        "id": namespaced_id(rid, req.id),
        "prompt": list(req.prompt) + list(req.generated),
        "max_new_tokens": max(1, req.max_new_tokens - len(req.generated)),
        "priority": req.priority,
    }
    if req.deadline_ms is not None:
        elapsed_ms = (clock() - req.arrival_s) * 1000.0
        record["deadline_ms"] = max(1.0, float(req.deadline_ms) - elapsed_ms)
    return record


def route_main(args) -> int:
    from llm_training_tpu_torch.cli.config import load_config
    from llm_training_tpu_torch.cli.main import _jsonl_run_dir
    from llm_training_tpu_torch.resilience.chaos import (
        config_from_env,
        get_chaos,
        install_chaos,
        uninstall_chaos,
    )
    from llm_training_tpu_torch.resilience.shutdown import GracefulShutdown
    from llm_training_tpu_torch.telemetry.exporter import (
        MetricsExporter,
        find_free_port,
        resolve_metrics_port,
    )
    from llm_training_tpu_torch.telemetry.fleet import FleetAggregator, resolve_scrape_interval
    from llm_training_tpu_torch.telemetry.registry import get_registry
    from llm_training_tpu_torch.telemetry.slo import build_slo_monitor
    from llm_training_tpu_torch.telemetry.trace import get_tracer

    logging.basicConfig(
        stream=sys.stderr,  # stdout is the JSONL protocol
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
        force=True,
    )

    overrides = [a for a in args.serve_args if "=" in a and not a.startswith("-")]
    config = load_config(args.config, overrides)
    run_dir = Path(_jsonl_run_dir(config))
    run_dir.mkdir(parents=True, exist_ok=True)
    if args.replica_run_root is None:
        args.replica_run_root = str(run_dir / "replicas")
    if args.seed_run_dir is None and (run_dir / "checkpoints").is_dir():
        args.seed_run_dir = str(run_dir)
    fleet_dir = Path(os.environ.get("LLMT_FLEET_DIR") or (run_dir / "router-fleet"))
    fleet_dir.mkdir(parents=True, exist_ok=True)
    os.environ["LLMT_FLEET_DIR"] = str(fleet_dir)

    min_replicas = max(1, int(args.replicas))
    max_replicas = max(min_replicas, int(args.max_replicas or min_replicas))
    scrape_interval = (
        float(args.scrape_interval_s)
        if args.scrape_interval_s is not None
        else resolve_scrape_interval()
    )

    registry = get_registry()
    chaos = install_chaos(config_from_env(), registry=registry)
    if chaos is not None:
        logger.info("chaos active: %s", chaos.config)
    shutdown = GracefulShutdown().install()
    tracer = get_tracer()
    tracer.attach_sink(run_dir / "trace.jsonl")

    # -- router journal: rotate + fold + resume (exactly-once across router
    # restarts, mirroring serve's own journal discipline) -------------------
    journal_path = run_dir / ROUTER_JOURNAL
    replaying_path = run_dir / ROUTER_JOURNAL_REPLAYING
    resumed_entries: list[dict] = []
    if journal_path.exists():
        shutil.move(str(journal_path), str(replaying_path))
    if replaying_path.exists():
        resumed_entries = replay_journal(str(replaying_path))
    journal = RequestJournal(str(journal_path))

    router = Router(
        journal=journal,
        hedge_ttft_ms=args.hedge_ttft_ms,
        min_replicas=min_replicas,
        max_replicas=max_replicas,
        scale_cooldown_s=args.scale_cooldown_s,
        idle_retire_s=args.idle_retire_s,
    )
    router.set_target(min_replicas)

    slo = build_slo_monitor(registry=registry, run_dir=run_dir)
    aggregator = FleetAggregator(fleet_dir=fleet_dir, interval_s=scrape_interval)
    aggregator.start(port=None)
    exporter = MetricsExporter(
        port=resolve_metrics_port() or find_free_port(),
        registry=registry,
        slo=slo,
        role="router",
        extra_fn=router.live_stats,
    )
    exporter.start()

    events: "queue.Queue[tuple[str, str, object]]" = queue.Queue()
    lines: "queue.Queue[object]" = queue.Queue()

    def read_stdin() -> None:
        try:
            for line in sys.stdin:
                lines.put(line)
        finally:
            lines.put(_EOF)

    threading.Thread(target=read_stdin, name="router-stdin", daemon=True).start()

    replica_stats: dict[str, dict] = {}
    tokens_forwarded = 0
    rc = 0

    def emit(event: dict) -> None:
        print(json.dumps(event), flush=True)

    def dispatch(req: RoutedRequest, exclude: tuple[str, ...] = ()) -> None:
        assigned = router.assign(req, exclude=exclude)
        if assigned is None:
            router.park(req)
            return
        rid, seq = assigned
        active_chaos = get_chaos()
        if active_chaos is not None and active_chaos.maybe_router_blackhole(seq):
            router.bump("blackholed")
            router.note({"event": "blackholed", "id": req.id, "replica": rid})
            tracer.instant("router", "blackhole", id=req.id, replica=rid)
            return  # leg stays open; only hedging/failover can finish this
        handle = router.replica(rid)
        if handle is None or not handle.submit(_leg_record(req, rid)):
            result = router.fail_replica(rid, folded=_fold_dead(rid, handle))
            _absorb_failover(rid, result)

    def _fold_dead(rid: str, handle: ReplicaHandle | None) -> list[dict]:
        if handle is None:
            return []
        try:
            return fold_replica_journals({rid: handle.journal_path})
        except OSError:
            return []

    def _absorb_failover(rid: str, result: dict) -> None:
        nonlocal tokens_forwarded
        for ev in result["events"]:
            emit(ev)
            if ev.get("type") == "token":
                tokens_forwarded += 1
            elif ev.get("type") == "done":
                _observe_done(ev)
        tracer.instant("router", "failover", replica=rid, orphans=len(result["orphans"]))
        for req in result["orphans"]:
            if len(req.generated) >= req.max_new_tokens:
                for ev in router.synthesize_done(req, "max_tokens"):
                    emit(ev)
                    _observe_done(ev)
                continue
            req.replays += 1
            router.bump("replays")
            router.note({"event": "replayed", "id": req.id, "emitted": req.emitted})
            dispatch(req)

    def _observe_done(ev: dict) -> None:
        if slo is None:
            return
        ok = ev.get("stop_reason") in COMPLETED_REASONS
        slo.observe_request(ttft_ms=ev.get("ttft_ms"), tpot_ms=ev.get("tpot_ms"), ok=ok)

    def _broadcast(record: dict) -> None:
        for handle in router.replicas():
            handle.submit(record)

    def _handle_chunk(rid: str, obj: dict) -> None:
        nonlocal tokens_forwarded
        kind = obj.get("type")
        if kind == "token":
            for ev in router.record_token(rid, obj):
                emit(ev)
                tokens_forwarded += 1
                active_chaos = get_chaos()
                if active_chaos is not None and active_chaos.maybe_router_kill_replica(
                    tokens_forwarded
                ):
                    handle = router.replica(rid)
                    if handle is not None and handle.alive():
                        tracer.instant("router", "chaos_kill_replica", replica=rid)
                        try:
                            os.kill(handle.proc.pid, signal.SIGKILL)
                        except OSError:
                            pass
        elif kind == "done":
            for ev in router.record_done(rid, obj):
                emit(ev)
                if ev.get("type") == "token":
                    tokens_forwarded += 1
                else:
                    _observe_done(ev)
        elif kind == "stats":
            replica_stats[rid] = obj.get("stats", {})
        elif kind == "error":
            out = dict(obj)
            nsid = str(obj.get("id", ""))
            if "::" in nsid:
                out["id"] = split_namespaced_id(nsid)[1]
            out["replica"] = rid
            emit(out)

    def _handle_eof(rid: str) -> None:
        handle = router.replica(rid)
        if handle is None:
            return
        try:
            returncode = handle.proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            handle.kill()
            returncode = handle.proc.wait()
        card = fleet_dir / f"replica-{handle.proc.pid}.json"
        if returncode == 0:
            router.retire_replica(rid)
            tracer.instant("router", "replica_retired", replica=rid)
            logger.info("replica %s retired cleanly", rid)
        else:
            logger.warning("replica %s died rc=%s; failing over", rid, returncode)
            try:
                card.unlink()
            except OSError:
                pass
            result = router.fail_replica(rid, folded=_fold_dead(rid, handle))
            _absorb_failover(rid, result)
            live = len(router.replicas())
            if not closing and live < router.target():
                tracer.instant("router", "replace_replica", replica=rid)
                _provision_replica(router, args, overrides, fleet_dir, events)

    # -- bring up the initial fleet ----------------------------------------
    for _ in range(min_replicas):
        _provision_replica(router, args, overrides, fleet_dir, events)

    for entry in resumed_entries:
        req = router.resume(entry)
        logger.info(
            "resumed %s at emitted=%d after router restart", req.id, req.emitted
        )
        if len(req.generated) >= req.max_new_tokens:
            for ev in router.synthesize_done(req, "max_tokens"):
                emit(ev)
        else:
            dispatch(req)
    if replaying_path.exists():
        replaying_path.unlink()

    open_stdin = True
    closing = False
    drain_deadline: float | None = None
    last_sweeps = -1
    last_hedge_check = 0.0

    try:
        while True:
            now = time.monotonic()
            if shutdown.requested and drain_deadline is None:
                drain_deadline = now + args.drain_timeout_s
                logger.info("shutdown requested: draining for up to %.1fs", args.drain_timeout_s)
            if drain_deadline is not None and now > drain_deadline:
                rc = 75
                break

            # stdin intake
            while open_stdin:
                try:
                    line = lines.get_nowait()
                except queue.Empty:
                    break
                if line is _EOF:
                    open_stdin = False
                    break
                text = str(line).strip()
                if not text:
                    continue
                try:
                    record = json.loads(text)
                except json.JSONDecodeError:
                    logger.warning("skipping malformed request line")
                    continue
                if "type" in record:
                    _broadcast(record)  # control plane: reload / profile
                    continue
                req = router.intake(record)
                if req is not None:
                    dispatch(req)

            # replica events
            try:
                kind, rid, obj = events.get(timeout=0.05)
            except queue.Empty:
                kind = None
            while kind is not None:
                if kind == "chunk":
                    _handle_chunk(rid, obj)
                elif kind == "eof":
                    _handle_eof(rid)
                try:
                    kind, rid, obj = events.get_nowait()
                except queue.Empty:
                    kind = None

            # fleet health: evictions on red/stale, once per fresh sweep
            snapshot = aggregator.snapshot()
            if snapshot.get("sweeps", 0) != last_sweeps:
                last_sweeps = snapshot.get("sweeps", 0)
                for rid_evicted in router.update_fleet(snapshot):
                    tracer.instant("router", "replica_evicted", replica=rid_evicted)
                    logger.warning("evicted %s from rotation (red/stale)", rid_evicted)

            # retry parked requests
            pending = router.take_pending()
            for req in pending:
                dispatch(req)

            # hedging
            if now - last_hedge_check >= 0.05:
                last_hedge_check = now
                for req, hedge_rid in router.maybe_hedge(now):
                    handle = router.replica(hedge_rid)
                    tracer.instant("router", "hedge", id=req.id, replica=hedge_rid)
                    if handle is not None:
                        handle.submit(_leg_record(req, hedge_rid))

            # elasticity
            if not closing:
                breaches = slo.breach_count() if slo is not None else 0
                decision = router.scale_decision(now, breaches)
                if decision is not None:
                    direction, target_rid = decision
                    if direction == "out":
                        tracer.instant("router", "scale_out", target=router.target())
                        logger.info("SLO burn: scaling out to %d replicas", router.target())
                        _provision_replica(router, args, overrides, fleet_dir, events)
                    else:
                        tracer.instant(
                            "router", "scale_in", replica=target_rid, target=router.target()
                        )
                        logger.info("idle: draining and retiring %s", target_rid)
                        handle = router.replica(target_rid)
                        if handle is not None:
                            handle.close_stdin()

            if not open_stdin and router.inflight() == 0 and not closing:
                closing = True
                for handle in router.replicas():
                    handle.close_stdin()
            if closing and not router.replicas():
                break
    finally:
        # terminal sweep: SIGTERM (preserving their journals) then reap
        for handle in router.replicas():
            if drain_deadline is not None and rc == 75:
                try:
                    handle.proc.send_signal(signal.SIGTERM)
                except OSError:
                    pass
            else:
                handle.close_stdin()
        deadline = time.monotonic() + 10.0
        for handle in router.replicas():
            timeout = max(0.1, deadline - time.monotonic())
            try:
                handle.proc.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                handle.kill()
            handle.join_reader(timeout=1.0)
        # drain any trailing chunks (final stats / dones raced with close)
        while True:
            try:
                kind, rid, obj = events.get_nowait()
            except queue.Empty:
                break
            if kind == "chunk":
                _handle_chunk(rid, obj)

        stats = router.stats()
        stats["tokens_forwarded"] = tokens_forwarded
        stats["replica_stats"] = replica_stats
        emit({"type": "stats", "stats": stats})
        _publish_router_telemetry(run_dir, stats)

        journal.close()
        if rc == 0:
            try:
                journal_path.unlink()
            except OSError:
                pass
        exporter.stop()
        aggregator.stop()
        tracer.detach_sink()
        uninstall_chaos()
        shutdown.uninstall()
    return rc
