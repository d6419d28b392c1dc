"""Request journal: accepted-but-unfinished serving work that survives the
process.

Counterpart of `llm_training_tpu/serve/journal.py`, in its file format
field for field: a journal one package writes, the other replays. The
contract is at-least-once execution with exactly-once termination: once
the engine accepts a request, the client is owed one terminal chunk, even
across a drain (SIGTERM -> exit 75) and a relaunch.

- `accepted` records land when the engine takes a request (id, prompt,
  budget, priority, deadline);
- `progress` records checkpoint the continuation (generated tokens, their
  logprobs and how many were already streamed), delta-encoded, on the
  engine's step cadence and always at drain;
- `done` records retire an id once its terminal chunk was delivered.

`replay_journal` folds the log: per id the last acceptance wins, ids with
a `done` after it are dropped, and what remains is resubmittable like an
eviction requeue (`ServingEngine.submit_resumed`): progress folded into
the prompt, the `emitted` watermark carried, so no token is streamed
twice. Torn tails and malformed lines are skipped.
"""

from __future__ import annotations

import json
import logging
import threading
from pathlib import Path

logger = logging.getLogger(__name__)


class RequestJournal:
    """Append-only jsonl writer for one serve process's request lifetimes.

    Every record is flushed as written: the journal's whole point is being
    readable after an abrupt death, and serve-step cadence is nowhere near
    syscall-bound. Writes are lock-serialized — the serve CLI journals
    deliveries from its stdin reader THREAD (so a line a hard death
    catches between read and submit still replays) while the engine
    journals progress from the step loop."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._file = open(self.path, "a")  # guarded by: _lock
        self._lock = threading.Lock()
        # last progress state written per id, so an unchanged request does
        # not grow the journal every step
        self._written: dict[str, tuple[int, int]] = {}  # guarded by: _lock

    # ------------------------------------------------------------ records

    def delivered(
        self,
        id: str,
        prompt: list[int],
        max_new_tokens: int,
        priority: int = 0,
        deadline_ms: float | None = None,
    ) -> None:
        """Record acceptance from raw protocol fields — the stdin reader's
        entry point, taken BEFORE the request ever reaches the engine so
        the delivered-but-not-yet-submitted window (a queue a SIGABRT
        would vaporize) is covered."""
        record = {
            "event": "accepted",
            "id": str(id),
            "prompt": [int(t) for t in prompt],
            "max_new_tokens": int(max_new_tokens),
            "priority": int(priority),
        }
        if deadline_ms is not None:
            record["deadline_ms"] = float(deadline_ms)
        with self._lock:
            self._written[record["id"]] = (-1, -1)  # force the first progress
            self._append(record)

    def accepted(self, request) -> None:
        self.delivered(
            request.id, request.prompt, request.max_new_tokens,
            priority=request.priority,
            deadline_ms=(
                # the absolute perf_counter deadline is meaningless in
                # another process; persist the original relative budget
                # (replay re-anchors at its own arrival)
                round(1000.0 * (request.deadline_s - request.arrival_s), 3)
                if request.deadline_s is not None else None
            ),
        )

    def progress(self, request) -> None:
        """Checkpoint the continuation state. Records are DELTA-encoded
        against the last one written for this id (`generated` within one
        acceptance only ever appends), so a long-lived stream journals
        O(tokens) total instead of O(tokens^2) at the default every-step
        cadence; `replay_journal` re-concatenates."""
        state = (len(request.generated), request.emitted)
        with self._lock:
            prev = self._written.get(request.id)
            if prev == state:
                return
            start = 0 if prev is None or prev[0] < 0 else prev[0]
            self._written[request.id] = state
            # logprobs ride the same delta window as `generated` (the
            # engine appends both together, so they share length); a
            # request without the attribute (router-side bookkeeping)
            # journals tokens only
            logprobs = getattr(request, "logprobs", None)
            record = {
                "event": "progress",
                "id": request.id,
                "generated_from": start,
                "generated": list(request.generated[start:]),
                "emitted": request.emitted,
            }
            if logprobs is not None:
                record["logprobs"] = [
                    None if lp is None else round(float(lp), 6)
                    for lp in logprobs[start:]
                ]
            self._append(record)

    def finished(self, request) -> None:
        with self._lock:
            self._written.pop(request.id, None)
            self._append({
                "event": "done",
                "id": request.id,
                "stop_reason": request.stop_reason,
            })

    def note(self, record: dict) -> None:
        """Append an auxiliary event record (e.g. the router's assignment /
        hedge / scale markers). `replay_journal` ignores unknown event
        types, so notes ride the same durable stream without affecting the
        fold — they exist for post-mortem forensics and tests."""
        with self._lock:
            self._append(dict(record))

    def _append(self, record: dict) -> None:
        """Write one record (caller holds the lock)."""
        try:
            self._file.write(json.dumps(record) + "\n")
            self._file.flush()
        except (OSError, ValueError):
            logger.exception("request journal write failed (record dropped)")

    def close(self) -> None:
        with self._lock:
            try:
                self._file.close()
            except OSError:
                logger.exception("request journal close failed")


def replay_journal(path: str | Path) -> list[dict]:
    """Fold a journal into the resubmittable remainder: one entry per
    accepted-but-unfinished id ({id, prompt, generated, emitted,
    max_new_tokens, priority, deadline_ms?}), in original acceptance
    order. Duplicate ids dedupe to the LAST acceptance; ids with a `done`
    after their last acceptance are dropped; torn/malformed lines are
    skipped."""
    path = Path(path)
    try:
        text = path.read_text()
    except OSError:
        return []
    entries: dict[str, dict] = {}
    order: list[str] = []
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            record = json.loads(line)
        except json.JSONDecodeError:
            continue  # torn tail from an abrupt death
        if not isinstance(record, dict):
            continue
        rid = record.get("id")
        event = record.get("event")
        if not isinstance(rid, str):
            continue
        if event == "accepted":
            try:
                entry = {
                    "id": rid,
                    "prompt": [int(t) for t in record["prompt"]],
                    "generated": [],
                    "logprobs": [],
                    "emitted": 0,
                    "max_new_tokens": int(record["max_new_tokens"]),
                    "priority": int(record.get("priority", 0)),
                }
            except (KeyError, TypeError, ValueError):
                continue
            if record.get("deadline_ms") is not None:
                entry["deadline_ms"] = float(record["deadline_ms"])
            if rid in entries:
                order.remove(rid)  # client reused the id: last wins
            entries[rid] = entry
            order.append(rid)
        elif event == "progress" and rid in entries:
            try:
                start = int(record.get("generated_from", 0))
                tokens = [int(t) for t in record["generated"]]
                current = entries[rid]["generated"]
                if start > len(current):
                    # a dropped record left a gap: keep the shorter known
                    # prefix — replay may re-stream, it must never invent
                    continue
                entries[rid]["generated"] = current[:start] + tokens
                # fold the parallel logprob delta; a record without one
                # (pre-logprob journal) pads with None so the entry's
                # logprobs stay aligned with generated
                raw_lps = record.get("logprobs")
                if raw_lps is None:
                    lps = [None] * len(tokens)
                else:
                    lps = [
                        None if lp is None else float(lp) for lp in raw_lps
                    ][: len(tokens)]
                    lps += [None] * (len(tokens) - len(lps))
                entries[rid]["logprobs"] = (
                    entries[rid]["logprobs"][:start] + lps
                )
                entries[rid]["emitted"] = int(record["emitted"])
            except (KeyError, TypeError, ValueError):
                continue
        elif event == "done" and rid in entries:
            del entries[rid]
            order.remove(rid)
    return [entries[rid] for rid in order]
