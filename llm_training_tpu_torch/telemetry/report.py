"""Render a post-hoc run summary from a run directory.

Counterpart of `llm_training_tpu/telemetry/report.py` (standard library
only), section for section and byte for byte: `python -m
llm_training_tpu_torch report <run_dir>` reads the artifacts the loggers
wrote (`metrics.jsonl`, `telemetry.jsonl`, `run_metadata.json`,
`trace.jsonl`, `fleet.json`, the profile manifests, `supervisor.jsonl`)
and prints a human-readable summary, or with `--format json` one
machine-readable object (`schema_version`). A key the port's run dir
does not write (the compiled step's `xla/*` gauges) reads as it reads in
JAX's report for a run dir without it: the section or line is left out.
It never touches the card, so it runs anywhere the run dir is mounted.
"""

from __future__ import annotations

import json
import statistics
import sys
from pathlib import Path

from llm_training_tpu_torch.telemetry.goodput import PHASES

_GIB = 1024.0**3


def _read_jsonl(path: Path) -> list[dict]:
    records = []
    if not path.exists():
        return records
    for line in path.read_text().splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            records.append(json.loads(line))
        except json.JSONDecodeError:
            continue  # tolerate a torn tail from a killed run
    return records


def _fmt_seconds(s: float) -> str:
    return f"{s:,.2f}"


def _last_with(records: list[dict], key: str) -> dict | None:
    for record in reversed(records):
        if key in record:
            return record
    return None


def _last_run_segment(records: list[dict]) -> list[dict]:
    """Run dirs are opened in append mode (a legitimate resume continues the
    step sequence), so re-running a fixed-name config stacks multiple runs
    in one file. A step-number RESET marks a new run — summarize only the
    newest segment rather than silently pooling runs."""
    start = 0
    previous = None
    for i, record in enumerate(records):
        step = record.get("step")
        if step is None:
            continue
        if previous is not None and step < previous:
            start = i
        previous = step
    return records[start:]


def _goodput_table(telemetry: dict) -> list[str]:
    total = float(telemetry.get("goodput/total_s", 0.0))
    lines = [
        "== Goodput ==",
        f"{'phase':<16} {'seconds':>12} {'share':>8}",
    ]
    for phase in PHASES + ("other",):
        seconds = float(telemetry.get(f"goodput/{phase}_s", 0.0))
        share = 100.0 * seconds / total if total > 0 else 0.0
        lines.append(f"{phase:<16} {_fmt_seconds(seconds):>12} {share:>7.1f}%")
    lines.append(f"{'total':<16} {_fmt_seconds(total):>12} {100.0 if total > 0 else 0.0:>7.1f}%")
    lines.append(f"goodput: {float(telemetry.get('goodput/goodput_pct', 0.0)):.1f}% of wall time in step compute")
    return lines


def _health_section(telemetry: dict) -> list[str]:
    """Model-health summary from the `health/*` + `nan_guard/*` gauges
    (docs/observability.md): guard counters, the worst layer group by grad
    norm and update ratio, and the MoE balance extremes. Rendered only when
    the run recorded health telemetry (health.every_n_steps set)."""
    numeric: dict[str, float] = {}
    for key, value in telemetry.items():
        if not (key.startswith("health/") or key.startswith("nan_guard/")):
            continue
        try:
            numeric[key] = float(value)
        except (TypeError, ValueError):
            continue
    if not numeric:
        return []

    def by_prefix(prefix: str) -> dict[str, float]:
        return {
            key[len(prefix):]: value
            for key, value in numeric.items()
            if key.startswith(prefix)
        }

    lines = ["", "== Health =="]
    non_finite = numeric.get("nan_guard/non_finite_steps")
    spikes = numeric.get("nan_guard/spike_steps")
    if non_finite is not None or spikes is not None:
        lines.append(
            f"nan_guard: non_finite_steps {int(non_finite or 0)}  "
            f"spike_steps {int(spikes or 0)}"
        )
    grad = by_prefix("health/grad_norm/")
    if grad:
        worst = max(grad, key=grad.get)
        lines.append(
            f"layer groups: {len(grad)}  "
            f"grad_norm max: {grad[worst]:.3g} ({worst})"
        )
    ratio = by_prefix("health/update_ratio/")
    if ratio:
        worst = max(ratio, key=ratio.get)
        lines.append(f"update_ratio max: {ratio[worst]:.3g} ({worst})")
    entropy = by_prefix("health/moe/router_entropy/")
    if entropy:
        coldest = min(entropy, key=entropy.get)
        line = f"moe: router_entropy min {entropy[coldest]:.3f} ({coldest})"
        share = by_prefix("health/moe/max_expert_share/")
        if share:
            hottest = max(share, key=share.get)
            line += f"  max_expert_share {share[hottest]:.3f} ({hottest})"
        lines.append(line)
        if "health/moe/dropped_rows" in numeric:
            lines.append(
                f"moe dropped: {numeric['health/moe/dropped_rows']:.0f} rows "
                f"({100.0 * numeric.get('health/moe/dropped_frac', 0.0):.3f}%)"
            )
    return lines


def _decode_section(telemetry: dict) -> list[str]:
    """Inference telemetry (`decode/*` from `generate`, `eval/*` from
    `evaluate` — docs/inference.md): rendered only when the run dir saw an
    inference invocation merge its gauges into telemetry.jsonl."""
    def num(key):
        try:
            return float(telemetry[key])
        except (KeyError, TypeError, ValueError):
            return None

    lines = []
    prefill = num("decode/prefill_time_s")
    tps = num("decode/tokens_per_sec")
    if prefill is not None or tps is not None:
        line = "generate:"
        if prefill is not None:
            line += f" prefill_time_s {prefill:.3f}"
        if tps is not None:
            line += f"  decode_tokens_per_sec {tps:,.1f}"
        new_tokens = num("decode/new_tokens")
        if new_tokens is not None:
            line += f"  new_tokens {int(new_tokens)}"
        lines.append(line)
        cache = num("decode/cache_bytes")
        if cache is not None:
            line = f"kv cache: {cache / _GIB:.3f} GiB"
            max_len = num("decode/max_length")
            if max_len is not None:
                line += f" ({int(max_len)} slots)"
            lines.append(line)
    nll = num("eval/nll_per_token")
    if nll is not None:
        line = f"evaluate: nll/token {nll:.4f}"
        ppl = num("eval/perplexity")
        if ppl is not None:
            line += f"  perplexity {ppl:.2f}"
        tokens = num("eval/tokens")
        if tokens is not None:
            line += f"  over {int(tokens):,} tokens"
        lines.append(line)
    if not lines:
        return []
    return ["", "== Inference =="] + lines


def _serving_section(telemetry: dict) -> list[str]:
    """Serving telemetry (`serve/*` from the `serve` CLI / loadgen —
    docs/serving.md#telemetry): throughput, latency percentiles, and
    paged-pool pressure. Rendered only when a serve invocation merged its
    gauges into telemetry.jsonl."""
    def num(key):
        try:
            return float(telemetry[key])
        except (KeyError, TypeError, ValueError):
            return None

    completed = num("serve/requests_completed")
    tps = num("serve/tokens_per_sec")
    if completed is None and tps is None:
        return []
    lines = ["", "== Serving =="]
    line = f"requests: {int(completed or 0)} completed"
    failed = num("serve/requests_failed")
    if failed:
        line += f", {int(failed)} failed"
    # shed load (deadline/overloaded) is reported apart from failures —
    # the engine protecting its SLO is not an error condition
    shed_requests = num("serve/requests_shed")
    if shed_requests:
        line += f", {int(shed_requests)} shed"
    evicted = num("serve/requests_evicted")
    if evicted:
        line += f", {int(evicted)} evictions"
    peak = num("serve/peak_running")
    if peak is not None:
        line += f" (peak concurrency {int(peak)})"
    lines.append(line)
    # resilience counters (docs/serving.md#resilience): shed / expired /
    # hot-reloaded / replayed — each omitted when absent (an older run's
    # telemetry predates them) and the whole line omitted when all are
    shed = num("serve/shed_total")
    expired = num("serve/deadline_total")
    generation = num("serve/weights_generation")
    replayed = num("serve/replayed_requests")
    parts = []
    if shed:
        parts.append(f"{int(shed)} shed (overloaded)")
    if expired:
        parts.append(f"{int(expired)} deadline-expired")
    if generation:
        parts.append(f"weights generation {int(generation)}")
    if replayed:
        parts.append(f"{int(replayed)} replayed from journal")
    if parts:
        lines.append("resilience: " + ", ".join(parts))
    if tps is not None:
        line = f"throughput: {tps:,.1f} tokens/s"
        per_chip = num("serve/tokens_per_sec_per_chip")
        if per_chip is not None:
            line += f" ({per_chip:,.1f}/chip)"
        tokens = num("serve/tokens_generated")
        if tokens is not None:
            line += f" over {int(tokens):,} tokens"
        lines.append(line)
    for stat, label in (("ttft", "ttft"), ("tpot", "tpot")):
        p50, p99 = num(f"serve/{stat}_p50_ms"), num(f"serve/{stat}_p99_ms")
        if p50 is not None:
            line = f"{label}: p50 {p50:,.1f} ms"
            if p99 is not None:
                line += f"  p99 {p99:,.1f} ms"
            lines.append(line)
    total = num("decode/cache_blocks_total")
    peak_blocks = num("decode/cache_peak_blocks_in_use")
    if total:
        line = f"kv pool: {int(total)} blocks, peak {int(peak_blocks or 0)} in use"
        line += f" ({100.0 * (peak_blocks or 0) / total:.0f}%)"
        leaked = num("decode/cache_blocks_in_use")
        if leaked:
            line += f" — {int(leaked)} still held at exit (leak?)"
        lines.append(line)
    return lines


def _rl_section(telemetry: dict) -> list[str]:
    """RL post-training telemetry (`rl/*` from the `rl-fit` CLI —
    docs/post-training.md): rounds, reward, rollout accounting, and the
    weight-sync / SLO-yield counters. Rendered only when an rl-fit
    invocation merged its gauges into telemetry.jsonl."""
    def num(key):
        try:
            return float(telemetry[key])
        except (KeyError, TypeError, ValueError):
            return None

    rounds = num("rl/rounds")
    collected = num("rl/rollouts_collected")
    if rounds is None and collected is None:
        return []
    lines = ["", "== RL =="]
    line = f"rounds: {int(rounds or 0)}"
    reward = num("rl/mean_reward")
    if reward is not None:
        line += f", final mean reward {reward:.4f}"
    lines.append(line)
    parts = [f"{int(collected or 0)} collected"]
    stale = num("rl/rollouts_stale_dropped")
    failed = num("rl/rollouts_failed")
    if stale:
        # stale = tokens from an older weights generation: dropped by
        # contract, never trained on (docs/post-training.md#generations)
        parts.append(f"{int(stale)} stale-dropped")
    if failed:
        parts.append(f"{int(failed)} shed/failed")
    submitted = num("rl/rollouts_submitted")
    if submitted is not None:
        parts.append(f"of {int(submitted)} submitted")
    lines.append("rollouts: " + ", ".join(parts))
    yields = num("rl/rollout_yields")
    user_done = num("rl/user_requests_done")
    parts = []
    if yields:
        parts.append(f"{int(yields)} SLO yield(s)")
    if user_done:
        parts.append(f"{int(user_done)} user requests served alongside")
    if parts:
        lines.append("arbitration: " + ", ".join(parts))
    return lines


def _router_section(telemetry: dict) -> list[str]:
    """Router telemetry (`router/*` from the `route` CLI —
    docs/serving.md#router): request census, failover/replay, hedging, and
    elasticity counters, with an exactly-once verdict. Rendered only when a
    route invocation merged its gauges into telemetry.jsonl."""
    def num(key):
        try:
            return float(telemetry[key])
        except (KeyError, TypeError, ValueError):
            return None

    total = num("router/requests_total")
    if total is None:
        return []
    lines = ["", "== Router =="]
    completed = num("router/requests_completed") or 0
    failed = num("router/requests_failed") or 0
    line = f"requests: {int(total)} routed, {int(completed)} completed"
    if failed:
        line += f", {int(failed)} failed"
    peak = num("router/peak_inflight")
    if peak is not None:
        line += f" (peak in-flight {int(peak)})"
    lines.append(line)
    line = (
        f"replicas: {int(num('router/replicas') or 0)} live, "
        f"target {int(num('router/replicas_target') or 0)}"
    )
    evictions = num("router/evictions")
    if evictions:
        line += f", {int(evictions)} evictions"
    lines.append(line)
    parts = []
    failovers = num("router/failovers")
    if failovers:
        parts.append(f"{int(failovers)} failovers")
    replays = num("router/replays")
    if replays:
        parts.append(f"{int(replays)} replays")
    recovered = num("router/recovered_tokens")
    if recovered:
        parts.append(f"{int(recovered)} tokens recovered from journals")
    adoptions = num("router/leg_adoptions")
    if adoptions:
        parts.append(f"{int(adoptions)} leg adoptions")
    if parts:
        lines.append("failover: " + ", ".join(parts))
    parts = []
    hedges = num("router/hedges")
    if hedges:
        parts.append(f"{int(hedges)} hedged")
    wins = num("router/hedge_wins")
    if wins:
        parts.append(f"{int(wins)} hedge wins")
    dup = num("router/duplicate_terminals_suppressed")
    if dup:
        parts.append(f"{int(dup)} duplicate terminals suppressed")
    if parts:
        lines.append("hedging: " + ", ".join(parts))
    parts = []
    out = num("router/scale_out_total")
    if out:
        parts.append(f"{int(out)} scale-out")
    scale_in = num("router/scale_in_total")
    if scale_in:
        parts.append(f"{int(scale_in)} scale-in")
    if parts:
        lines.append("elasticity: " + ", ".join(parts))
    # the failover proof in one line: every routed request got exactly one
    # terminal (completed + failed == total), or the run is called out red
    if completed + failed == total:
        lines.append(f"exactly-once: green ({int(total)}/{int(total)} terminals)")
    else:
        lines.append(
            "exactly-once: RED "
            f"({int(completed + failed)}/{int(total)} terminals)"
        )
    return lines


def _newest_json_record(
    dirs: list[Path], patterns: tuple[str, ...]
) -> tuple[dict, str] | None:
    """The newest JSON dict matching `patterns` reachable from `dirs`:
    first directory with any match wins the tie; within it, newest mtime
    then name (BENCH_rNN names sort by round). Unreadable/non-dict files
    return None — the caller's section degrades or is omitted."""
    candidates: list[Path] = []
    for d in dirs:
        if d is None or not d.is_dir():
            continue
        for pattern in patterns:
            candidates.extend(d.glob(pattern))
        if candidates:
            break
    if not candidates:
        return None
    newest = max(candidates, key=lambda p: (p.stat().st_mtime, p.name))
    try:
        record = json.loads(newest.read_text())
    except (OSError, json.JSONDecodeError):
        return None
    if not isinstance(record, dict):
        return None
    return record, newest.name


def _newest_bench_record(dirs: list[Path]) -> tuple[dict, str] | None:
    """The newest bench record reachable from `dirs`. Accepts both shapes:
    a raw bench.py summary record and its wrapper
    {n, cmd, rc, tail, parsed}."""
    found = _newest_json_record(dirs, ("BENCH_r*.json", "bench*.json"))
    if found is None:
        return None
    record, name = found
    if "parsed" in record:  # the wrapper record
        parsed = record.get("parsed")
        if not isinstance(parsed, dict):
            parsed = {"error": f"bench crashed before emitting a record "
                               f"(rc {record.get('rc')})"}
        record = parsed
    return record, name


def _perf_section(bench: tuple[dict, str] | None) -> list[str]:
    """Newest bench record (MFU, vs_baseline, flash blocks used, per-stage
    status — docs/performance.md). Omitted when no bench record is
    reachable from the run/bench dir."""
    if bench is None:
        return []
    record, name = bench
    header = ["", "== Perf ==", f"bench record: {name}"]
    try:
        return header + _perf_lines(record)
    except (KeyError, TypeError, ValueError, AttributeError):
        # the broad bench*.json glob (and its cwd fallback) can pick up a
        # foreign or malformed file — that must cost one honest line, not
        # crash the whole report for a run that never touched bench
        return header + ["unreadable bench record — malformed fields"]


def _perf_lines(record: dict) -> list[str]:
    lines = []
    value = record.get("value")
    if value is not None:
        line = f"mfu: {float(value):.4f}"
        if record.get("vs_baseline") is not None:
            line += f" (vs_baseline {float(record['vs_baseline']):.3f})"
        lines.append(line)
        extras = []
        if record.get("tokens_per_sec_per_chip") is not None:
            extras.append(f"tokens/sec/chip {float(record['tokens_per_sec_per_chip']):,.1f}")
        if record.get("sec_per_step") is not None:
            extras.append(f"sec_per_step {float(record['sec_per_step']):.4f}")
        if record.get("goodput_pct") is not None:
            extras.append(f"goodput {float(record['goodput_pct']):.1f}%")
        if extras:
            lines.append("  ".join(extras))
    else:
        lines.append(f"mfu: unavailable — {record.get('error', 'no value recorded')}")
    blocks = record.get("blocks") or {}
    if blocks:
        parts = [
            f"{kind} {int(bq)}x{int(bk)}"
            for kind, (bq, bk) in sorted(blocks.items())
        ]
        sources = record.get("block_sources") or {}
        src = ", ".join(f"{k} x{v}" for k, v in sorted(sources.items()))
        lines.append("flash blocks: " + "  ".join(parts) + (f"  (resolved: {src})" if src else ""))
    stages = record.get("stages") or {}
    if stages:
        parts = []
        for stage, info in stages.items():
            status = info.get("status", "?")
            part = f"{stage} {status}"
            if status == "error" and info.get("error"):
                part += f" ({info['error']})"
            parts.append(part)
        lines.append("stages: " + "  ".join(parts))
    if record.get("health_overhead_pct") is not None:
        lines.append(f"health_overhead_pct: {float(record['health_overhead_pct']):.2f}")
    if record.get("trace_overhead_pct") is not None:
        lines.append(f"trace_overhead_pct: {float(record['trace_overhead_pct']):.2f}")
    if record.get("decode_tokens_per_sec") is not None:
        lines.append(
            f"decode: {float(record['decode_tokens_per_sec']):,.1f} tokens/sec"
            + (f"  prefill {float(record['prefill_time_s']):.3f}s"
               if record.get("prefill_time_s") is not None else "")
        )
    return lines


def _newest_audit_record(dirs: list[Path]) -> tuple[dict, str] | None:
    """The newest shardcheck audit record (`--audit --json` output saved as
    audit*.json) reachable from `dirs`."""
    return _newest_json_record(dirs, ("audit*.json",))


def _newest_race_record(dirs: list[Path]) -> tuple[dict, str] | None:
    """The newest racecheck record (`--races --json` output saved as
    race*.json) reachable from `dirs` (precommit tees one next to
    audit.json)."""
    return _newest_json_record(dirs, ("race*.json",))


def _audit_section(
    audit: tuple[dict, str] | None,
    races: tuple[dict, str] | None,
    telemetry: dict,
) -> list[str]:
    """Newest shardcheck audit record (docs/static-analysis.md#audit):
    finding count, worst per-chip HBM estimate, and — when the run also
    recorded the measured `hbm/peak_bytes_in_use` gauge — the measured
    number next to the estimate so drift between the audit's model of HBM
    and reality is visible in one place. A race*.json from the `--races`
    gate adds its one-line summary (docs/static-analysis.md#racecheck).
    Omitted when neither record is reachable; a foreign/malformed record
    costs one honest line, mirroring `== Perf ==`."""
    if audit is None and races is None:
        return []
    lines = ["", "== Audit =="]
    if audit is not None:
        record, name = audit
        lines.append(f"audit record: {name}")
        try:
            lines.extend(_audit_lines(record, telemetry))
        except (KeyError, TypeError, ValueError, AttributeError):
            lines.append("unreadable audit record — malformed fields")
    if races is not None:
        record, name = races
        try:
            lines.extend(_race_lines(record, name))
        except (KeyError, TypeError, ValueError, AttributeError):
            lines.append(f"racecheck: unreadable race record {name} — malformed fields")
    return lines


def _race_lines(record: dict, name: str) -> list[str]:
    findings = record.get("findings")
    if not isinstance(findings, list):
        return [f"racecheck: unreadable race record {name} — malformed fields"]
    status = "FAIL" if findings else "OK"
    line = (
        f"racecheck: {status} — {len(findings)} finding(s) "
        f"(record {name}"
    )
    suppressed = record.get("suppressed")
    if suppressed:
        line += f", {int(suppressed)} suppressed"
    baselined = record.get("baselined")
    if baselined:
        line += f", {int(baselined)} baselined"
    line += ")"
    lines = [line]
    by_rule: dict[str, int] = {}
    for finding in findings:
        rule = finding.get("rule", "?") if isinstance(finding, dict) else "?"
        by_rule[rule] = by_rule.get(rule, 0) + 1
    if by_rule:
        lines.append(
            "race findings: "
            + "  ".join(f"{r} x{n}" for r, n in sorted(by_rule.items()))
        )
    return lines


def _audit_lines(record: dict, telemetry: dict) -> list[str]:
    lines = []
    findings = record.get("findings")
    families = record.get("families") or []
    meshes = record.get("meshes") or []
    if findings is None:
        lines.append(
            f"audit: unavailable — {record.get('error', 'no findings recorded')}"
        )
        return lines
    status = "FAIL" if findings else "OK"
    line = (
        f"shardcheck: {status} — {len(findings)} finding(s), "
        f"{len(families)} family(ies) x {len(meshes)} mesh(es)"
    )
    baselined = record.get("baselined")
    if baselined:
        line += f", {int(baselined)} baselined"
    lines.append(line)
    by_rule: dict[str, int] = {}
    for finding in findings:
        by_rule[finding.get("rule", "?")] = by_rule.get(finding.get("rule", "?"), 0) + 1
    if by_rule:
        lines.append(
            "findings: " + "  ".join(f"{r} x{n}" for r, n in sorted(by_rule.items()))
        )
    worst = worst_estimate(record.get("estimates") or {})
    if worst is not None:
        line = f"worst per-chip HBM estimate: {worst[2]:.3f} GiB ({worst[0]} @ {worst[1]}"
        budget = record.get("hbm_budget_gib")
        if budget is not None:
            line += f", budget {float(budget):.1f} GiB"
        line += ")"
        lines.append(line)
        measured = telemetry.get("hbm/peak_bytes_in_use")
        if measured is not None:
            # the audited families are the tiny registry proxies, not this
            # run's model — the cross-reference shows scale drift, not a
            # per-run prediction
            lines.append(
                f"measured hbm/peak_bytes_in_use: {float(measured) / _GIB:.3f} "
                "GiB (this run's model; audit estimates cover the registry "
                "families)"
            )
    return lines


def worst_estimate(estimates: dict) -> tuple[str, str, float] | None:
    """(family, mesh, total_gib) of the largest per-chip estimate of a
    shardcheck audit record (a copy of `worst_estimate` in JAX's
    `analysis/shard_audit.py`)."""
    worst: tuple[str, str, float] | None = None
    for family, family_json in estimates.items():
        for mesh, cell in family_json.get("meshes", {}).items():
            total = float(cell.get("total_gib", 0.0))
            if worst is None or total > worst[2]:
                worst = (family, mesh, total)
    return worst


def _read_supervisor_events(path: Path) -> list[dict] | None:
    """Events from a supervisor.jsonl, or None when the file is absent OR
    empty (a zero-byte log left by a killed supervisor says nothing and
    must not force the elastic section into a run's report). A log with
    content but no parseable events returns [] so the section can say so
    honestly instead of crashing."""
    if not path.is_file():
        return None
    try:
        if path.stat().st_size == 0:
            return None
    except OSError:
        return []
    try:
        records = _read_jsonl(path)
    except OSError:
        return []
    return [
        record for record in records
        if isinstance(record, dict) and "event" in record
    ]


def _elastic_section(
    telemetry_records: list[dict], supervisor_events: list[dict] | None
) -> list[str]:
    """Per-segment topology + aggregated goodput-per-dollar
    (docs/resilience.md#elastic).

    Two independent sources, each degrading on its own: `segment_topology`
    / `exit` events from supervisor.jsonl (the per-segment worlds), and the
    `elastic/segment`-tagged telemetry records (each segment's cumulative
    goodput/cost gauges — the LAST record per segment is its total).
    Omitted entirely for runs with nothing elastic to say: a single
    unsupervised segment with no chip-price metadata renders no section."""
    # last telemetry record per segment (cumulative gauges -> totals)
    segments: dict[int, dict] = {}
    for record in telemetry_records:
        seg = record.get("elastic/segment")
        if seg is None:
            continue
        try:
            segments[int(float(seg))] = record
        except (TypeError, ValueError):
            continue
    topology: dict[int, dict] = {}
    exits: dict[int, dict] = {}
    malformed_log = supervisor_events == []
    for event in supervisor_events or ():
        try:
            attempt = int(event.get("attempt", 0))
        except (TypeError, ValueError):
            continue
        if event.get("event") == "segment_topology":
            topology[attempt] = event
        elif event.get("event") == "exit":
            exits[attempt] = event

    has_cost = any("goodput/cost_dollars" in r for r in segments.values())
    if not topology and not malformed_log and not (
        has_cost or len(segments) > 1
    ):
        return []

    lines = ["", "== Elastic =="]
    if malformed_log:
        lines.append(
            "supervisor log present but unreadable — per-segment topology "
            "unavailable"
        )
    attempts = sorted(set(topology) | set(segments))
    for attempt in attempts:
        parts = [f"segment #{attempt}:"]
        event = topology.get(attempt)
        record = segments.get(attempt, {})
        chips = (
            event.get("device_count") if event is not None
            else record.get("goodput/chip_count")
        )
        # every field below may come from a foreign/corrupted-but-parseable
        # log: degrade per field, never crash the report
        try:
            parts.append(f"{int(float(chips))} device(s)")
        except (TypeError, ValueError):
            pass
        mesh = (event or {}).get("mesh")
        if isinstance(mesh, dict) and mesh:
            shown = [f"data={mesh.get('data', '?')}"]
            for axis, size in sorted(mesh.items()):
                try:
                    if axis != "data" and int(size) != 1:
                        shown.append(f"{axis}={size}")
                except (TypeError, ValueError):
                    continue
            parts.append("mesh " + " ".join(shown))
        if (event or {}).get("decision"):
            parts.append(f"[{event['decision']}]")
        runtime = exits.get(attempt, {}).get("runtime_s")
        if runtime is None and "goodput/total_s" in record:
            runtime = record["goodput/total_s"]
        if runtime is not None:
            try:
                parts.append(f"runtime {float(runtime):,.1f}s")
            except (TypeError, ValueError):
                pass
        if "goodput/cost_dollars" in record:
            try:
                parts.append(f"cost ${float(record['goodput/cost_dollars']):,.4f}")
            except (TypeError, ValueError):
                pass
        exit_event = exits.get(attempt)
        if exit_event is not None:
            parts.append(
                f"exit {exit_event.get('signal') or exit_event.get('rc')}"
            )
        lines.append("  ".join(parts))

    def total(key: str) -> float | None:
        values = []
        for record in segments.values():
            if key in record:
                try:
                    values.append(float(record[key]))
                except (TypeError, ValueError):
                    pass
        return sum(values) if values else None

    chip_hours = total("goodput/chip_hours")
    if chip_hours is not None:
        lines.append(
            f"chip-time: {chip_hours:.4f} chip-hours across "
            f"{len(segments)} segment(s)"
        )
    cost = total("goodput/cost_dollars")
    productive = total("goodput/productive_chip_hours")
    if cost is not None:
        line = f"cost: ${cost:,.4f}"
        if productive is not None and cost > 0:
            line += (
                f"  goodput-per-dollar: {productive / cost:.3f} "
                "productive chip-hours / $"
            )
        lines.append(line)
    elif segments or topology:
        lines.append(
            "cost: unavailable (no $/chip-hour — set LLMT_CHIP_PRICE_PER_HOUR "
            "or trainer.resilience.elastic.price_per_chip_hour)"
        )
    return lines


def _trace_summary(run_dir: Path) -> dict | None:
    """Span aggregates + slowest-request breakdowns from the run dir's
    trace.jsonl (docs/observability.md#tracing), or None when the run never
    traced. A present-but-unparseable file returns an `events: 0` summary
    so the section can say so honestly."""
    from llm_training_tpu_torch.telemetry.trace import read_trace_events, summarize_trace

    path = run_dir / "trace.jsonl"
    if not path.is_file():
        return None
    return summarize_trace(read_trace_events(path))


def _fleet_summary(run_dir: Path) -> dict | None:
    """The fleet snapshot a `fleet --out <run_dir>/fleet.json` sweep left
    behind (docs/observability.md#fleet), shaped for trend tracking:
    verdict + per-replica health + rollups, without the per-replica
    metric bulk. None when the run never swept a fleet; a
    present-but-unparseable file returns an honest error record."""
    path = run_dir / "fleet.json"
    if not path.is_file():
        return None
    try:
        snapshot = json.loads(path.read_text())
    except (OSError, json.JSONDecodeError):
        return {"error": f"{path.name} unparseable"}
    if not isinstance(snapshot, dict):
        return {"error": f"{path.name} is not a snapshot object"}
    replicas = {}
    for rid, entry in (snapshot.get("replicas") or {}).items():
        if isinstance(entry, dict):
            replicas[rid] = {
                key: entry.get(key)
                for key in ("role", "healthy", "stale", "error", "attempt")
            }
    return {
        "verdict": snapshot.get("verdict"),
        "sweeps": snapshot.get("sweeps"),
        "replicas": replicas,
        "red": snapshot.get("red"),
        "stale_cards": snapshot.get("stale_cards"),
        "rollup": snapshot.get("rollup"),
    }


def _fleet_section(summary: dict | None) -> list[str]:
    """`== Fleet ==`: the persisted sweep's verdict, red/stale names, and
    the serve rollups. Omitted when the run has no fleet.json."""
    if summary is None:
        return []
    lines = ["", "== Fleet =="]
    if summary.get("error"):
        lines.append(f"  {summary['error']}")
        return lines
    replicas = summary.get("replicas") or {}
    lines.append(
        f"  verdict: {str(summary.get('verdict', '?')).upper()} "
        f"({len(replicas)} replica(s))"
    )
    for rid in summary.get("red") or []:
        entry = replicas.get(rid) or {}
        lines.append(f"  red: {rid} — {entry.get('error') or 'unhealthy'}")
    for rid in summary.get("stale_cards") or []:
        lines.append(f"  stale card: {rid}")
    rollup = summary.get("rollup") or {}
    for key in sorted(rollup):
        if key.startswith("llmt_fleet_serve_") and not key.endswith(
            ("_min", "_mean", "_max")
        ):
            lines.append(f"  {key} = {float(rollup[key]):.3f}")
    return lines


def _trace_section(summary: dict | None) -> list[str]:
    """`== Trace ==`: per-phase span aggregates and the top-k slowest
    requests with their queue/prefill/decode breakdowns. Omitted when the
    run has no trace.jsonl; degrades to one honest line on a malformed or
    empty one."""
    if summary is None:
        return []
    lines = ["", "== Trace =="]
    try:
        if not summary.get("events"):
            lines.append("trace.jsonl present but holds no parseable events")
            return lines
        lines.append(
            f"events: {int(summary['events'])}  "
            f"requests traced: {int(summary.get('requests_traced', 0))} "
            f"({int(summary.get('requests_completed', 0))} completed)"
        )
        spans = summary.get("spans") or {}
        if spans:
            lines.append(f"{'span':<24} {'count':>6} {'total_s':>10} {'mean_ms':>9}")
            for name, agg in sorted(spans.items()):
                count = int(agg["count"])
                total = float(agg["total_s"])
                lines.append(
                    f"{name:<24} {count:>6} {total:>10.3f} "
                    f"{1000.0 * total / count:>9.2f}"
                )
        slowest = summary.get("slowest_requests") or []
        if slowest:
            lines.append("slowest requests:")
            for request in slowest:
                parts = [f"  {request['id']}: {float(request['wall_ms']):,.1f} ms"]
                breakdown = "  ".join(
                    f"{phase} {float(request.get(f'{phase}_ms', 0.0)):,.1f}"
                    for phase in ("queue", "prefill", "decode")
                )
                parts.append(f"({breakdown} ms)")
                if request.get("ttft_ms") is not None:
                    parts.append(f"ttft {float(request['ttft_ms']):,.1f} ms")
                if request.get("evictions"):
                    parts.append(f"{int(request['evictions'])} eviction(s)")
                lines.append("  ".join(parts))
    except (KeyError, TypeError, ValueError, AttributeError):
        return ["", "== Trace ==", "unreadable trace summary — malformed fields"]
    return lines


def _slo_section(telemetry: dict) -> list[str]:
    """SLO targets vs reality (`slo/*` gauges from telemetry/slo.py —
    docs/observability.md#slo): per-target line (target, worst observed,
    breach count) plus the totals line with the last breach's step /
    request ordinal. Omitted entirely when the run armed no SLO config —
    no slo/ keys, no section."""
    numeric: dict[str, float] = {}
    for key, value in telemetry.items():
        if not key.startswith("slo/"):
            continue
        try:
            numeric[key] = float(value)
        except (TypeError, ValueError):
            continue
    if not numeric:
        return []
    lines = ["", "== SLO =="]
    targets = sorted(
        key[len("slo/"):-len("/target")]
        for key in numeric if key.endswith("/target")
    )
    for name in targets:
        line = f"{name}: target {numeric[f'slo/{name}/target']:g}"
        worst = numeric.get(f"slo/{name}/worst")
        if worst is not None:
            line += f"  worst {worst:g}"
        breaches = numeric.get(f"slo/{name}/breaches", 0.0)
        line += f"  breaches {int(breaches)}"
        burn = numeric.get(f"slo/{name}/burn_fast")
        if burn is not None:
            line += f"  (burn {burn:.1f}x fast"
            slow = numeric.get(f"slo/{name}/burn_slow")
            if slow is not None:
                line += f" / {slow:.1f}x slow"
            line += ")"
        lines.append(line)
    total = numeric.get("slo/breaches_total", 0.0)
    line = f"breaches: {int(total)} total"
    last_step = numeric.get("slo/last_breach_step")
    if last_step is not None:
        line += f"  last at step {int(last_step)}"
    last_request = numeric.get("slo/last_breach_request_n")
    if last_request is not None:
        line += f"  last at request #{int(last_request)}"
    lines.append(line)
    return lines


def _profile_manifests(run_dir: Path) -> list[dict]:
    """Capture manifests (`profile-<tag>.json`, written by the
    ProfileTrigger next to each trace dir). A torn/unreadable manifest
    keeps its slot with an `error` field — the capture HAPPENED even if
    the record of it is damaged, and the report must say so."""
    entries: list[dict] = []
    for path in sorted(run_dir.glob("profile-*.json")):
        try:
            record = json.loads(path.read_text())
            if not isinstance(record, dict):
                raise ValueError("manifest must be a JSON object")
            record["file"] = path.name
            entries.append(record)
        except (OSError, ValueError) as e:
            entries.append({
                "file": path.name,
                "error": f"unreadable manifest ({type(e).__name__})",
            })
    return entries


def _profiling_summary(run_dir: Path, telemetry: dict) -> dict | None:
    """The structured `profiling` block (docs/observability.md#profiling):
    trigger counters, capture manifests, and the compiled-program
    compute/comm attribution gauges. None when the run recorded none of
    them — a run that never armed the trigger stays unchanged."""
    counters = _numeric_subset(telemetry, ("profile/", "hbm_timeline/"))
    attribution = _numeric_subset(telemetry, ("attr/",))
    captures = _profile_manifests(run_dir)
    if not counters and not attribution and not captures:
        return None
    return {
        "counters": counters or {},
        "attribution": attribution,
        "captures": captures,
    }


def _profiling_section(summary: dict | None) -> list[str]:
    """`== Profiling ==`: trigger activity (captures vs suppressions —
    the suppressed count is the budget/cooldown doing its job), one line
    per capture manifest, the static compute/comm attribution split, and
    the HBM timeline tally. Omitted when the run profiled nothing."""
    if summary is None:
        return []
    try:
        lines = ["", "== Profiling =="]
        counters = summary["counters"]
        requested = int(counters.get("profile/requested", 0.0))
        captures = int(counters.get("profile/captures", 0.0))
        suppressed = int(counters.get("profile/suppressed", 0.0))
        if requested or captures or suppressed:
            lines.append(
                f"captures: {captures} (requested {requested}, "
                f"suppressed {suppressed})"
            )
        errors = counters.get("profile/errors")
        if errors:
            lines.append(f"capture errors: {int(errors)}")
        for record in summary["captures"]:
            name = str(record.get("file", "?"))
            try:
                if record.get("error"):
                    lines.append(f"{name}: {record['error']}")
                    continue
                line = (
                    f"{name}: steps {int(record['start_step'])}"
                    f"..{int(record['stop_step'])}"
                )
                if record.get("duration_s") is not None:
                    line += f", {float(record['duration_s']):.2f}s"
                if record.get("source"):
                    line += f" ({record['source']})"
                lines.append(line)
            except (KeyError, TypeError, ValueError):
                # honest per-capture degrade: a torn manifest costs its
                # own line, never the section
                lines.append(f"{name}: unreadable manifest — malformed fields")
        attribution = summary["attribution"]
        if attribution:
            frac = attribution.get("attr/comm_fraction")
            if frac is not None:
                lines.append(
                    f"comm fraction: {100.0 * frac:.1f}% of bytes accessed"
                )
            flops = attribution.get("attr/flops_per_step")
            if flops is not None:
                lines.append(f"flops/step: {flops:.3g}")
            cbytes = attribution.get("attr/collective_bytes_per_step")
            if cbytes is not None:
                ops = int(attribution.get("attr/collective_ops", 0.0))
                lines.append(
                    f"collective bytes/step: {cbytes:,.0f} ({ops} op(s))"
                )
            for key in sorted(attribution):
                if key.startswith("attr/mesh/") and attribution[key]:
                    axis = key[len("attr/mesh/"):].rsplit("/", 1)[0]
                    lines.append(f"  mesh {axis}: {attribution[key]:,.0f} B")
            decode_frac = attribution.get("attr/decode/comm_fraction")
            if decode_frac is not None:
                lines.append(
                    f"decode comm fraction: {100.0 * decode_frac:.1f}%"
                )
        records = counters.get("hbm_timeline/records")
        if records:
            line = f"hbm timeline: {int(records)} record(s)"
            highwater = counters.get("hbm_timeline/highwater_events")
            if highwater:
                line += f", {int(highwater)} high-water crossing(s)"
            if counters.get("hbm_timeline/truncated"):
                line += " (truncated at cap)"
            lines.append(line)
        return lines
    except (KeyError, TypeError, ValueError):
        return ["", "== Profiling ==", "unreadable profiling data — malformed fields"]


def _counter_section(title: str, rows: list[tuple[str, str]], telemetry: dict) -> list[str]:
    """An event-counter section: one `label: count` line per nonzero
    counter, the whole section omitted when nothing fired — a clean run's
    report stays unchanged."""
    lines = []
    for key, label in rows:
        try:
            value = float(telemetry.get(key, 0.0))
        except (TypeError, ValueError):
            continue
        if value:
            lines.append(f"{label}: {int(value)}")
    if not lines:
        return []
    return ["", f"== {title} =="] + lines


def _recovery_section(telemetry: dict) -> list[str]:
    """Self-healing events (`resilience/rollbacks` etc. —
    docs/resilience.md#recovery)."""
    return _counter_section("Recovery", [
        ("resilience/rollbacks", "in-process rollbacks (rewind + resume)"),
        ("resilience/skip_windows", "poisoned data windows skipped"),
        ("resilience/skipped_steps", "micro-steps served from the reserve pool"),
        ("resilience/lr_cooldowns", "temporary LR cooldowns applied"),
        ("resilience/recovery_escalations", "recovery escalations (budget/same-step)"),
    ], telemetry)


def _resilience_section(telemetry: dict) -> list[str]:
    """Fault-tolerance event counters (`resilience/*` plus the retry
    counters — docs/resilience.md)."""
    return _counter_section("Resilience", [
        ("resilience/preemptions", "preemptions (graceful shutdowns)"),
        ("resilience/emergency_saves", "emergency checkpoint saves"),
        ("resilience/restore_fallbacks", "restore fallbacks (corrupt step skipped)"),
        ("resilience/watchdog_dumps", "watchdog hang dumps"),
        ("resilience/chaos_injections", "chaos-injected faults"),
        ("data/retries", "data-source retries"),
        ("checkpoint/retries", "checkpoint I/O retries"),
    ], telemetry)


def _durability_section(telemetry: dict) -> list[str]:
    """Checkpoint durability plane (docs/resilience.md#durability):
    verify/heal/scrub event counters plus the mirror's end-of-run state.
    Omitted entirely for runs with no mirror and no findings — like the
    other event sections, a clean unmirrored run's report is unchanged."""
    lines = _counter_section("Durability", [
        ("checkpoint/verify_failures",
         "checkpoint verify failures (offending file named in the log)"),
        ("checkpoint/mirror_restores", "restores healed from the mirror"),
        ("ckpt/mirror_verify_rejects",
         "mirror copies rejected by re-verification"),
        ("ckpt/gc_deleted", "mirror steps deleted by retention GC"),
        ("ckpt/scrub_ok", "scrub verifications passed"),
        ("ckpt/scrub_failures", "scrub verifications FAILED"),
    ], telemetry)
    if "ckpt/mirrored_steps" in telemetry:
        try:
            mirrored = int(float(telemetry["ckpt/mirrored_steps"]))
            lag = int(float(telemetry.get("ckpt/mirror_lag_steps", 0)))
        except (TypeError, ValueError):
            return lines
        if not lines:
            lines = ["", "== Durability =="]
        lines.append(f"mirrored steps: {mirrored} (lag {lag} step(s))")
    return lines


def _load_run(run_dir: Path) -> tuple[list[dict], list[dict], dict]:
    """(metrics, telemetry_records, telemetry-total) for the NEWEST run
    segment — the one loader both the text and JSON renderers consume, so
    segment handling can never drift between them."""
    metrics = _read_jsonl(run_dir / "metrics.jsonl")
    telemetry_records = _last_run_segment(_read_jsonl(run_dir / "telemetry.jsonl"))
    if not metrics and not telemetry_records:
        raise FileNotFoundError(
            f"no metrics.jsonl or telemetry.jsonl records under {run_dir}"
            " — is this a run directory?"
        )
    # serve/router run dirs are telemetry-only (no fit loop, no
    # metrics.jsonl): render from the telemetry ledger alone
    metrics = _last_run_segment(metrics)
    # the ledger is cumulative, so the newest record is the run total; fall
    # back to goodput keys embedded in metrics.jsonl (older runs / W&B-only)
    telemetry = (
        telemetry_records[-1]
        if telemetry_records
        else (_last_with(metrics, "goodput/total_s") or {})
    )
    return metrics, telemetry_records, telemetry


def _read_world(run_dir: Path) -> dict | None:
    meta_path = run_dir / "run_metadata.json"
    if not meta_path.exists():
        return None
    try:
        meta = json.loads(meta_path.read_text())
        world = meta.get("world", meta)
        return world if isinstance(world, dict) else None
    except Exception:
        return None


def _training_summary(metrics: list[dict]) -> dict | None:
    """The training-section numbers, shared by both renderers. None only
    when the run logged neither train-loss nor val-loss records."""
    train = [r for r in metrics if "loss" in r]
    last_tokens = _last_with(metrics, "consumed_tokens")
    val = _last_with(metrics, "val_loss")
    if not train and not val:
        return None
    steps = [int(r["step"]) for r in train if "step" in r]
    losses = [float(r["loss"]) for r in train]
    sps = [float(r["steps_per_sec"]) for r in train if "steps_per_sec" in r]
    return {
        "records": len(train),
        "step_min": min(steps) if steps else None,
        "step_max": max(steps) if steps else None,
        "loss_first": losses[0] if losses else None,
        "loss_last": losses[-1] if losses else None,
        "loss_min": min(losses) if losses else None,
        "steps_per_sec_median": statistics.median(sps) if sps else None,
        "steps_per_sec_last": sps[-1] if sps else None,
        "consumed_tokens": (
            int(last_tokens["consumed_tokens"]) if last_tokens else None
        ),
        "consumed_samples": (
            int(last_tokens.get("consumed_samples", 0)) if last_tokens else None
        ),
        "val_loss": float(val["val_loss"]) if val else None,
        "val_step": val.get("step") if val else None,
    }


def render_report(
    run_dir: str | Path,
    bench_dir: str | Path | None = None,
    supervisor_log: str | Path | None = None,
    audit_dir: str | Path | None = None,
) -> str:
    run_dir = Path(run_dir)
    metrics, telemetry_records, telemetry = _load_run(run_dir)

    lines = [f"Run report: {run_dir}"]
    world = _read_world(run_dir)
    if world:
        parts = [
            f"{key}={world[key]}"
            for key in ("backend", "device_kind", "device_count", "num_processes")
            if key in world
        ]
        if parts:
            lines.append("env: " + "  ".join(parts))

    training = _training_summary(metrics)
    lines.append("")
    lines.append("== Training ==")
    if training and training["records"]:
        lines.append(
            f"logged steps: {training['step_min']}..{training['step_max']} "
            f"({training['records']} records)"
        )
        lines.append(
            f"loss: first {training['loss_first']:.4f} -> last "
            f"{training['loss_last']:.4f} (min {training['loss_min']:.4f})"
        )
        if training["steps_per_sec_median"] is not None:
            lines.append(
                f"steps_per_sec: median {training['steps_per_sec_median']:.3f} "
                f"(last {training['steps_per_sec_last']:.3f})"
            )
        if training["consumed_tokens"] is not None:
            lines.append(
                f"consumed: {training['consumed_tokens']:,} tokens, "
                f"{training['consumed_samples']:,} samples"
            )
    if training and training["val_loss"] is not None:
        lines.append(
            f"val_loss: {training['val_loss']:.4f} "
            f"(step {training['val_step'] if training['val_step'] is not None else '?'})"
        )

    # MFU: the time estimator publishes perf/* gauges into telemetry
    for key, label in (
        ("perf/mfu", "MFU (analytic 6N+attention)"),
        ("perf/mfu_xla", "MFU (XLA cost_analysis)"),
        ("perf/tokens_per_sec", "tokens/sec"),
        ("perf/tokens_per_sec_per_device", "tokens/sec/device"),
    ):
        if key in telemetry:
            value = float(telemetry[key])
            lines.append(
                f"{label}: {value:.4f}" if "mfu" in key else f"{label}: {value:,.1f}"
            )
    if "compile_time_s" in telemetry:
        lines.append(f"compile_time_s: {float(telemetry['compile_time_s']):.2f}")

    lines.append("")
    lines.extend(_goodput_table(telemetry))

    hbm_peak = telemetry.get("hbm/peak_bytes_in_use")
    hbm_limit = telemetry.get("hbm/bytes_limit")
    if hbm_peak is not None:
        lines.append("")
        lines.append("== Device memory ==")
        source = "host RSS fallback" if telemetry.get("hbm/host_fallback") else "HBM"
        peak_line = f"peak: {float(hbm_peak) / _GIB:.2f} GiB ({source})"
        if hbm_limit:
            peak_line += (
                f" of {float(hbm_limit) / _GIB:.2f} GiB limit"
                f" ({100.0 * float(hbm_peak) / float(hbm_limit):.0f}%)"
            )
        lines.append(peak_line)

    lines.extend(_health_section(telemetry))
    lines.extend(_perf_section(_newest_bench_record([
        Path(bench_dir) if bench_dir else None, run_dir, Path.cwd(),
    ])))
    lines.extend(_audit_section(
        _newest_audit_record([
            Path(audit_dir) if audit_dir else None, run_dir,
        ]),
        _newest_race_record([
            Path(audit_dir) if audit_dir else None, run_dir,
        ]),
        telemetry,
    ))
    lines.extend(_decode_section(telemetry))
    lines.extend(_serving_section(telemetry))
    lines.extend(_rl_section(telemetry))
    lines.extend(_router_section(telemetry))
    lines.extend(_slo_section(telemetry))
    lines.extend(_profiling_section(_profiling_summary(run_dir, telemetry)))
    lines.extend(_trace_section(_trace_summary(run_dir)))
    lines.extend(_fleet_section(_fleet_summary(run_dir)))
    lines.extend(_elastic_section(
        telemetry_records,
        _read_supervisor_events(
            Path(supervisor_log) if supervisor_log
            else run_dir / "supervisor.jsonl"
        ),
    ))
    lines.extend(_recovery_section(telemetry))
    lines.extend(_resilience_section(telemetry))
    lines.extend(_durability_section(telemetry))
    return "\n".join(lines)


# schema_version of the JSON report below: bump on any breaking key change
# (tests/test_trace.py pins the top-level shape)
REPORT_SCHEMA_VERSION = 1


def _numeric_subset(telemetry: dict, prefixes: tuple[str, ...]) -> dict | None:
    """All numeric telemetry keys under `prefixes`, or None when the run
    recorded none of them (section omitted in the JSON like in the text)."""
    out: dict[str, float] = {}
    for key, value in telemetry.items():
        if not key.startswith(prefixes):
            continue
        try:
            out[key] = float(value)
        except (TypeError, ValueError):
            continue
    return out or None


def _supervisor_segments(events: list[dict] | None) -> list[dict] | None:
    """Per-segment topology/runtime rows from supervisor.jsonl events —
    the structured twin of what `== Elastic ==` renders. None when the log
    was absent or carried no segment events."""
    if not events:
        return None
    topology: dict[int, dict] = {}
    exits: dict[int, dict] = {}
    for event in events:
        try:
            attempt = int(event.get("attempt", 0))
        except (TypeError, ValueError):
            continue
        if event.get("event") == "segment_topology":
            topology[attempt] = event
        elif event.get("event") == "exit":
            exits[attempt] = event
    if not topology and not exits:
        return None
    return [
        {
            "attempt": attempt,
            "device_count": topology.get(attempt, {}).get("device_count"),
            "mesh": topology.get(attempt, {}).get("mesh"),
            "decision": topology.get(attempt, {}).get("decision"),
            "runtime_s": exits.get(attempt, {}).get("runtime_s"),
            "exit": (
                exits.get(attempt, {}).get("signal")
                or exits.get(attempt, {}).get("rc")
            ),
        }
        for attempt in sorted(set(topology) | set(exits))
    ]


def render_report_data(
    run_dir: str | Path,
    bench_dir: str | Path | None = None,
    supervisor_log: str | Path | None = None,
    audit_dir: str | Path | None = None,
) -> dict:
    """The machine-readable twin of `render_report` (`report --format
    json`): every section as structured data, for CI trend tracking of
    goodput/serve/trace numbers. Absent sections are null; `telemetry` is
    the newest persisted record verbatim so nothing numeric is lost to the
    section shaping."""
    run_dir = Path(run_dir)
    metrics, telemetry_records, telemetry = _load_run(run_dir)
    world = _read_world(run_dir)
    training = _training_summary(metrics)

    bench = _newest_bench_record([
        Path(bench_dir) if bench_dir else None, run_dir, Path.cwd(),
    ])
    audit = _newest_audit_record([
        Path(audit_dir) if audit_dir else None, run_dir,
    ])
    audit_data = None
    if audit is not None:
        record, name = audit
        findings = record.get("findings")
        by_rule: dict[str, int] = {}
        for finding in findings or []:
            if isinstance(finding, dict):
                rule = str(finding.get("rule", "?"))
                by_rule[rule] = by_rule.get(rule, 0) + 1
        audit_data = {
            "file": name,
            "findings": len(findings) if findings is not None else None,
            "by_rule": by_rule,
            "error": record.get("error"),
        }

    device_memory = None
    if telemetry.get("hbm/peak_bytes_in_use") is not None:
        device_memory = {
            "peak_bytes": float(telemetry["hbm/peak_bytes_in_use"]),
            "limit_bytes": (
                float(telemetry["hbm/bytes_limit"])
                if telemetry.get("hbm/bytes_limit") else None
            ),
            "host_fallback": bool(telemetry.get("hbm/host_fallback")),
        }

    # elastic: the flat gauges plus the per-segment rows text mode renders
    # from supervisor.jsonl (same default path as `== Elastic ==`)
    elastic_gauges = _numeric_subset(telemetry, ("elastic/",))
    segments = _supervisor_segments(_read_supervisor_events(
        Path(supervisor_log) if supervisor_log
        else run_dir / "supervisor.jsonl"
    ))
    elastic = None
    if elastic_gauges or segments:
        elastic = {"gauges": elastic_gauges or {}, "segments": segments}

    return {
        "schema_version": REPORT_SCHEMA_VERSION,
        "run_dir": str(run_dir),
        "world": world,
        "training": training,
        "goodput": _numeric_subset(telemetry, ("goodput/",)),
        "device_memory": device_memory,
        "health": _numeric_subset(telemetry, ("health/", "nan_guard/")),
        "perf": {"file": bench[1], "data": bench[0]} if bench else None,
        "audit": audit_data,
        "inference": _numeric_subset(telemetry, ("decode/", "eval/")),
        "serving": _numeric_subset(telemetry, ("serve/",)),
        # null when the run never post-trained (no `rl-fit` invocation) —
        # additive: schema_version stays 1
        "rl": _numeric_subset(telemetry, ("rl/",)),
        # null when the run never routed (no `route` invocation)
        "router": _numeric_subset(telemetry, ("router/",)),
        # null when the run armed no SLO config — the structured twin of
        # the text section's absent-config omission
        "slo": _numeric_subset(telemetry, ("slo/",)),
        # null when the run profiled nothing (no trigger counters, no
        # capture manifests, no attr/ gauges)
        "profiling": _profiling_summary(run_dir, telemetry),
        "elastic": elastic,
        "trace": _trace_summary(run_dir),
        # null when no `fleet --out` sweep was persisted into the run dir
        "fleet": _fleet_summary(run_dir),
        "recovery": _numeric_subset(telemetry, ("resilience/",)),
        # null when the run mirrored nothing and had no verify findings —
        # full-key "prefixes" pick the two checkpoint/ durability counters
        # without dragging in save/wait timers
        "durability": _numeric_subset(telemetry, (
            "ckpt/", "checkpoint/verify_failures", "checkpoint/mirror_restores",
        )),
        "flash": _numeric_subset(telemetry, ("flash/",)),
        "telemetry": telemetry,
    }


def report_main(
    run_dir: str,
    bench_dir: str | None = None,
    supervisor_log: str | None = None,
    audit_dir: str | None = None,
    format: str = "text",
) -> int:
    """`python -m llm_training_tpu_torch report <run_dir>` entry point."""
    try:
        if format == "json":
            print(json.dumps(render_report_data(
                run_dir, bench_dir=bench_dir, supervisor_log=supervisor_log,
                audit_dir=audit_dir,
            )))
        else:
            print(render_report(
                run_dir, bench_dir=bench_dir, supervisor_log=supervisor_log,
                audit_dir=audit_dir,
            ))
    except FileNotFoundError as e:
        print(f"report: {e}", file=sys.stderr)
        return 2
    return 0
