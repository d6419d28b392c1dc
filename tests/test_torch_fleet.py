"""The port's fleet plane (`llm_training_tpu_torch/telemetry/fleet.py` and
the exporter's discovery cards) against JAX's.

Two exporters of the port over fixed registries announce themselves in
one `LLMT_FLEET_DIR` (the second card carries the pid of a live helper
process, since one process owns one card name), beside a card whose pid is
dead. JAX's `FleetAggregator` and the port's sweep that directory and give
the same snapshot, with the timestamps and the exporters' own scrape
counters aside (each sweep is a scrape, so the second aggregator reads one
more): the same rollups, verdict and stale card, and the same federation
text. `fleet --once` exits as JAX's does. The cases of `tests/test_fleet.py`
that need no live exporter run over the port's modules too.
"""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys
import types
import urllib.error
import urllib.request
from pathlib import Path

import pytest

from llm_training_tpu.telemetry import fleet as jax_fleet
from llm_training_tpu_torch.telemetry import fleet as port_fleet
from llm_training_tpu_torch.telemetry.exporter import MetricsExporter
from llm_training_tpu_torch.telemetry.registry import TelemetryRegistry

ROOT = Path(__file__).resolve().parents[1]
SOURCE = (ROOT / "tests" / "test_fleet.py").read_text()
# the cases whose arguments are plain pytest fixtures (the rest take the
# module's live `serve_exporter` fixture, which the sweeps below cover)
CASES = [node.name for node in ast.parse(SOURCE).body
         if isinstance(node, ast.FunctionDef) and node.name.startswith("test_")
         and {a.arg for a in node.args.args} <= {"tmp_path", "monkeypatch", "capsys"}]
# what differs between two sweeps of one live fleet by construction
_VOLATILE = ("exporter_scrapes", "exporter_uptime_s", "sweep_s", "swept_at", "age_s")


def _dead_pid() -> int:
    proc = subprocess.Popen([sys.executable, "-c", "pass"])
    proc.wait()
    return proc.pid


def _steady(value):
    """A snapshot without its timestamps and sweep-counting series."""
    if isinstance(value, dict):
        return {k: _steady(v) for k, v in value.items()
                if not any(tag in k for tag in _VOLATILE)}
    if isinstance(value, list):
        return [_steady(v) for v in value]
    return value


def _steady_text(text: str) -> list[str]:
    return [line for line in text.splitlines() if not any(tag in line for tag in _VOLATILE)]


@pytest.fixture
def fleet(tmp_path, monkeypatch):
    """Two serve exporters with discovery cards and one stale card."""
    fleet_dir = tmp_path / "fleet"
    monkeypatch.setenv("LLMT_FLEET_DIR", str(fleet_dir))
    exporters = []
    helper = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(120)"])
    try:
        own = fleet_dir / f"replica-{os.getpid()}.json"
        cards = []
        for queue, completed, ttft in ((1.0, 5.0, 40.0), (3.0, 7.0, 90.0)):
            registry = TelemetryRegistry()
            registry.gauge("serve/queue_depth").set(queue)
            registry.gauge("serve/requests_completed").set(completed)
            registry.gauge("serve/ttft_p99_ms").set(ttft)
            registry.counter("serve/tokens_generated").inc(int(completed * 10))
            exporter = MetricsExporter(0, registry=registry, role="serve",
                                       clock=lambda: 100.0)
            assert exporter.start()
            exporters.append(exporter)
            cards.append(json.loads(own.read_text()))
        # each arming wrote this process's card; the first stays under this
        # pid and the second moves to the helper's
        card, second = cards
        assert [c["port"] for c in cards] == [e.port for e in exporters]
        assert card["role"] == "serve"
        own.write_text(json.dumps(card))
        second.update(pid=helper.pid, replica_id=f"serve-0-{helper.pid}")
        (fleet_dir / f"replica-{helper.pid}.json").write_text(json.dumps(second))
        dead = _dead_pid()
        stale = dict(card, pid=dead, port=1, replica_id=f"serve-1-{dead}", attempt=1)
        (fleet_dir / f"replica-{dead}.json").write_text(json.dumps(stale))
        yield {"dir": fleet_dir, "exporters": exporters, "stale": stale["replica_id"]}
    finally:
        for exporter in exporters:
            exporter.stop()
        helper.kill()
        helper.wait()


def test_snapshot_and_federation_match_jax(fleet):
    aggregators = [module.FleetAggregator(fleet_dir=fleet["dir"], timeout_s=2.0)
                   for module in (jax_fleet, port_fleet)]
    snapshots = [aggregator.sweep() for aggregator in aggregators]
    assert _steady(snapshots[1]) == _steady(snapshots[0])
    ours = snapshots[1]
    assert ours["verdict"] == "red" and ours["stale_cards"] == [fleet["stale"]]
    assert ours["rollup"]["llmt_fleet_replicas_live"] == 2.0
    assert ours["rollup"]["llmt_fleet_serve_requests_completed"] == 12.0
    assert ours["rollup"]["llmt_fleet_serve_queue_depth"] == 4.0
    assert ours["rollup"]["llmt_fleet_serve_tokens_generated"] == 120.0
    assert ours["replicas"][fleet["stale"]]["metrics"] == {}
    texts = [aggregator.render_metrics() for aggregator in aggregators]
    assert _steady_text(texts[1]) == _steady_text(texts[0])
    fleetz = [aggregator.render_fleetz() for aggregator in aggregators]
    assert _steady_text(fleetz[1]) == _steady_text(fleetz[0])
    assert [a.health()[0] for a in aggregators] == [False, False]
    # the aggregator's own federation endpoint answers as JAX's
    for aggregator in aggregators:
        assert aggregator.start(port=0)
    try:
        codes = []
        for aggregator in aggregators:
            try:
                urllib.request.urlopen(f"http://127.0.0.1:{aggregator.port}/healthz", timeout=5)
                codes.append(200)
            except urllib.error.HTTPError as e:
                codes.append(e.code)
        assert codes == [503, 503]
    finally:
        for aggregator in aggregators:
            aggregator.stop()


def test_fleet_once_exit_codes_match_jax(fleet, tmp_path, capsys, monkeypatch):
    """`fleet --once` over the red fleet, a green one, an empty directory
    and no directory at all: the same exit codes and the same JSON."""
    green = tmp_path / "green"
    port_fleet.write_replica_card(green, fleet["exporters"][0].port, role="serve")
    empty = tmp_path / "empty"
    empty.mkdir()
    results = {}
    for name, module in (("jax", jax_fleet), ("port", port_fleet)):
        runs = []
        for fleet_dir in (fleet["dir"], green, empty, tmp_path / "absent"):
            rc = module.fleet_main(fleet_dir=str(fleet_dir), once=True, as_json=True)
            out = capsys.readouterr().out
            runs.append((rc, _steady(json.loads(out)) if out.strip() else None))
        monkeypatch.delenv("LLMT_FLEET_DIR")
        runs.append((module.fleet_main(once=True), None))
        monkeypatch.setenv("LLMT_FLEET_DIR", str(fleet["dir"]))
        results[name] = runs
    assert results["port"] == results["jax"]
    assert [rc for rc, _ in results["port"]] == [0, 0, 2, 2, 2]
    assert results["port"][0][1]["verdict"] == "red"
    assert results["port"][1][1]["verdict"] == "green"


def _namespace(package: str) -> dict:
    source = SOURCE.replace("from llm_training_tpu.", f"from {package}.")
    module = types.ModuleType(f"fleet_cases_{package}")
    module.__file__ = str(ROOT / "tests" / "test_fleet.py")
    exec(compile(source, module.__file__, "exec"), module.__dict__)
    return module.__dict__


@pytest.mark.parametrize("case", CASES)
def test_fleet_cases_hold_for_the_port(case, tmp_path, monkeypatch, capsys):
    """A case of `tests/test_fleet.py` over the port's fleet, exporter and
    report modules passes as it passes over JAX's."""
    fn = _namespace("llm_training_tpu_torch")[case]
    fixtures = {"tmp_path": tmp_path, "monkeypatch": monkeypatch, "capsys": capsys}
    fn(**{a: fixtures[a] for a in fn.__code__.co_varnames[:fn.__code__.co_argcount]})
